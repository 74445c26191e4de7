"""End-to-end inverse-rendering demo (counterpart of tools/demo_inverse.py).

Perturbs the 46-sphere scene (albedo, and centers with --center-jitter),
renders a target with the true scene, then recovers the perturbed
parameters by Adam on pixel L2 through the differentiable renderer: on
the card the render kernel forward and the gradient kernel backward.
Writes target/initial/recovered PNGs and prints one JSON line with the
same keys as the JAX demo.

    python -m toypathtracer_torch.demo_inverse [--steps 200]
        [--width 192 --height 108] [--outdir build/inverse_demo]
        [--device cuda|cpu]

The default recovers perturbed albedo.  Geometry modes (--trainable
center, --center-jitter) need the soft-silhouette estimator: --soft-eps
0.05 with --tonemap-loss, the JAX package's recipe; without it
d(loss)/d(center) lacks the silhouette term and they are not expected to
converge.  On the card --soft-eps > 0 runs the gradient kernel's soft
instance.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="toypathtracer_torch.demo_inverse")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--width", type=int, default=192)
    ap.add_argument("--height", type=int, default=108)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--outdir", default="build/inverse_demo")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--trainable", default="albedo",
                    help="comma list of scene fields to optimize")
    ap.add_argument("--center-jitter", type=float, default=0.0)
    ap.add_argument("--albedo-jitter", type=float, default=0.15)
    ap.add_argument("--soft-eps", type=float, default=0.0,
                    help="the soft-silhouette estimator's eps (0: the hard "
                         "selects' gradient)")
    ap.add_argument("--tonemap-loss", action="store_true",
                    help="L2 on Reinhard-compressed radiance")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the CUDA kernels (default); cpu: the plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)

    from . import io as image_io
    from .config import RenderConfig
    from .inverse import InverseRenderer, image_l2, image_l2_tonemapped
    from .ops.cuda_render import render_frame
    from .scene import make_scene

    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=args.spp, max_depth=args.depth,
                       soft_silhouette_eps=args.soft_eps)
    loss_fn = image_l2_tonemapped if args.tonemap_loss else image_l2
    true_scene = make_scene(big=True)

    # Perturb every non-emissive sphere's center and albedo.
    rng = np.random.default_rng(args.seed)
    emissive = np.zeros(true_scene.n_spheres, bool)
    emissive[list(true_scene.emissive_ids)] = True
    c_jit = rng.normal(0, args.center_jitter,
                       true_scene.center.shape).astype(np.float32)
    a_jit = rng.normal(0, args.albedo_jitter,
                       true_scene.albedo.shape).astype(np.float32)
    c_jit[emissive] = 0.0
    a_jit[emissive] = 0.0
    start = true_scene.replace(
        center=true_scene.center + torch.from_numpy(c_jit),
        albedo=torch.clamp(true_scene.albedo + torch.from_numpy(a_jit),
                           0.02, 0.98))

    # The target from the true scene with the sample set the optimizer
    # uses (resample=False: a deterministic objective, loss -> ~0).
    target, _ = render_frame(true_scene, cfg, 0, device=args.device)
    inv = InverseRenderer(cfg, target,
                          trainable=tuple(args.trainable.split(",")),
                          learning_rate=args.lr, loss_fn=loss_fn,
                          adam_eps=1e-3, device=args.device)
    img0, _ = render_frame(start, cfg, 0, device=args.device)
    loss0 = float(loss_fn(img0, target))
    t0 = time.perf_counter()
    fitted, losses = inv.fit(start, steps=args.steps, frame0=0,
                             resample=False)
    fit_s = time.perf_counter() - t0
    img_n, _ = render_frame(fitted, cfg, 0, device=args.device)

    os.makedirs(args.outdir, exist_ok=True)
    for name, img in (("target", target), ("initial", img0),
                      ("recovered", img_n)):
        image_io.write_png(os.path.join(args.outdir, f"{name}.png"),
                           img.cpu().numpy())

    def err(a, b):
        return np.abs(a.detach().cpu().numpy() - b.detach().cpu().numpy())
    ce0, ce_n = err(start.center, true_scene.center), \
        err(fitted.center, true_scene.center)
    print(json.dumps({
        "steps": args.steps,
        "seconds": round(fit_s, 1),
        "loss_initial": loss0,
        "loss_final": losses[-1],
        "loss_drop_x": round(loss0 / max(losses[-1], 1e-12), 1),
        "center_maxerr_initial": float(ce0.max()),
        "center_maxerr_final": float(ce_n.max()),
        "center_meanerr_initial": float(ce0.mean()),
        "center_meanerr_final": float(ce_n.mean()),
        "albedo_maxerr_initial": float(
            err(start.albedo, true_scene.albedo).max()),
        "albedo_maxerr_final": float(
            err(fitted.albedo, true_scene.albedo).max()),
        "outdir": args.outdir,
        "device": args.device,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
