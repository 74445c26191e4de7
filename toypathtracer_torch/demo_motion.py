"""Motion-parameter recovery demo (counterpart of tools/demo_motion.py;
BASELINE.json config 4).

The reference's animation moves sphere 1 (y = cos t + 1) and sphere 8
(z = 0.3 sin t) (reference: Cpp/Source/Test.cpp:304-308).  The animation
TIME is recovered by gradient descent from one rendered frame: render a
target at t_true, start from t_guess, and minimise the tonemapped pixel
L2 through Scene.animate and the differentiable render (on the card the
render kernel forward and the gradient kernel's soft instance backward,
on the CPU the plain versions).  The soft-silhouette estimator carries
the moving silhouettes' gradient; without it d(loss)/dt is the shading's
alone.  Prints one JSON line with the JAX demo's keys and the device.

    python -m toypathtracer_torch.demo_motion [--t-true 0.8] [--t-guess 0.3]
        [--steps 150] [--lr 2e-2] [--width 192 --height 108]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="toypathtracer_torch.demo_motion")
    ap.add_argument("--t-true", type=float, default=0.8)
    ap.add_argument("--t-guess", type=float, default=0.3)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--width", type=int, default=192)
    ap.add_argument("--height", type=int, default=108)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the CUDA kernels (default); cpu: the plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)

    from .config import FLAG_ANIMATE, RenderConfig, resolve_device
    from .inverse import adam_update, image_l2_tonemapped
    from .ops.cuda_grad import render_frame_diff
    from .ops.cuda_render import render_frame
    from .render.frame import scene_for_frame
    from .scene import make_scene

    device = resolve_device(args.device)
    # geometry-recovery recipe (inverse.py docstring): soft-silhouette
    # estimator + tonemapped loss -- sphere 8 is an emissive whose moving
    # silhouette otherwise dominates with unusable hard-select gradients
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=2, max_depth=4,
                       soft_silhouette_eps=0.05)
    scene = make_scene(big=True).to(device)
    target, _ = render_frame(
        scene_for_frame(scene, args.t_true, FLAG_ANIMATE), cfg, 0,
        device=device)

    t = torch.tensor(args.t_guess, dtype=torch.float32, device=device)
    state: dict = {}
    loss0 = None
    t0 = time.perf_counter()
    for _ in range(args.steps):
        leaf = t.detach().requires_grad_(True)
        img, _ = render_frame_diff(scene_for_frame(scene, leaf, FLAG_ANIMATE),
                                   cfg, 0, device=device)
        loss = image_l2_tonemapped(img, target)
        g, = torch.autograd.grad(loss, leaf)
        loss = loss.detach()
        if loss0 is None:
            loss0 = float(loss)
        params, state = adam_update({"t": leaf.detach()}, {"t": g}, state,
                                    args.lr, 1e-8, None)
        t = params["t"]
    t_rec = float(t)
    dt = time.perf_counter() - t0

    res = {
        "t_true": args.t_true,
        "t_guess": args.t_guess,
        "t_recovered": t_rec,
        "t_abs_err": abs(t_rec - args.t_true),
        "loss_initial": loss0,
        "loss_final": float(loss),
        "steps": args.steps,
        "seconds": round(dt, 1),
        "device": str(device),
    }
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
