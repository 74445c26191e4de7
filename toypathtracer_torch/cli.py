"""Headless CLI: render N frames, print the reference HUD, write an image
(counterpart of toypathtracer_tpu/cli.py; reference: Cs/Program.cs:7-59).

Usage:
    python -m toypathtracer_torch [--frames 30] [--width 1280 --height 720]
        [--spp 4] [--max-depth 10] [--small] [--animate] [--no-progressive]
        [--no-light-sampling] [--mitsuba-compare] [--output out.png|out.tga]
        [--device cuda|cpu] [--scaled N]
        [--backend auto|pallas|jnp|sharded|parity]
        [--batch N] [--resume STATE.npz] [--save-state STATE.npz]
        [--tile H,W] [--ppl K] [--merged]

Renders on the card by default; `--device cpu` runs the plain PyTorch
renderer on the CPU.  `--scaled N` renders the procedurally instanced
N-sphere scene (the chunked traversal; `--animate` orbits its beacons).
The JAX CLI's `--backend pallas` is the card's hand-written render kernel
here (with `--device cpu` it stops: the CPU has no kernel and nothing
falls back), and `--backend jnp` the plain PyTorch renderer on `--device`;
each says on stderr what runs.
`--backend sharded` splits each frame's rows over every visible card
(parallel/mesh.render_frame_sharded; with `--device cpu` one band on the
CPU); `--backend parity` renders with the reference's scalar C++
semantics (render/parity.py: slow, for validation).  `--batch N` renders N
frames a step while accumulating a static view, the HUD line showing
per-frame averages.  `--save-state` writes the accumulator and frame
counter, and `--resume` continues from them: the resumed frames are those
an uninterrupted run renders.  `--tile`, `--ppl` and `--merged` are the
JAX CLI's TPU occupancy knobs, accepted so that its command lines run
unchanged; they never change the image, and the card's kernel ignores
them.
"""

from __future__ import annotations

import argparse
import sys
import time
from functools import partial

from . import io as image_io
from .config import FLAG_ANIMATE, FLAG_PROGRESSIVE, RenderConfig
from .profiling import hud_string
from .render.frame import RenderSession, sum_rays
from .scaled import make_scaled_scene
from .scene import make_scene


def pick_backend(name: str, device: str, scaled: bool = False):
    """The JAX CLI's `pallas` and `jnp` backends (its _pick_backend) on the
    port: "pallas" the card's hand-written render kernel (the session's
    default there: None), "jnp" the plain PyTorch renderer (of the scaled
    scene with `scaled`) on `device`.  Prints one stderr line naming what
    runs.  "pallas" with device "cpu" exits with an error: the CPU has no
    kernel, and nothing falls back to the plain renderer."""
    kind = "scaled render kernel" if scaled else "render kernel K1"
    if name == "pallas":
        if device != "cuda":
            raise SystemExit(
                "--backend pallas runs the card's hand-written "
                f"{kind}, and --device {device} has none: use --device "
                "cuda, or --backend jnp for the plain PyTorch renderer")
        print(f"--backend pallas: the hand-written {kind} (CUDA) on the "
              "card", file=sys.stderr)
        return None
    if name != "jnp":
        raise ValueError(f"no kernel-or-plain backend {name!r}")
    if scaled:
        from .scaled import render_frame_scaled_plain as fn
    else:
        from .render.wavefront import render_frame_plain as fn
    print(f"--backend jnp: the plain PyTorch renderer on {device}",
          file=sys.stderr)
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="toypathtracer_torch",
        description="PyTorch/CUDA path tracer (ToyPathTracer capabilities)")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--max-depth", type=int, default=10)
    ap.add_argument("--frames", type=int, default=30,
                    help="frames to render (reference CLI renders 30)")
    ap.add_argument("--small", action="store_true",
                    help="9-sphere scene instead of the 46-sphere big scene")
    ap.add_argument("--scaled", type=int, default=0, metavar="N",
                    help="render the procedurally instanced N-sphere scene "
                         "(chunked AABB-culled traversal) instead of the "
                         "46-sphere scene")
    ap.add_argument("--mitsuba-compare", action="store_true",
                    help="flat sky / zero aperture / mirror metal, for "
                         "comparison against Mitsuba")
    ap.add_argument("--no-light-sampling", action="store_true")
    ap.add_argument("--animate", action="store_true",
                    help="animate spheres 1 and 8 (kFlagAnimate)")
    ap.add_argument("--no-progressive", action="store_true",
                    help="disable progressive accumulation (kFlagProgressive)")
    ap.add_argument("--output", default="output.png",
                    help=".png or .tga (reference dumps output.tga)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the CUDA kernel (default); cpu: the plain "
                         "PyTorch renderer")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "pallas", "jnp", "sharded", "parity"],
                    help="auto: the whole frame on one device; pallas: the "
                         "card's hand-written kernel (no CPU form); jnp: "
                         "the plain PyTorch renderer on --device; sharded: "
                         "its rows split over every card (one CPU band "
                         "with --device cpu); parity: the reference's "
                         "scalar C++ semantics (slow, for validation)")
    ap.add_argument("--batch", type=int, default=1, metavar="N",
                    help="frames rendered a step while the view is static "
                         "and progressive (render.frame.progressive_steps; "
                         "the HUD prints per-frame averages a step)")
    ap.add_argument("--resume", metavar="STATE.npz",
                    help="continue the progressive accumulation saved by "
                         "--save-state (the accumulator and frame counter)")
    ap.add_argument("--save-state", metavar="STATE.npz",
                    help="write the final accumulation state for --resume")
    ap.add_argument("--tile", default=None, metavar="H,W",
                    help="the JAX CLI's TPU pixel tile; never changes the "
                         "image, ignored by the card's kernel")
    ap.add_argument("--ppl", type=int, default=1, metavar="K",
                    help="the JAX CLI's TPU pixels per lane; never changes "
                         "the image, ignored by the card's kernel")
    ap.add_argument("--merged", action="store_true",
                    help="the JAX CLI's merged TPU wavefront; never "
                         "changes the image, ignored by the card's kernel")
    args = ap.parse_args(argv)
    if args.scaled and args.backend not in ("auto", "pallas", "jnp"):
        raise SystemExit("--scaled uses its own chunked renderer")

    cfg = RenderConfig(
        width=args.width, height=args.height,
        samples_per_pixel=args.spp, max_depth=args.max_depth,
        do_light_sampling=not args.no_light_sampling,
        do_mitsuba_compare=args.mitsuba_compare,
        pix_per_lane=args.ppl, merged_wavefront=args.merged)
    if args.tile:
        th, tw = (int(v) for v in args.tile.split(","))
        cfg = cfg.replace(tile_h=th, tile_w=tw)
    if args.tile or args.ppl != 1 or args.merged:
        print("--tile/--ppl/--merged are TPU occupancy knobs: they never "
              "change the image, and the card's kernel ignores them",
              file=sys.stderr)
    if args.scaled:
        scene = make_scaled_scene(n=args.scaled)
        n_spheres = args.scaled
    else:
        scene = make_scene(big=not args.small,
                           mitsuba_compare=args.mitsuba_compare)
        n_spheres = scene.n_spheres
    flags = 0
    if not args.no_progressive:
        flags |= FLAG_PROGRESSIVE
    if args.animate:
        flags |= FLAG_ANIMATE

    render_fn, backend = None, "auto"
    if args.backend == "sharded":
        import torch
        from .parallel.mesh import make_mesh, render_frame_sharded
        mesh = make_mesh([torch.device("cpu")] if args.device == "cpu"
                         else None)
        render_fn = partial(render_frame_sharded, mesh=mesh)
        backend = f"sharded x{mesh.size}"
    elif args.backend == "parity":
        from .render.parity import render_frame_parity
        render_fn = partial(render_frame_parity, device=args.device)
        backend = "parity"
    elif args.backend in ("pallas", "jnp"):
        render_fn = pick_backend(args.backend, args.device,
                                 bool(args.scaled))
        backend = args.backend
    sess = RenderSession(scene, cfg, flags=flags, render_fn=render_fn,
                         device=args.device)
    frame0 = 0
    if args.resume:
        from .checkpoint import load_frame_state
        state = load_frame_state(args.resume, device=sess.device)
        if tuple(state.accum.shape) != (cfg.height, cfg.width, 3):
            raise SystemExit(f"--resume state is {tuple(state.accum.shape)}"
                             f", the render is {(cfg.height, cfg.width, 3)}")
        sess.state = state
        frame0 = state.frame
    if sess.device.type == "cuda":
        import torch
        kind = torch.cuda.get_device_name(sess.device)
    else:
        kind = "cpu"
    print(f"backend={backend} device={args.device} ({kind}) "
          f"scene={n_spheres}-sphere "
          f"{cfg.width}x{cfg.height} spp={cfg.samples_per_pixel}")
    title = f"{args.device.upper()} path tracer"
    # several frames a step only while accumulating a static view: without
    # progressive accumulation each frame overwrites the last, and an
    # animation needs each frame's own time
    batch = max(1, args.batch) if (flags & FLAG_PROGRESSIVE
                                   and not flags & FLAG_ANIMATE) else 1
    img = None
    f = frame0
    total = 0
    while f < frame0 + args.frames:
        n = min(batch, frame0 + args.frames - f)
        t0 = time.perf_counter()
        img, raycount = sess.steps(time=f / 60.0, n=n)
        rays = sum_rays(raycount)  # host copy: waits for the frames
        dt = time.perf_counter() - t0
        print(hud_string(title, dt / n, rays // n, f + n))
        total += rays
        f += n
    print(f"frames {frame0 + 1}-{f}: {total} rays")

    if args.save_state:
        from .checkpoint import save_frame_state
        save_frame_state(args.save_state, sess.state)
        print(f"saved state {args.save_state} (frame {sess.state.frame})")
    if args.output and img is not None:
        image_io.write_image(args.output, img.cpu().numpy())
        print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
