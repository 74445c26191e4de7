"""Where the render kernel (K1) spends its SM cycles.

    python -m toypathtracer_torch.tools.render_parts [--forms thread,merged]
        [--width 1280] [--height 720] [--spp 4] [--depth 10] [--frame 0]
        [--out PATH]

Launches each form's instrumented instance once (ops/cuda_render.
render_tile_form with counted=True) on the 46-sphere frame:

- "thread", the per-thread kernel K1 replaced (render_kernel<2>: its
  clocked instance).  Its SM-clock counters, summed over threads, as
  shares of the threads' cycles: camera-ray setup, the nearest-hit sphere
  loops, shading and scatter (a bounce less its hit loop and NEE), NEE
  outside its occlusion loops, the occlusion loops, waiting at each
  sample's end for the warp's deepest lane, and "other" (staging the
  scene, the ray count, the block's barrier).
- "merged", the main path's merged kernel (merged_render_kernel<1>: its
  counted instance).  The loop's iterations and busy lanes, its lane busy
  share busy / (32 iterations), and its warps' cycles as shares of the
  loop's: the hit loops, NEE outside the shadow loops, the shadow loops,
  and "other" (refilling lanes, camera rays, shading and scatter).

The clock reads cost cycles of their own, so the shares are what to read,
not the totals.  Needs a card: cycle counts are never taken on the CPU.
Writes build/render_parts_torch.json at the root of the checkout (or
--out) and prints the same JSON.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..config import RenderConfig
from ..ops import cuda_render
from ..scene import make_scene

OUT = Path(__file__).resolve().parents[2] / "build" / "render_parts_torch.json"


def thread_shares(c: dict) -> dict:
    """The clocked per-thread kernel's counters as shares of its cycles."""
    total = c["cycles_all"]
    parts = {"camera": c["cycles_camera"], "hit": c["cycles_hit"],
             "shade": c["cycles_bounce"] - c["cycles_hit"] - c["cycles_nee"],
             "nee": c["cycles_nee"] - c["cycles_occlusion"],
             "occlusion": c["cycles_occlusion"], "wait": c["cycles_wait"]}
    shares = {k: v / total for k, v in parts.items()}
    shares["other"] = 1.0 - sum(shares.values())
    return shares


def merged_shares(c: dict) -> dict:
    """The counted merged kernel's counters as shares of its loop's
    cycles."""
    total = c["cycles"]
    parts = {"hit": c["cycles_hit"],
             "nee": c["cycles_nee"] - c["cycles_shadow"],
             "shadow": c["cycles_shadow"]}
    shares = {k: v / total for k, v in parts.items()}
    shares["other"] = 1.0 - sum(shares.values())
    return shares


def form_parts(scene, cfg: RenderConfig, form: str, frame: int = 0) -> dict:
    """One instrumented launch of K1's `form` over the whole frame;
    `scene` on the card."""
    H, W = cfg.height, cfg.width
    _, rays, c = cuda_render.render_tile_form(scene, cfg, frame, 0, 0, H, W,
                                              form, counted=True)
    out = {"form": form, "rays": int(rays), "counters": c}
    if form == "thread":
        out["cycle_shares"] = thread_shares(c)
        out["bounces_per_sample"] = c["bounces"] / max(c["samples"], 1)
    else:
        out["cycle_shares"] = merged_shares(c)
        out["lane_busy_share"] = c["busy"] / (32 * max(c["iters"], 1))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--forms", default="thread,merged")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--frame", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help=f"output path (default {OUT})")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("render_parts: needs a CUDA device")
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=args.spp, max_depth=args.depth)
    scene = make_scene(big=True).to("cuda")
    res = {"device": torch.cuda.get_device_name(0),
           "config": {"width": cfg.width, "height": cfg.height,
                      "spp": cfg.samples_per_pixel,
                      "max_depth": cfg.max_depth, "frame": args.frame},
           "forms": [form_parts(scene, cfg, f, args.frame)
                     for f in args.forms.split(",")]}
    out = Path(args.out) if args.out else OUT
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
