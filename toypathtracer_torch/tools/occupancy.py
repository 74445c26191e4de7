"""Occupancy counters of the stats render kernel (counterpart of the JAX
package's tools/occupancy.py).

    python -m toypathtracer_torch.tools.occupancy [--width 1280]
        [--height 720] [--spp 4] [--depth 10] [--frame 0] [--ppl 1]
        [--tile 16,128] [--merged] [--device cuda] [--out PATH]

Renders the 46-sphere frame through the stats render kernel (K2,
ops/cuda_render.render_tile_stats) and reports the TPU kernel's per-tile
counters, derived exactly from the per-pixel trip counts
(ops/cuda_render.tile_counters), under the JAX tool's keys: occupancy of
a tile = work / (iters x lanes), the share of the wavefront loop's lane
slots doing a bounce.  The counts are deterministic.  The `warp` block
holds the GPU's own form for the per-thread render kernel's layout
(render_kernel<0>: a thread a pixel, 16x2 pixels a warp), counted by K2
per such warp: efficiency = work / (32 x iters), the share of a warp's
lane-steps that do a bounce when the warp runs each sample as long as its
deepest lane (0.480 at the defaults).  K2 itself runs the merged loop,
whose lanes do not wait so (its lane busy share is the merged K1's counted
instance's, tools.render_parts), and counts that layout's warps exactly.

Writes build/occupancy_torch.json at the root of the checkout (or --out)
and prints the same JSON.  --device cpu runs the plain version.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..config import RenderConfig, resolve_device
from ..ops import cuda_render
from ..scene import make_scene

OUT = Path(__file__).resolve().parents[2] / "build" / "occupancy_torch.json"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--frame", type=int, default=0)
    ap.add_argument("--ppl", type=int, default=1,
                    help="pixels per lane (RenderConfig.pix_per_lane)")
    ap.add_argument("--tile", default=None,
                    help="tile_h,tile_w override, e.g. 16,128")
    ap.add_argument("--merged", action="store_true",
                    help="count the merged wavefront loop's trips")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help=f"output path (default {OUT})")
    args = ap.parse_args(argv)

    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=args.spp, max_depth=args.depth,
                       pix_per_lane=args.ppl, merged_wavefront=args.merged)
    if args.tile:
        th, tw = (int(x) for x in args.tile.split(","))
        cfg = cfg.replace(tile_h=th, tile_w=tw)
    dev = resolve_device(args.device)
    scene = make_scene(big=True).to(dev)
    img, rays, counters = cuda_render.render_tile_stats(scene, cfg,
                                                        args.frame)
    it, wk = (t.cpu().numpy().astype(np.int64)
              for t in cuda_render.tile_counters(counters, cfg))
    grid_h, grid_w = cuda_render.padded_grid(cfg)
    ppl = cuda_render.resolve_pix_per_lane(cfg, grid_h - cfg.height,
                                           grid_w - cfg.width)
    lanes = (cfg.tile_h // ppl) * cfg.tile_w
    occ = wk / np.maximum(it * lanes, 1)
    ideal_iters = np.ceil(wk / lanes)
    w_it = counters.warp_iters.cpu().numpy().astype(np.int64)
    w_wk = counters.warp_work.cpu().numpy().astype(np.int64)
    out = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "config": {"width": cfg.width, "height": cfg.height,
                   "spp": cfg.samples_per_pixel, "depth": cfg.max_depth,
                   "tile": [cfg.tile_h, cfg.tile_w],
                   "pix_per_lane": ppl, "merged": cfg.merged_wavefront},
        "rays": int(rays),
        "tiles": int(it.size),
        "iters": {"sum": int(it.sum()), "mean": float(it.mean()),
                  "min": int(it.min()), "max": int(it.max())},
        "work_lane_bounces": int(wk.sum()),
        "occupancy": {"mean": float(occ.mean()), "min": float(occ.min()),
                      "max": float(occ.max()),
                      "weighted": float(wk.sum() / (it.sum() * lanes))},
        "iters_vs_ideal": float(it.sum() / max(ideal_iters.sum(), 1)),
        "img_mean": float(img.mean()),
        "warp": {"lanes": 32, "pixels": [2, 16],
                 "warps": int((w_it > 0).sum()),
                 "iters_sum": int(w_it.sum()), "work_sum": int(w_wk.sum()),
                 "efficiency": float(w_wk.sum()
                                     / max(32 * w_it.sum(), 1))},
    }
    path = Path(args.out) if args.out else OUT
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
