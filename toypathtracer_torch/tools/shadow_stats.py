"""The NEE occlusion kernel (K6) at work: its two forms' counted instances.

    python -m toypathtracer_torch.tools.shadow_stats [--out PATH]

Builds K6's workload as the scaled path queries it (ChunkedScenePort) on
the 100k-sphere scene (make_scaled_scene(SPHERES)) at 1280x720: frame 0's
camera rays, one a pixel (each pixel's first sample), their
nearest hits through K5, and from each first Lambert hit one cone sample
toward each of the scene's beacons, drawn as tracecore.bounce draws them.
Then launches each form's counted instance once on those ray-light pairs
(ops/cuda_scaled.shadow_chunks_form with stats=True):

- "thread", the per-thread form (shadow_chunks_kernel<1>: a thread a ray,
  occluded_chunks per light, a warp step counted for the lanes active in
  it);
- "coop", the main path's warp-cooperative form (coop_shadow_kernel<1>:
  the warp walks the chunks together in scaled.chunk_index's spatial
  order, group boxes first, the light's chunk last).

For each: the sphere-loop SIMT efficiency (the sphere tests the pairs
needed over 32 x the trips the warps ran), the warps' box steps per warp
call and the lane slab tests per ray-light pair, the sphere tests per pair,
and the share of pairs occluded; and whether its bits equal the other
form's.  Needs a card.  Writes build/shadow_stats_torch.json at the root of
the checkout (or --out) and prints the same JSON.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..config import RenderConfig
from ..ops import cuda_render, cuda_scaled
from ..ops import tracecore as tc
from ..render.wavefront import camera_scalars
from ..scaled import ChunkedScenePort, make_scaled_scene

OUT = Path(__file__).resolve().parents[2] / "build" / "shadow_stats_torch.json"
SPHERES = 100_000
CFG = RenderConfig(width=1280, height=720, samples_per_pixel=4, max_depth=10)
FRAME = 0
FORMS = ("thread", "coop")


class Workload(NamedTuple):
    """K6's inputs on the scene's device: origins (3 planes), per light
    its direction (3 planes) and its own root t_l, the light ids, and
    the camera rays and hits they came from."""
    pos: tuple
    dirs: list
    t_ls: list
    lights: list
    cam_ro: tuple
    cam_rd: tuple
    hit_t: torch.Tensor
    hit_id: torch.Tensor
    st: torch.Tensor


def camera_rays(scene, cfg: RenderConfig, frame: int = 0, px=None,
                py=None):
    """The first camera ray of each pixel (px, py) of `frame` (default:
    every pixel, row by row) on the scene's device, drawn as the render
    draws them: (ro 3 planes, rd 3 planes, RNG states after the draw)."""
    dev = scene.device
    if px is None:
        yy, xx = torch.meshgrid(torch.arange(cfg.height, device=dev),
                                torch.arange(cfg.width, device=dev),
                                indexing="ij")
        px, py = xx.reshape(-1), yy.reshape(-1)
    st = tc.seed_pixels(px, py, frame)
    st, ur = tc.rand01(st)
    st, vr = tc.rand01(st)
    u = (px.to(torch.float32) + ur) * float(np.float32(cfg.inv_width))
    v = (py.to(torch.float32) + vr) * float(np.float32(cfg.inv_height))
    st, ro, rd = tc.camera_get_ray(camera_scalars(scene, cfg), u, v, st)
    return ro, rd, st


def workload(port: ChunkedScenePort, cfg: RenderConfig,
             frame: int = 0) -> Workload:
    """K6's workload on `port`'s scene (one K5 launch for the hits)."""
    scene = port.scene
    cam_ro, cam_rd, st = camera_rays(scene, cfg, frame)
    hit_t, hit_id = port.hit_chunks(cam_ro, cam_rd, cfg.min_t, cfg.max_t)
    idl = hit_id.long()
    mat = scene.mat_ids().long()
    sel = ((idl >= 0) & (mat[idl.clamp_min(0)] == 0)).nonzero().squeeze(1)
    pos = tuple((o + d * hit_t)[sel] for o, d in zip(cam_ro, cam_rd))
    st_l, _ = tc.random_unit_vector(st[sel])
    tab = cuda_render.pack_scene(scene)
    lights = list(scene.emissive_ids)
    _, cones = tc.nee_cones(tab, lights, pos, idl[sel],
                            torch.ones_like(sel, dtype=torch.bool), st_l)
    dirs = [c[2] for c in cones]
    t_min = float(np.float32(cfg.min_t))
    t_ls = [tc.sphere_t(tab[0, e], tab[1, e], tab[2, e], tab[3, e], pos, l,
                        t_min)[0] for e, l in zip(lights, dirs)]
    return Workload(pos, dirs, t_ls, lights, cam_ro, cam_rd, hit_t, hit_id,
                    st)


def form_stats(port: ChunkedScenePort, wl: Workload, cfg: RenderConfig,
               form: str):
    """One counted launch of K6's `form` on the workload: (bits, summary
    dict)."""
    flat = tuple(x for l in wl.dirs for x in l)
    bits, st = cuda_scaled.shadow_chunks_form(
        port.rows, wl.pos, flat, tuple(wl.t_ls), port.scene.chunk,
        wl.lights, float(np.float32(cfg.min_t)), form,
        index=port.chunk_index, stats=True)
    s = st["shadow"]
    n = int(bits.numel())
    pairs = n * len(wl.lights)
    occluded = sum(int(((bits >> k) & 1).sum())
                   for k in range(len(wl.lights)))
    return bits, {
        "form": form, "rays": n, "pairs": pairs, "counters": s,
        "simt_efficiency": s["simt_efficiency"],
        "box_steps_per_warp_call": s["boxes"] / max(s["calls"], 1),
        "slab_tests_per_pair": s["slabs"] / max(s["lanes"], 1),
        "sphere_tests_per_pair": s["need"] / max(s["lanes"], 1),
        "trips_per_warp_call": s["trips"] / max(s["calls"], 1),
        "occluded_share": occluded / max(pairs, 1)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help=f"output path (default {OUT})")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("shadow_stats: needs a CUDA device")
    port = ChunkedScenePort(make_scaled_scene(SPHERES).to("cuda"))
    wl = workload(port, CFG, FRAME)
    bits, forms = {}, []
    for f in FORMS:
        bits[f], summary = form_stats(port, wl, CFG, f)
        forms.append(summary)
    torch.cuda.synchronize()
    res = {"device": torch.cuda.get_device_name(0),
           "config": {"spheres": port.scene.n_spheres,
                      "chunks": port.scene.n_chunks, "width": CFG.width,
                      "height": CFG.height, "frame": FRAME,
                      "lights": len(wl.lights)},
           "forms": forms,
           "bits_equal": bool(torch.equal(*bits.values()))}
    out = Path(args.out) if args.out else OUT
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
