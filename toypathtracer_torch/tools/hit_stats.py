"""The chunk-traversal kernel (K5) at work: its two forms' counted instances.

    python -m toypathtracer_torch.tools.hit_stats [--out PATH]

K5's workload as the scaled path queries it (ChunkedScenePort.hit_chunks)
on the 100k-sphere scene (make_scaled_scene(SPHERES)) at 1280x720: the
first camera ray of each pixel of frame 0, 921,600 rays.  Launches each
form's counted instance once on those rays (ops/cuda_scaled.hit_chunks_form
with stats=True):

- "thread", the per-thread form (hit_chunks_kernel<1>: a thread a
  ray, hit_chunks_ray over every chunk box in the rows' order, a warp step
  counted for the lanes active in it);
- "coop", the main path's warp-cooperative form (coop_hit_kernel<1>: the
  group boxes of scaled.chunk_index as the prefilter, then the kept
  chunks in the rows' order).

For each: per ray the slab tests (for "coop" the group boxes' and the
chunk boxes' apart), chunks entered and sphere tests; the sphere-loop SIMT
efficiency (the tests the rays needed over 32 x the trips the warps ran);
per warp call the box steps and the sphere-loop trips; and whether its ids
and t equal the other form's bit for bit.  Beside them, from the plain
slab arithmetic (scaled._slabs) on the same rays: the chunk boxes a ray
crosses at all, the rays that enter chunk 0 and the share of the sphere
tests spent there, the rays whose hit lies in chunk 0, the rays that hit,
and the groups of GROUP chunks a ray enters at its initial bound over the
rows' order and over the index's order, per ray and per warp of 32
consecutive rays.  Needs a card.  Writes build/hit_stats_torch.json at the
root of the checkout (or --out) and prints the same JSON.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..config import RenderConfig
from ..ops import cuda_scaled
from ..scaled import (ChunkedScenePort, _slabs, group_boxes,
                      make_scaled_scene, safe_inv)
from .shadow_stats import camera_rays

OUT = Path(__file__).resolve().parents[2] / "build" / "hit_stats_torch.json"
SPHERES = 100_000
CFG = RenderConfig(width=1280, height=720, samples_per_pixel=4, max_depth=10)
FRAME = 0
FORMS = ("thread", "coop")
# rays a batch of the plain slab counts (391 chunks x this many floats)
BATCH = 1 << 16


def form_stats(port: ChunkedScenePort, ro, rd, cfg: RenderConfig,
               form: str):
    """One counted launch of K5's `form` on the rays: (t, ids, summary
    dict)."""
    t, hid, st = cuda_scaled.hit_chunks_form(
        port.rows, ro, rd, port.scene.chunk, cfg.min_t, cfg.max_t, form,
        index=port.chunk_index, stats=True)
    h = st["hit"]
    rays = max(h["lanes"], 1)
    calls = max(h["calls"], 1)
    group_slabs = st["groups"]["slabs"]
    return t, hid, {
        "form": form, "rays": int(hid.numel()), "counters": st,
        "simt_efficiency": h["simt_efficiency"],
        "slab_tests_per_ray": (h["slabs"] + group_slabs) / rays,
        "chunk_slab_tests_per_ray": h["slabs"] / rays,
        "group_slab_tests_per_ray": group_slabs / rays,
        "chunks_entered_per_ray": h["need"] / port.scene.chunk / rays,
        "sphere_tests_per_ray": h["need"] / rays,
        "box_steps_per_warp_call": h["boxes"] / calls,
        "trips_per_warp_call": h["trips"] / calls}


def plain_counts(port: ChunkedScenePort, ro, rd, hit_id, cfg: RenderConfig):
    """The counts that do not depend on a form, from the plain slab chain
    at each ray's initial bound (t_min, t_max)."""
    rows, K = port.rows, port.scene.chunk
    t_min = float(np.float32(cfg.min_t))
    t_max = float(np.float32(cfg.max_t))
    box = rows[:, 4 * K:4 * K + 6]
    boxes = {"chunks": box, "groups_rows_order": group_boxes(rows, K),
             "groups_index_order": port.chunk_index.gbox}
    n = int(ro[0].numel())
    crossed = {k: torch.zeros((n,), dtype=torch.int64, device=ro[0].device)
               for k in boxes}
    chunk0 = torch.zeros((n,), dtype=torch.bool, device=ro[0].device)
    warp = {k: 0 for k in boxes if k != "chunks"}
    for s in range(0, n, BATCH):
        sl = slice(s, min(s + BATCH, n))
        o = tuple(x[sl] for x in ro)
        inv = tuple(safe_inv(x[sl]) for x in rd)
        for k, b in boxes.items():
            t0, t1 = _slabs(b, o, inv, t_min)
            enter = t0 <= torch.clamp_max(t1, t_max)   # (boxes, rays)
            crossed[k][sl] = enter.sum(dim=0)
            if k == "chunks":
                chunk0[sl] = enter[0]
            else:
                # groups a warp of 32 consecutive rays enters (BATCH and
                # the batch starts are multiples of 32)
                m = enter.shape[1] // 32 * 32
                warp[k] += int(enter[:, :m].reshape(b.shape[0], -1, 32)
                               .any(dim=2).sum())
    warps = n // 32
    tests_chunk0 = K * int(chunk0.sum())
    return {
        "chunk_boxes_crossed_per_ray": float(crossed["chunks"].double()
                                             .mean()),
        "rays_entering_chunk0": float(chunk0.double().mean()),
        "tests_in_chunk0": tests_chunk0,
        "rays_hit_in_chunk0": float(((hit_id >= 0) & (hit_id < K)).double()
                                    .mean()),
        "rays_hit": float((hit_id >= 0).double().mean()),
        "groups": {k: {"of": int(boxes[k].shape[0]),
                       "entered_per_ray": float(crossed[k].double().mean()),
                       "entered_per_warp": warp[k] / max(warps, 1)}
                   for k in warp}}


def measure(port: ChunkedScenePort, cfg: RenderConfig = CFG,
            frame: int = FRAME) -> dict:
    """Both forms' counted instances and the plain counts on K5's workload
    of `port`'s scene."""
    ro, rd, _ = camera_rays(port.scene, cfg, frame)
    out, forms = {}, []
    for f in FORMS:
        t, hid, summary = form_stats(port, ro, rd, cfg, f)
        out[f] = (t, hid)
        forms.append(summary)
    (t_a, id_a), (t_b, id_b) = out.values()
    plain = plain_counts(port, ro, rd, id_a.long(), cfg)
    for f in forms:
        f["share_of_tests_in_chunk0"] = plain["tests_in_chunk0"] / max(
            f["counters"]["hit"]["need"], 1)
    torch.cuda.synchronize()
    return {"device": torch.cuda.get_device_name(0),
            "config": {"spheres": port.scene.n_spheres,
                       "chunks": port.scene.n_chunks, "width": cfg.width,
                       "height": cfg.height, "frame": frame},
            "forms": forms, "plain": plain,
            "bit_equal": bool(torch.equal(id_a, id_b)
                              and torch.equal(t_a.view(torch.int32),
                                              t_b.view(torch.int32)))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help=f"output path (default {OUT})")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("hit_stats: needs a CUDA device")
    res = measure(ChunkedScenePort(make_scaled_scene(SPHERES).to("cuda")))
    out = Path(args.out) if args.out else OUT
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
