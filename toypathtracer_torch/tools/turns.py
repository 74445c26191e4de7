"""Times the main path's kernels and the training step of several checkouts
of the port in turns, on one card.

    python -m toypathtracer_torch.tools.turns DIR [DIR ...] [--rounds 4]
        [--metrics k1_ms,k2_ms,step_ms,k6_ms,k5_ms,k3_ms,k3_soft_ms,
                   scaled_ms]
        [--out PATH]

Each DIR is the root of a checkout of the repo (this one is "."; an older
commit can be unpacked with `git archive` into a directory that
.gitignore lists).  Each round starts one process per checkout, in the
order given in even rounds and reversed in odd ones (A B, B A, ...).  Each
process imports its own checkout's package, renders one warm-up frame
(which builds its kernels), and times at the reference workload
(make_scene(big=True), 1280x720, spp 4, depth 10, frame 0):

- "k1_ms": ops.cuda_render.render_tile, the render kernel's wrapper call,
  CUDA events over 16 calls (profiling.time_device_call);
- "k2_ms": ops.cuda_render.render_tile_stats, the stats render kernel's,
  likewise;
- "step_ms": the training step of chip_smoke.py's grad_timing
  (InverseRenderer, albedo, Adam, image_l2), on the host clock over 5
  steps ending in torch.cuda.synchronize(), 3 times after 2 warm-up
  steps; the process reports their mean and each;
- "k6_ms": ops.cuda_scaled.shadow_chunks on tools.shadow_stats's workload
  (the 100k-sphere scene's frame-0 ray-light pairs) with the port's
  chunk index, CUDA events over 16 calls, where the checkout has that
  tool;
- "k5_ms": ops.cuda_scaled.hit_chunks on the same workload's camera rays
  (frame 0's 921,600) with the port's index, CUDA events over 16 calls,
  where the checkout has that tool;
- "k3_ms", "k3_soft_ms": ops.cuda_grad.render_tile_grad_form's warp form
  (the gradient kernel on the training step's path) for a seeded uniform
  pixel cotangent, hard and with soft_silhouette_eps 0.05, CUDA events
  over 8 calls after one warm-up call;
- "scaled_ms": ops.cuda_scaled.render_tile_scaled, the scaled render
  kernel's wrapper call on make_scaled_scene(100_000) at the same config,
  CUDA events over 4 calls after one warm-up call.

--metrics times only the metrics named (default all).

Prints each process's JSON object as it ends, then per checkout and
metric the runs, their mean, min and max; writes all of it to --out
(default build/turns.json of this checkout) and exits non-zero if a
process failed.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

OUT = Path(__file__).resolve().parents[2] / "build" / "turns.json"

# One timing process; runs from the root of the checkout it times.
CHILD = r'''
import json, os, time
import numpy as np
import torch
from toypathtracer_torch.config import RenderConfig
from toypathtracer_torch.inverse import InverseRenderer
from toypathtracer_torch.ops import cuda_render, cuda_scaled
from toypathtracer_torch.profiling import time_device_call
from toypathtracer_torch.scene import make_scene

cfg = RenderConfig(width=1280, height=720, samples_per_pixel=4, max_depth=10)
H, W = cfg.height, cfg.width
want = os.environ["TURNS_METRICS"].split(",")
scene = make_scene(big=True).to("cuda")
target, _ = cuda_render.render_frame(scene, cfg, 0)
r = {}
if "k1_ms" in want:
    r["k1_ms"] = time_device_call(cuda_render.render_tile, scene, cfg, 0, 0,
                                  0, H, W, repeats=16)[0] * 1e3
if "k2_ms" in want:
    cuda_render.render_tile_stats(scene, cfg, 0)
    r["k2_ms"] = time_device_call(cuda_render.render_tile_stats, scene, cfg,
                                  0, repeats=16)[0] * 1e3
if "step_ms" in want:
    rng = np.random.default_rng(7)
    jit = rng.normal(0, 0.15, scene.albedo.shape).astype(np.float32)
    jit[list(scene.emissive_ids)] = 0.0
    start = scene.replace(albedo=torch.clamp(
        scene.albedo + torch.from_numpy(jit).to("cuda"), 0.02, 0.98))
    inv = InverseRenderer(cfg, target, trainable=("albedo",),
                          learning_rate=2e-2)
    inv.fit(start, steps=2, resample=False)
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inv.fit(start, steps=5, resample=False)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) / 5 * 1e3)
    r["step_ms"], r["step_ms_runs"] = sum(runs) / len(runs), runs
try:
    from toypathtracer_torch.tools import shadow_stats
except ImportError:
    shadow_stats = None
if shadow_stats is not None and {"k5_ms", "k6_ms"} & set(want):
    from toypathtracer_torch.scaled import ChunkedScenePort, make_scaled_scene
    port = ChunkedScenePort(make_scaled_scene(100_000).to("cuda"))
    wl = shadow_stats.workload(port, cfg)
    # the index's name before it was chunk_index
    index = getattr(port, "chunk_index", None) or port.shadow_index
    if "k6_ms" in want:
        args = (port.rows, wl.pos, tuple(x for d in wl.dirs for x in d),
                tuple(wl.t_ls), port.scene.chunk, wl.lights,
                float(np.float32(cfg.min_t)))
        k6 = lambda: cuda_scaled.shadow_chunks(*args, index=index)
        k6()
        r["k6_ms"] = time_device_call(k6, repeats=16)[0] * 1e3
    if "k5_ms" in want:
        k5 = lambda: port.hit_chunks(wl.cam_ro, wl.cam_rd, cfg.min_t,
                                     cfg.max_t)
        k5()
        r["k5_ms"] = time_device_call(k5, repeats=16)[0] * 1e3
for key, eps in (("k3_ms", 0.0), ("k3_soft_ms", 0.05)):
    if key not in want:
        continue
    from toypathtracer_torch.ops import cuda_grad
    g = torch.from_numpy(np.random.RandomState(11).rand(H, W, 3)
                         .astype(np.float32)).to("cuda")
    c = cfg.replace(soft_silhouette_eps=eps)
    args = (scene, c, 0, g, 0, 0, H, W, "warp")
    cuda_grad.render_tile_grad_form(*args)
    r[key] = time_device_call(cuda_grad.render_tile_grad_form, *args,
                              repeats=8)[0] * 1e3
if "scaled_ms" in want:
    from toypathtracer_torch.scaled import make_scaled_scene
    ss = make_scaled_scene(100_000).to("cuda")
    cuda_scaled.render_tile_scaled(ss, cfg, 0, 0, 0, H, W)
    r["scaled_ms"] = time_device_call(cuda_scaled.render_tile_scaled, ss,
                                      cfg, 0, 0, 0, H, W,
                                      repeats=4)[0] * 1e3
print(json.dumps(r), flush=True)
'''

METRICS = ("k1_ms", "k2_ms", "step_ms", "k6_ms", "k5_ms", "k3_ms",
           "k3_soft_ms", "scaled_ms")


def run_child(root: Path, metrics) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root),
               TURNS_METRICS=",".join(metrics))
    p = subprocess.run([sys.executable, "-c", CHILD], cwd=root, env=env,
                       capture_output=True, text=True, timeout=900)
    if p.returncode != 0:
        return {"error": p.stderr[-2000:], "rc": p.returncode}
    return json.loads(p.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--metrics", default=",".join(METRICS))
    ap.add_argument("--out", default=None,
                    help=f"output path (default {OUT})")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("turns: needs a CUDA device")
    roots = [Path(d).resolve() for d in args.dirs]
    metrics = args.metrics.split(",")
    if not set(metrics) <= set(METRICS):
        raise SystemExit(f"turns: metrics are {METRICS}, got {metrics}")
    runs = []
    for k in range(args.rounds):
        for root in (roots if k % 2 == 0 else roots[::-1]):
            r = {"dir": str(root), "round": k, **run_child(root, metrics)}
            print(json.dumps(r), flush=True)
            runs.append(r)
    summary = {}
    for root in roots:
        mine = [r for r in runs if r["dir"] == str(root)]
        summary[str(root)] = {
            m: {"runs": v, "mean": sum(v) / len(v), "min": min(v),
                "max": max(v)}
            for m in METRICS
            if (v := [r[m] for r in mine if m in r])}
    res = {"device": torch.cuda.get_device_name(0), "runs": runs,
           "summary": summary}
    out = Path(args.out) if args.out else OUT
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(json.dumps({"summary": summary}), flush=True)
    return 1 if any("error" in r for r in runs) else 0


if __name__ == "__main__":
    sys.exit(main())
