"""Where the gradient kernel (K3) and the differentiable wavefront's sweep
spend their SM cycles.

    python -m toypathtracer_torch.tools.grad_stats [--forms replay,warp]
        [--width 1280] [--height 720] [--spp 4] [--depth 10] [--frame 0]
        [--soft-eps 0.05] [--scaled N] [--out PATH]
    python -m toypathtracer_torch.tools.grad_stats --forms wave

Launches each form's stats instance once (ops/cuda_grad.
render_tile_grad_form with stats=True) on the 46-sphere frame for a
random pixel cotangent (numpy seed 11), and reports its SM-cycle counters
(csrc/trace.cuh kGc*) as shares of its threads' cycles, its work counts,
and the form's final sum of the per-block partials timed alone with CUDA
events (ops/cuda_grad.sum_partials).  The counters are summed over
threads, and the clock reads cost cycles of their own, so the shares are
what to read, not the totals.  "other" is what no part holds: staging the
scene, the ray count, and the waits of threads whose pixels ended early.
With --soft-eps > 0 each form's soft instance runs (the soft-silhouette
estimator); the warp form's "soft" share is then the cycles of its
silhouette and shadow-boundary scans and their adjoints' setup, a part of
"adj" as "group" is.

With --scaled N the chunked instance's stats instance runs instead, on
make_scaled_scene(N) (chunk_stats: the forward trace, the reverse sweep
and the soft scans).

The form "wave" is the differentiable wavefront's sweep over the tape of
K1's staged tape instance for that frame (wave_stats): the stats
instances of the redesigned sweep (csrc/wavesweep.cu wave_run_kernel,
wavesweep.cuh sweep_runs) on the kept sweep's deal, grid and launch
bounds ("runs_on_tiles_deal"), where its cotangent is the kept sweep's
(csrc/wavegrad.cu wave_sweep_kernel) bit for bit and its counters split
the kept schedule's loop into the tape reads, the queue's claims and the
bounces' adjoint (with, inside it, the hit's grouping); and as the main
path runs it ("runs": sorted blocks, the fused adds).  Each with its wait
at the block's end, its lane busy share (adjoint bounces / lane slots)
and, where the build kept its -Xptxas -v report, its registers and
spills.

Needs a card: cycle counts and times are never taken on the CPU.  Writes
build/grad_stats_torch.json at the root of the checkout (or --out) and
prints the same JSON.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..config import RenderConfig
from ..ops import cuda_grad
from ..profiling import time_device_call
from ..scene import make_scene

OUT = Path(__file__).resolve().parents[2] / "build" / "grad_stats_torch.json"

PARTS = ("fwd", "replay", "adj", "group", "zero", "reduce", "soft")
# Parts counted inside "adj".
WITHIN_ADJ = ("group", "soft")
# The sweeps' parts: inside "adj" (the sweep loop) the tape reads, the
# queue's claims and the bounces' adjoint, inside which "group"; and
# outside it the wait at the block's end for its other warps.
WAVE_PARTS = ("adj", "tape", "queue", "bounce", "group", "zero", "reduce",
              "wait")


def cotangent(height: int, width: int, seed: int = 11, device="cuda"):
    """The pixel cotangent the gradient measurements use: uniform [0, 1)
    from a seeded numpy generator."""
    g = np.random.RandomState(seed).rand(height, width, 3)
    return torch.from_numpy(g.astype(np.float32)).to(device)


def form_stats(scene, cfg: RenderConfig, form: str, g, frame: int = 0,
               sum_repeats: int = 20) -> dict:
    """One stats launch of K3's `form` over the whole frame and the form's
    final sum timed alone; `scene` and `g` on the card."""
    H, W = cfg.height, cfg.width
    _, rays, _, c = cuda_grad.render_tile_grad_form(
        scene, cfg, frame, g, 0, 0, H, W, form, stats=True)
    total = c["cycles_all"]
    shares = {k: c[f"cycles_{k}"] / total for k in PARTS}
    # the warp form's grouping and soft scans run inside its adjoint sweep
    shares["other"] = 1.0 - sum(v for k, v in shares.items()
                                if k not in WITHIN_ADJ)
    rows, _ = cuda_grad.grad_scratch(scene, cfg, frame, 0, 0, H, W, form)
    partial = torch.ones((rows, 14, scene.n_spheres), dtype=torch.float32,
                         device=scene.device)
    cuda_grad.sum_partials(partial, form)
    sum_s, _ = time_device_call(cuda_grad.sum_partials, partial, form,
                                repeats=sum_repeats)
    samples = H * W * cfg.samples_per_pixel
    out = {"form": form, "soft_eps": cfg.soft_silhouette_eps,
           "rays": int(rays), "counters": c,
           "cycle_shares": shares,
           "adjoint_bounces_per_sample": c["adj_bounces"] / samples,
           "partial_rows": rows, "sum_ms": sum_s * 1e3}
    if form == "replay":
        out["replayed_bounces_per_adjoint_bounce"] = (
            c["replay_bounces"] / max(c["adj_bounces"], 1))
    else:
        out["reverse_lane_busy"] = c["adj_bounces"] / max(c["adj_slots"], 1)
        out["mean_hit_group"] = c["hit_lanes"] / max(c["hit_groups"], 1)
    return out


def chunk_stats(scene, cfg: RenderConfig, g, frame: int = 0) -> dict:
    """One launch of the stats instance of K3's chunked instance
    (csrc/grad.cu chunk_grad_stats_kernel, the per-lane chunk walks)
    over the whole frame of a ScaledScene on the card: the shares of its
    threads' SM cycles in the forward trace, the reverse sweep and, inside
    the sweep, the grouping and the soft scans (the silhouette and
    shadow-boundary scans with their adjoints' setup)."""
    from ..ops import cuda_scaled
    H, W = cfg.height, cfg.width
    _, rays, _, c = cuda_scaled.render_tile_scaled_grad_form(
        scene, cfg, frame, g, 0, 0, H, W, "chunk", stats=True)
    total = c["cycles_all"]
    shares = {k: c[f"cycles_{k}"] / total
              for k in ("fwd", "adj", "group", "soft")}
    shares["other"] = 1.0 - shares["fwd"] - shares["adj"]
    samples = H * W * cfg.samples_per_pixel
    return {"form": "chunk", "soft_eps": cfg.soft_silhouette_eps,
            "spheres": scene.n_spheres, "rays": int(rays), "counters": c,
            "cycle_shares": shares,
            "adjoint_bounces_per_sample": c["adj_bounces"] / samples,
            "reverse_lane_busy": c["adj_bounces"] / max(c["adj_slots"], 1)}


def wave_stats(scene, cfg: RenderConfig, g, frame: int = 0) -> list:
    """The differentiable wavefront's sweeps' stats instances over the
    frame's tape (K1's staged tape instance; `scene` and `g` on the card):
    the redesigned sweep on the kept sweep's deal, grid and launch bounds
    ("runs_on_tiles_deal") and as the main path runs it ("runs").  Each
    entry: its counters, their shares of the threads' cycles ("adj" the
    sweep loop; within it "tape", "queue", "bounce" and their remainder
    "loop_other"; "group" within "bounce"; "wait" at the block's end;
    "other", staging the scene and a sorted block's counting sort), the
    lane busy share, whether its cotangent is the timed kept sweep's bit
    for bit (the first must be), and the largest over the 14 rows of max
    |its cotangent - the kept sweep's| / the row's max |value|."""
    from ..ops import _build
    H, W = cfg.height, cfg.width
    wcfg = cfg.replace(merged_wavefront=True, diff_wavefront=True)
    _, _, tape = cuda_grad.render_tile_wave_tape(scene, wcfg, frame, 0, 0,
                                                 H, W)
    kept = cuda_grad.sweep_wave_tape(scene, wcfg, g, tape, form="tiles")
    lib = _build.build()
    report = lib.with_suffix(".ptxas.txt")
    usage = (_build.ptxas_usage(report.read_text()) if report.exists()
             else {})
    out = []
    samples = H * W * cfg.samples_per_pixel
    for form in ("runs_on_tiles_deal", "runs"):
        d, c = cuda_grad.sweep_wave_tape(scene, wcfg, g, tape, form=form,
                                         stats=True)
        total = c["cycles_all"]
        shares = {k: c[f"cycles_{k}"] / total for k in WAVE_PARTS}
        shares["loop_other"] = shares["adj"] - sum(
            shares[k] for k in ("tape", "queue", "bounce"))
        shares["other"] = 1.0 - sum(shares[k] for k in (
            "adj", "zero", "reduce", "wait"))
        err = (d - kept).abs().amax(dim=1)
        scale = kept.abs().amax(dim=1)
        rel = torch.where(scale > 0, err / scale.clamp_min(1e-30),
                          torch.where(err > 0, torch.inf, 0.0))
        out.append({
            "sweep": form, "counters": c, "cycle_shares": shares,
            "adjoint_bounces_per_sample": c["adj_bounces"] / samples,
            "reverse_lane_busy": c["adj_bounces"] / max(c["adj_slots"], 1),
            "mean_hit_group": c["hit_lanes"] / max(c["hit_groups"], 1),
            "bit_equal_to_tiles": bool(torch.equal(d, kept)),
            "row_rel_vs_tiles": float(rel.max()),
            "ptxas": {"stats": usage.get(cuda_grad.SWEEP_STATS_LABELS[form],
                                         {}),
                      "timed": usage.get(cuda_grad.SWEEP_LABELS[form], {})}})
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--forms", default="replay,warp")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--frame", type=int, default=0)
    ap.add_argument("--soft-eps", type=float, default=0.0,
                    help="the soft-silhouette estimator's eps (0: off)")
    ap.add_argument("--scaled", type=int, default=0,
                    help="the chunked instance on make_scaled_scene(N) "
                         "instead of the forms on the 46-sphere scene")
    ap.add_argument("--out", default=None,
                    help=f"output path (default {OUT})")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("grad_stats: needs a CUDA device")
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=args.spp, max_depth=args.depth,
                       soft_silhouette_eps=args.soft_eps)
    g = cotangent(cfg.height, cfg.width)
    res = {"device": torch.cuda.get_device_name(0),
           "config": {"width": cfg.width, "height": cfg.height,
                      "spp": cfg.samples_per_pixel,
                      "max_depth": cfg.max_depth, "frame": args.frame,
                      "soft_eps": args.soft_eps}}
    if args.scaled:
        from ..scaled import make_scaled_scene
        scene = make_scaled_scene(args.scaled).to("cuda")
        res["forms"] = [chunk_stats(scene, cfg, g, args.frame)]
    elif args.forms == "wave":
        res["forms"] = wave_stats(make_scene(big=True).to("cuda"), cfg, g,
                                  args.frame)
    else:
        scene = make_scene(big=True).to("cuda")
        res["forms"] = [form_stats(scene, cfg, f, g, args.frame)
                        for f in args.forms.split(",")]
    out = Path(args.out) if args.out else OUT
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
