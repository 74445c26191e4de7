"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and hold its
kernel against the plain PyTorch version.

    python3 chip_smoke.py

Phases (one JSON line each on stdout; any failure raises and exits
non-zero):
  1. device: the card, torch/CUDA versions, the nvcc build of csrc/;
     each kernel's registers, stack and spills from -Xptxas -v, with the
     per-thread K1, K3 (both forms' hard instances and the warp form's
     soft one; the replaying soft instance's counts recorded in phase
     7g), K4's per-thread form, both K5 forms,
     both K6 forms, both K2 forms, the per-lane and the cooperative scaled
     render kernels and the merged K1 held at their counts, the
     differentiable wavefront's pair (K1's staged and scalar tape
     instances, the sweeps, the redesigned sweep) at their first counts;
     the 16-light
     instances of K3's warp and replaying forms and the cooperative
     scaled render kernel held at the SASS they had before their lights
     instances, the merged K1, its counted instance and the merged K2 at
     the SASS they had before K1's tape instance, and K1's scalar tape
     instance, the sweeps and the scaled tape-writing render at the SASS
     they had before the staged one (KEPT_SASS digests, where the
     toolkit is the one they were taken with).
  2. kernel vs plain at 320x176, spp 2, depth 6, frames 0-3: the big
     scene, the big scene without light sampling, the small scene; in each
     the merged K1 (the main path's) bit-equal to the per-thread K1 it
     replaced and K4 bit-equal to it; then 600 spheres (past the
     per-thread kernels' 512) against plain.
  3. the main path: RenderSession(device="cuda") at 1280x720, spp 4,
     depth 10, 46 spheres, 16 progressive frames plus one animated frame;
     frame 0's rays against the plain version and the TPU's frame-0 count,
     the 16-frame image against 16 plain frames (8x8 block gates), one
     merged-K1 launch per frame and none of the per-thread K1; frame 0,
     the animated frame and the 16-frame image bit-equal to the per-thread
     K1's.
  4. K1's step 1 and counted instance (tools.render_parts: the per-thread
     K1's cycles by part, the merged K1's lane busy share and cycles by
     part), tools.sass_loops (the sphere loops' instruction mix); timing
     with CUDA events: 64 steady frames after 4 warm-up frames, the merged
     and per-thread K1 in turns.
  5. gradient kernel (K3: its warp form, the main path's, and the
     replaying form it replaced, the baseline) and lockstep kernel (K4)
     vs plain autograd at 320x176, spp 2, depth 4, the big and the small
     scene, frames 0-1, and the warp form on a 130-sphere scene; each
     form bit-equal launch to launch.
  6. the training path at 1280x720, spp 4, depth 10, 46 spheres:
     InverseRenderer Adam steps from a perturbed albedo (one render and
     one warp-form gradient launch a step; with lockstep_primal, one
     lockstep and one gradient launch; none of the per-thread K1 or K4),
     both K3 forms' full-frame
     gradients against 45 plain bands and finite differences, the warp
     form's against its own 45 bands and one band against plain.
  7. K3's cycle shares by part (tools.grad_stats: both forms' stats
     instances, and each form's final sum timed alone); the warp and
     replay forms timed in turns with CUDA events, and K4's merged and
     per-thread forms; the training step on the host clock.
 7b. K3's soft instances (the soft-silhouette estimator, eps 0.05) at
     1280x720, spp 4, depth 10: both forms against plain autograd over the
     frame's 45 bands (per row within 1e-3), the image bit-equal to K3 at
     eps 0 and to K1, rays exact, two launches bit-equal, 45 soft band
     launches summing to the frame.
 7c. finite differences of sum(img * w) on sphere 2's x and radius, 32
     frames a side, against K3's soft and hard instances: the soft sign.
 7d. the training path with trainable centres and radii (InverseRenderer,
     tonemapped loss, 10 Adam steps): one render and one soft K3 launch a
     step and no other gradient launch, the loss finite and lower after
     the fit than before it, ms/step; the hard instance's fit from the
     same start beside it.
 7e. the motion AD-vs-FD check of tests/test_motion.py:33 (96x32, spp 2,
     depth 2, eps 0.02, t 0.7, dt 0.05, 32 frames) through K3's soft
     instance: sign equal, rel err < 0.40; the hard instance's beside it.
 7f. demo_motion at its defaults (192x108, 150 Adam steps): the loss
     falls; t_abs_err printed.
 7g. the soft instances' cycle shares (tools.grad_stats), both forms'
     soft and hard instances timed in turns, the soft bound from the plain
     version's soft counters.
  8. the scaled path (make_scaled_scene(100_000): 100,096 spheres in 391
     chunks, 8 beacons) at 1280x720, spp 4, depth 10: RenderSession, 4
     progressive frames plus 1 animated frame (one launch a frame of the
     warp-cooperative scaled render kernel, none of the per-lane form),
     and the ChunkedScenePort queries on frame 0's camera rays (K5) and
     on their first Lambert hits' cone samples (K6); one launch each of
     K5's and K6's cooperative forms, none of the per-thread forms.
  9. K5 on the camera rays and on 65,536 random rays, the cooperative form
     bit-equal (ids and t) to the per-thread form it replaced and
     within its gates of plain; both K5 forms' counted instances
     (tools.hit_stats: step 1's slab and sphere tests, chunk 0's share,
     SIMT efficiency; the sphere tests equal to plain's), the two timed
     in turns, the old and the new bound; K6 on the camera
     rays' hits and on 65,536 random rays toward the beacons, the
     cooperative form bit-equal to the per-thread form it replaced and
     within its gate of plain; both K6 forms' counted instances
     (tools.shadow_stats: step 1's SIMT efficiency, box steps, occluded
     share), the two timed in turns, the old and the new bound; the scaled render
     kernel vs plain at 320x176 / spp 1 / depth 4 (frames 0-1), on a
     16-row band and on the full frame at full size (whose plain work
     counts give the bounds), and in every one of those and on the
     animated frame bit-equal to the per-lane form; both forms' stats
     instances on frame 0 (image
     bit-equal, the hit rays' sphere tests equal to the plain count, and
     the per-lane form's shadow and slab tests; sphere-loop SIMT
     efficiency for hit and shadow calls; the cooperative form's cycles
     by part of the path loop).
 10. scaled timing with CUDA events: the cooperative and per-lane forms
     in turns at 1280x720 and 320x176; the session; bounds from the
     lesser, term by term, of the plain version's work counters and the
     cooperative stats instance's (at 320x176 its second launch).
 11. the stats render kernel (K2, its merged form) at 320x176, spp 2,
     depth 6, frames 0-1: 16x128 tiles unmerged, a padded shape (32x128
     tiles, 2 pixels a lane, merged) and 600 spheres; image and rays
     bit-equal to the merged K1's, image, rays and the five counter planes
     equal to the per-thread form's (render_kernel<1>; not at 600), trip
     counts, tile and warp counters against the plain version.
 12. K2's main path: tools.occupancy at its defaults (1280x720, spp 4,
     depth 10, 16x128 tiles, frame 0), one merged K2 launch and none of
     the per-thread form; rays, work and iters against the TPU's counts;
     both forms equal on the full frame; the merged K1 and K2's two forms
     timed in turns; the per-thread K1's warp work efficiency from K2's
     counters beside the plain version's.
 13. the issue-rate probe (T1): six cases at 64 trips against their plain
     versions, the launch floor (T2) against its plain version; then
     tools.roofline's main path: the full-size rates, both floors, the SM
     clock under load, and every thread of each case's and each floor's
     launches against the plain version.
 14. the gradient kernel's pool instance (K3 with a table per warp in
     device memory, found through a block directory): bit-equal to the
     warp form on its grid at 46 and 130 spheres, hard and soft; at 600
     spheres (past the warp form's 512) against plain autograd at
     320x176, hard and soft; at 40 lights (past the carry record's 16
     bits) the warp form's lights instance and the pool form against
     plain autograd and bit-equal to each other; Adam steps on the
     600-sphere scene at 1280x720 (one render and one pool launch a
     step); timed in turns with the warp form at 46 spheres.
 15. the scaled scene's gradient, render_frame_scaled(differentiable=
     True) on the 100k-sphere scene at 1280x720, spp 4, depth 10, hard
     and eps 0.05: one tape-writing render (its tape held across
     autograd: the bytes the forward leaves allocated) and one sweep
     launch each; step 1's cycle shares of the per-lane chunked instance.
 16. the cooperative chunked K3 there: rays equal to plain, the image
     bit-equal to the scaled render kernel's, the cotangent bit-equal to
     the per-lane chunk_grad_kernel on its grid, per row within 1e-3 of plain
     autograd on three 8-row bands, two launches bit-equal, albedo AD vs
     FD, the two forms timed in turns and the tape render and the sweep
     alone, the directory's (<= 420 MB) and the tape's bytes, the bounds
     from the plain version's work counters.
 17. the reference's configuration (2000 spheres, chunk 64, 32x8, spp 1,
     depth 3, hard and eps 1.0, and with 40 lights) against plain, and
     the geometry recovery of tests/test_scaled.py:305 through the soft
     instance (60 Adam steps, one tape render and one soft sweep a step):
     final error < 0.4 x initial, final loss < 0.2 x first.
 17b. wavefront_grad: the differentiable wavefront (cfg.diff_wavefront)
     at the reference workload with the flag on: 4 InverseRenderer Adam
     steps (one tape-instance and one sweep launch a step, none of the
     kept sweep, no warning, the loss falling), K1's staged tape instance
     bit-equal to K1 (image, rays) and its tape word for word the scalar
     instance's at every used slot, the main sweep (csrc/wavesweep.cu
     wave_run_kernel) within 1e-4 x each row's max of the kept sweep
     (wave_sweep_kernel) and bit-equal launch to launch, the kept sweep
     bit-equal to K3's warp form on its grid and the main one on the kept
     one's deal bit-equal to it, three 8-row bands of both against plain
     autograd through the plain wavefront (per row 1e-3), albedo AD vs FD
     (5% + 1e-6); at 600 spheres the redesigned pool sweep
     (wave_run_pool_kernel) within 1e-4 of the kept one, which is bit-equal
     to K3's pool form, the two in turns, and 2 Adam steps; 40 lights
     against plain and the kept sweep; 8
     sharded bands within rtol 1e-4 of one device; the staged tape
     instance timed in turns with the scalar one and K1 (CUDA events on
     the wrappers, and each kernel's device time from a torch.profiler
     trace of the same turns, profiling.trace_to), the main sweep in turns
     with the kept one (the same two ways), both sweeps' cycles by part
     (tools.grad_stats --forms wave), the pair in turns with K1 + K3, the
     training step in turns with the lockstep step; one traced step of
     each route (the device's idle share, each kernel's device time, no
     cudaMemGetInfo in the wavefront step); the tape's bytes.
 18. row-sharded rendering and training on one card (parallel/mesh.py,
     parallel/distributed.py) at the reference workload, 8 bands of 90
     rows on cuda:0: the frame bit-equal to the single-device frame (8
     merged-K1 launches, none of the per-thread K1) and a 16-frame
     session bit-equal to the unsharded one; make_mesh() over every card
     present; the 100k-sphere scaled frame bit-equal (8 cooperative
     scaled render launches, none of the per-lane form); the sharded
     training step, albedo hard and centre/radius at eps 0.05 (8 render
     and 8 K3 launches, no other), the loss within 1e-5 relative and each
     field within JAX's contract where it holds, within 1e-5 x its max
     always (the worst printed); each sharded and unsharded path timed
     in turns with CUDA events; InverseRenderer(mesh=...) (4 Adam steps'
     losses within 1e-5 of the unsharded run's) and the multi-view
     recovery of tests/test_sharding.py:218 through K3's soft instance
     (errz < 0.06, last loss < 0.5 x first); NCCL at world size 1 (frame
     and step bit-equal to the mesh without a group); two processes on
     the card over gloo (toypathtracer_torch.tools.distributed_smoke, 4
     bands each): rays and loss agree, the gathered rows bit-equal to the
     single-process 8-band frame, gradients within rtol 1e-5, atol 1e-8.
 19. parity: the CPU-exact parity renderer (render/parity.py, plain
     PyTorch, the reference's scalar C++ semantics) on the card against
     the reference's goldens with tests/test_parity.py's gates: tiny_f1,
     tiny_pp_d2_f1, tiny_pp_d3_f1, small_anim_f2 and (inside the phase's
     budget) tiny_f16; the share of the 2^24-point sampler grid where the
     card's sinf/cosf differ from glibc's, and its sqrt from sqrtf's; no
     counted kernel launched.
 20. viewer: serve.Viewer at 1280x720, spp 4, depth 10 on the card, its
     HTTP server on 127.0.0.1 at port 0: one K1 launch a frame, /frame.png
     equal to io.png_bytes of the session's image, /stats frame counts
     advancing and reset by a toggle, the 'g' round trip through the
     plain renderer (no kernel launched there) back to K1, --batch 8
     bit-equal to 8 single steps (8 K1 launches), the HUD's Mray/s beside
     the session's ms/frame, --scaled 100000 through the cooperative
     scaled render kernel (one launch a frame).
 21. resume at 1280x720: the CLI's 2 frames, --save-state, --resume and
     2 more equal to 4 straight frames (PNG bytes, accumulator, int64
     rays; 8 K1 launches); InverseRenderer's 2 Adam steps, the train
     state saved and loaded, 2 more bit-equal to 4 straight steps (8 K1
     and 8 K3 warp-form launches); a train state in the JAX package's
     layout written with numpy loaded onto the card.
 22. the `kernels` line: render, render_baseline, grad, grad_replay,
     lockstep, grad_soft, scaled_render, hit_chunks, hit_chunks_baseline, shadow_chunks,
     shadow_chunks_baseline, render_stats, render_stats_baseline,
     issue_rate, launch_floor, grad_pool, scaled_grad_sweep,
     scaled_grad_sweep_soft (the cooperative form's sweeps),
     scaled_grad_baseline,
     scaled_grad_baseline_soft (the per-lane chunked instance),
     scaled_grad_tape (the cooperative form's forward), wave_tape (K1's
     staged tape instance), wave_tape_baseline (the scalar one), wave_sweep
     (the redesigned sweep), wave_sweep_baseline (the kept one),
     wave_sweep_pool and wave_sweep_pool_baseline (the same past 512
     spheres); render,
     grad and
     scaled_render count the launches of phases 20-21 beside the main
     path's (`launches_by_path`).
Then the script's wall time (and its time before phase 18), the card's
name and power limit as nvidia-smi reports them, and the `ok` line last.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time

import torch


# Registers and spill bytes of the kernels that the redesigns must leave as
# they were (-Xptxas -v of their sources before them): the per-thread K1
# (render_kernel<0>) and K2 (<1>), the replaying K3 (lockstep_kernel<1,0>),
# the per-thread K4 (<0,0>), the per-thread K5, the per-thread K6, the per-lane
# scaled render kernel and the cooperative one, whose path loop and chunk
# walk the merged K1 and the cooperative K6 share; and K3's warp form (its
# hard and soft instances, which the pool and chunked instances beside
# them must leave as they were), the merged K1, the cooperative K5 and K6
# and the merged K2 at their own counts; the cooperative scaled render's
# lights instance (past 16 lights; the 16-light kernel keeps its SASS,
# KEPT_SASS), K3's lights
# instances, its pool and chunked instances (their directory and, for the
# pool's, lights repaired), the cooperative chunked form's kernels and the
# differentiable wavefront's pair (K1's tape instances, the sweep and its
# pool instance) and the redesigned sweep (the main path's instance of
# csrc/wavesweep.cu wave_run_kernel, and its pool instance) at their first
# counts.
KEPT_USAGE = {
    "render_kernel<1>": {"registers": 72, "spill_stores": 16},
    "coop_shadow_kernel<0>": {"registers": 40, "spill_stores": 12},
    "merged_render_kernel<2>": {"registers": 64, "spill_stores": 876},
    "render_kernel<0>": {"registers": 80, "spill_stores": 48},
    "merged_render_kernel<0>": {"registers": 64, "spill_stores": 788},
    "coop_render_kernel<0>": {"registers": 96, "spill_stores": 110},
    "lockstep_kernel<1,0>": {"registers": 116, "spill_stores": 0},
    "lockstep_kernel<0,0>": {"registers": 80, "spill_stores": 52},
    "warp_grad_kernel<0>": {"registers": 40, "spill_stores": 1154},
    "soft_warp_grad_kernel<0>": {"registers": 40, "spill_stores": 1402},
    "scaled_render_kernel<0>": {"registers": 80, "spill_stores": 32},
    "hit_chunks_kernel<0>": {"registers": 40, "spill_stores": 0},
    "coop_hit_kernel<0>": {"registers": 40, "spill_stores": 32},
    "shadow_chunks_kernel<0>": {"registers": 32, "spill_stores": 0},
    "lights_warp_grad_kernel<0>": {"registers": 40, "spill_stores": 1258},
    "lights_warp_grad_kernel<1>": {"registers": 40, "spill_stores": 1486},
    "pool_grad_kernel<0>": {"registers": 64, "spill_stores": 858},
    "pool_grad_kernel<1>": {"registers": 64, "spill_stores": 950},
    "chunk_grad_kernel<0>": {"registers": 64, "spill_stores": 790},
    "chunk_grad_kernel<1>": {"registers": 64, "spill_stores": 990},
    "tape_render_kernel<0>": {"registers": 96, "spill_stores": 122},
    "tape_render_kernel<1>": {"registers": 96, "spill_stores": 350},
    "lights_render_kernel": {"registers": 96, "spill_stores": 290},
    "chunk_sweep_kernel<0>": {"registers": 64, "spill_stores": 552},
    "chunk_sweep_kernel<1>": {"registers": 64, "spill_stores": 644},
    "merged_render_kernel<3>": {"registers": 64, "spill_stores": 880},
    "merged_render_kernel<4>": {"registers": 64, "spill_stores": 892},
    "wave_sweep_kernel": {"registers": 40, "spill_stores": 776},
    "wave_sweep_pool_kernel": {"registers": 64, "spill_stores": 552},
    "wave_run_kernel<1,0>": {"registers": 128, "spill_stores": 40},
    "wave_run_pool_kernel": {"registers": 128, "spill_stores": 56},
}


# SHA-256 of the SASS (tools.sass_loops --digests) of the kernels whose
# code the instances added beside them must leave as it was: K3's warp
# form's and replaying form's 16-light instances, timed and stats, and
# the cooperative scaled render kernel (the scaled main path's), as the
# sources before those lights instances built them; K1, its counted
# instance and K2 (merged_render_kernel<0>, <1>, <2>), as the sources
# before K1's tape instance built them; and K1's scalar tape instance
# (<3>), the wavefront's sweeps and the scaled tape-writing render
# (tape_render_kernel<0>, <1>), as the sources before K1's staged tape
# instance built them; on an H100 with this nvcc
# (tools.sass_loops --compare against those checkouts lists them
# identical).  A build by another toolkit is not comparable.
KEPT_SASS = {
    "nvcc": "Cuda compilation tools, release 12.9, V12.9.86",
    "digests": {
        "warp_grad_kernel<0>":
            "7d5b7b882fbecf2e76b4d466ea1847dcaca55ecd23df85b826833f0bfc5e5e8e",
        "warp_grad_kernel<1>":
            "22aa90c7a72d0c16e8b1862982ac48b94ccaf5b65085fde0883bad2c230204a8",
        "soft_warp_grad_kernel<0>":
            "8272125b2745630acc002a89526be09d75b12d7bb18968d77d419a6693ee95af",
        "soft_warp_grad_kernel<1>":
            "ec3198679c3a0f0ba7ed91e594f9db284cda3675884af9039f755ec15ed5558d",
        "lockstep_kernel<1,0>":
            "1480d34ccb5c4362469fd9014fc455190fb39030d47fb10cffb508c57286043c",
        "lockstep_kernel<1,1>":
            "b000fb099a0855ab4e2f1c1fb5f57b4519340c8dba92b0f904aa22c8d1aeea2f",
        "lockstep_kernel<2,0>":
            "2e6076401074a7f2135e7340ed4aa3f5a1568eb51d263ecceae45cb8f7c0a221",
        "lockstep_kernel<2,1>":
            "8f836ea46018af04b513e9913beb7442cddb6d14920b03262b64c3aece08bedb",
        "coop_render_kernel<0>":
            "67a41a31b6dafea3a83ca6d6da83ccdccb692d98bfff91a12b6b2714651059d8",
        "merged_render_kernel<0>":
            "7eed620e22edd9eb7f16ca946945bbdc048c7d3fab1038ff1ad1406d7fda60a1",
        "merged_render_kernel<1>":
            "75ecb913aa3d3433cc4d3298b0ae565997f42fa45d5d9605f4d9edbd8435443f",
        "merged_render_kernel<2>":
            "3c4a90aadf96486f0f354a3e1fde8e5bf1f1bf6e5e273812c4c15cab2cad2fc0",
        "merged_render_kernel<3>":
            "3dcda71e6f358bb059c8ba5cf0127f0425fe3c9dc01b9a379742917f7b327774",
        "wave_sweep_kernel":
            "63426693d48c37f7bdac0639d7ddc040be9bb291d60fa5e452724aa41e6ec02b",
        "wave_sweep_pool_kernel":
            "3e648074171731e4c8572ecfef4c0f45cc7a9d149abb6ee5b6cf538e52ebfe7b",
        "tape_render_kernel<0>":
            "20ca8bd63307246c24ad973093f2a90291aed38de1441ec358508253f88d6c11",
        "tape_render_kernel<1>":
            "37514468ad9783f8afeddb1f184540e046e0b50bd457fd6c8127376404e7fe8c",
    }}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def block_gates(a, b):
    """Mean and max |diff| of 8x8 block means of sqrt-tonemapped images
    (the progressive gate of tools/tpu_parity.py, at 8x8 blocks)."""
    h, w = a.shape[0] // 8 * 8, a.shape[1] // 8 * 8

    def blocks(x):
        t = torch.sqrt(torch.clamp_min(x[:h, :w].double(), 0.0))
        return t.reshape(h // 8, 8, w // 8, 8, 3).mean(dim=(1, 3))
    d = (blocks(a) - blocks(b)).abs()
    return float(d.mean()), float(d.max())


def compare(img_k, rays_k, img_p, rays_p):
    d = (img_k - img_p).abs()
    rk, rp = int(rays_k), int(rays_p)
    return {"rays_kernel": rk, "rays_plain": rp,
            "rays_rel_diff": abs(rk - rp) / max(rp, 1),
            "mean_abs_diff": float(d.mean()), "max_abs_diff": float(d.max()),
            "frac_within_1e-4": float((d.amax(dim=-1) <= 1e-4)
                                      .double().mean()),
            "finite": bool(torch.isfinite(img_k).all())}


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def row_rel(got, want):
    """Per row of a (14, N) table: max |got - want| / max |want| (0 where
    both rows are zero)."""
    err = (got - want).abs().amax(dim=1)
    scale = want.abs().amax(dim=1)
    return [float(e / s) if s > 0 else (0.0 if e == 0 else float("inf"))
            for e, s in zip(err, scale)]


class RootCount:
    """The plain version's brute-force traversal (tracecore.BruteForce)
    that also counts, over the lanes it answers for, the sphere tests whose
    root the function needs: `hit_roots`, the camera/bounce rays' tests
    with a positive discriminant, and `light_roots`, the shadow rays whose
    light was hit (the lanes each occlusion query runs for)."""

    def __init__(self, tab):
        from toypathtracer_torch.ops import tracecore as tc
        self.tc, self.tab = tc, tab
        self.brute = tc.BruteForce(tab)
        self.hit_roots = self.light_roots = 0

    def nearest_hit(self, ro, rd, t_min, t_max, active=None):
        tc, tab = self.tc, self.tab
        _, discr = tc.sphere_discr(
            tab[tc.ROW_CX], tab[tc.ROW_CY], tab[tc.ROW_CZ], tab[tc.ROW_SQR],
            tuple(x[:, None] for x in ro), tuple(x[:, None] for x in rd))
        n = (discr > 0.0).sum(dim=1)
        self.hit_roots += int((n if active is None else n[active]).sum())
        return self.brute.nearest_hit(ro, rd, t_min, t_max, active)

    def occluded(self, pos, l, light, t_min, t_l, active=None):
        self.light_roots += int(pos[0].numel() if active is None
                                else active.sum())
        return self.brute.occluded(pos, l, light, t_min, t_l, active)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    from toypathtracer_torch import (FLAG_ANIMATE, FLAG_PROGRESSIVE,
                                     RenderConfig, make_scene)
    from toypathtracer_torch.ops import _build, cuda_grad, cuda_render
    from toypathtracer_torch.ops import tracecore as tc
    from toypathtracer_torch.profiling import time_device_call
    from toypathtracer_torch.render import frame as frame_mod
    from toypathtracer_torch.render.wavefront import (camera_scalars,
                                                      render_frame_plain)
    from toypathtracer_torch.tools import render_parts, sass_loops
    from toypathtracer_torch.tools.scenes import crowded_scene

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    build_s = time.perf_counter() - t0
    _build.load_library()
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_s": build_s, "library": str(lib_path.name)})
    usage = _build.ptxas_usage(
        lib_path.with_suffix(".ptxas.txt").read_text())
    emit({"phase": "ptxas", "kernels": usage})
    for label, want in KEPT_USAGE.items():
        got = usage.get(label, {})
        check(all(got.get(k) == v for k, v in want.items()),
              f"{label}: registers/spills {got}, expected {want}")
    # the 16-light instances of K3's warp and replaying forms, the
    # cooperative scaled render kernel and K1's merged kernel's instances:
    # their SASS as the commit before the instances beside them built it
    t1 = time.perf_counter()
    now = sass_loops.digests(sass_loops.disassemble(lib_path))
    nvcc = sass_loops.nvcc_version()
    kept = {k: now.get(k) == v for k, v in KEPT_SASS["digests"].items()}
    comparable = nvcc == KEPT_SASS["nvcc"]
    emit({"phase": "sass_kept", "nvcc": nvcc,
          "recorded_with": KEPT_SASS["nvcc"], "comparable": comparable,
          "identical": kept, "seconds": time.perf_counter() - t1})
    check(not comparable or all(kept.values()),
          f"the kept kernels' SASS changed: {kept}")

    # ---- 2. kernel vs plain, small size ---------------------------------
    small_cfg = RenderConfig(width=320, height=176, samples_per_pixel=2,
                             max_depth=6)
    cases = [("big", make_scene(big=True), small_cfg),
             ("big_no_nee", make_scene(big=True),
              small_cfg.replace(do_light_sampling=False)),
             ("small", make_scene(big=False), small_cfg)]
    forms_equal = {}
    for name, scene, cfg in cases:
        scene = scene.to(dev)
        for frame in range(4):
            args = (scene, cfg, frame, 0, 0, cfg.height, cfg.width)
            img_k, rays_k = cuda_render.render_tile(*args)
            img_t, rays_t = cuda_render.render_tile_form(*args, "thread")
            img_l, rays_l = cuda_grad.render_tile_lockstep(*args)
            img_p, rays_p = render_frame_plain(scene, cfg, frame)
            torch.cuda.synchronize()
            r = compare(img_k, rays_k, img_p, rays_p)
            r["bit_equal_to_thread_kernel"] = bool(
                torch.equal(img_k, img_t)) and int(rays_k) == int(rays_t)
            r["lockstep_bit_equal"] = bool(
                torch.equal(img_l, img_k)) and int(rays_l) == int(rays_k)
            forms_equal[f"{name}_frame{frame}"] = (
                r["bit_equal_to_thread_kernel"] and r["lockstep_bit_equal"])
            emit({"phase": "kernel_vs_plain", "case": name, "frame": frame,
                  **r})
            check(r["finite"] and tuple(img_k.shape) == (176, 320, 3),
                  f"{name} frame {frame}: shape/finite")
            check(r["rays_rel_diff"] <= 5e-4, f"{name} frame {frame}: rays")
            check(r["mean_abs_diff"] <= 1e-3, f"{name} frame {frame}: mean")
            check(r["bit_equal_to_thread_kernel"],
                  f"{name} frame {frame}: merged K1 != per-thread K1")
            check(r["lockstep_bit_equal"], f"{name} frame {frame}: K4 != K1")
    # 600 spheres: more than the per-thread kernels stage
    crowd = crowded_scene(extra=554).to(dev)
    img_k, rays_k = cuda_render.render_tile(crowd, small_cfg, 0, 0, 0, 176,
                                            320)
    img_l, rays_l = cuda_grad.render_tile_lockstep(crowd, small_cfg, 0, 0, 0,
                                                   176, 320)
    img_p, rays_p = render_frame_plain(crowd, small_cfg, 0)
    torch.cuda.synchronize()
    crowd_r = compare(img_k, rays_k, img_p, rays_p)
    crowd_r["lockstep_bit_equal"] = bool(torch.equal(img_l, img_k)) and int(
        rays_l) == int(rays_k)
    emit({"phase": "kernel_vs_plain", "case": "crowded_600", "frame": 0,
          "spheres": crowd.n_spheres, **crowd_r})
    check(crowd_r["finite"] and crowd_r["rays_rel_diff"] <= 5e-4
          and crowd_r["mean_abs_diff"] <= 1e-3, "600 spheres vs plain")
    check(crowd_r["lockstep_bit_equal"], "600 spheres: K4 != K1")

    # ---- 3. the main path at full size ----------------------------------
    cfg = RenderConfig(width=1280, height=720, samples_per_pixel=4,
                       max_depth=10)
    scene = make_scene(big=True)
    n_frames = 16
    sess = frame_mod.RenderSession(scene, cfg, flags=FLAG_PROGRESSIVE,
                                   device="cuda")
    for k in cuda_render.launches:
        cuda_render.launches[k] = 0
    rays = []
    img0 = None
    for f in range(n_frames):
        img, r = sess.step(time=0.0)
        if f == 0:
            img0 = img.clone()
        rays.append(r)
    accum = sess.state.accum.clone()
    sess.set_flags(FLAG_PROGRESSIVE | FLAG_ANIMATE)
    img_anim, rays_anim = sess.step(time=1.0)
    img_anim = img_anim.clone()
    torch.cuda.synchronize()
    main_launches = cuda_render.launches["render"]
    other_launches = {k: v for k, v in cuda_render.launches.items()
                      if k != "render"}
    rays = [int(r) for r in rays]

    # the same frames through the plain version on the card
    scene_d = scene.to(dev)
    st = frame_mod.init_frame_state(cfg, dev)
    plain_rays = []
    plain0 = None
    for f in range(n_frames):
        st, img_p, r = frame_mod.progressive_step(
            st, scene_d, 0.0, cfg, FLAG_PROGRESSIVE,
            render_fn=render_frame_plain)
        if f == 0:
            plain0 = img_p.clone()
        plain_rays.append(int(r))
    anim_p, rays_anim_p = render_frame_plain(scene_d.animate(1.0), cfg, 0)

    # the same frames through the per-thread K1 it replaced: bit-equal
    def thread_frame(sc, c, f):
        return cuda_render.render_tile_form(sc, c, f, 0, 0, c.height,
                                            c.width, "thread")
    st_t = frame_mod.init_frame_state(cfg, dev)
    thread0 = None
    thread_rays = []
    for f in range(n_frames):
        st_t, img_t, r = frame_mod.progressive_step(
            st_t, scene_d, 0.0, cfg, FLAG_PROGRESSIVE, render_fn=thread_frame)
        if f == 0:
            thread0 = img_t.clone()
        thread_rays.append(int(r))
    anim_t, rays_anim_t = thread_frame(scene_d.animate(1.0), cfg, 0)
    torch.cuda.synchronize()
    thread_equal = {
        "frame0": bool(torch.equal(img0, thread0)),
        "animated": bool(torch.equal(img_anim, anim_t))
        and int(rays_anim) == int(rays_anim_t),
        "accum_16_frames": bool(torch.equal(accum, st_t.accum)),
        "rays_per_frame": rays == thread_rays}

    tpu_rays_f0 = 16772198  # docs/measured/tpu_parity.json:49
    f0 = compare(img0, rays[0], plain0, plain_rays[0])
    bm, bx = block_gates(accum, st.accum)
    anim = compare(img_anim, rays_anim, anim_p, rays_anim_p)
    main = {"phase": "main_path", "frames": n_frames + 1,
            "launches": main_launches, "other_launches": other_launches,
            "bit_equal_to_thread_kernel": thread_equal, "frame0": f0,
            "frame0_rays_rel_vs_tpu": abs(rays[0] - tpu_rays_f0) / tpu_rays_f0,
            "rays_per_frame": rays,
            "rays_16f_rel_diff": abs(sum(rays) - sum(plain_rays))
            / sum(plain_rays),
            "block_mean_abs": bm, "block_max_abs": bx,
            "accum_finite": bool(torch.isfinite(accum).all()),
            "animated": anim}
    emit(main)
    check(main_launches == n_frames + 1,
          f"{main_launches} launches for {n_frames + 1} frames")
    check(not any(other_launches.values()),
          f"the main path launched other kernels: {other_launches}")
    check(all(thread_equal.values()),
          f"merged K1 != per-thread K1 on the main path: {thread_equal}")
    check(tuple(accum.shape) == (720, 1280, 3) and main["accum_finite"],
          "accumulated image shape/finite")
    check(f0["rays_rel_diff"] <= 5e-4, "frame 0 rays vs plain")
    check(main["frame0_rays_rel_vs_tpu"] <= 5e-4, "frame 0 rays vs TPU")
    check(bm <= 0.02 and bx <= 0.2, "16-frame block gates")
    check(anim["finite"] and anim["rays_rel_diff"] <= 5e-4, "animated frame")

    # ---- 4. step 1, the counted instance, the sphere loops, timing -------
    t1 = time.perf_counter()
    parts = {f: render_parts.form_parts(scene_d, cfg, f)
             for f in ("thread", "merged")}
    for f, pr in parts.items():
        emit({"phase": "render_cycle_shares", "nvidia_smi": smi, **pr})
        check(pr["rays"] == rays[0], f"K1 {f} instrumented instance: rays")
    with contextlib.redirect_stdout(io.StringIO()):  # its JSON: in build/
        sass = sass_loops.main([])["kernels"]
    emit({"phase": "render_sass_loops",
          "loops": {k: [{x: lp[x] for x in ("start", "instructions",
                                            "by_class", "mufu", "calls")}
                        for lp in v["loops"] if lp["by_class"]["fp32"] >= 20]
                    for k, v in sass.items()},
          "seconds": time.perf_counter() - t1})
    busy = parts["merged"]["lane_busy_share"]

    sess = frame_mod.RenderSession(scene, cfg, flags=FLAG_PROGRESSIVE,
                                   device="cuda")
    for f in range(4):
        sess.step(time=0.0)
    torch.cuda.synchronize()
    n_timed = 64
    timed_rays = []
    step_s, _ = time_device_call(
        lambda: timed_rays.append(sess.step(time=0.0)[1]), repeats=n_timed)
    step_ms = step_s * 1e3
    rays_per_frame = frame_mod.sum_rays(torch.stack(timed_rays)) / n_timed

    # the kernel alone (wrapper call) in turns with the per-thread K1 it
    # replaced (merged, thread, thread, merged), and the plain version, same
    # inputs
    runs = {"merged": [], "thread": []}
    for form in ("merged", "thread", "thread", "merged"):
        runs[form].append(time_device_call(
            cuda_render.render_tile_form, scene_d, cfg, 0, 0, 0, cfg.height,
            cfg.width, form, repeats=16)[0] * 1e3)
    kernel_ms = sum(runs["merged"]) / 2
    thread_ms = sum(runs["thread"]) / 2
    plain_s, (plain_img, _) = time_device_call(render_frame_plain, scene_d,
                                               cfg, 0)
    plain_ms = plain_s * 1e3

    # Bound: the FP32 arithmetic the function needs on frame 0's data,
    # counted from csrc/trace.cuh with the plain version's work counters: 16
    # operations per sphere test (3 sub, 5 for nb, 6 for c, 2 for the
    # discriminant) -- every sphere for each camera/bounce ray, the light's
    # own sphere for each shadow ray -- and 3 more (sqrt, 2 roots) only
    # where the root is needed: the tests whose discriminant is positive,
    # and the shadow rays whose light was hit (a light test with a positive
    # discriminant whose root falls outside (t_min, t_max) is not counted);
    # then 20 per sphere of each shadow ray's occlusion loop, which stops
    # at the first occluder.  Shading, compares and selects are not
    # counted, and sqrt counts as one operation, so the bound is low.
    # 67 TFLOP/s: H100 SXM FP32 peak at 700 W.
    tab = cuda_render.pack_scene(scene_d)
    mat = torch.tensor(scene.mat_type, dtype=torch.int64, device=dev)
    yy, xx = torch.meshgrid(torch.arange(cfg.height, device=dev),
                            torch.arange(cfg.width, device=dev),
                            indexing="ij")
    roots = RootCount(tab)
    _, work = tc.render_pixels(
        tab, mat, scene.emissive_ids, cfg, camera_scalars(scene, cfg),
        xx.reshape(-1), yy.reshape(-1), 0, traversal=roots)
    traced, shadow, occ_tests = (int(w.sum()) for w in (
        work.traced, work.shadow, work.occlusion_tests))
    ops = (16 * scene.n_spheres * traced + 3 * roots.hit_roots
           + 16 * shadow + 3 * roots.light_roots + 20 * occ_tests)
    ops_ms = ops / 67e12 * 1e3
    # bytes: the packed scene, material ids, lights and camera read once,
    # the image written once, the ray counter; 3.35 TB/s HBM3
    n_bytes = (4 * (14 * scene.n_spheres + scene.n_spheres
                    + len(scene.emissive_ids) + 22)
               + 4 * 3 * cfg.width * cfg.height + 8)
    bytes_ms = n_bytes / 3.35e12 * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    emit({"phase": "timing", "nvidia_smi": smi,
          "step_ms_per_frame": step_ms, "kernel_ms": kernel_ms,
          "kernel_ms_runs": runs["merged"], "thread_kernel_ms": thread_ms,
          "thread_kernel_ms_runs": runs["thread"],
          "merged_over_thread": kernel_ms / thread_ms,
          "lane_busy_share": busy,
          "mray_s": rays_per_frame / (step_ms * 1e-3) * 1e-6,
          "rays_per_frame": rays_per_frame, "plain_ms": plain_ms,
          "frame0_traced_rays": traced, "frame0_shadow_rays": shadow,
          "frame0_occlusion_sphere_tests": occ_tests,
          "frame0_hit_tests": scene.n_spheres * traced,
          "frame0_hit_roots": roots.hit_roots,
          "frame0_light_roots": roots.light_roots,
          "bound_fp32_ops": ops, "bound_ops_ms": ops_ms,
          "bound_bytes": n_bytes, "bound_bytes_ms": bytes_ms,
          "bound_ms": bound_ms,
          "bound_peak": "67 TFLOP/s FP32 (H100 SXM, 700 W)",
          "library_call": None})

    grad = grad_phases(cfg, scene, scene_d, smi,
                       dict(ops=ops, bytes=n_bytes, traced=traced,
                            shadow=shadow, plain_ms=plain_ms,
                            plain_img=plain_img), usage)
    soft = soft_phases(cfg, scene, scene_d, smi,
                       dict(ops=ops, bytes=n_bytes, traced=traced,
                            shadow=shadow), usage)
    scaled = scaled_phases(cfg, smi, usage)
    stats = stats_phases(cfg, smi, dict(ops=ops, bytes=n_bytes), usage)
    probe = probe_phases(smi)
    pool = pool_phases(cfg, smi, usage)
    scaled_grad = scaled_grad_phases(cfg, smi, usage)
    wave = wavefront_phases(smi, usage)
    before_sharded_s = time.perf_counter() - t_start
    sharded_phases(smi)
    t_new = time.perf_counter()
    parity_phase(smi)
    viewer = viewer_phase(smi)
    resume = resume_phase(smi)
    new_paths_s = time.perf_counter() - t_new
    # the new paths' launches, each counted from 0 in its own phase
    new_paths = {
        "render": {
            "viewer": viewer["launches"].get("render", 0) + viewer[
                "g_round_trip"]["cuda"]["launches"].get("render", 0),
            "viewer_batch8": viewer["batch8"]["launches"].get("render", 0),
            "resume_cli": resume["cli"]["launches"].get("render", 0),
            "resume_fit": resume["train"]["launches"].get("render", 0)},
        "grad": {"resume_fit": resume["train"]["launches"].get("grad", 0)},
        "scaled_render": {"viewer_scaled": viewer["scaled"]["launches"].get(
            "scaled_render", 0)}}

    tol = ("rays rel <= 5e-4, mean |diff| <= 1e-3, 8x8 block mean <= 0.02, "
           "max <= 0.2; 600 spheres at 320x176 rays rel <= 5e-4, mean "
           "|diff| <= 1e-3")
    vs_plain = {"rays_rel_diff": f0["rays_rel_diff"],
                "mean_abs_diff": f0["mean_abs_diff"],
                "frac_within_1e-4": f0["frac_within_1e-4"],
                "block_mean_abs": bm, "block_max_abs": bx,
                "crowded_600": crowd_r}
    kernels = [
        {"name": "render", "route": "cuda",
         "source": "toypathtracer_torch/csrc/render.cu",
         "replaces": "toypathtracer_tpu/ops/pallas_render.py:152",
         "launches": main_launches,
         "max_abs_err": f0["max_abs_diff"],
         "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": None,
         "form": "merged (merged_render_kernel<0>: csrc/merged.cuh, "
                 "flat.cuh)",
         "baseline_ms": thread_ms,
         "baseline": "the per-thread K1 it replaced (render_kernel<0>), "
                     "timed in turns with it",
         "lane_busy_share": busy,
         "cycle_shares": parts["merged"]["cycle_shares"],
         "ptxas": usage.get("merged_render_kernel<0>", {}),
         "vs_plain": {"tolerance": tol + "; bit-equal to the per-thread K1 "
                                         "in every case, K4 bit-equal to it",
                      **vs_plain,
                      "bit_equal_to_thread_kernel": {
                          **forms_equal, **thread_equal}}},
        {"name": "render_baseline", "route": "cuda",
         "source": "toypathtracer_torch/csrc/render.cu",
         "replaces": "toypathtracer_tpu/ops/pallas_render.py:152",
         "launches": other_launches["render_baseline"],
         "max_abs_err": float((thread0 - plain0).abs().max()),
         "ms": thread_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": None,
         "form": "thread (render_kernel<0>)",
         "baseline": "the per-thread K1, kept beside the merged one as its "
                     "A/B and equality baseline; not on the main path",
         "cycle_shares": parts["thread"]["cycle_shares"],
         "ptxas": usage.get("render_kernel<0>", {}),
         "vs_plain": {"tolerance": "bit-equal to the merged K1"}},
        *grad, soft, *scaled, *stats, *probe, pool, *scaled_grad, *wave]
    for k in kernels:
        if k["name"] in new_paths:
            by_path = {"main_path": k["launches"], **new_paths[k["name"]]}
            k["launches"] = sum(by_path.values())
            k["launches_by_path"] = by_path
    emit({"kernels": kernels})
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start,
          "seconds_before_sharded_phase": before_sharded_s,
          "seconds_parity_viewer_resume": new_paths_s})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def grad_phases(cfg, scene, scene_d, smi, k1, usage):
    """Phases 5-7: the gradient kernel (K3: its warp form on the main path
    and the replaying form it replaced, the baseline) and the lockstep
    kernel (K4) against plain autograd, the training path at full size,
    K3's cycle shares by part, and the timing, the K3 forms in turns.  `k1`
    carries the render kernel's frame-0 work counts, bound terms and plain
    version from phase 4; `usage` is phase 1's -Xptxas -v table.  Returns
    the kernels' entries of the `kernels` line."""
    import numpy as np

    from toypathtracer_torch import make_scene
    from toypathtracer_torch.inverse import InverseRenderer, image_l2
    from toypathtracer_torch.ops import cuda_grad, cuda_render
    from toypathtracer_torch.profiling import time_device_call
    from toypathtracer_torch.render.wavefront import render_tile_grad_plain
    from toypathtracer_torch.tools import grad_stats
    from toypathtracer_torch.tools.scenes import crowded_scene

    dev = scene_d.device
    main_form = cuda_grad.MAIN_FORM

    def cotangent(seed, h, w):
        return grad_stats.cotangent(h, w, seed, dev)

    # ---- 5. K3 / K4 vs plain autograd, small size ---------------------
    small_cfg = cfg.replace(width=320, height=176, samples_per_pixel=2,
                            max_depth=4)
    small_rel = {"warp": 0.0, "replay": 0.0}
    cases = [("big", make_scene(big=True)), ("small", make_scene(big=False)),
             ("crowded", crowded_scene())]
    for name, sc in cases:
        sc = sc.to(dev)
        for frame in range(1 if name == "crowded" else 2):
            g = cotangent(frame, 176, 320)
            args = (sc, small_cfg, frame, g, 0, 0, 176, 320)
            img_p, rays_p, d_p = render_tile_grad_plain(*args)
            img_l, rays_l = cuda_grad.render_tile_lockstep(
                sc, small_cfg, frame, 0, 0, 176, 320)
            forms = ("warp",) if name == "crowded" else ("warp", "replay")
            for form in forms:
                img_k, rays_k, d_k = cuda_grad.render_tile_grad_form(
                    *args, form)
                _, _, d_k2 = cuda_grad.render_tile_grad_form(*args, form)
                torch.cuda.synchronize()
                rel = row_rel(d_k, d_p)
                small_rel[form] = max(small_rel[form], max(rel))
                r = {"phase": "grad_vs_plain", "case": name, "form": form,
                     "frame": frame, "spheres": sc.n_spheres,
                     "rays_kernel": int(rays_k), "rays_plain": int(rays_p),
                     "rays_lockstep": int(rays_l),
                     "d_packed_row_rel_max": max(rel),
                     "d_packed_row_rel": rel,
                     "img_max_abs_diff": float((img_k - img_p).abs().max()),
                     "lockstep_bit_equal": bool(torch.equal(img_l, img_k)),
                     "grad_deterministic": bool(torch.equal(d_k, d_k2)),
                     "finite": bool(torch.isfinite(d_k).all())}
                if name == "crowded":
                    r["appended_spheres_reached"] = int(
                        (d_k[:, 46:].abs().sum(dim=0) > 0).sum())
                    check(r["appended_spheres_reached"] >= 5,
                          "crowded scene: no gradient reaches the appended "
                          "spheres")
                emit(r)
                what = f"grad {form} {name} frame {frame}"
                check(r["finite"], f"{what}: finite")
                check(r["rays_kernel"] == r["rays_plain"]
                      == r["rays_lockstep"], f"{what}: rays")
                check(max(rel) <= 1e-3, f"{what}: d_packed vs plain")
                check(r["lockstep_bit_equal"],
                      f"{what}: K4 image == K3 primal")
                check(r["grad_deterministic"], f"{what}: two launches differ")

    # ---- 6. the training path at full size ----------------------------
    H, W = cfg.height, cfg.width
    target, _ = cuda_render.render_frame(scene, cfg, 0)
    rng = np.random.default_rng(7)
    a_jit = rng.normal(0, 0.15, scene.albedo.shape).astype(np.float32)
    a_jit[list(scene.emissive_ids)] = 0.0
    start = scene.replace(albedo=torch.clamp(
        scene.albedo + torch.from_numpy(a_jit), 0.02, 0.98))

    def step_launches():
        return {"render": cuda_render.launches["render"],
                "render_baseline": cuda_render.launches["render_baseline"],
                "grad": cuda_grad.launches["grad"],
                "lockstep": cuda_grad.launches["lockstep"],
                "lockstep_baseline": cuda_grad.launches["lockstep_baseline"]}
    for k in cuda_render.launches:
        cuda_render.launches[k] = 0
    for k in cuda_grad.launches:
        cuda_grad.launches[k] = 0
    inv = InverseRenderer(cfg, target, trainable=("albedo",),
                          learning_rate=2e-2)
    _, losses = inv.fit(start, steps=4, resample=False)
    after_fit = step_launches()
    inv_l = InverseRenderer(cfg, target, trainable=("albedo",),
                            learning_rate=2e-2, lockstep_primal=True)
    _, losses_l = inv_l.fit(start, steps=2, resample=False)
    torch.cuda.synchronize()
    train_launches = step_launches()
    other = {k: v for k, v in cuda_grad.launches.items()
             if k not in train_launches}
    emit({"phase": "training_path", "losses": losses,
          "losses_lockstep_primal": losses_l,
          "launches_after_4_steps": after_fit,
          "launches": train_launches, "other_grad_launches": other})
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"Adam losses not strictly decreasing: {losses}")
    check(all(b < a for a, b in zip(losses_l, losses_l[1:])),
          f"lockstep-primal losses not strictly decreasing: {losses_l}")
    check(after_fit == {"render": 4, "render_baseline": 0, "grad": 4,
                        "lockstep": 0, "lockstep_baseline": 0},
          f"4 steps launched {after_fit}")
    check(train_launches == {"render": 4, "render_baseline": 0, "grad": 6,
                             "lockstep": 2, "lockstep_baseline": 0},
          f"training path launched {train_launches}")
    check(not any(other.values()), f"other K3 forms launched: {other}")

    # value and gradient of every field through render_frame_diff
    leaves = {f: getattr(scene, f).clone().requires_grad_(True)
              for f in cuda_grad.PARAM_FIELDS}
    img, _ = cuda_grad.render_frame_diff(scene.replace(**leaves), cfg, 0)
    loss = image_l2(img, target * 0.9)
    loss.backward()
    finite = bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(t.grad).all()) for t in leaves.values())
    check(finite, "render_frame_diff value/grad finite")

    w = cotangent(11, H, W)
    full = {}
    for form in ("warp", "replay"):
        img_f, rays_f, d_f = cuda_grad.render_tile_grad_form(
            scene_d, cfg, 0, w, 0, 0, H, W, form)
        _, _, d_again = cuda_grad.render_tile_grad_form(
            scene_d, cfg, 0, w, 0, 0, H, W, form)
        full[form] = (img_f, rays_f, d_f, bool(torch.equal(d_f, d_again)))
    img_g, rays_g, d_full, _ = full[main_form]
    img_l, rays_l = cuda_grad.render_tile_lockstep(scene_d, cfg, 0, 0, 0, H,
                                                   W)
    img_k1, _ = cuda_render.render_tile(scene_d, cfg, 0, 0, 0, H, W)
    band, n_bands = 16, H // 16
    d_bands = torch.zeros_like(d_full)
    rays_bands = 0
    d_band_k = {}
    for b in range(n_bands):
        _, r_b, d_b = cuda_grad.render_tile_grad(
            scene_d, cfg, 0, w[b * band:(b + 1) * band], 0, b * band, band, W)
        d_bands += d_b
        rays_bands += int(r_b)
        d_band_k[b] = d_b
    # the plain version, band by band (its graph cannot hold the frame)
    d_plain = torch.zeros_like(d_full)
    d_band_p = {}

    def plain_frame():
        d_plain.zero_()
        for b in range(n_bands):
            _, _, d_b = render_tile_grad_plain(
                scene_d, cfg, 0, w[b * band:(b + 1) * band], 0, b * band,
                band, W)
            d_plain.add_(d_b)
            d_band_p[b] = d_b
    grad_plain_s, _ = time_device_call(plain_frame)
    torch.cuda.synchronize()
    mid = n_bands // 2
    band_rel = row_rel(d_band_k[mid], d_band_p[mid])
    bands_rel = row_rel(d_bands, d_full)
    full_rel = {f: row_rel(full[f][2], d_plain) for f in full}

    # central differences of L = sum(img * w) in float64 on 3 albedo
    # entries of visible Lambert spheres (albedo moves no path)
    tab = cuda_render.pack_scene(scene_d)
    w64 = w.double()
    fd = []
    for i, c in ((0, 0), (2, 1), (1, 2)):
        row = 6 + c
        vals = []
        for sign in (1.0, -1.0):
            t = tab.clone()
            t[row, i] += sign * 1e-2
            im, _ = cuda_render.render_tile(scene_d, cfg, 0, 0, 0, H, W,
                                            tab=t)
            vals.append(float((im.double() * w64).sum()))
        g_fd = (vals[0] - vals[1]) / 2e-2
        entry = {"sphere": i, "channel": c, "fd": g_fd}
        for f in full:
            entry[f] = float(full[f][2][row, i])
            entry[f"rel_{f}"] = abs(entry[f] - g_fd) / abs(g_fd)
        fd.append(entry)
    r = {"phase": "grad_full_size", "form": main_form, "rays": int(rays_g),
         "rays_bands": rays_bands, "rays_lockstep": int(rays_l),
         "value_grad_finite": finite,
         "grad_deterministic": {f: full[f][3] for f in full},
         "lockstep_bit_equal": bool(torch.equal(img_l, img_g)),
         "render_kernel_bit_equal": bool(torch.equal(img_k1, img_g)),
         "replay_primal_bit_equal": bool(torch.equal(full["replay"][0],
                                                     img_g)),
         "replay_rays": int(full["replay"][1]),
         "bands_vs_full_row_rel_max": max(bands_rel),
         "band_vs_plain_row_rel_max": max(band_rel),
         "band_vs_plain_row_rel": band_rel,
         "full_vs_plain_bands_row_rel_max": {f: max(v)
                                             for f, v in full_rel.items()},
         "full_vs_plain_bands_max_abs": {
             f: float((full[f][2] - d_plain).abs().max()) for f in full},
         "warp_vs_replay_row_rel_max": max(row_rel(d_full,
                                                   full["replay"][2])),
         "lockstep_vs_plain_img_max_abs": float(
             (img_l - k1["plain_img"]).abs().max()),
         "finite_differences": fd}
    emit(r)
    for f in full:
        check(full[f][3], f"full-size d_packed of the {f} form not "
                          "deterministic")
        check(max(full_rel[f]) <= 1e-3,
              f"full-size {f} d_packed vs plain autograd")
        check(all(e[f"rel_{f}"] <= 1e-2 for e in fd),
              f"K3 {f} vs finite differences")
    check(r["lockstep_bit_equal"] and int(rays_l) == int(rays_g),
          "full-size K4 image != K3 primal")
    check(r["replay_primal_bit_equal"] and r["replay_rays"] == int(rays_g),
          "full-size primal of the two K3 forms differ")
    check(rays_bands == int(rays_g), "band rays != full-frame rays")
    check(max(bands_rel) <= 1e-4, "45 bands' d_packed != the full frame's")
    check(max(band_rel) <= 1e-3, "band d_packed vs plain autograd")

    # ---- 7. cycle shares and timing -----------------------------------
    t1 = time.perf_counter()
    shares = {f: grad_stats.form_stats(scene_d, cfg, f, w)
              for f in ("replay", "warp")}
    for f, st in shares.items():
        emit({"phase": "grad_cycle_shares", "nvidia_smi": smi, **st})
    # the warp form's carries: the scratch a full-frame launch allocates
    # (device memory), and what its records move -- each bounce's record
    # written once by the forward trace and read once by the reverse sweep
    blocks, tape_floats = cuda_grad.grad_scratch(scene_d, cfg, 0, 0, 0, H, W,
                                                 "warp")
    rec_bytes = 4 * 16  # csrc/gradwarp.cuh kRecWords
    moved = 2 * rec_bytes * shares["warp"]["counters"]["adj_bounces"]
    carries = {"blocks": blocks, "tape_bytes": 4 * tape_floats,
               "record_bytes": rec_bytes, "bytes_moved": moved,
               "moved_ms_at_3.35TB/s": moved / 3.35e12 * 1e3}
    # the forms in turns: warp, replay, replay, warp; each entry the mean of
    # its two runs
    runs = {}
    for form in ("warp", "replay", "replay", "warp"):
        runs.setdefault(form, []).append(time_device_call(
            cuda_grad.render_tile_grad_form, scene_d, cfg, 0, w, 0, 0, H, W,
            form, repeats=3)[0] * 1e3)
    form_ms = {f: {"ms": sum(v) / len(v), "runs": v}
               for f, v in runs.items()}
    grad_ms = form_ms[main_form]["ms"]
    # K4 and its per-thread baseline in turns: merged, thread, thread,
    # merged
    lock_fns = {"merged": cuda_grad.render_tile_lockstep,
                "thread": cuda_grad.render_tile_lockstep_baseline}
    lock_runs = {"merged": [], "thread": []}
    for form in ("merged", "thread", "thread", "merged"):
        lock_runs[form].append(time_device_call(
            lock_fns[form], scene_d, cfg, 0, 0, 0, H, W, repeats=16)[0])
    lock_s = sum(lock_runs["merged"]) / 2
    lock_thread_s = sum(lock_runs["thread"]) / 2
    n_steps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inv.fit(start, steps=n_steps, resample=False)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_steps
    # Bound of K3: K1's forward count (the same sphere tests, fwd_ops) plus
    # the adjoint's FP32 arithmetic counted from csrc/trace.cuh: ~150 per
    # traced ray (bounce_adj with sphere_t_adj, reflect and normal
    # adjoints) and ~270 per shadow ray (cone recomputed, cone_adj), for
    # every traced and shadow ray (misses and unseen lights do less).
    # Replays are a kernel's design, not the function's work, and are not
    # counted.  Bytes: K1's plus the cotangent read.
    grad_ops = k1["ops"] + 150 * k1["traced"] + 270 * k1["shadow"]
    grad_bytes = k1["bytes"] + 4 * 3 * H * W
    grad_bound = max(grad_ops / 67e12, grad_bytes / 3.35e12) * 1e3
    lock_bound = max(k1["ops"] / 67e12, k1["bytes"] / 3.35e12) * 1e3
    t = {"phase": "grad_timing", "nvidia_smi": smi, "form": main_form,
         "grad_kernel_ms": grad_ms, "forms_ms": form_ms,
         "lockstep_kernel_ms": lock_s * 1e3,
         "lockstep_thread_kernel_ms": lock_thread_s * 1e3,
         "lockstep_ms_runs": {f: [x * 1e3 for x in v]
                              for f, v in lock_runs.items()},
         "train_step_ms": step_s * 1e3,
         "fwd_bwd_mray_s": int(rays_g) / step_s * 1e-6,
         "primal_rays_per_step": int(rays_g),
         "grad_plain_ms": grad_plain_s * 1e3,
         "lockstep_plain_ms": k1["plain_ms"],
         "sum_ms": {f: shares[f]["sum_ms"] for f in shares},
         "warp_carries": carries,
         "grad_bound_fp32_ops": grad_ops, "grad_bound_bytes": grad_bytes,
         "grad_bound_ms": grad_bound, "lockstep_bound_ms": lock_bound,
         "bound_peak": "67 TFLOP/s FP32, 3.35 TB/s (H100 SXM, 700 W)",
         "seconds": time.perf_counter() - t1}
    emit(t)
    tol = ("d_packed per row <= 1e-3 x row max (320x176 cases, the full "
           "frame against 45 plain bands), rays exact; bit-equal launch to "
           "launch; finite differences <= 1e-2")
    return [
        {"name": "grad", "route": "cuda",
         "source": "toypathtracer_torch/csrc/grad.cu",
         "replaces": "toypathtracer_tpu/ops/pallas_grad.py:127",
         "launches": train_launches["grad"],
         "max_abs_err": r["full_vs_plain_bands_max_abs"][main_form],
         "ms": grad_ms, "plain_ms": grad_plain_s * 1e3,
         "bound_ms": grad_bound, "bound_by": "operations",
         "library_ms": None, "form": main_form,
         "baseline_ms": form_ms["replay"]["ms"],
         "baseline": "the replaying form (lockstep_kernel<1,0>), timed "
                     "in turns with it",
         "ptxas": usage.get("warp_grad_kernel<0>", {}),
         "cycle_shares": shares[main_form]["cycle_shares"],
         "vs_plain": {"tolerance": tol + "; also at 130 spheres (320x176); "
                                         "bands sum to the frame <= 1e-4",
                      "small_row_rel_max": small_rel[main_form],
                      "band_row_rel_max": max(band_rel),
                      "full_frame_row_rel_max": max(full_rel[main_form]),
                      "fd_rel_max": max(e[f"rel_{main_form}"] for e in fd)}},
        {"name": "grad_replay", "route": "cuda",
         "source": "toypathtracer_torch/csrc/grad.cu",
         "replaces": "toypathtracer_tpu/ops/pallas_grad.py:127",
         "launches": other["grad_replay"],
         "max_abs_err": r["full_vs_plain_bands_max_abs"]["replay"],
         "ms": form_ms["replay"]["ms"], "plain_ms": grad_plain_s * 1e3,
         "bound_ms": grad_bound, "bound_by": "operations",
         "library_ms": None, "form": "replay",
         "baseline": "the replaying K3, kept beside the warp form as its "
                     "A/B and equality baseline; not on the main path",
         "ptxas": usage.get("lockstep_kernel<1,0>", {}),
         "cycle_shares": shares["replay"]["cycle_shares"],
         "vs_plain": {"tolerance": tol,
                      "small_row_rel_max": small_rel["replay"],
                      "full_frame_row_rel_max": max(full_rel["replay"]),
                      "fd_rel_max": max(e["rel_replay"] for e in fd)}},
        {"name": "lockstep", "route": "cuda",
         "source": "toypathtracer_torch/csrc/grad.cu",
         "replaces": "toypathtracer_tpu/ops/pallas_grad.py:181",
         "launches": train_launches["lockstep"],
         "max_abs_err": r["lockstep_vs_plain_img_max_abs"],
         "ms": lock_s * 1e3, "plain_ms": k1["plain_ms"],
         "bound_ms": lock_bound,
         "bound_by": "operations", "library_ms": None,
         "form": "merged (the merged K1, merged_render_kernel<0>)",
         "baseline_ms": lock_thread_s * 1e3,
         "baseline": "the per-thread K4 (lockstep_kernel<0,0>), timed in "
                     "turns with it",
         "vs_plain": {"tolerance": "image bit-equal to K3's primal, rays "
                                   "exact",
                      "bit_equal_to_grad_primal": r["lockstep_bit_equal"],
                      "bit_equal_to_render_kernel":
                          r["render_kernel_bit_equal"]}}]


def soft_phases(cfg, scene, scene_d, smi, k1, usage):
    """Phases 7b-7g: K3's soft instances (the soft-silhouette estimator,
    eps 0.05) at the reference workload -- both forms against plain
    autograd over the frame's 45 bands, image bit-equal to K3 at eps 0 and
    to K1, rays exact, two launches bit-equal, the bands summing to the
    frame; finite differences on a centre and a radius, 32 frames a side;
    the training path with trainable centres and radii (InverseRenderer,
    one render and one soft K3 launch a step); the motion AD-vs-FD check
    of tests/test_motion.py at its configuration through K3's soft
    instance, the hard one's beside it; demo_motion at its defaults; the
    soft instances' cycle shares (tools.grad_stats) and both forms timed in
    turns with their hard instances.  `k1` carries the render kernel's
    frame-0 work counts and bound terms; `usage` is phase 1's -Xptxas -v
    table.  Returns the `kernels` line's grad_soft entry."""
    import numpy as np

    from toypathtracer_torch import FLAG_ANIMATE, RenderConfig, demo_motion
    from toypathtracer_torch.inverse import (InverseRenderer,
                                             image_l2_tonemapped)
    from toypathtracer_torch.ops import cuda_grad, cuda_render
    from toypathtracer_torch.ops import tracecore as tc
    from toypathtracer_torch.profiling import time_device_call
    from toypathtracer_torch.render.frame import scene_for_frame
    from toypathtracer_torch.render.wavefront import (camera_scalars,
                                                      render_tile_grad_plain)
    from toypathtracer_torch.tools import grad_stats

    dev = scene_d.device
    eps = 0.05
    cfg_s = cfg.replace(soft_silhouette_eps=eps)
    H, W = cfg.height, cfg.width
    w = grad_stats.cotangent(H, W, 11, dev)

    def zero_counts():
        for k in cuda_grad.launches:
            cuda_grad.launches[k] = 0
        for k in cuda_render.launches:
            cuda_render.launches[k] = 0

    # ---- 7b. both soft forms against plain autograd over 45 bands ------
    zero_counts()
    full = {}
    for form in ("warp", "replay"):
        img_f, rays_f, d_f = cuda_grad.render_tile_grad_form(
            scene_d, cfg_s, 0, w, 0, 0, H, W, form)
        _, _, d_again = cuda_grad.render_tile_grad_form(
            scene_d, cfg_s, 0, w, 0, 0, H, W, form)
        full[form] = (img_f, rays_f, d_f, bool(torch.equal(d_f, d_again)))
    soft_launches = {k: v for k, v in cuda_grad.launches.items() if v}
    img_h, rays_h, d_h = cuda_grad.render_tile_grad(scene_d, cfg, 0, w, 0, 0,
                                                    H, W)
    img_k1, rays_k1 = cuda_render.render_tile(scene_d, cfg, 0, 0, 0, H, W)
    band, n_bands = 16, H // 16
    d_bands = torch.zeros_like(d_h)
    rays_bands = 0
    for b in range(n_bands):
        _, r_b, d_b = cuda_grad.render_tile_grad(
            scene_d, cfg_s, 0, w[b * band:(b + 1) * band], 0, b * band, band,
            W)
        d_bands += d_b
        rays_bands += int(r_b)
    d_plain = torch.zeros_like(d_h)
    rays_plain = [0]

    def plain_frame():
        d_plain.zero_()
        rays_plain[0] = 0
        for b in range(n_bands):
            _, r_b, d_b = render_tile_grad_plain(
                scene_d, cfg_s, 0, w[b * band:(b + 1) * band], 0, b * band,
                band, W)
            d_plain.add_(d_b)
            rays_plain[0] += int(r_b)
    plain_s, _ = time_device_call(plain_frame)
    torch.cuda.synchronize()
    rel = {f: row_rel(full[f][2], d_plain) for f in full}
    worst = {f: int(np.argmax(rel[f])) for f in full}
    r = {"phase": "grad_soft_vs_plain", "soft_eps": eps,
         "launches": soft_launches,
         "rays": {f: int(full[f][1]) for f in full},
         "rays_hard": int(rays_h), "rays_k1": int(rays_k1),
         "rays_plain": rays_plain[0], "rays_bands": rays_bands,
         "image_bit_equal_to_hard_k3": {
             f: bool(torch.equal(full[f][0], img_h)) for f in full},
         "image_bit_equal_to_k1": {
             f: bool(torch.equal(full[f][0], img_k1)) for f in full},
         "deterministic": {f: full[f][3] for f in full},
         "row_rel_max": {f: max(v) for f, v in rel.items()},
         "row_rel": rel,
         "worst_row": worst,
         "max_abs": {f: float((full[f][2] - d_plain).abs().max())
                     for f in full},
         "bands_vs_full_row_rel_max": max(row_rel(d_bands, full["warp"][2])),
         "vs_hard_row_rel_max": max(row_rel(full["warp"][2], d_h)),
         "finite": {f: bool(torch.isfinite(full[f][2]).all()) for f in full},
         "plain_45_bands_ms": plain_s * 1e3}
    emit(r)
    check(soft_launches == {"grad_soft": 2, "grad_replay_soft": 2},
          f"soft launches {soft_launches}")
    for f in full:
        what = f"K3 soft {f}"
        check(r["finite"][f], f"{what}: finite")
        check(r["image_bit_equal_to_hard_k3"][f]
              and r["image_bit_equal_to_k1"][f], f"{what}: image")
        check(r["rays"][f] == int(rays_h) == int(rays_k1) == rays_plain[0],
              f"{what}: rays")
        check(full[f][3], f"{what}: two launches differ")
        check(max(rel[f]) <= 1e-3, f"{what}: d_packed vs plain autograd")
    check(rays_bands == int(rays_h), "K3 soft: band rays")
    check(r["bands_vs_full_row_rel_max"] <= 1e-4,
          "K3 soft: 45 bands' d_packed != the full frame's")

    # ---- 7c. finite differences on a centre and a radius ---------------
    # L = sum(img * w) over 32 frames: AD through K3 (soft, and hard
    # beside it), central differences of K1's images; sphere 2 (the green
    # Lambert sphere in front of the camera), its x and its radius
    n_fd, h = 32, 0.02
    ad = {0.0: None, eps: None}
    for e in ad:
        c = cfg.replace(soft_silhouette_eps=e)
        d_sum = torch.zeros_like(d_h)
        for f in range(n_fd):
            d_sum += cuda_grad.render_tile_grad(scene_d, c, f, w, 0, 0, H,
                                                W)[2]
        ad[e] = cuda_grad.scene_cotangent_from_packed(scene_d, d_sum / n_fd)
    w64 = w.double()
    fd = []
    for field, idx in (("center", (2, 0)), ("radius", (2,))):
        vals = []
        for sign in (1.0, -1.0):
            x = getattr(scene_d, field).clone()
            x[idx] += sign * h
            s = scene_d.replace(**{field: x})
            vals.append(sum(float((cuda_render.render_tile(
                s, cfg, f, 0, 0, H, W)[0].double() * w64).sum())
                for f in range(n_fd)))
        g_fd = (vals[0] - vals[1]) / (2 * h * n_fd)
        g_soft = float(getattr(ad[eps], field)[idx])
        g_hard = float(getattr(ad[0.0], field)[idx])
        fd.append({"field": field, "index": list(idx), "fd": g_fd,
                   "ad_soft": g_soft, "ad_hard": g_hard,
                   "rel_soft": abs(g_soft - g_fd) / abs(g_fd),
                   "rel_hard": abs(g_hard - g_fd) / abs(g_fd)})
    emit({"phase": "grad_soft_finite_differences", "frames": n_fd, "h": h,
          "soft_eps": eps, "entries": fd})
    for e in fd:
        check(np.sign(e["ad_soft"]) == np.sign(e["fd"]),
              f"K3 soft vs finite differences, {e['field']}: sign")

    # ---- 7d. the training path with centres and radii ------------------
    # Every sphere but the floor and the lights moved (sigma 0.03, radii
    # 0.02), Adam at lr 1e-3 with the recipe's tonemapped loss and
    # adam_eps; the hard instance's fit from the same start beside it
    target, _ = cuda_render.render_frame(scene, cfg, 0)
    rng = np.random.default_rng(7)
    c_jit = rng.normal(0, 0.03, scene.center.shape).astype(np.float32)
    r_jit = rng.normal(0, 0.02, scene.radius.shape).astype(np.float32)
    still = [0] + list(scene.emissive_ids)
    c_jit[still] = 0.0
    r_jit[still] = 0.0
    start = scene.replace(center=scene.center + torch.from_numpy(c_jit),
                          radius=scene.radius + torch.from_numpy(r_jit))

    def fitter(c):
        return InverseRenderer(c, target, trainable=("center", "radius"),
                               learning_rate=1e-3,
                               loss_fn=image_l2_tonemapped, adam_eps=1e-3)
    inv = fitter(cfg_s)
    inv.fit(start, steps=1, resample=False)  # warm-up
    n_steps = 10
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted, losses = inv.fit(start, steps=n_steps, resample=False)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n_steps * 1e3
    fit_launches = {"render": cuda_render.launches["render"],
                    **{k: v for k, v in cuda_grad.launches.items()}}
    main_soft_launches = cuda_grad.launches["grad_soft"]
    _, losses_hard = fitter(cfg).fit(start, steps=n_steps, resample=False)
    emit({"phase": "training_path_soft", "soft_eps": eps,
          "trainable": ["center", "radius"], "losses": losses,
          "losses_hard_instance": losses_hard, "step_ms": step_ms,
          "launches": fit_launches,
          "center_moved": float((fitted.center.cpu()
                                 - start.center).abs().max())})
    check(all(np.isfinite(losses)), f"soft fit losses {losses}")
    check(losses[-1] < losses[0], f"soft fit loss not falling: {losses}")
    check(fit_launches["render"] == n_steps
          and main_soft_launches == n_steps
          and fit_launches["grad"] == 0
          and not any(v for k, v in fit_launches.items()
                      if k not in ("render", "grad_soft")),
          f"soft fit launched {fit_launches}")

    # ---- 7e. motion AD vs FD (tests/test_motion.py:33) ------------------
    cfg_m = RenderConfig(width=96, height=32, samples_per_pixel=2,
                         max_depth=2, soft_silhouette_eps=0.02)
    t_at, dt, n_m = 0.7, 0.05, 32
    motion = {}
    for name, c in (("soft", cfg_m),
                    ("hard", cfg_m.replace(soft_silhouette_eps=0.0))):
        g_sum = 0.0
        for f in range(n_m):
            t = torch.tensor(t_at, device=dev, requires_grad=True)
            img, _ = cuda_grad.render_frame_diff(
                scene_for_frame(scene_d, t, FLAG_ANIMATE), c, f)
            g_t, = torch.autograd.grad(img.mean(), t)
            g_sum += float(g_t)
        motion[name] = g_sum / n_m
    fp = fm = 0.0
    for f in range(n_m):
        fp += float(cuda_render.render_frame(scene_for_frame(
            scene_d, t_at + dt, FLAG_ANIMATE), cfg_m, f)[0].mean())
        fm += float(cuda_render.render_frame(scene_for_frame(
            scene_d, t_at - dt, FLAG_ANIMATE), cfg_m, f)[0].mean())
    m_fd = (fp - fm) / (2 * dt * n_m)
    m = {"phase": "motion_ad_vs_fd", "config": "96x32, spp 2, depth 2, "
         "eps 0.02, t 0.7, dt 0.05, 32 frames (tests/test_motion.py:33)",
         "fd": m_fd, "ad_soft": motion["soft"], "ad_hard": motion["hard"],
         "rel_soft": abs(motion["soft"] - m_fd) / abs(m_fd),
         "rel_hard": abs(motion["hard"] - m_fd) / abs(m_fd),
         "jax_rel_err_measured": 0.288}
    emit(m)
    check(np.sign(m["ad_soft"]) == np.sign(m_fd), "motion AD vs FD: sign")
    check(m["rel_soft"] < 0.40, f"motion AD vs FD: rel err {m['rel_soft']}")

    # ---- 7f. demo_motion at its defaults -------------------------------
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        demo = demo_motion.main([])
    emit({"phase": "demo_motion", **demo,
          "wall_s": time.perf_counter() - t1})
    check(demo["loss_final"] < demo["loss_initial"],
          f"demo_motion loss {demo['loss_initial']} -> {demo['loss_final']}")
    check(np.isfinite(demo["t_recovered"]), "demo_motion t finite")

    # ---- 7g. cycle shares, timing in turns, bound ----------------------
    shares = {f: grad_stats.form_stats(scene_d, cfg_s, f, w)
              for f in ("warp", "replay")}
    for f, st in shares.items():
        emit({"phase": "grad_soft_cycle_shares", "nvidia_smi": smi, **st})
    runs = {}
    for form in ("warp", "replay"):
        for e in (0.0, eps, eps, 0.0):
            runs.setdefault((form, e), []).append(time_device_call(
                cuda_grad.render_tile_grad_form, scene_d,
                cfg.replace(soft_silhouette_eps=e), 0, w, 0, 0, H, W, form,
                repeats=3)[0] * 1e3)
    ms = {f"{form}_{'soft' if e else 'hard'}": sum(v) / len(v)
          for (form, e), v in runs.items()}
    # Bound of the soft instance: the hard K3's count (K1's forward plus
    # the adjoint) and the estimator's work, from the plain version's soft
    # counters on frame 0: 16 operations per silhouette test (every
    # sphere for a ray that missed, the winner for one that hit) and per
    # shadow-boundary test (every sphere but the light for each shadow ray
    # whose light lies in front of the surface); 40 per traced ray (the
    # soft weight and the discriminant's adjoint), 100 per missed ray (the
    # tangent point's radiance with two lights) and 40 per shadow-boundary
    # scan (its sigmoid and the adjoint into the occluder and the cone).
    tab = cuda_render.pack_scene(scene_d)
    mat = torch.tensor(scene.mat_type, dtype=torch.int64, device=dev)
    yy, xx = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    with torch.no_grad():
        _, work = tc.render_pixels(
            tab, mat, scene.emissive_ids, cfg, camera_scalars(scene, cfg),
            xx.reshape(-1), yy.reshape(-1), 0, soft_eps=eps)
    n = scene.n_spheres
    sil, prox, traced = (int(x.sum()) for x in (
        work.silhouette_tests, work.proximity_tests, work.traced))
    misses = (sil - traced) // (n - 1)
    scans = prox // (n - 1)
    grad_ops = k1["ops"] + 150 * k1["traced"] + 270 * k1["shadow"]
    soft_ops = (grad_ops + 16 * sil + 16 * prox + 40 * traced + 100 * misses
                + 40 * scans)
    grad_bytes = k1["bytes"] + 4 * 3 * H * W
    bound = max(soft_ops / 67e12, grad_bytes / 3.35e12) * 1e3
    t = {"phase": "grad_soft_timing", "nvidia_smi": smi, "soft_eps": eps,
         "ms": ms, "runs": {f"{f}_{e}": v for (f, e), v in runs.items()},
         "soft_over_hard": {f: ms[f"{f}_soft"] / ms[f"{f}_hard"]
                            for f in ("warp", "replay")},
         "silhouette_tests": sil, "proximity_tests": prox,
         "missed_rays": misses, "boundary_scans": scans,
         "traced_rays": traced, "bound_fp32_ops": soft_ops,
         "bound_ms": bound,
         "hard_bound_ms": max(grad_ops / 67e12,
                              grad_bytes / 3.35e12) * 1e3,
         "bound_peak": "67 TFLOP/s FP32, 3.35 TB/s (H100 SXM, 700 W)",
         "ptxas": {k: usage.get(k, {}) for k in (
             "soft_warp_grad_kernel<0>", "lockstep_kernel<2,0>",
             "warp_grad_kernel<0>", "lockstep_kernel<1,0>")}}
    emit(t)
    check(traced == k1["traced"], "soft plain counters: traced rays")
    tol = ("d_packed per row <= 1e-3 x row max against plain autograd over "
           "45 bands (both forms), image bit-equal to K3 at eps 0 and to "
           "K1, rays exact, bit-equal launch to launch, 45 bands sum to the "
           "frame <= 1e-4; finite differences: sign; motion AD vs FD: sign, "
           "rel err < 0.40")
    return {"name": "grad_soft", "route": "cuda",
            "source": "toypathtracer_torch/csrc/grad.cu",
            "replaces": "toypathtracer_tpu/ops/pallas_grad.py:127",
            "launches": main_soft_launches,
            "max_abs_err": r["max_abs"]["warp"],
            "ms": ms["warp_soft"], "plain_ms": plain_s * 1e3,
            "bound_ms": bound, "bound_by": "operations", "library_ms": None,
            "form": "warp, soft instance (soft_warp_grad_kernel<0>: "
                    "csrc/gradwarp.cuh grad_tiles<true>), eps 0.05",
            "hard_ms": ms["warp_hard"],
            "baseline_ms": ms["replay_soft"],
            "baseline": "the replaying form's soft instance "
                        "(lockstep_kernel<2,0>), timed in turns with its "
                        "hard one",
            "ptxas": usage.get("soft_warp_grad_kernel<0>", {}),
            "cycle_shares": shares["warp"]["cycle_shares"],
            "vs_plain": {"tolerance": tol,
                         "full_frame_row_rel_max": r["row_rel_max"],
                         "finite_differences": fd,
                         "motion_rel_err": m["rel_soft"]}}


def scaled_phases(cfg, smi, usage):
    """Phases 8-10: the scaled scene's main path, its kernels against
    their plain versions at the full 100k-sphere scene, the scaled render
    kernel's forms against each other, and their timing.  `usage` is
    phase 1's -Xptxas -v table.  Returns the three kernels' entries of the
    `kernels` line."""
    import numpy as np

    from toypathtracer_torch import (FLAG_ANIMATE, FLAG_PROGRESSIVE,
                                     make_scaled_scene)
    from toypathtracer_torch.ops import cuda_render, cuda_scaled
    from toypathtracer_torch.ops import tracecore as tc
    from toypathtracer_torch.profiling import time_device_call
    from toypathtracer_torch.render import frame as frame_mod
    from toypathtracer_torch.scaled import (ChunkedScenePort, ChunkTraversal,
                                            pack_chunks,
                                            render_tile_scaled_plain)
    from toypathtracer_torch.tools import hit_stats, shadow_stats

    dev = torch.device("cuda")
    t_min, t_max = float(np.float32(cfg.min_t)), float(np.float32(cfg.max_t))
    H, W = cfg.height, cfg.width
    scene = make_scaled_scene(100_000)
    sd = scene.to(dev)
    K, C = sd.chunk, sd.n_chunks
    rows = pack_chunks(sd)
    tab = cuda_render.pack_scene(sd)
    mat = sd.mat_ids().long()
    trav = ChunkTraversal(rows, K)
    lights = list(sd.emissive_ids)
    scene_bytes = 4 * (tab.numel() + rows.numel() + mat.numel())

    # ---- 8. the scaled main path ----------------------------------------
    t0 = time.perf_counter()
    for k in cuda_scaled.launches:
        cuda_scaled.launches[k] = 0
    sess = frame_mod.RenderSession(scene, cfg, flags=FLAG_PROGRESSIVE,
                                   device="cuda")
    rays = []
    img0 = None
    for f in range(4):
        img, r = sess.step(time=0.0)
        if f == 0:
            img0 = img.clone()
        rays.append(r)
    accum = sess.state.accum.clone()
    sess.set_flags(FLAG_PROGRESSIVE | FLAG_ANIMATE)
    img_anim, rays_anim = sess.step(time=1.0)
    img_anim = img_anim.clone()
    # the traversal queries of ChunkedScenePort: frame 0's camera rays (K5),
    # then NEE's shadow rays from their first Lambert hits (K6), the cone
    # samples drawn as tracecore.bounce draws them (tools.shadow_stats)
    port = ChunkedScenePort(sess.scene)
    wl = shadow_stats.workload(port, cfg)
    cam_ro, cam_rd, hit_id = wl.cam_ro, wl.cam_rd, wl.hit_id
    pos, dirs, t_ls = wl.pos, wl.dirs, wl.t_ls
    visible = port.lights_visible(pos, dirs, lights, cfg.min_t, cfg.max_t)
    torch.cuda.synchronize()
    main_launches = dict(cuda_scaled.launches)
    rays = [int(r) for r in rays]
    anim_diff = float((img_anim - img0).abs().max())
    main = {"phase": "scaled_main_path", "spheres": sd.n_spheres,
            "chunks": C, "lights": len(lights), "frames": 5,
            "launches": main_launches, "rays_per_frame": rays,
            "rays_animated": int(rays_anim),
            "accum_finite": bool(torch.isfinite(accum).all()),
            "animated_vs_static_max_abs": anim_diff,
            "camera_rays": int(hit_id.numel()),
            "camera_hits": int((hit_id >= 0).sum()),
            "lambert_hits": int(pos[0].numel()),
            "visible_light_samples": int(sum(int(x.sum()) for x in visible)),
            "seconds": time.perf_counter() - t0}
    emit(main)
    check({k: v for k, v in main_launches.items() if v}
          == {"scaled_render": 5, "hit_chunks": 1, "shadow_chunks": 1},
          f"scaled main path launched {main_launches}")
    check(tuple(accum.shape) == (720, 1280, 3) and main["accum_finite"],
          "scaled accumulated image shape/finite")
    check(anim_diff > 1e-3, "the animated frame equals the static one")
    check(min(rays) > H * W, "scaled frames traced too few rays")

    # ---- 9. kernels vs plain at the full scene ----------------------------
    def hit_case(name, ro, rd):
        """K5's main-path form against the per-thread kernel it replaced
        (ids and t bit-equal on every ray) and against the plain
        version."""
        t1 = time.perf_counter()
        args = (rows, ro, rd, K, t_min, t_max)
        t_k, id_k = cuda_scaled.hit_chunks(*args, index=port.chunk_index)
        t_b, id_b = cuda_scaled.hit_chunks_form(*args, "thread")
        plain_s, (t_p, id_p, slabs, spheres, roots) = time_device_call(
            trav.nearest_hit_roots, ro, rd, t_min, t_max)
        agree = id_k.long() == id_p
        both = agree & (id_p >= 0)
        n = int(id_k.numel())
        check(bool(both.any()), f"K5 {name}: no ray hit")
        r = {"phase": "hit_chunks_vs_plain", "case": name, "rays": n,
             "hits": int((id_p >= 0).sum()),
             "bit_equal_to_thread_form": bool(
                 torch.equal(id_k, id_b)
                 and torch.equal(t_k.view(torch.int32),
                                 t_b.view(torch.int32))),
             "id_mismatch": int((~agree).sum()),
             "t_rel_max": float(((t_k - t_p).abs() / t_p.abs())[both].max()),
             "t_abs_max": float((t_k - t_p).abs()[both].max()),
             "slab_tests": int(slabs.sum()),
             "sphere_tests": int(spheres.sum()),
             "root_tests": int(roots.sum()),
             "plain_ms": plain_s * 1e3, "seconds": time.perf_counter() - t1}
        emit(r)
        check(r["bit_equal_to_thread_form"],
              f"K5 {name}: the cooperative form's ids or t != the "
              "per-thread kernel's")
        check(r["id_mismatch"] <= 1e-5 * n, f"K5 {name}: ids")
        check(r["t_rel_max"] <= 1e-6, f"K5 {name}: t")
        return r, (slabs, spheres, roots), args

    k5, k5_work, k5_args = hit_case("camera_1280x720", cam_ro, cam_rd)
    rng = np.random.default_rng(5)
    o = rng.uniform((-150.0, 0.5, -150.0), (150.0, 12.0, 150.0),
                    (65536, 3)).astype(np.float32).T
    d = rng.normal(size=(3, 65536)).astype(np.float32)
    d /= np.sqrt((d * d).sum(axis=0))
    k5_random, _, _ = hit_case(
        "random_65536", tuple(torch.from_numpy(o.copy()).to(dev)),
        tuple(torch.from_numpy(d).to(dev)))

    # step 1 and the cooperative form's work: both counted instances on the
    # camera rays (tools.hit_stats); then the forms in turns: coop, thread,
    # thread, coop, and the cooperative wrapper once more building its
    # index itself
    t1 = time.perf_counter()
    k5_stats = hit_stats.measure(port, cfg)
    emit({"phase": "hit_traversal_stats", "nvidia_smi": smi, **k5_stats})
    check(k5_stats["bit_equal"], "K5 counted instances: ids or t differ")
    k5_st = {f["form"]: f for f in k5_stats["forms"]}
    for f in k5_st.values():
        check(f["counters"]["hit"]["need"] == k5["sphere_tests"],
              f"K5 {f['form']} counted instance: sphere tests "
              f"{f['counters']['hit']['need']} vs plain {k5['sphere_tests']}")
    check(k5_st["thread"]["counters"]["hit"]["slabs"] == k5["slab_tests"],
          "K5 thread counted instance: slab tests vs plain")
    k5_runs = {}
    for form in ("coop", "thread", "thread", "coop"):
        k5_runs.setdefault(form, []).append(time_device_call(
            cuda_scaled.hit_chunks_form, *k5_args, form, port.chunk_index,
            repeats=10)[0] * 1e3)
    k5_ms = {f: sum(v) / len(v) for f, v in k5_runs.items()}
    k5_index_in_wrapper_ms = time_device_call(
        cuda_scaled.hit_chunks_form, *k5_args, "coop", repeats=10)[0] * 1e3
    # Bounds: 12 operations per slab test, 16 per sphere test (K1's count)
    # and 3 more (sqrt, 2 roots) per root test, a sphere test whose
    # discriminant is positive (the plain version's count).  Old: the
    # plain version's counts (every chunk box of each ray).  New: each term
    # the lesser of the plain count and the cooperative counted
    # instance's, whose prefilter tests 25 group boxes a ray and the chunk
    # boxes of the groups its warp enters, so the function needs no more.
    n_k5 = k5["rays"]
    k5_bytes = 4 * rows.numel() + n_k5 * (6 * 4 + 8)
    k5_old_ops = (12 * k5["slab_tests"] + 16 * k5["sphere_tests"]
                  + 3 * k5["root_tests"])
    st_c = k5_st["coop"]["counters"]
    k5_terms = {"slab_tests": min(k5["slab_tests"], st_c["hit"]["slabs"]
                                  + st_c["groups"]["slabs"]),
                "sphere_tests": min(k5["sphere_tests"],
                                    st_c["hit"]["need"]),
                "root_tests": k5["root_tests"]}
    k5_ops = (12 * k5_terms["slab_tests"] + 16 * k5_terms["sphere_tests"]
              + 3 * k5_terms["root_tests"])

    def k5_bound(ops):
        ms = max(ops / 67e12, k5_bytes / 3.35e12) * 1e3
        return ms, "operations" if ops / 67e12 >= k5_bytes / 3.35e12 \
            else "bytes"
    k5_bound_old, _ = k5_bound(k5_old_ops)
    k5_bound_ms, k5_bound_by = k5_bound(k5_ops)
    k5_timing = {"phase": "hit_chunks_timing", "nvidia_smi": smi,
                 "ms": k5_ms, "runs": k5_runs,
                 "coop_over_thread": k5_ms["coop"] / k5_ms["thread"],
                 "coop_index_built_in_wrapper_ms": k5_index_in_wrapper_ms,
                 "plain_ms": k5["plain_ms"],
                 "simt_efficiency": {f: k5_st[f]["simt_efficiency"]
                                     for f in k5_st},
                 "bound_fp32_ops_old": k5_old_ops,
                 "bound_ms_old": k5_bound_old, "bound_work_new": k5_terms,
                 "bound_fp32_ops": k5_ops, "bound_bytes": k5_bytes,
                 "bound_ms": k5_bound_ms, "bound_by": k5_bound_by,
                 "seconds": time.perf_counter() - t1}
    emit(k5_timing)

    def k6_case(name, pos, dirs, t_ls):
        """K6's main-path form against the per-thread form it replaced
        (bits equal on every pair) and against the plain version."""
        t1 = time.perf_counter()
        flat = tuple(x for l in dirs for x in l)
        args = (rows, pos, flat, tuple(t_ls), K, lights, t_min)
        bits_k = cuda_scaled.shadow_chunks(*args,
                                           index=port.chunk_index)
        bits_t = cuda_scaled.shadow_chunks_form(*args, "thread")
        plain_s, (bits_p, slabs, spheres) = time_device_call(
            trav.occlusion_bits, pos, dirs, t_ls, lights, t_min)
        n = int(bits_k.numel())
        diff = bits_k ^ bits_p
        r = {"phase": "shadow_chunks_vs_plain", "case": name, "rays": n,
             "lights": len(lights),
             "bit_equal_to_thread_form": bool(torch.equal(bits_k, bits_t)),
             "ray_mismatch": int((diff != 0).sum()),
             "bit_mismatch": int(sum(int(((diff >> k) & 1).sum())
                                     for k in range(len(lights)))),
             "occluded_bits": int(sum(int(((bits_p >> k) & 1).sum())
                                      for k in range(len(lights)))),
             "slab_tests": int(slabs.sum()),
             "sphere_tests": int(spheres.sum()),
             "plain_ms": plain_s * 1e3, "seconds": time.perf_counter() - t1}
        emit(r)
        check(r["bit_equal_to_thread_form"],
              f"K6 {name}: the cooperative form's bits != the per-thread "
              "form's")
        check(r["ray_mismatch"] <= 1e-5 * n, f"K6 {name}: occlusion bits")
        return r, args

    k6, k6_args = k6_case("camera_1280x720", pos, dirs, t_ls)
    # 65,536 random origins over the field toward the beacons, jittered
    o = torch.from_numpy(rng.uniform((-150.0, 0.5, -150.0),
                                     (150.0, 12.0, 150.0),
                                     (65536, 3)).astype(np.float32).T.copy())
    r_pos = tuple(o.to(dev))
    r_dirs, r_tls = [], []
    for e in lights:
        d = torch.from_numpy(rng.normal(0, 3.0, (3, 65536)).astype(
            np.float32)).to(dev)
        r_dirs.append(tc.normalize3(tuple(tab[a, e] - r_pos[a] + d[a]
                                          for a in range(3))))
        r_tls.append(tc.sphere_t(tab[0, e], tab[1, e], tab[2, e], tab[3, e],
                                 r_pos, r_dirs[-1], t_min)[0])
    k6_random, _ = k6_case("random_65536", r_pos, r_dirs, r_tls)

    # step 1 and the cooperative form's work: both counted instances on
    # the camera case (tools.shadow_stats); then the forms in turns:
    # coop, thread, thread, coop, and the cooperative wrapper once more
    # building its chunk index (walk order, group boxes, records) itself
    t1 = time.perf_counter()
    k6_stats = {}
    for form in ("thread", "coop"):
        bits_s, k6_stats[form] = shadow_stats.form_stats(port, wl, cfg, form)
        emit({"phase": "shadow_traversal_stats", "nvidia_smi": smi,
              **k6_stats[form]})
        check(bool(torch.equal(bits_s, cuda_scaled.shadow_chunks(
            *k6_args, index=port.chunk_index))),
              f"K6 {form} counted instance != the timed kernel")
    k6_runs = {}
    for form in ("coop", "thread", "thread", "coop"):
        k6_runs.setdefault(form, []).append(time_device_call(
            cuda_scaled.shadow_chunks_form, *k6_args, form,
            port.chunk_index, repeats=3)[0] * 1e3)
    k6_ms = {f: sum(v) / len(v) for f, v in k6_runs.items()}
    index_in_wrapper_ms = time_device_call(
        cuda_scaled.shadow_chunks_form, *k6_args, "coop",
        repeats=3)[0] * 1e3
    # Bounds: 12 operations per slab test, 20 per occlusion sphere test up
    # to the first occluder.  Old: the plain version's counts (every chunk
    # box of each pair, the chunks in the rows' order).  New: each term the
    # lesser of the plain count and the cooperative counted instance's,
    # whose group boxes over a spatial order skip chunk boxes and which
    # takes the light's chunk last, so the function needs no more.
    st_c = k6_stats["coop"]["counters"]
    n_k6 = k6["rays"]
    k6_bytes = 4 * rows.numel() + n_k6 * 4 * (3 + 4 * len(lights) + 1)
    old_ops = 12 * k6["slab_tests"] + 20 * k6["sphere_tests"]
    new_terms = {"slab_tests": min(k6["slab_tests"], st_c["slabs"]),
                 "sphere_tests": min(k6["sphere_tests"], st_c["need"])}
    new_ops = 12 * new_terms["slab_tests"] + 20 * new_terms["sphere_tests"]

    def bound(ops):
        ms = max(ops / 67e12, k6_bytes / 3.35e12) * 1e3
        return ms, "operations" if ops / 67e12 >= k6_bytes / 3.35e12 \
            else "bytes"
    k6_bound_old, _ = bound(old_ops)
    k6_bound, k6_bound_by = bound(new_ops)
    k6_timing = {"phase": "shadow_chunks_timing", "nvidia_smi": smi,
                 "ms": k6_ms, "runs": k6_runs,
                 "coop_over_thread": k6_ms["coop"] / k6_ms["thread"],
                 "coop_index_built_in_wrapper_ms": index_in_wrapper_ms,
                 "plain_ms": k6["plain_ms"],
                 "simt_efficiency": {f: k6_stats[f]["simt_efficiency"]
                                     for f in k6_stats},
                 "bound_fp32_ops_old": old_ops, "bound_ms_old": k6_bound_old,
                 "bound_work_new": new_terms, "bound_fp32_ops": new_ops,
                 "bound_bytes": k6_bytes, "bound_ms": k6_bound,
                 "bound_by": k6_bound_by,
                 "seconds": time.perf_counter() - t1}
    emit(k6_timing)

    def forms_equal(what, sc, c, frame, y0, h, main):
        """The per-lane form on the same tile as the main path's form:
        image and rays bit-equal."""
        img, rays = main
        img_f, rays_f = cuda_scaled.render_tile_scaled_form(
            sc, c, frame, 0, y0, h, c.width, "lane")
        torch.cuda.synchronize()
        r = {"bit_equal": bool(torch.equal(img_f, img)),
             "rays_equal": int(rays_f) == int(rays),
             "pixels_differ": int((img_f != img).any(-1).sum())}
        emit({"phase": "scaled_forms_bit_equal", "case": what, **r})
        check(r["bit_equal"] and r["rays_equal"],
              f"scaled {what}: the per-lane form differs from coop")
        return r

    small = cfg.replace(width=320, height=176, samples_per_pixel=1,
                        max_depth=4)
    bit_equal = {}
    for frame in range(2):
        t1 = time.perf_counter()
        img_k, rays_k = cuda_scaled.render_tile_scaled(sd, small, frame, 0, 0,
                                                       176, 320)
        img_p, rays_p = render_tile_scaled_plain(sd, small, frame, 0, 0, 176,
                                                 320)
        torch.cuda.synchronize()
        r = compare(img_k, rays_k, img_p, rays_p)
        emit({"phase": "scaled_render_vs_plain", "size": "320x176",
              "frame": frame, **r, "seconds": time.perf_counter() - t1})
        check(r["finite"], f"scaled 320x176 frame {frame}: finite")
        check(r["rays_rel_diff"] <= 5e-4, f"scaled 320x176 frame {frame}: "
              "rays")
        check(r["mean_abs_diff"] <= 1e-3, f"scaled 320x176 frame {frame}: "
              "mean")
        bit_equal[f"320x176_frame{frame}"] = forms_equal(
            f"320x176 frame {frame}", sd, small, frame, 0, 176,
            (img_k, rays_k))
    t1 = time.perf_counter()
    y0 = H // 2 - 8
    img_k, rays_k = cuda_scaled.render_tile_scaled(sd, cfg, 0, 0, y0, 16, W)
    img_p, rays_p = render_tile_scaled_plain(sd, cfg, 0, 0, y0, 16, W)
    torch.cuda.synchronize()
    band = compare(img_k, rays_k, img_p, rays_p)
    emit({"phase": "scaled_render_vs_plain", "size": f"16x{W} band at row "
          f"{y0} of 1280x720, spp 4, depth 10", "frame": 0, **band,
          "seconds": time.perf_counter() - t1})
    check(band["finite"] and band["rays_rel_diff"] <= 5e-4
          and band["mean_abs_diff"] <= 1e-3, "scaled full-size band")
    bit_equal["band"] = forms_equal("16-row band", sd, cfg, 0, y0, 16,
                                    (img_k, rays_k))

    # the full frame through the plain version: its work counters give the
    # bound, and its image one more comparison
    t1 = time.perf_counter()
    full_plain_s, (img_fp, rays_fp, work) = time_device_call(
        render_tile_scaled_plain, sd, cfg, 0, 0, 0, H, W, True)
    img_fk, rays_fk = cuda_scaled.render_tile_scaled(sd, cfg, 0, 0, 0, H, W)
    torch.cuda.synchronize()
    full = compare(img_fk, rays_fk, img_fp, rays_fp)
    w = {k: int(getattr(work, k).sum()) for k in work._fields}
    emit({"phase": "scaled_render_vs_plain", "size": "1280x720", "frame": 0,
          **full, "work": w, "seconds": time.perf_counter() - t1})
    check(full["finite"] and full["rays_rel_diff"] <= 5e-4
          and full["mean_abs_diff"] <= 1e-3, "scaled full frame vs plain")
    bit_equal["1280x720"] = forms_equal("1280x720 frame 0", sd, cfg, 0, 0, H,
                                        (img_fk, rays_fk))
    sd_anim = sd.animate(1.0)
    img_ak, rays_ak = cuda_scaled.render_tile_scaled(sd_anim, cfg, 0, 0, 0, H,
                                                     W)
    bit_equal["animated"] = forms_equal("1280x720 animated (t=1)", sd_anim,
                                        cfg, 0, 0, H, (img_ak, rays_ak))

    # both forms' stats instances on frame 0.  Their images are
    # the timed instances'; the sphere tests the hit rays need are the
    # plain version's count, and in the per-lane form, which takes every
    # chunk in order, the shadow rays' tests and the slab tests too.
    t1 = time.perf_counter()
    simt = {}
    for form in ("lane", "coop"):
        img_s, rays_s, st_k = cuda_scaled.render_tile_scaled_form(
            sd, cfg, 0, 0, 0, H, W, form, stats=True)
        torch.cuda.synchronize()
        simt[form] = st_k
        same = bool(torch.equal(img_s, img_fk)) and int(rays_s) == int(rays_fk)
        need = {"hit": w["hit_tests"]}
        if form == "lane":
            need["shadow"] = w["occlusion_tests"]
        rel = {k: abs(st_k[k]["need"] - v) / max(v, 1)
               for k, v in need.items()}
        emit({"phase": "scaled_traversal_stats", "form": form,
              "bit_equal_to_timed": same, "need_rel_vs_plain": rel,
              "plain_slab_tests": w["slab_tests"], **st_k,
              "seconds": time.perf_counter() - t1})
        check(same, f"scaled {form} stats instance != its timed instance")
        check(max(rel.values()) <= 1e-4,
              f"scaled {form} stats: sphere tests needed vs plain {rel}")
        if form == "lane":
            slabs = st_k["hit"]["slabs"] + st_k["shadow"]["slabs"]
            check(abs(slabs - w["slab_tests"]) <= 1e-4 * w["slab_tests"],
                  f"scaled lane stats: slab tests {slabs} vs plain "
                  f"{w['slab_tests']}")

    # ---- 10. timing ------------------------------------------------------
    # the forms in turns at both sizes: coop, lane, lane, coop; each entry
    # the mean of its two runs
    t1 = time.perf_counter()
    form_ms = {}
    for name, c, h, reps in (("1280x720", cfg, H, 3),
                             ("320x176", small, 176, 10)):
        runs = {}
        for form in ("coop", "lane", "lane", "coop"):
            runs.setdefault(form, []).append(time_device_call(
                cuda_scaled.render_tile_scaled_form, sd, c, 0, 0, 0, h,
                c.width, form, repeats=reps)[0] * 1e3)
        form_ms[name] = {f: {"ms": sum(v) / len(v), "runs": v}
                         for f, v in runs.items()}
    full_s = form_ms["1280x720"][cuda_scaled.MAIN_FORM]["ms"] * 1e-3
    small_s = form_ms["320x176"][cuda_scaled.MAIN_FORM]["ms"] * 1e-3
    small_plain_s, (_, small_rays, small_work) = time_device_call(
        render_tile_scaled_plain, sd, small, 0, 0, 0, 176, 320, True)
    _, _, small_stats = cuda_scaled.render_tile_scaled_form(
        sd, small, 0, 0, 0, 176, 320, "coop", stats=True)
    sess = frame_mod.RenderSession(scene, cfg, flags=FLAG_PROGRESSIVE,
                                   device="cuda")
    sess.step(time=0.0)
    timed = []
    step_s, _ = time_device_call(
        lambda: timed.append(sess.step(time=0.0)[1]), repeats=3)
    step_rays = frame_mod.sum_rays(torch.stack(timed)) / len(timed)

    def render_bound(w, st, pixels):
        """The scaled render's counted work: each term the lesser of the
        plain version's count (w, the sequential scan) and the cooperative
        stats instance's (st), which tests a shadow ray's own chunk first
        and skips chunks by group boxes, so the function needs no more."""
        terms = {"slab_tests": min(w["slab_tests"], st["hit"]["slabs"]
                                   + st["shadow"]["slabs"]),
                 "hit_tests": min(w["hit_tests"], st["hit"]["need"]),
                 "shadow": w["shadow"],
                 "occlusion_tests": min(w["occlusion_tests"],
                                        st["shadow"]["need"])}
        ops = (12 * terms["slab_tests"] + 19 * terms["hit_tests"]
               + 19 * terms["shadow"] + 20 * terms["occlusion_tests"])
        n_bytes = scene_bytes + 4 * 3 * pixels + 8
        return ops, n_bytes, max(ops / 67e12, n_bytes / 3.35e12) * 1e3, terms

    def warp_efficiency(lane_ops, rows, cols):
        """sum / (32 x the warp's most) of per-lane operation counts over
        the kernel's warps of rows x cols lanes: the share of a warp's
        lane-steps that do work if each warp runs as long as its busiest
        lane (an upper count: lanes also wait on each other inside a
        pixel's sequence of loops)."""
        h, w = lane_ops.shape
        g = lane_ops.double().reshape(h // rows, rows, w // cols, cols)
        g = g.permute(0, 2, 1, 3).reshape(-1, rows * cols)
        return float(g.sum() / (g.amax(dim=1).sum() * rows * cols))

    pix_ops = (12 * work.slab_tests + 19 * work.hit_tests + 19 * work.shadow
               + 20 * work.occlusion_tests).reshape(H, W)
    # K5/K6: 32 consecutive rays a warp; the per-lane render kernel: 16x2
    # pixels (a model of that form only: the cooperative form's figures are
    # its stats instance's SIMT efficiencies and path-loop busy share)
    divergence = {
        "lane_form_render_1280x720": warp_efficiency(pix_ops, 2, 16),
        "hit_chunks_camera": warp_efficiency(
            (12 * k5_work[0] + 16 * k5_work[1] + 3 * k5_work[2])
            .reshape(-1, 32), 1, 32),
    }
    sw = {k: int(getattr(small_work, k).sum()) for k in small_work._fields}
    ops_f, bytes_f, bound_f, terms_f = render_bound(w, simt["coop"], H * W)
    ops_s, bytes_s, bound_s, terms_s = render_bound(sw, small_stats,
                                                    176 * 320)
    timing = {"phase": "scaled_timing", "nvidia_smi": smi,
              "full_kernel_ms": full_s * 1e3,
              "full_plain_ms": full_plain_s * 1e3,
              "full_rays": int(rays_fk),
              "full_kernel_mray_s": int(rays_fk) / full_s * 1e-6,
              "session_step_ms": step_s * 1e3,
              "session_mray_s": step_rays / step_s * 1e-6,
              "full_bound_fp32_ops": ops_f, "full_bound_bytes": bytes_f,
              "full_bound_ms": bound_f, "full_bound_work": terms_f,
              "small_kernel_ms": small_s * 1e3,
              "small_plain_ms": small_plain_s * 1e3,
              "small_rays": int(small_rays),
              "small_kernel_mray_s": int(small_rays) / small_s * 1e-6,
              "small_work": sw, "small_bound_work": terms_s,
              "small_bound_fp32_ops": ops_s,
              "small_bound_ms": bound_s,
              "hit_chunks_ms": k5_ms[cuda_scaled.HIT_MAIN_FORM],
              "shadow_chunks_ms": k6_ms[cuda_scaled.SHADOW_MAIN_FORM],
              "forms_ms": form_ms,
              "sphere_loop_simt_efficiency": {
                  f: {k: simt[f][k]["simt_efficiency"]
                      for k in ("hit", "shadow")} for f in simt},
              "path_loop_busy_share_coop": simt["coop"]["loop"]["busy"]
              / (32 * simt["coop"]["loop"]["iters"]),
              "coop_cycle_shares": {
                  k: simt["coop"]["loop"][f"cycles_{k}"]
                  / simt["coop"]["loop"]["cycles"]
                  for k in ("hit", "nee", "shadow")},
              "warp_work_efficiency": divergence,
              "bound_peak": "67 TFLOP/s FP32, 3.35 TB/s (H100 SXM, 700 W)",
              "seconds": time.perf_counter() - t1}
    emit(timing)
    tol = "rays rel <= 5e-4, mean |diff| <= 1e-3 (320x176 frames 0-1, " \
          "16-row band and full frame at 1280x720); bit-equal to the " \
          "per-lane form there and on the animated frame"
    reg = {f: usage.get(k, {}) for f, k in (
        ("coop", "coop_render_kernel<0>"),
        ("lane", "scaled_render_kernel<0>"))}
    return [
        {"name": "scaled_render", "route": "cuda",
         "source": "toypathtracer_torch/csrc/scaled.cu",
         "replaces": "toypathtracer_tpu/scaled.py:816",
         "launches": main_launches["scaled_render"],
         "max_abs_err": full["max_abs_diff"],
         "ms": full_s * 1e3, "plain_ms": full_plain_s * 1e3,
         "bound_ms": bound_f,
         "bound_by": "operations" if ops_f / 67e12 >= bytes_f / 3.35e12
         else "bytes", "library_ms": None,
         "form": cuda_scaled.MAIN_FORM,
         "baseline_ms": form_ms["1280x720"]["lane"]["ms"],
         "baseline": "the per-lane form it replaced "
                     "(scaled_render_kernel<0>), timed in turns with it",
         "ms_320x176": form_ms["320x176"],
         "sphere_loop_simt_efficiency": {
             f: {k: simt[f][k]["simt_efficiency"] for k in ("hit", "shadow")}
             for f in simt},
         "ptxas": reg,
         "vs_plain": {"tolerance": tol, "band": band, "full_frame": full,
                      "bit_equal_to_lane_form": bit_equal}},
        {"name": "hit_chunks", "route": "cuda",
         "source": "toypathtracer_torch/csrc/scaled.cu",
         "replaces": "toypathtracer_tpu/ops/scaled_pallas.py:64",
         "launches": main_launches["hit_chunks"],
         "max_abs_err": k5["t_abs_max"],
         "ms": k5_ms[cuda_scaled.HIT_MAIN_FORM],
         "plain_ms": k5["plain_ms"], "bound_ms": k5_bound_ms,
         "bound_by": k5_bound_by, "library_ms": None,
         "form": "coop (coop_hit_kernel<0>: csrc/coop.cuh hit_chunks_warp "
                 "with scaled.chunk_index's group boxes)",
         "baseline_ms": k5_ms["thread"],
         "baseline": "the per-thread K5 it replaced "
                     "(hit_chunks_kernel<0>), timed in turns with it",
         "bound_ms_old": k5_bound_old,
         "index_built_in_wrapper_ms": k5_index_in_wrapper_ms,
         "sphere_loop_simt_efficiency": k5_st["coop"]["simt_efficiency"],
         "ptxas": usage.get("coop_hit_kernel<0>", {}),
         "vs_plain": {"tolerance": "ids equal on all but 1e-5 of the rays, "
                                   "t rel <= 1e-6 where they agree; ids and "
                                   "t bit-equal to the per-thread kernel on "
                                   "every ray",
                      "id_mismatch": k5["id_mismatch"],
                      "id_mismatch_random": k5_random["id_mismatch"],
                      "t_rel_max": k5["t_rel_max"],
                      "bit_equal_to_thread_form": {
                          "camera_1280x720": k5["bit_equal_to_thread_form"],
                          "random_65536":
                              k5_random["bit_equal_to_thread_form"]}}},
        {"name": "hit_chunks_baseline", "route": "cuda",
         "source": "toypathtracer_torch/csrc/scaled.cu",
         "replaces": "toypathtracer_tpu/ops/scaled_pallas.py:64",
         "launches": main_launches["hit_chunks_baseline"],
         "max_abs_err": k5["t_abs_max"], "ms": k5_ms["thread"],
         "plain_ms": k5["plain_ms"], "bound_ms": k5_bound_ms,
         "bound_by": k5_bound_by, "library_ms": None,
         "form": "thread (hit_chunks_kernel<0>)",
         "baseline": "the per-thread K5, kept beside the cooperative one "
                     "as its A/B and equality baseline; not on the main path",
         "sphere_loop_simt_efficiency": k5_st["thread"]["simt_efficiency"],
         "ptxas": usage.get("hit_chunks_kernel<0>", {}),
         "vs_plain": {"tolerance": "bit-equal to the cooperative form"}},
        {"name": "shadow_chunks", "route": "cuda",
         "source": "toypathtracer_torch/csrc/scaled.cu",
         "replaces": "toypathtracer_tpu/ops/scaled_pallas.py:143",
         "launches": main_launches["shadow_chunks"],
         "max_abs_err": float(k6["bit_mismatch"] > 0),
         "ms": k6_ms[cuda_scaled.SHADOW_MAIN_FORM],
         "plain_ms": k6["plain_ms"], "bound_ms": k6_bound,
         "bound_by": k6_bound_by, "library_ms": None,
         "form": "coop (coop_shadow_kernel<0>: csrc/coop.cuh "
                 "shadow_chunks_warp over scaled.chunk_index)",
         "baseline_ms": k6_ms["thread"],
         "baseline": "the per-thread K6 it replaced "
                     "(shadow_chunks_kernel<0>), timed in turns with it",
         "bound_ms_old": k6_bound_old,
         "index_built_in_wrapper_ms": index_in_wrapper_ms,
         "sphere_loop_simt_efficiency": k6_stats["coop"]["simt_efficiency"],
         "ptxas": usage.get("coop_shadow_kernel<0>", {}),
         "vs_plain": {"tolerance": "bits equal on all but 1e-5 of the rays; "
                                   "bit-equal to the per-thread form on "
                                   "every pair",
                      "ray_mismatch": k6["ray_mismatch"],
                      "ray_mismatch_random": k6_random["ray_mismatch"],
                      "bit_equal_to_thread_form": {
                          "camera_1280x720": k6["bit_equal_to_thread_form"],
                          "random_65536":
                              k6_random["bit_equal_to_thread_form"]}}},
        {"name": "shadow_chunks_baseline", "route": "cuda",
         "source": "toypathtracer_torch/csrc/scaled.cu",
         "replaces": "toypathtracer_tpu/ops/scaled_pallas.py:143",
         "launches": main_launches["shadow_chunks_baseline"],
         "max_abs_err": float(k6["bit_mismatch"] > 0),
         "ms": k6_ms["thread"], "plain_ms": k6["plain_ms"],
         "bound_ms": k6_bound, "bound_by": k6_bound_by,
         "library_ms": None, "form": "thread (shadow_chunks_kernel<0>)",
         "baseline": "the per-thread K6, kept beside the cooperative one as "
                     "its A/B and equality baseline; not on the main path",
         "sphere_loop_simt_efficiency":
             k6_stats["thread"]["simt_efficiency"],
         "ptxas": usage.get("shadow_chunks_kernel<0>", {}),
         "vs_plain": {"tolerance": "bit-equal to the cooperative form"}}]


class ChunkCount:
    """The plain chunk traversal (scaled.ChunkTraversal) that also counts,
    over the lanes it answers for, what the chunked gradient kernel's bound
    needs beyond tracecore.Work: the sphere tests whose root the function
    takes (a positive discriminant), the rays that miss, and the shadow
    rays whose boundary scan runs."""

    def __init__(self, rows, chunk, tab):
        from toypathtracer_torch.scaled import ChunkTraversal
        self.trav = ChunkTraversal(rows, chunk, tab=tab)
        self.hit_roots = self.misses = self.scans = 0

    def nearest_hit(self, ro, rd, t_min, t_max, active=None):
        t, hid, slabs, spheres, roots = self.trav.nearest_hit_roots(
            ro, rd, t_min, t_max, active)
        act = torch.ones_like(hid, dtype=torch.bool) if active is None \
            else active
        self.hit_roots += int(roots[act].sum())
        self.misses += int((act & (hid < 0)).sum())
        return t, hid, slabs, spheres

    def occluded(self, *args, **kw):
        return self.trav.occluded(*args, **kw)

    def silhouette(self, *args, **kw):
        return self.trav.silhouette(*args, **kw)

    def proximity(self, pos, l, light, t_min, t_l, soft_eps, active=None):
        self.scans += int(pos[0].numel() if active is None else active.sum())
        return self.trav.proximity(pos, l, light, t_min, t_l, soft_eps,
                                   active)


def chunked_grad_bound(scene, cfg, eps, n_lights, records):
    """The chunked gradient kernel's bound on frame 0 of `cfg`, from the
    plain version's work counters (ChunkCount, tracecore.Work): the
    scaled render's forward count as K5's and K6's -- 12 operations per
    slab test, 16 per sphere test and 3 more where the root is taken, 19
    per shadow ray (its light's root), 20 per occlusion test, the slab,
    sphere and occlusion tests each the lesser of the plain count and the
    cooperative render stats instance's on the same frame (it tests a
    shadow ray's own chunk first and skips chunks by group boxes, so the
    function needs no more; render_bound in scaled_phases) -- then K3's
    adjoint, ~150 per traced ray and ~270 per shadow ray, and with eps > 0
    the estimator's: 16 per silhouette and boundary test, 40 per traced
    ray, 40 + 30 per light for each missed ray (its tangent radiance), 40
    per boundary scan.  Bytes: the packed scene and chunk rows and the
    material ids read once, the pixel cotangent read, the image and the
    (14, N) cotangent written.  Returns (ops, bytes, ms, counters): the
    plain counters and, under "bound", the forward terms taken, and under
    "split" the cooperative form's two kernels' own bounds: the
    tape-writing forward (the forward terms; bytes: the scene read, the
    image and the tape's used part written) and the sweep (the adjoint's
    terms; bytes: the tape's used part read, the scene and cotangent as
    above).  The tape's used part: `records` (the bounces this run's
    samples took, the sum of the tape's depth array), each a 64-byte
    record and light_words(n_lights) words of seen lights, and the depth
    array; the rest of the tape is allocated and never touched."""
    from toypathtracer_torch.ops import cuda_scaled
    from toypathtracer_torch.ops import tracecore as tc
    from toypathtracer_torch.ops.cuda_render import pack_scene
    from toypathtracer_torch.render.wavefront import camera_scalars
    from toypathtracer_torch.scaled import pack_chunks
    dev = scene.device
    H, W = cfg.height, cfg.width
    tab = pack_scene(scene).requires_grad_(eps > 0.0)
    rows = pack_chunks(scene)
    trav = ChunkCount(rows, scene.chunk, tab)
    yy, xx = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    with torch.no_grad():
        _, work = tc.render_pixels(
            tab, scene.mat_ids().to(torch.int64), scene.emissive_ids, cfg,
            camera_scalars(scene, cfg), xx.reshape(-1), yy.reshape(-1), 0,
            traversal=trav, soft_eps=eps)
    w = {k: int(getattr(work, k).sum()) for k in work._fields}
    w.update(hit_roots=trav.hit_roots, misses=trav.misses,
             boundary_scans=trav.scans)
    _, _, st = cuda_scaled.render_tile_scaled_form(
        scene, cfg.replace(soft_silhouette_eps=0.0), 0, 0, 0, H, W, "coop",
        stats=True)
    terms = {"slab_tests": min(w["slab_tests"], st["hit"]["slabs"]
                               + st["shadow"]["slabs"]),
             "hit_tests": min(w["hit_tests"], st["hit"]["need"]),
             "occlusion_tests": min(w["occlusion_tests"],
                                    st["shadow"]["need"])}
    w["bound"] = terms
    fwd = (12 * terms["slab_tests"] + 16 * terms["hit_tests"]
           + 3 * w["hit_roots"] + 19 * w["shadow"]
           + 20 * terms["occlusion_tests"])
    adj = 150 * w["traced"] + 270 * w["shadow"]
    if eps > 0.0:
        adj += (16 * (w["silhouette_tests"] + w["proximity_tests"])
                + 40 * w["traced"] + (40 + 30 * n_lights) * w["misses"]
                + 40 * w["boundary_scans"])
    ops = fwd + adj
    scene_bytes = 4 * (tab.numel() + rows.numel() + scene.n_spheres)
    n_bytes = scene_bytes + 4 * (2 * 3 * H * W + tab.numel())
    words = -(-n_lights // 32)
    used = records * (64 + 4 * words) + 4 * H * W * cfg.samples_per_pixel
    w.update(tape_records=records, tape_used_bytes=used,
             tape_allocated_bytes=cuda_scaled.tape_bytes(scene, cfg, H, W))
    split = {}
    for name, o, b in (("tape", fwd, scene_bytes + 4 * 3 * H * W + used),
                       ("sweep", adj, scene_bytes + used
                        + 4 * (3 * H * W + tab.numel()))):
        split[name] = {"fp32_ops": o, "bytes": b,
                       "ms": max(o / 67e12, b / 3.35e12) * 1e3,
                       "by": "operations" if o / 67e12 >= b / 3.35e12
                       else "bytes"}
    w["split"] = split
    return ops, n_bytes, max(ops / 67e12, n_bytes / 3.35e12) * 1e3, w


# The first rows of the 8-row bands on which the full-size gradients (1280x720)
# are held against plain autograd: the top, the middle, the bottom.
GRAD_BANDS = (0, 356, 712)


def pool_phases(cfg, smi, usage):
    """Phase 14: the gradient kernel's pool instance (K3 with a table per
    warp in device memory, any number of spheres) -- bit-equal to the
    warp form on its grid at 46 and 130 spheres, hard and soft; against
    plain autograd at 600 spheres (tools/scenes.crowded_scene(extra=554))
    at 320x176, spp 2, depth 4, hard and soft; its main path, Adam steps
    of InverseRenderer on the 600-sphere scene at 1280x720 (one render and
    one pool launch a step); at that size, spp 4, depth 10, hard and soft,
    three 8-row bands against plain autograd and the full frame's launch
    bit-equal to itself, also where a first pool too small makes it run
    again; timing with CUDA events, the pool instance in turns with the
    warp form at 46 spheres.  Returns its entry of the `kernels` line."""
    import numpy as np

    from toypathtracer_torch import make_scene
    from toypathtracer_torch.inverse import InverseRenderer
    from toypathtracer_torch.ops import cuda_grad, cuda_render
    from toypathtracer_torch.ops import tracecore as tc
    from toypathtracer_torch.profiling import time_device_call
    from toypathtracer_torch.render.wavefront import (camera_scalars,
                                                      render_tile_grad_plain)
    from toypathtracer_torch.tools import grad_stats
    from toypathtracer_torch.tools.scenes import (crowded_scene,
                                                  many_lights_scene)

    dev = torch.device("cuda")
    t1 = time.perf_counter()
    small = cfg.replace(width=320, height=176, samples_per_pixel=2,
                        max_depth=4)
    g = grad_stats.cotangent(176, 320, 0, dev)
    equal = {}
    for name, sc in (("big", make_scene(big=True)),
                     ("crowded", crowded_scene())):
        sc = sc.to(dev)
        for e in (0.0, 0.05):
            c = small.replace(soft_silhouette_eps=e)
            args = (sc, c, 0, g, 0, 0, 176, 320)
            rows, _ = cuda_grad.grad_scratch(*args[:3], 0, 0, 176, 320,
                                             "warp")
            a = cuda_grad.render_tile_grad_form(*args, "warp")
            b = cuda_grad.render_tile_grad_form(*args, "pool", blocks=rows)
            torch.cuda.synchronize()
            equal[f"{name}_{'soft' if e else 'hard'}"] = bool(
                torch.equal(a[0], b[0]) and int(a[1]) == int(b[1])
                and torch.equal(a[2], b[2]))
    emit({"phase": "grad_pool_vs_warp", "size": "320x176, spp 2, depth 4",
          "bit_equal_on_the_warp_grid": equal,
          "seconds": time.perf_counter() - t1})
    check(all(equal.values()), f"K3 pool != warp form: {equal}")

    t1 = time.perf_counter()
    crowd = crowded_scene(extra=554).to(dev)
    vs = {}
    for e in (0.0, 0.05):
        c = small.replace(soft_silhouette_eps=e)
        args = (crowd, c, 0, g, 0, 0, 176, 320)
        before = dict(cuda_grad.launches)
        img_k, rays_k, d_k = cuda_grad.render_tile_grad(*args)
        _, _, d_k2 = cuda_grad.render_tile_grad(*args)
        torch.cuda.synchronize()
        counted = {k: cuda_grad.launches[k] - before[k] for k in before
                   if cuda_grad.launches[k] != before[k]}
        pool = dict(cuda_grad.last_pool)
        plain_s, (img_p, rays_p, d_p) = time_device_call(
            render_tile_grad_plain, *args)
        ms, _ = time_device_call(cuda_grad.render_tile_grad, *args,
                                 repeats=3)
        rel = row_rel(d_k, d_p)
        key = "soft" if e else "hard"
        vs[key] = {"rays_kernel": int(rays_k), "rays_plain": int(rays_p),
                   "d_packed_row_rel_max": max(rel),
                   "max_abs": float((d_k - d_p).abs().max()),
                   "img_max_abs_diff": float((img_k - img_p).abs().max()),
                   "deterministic": bool(torch.equal(d_k, d_k2)),
                   "finite": bool(torch.isfinite(d_k).all()),
                   "launches": counted, "pool": pool, "ms": ms * 1e3,
                   "plain_ms": plain_s * 1e3}
        what = f"K3 pool 600 spheres {key}"
        check(counted == {"grad_pool" + ("_soft" if e else ""): 2},
              f"{what}: launches {counted}")
        check(vs[key]["finite"] and vs[key]["deterministic"],
              f"{what}: finite, deterministic")
        check(int(rays_k) == int(rays_p), f"{what}: rays")
        check(max(rel) <= 1e-3, f"{what}: d_packed vs plain autograd")
    # bound at 320x176, 600 spheres: K1's count (every sphere for each
    # camera/bounce ray, roots where the discriminant is positive, the
    # light's root and the occlusion loop for each shadow ray) plus K3's
    # adjoint (~150 per traced ray, ~270 per shadow ray)
    tab = cuda_render.pack_scene(crowd)
    roots = RootCount(tab)
    yy, xx = torch.meshgrid(torch.arange(176, device=dev),
                            torch.arange(320, device=dev), indexing="ij")
    with torch.no_grad():
        _, work = tc.render_pixels(
            tab, torch.tensor(crowd.mat_type, dtype=torch.int64, device=dev),
            crowd.emissive_ids, small, camera_scalars(crowd, small),
            xx.reshape(-1), yy.reshape(-1), 0, traversal=roots)
    traced, shadow, occ = (int(x.sum()) for x in (
        work.traced, work.shadow, work.occlusion_tests))
    ops = (16 * crowd.n_spheres * traced + 3 * roots.hit_roots
           + 16 * shadow + 3 * roots.light_roots + 20 * occ
           + 150 * traced + 270 * shadow)
    n_bytes = 4 * (tab.numel() + crowd.n_spheres + 2 * 3 * 176 * 320
                   + tab.numel())
    bound = max(ops / 67e12, n_bytes / 3.35e12) * 1e3
    emit({"phase": "grad_pool_vs_plain", "nvidia_smi": smi,
          "spheres": crowd.n_spheres, "size": "320x176, spp 2, depth 4",
          **vs, "bound_fp32_ops": ops, "bound_ms": bound,
          "ptxas": {k: usage.get(k, {}) for k in (
              "pool_grad_kernel<0>", "pool_grad_kernel<1>", "sum_pool")},
          "seconds": time.perf_counter() - t1})

    # 40 lights (tools/scenes.many_lights_scene: past the 16 bits of a
    # carry record and past a word of 32): the warp form's instance that
    # keeps the seen lights in words of their own and the pool form,
    # against plain autograd and bit-equal to each other on the warp
    # form's grid
    t1 = time.perf_counter()
    lit = many_lights_scene().to(dev)
    lights40 = {}
    for e in (0.0, 0.05):
        c = small.replace(soft_silhouette_eps=e)
        args = (lit, c, 0, g, 0, 0, 176, 320)
        rows, _ = cuda_grad.grad_scratch(*args[:3], 0, 0, 176, 320, "warp")
        before = dict(cuda_grad.launches)
        a = cuda_grad.render_tile_grad_form(*args, "warp")
        b = cuda_grad.render_tile_grad_form(*args, "pool", blocks=rows)
        img_p, rays_p, d_p = render_tile_grad_plain(*args)
        torch.cuda.synchronize()
        key = "soft" if e else "hard"
        lights40[key] = {
            "lights": len(lit.emissive_ids), "rays_kernel": int(a[1]),
            "rays_plain": int(rays_p), "row_rel_max": max(row_rel(a[2], d_p)),
            "pool_row_rel_max": max(row_rel(b[2], d_p)),
            "warp_pool_bit_equal": bool(torch.equal(a[0], b[0])
                                        and torch.equal(a[2], b[2])),
            "launches": {k: cuda_grad.launches[k] - before[k] for k in before
                         if cuda_grad.launches[k] != before[k]}}
        r = lights40[key]
        check(r["rays_kernel"] == r["rays_plain"] and r["row_rel_max"] <= 1e-3
              and r["pool_row_rel_max"] <= 1e-3 and r["warp_pool_bit_equal"],
              f"K3 at 40 lights {key}: {r}")
    emit({"phase": "grad_40_lights_vs_plain", "size": "320x176, spp 2, "
          "depth 4", **lights40,
          "ptxas": {k: usage.get(k, {}) for k in (
              "lights_warp_grad_kernel<0>", "lights_warp_grad_kernel<1>")},
          "seconds": time.perf_counter() - t1})

    # the main path: Adam steps on the 600-sphere scene at full size
    t1 = time.perf_counter()
    target, _ = cuda_render.render_frame(crowd, cfg, 0)
    rng = np.random.default_rng(7)
    a_jit = rng.normal(0, 0.15, crowd.albedo.shape).astype(np.float32)
    a_jit[list(crowd.emissive_ids)] = 0.0
    start = crowd.replace(albedo=torch.clamp(
        crowd.albedo + torch.from_numpy(a_jit).to(dev), 0.02, 0.98))
    for k in cuda_render.launches:
        cuda_render.launches[k] = 0
    for k in cuda_grad.launches:
        cuda_grad.launches[k] = 0
    inv = InverseRenderer(cfg, target, trainable=("albedo",),
                          learning_rate=2e-2)
    steps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, losses = inv.fit(start, steps=steps, resample=False)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    launched = {k: v for k, v in {**cuda_render.launches,
                                  **cuda_grad.launches}.items() if v}
    pool_full = dict(cuda_grad.last_pool)
    w = grad_stats.cotangent(cfg.height, cfg.width, 11, dev)
    full_ms, _ = time_device_call(cuda_grad.render_tile_grad, crowd, cfg, 0,
                                  w, 0, 0, cfg.height, cfg.width)
    # the pool instance and the warp form in turns on the 46-sphere frame:
    # warp, pool, pool, warp
    scene_d = make_scene(big=True).to(dev)
    runs = {}
    for form in ("warp", "pool", "pool", "warp"):
        runs.setdefault(form, []).append(time_device_call(
            cuda_grad.render_tile_grad_form, scene_d, cfg, 0, w, 0, 0,
            cfg.height, cfg.width, form, repeats=3)[0] * 1e3)
    turns = {f: sum(v) / len(v) for f, v in runs.items()}
    emit({"phase": "grad_pool_training_path", "nvidia_smi": smi,
          "spheres": crowd.n_spheres, "size": "1280x720, spp 4, depth 10",
          "losses": losses, "launches": launched, "step_ms": step_s * 1e3,
          "full_frame_ms": full_ms * 1e3, "pool_full_frame": pool_full,
          "turns_46_spheres_ms": turns, "turns_runs": runs,
          "seconds": time.perf_counter() - t1})
    check(launched == {"render": steps, "grad_pool": steps},
          f"600-sphere training path launched {launched}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"600-sphere Adam losses not decreasing: {losses}")

    # the main path's size against plain autograd: three 8-row bands of
    # the frame, and the full frame's launch twice and once with a first
    # pool of half the slots it draws (so it runs again)
    t1 = time.perf_counter()
    H, W = cfg.height, cfg.width
    full = {}
    for e in (0.0, 0.05):
        c = cfg.replace(soft_silhouette_eps=e)
        bands = {}
        for y0 in GRAD_BANDS:
            wb = w[y0:y0 + 8].contiguous()
            img_k, rays_k, d_k = cuda_grad.render_tile_grad(crowd, c, 0, wb,
                                                            0, y0, 8, W)
            plain_s, (img_p, rays_p, d_p) = time_device_call(
                render_tile_grad_plain, crowd, c, 0, wb, 0, y0, 8, W)
            rel = row_rel(d_k, d_p)
            bands[y0] = {"rays_kernel": int(rays_k), "rays_plain": int(rays_p),
                         "row_rel_max": max(rel),
                         "max_abs": float((d_k - d_p).abs().max()),
                         "img_max_abs_diff": float((img_k - img_p)
                                                   .abs().max()),
                         "plain_ms": plain_s * 1e3}
        mat, lights, cam = cuda_render.kernel_inputs(crowd, c)
        tab_c = cuda_render.pack_scene(crowd).contiguous()
        params = cuda_render.render_params(crowd, c, 0, 0, 0, H, W)
        first = cuda_grad.launch_pool(tab_c, mat, lights, cam, params, w,
                                      dev)
        room = dict(cuda_grad.last_pool)
        again = cuda_grad.launch_pool(tab_c, mat, lights, cam, params, w,
                                      dev)
        rerun = cuda_grad.launch_pool(tab_c, mat, lights, cam, params, w,
                                      dev, cap=room["slots"] // 2)
        torch.cuda.synchronize()
        key = "soft" if e else "hard"
        full[key] = {
            "bands": bands,
            "band_row_rel_max": max(b["row_rel_max"] for b in bands.values()),
            "full_frame_pool": room, "rerun_pool": dict(cuda_grad.last_pool),
            "full_frame_deterministic": all(
                torch.equal(a, b) for a, b in zip(first, again)),
            "rerun_bit_equal": all(torch.equal(a, b)
                                   for a, b in zip(first, rerun)),
            "finite": bool(torch.isfinite(first[2]).all())}
        what = f"K3 pool 600 spheres at 1280x720 {key}"
        check(all(b["rays_kernel"] == b["rays_plain"]
                  for b in bands.values()), f"{what}: band rays")
        check(full[key]["band_row_rel_max"] <= 1e-3,
              f"{what}: d_packed vs plain autograd on the bands")
        check(full[key]["finite"] and full[key]["full_frame_deterministic"],
              f"{what}: finite, deterministic")
        check(room["launches"] == 1 and full[key]["rerun_pool"]["launches"]
              in (2, 3) and full[key]["rerun_bit_equal"],
              f"{what}: a rerun launch != the launch that had room")
    emit({"phase": "grad_pool_full_size_vs_plain", "nvidia_smi": smi,
          "spheres": crowd.n_spheres, "size": "1280x720, spp 4, depth 10",
          "rows": list(GRAD_BANDS), **full,
          "seconds": time.perf_counter() - t1})
    return {"name": "grad_pool", "route": "cuda",
            "source": "toypathtracer_torch/csrc/grad.cu",
            "replaces": "toypathtracer_tpu/ops/pallas_grad.py:127",
            "launches": launched["grad_pool"],
            "max_abs_err": vs["hard"]["max_abs"],
            "ms": vs["hard"]["ms"], "plain_ms": vs["hard"]["plain_ms"],
            "bound_ms": bound,
            "bound_by": "operations" if ops / 67e12 >= n_bytes / 3.35e12
            else "bytes", "library_ms": None,
            "form": "pool (pool_grad_kernel<0>: gradwarp.cuh grad_tiles "
                    "with a PoolTable a warp; soft instance "
                    "pool_grad_kernel<1> where eps > 0)",
            "workload": "600 spheres (crowded_scene(extra=554)), 320x176, "
                        "spp 2, depth 4; launches: 3 Adam steps at "
                        "1280x720",
            "soft_ms": vs["soft"]["ms"], "full_frame_ms": full_ms * 1e3,
            "turns_46_spheres_ms": turns,
            "ptxas": usage.get("pool_grad_kernel<0>", {}),
            "ptxas_soft": usage.get("pool_grad_kernel<1>", {}),
            "vs_plain": {"tolerance": "d_packed per row <= 1e-3 x row max "
                                      "against plain autograd (at 320x176 "
                                      "and on three 8-row bands at "
                                      "1280x720), rays exact, "
                                      "bit-equal launch to launch and "
                                      "where the pool reruns; "
                                      "bit-equal to the warp form on its "
                                      "grid at 46 and 130 spheres",
                         "row_rel_max": {k: v["d_packed_row_rel_max"]
                                         for k, v in vs.items()},
                         "full_size_band_row_rel_max": {
                             k: v["band_row_rel_max"]
                             for k, v in full.items()},
                         "lights_40": lights40,
                         "bit_equal_to_warp_form": equal}}


def scaled_grad_phases(cfg, smi, usage):
    """Phases 15-17: the scaled scene's gradient (scaled.py:712
    render_frame_scaled(differentiable=True)) on the 100k-sphere scene at
    1280x720, spp 4, depth 10, hard and with eps 0.05 -- its main path
    (K3's cooperative chunked form: one tape-writing render, whose tape
    autograd keeps, and one sweep launch), the cooperative form against
    the per-lane chunked instance (image, rays and cotangent bit for bit, the
    two timed in turns, the tape render and the sweep timed alone, the
    directory's and the tape's bytes, the baseline's cycle shares by
    part), against plain autograd on three 8-row bands, its image against
    the scaled render kernel's, rays against plain, two launches, finite
    differences on an albedo, the bounds; the reference's own
    configuration (tests/test_scaled.py:129: 2000 spheres, chunk 64,
    32x8, spp 1, depth 3, hard and eps 1.0) and with 40 lights; the
    geometry recovery of tests/test_scaled.py:305 through the soft
    instance.  Returns the entries of the `kernels` line."""
    import numpy as np

    from toypathtracer_torch import make_scaled_scene
    from toypathtracer_torch.ops import cuda_grad, cuda_render, cuda_scaled
    from toypathtracer_torch.profiling import time_device_call
    from toypathtracer_torch.scaled import (refresh_chunk_aabb,
                                            render_tile_scaled_grad_plain,
                                            render_tile_scaled_plain)
    from toypathtracer_torch.tools import grad_stats

    fields = ("center", "radius", "albedo", "emissive", "roughness", "ri")
    dev = torch.device("cuda")
    H, W = cfg.height, cfg.width
    sd = make_scaled_scene(100_000).to(dev)
    w = grad_stats.cotangent(H, W, 11, dev)
    eps_soft = 0.05
    cases = {"hard": 0.0, "soft": eps_soft}
    counters = (cuda_render.launches, cuda_grad.launches,
                cuda_scaled.launches)

    def zero_counts():
        for counter in counters:
            for k in counter:
                counter[k] = 0

    def counted():
        return {k: v for c in counters for k, v in c.items() if v}

    # ---- 15. the main path: render_frame_scaled(differentiable=True) ----
    t1 = time.perf_counter()
    zero_counts()
    route = {}
    held = {}
    for name, e in cases.items():
        leaves = {f: getattr(sd, f).clone().requires_grad_(True)
                  for f in fields}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        img, rays = cuda_scaled.render_frame_scaled(
            sd.replace(**leaves), cfg.replace(soft_silhouette_eps=e), 0,
            differentiable=True)
        torch.cuda.synchronize()
        # what the forward leaves allocated for the backward: the tape
        held[name] = torch.cuda.memory_allocated(dev) - base
        (img * w).sum().backward()
        route[name] = (img.detach(), int(rays),
                       {f: t.grad for f, t in leaves.items()})
    torch.cuda.synchronize()
    path = counted()
    tape_bytes = cuda_scaled.tape_bytes(sd, cfg, H, W)
    emit({"phase": "scaled_grad_path", "launches": path,
          "tape_bytes": tape_bytes, "held_across_autograd_bytes": held,
          "finite": {n: all(bool(torch.isfinite(t).all())
                            for t in r[2].values())
                     for n, r in route.items()},
          "seconds": time.perf_counter() - t1})
    check(path == {"scaled_tape": 2, "scaled_grad": 1,
                   "scaled_grad_soft": 1},
          f"the scaled gradient's path launched {path}")
    check(all(h >= tape_bytes for h in held.values()),
          f"the forward did not keep its tape: {held} < {tape_bytes}")

    # ---- step 1: the per-lane chunked instance's cycles by part -------
    t1 = time.perf_counter()
    shares = {name: grad_stats.chunk_stats(
        sd, cfg.replace(soft_silhouette_eps=e), w)
        for name, e in cases.items()}
    emit({"phase": "scaled_grad_cycle_shares", "nvidia_smi": smi,
          "form": "the per-lane chunk_grad_kernel (chunk_grad_stats_kernel)",
          **{n: {k: v[k] for k in ("cycle_shares", "counters",
                                   "adjoint_bounces_per_sample",
                                   "reverse_lane_busy")}
             for n, v in shares.items()},
          "seconds": time.perf_counter() - t1})

    # ---- 16. the cooperative chunked K3 at full size --------------------
    t1 = time.perf_counter()
    img_r, rays_r = cuda_scaled.render_tile_scaled(sd, cfg, 0, 0, 0, H, W)
    _, rays_p = render_tile_scaled_plain(sd, cfg, 0, 0, 0, H, W)
    out = {}
    for name, e in cases.items():
        c = cfg.replace(soft_silhouette_eps=e)
        img, rays, d = cuda_scaled.render_tile_scaled_grad(sd, c, 0, w, 0, 0,
                                                           H, W)
        pool = dict(cuda_grad.last_pool)
        _, _, d2 = cuda_scaled.render_tile_scaled_grad(sd, c, 0, w, 0, 0, H,
                                                       W)
        img_b, rays_b, d_b = cuda_scaled.render_tile_scaled_grad_form(
            sd, c, 0, w, 0, 0, H, W, "chunk")
        pool_b = dict(cuda_grad.last_pool)
        torch.cuda.synchronize()
        baseline_equal = bool(torch.equal(img, img_b) and int(rays) ==
                              int(rays_b) and torch.equal(d, d_b))
        bands = {}
        for y0 in GRAD_BANDS:
            wb = w[y0:y0 + 8].contiguous()
            plain_s, (img_p, rays_b8, d_p) = time_device_call(
                render_tile_scaled_grad_plain, sd, c, 0, wb, 0, y0, 8, W)
            band_s, (img_k, rays_k, d_k) = time_device_call(
                cuda_scaled.render_tile_scaled_grad, sd, c, 0, wb, 0, y0, 8,
                W)
            rel = row_rel(d_k, d_p)
            bands[y0] = {"rays_kernel": int(rays_k),
                         "rays_plain": int(rays_b8),
                         "row_rel_max": max(rel), "row_rel": rel,
                         "max_abs": float((d_k - d_p).abs().max()),
                         "img_max_abs_diff": float((img_k - img_p)
                                                   .abs().max()),
                         "plain_ms": plain_s * 1e3, "ms": band_s * 1e3}
        # the route's gradient is the kernel's: pack_scene carries d to the
        # fields (albedo rows as they are)
        route_albedo = bool(torch.equal(route[name][2]["albedo"].t(), d[6:9]))
        # finite differences of L = sum(img * w) on the albedo entry with
        # the largest gradient (albedo moves no path), the scaled render
        # kernel's images, float64 sums, h 1e-2
        alb = d[6:9]
        c_i, i = np.unravel_index(int(alb.abs().argmax()), tuple(alb.shape))
        h, vals = 1e-2, []
        for sign in (1.0, -1.0):
            a = sd.albedo.clone()
            a[i, c_i] += sign * h
            im, _ = cuda_scaled.render_tile_scaled(sd.replace(albedo=a), c, 0,
                                                   0, 0, H, W)
            vals.append(float((im.double() * w.double()).sum()))
        fd = (vals[0] - vals[1]) / (2 * h)
        ad = float(alb[c_i, i])
        # the two forms in turns (coop, chunk, chunk, coop), then the
        # cooperative form's two kernels alone
        runs = {"coop": [], "chunk": []}
        for f in ("coop", "chunk", "chunk", "coop"):
            runs[f].append(time_device_call(
                cuda_scaled.render_tile_scaled_grad_form, sd, c, 0, w, 0, 0,
                H, W, f, repeats=2)[0] * 1e3)
        tape_s, (_, _, tape) = time_device_call(
            cuda_scaled.render_tile_scaled_tape, sd, c, 0, 0, 0, H, W,
            repeats=2)
        sweep_s, _ = time_device_call(cuda_scaled.sweep_scaled_tape, sd, c, w,
                                      tape, repeats=2)
        records = int(tape["depth"].sum())
        del tape
        ops, n_bytes, bound, work = chunked_grad_bound(
            sd, c, e, len(sd.emissive_ids), records)
        out[name] = {
            "soft_eps": e, "rays_kernel": int(rays), "rays_plain": int(rays_p),
            "image_bit_equal_to_scaled_render": bool(torch.equal(img, img_r)),
            "image_max_abs_diff_to_scaled_render": float(
                (img - img_r).abs().max()),
            "rays_equal_to_scaled_render": int(rays) == int(rays_r),
            "bit_equal_to_chunk_grad_kernel": baseline_equal,
            "deterministic": bool(torch.equal(d, d2)),
            "finite": bool(torch.isfinite(d).all()),
            "route_gradient_is_the_kernels": route_albedo,
            "route_image_bit_equal": bool(torch.equal(route[name][0], img)),
            "bands": bands,
            "band_row_rel_max": max(b["row_rel_max"] for b in bands.values()),
            "band_plain_ms": sum(b["plain_ms"] for b in bands.values()),
            "band_ms": sum(b["ms"] for b in bands.values()),
            "fd": {"sphere": int(i), "channel": int(c_i), "h": h, "fd": fd,
                   "ad": ad, "rel": abs(ad - fd) / abs(fd)},
            "pool": pool, "pool_baseline": pool_b, "tape_bytes": tape_bytes,
            "ms": sum(runs["coop"]) / 2, "baseline_ms": sum(runs["chunk"]) / 2,
            "runs": runs, "tape_ms": tape_s * 1e3, "sweep_ms": sweep_s * 1e3,
            "bound_fp32_ops": ops, "bound_bytes": n_bytes, "bound_ms": bound,
            "work": work}
        emit({"phase": "scaled_grad_vs_plain", "nvidia_smi": smi,
              "size": "1280x720, spp 4, depth 10, 100,096 spheres",
              **out[name], "seconds": time.perf_counter() - t1})
        r, what = out[name], f"chunked K3 {name}"
        check(r["finite"] and r["deterministic"],
              f"{what}: finite, deterministic")
        check(r["image_bit_equal_to_scaled_render"]
              and r["rays_equal_to_scaled_render"],
              f"{what}: image != the scaled render kernel's")
        check(r["bit_equal_to_chunk_grad_kernel"],
              f"{what}: != the per-lane chunk_grad_kernel on its grid")
        check(r["rays_kernel"] == r["rays_plain"], f"{what}: rays vs plain")
        check(all(b["rays_kernel"] == b["rays_plain"]
                  for b in bands.values()), f"{what}: band rays")
        check(r["band_row_rel_max"] <= 1e-3,
              f"{what}: d_packed vs plain autograd on the bands")
        check(route_albedo and r["route_image_bit_equal"],
              f"{what}: the differentiable route is not the kernel's")
        check(r["fd"]["rel"] <= 1e-2, f"{what}: albedo AD vs FD {r['fd']}")
        check(pool["dir_bytes"] <= 420e6,
              f"{what}: the pool directory takes {pool['dir_bytes']} bytes")

    # ---- 17. the reference's configuration and its recovery loop --------
    t1 = time.perf_counter()
    ref = make_scaled_scene(n=2000, chunk=64, extent=40.0).to(dev)
    small = cfg.replace(width=32, height=8, samples_per_pixel=1, max_depth=3)
    g8 = grad_stats.cotangent(8, 32, 0, dev)
    ref_vs = {}
    lit = ref.replace(emissive_ids=tuple(range(40)))
    for name, sc, e in (("hard", ref, 0.0), ("soft", ref, 1.0),
                        ("lights40_hard", lit, 0.0),
                        ("lights40_soft", lit, 0.05)):
        c = small.replace(soft_silhouette_eps=e)
        img_k, rays_k, d_k = cuda_scaled.render_tile_scaled_grad(
            sc, c, 0, g8, 0, 0, 8, 32)
        img_p, rays_q, d_p = render_tile_scaled_grad_plain(sc, c, 0, g8, 0,
                                                           0, 8, 32)
        img_r8, _ = cuda_scaled.render_tile_scaled(sc, c, 0, 0, 0, 8, 32)
        torch.cuda.synchronize()
        ref_vs[name] = {"rays_kernel": int(rays_k), "rays_plain": int(rays_q),
                        "lights": len(sc.emissive_ids), "soft_eps": e,
                        "row_rel_max": max(row_rel(d_k, d_p)),
                        "image_bit_equal_to_scaled_render": bool(
                            torch.equal(img_k, img_r8))}
        if name.startswith("lights40"):
            _, _, d_b = cuda_scaled.render_tile_scaled_grad(
                ref, c, 0, g8, 0, 0, 8, 32)
            ref_vs[name]["differs_from_8_lights"] = not bool(
                torch.equal(d_b, d_k))
        check(ref_vs[name]["rays_kernel"] == ref_vs[name]["rays_plain"]
              and ref_vs[name]["row_rel_max"] <= 1e-3
              and ref_vs[name]["image_bit_equal_to_scaled_render"]
              and ref_vs[name].get("differs_from_8_lights", True),
              f"reference configuration {name}: {ref_vs[name]}")
    # tests/test_scaled.py:305: one sphere moved against the sky, its
    # centre recovered through the soft instance (eps 1.0, 96x24, depth 2,
    # Adam 3e-2, 60 steps)
    sid = len(ref.emissive_ids)
    center, radius = ref.center.clone(), ref.radius.clone()
    center[sid] = torch.tensor([0.0, 10.0, 5.0], device=dev)
    radius[sid] = 3.0
    scene = refresh_chunk_aabb(ref.replace(center=center, radius=radius))
    rc = cfg.replace(width=96, height=24, samples_per_pixel=1, max_depth=2,
                     soft_silhouette_eps=1.0)
    target, _ = cuda_scaled.render_frame_scaled(scene, rc, 0)
    true_c = scene.center[sid].clone()
    delta0 = torch.tensor([0.4, 0.2, 0.3], device=dev)
    p = (true_c + delta0).requires_grad_(True)
    opt = torch.optim.Adam([p], lr=3e-2)
    zero_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(60):
        cen = scene.center.clone()
        cen[sid] = p
        img, _ = cuda_scaled.render_frame_scaled(
            refresh_chunk_aabb(scene.replace(center=cen)), rc, 0,
            differentiable=True)
        loss = ((img - target) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    step_s = (time.perf_counter() - t0) / 60
    fit = counted()
    err0 = float(delta0.norm())
    err = float((p.detach() - true_c).norm())
    emit({"phase": "scaled_grad_reference", "reference_configuration":
          ref_vs, "recovery": {"err0": err0, "err": err,
                               "loss_first": losses[0],
                               "loss_last": losses[-1], "launches": fit,
                               "step_ms": step_s * 1e3},
          "seconds": time.perf_counter() - t1})
    check(fit == {"scaled_tape": 60, "scaled_grad_soft": 60},
          f"recovery loop launched {fit}")
    check(err < 0.4 * err0, f"recovery: err {err} vs {err0}")
    check(losses[-1] < 0.2 * losses[0],
          f"recovery: loss {losses[0]} -> {losses[-1]}")

    tol = ("d_packed per row <= 1e-3 x row max against plain autograd on "
           "three 8-row bands and at the reference configuration (also "
           "with 40 lights); rays equal to plain; image bit-equal to the "
           "scaled render kernel's; d_packed bit-equal to the per-lane "
           "chunk_grad_kernel on its grid; bit-equal launch to launch; "
           "albedo AD vs FD <= 1e-2")
    entries = []
    for name in cases:
        r = out[name]
        soft = name == "soft"
        sweep = r["work"]["split"]["sweep"]
        common = {"route": "cuda",
                  "replaces": "toypathtracer_tpu/ops/pallas_grad.py:127",
                  "max_abs_err": max(b["max_abs"]
                                     for b in r["bands"].values()),
                  "plain_ms": r["band_plain_ms"], "library_ms": None,
                  "soft_eps": r["soft_eps"]}
        entries.append({
            "name": "scaled_grad_sweep" + ("_soft" if soft else ""),
            "source": "toypathtracer_torch/csrc/chunkgrad.cu", **common,
            "launches": path["scaled_grad" + ("_soft" if soft else "")],
            "ms": r["sweep_ms"], "bound_ms": sweep["ms"],
            "bound_by": sweep["by"],
            "form": "the cooperative chunked form's sweep "
                    "(chunk_sweep_kernel<%d>: coopgrad.cuh sweep_tiles over "
                    "the frame tape, a PoolTable a warp%s), with sum_pool"
                    % (soft, "; the soft scans as warp walks" if soft
                       else ""),
            "form_ms": r["ms"], "baseline_ms": r["baseline_ms"],
            "baseline": "the per-lane chunk_grad_kernel<%d> (forward and "
                        "sweep in one kernel), timed in turns with the "
                        "cooperative form's two kernels (form_ms)" % soft,
            "form_bound_ms": r["bound_ms"],
            "note": "ms: the sweep's wrapper alone (scratch, sweep, "
                    "sum_pool), bound_ms its own; form_ms: the tape render "
                    "and the sweep, form_bound_ms theirs; plain_ms: the "
                    "plain version on the three 8-row bands (rows %s)"
                    % ", ".join(map(str, GRAD_BANDS)),
            "bands_ms": r["band_ms"], "pool": r["pool"],
            "ptxas": usage.get(f"chunk_sweep_kernel<{int(soft)}>", {}),
            "vs_plain": {"tolerance": tol,
                         "band_row_rel_max": r["band_row_rel_max"],
                         "reference_row_rel_max": ref_vs[name]["row_rel_max"],
                         "bit_equal_to_chunk_grad_kernel":
                             r["bit_equal_to_chunk_grad_kernel"],
                         "fd": r["fd"]}})
        entries.append({
            "name": "scaled_grad_baseline" + ("_soft" if soft else ""),
            "source": "toypathtracer_torch/csrc/grad.cu", **common,
            "launches": path.get("scaled_grad_baseline"
                                 + ("_soft" if soft else ""), 0),
            "ms": r["baseline_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "operations" if r["bound_fp32_ops"] / 67e12
            >= r["bound_bytes"] / 3.35e12 else "bytes",
            "form": "the per-lane chunked instance (chunk_grad_kernel<%d>: "
                    "gradwarp.cuh grad_tiles over chunks.cuh "
                    "GradChunkedView), kept as the baseline; not on the "
                    "main path" % soft,
            "pool": r["pool_baseline"],
            "cycle_shares": shares[name]["cycle_shares"],
            "ptxas": usage.get(f"chunk_grad_kernel<{int(soft)}>", {}),
            "vs_plain": {"tolerance": "bit-equal to the cooperative form"}})
    r = out["hard"]
    tape_b = r["work"]["split"]["tape"]
    entries.append({
        "name": "scaled_grad_tape", "route": "cuda",
        "source": "toypathtracer_torch/csrc/scaled.cu",
        "replaces": "toypathtracer_tpu/ops/pallas_grad.py:127",
        "launches": path["scaled_tape"],
        "max_abs_err": max(v["image_max_abs_diff_to_scaled_render"]
                           for v in out.values()),
        "ms": r["tape_ms"],
        "plain_ms": r["band_plain_ms"], "bound_ms": tape_b["ms"],
        "bound_by": tape_b["by"], "library_ms": None,
        "form": "the cooperative chunked form's forward "
                "(tape_render_kernel: coop_render_kernel's merged loop with "
                "a TapeSink, coopgrad.cuh), the same for hard and soft",
        "soft_ms": out["soft"]["tape_ms"],
        "tape_bytes": tape_bytes,
        "note": "max_abs_err: against the scaled render kernel's image, "
                "which it equals bit for bit (the sweep's entries hold the "
                "gradient against plain); plain_ms: the plain gradient on "
                "the three 8-row bands",
        "ptxas": usage.get("tape_render_kernel<0>", {}),
        "ptxas_lights": usage.get("tape_render_kernel<1>", {}),
        "vs_plain": {"tolerance": "image and rays bit-equal to the scaled "
                                  "render kernel's (held against plain in "
                                  "its own entry); the tape's records "
                                  "trace_sample_tape's (g++ tests)",
                     "image_bit_equal": {n: v[
                         "image_bit_equal_to_scaled_render"]
                         for n, v in out.items()}}})
    return entries


def wavefront_phases(smi, usage):
    """Phase wavefront_grad: the differentiable wavefront
    (cfg.diff_wavefront) at the reference workload with the flag on
    (1280x720, spp 4, depth 10, 46 spheres): its main path, 4
    InverseRenderer Adam steps on the albedo with no diff_wavefront
    warning, one tape and one sweep launch a step and no K1 or K3, the
    loss falling; K1's tape instance bit-equal (image, rays) to K1, the
    main sweep's d_packed within 1e-4 x each row's max of the kept
    sweep's, the kept sweep's bit-equal to K3's warp form on its grid,
    both per row within 1e-3 x the row's max of autograd through the
    plain wavefront on three 8-row bands, the albedo gradient against
    central differences (the JAX test's gate, 5% + 1e-6); past 512 spheres
    (600, crowded_scene) the redesigned pool sweep within 1e-4 x each row's
    max of the kept pool sweep, which is bit-equal to K3's pool form on
    the full frame, the two in turns, and 2 Adam steps on it (its main
    path); 40 lights
    (many_lights_scene, 128x32, spp 2, depth 4) within 1e-3 x max of
    plain; 8 row bands through make_sharded_value_and_grad within rtol
    1e-4 (atol 1e-7) of one device, the JAX test's contract; timing with
    CUDA events: the tape forward, the main sweep in turns with the kept
    one (and their device time from a trace), both sweeps' cycles by part,
    the pair in turns with K1 + the warp K3, the training step on the
    host clock in
    turns with the lockstep step (the parent's route); the tape's bytes,
    allocated and used; bounds from the plain version's work counters and
    the tape's used bytes.  Returns the kernels' entries."""
    import warnings

    import numpy as np

    from toypathtracer_torch import RenderConfig, make_scene
    from toypathtracer_torch.inverse import (InverseRenderer,
                                             make_sharded_value_and_grad,
                                             render_loss)
    from toypathtracer_torch.ops import cuda_grad, cuda_render
    from toypathtracer_torch.ops import tracecore as tc
    from toypathtracer_torch.parallel.mesh import make_mesh
    from toypathtracer_torch.profiling import (time_device_call, trace_to,
                                               trace_summary, traced_kernel)
    from toypathtracer_torch.render.wavefront import (camera_scalars,
                                                      render_tile_grad_plain)
    from toypathtracer_torch.tools import grad_stats
    from toypathtracer_torch.tools.scenes import (crowded_scene,
                                                  many_lights_scene)

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = RenderConfig(width=1280, height=720, samples_per_pixel=4,
                       max_depth=10, merged_wavefront=True,
                       diff_wavefront=True)
    lock = cfg.replace(diff_wavefront=False)
    H, W = cfg.height, cfg.width
    scene = make_scene(big=True).to(dev)
    g = grad_stats.cotangent(H, W, 11, dev)
    run_label = cuda_grad.SWEEP_LABELS[cuda_grad.SWEEP_MAIN_FORM]

    def with_warnings(fn):
        """fn()'s value and the diff_wavefront warnings it raised."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
        return out, [str(w.message) for w in caught
                     if "diff_wavefront" in str(w.message)]

    # ---- the main path: Adam steps under the flag ------------------------
    target, _ = cuda_render.render_frame(scene, cfg, 0)
    rng = np.random.default_rng(7)
    a_jit = rng.normal(0, 0.15, scene.albedo.shape).astype(np.float32)
    a_jit[list(scene.emissive_ids)] = 0.0
    start = scene.replace(albedo=torch.clamp(
        scene.albedo + torch.from_numpy(a_jit).to(dev), 0.02, 0.98))

    def fit(c, steps, sc=start, tgt=target):
        return InverseRenderer(c, tgt, trainable=("albedo",),
                               learning_rate=2e-2).fit(sc, steps=steps,
                                                       resample=False)[1]
    zero_launches()
    losses, warned = with_warnings(lambda: fit(cfg, 4))
    torch.cuda.synchronize()
    main_launches = launched()
    emit({"phase": "wavefront_grad", "part": "training_path",
          "losses": losses,
          "launches": main_launches, "warnings": warned})
    check(not warned, f"the flat route warned: {warned}")
    check(main_launches == {"wave_tape": 4, "wave_sweep": 4},
          f"4 wavefront steps launched {main_launches}")
    check(losses[-1] < losses[0], f"wavefront losses did not fall: {losses}")

    # ---- the pair against K1 and K3 at full size -------------------------
    img_t, rays_t, tape = cuda_grad.render_tile_wave_tape(scene, cfg, 0, 0,
                                                          0, H, W)
    d_t = cuda_grad.sweep_wave_tape(scene, cfg, g, tape)
    d_t2 = cuda_grad.sweep_wave_tape(scene, cfg, g, tape)
    # the kept sweep (wave_sweep_kernel) on the same tape, and the
    # redesigned one on the kept sweep's deal and grid
    d_kept = cuda_grad.sweep_wave_tape(scene, cfg, g, tape, form="tiles")
    d_deal = cuda_grad.sweep_wave_tape(scene, cfg, g, tape,
                                       form="runs_on_tiles_deal")
    sweep_rel = max(row_rel(d_t, d_kept))
    img_k1, rays_k1 = cuda_render.render_tile(scene, cfg, 0, 0, 0, H, W)
    img_k3, rays_k3, d_k3 = cuda_grad.render_tile_grad_form(
        scene, lock, 0, g, 0, 0, H, W, "warp")
    torch.cuda.synchronize()
    depth = tape["depth"].long()
    traced = int(depth.sum())
    n_lights = len(scene.emissive_ids)
    words = -(-n_lights // 32)
    allocated = cuda_grad.tape_bytes(n_lights, cfg, H, W)
    used = traced * (64 + 4 * words) + 4 * depth.numel()
    # the scalar tape instance it replaced: the same words at every used
    # slot
    img_b, rays_b, tape_b = cuda_grad.render_tile_wave_tape(
        scene, cfg, 0, 0, 0, H, W, form="scalar")
    used_slots = (torch.arange(cfg.max_depth, device=dev)[None, :]
                  < depth[:, None]).reshape(-1)

    def used_words(t):
        return (t["rec"].view(torch.int32).reshape(-1, 16)[used_slots],
                t["see"].reshape(-1, words)[used_slots])
    (rec_s, see_s), (rec_b, see_b) = used_words(tape), used_words(tape_b)
    tapes_eq = {"rec": bool(torch.equal(rec_s, rec_b)),
                "see": bool(torch.equal(see_s, see_b)),
                "depth": bool(torch.equal(tape["depth"], tape_b["depth"]))}
    del tape, tape_b, rec_s, see_s, rec_b, see_b, used_slots
    eq = {"tape_image_bit_equal_to_k1": bool(torch.equal(img_t, img_k1)),
          "tape_rays_equal_to_k1": int(rays_t) == int(rays_k1),
          "staged_tape_equal_to_scalar": all(tapes_eq.values()),
          "scalar_image_bit_equal_to_k1": bool(torch.equal(img_b, img_k1)),
          "scalar_rays_equal_to_k1": int(rays_b) == int(rays_k1),
          "kept_sweep_bit_equal_to_warp_k3": bool(torch.equal(d_kept,
                                                              d_k3)),
          "runs_on_kept_deal_bit_equal_to_kept": bool(torch.equal(d_deal,
                                                                  d_kept)),
          "sweep_within_1e-4_of_kept": sweep_rel <= 1e-4,
          "k3_image_bit_equal": bool(torch.equal(img_k3, img_t)),
          "sweep_deterministic": bool(torch.equal(d_t, d_t2))}
    del d_deal
    emit({"phase": "wavefront_grad", "part": "pair",
          "rays": int(rays_t), "sweep_row_rel_vs_kept": sweep_rel,
          "traced_rays": traced, "tape_bytes_allocated": allocated,
          "tape_bytes_used": used, "staged_vs_scalar_words": tapes_eq,
          **eq})
    check(all(eq.values()), f"the wavefront pair: {eq}")

    # ---- against plain autograd on three 8-row bands ---------------------
    bands = (0, 356, 712)
    plain_bands_s = 0.0
    rel, err, rel_kept, err_kept = [], 0.0, [], 0.0
    for y0 in bands:
        gb = g[y0:y0 + 8].contiguous()
        _, r_k, d_b = cuda_grad.render_tile_grad(scene, cfg, 0, gb, 0, y0, 8,
                                                 W)
        _, _, tb = cuda_grad.render_tile_wave_tape(scene, cfg, 0, 0, y0, 8, W)
        d_bk = cuda_grad.sweep_wave_tape(scene, cfg, gb, tb, form="tiles")
        torch.cuda.synchronize()
        plain_t0 = time.perf_counter()
        _, r_p, d_p = render_tile_grad_plain(scene, cfg, 0, gb, 0, y0, 8, W)
        torch.cuda.synchronize()
        plain_bands_s += time.perf_counter() - plain_t0
        check(int(r_k) == int(r_p), f"band {y0}: rays")
        rel.append(max(row_rel(d_b, d_p)))
        err = max(err, float((d_b - d_p).abs().max()))
        rel_kept.append(max(row_rel(d_bk, d_p)))
        err_kept = max(err_kept, float((d_bk - d_p).abs().max()))

    # ---- finite differences on albedo[2, 0] -----------------------------
    n_px = float(H * W * 3)
    _, _, d_mean = cuda_grad.render_tile_grad(
        scene, cfg, 0, torch.full((H, W, 3), 1.0 / n_px, device=dev), 0, 0,
        H, W)
    tab = cuda_render.pack_scene(scene)
    vals = []
    for sign in (1.0, -1.0):
        t = tab.clone()
        t[6, 2] += sign * 1e-3
        im, _ = cuda_render.render_tile(scene, cfg, 0, 0, 0, H, W, tab=t)
        vals.append(float(im.double().mean()))
    g_fd = (vals[0] - vals[1]) / 2e-3
    g_ad = float(d_mean[6, 2])
    fd_ok = g_ad != 0.0 and abs(g_ad - g_fd) <= 0.05 * abs(g_fd) + 1e-6
    emit({"phase": "wavefront_grad", "part": "vs_plain",
          "bands": bands,
          "row_rel_max": rel, "max_abs": err, "plain_bands_s": plain_bands_s,
          "kept_sweep_row_rel_max": rel_kept, "kept_sweep_max_abs": err_kept,
          "albedo_2_0": {"ad": g_ad, "fd": g_fd, "ok": fd_ok}})
    check(max(rel) <= 1e-3 and max(rel_kept) <= 1e-3,
          f"wavefront bands vs plain: {rel}, the kept sweep's {rel_kept}")
    check(fd_ok, f"wavefront albedo AD {g_ad} vs FD {g_fd}")

    # ---- past 512 spheres: the pool sweep --------------------------------
    crowd = crowded_scene(extra=554).to(dev)
    img_c, rays_c, tape_c = cuda_grad.render_tile_wave_tape(crowd, cfg, 0, 0,
                                                            0, H, W)
    d_c = cuda_grad.sweep_wave_tape(crowd, cfg, g, tape_c)
    crowd_pool = dict(cuda_grad.last_pool)
    d_c2 = cuda_grad.sweep_wave_tape(crowd, cfg, g, tape_c)
    d_ck = cuda_grad.sweep_wave_tape(crowd, cfg, g, tape_c, form="tiles")
    kept_pool = dict(cuda_grad.last_pool)
    img_cp, rays_cp, d_cp = cuda_grad.render_tile_grad_form(
        crowd, lock, 0, g, 0, 0, H, W, "pool")
    # the redesigned pool sweep in turns with the kept one
    pool_runs = {"runs": [], "tiles": []}
    for k in ("runs", "tiles", "tiles", "runs"):
        pool_runs[k].append(time_device_call(
            lambda: cuda_grad.sweep_wave_tape(crowd, cfg, g, tape_c, form=k),
            repeats=3)[0] * 1e3)
    pool_ms, kept_pool_ms = (sum(pool_runs[k]) / 2 for k in ("runs", "tiles"))
    depth_c = tape_c["depth"].long()
    traced_c = int(depth_c.sum())
    used_c = traced_c * (64 + 4 * words) + 4 * depth_c.numel()
    adj_ops_c = 150 * traced_c + 270 * (int(rays_c) - traced_c)
    del tape_c
    # one 8-row band against plain autograd (the pool sweep on the band)
    gb = g[356:364].contiguous()
    _, _, d_cb = cuda_grad.render_tile_grad(crowd, cfg, 0, gb, 0, 356, 8, W)
    _, _, tb = cuda_grad.render_tile_wave_tape(crowd, cfg, 0, 0, 356, 8, W)
    d_cbk = cuda_grad.sweep_wave_tape(crowd, cfg, gb, tb, form="tiles")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, d_cbp = render_tile_grad_plain(crowd, cfg, 0, gb, 0, 356, 8, W)
    torch.cuda.synchronize()
    plain_c_ms = (time.perf_counter() - t0) * 1e3
    crowd_rel = max(row_rel(d_cb, d_cbp))
    crowd_err = float((d_cb - d_cbp).abs().max())
    crowd_rel_kept = max(row_rel(d_cbk, d_cbp))
    crowd_err_kept = float((d_cbk - d_cbp).abs().max())
    target_c, _ = cuda_render.render_frame(crowd, cfg, 0)
    start_c = crowd.replace(albedo=torch.clamp(crowd.albedo * 0.8, 0.02,
                                               0.98))
    zero_launches()
    losses_c, warned_c = with_warnings(lambda: fit(cfg, 2, start_c,
                                                   target_c))
    torch.cuda.synchronize()
    crowd_launches = launched()
    pool_rel = max(row_rel(d_c, d_ck))
    pool_eq = {"image_bit_equal": bool(torch.equal(img_c, img_cp)),
               "rays_equal": int(rays_c) == int(rays_cp),
               "kept_d_packed_bit_equal_to_k3_pool": bool(torch.equal(d_ck,
                                                                      d_cp)),
               "d_packed_within_1e-4_of_kept": pool_rel <= 1e-4,
               "deterministic": bool(torch.equal(d_c, d_c2))}
    emit({"phase": "wavefront_grad", "part": "pool",
          "spheres": crowd.n_spheres, "nvidia_smi": smi,
          "launches": crowd_launches, "losses": losses_c,
          "warnings": warned_c, "sweep_ms": pool_ms,
          "kept_sweep_ms": kept_pool_ms, "runs_ms": pool_runs,
          "row_rel_vs_kept": pool_rel, "kept_pool": kept_pool,
          "pool": crowd_pool,
          "tape_bytes_used": used_c, "band_row_rel_max": crowd_rel,
          "band_plain_ms": plain_c_ms, **pool_eq})
    check(all(pool_eq.values()), f"the pool sweep: {pool_eq}")
    check(crowd_rel <= 1e-3 and crowd_rel_kept <= 1e-3,
          f"600 spheres: band vs plain {crowd_rel}, kept {crowd_rel_kept}")
    check(crowd_launches == {"wave_tape": 2, "wave_sweep_pool": 2}
          and not warned_c, f"600-sphere steps launched {crowd_launches}")
    check(all(np.isfinite(losses_c)), "600-sphere losses finite")

    # ---- 40 lights --------------------------------------------------------
    many = many_lights_scene().to(dev)
    small = cfg.replace(width=128, height=32, samples_per_pixel=2,
                        max_depth=4)
    gm = grad_stats.cotangent(32, 128, 5, dev)
    _, r_m, d_m = cuda_grad.render_tile_grad(many, small, 0, gm, 0, 0, 32,
                                             128)
    _, r_mp, d_mp = render_tile_grad_plain(many, small, 0, gm, 0, 0, 32, 128)
    _, _, d_mk = cuda_grad.render_tile_grad_form(
        many, small.replace(diff_wavefront=False), 0, gm, 0, 0, 32, 128,
        "warp")
    _, _, tape_m = cuda_grad.render_tile_wave_tape(many, small, 0, 0, 0, 32,
                                                   128)
    d_mkept = cuda_grad.sweep_wave_tape(many, small, gm, tape_m,
                                        form="tiles")
    torch.cuda.synchronize()
    many_rel = max(row_rel(d_m, d_mp))
    many_kept_rel = max(row_rel(d_m, d_mkept))
    many_eq = bool(torch.equal(d_mkept, d_mk))
    emit({"phase": "wavefront_grad", "part": "many_lights",
          "lights": len(many.emissive_ids),
          "row_rel_max": many_rel, "rays": int(r_m),
          "rays_plain": int(r_mp), "row_rel_vs_kept": many_kept_rel,
          "kept_bit_equal_to_k3": many_eq})
    check(many_rel <= 1e-3 and int(r_m) == int(r_mp) and many_eq
          and many_kept_rel <= 1e-4, "40 lights: the wavefront pair")

    # ---- 8 row bands through the sharded step ----------------------------
    fields = ("center", "radius", "albedo", "emissive")
    pert = scene.replace(center=scene.center + 0.03)
    zero_launches()
    (ln, gn), warned_s = with_warnings(
        lambda: make_sharded_value_and_grad(cfg, make_mesh([dev] * 8),
                                            fields=fields)(pert, target, 1))
    torch.cuda.synchronize()
    sharded_launches = launched()
    leaves = {f: getattr(pert, f).detach().requires_grad_(True)
              for f in fields}
    l1 = render_loss(pert.replace(**leaves), target, cfg, 1)
    g1 = dict(zip(fields, torch.autograd.grad(l1, list(leaves.values()))))
    contract = {f: bool(((gn[f] - g1[f]).abs()
                         <= 1e-4 * g1[f].abs() + 1e-7).all())
                for f in fields}
    worst = {f: float((gn[f] - g1[f]).abs().max())
             / max(float(g1[f].abs().max()), 1e-30) for f in fields}
    l1 = float(l1.detach())
    loss_rel = abs(float(ln) - l1) / abs(l1)
    emit({"phase": "wavefront_grad", "part": "sharded",
          "bands": 8,
          "launches": sharded_launches, "loss_rel": loss_rel,
          "contract": contract, "rel_max": worst, "warnings": warned_s})
    check(sharded_launches == {"wave_tape": 8, "wave_sweep": 8}
          and not warned_s, f"sharded steps launched {sharded_launches}")
    check(loss_rel <= 1e-6 and all(contract.values()),
          f"sharded wavefront vs one device: {contract}, {loss_rel}")

    # ---- timing ------------------------------------------------------------
    def tape_only():
        return cuda_grad.render_tile_wave_tape(scene, cfg, 0, 0, 0, H, W)
    keep = tape_only()[2]

    def pair():
        _, _, t = tape_only()
        return cuda_grad.sweep_wave_tape(scene, cfg, g, t)

    def lockstep_pair():
        cuda_render.render_tile(scene, cfg, 0, 0, 0, H, W)
        return cuda_grad.render_tile_grad_form(scene, lock, 0, g, 0, 0, H, W,
                                               "warp")
    runs = {"pair": [], "k1_k3": []}
    for k in ("pair", "k1_k3", "k1_k3", "pair"):
        runs[k].append(time_device_call(
            pair if k == "pair" else lockstep_pair, repeats=3)[0] * 1e3)
    # the staged tape instance in turns with the scalar one and K1:
    # the wrappers on CUDA events, then the kernels' device time from a
    # torch.profiler trace of the same turns
    forward = {
        "staged": tape_only,
        "scalar": lambda: cuda_grad.render_tile_wave_tape(
            scene, cfg, 0, 0, 0, H, W, form="scalar"),
        "k1": lambda: cuda_render.render_tile(scene, cfg, 0, 0, 0, H, W)}
    turns = ("staged", "scalar", "k1", "k1", "scalar", "staged")
    tape_runs = {k: [] for k in forward}
    for k in turns:
        tape_runs[k].append(time_device_call(forward[k], repeats=3)[0] * 1e3)
    tape_ms, scalar_ms, k1_ms = (sum(tape_runs[k]) / 2 for k in forward)
    emit({"phase": "wavefront_grad", "part": "tape_turns",
          "nvidia_smi": smi, "runs_ms": tape_runs, "staged_ms": tape_ms,
          "scalar_ms": scalar_ms, "k1_ms": k1_ms,
          "note": "wrapper ms on CUDA events, 3 calls a run (the tape's "
                  "allocation and uploads included)"})
    turns_dir = trace_dir("wave_tape_turns")
    with trace_to(turns_dir):
        for k in turns:
            forward[k]()
        torch.cuda.synchronize()
    traced_kernels = trace_summary(turns_dir)["kernels"]
    labels = {"staged": "merged_render_kernel<4>",
              "scalar": "merged_render_kernel<3>",
              "k1": "merged_render_kernel<0>"}
    device_ms = {}
    for k, label in labels.items():
        got = traced_kernels.get(label, {"ms": 0.0, "launches": 0})
        check(got["launches"] == 2, f"the turns' trace: {label} {got}")
        device_ms[k] = got["ms"] / got["launches"]
    emit({"phase": "wavefront_grad", "part": "tape_kernels_traced",
          "nvidia_smi": smi, "kernel_device_ms": device_ms,
          "kernels": labels,
          "note": "device ms of each kernel from a torch.profiler trace "
                  "(profiling.trace_to) of one launch a turn, two turns"})
    # the redesigned sweep in turns with the kept one on one tape: the
    # wrappers on CUDA events, then the kernels' device time from a trace
    # of the same turns; their cycles by part (tools.grad_stats --forms
    # wave: the stats instances)
    sweeps = {"runs": lambda: cuda_grad.sweep_wave_tape(scene, cfg, g, keep),
              "tiles": lambda: cuda_grad.sweep_wave_tape(scene, cfg, g, keep,
                                                         form="tiles")}
    sweep_order = ("runs", "tiles", "tiles", "runs", "runs", "tiles")
    sweep_runs = {k: [] for k in sweeps}
    for k in sweep_order:
        sweep_runs[k].append(time_device_call(sweeps[k], repeats=3)[0] * 1e3)
    sweep_ms, kept_sweep_ms = (sum(sweep_runs[k]) / len(sweep_runs[k])
                               for k in ("runs", "tiles"))
    sweeps_dir = trace_dir("wave_sweep_turns")
    with trace_to(sweeps_dir):
        for k in sweep_order:
            sweeps[k]()
        torch.cuda.synchronize()
    sweep_traced = trace_summary(sweeps_dir)["kernels"]
    sweep_device_ms = {}
    for k, label in (("runs", run_label), ("tiles", "wave_sweep_kernel")):
        got = traced_kernel(sweep_traced, label)
        check(got.get("launches") == 3, f"the sweeps' trace: {label} {got}")
        sweep_device_ms[k] = got["ms"] / got["launches"]
    emit({"phase": "wavefront_grad", "part": "sweep_turns",
          "nvidia_smi": smi, "runs_ms": sweep_runs, "sweep_ms": sweep_ms,
          "kept_sweep_ms": kept_sweep_ms,
          "kernel_device_ms": sweep_device_ms,
          "kernels": {"runs": run_label, "tiles": "wave_sweep_kernel"},
          "ptxas": {k: usage.get(k, {}) for k in (run_label,
                                                  "wave_sweep_kernel")},
          "note": "wrapper ms on CUDA events, 3 calls a run, three runs "
                  "each in turns; device ms from a torch.profiler trace "
                  "of one launch a turn"})
    shares = grad_stats.wave_stats(scene, cfg, g)
    emit({"phase": "wavefront_grad", "part": "sweep_cycle_shares",
          "nvidia_smi": smi, "sweeps": shares})
    check(shares[0]["bit_equal_to_tiles"]
          and shares[1]["row_rel_vs_tiles"] <= 1e-4,
          "the sweeps' stats instances")
    del keep
    k3_ms = time_device_call(cuda_grad.render_tile_grad_form, scene, lock, 0,
                             g, 0, 0, H, W, "warp", repeats=3)[0] * 1e3
    steps = {"wave": [], "lockstep": []}
    for k in ("lockstep", "wave", "wave", "lockstep"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit(cfg if k == "wave" else lock, 3)
        torch.cuda.synchronize()
        steps[k].append((time.perf_counter() - t0) / 3 * 1e3)
    emit({"phase": "wavefront_grad", "part": "step_turns",
          "nvidia_smi": smi, "runs_ms": steps,
          "pair_runs_ms": runs["pair"], "k1_plus_k3_runs_ms": runs["k1_k3"],
          "note": "steps: host clock around 3 Adam steps; pair and K1 + "
                  "K3: CUDA events, 3 calls a run"})
    # one traced step of each route (the second of two, each ending in a
    # synchronize): the device's idle share and each kernel's device time
    step_traces = {}
    for k, c in (("wave", cfg), ("lockstep", lock)):
        ir = InverseRenderer(c, target, trainable=("albedo",),
                             learning_rate=2e-2)
        ir.fit(start, steps=1, resample=False)
        torch.cuda.synchronize()
        d = trace_dir(f"{k}_step")
        with trace_to(d):
            for _ in range(2):
                with torch.profiler.record_function(f"{k}_step"):
                    ir.fit(start, steps=1, resample=False)
                    torch.cuda.synchronize()
        step_traces[k] = trace_summary(d, window=f"{k}_step")
    wave_k = step_traces["wave"]["kernels"]
    emit({"phase": "wavefront_grad", "part": "step_trace",
          "nvidia_smi": smi,
          "idle_share": step_traces["wave"]["idle_share"],
          "span_ms": step_traces["wave"]["span_ms"],
          "busy_ms": step_traces["wave"]["busy_ms"],
          "tape_kernel_ms": wave_k.get("merged_render_kernel<4>", {}).get(
              "ms"),
          "sweep_kernel_ms": traced_kernel(wave_k, run_label).get("ms"),
          "kernels": wave_k, "copies_ms": step_traces["wave"]["copies_ms"],
          "runtime": step_traces["wave"]["runtime"],
          "lockstep": step_traces["lockstep"],
          "trace_files": {k: v["file"] for k, v in step_traces.items()}})
    check(wave_k.get("merged_render_kernel<4>", {}).get("launches") == 1
          and traced_kernel(wave_k, run_label).get("launches") == 1
          and "wave_sweep_kernel" not in wave_k,
          f"the traced wavefront step's kernels: {wave_k}")
    check("cudaMemGetInfo" not in step_traces["wave"]["runtime"],
          "the traced wavefront step asked for the card's free memory")
    check(all(0.0 <= v["idle_share"] < 1.0 for v in step_traces.values()),
          f"idle shares {[v['idle_share'] for v in step_traces.values()]}")
    # the plain wavefront's forward on the card
    mat = torch.tensor(scene.mat_type, dtype=torch.int64, device=dev)
    yy, xx = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    roots = RootCount(tab)
    t0 = time.perf_counter()
    col, work = tc.render_pixels_wavefront(
        tab, mat, scene.emissive_ids, cfg, camera_scalars(scene, cfg),
        xx.reshape(-1), yy.reshape(-1), 0)
    torch.cuda.synchronize()
    plain_wave_ms = (time.perf_counter() - t0) * 1e3
    plain_wave_img = torch.stack(col, dim=-1).reshape(H, W, 3)
    # the bound terms of K1's function on this frame (phase 4's count)
    _, work_r = tc.render_pixels(
        tab, mat, scene.emissive_ids, cfg, camera_scalars(scene, cfg),
        xx.reshape(-1), yy.reshape(-1), 0, traversal=roots)
    shadow = int(work_r.shadow.sum())
    check(int(work.traced.sum()) == traced == int(work_r.traced.sum()),
          "the tape's bounces != the plain traced rays")
    fwd_ops = (16 * scene.n_spheres * traced + 3 * roots.hit_roots
               + 16 * shadow + 3 * roots.light_roots
               + 20 * int(work_r.occlusion_tests.sum()))
    adj_ops = 150 * traced + 270 * shadow
    scene_bytes = 4 * (14 * scene.n_spheres + scene.n_spheres + n_lights + 22)
    img_bytes = 4 * 3 * H * W
    bound = {
        "tape": max(fwd_ops / 67e12, (scene_bytes + img_bytes + used)
                    / 3.35e12) * 1e3,
        "sweep": max(adj_ops / 67e12, (scene_bytes + img_bytes + used
                                       + 4 * 14 * scene.n_spheres)
                     / 3.35e12) * 1e3}
    bound_by = {"tape": "operations" if fwd_ops / 67e12 >= (
        scene_bytes + img_bytes + used) / 3.35e12 else "bytes",
        "sweep": "operations" if adj_ops / 67e12 >= (
            scene_bytes + img_bytes + used + 56 * scene.n_spheres)
        / 3.35e12 else "bytes"}
    # the pair's bound: K3's operations (the forward's and the adjoint's)
    # plus the tape's used bytes at the memory rate
    k3_ops_ms = (fwd_ops + adj_ops) / 67e12 * 1e3
    pair_bound = k3_ops_ms + used / 3.35e12 * 1e3
    bytes_c = (4 * 15 * crowd.n_spheres + 4 * len(crowd.emissive_ids)
               + img_bytes + used_c + 4 * 14 * crowd.n_spheres)
    bound_c = max(adj_ops_c / 67e12, bytes_c / 3.35e12) * 1e3
    pool_bound_by = ("bytes" if bytes_c / 3.35e12 >= adj_ops_c / 67e12
                     else "operations")
    pair_ms = sum(runs["pair"]) / 2
    k1k3_ms = sum(runs["k1_k3"]) / 2
    timing = {"phase": "wavefront_grad", "part": "timing",
              "nvidia_smi": smi,
              "pair_ms": pair_ms, "pair_runs": runs["pair"],
              "k1_plus_k3_ms": k1k3_ms, "k1_plus_k3_runs": runs["k1_k3"],
              "tape_ms": tape_ms, "sweep_ms": sweep_ms,
              "kept_sweep_ms": kept_sweep_ms,
              "sweep_kernel_device_ms": sweep_device_ms,
              "scalar_tape_ms": scalar_ms,
              "tape_kernel_device_ms": device_ms,
              "tape_plus_sweep_ms": tape_ms + sweep_ms,
              "k1_ms": k1_ms, "k3_ms": k3_ms,
              "step_ms": sum(steps["wave"]) / 2,
              "lockstep_step_ms": sum(steps["lockstep"]) / 2,
              "step_runs": steps,
              "plain_wavefront_forward_ms": plain_wave_ms,
              "plain_bands_ms": plain_bands_s * 1e3,
              "tape_bytes_allocated": allocated, "tape_bytes_used": used,
              "bound_ms": bound, "bound_by": bound_by,
              "pair_bound_ms": pair_bound, "k3_ops_ms": k3_ops_ms,
              "ptxas": {k: usage.get(k, {}) for k in (
                  "merged_render_kernel<4>", "merged_render_kernel<3>",
                  run_label, "wave_sweep_kernel", "wave_run_pool_kernel",
                  "wave_sweep_pool_kernel")},
              "pool_sweep_ms": pool_ms, "kept_pool_sweep_ms": kept_pool_ms,
              "bound_peak": "67 TFLOP/s FP32, 3.35 TB/s (H100 SXM, 700 W)",
              "seconds": time.perf_counter() - t_phase}
    emit(timing)
    check(bool(torch.equal(plain_wave_img, img_t.reshape(H, W, 3)))
          or float((plain_wave_img - img_t).abs().max()) <= 1e-3,
          "plain wavefront forward vs the tape instance")
    tol = ("the tape instances' image and rays bit-equal to K1's, the "
           "staged instance's tape word for word the scalar one's at every "
           "used slot; the main sweep's d_packed per row <= 1e-4 x row max "
           "of the kept sweep's, two launches bit-equal; the kept sweep's "
           "bit-equal to K3's warp form on its grid (the pool sweep's to "
           "the pool form's at 600 spheres); both per row <= 1e-3 x row "
           "max of plain autograd on three 8-row bands, the main one also "
           "at 40 lights; albedo FD <= 5% + 1e-6")
    src = "toypathtracer_tpu/ops/tracecore.py:2223"
    return [
        {"name": "wave_tape", "route": "cuda",
         "source": "toypathtracer_torch/csrc/render.cu",
         "replaces": src + " (jnp under XLA, not a Pallas kernel)",
         "launches": main_launches.get("wave_tape", 0),
         "launches_by_path": {"main_path": main_launches.get("wave_tape",
                                                             0),
                              "crowded_600": crowd_launches.get(
                                  "wave_tape", 0)},
         "max_abs_err": float((img_t - plain_wave_img).abs().max()),
         "ms": tape_ms, "plain_ms": plain_wave_ms, "bound_ms": bound["tape"],
         "bound_by": bound_by["tape"], "library_ms": None,
         "kernel_device_ms": device_ms["staged"],
         "baseline_ms": scalar_ms,
         "baseline_kernel_device_ms": device_ms["scalar"],
         "baseline": "merged_render_kernel<3> (the scalar tape instance "
                     "it replaced), in turns",
         "form": "merged_render_kernel<4> (K1's staged tape instance)",
         "ptxas": usage.get("merged_render_kernel<4>", {}),
         "vs_plain": {"tolerance": tol,
                      "bit_equal_to_k1": eq["tape_image_bit_equal_to_k1"],
                      "tape_equal_to_scalar":
                          eq["staged_tape_equal_to_scalar"]}},
        {"name": "wave_tape_baseline", "route": "cuda",
         "source": "toypathtracer_torch/csrc/render.cu",
         "replaces": src + " (jnp under XLA, not a Pallas kernel)",
         "launches": main_launches.get("wave_tape_baseline", 0),
         "max_abs_err": float((img_b - plain_wave_img).abs().max()),
         "ms": scalar_ms, "plain_ms": plain_wave_ms,
         "bound_ms": bound["tape"], "bound_by": bound_by["tape"],
         "library_ms": None, "kernel_device_ms": device_ms["scalar"],
         "form": "merged_render_kernel<3> (the scalar tape instance, "
                 "the staged one's baseline)",
         "ptxas": usage.get("merged_render_kernel<3>", {}),
         "vs_plain": {"tolerance": tol,
                      "bit_equal_to_k1": eq["scalar_image_bit_equal_to_k1"]}},
        {"name": "wave_sweep", "route": "cuda",
         "source": "toypathtracer_torch/csrc/wavesweep.cu",
         "replaces": src + " (jnp under XLA, not a Pallas kernel)",
         "launches": main_launches.get("wave_sweep", 0),
         "launches_by_path": {"main_path": main_launches.get("wave_sweep",
                                                             0),
                              "sharded_step": sharded_launches.get(
                                  "wave_sweep", 0)},
         "max_abs_err": err, "ms": sweep_ms,
         "kernel_device_ms": sweep_device_ms["runs"],
         "plain_ms": plain_bands_s * 1e3,
         "plain_ms_rows": 24, "bound_ms": bound["sweep"],
         "bound_by": bound_by["sweep"], "library_ms": None,
         "form": f"{run_label} (wavesweep.cuh sweep_runs, sorted blocks "
                 "of 2 tiles a warp)",
         "baseline_ms": kept_sweep_ms,
         "baseline_kernel_device_ms": sweep_device_ms["tiles"],
         "baseline": "wave_sweep_kernel (the kept sweep it replaced), in "
                     "turns",
         "pair_ms": pair_ms, "pair_bound_ms": pair_bound,
         "pair_baseline_ms": k1k3_ms,
         "pair_baseline": "K1 + K3's warp form, timed in turns with the pair",
         "ptxas": usage.get(run_label, {}),
         "vs_plain": {"tolerance": tol, "band_row_rel_max": max(rel),
                      "many_lights_row_rel_max": many_rel,
                      "row_rel_vs_kept": sweep_rel,
                      "deterministic": eq["sweep_deterministic"]}},
        {"name": "wave_sweep_baseline", "route": "cuda",
         "source": "toypathtracer_torch/csrc/wavegrad.cu",
         "replaces": src + " (jnp under XLA, not a Pallas kernel)",
         "launches": main_launches.get("wave_sweep_baseline", 0),
         "max_abs_err": err_kept, "ms": kept_sweep_ms,
         "kernel_device_ms": sweep_device_ms["tiles"],
         "plain_ms": plain_bands_s * 1e3,
         "plain_ms_rows": 24, "bound_ms": bound["sweep"],
         "bound_by": bound_by["sweep"], "library_ms": None,
         "form": "wave_sweep_kernel (coopgrad.cuh sweep_tiles on K3's grid, "
                 "the main sweep's baseline)",
         "ptxas": usage.get("wave_sweep_kernel", {}),
         "vs_plain": {"tolerance": tol, "band_row_rel_max": max(rel_kept),
                      "bit_equal_to_warp_k3":
                          eq["kept_sweep_bit_equal_to_warp_k3"]}},
        {"name": "wave_sweep_pool", "route": "cuda",
         "source": "toypathtracer_torch/csrc/wavesweep.cu",
         "replaces": src + " (jnp under XLA, not a Pallas kernel)",
         "launches": crowd_launches.get("wave_sweep_pool", 0),
         "max_abs_err": crowd_err,
         "ms": pool_ms, "plain_ms": plain_c_ms, "plain_ms_rows": 8,
         "bound_ms": bound_c, "bound_by": pool_bound_by,
         "library_ms": None,
         "form": "wave_run_pool_kernel (sorted shares, the fused adds, a "
                 "PoolTable a warp)",
         "baseline_ms": kept_pool_ms,
         "baseline": "wave_sweep_pool_kernel (the kept pool sweep), in "
                     "turns",
         "ptxas": usage.get("wave_run_pool_kernel", {}),
         "vs_plain": {"tolerance": "within 1e-4 x row max of the kept pool "
                                   "sweep, which is bit-equal to K3's pool "
                                   "form on its grid; an 8-row band per row "
                                   "<= 1e-3 x row max of plain autograd",
                      "band_row_rel_max": crowd_rel, **pool_eq}},
        {"name": "wave_sweep_pool_baseline", "route": "cuda",
         "source": "toypathtracer_torch/csrc/wavegrad.cu",
         "replaces": src + " (jnp under XLA, not a Pallas kernel)",
         "launches": crowd_launches.get("wave_sweep_pool_baseline", 0),
         "max_abs_err": crowd_err_kept,
         "ms": kept_pool_ms, "plain_ms": plain_c_ms, "plain_ms_rows": 8,
         "bound_ms": bound_c, "bound_by": pool_bound_by,
         "library_ms": None,
         "form": "wave_sweep_pool_kernel (coopgrad.cuh sweep_tiles with a "
                 "PoolTable a warp, the main pool sweep's baseline)",
         "ptxas": usage.get("wave_sweep_pool_kernel", {}),
         "vs_plain": {"tolerance": "bit-equal to K3's pool form on its "
                                   "grid; an 8-row band per row <= 1e-3 x "
                                   "row max of plain autograd",
                      "band_row_rel_max": crowd_rel_kept,
                      "bit_equal_to_k3_pool":
                          pool_eq["kept_d_packed_bit_equal_to_k3_pool"]}}]


def grads_vs(got, want):
    """Per field: whether JAX's sharded-gradient contract holds (rtol
    1e-6, atol 1e-9 + 1e-7 max|g|; tests/test_sharding.py) and the worst
    max |diff| / max |g|."""
    out = {}
    for f, w in want.items():
        d = (got[f] - w).abs()
        scale = float(w.abs().max())
        tol = 1e-6 * w.abs() + 1e-9 + 1e-7 * scale
        out[f] = {"contract": bool((d <= tol).all()),
                  "rel": float(d.max()) / scale if scale > 0 else
                  (0.0 if float(d.max()) == 0 else float("inf"))}
    return out


def sharded_phases(smi, dev=None, cfg=None, scaled_n=100_000, bands=8,
                   backend="nccl"):
    """Phase 18: row-sharded rendering and training on one card
    (parallel/mesh.py, parallel/distributed.py): 8 bands on the card at
    the reference workload, bit-equal to the single device, with the
    launches each path makes and its ms beside the unsharded path's in
    turns; make_mesh() over every card present; the scaled frame; the
    sharded training step (albedo hard, centre/radius at eps 0.05) and
    InverseRenderer(mesh=...) with the multi-view recovery of
    tests/test_sharding.py:218; NCCL at world size 1; two processes
    sharing the card over gloo through the port's worker.  Returns the
    phase's summary (also emitted)."""
    import os
    import tempfile
    from functools import partial

    import numpy as np
    import torch.distributed as dist

    from toypathtracer_torch import (FLAG_PROGRESSIVE, RenderConfig,
                                     make_scaled_scene, make_scene)
    from toypathtracer_torch.inverse import (InverseRenderer,
                                             make_sharded_value_and_grad,
                                             render_loss)
    from toypathtracer_torch.ops import cuda_grad, cuda_render, cuda_scaled
    from toypathtracer_torch.parallel.mesh import (make_mesh,
                                                   render_frame_sharded)
    from toypathtracer_torch.profiling import time_device_call
    from toypathtracer_torch.render.frame import RenderSession
    from toypathtracer_torch.scene import (MAT_LAMBERT, CameraSpec,
                                           scene_from_arrays)

    dev = torch.device("cuda", 0) if dev is None else dev
    cfg = cfg or RenderConfig(width=1280, height=720, samples_per_pixel=4,
                              max_depth=10)
    H, W = cfg.height, cfg.width
    counters = (cuda_render.launches, cuda_grad.launches,
                cuda_scaled.launches)

    def zero():
        for c in counters:
            for k in c:
                c[k] = 0

    def counted():
        return {k: v for c in counters for k, v in c.items() if v}

    def in_turns(a, b, repeats):
        """ms of a and b, timed a, b, b, a with CUDA events."""
        runs = {"a": [], "b": []}
        for k in ("a", "b", "b", "a"):
            runs[k].append(time_device_call(a if k == "a" else b,
                                            repeats=repeats)[0] * 1e3)
        return sum(runs["a"]) / 2, sum(runs["b"]) / 2

    out = {"phase": "sharded", "bands": bands, "device": smi}
    t_phase = time.perf_counter()
    mesh = make_mesh([dev] * bands)
    scene = make_scene(big=True).to(dev)

    # ---- (a) the sharded frame on one card --------------------------------
    zero()
    img_s, rays_s = render_frame_sharded(scene, cfg, 0, mesh)
    torch.cuda.synchronize()
    frame_launches = counted()
    img_1, rays_1 = cuda_render.render_frame(scene, cfg, 0, device=dev)
    fn = partial(render_frame_sharded, mesh=mesh)
    sess_s = RenderSession(scene, cfg, flags=FLAG_PROGRESSIVE, render_fn=fn,
                           device=dev)
    sess_1 = RenderSession(scene, cfg, flags=FLAG_PROGRESSIVE, device=dev)
    r_s = [int(sess_s.step(0.0)[1]) for _ in range(16)]
    r_1 = [int(sess_1.step(0.0)[1]) for _ in range(16)]
    torch.cuda.synchronize()
    ms_1, ms_s = in_turns(lambda: cuda_render.render_frame(scene, cfg, 0,
                                                           device=dev),
                          lambda: fn(scene, cfg, 0), 8)
    out["frame"] = {
        "bit_equal": bool(torch.equal(img_s, img_1)),
        "rays": int(rays_s), "rays_single": int(rays_1),
        "launches": frame_launches,
        "session_16_frames_bit_equal": bool(torch.equal(
            sess_s.state.accum, sess_1.state.accum)) and r_s == r_1,
        "ms": ms_s, "ms_single": ms_1}
    check(out["frame"]["bit_equal"] and int(rays_s) == int(rays_1),
          "sharded frame != single-device frame")
    check(frame_launches == {"render": bands},
          f"sharded frame launched {frame_launches}")
    check(out["frame"]["session_16_frames_bit_equal"],
          "sharded session != single-device session")

    # ---- (b) make_mesh() over every card present --------------------------
    all_cards = make_mesh()
    img_b, rays_b = render_frame_sharded(scene, cfg, 0, all_cards)
    out["all_cards"] = {
        "count": len(all_cards.devices),
        "bit_equal": bool(torch.equal(img_b.to(dev), img_1))
        and int(rays_b) == int(rays_1)}
    check(len(all_cards.devices) == torch.cuda.device_count(),
          "make_mesh() is not every card")
    check(out["all_cards"]["bit_equal"], "make_mesh() frame != single")

    # ---- (c) the scaled frame ---------------------------------------------
    sd = make_scaled_scene(scaled_n).to(dev)
    zero()
    simg_s, srays_s = cuda_scaled.render_frame_scaled_sharded(sd, cfg, 0,
                                                              mesh)
    torch.cuda.synchronize()
    scaled_launches = counted()
    simg_1, srays_1 = cuda_scaled.render_frame_scaled(sd, cfg, 0, device=dev)
    sms_1, sms_s = in_turns(
        lambda: cuda_scaled.render_frame_scaled(sd, cfg, 0, device=dev),
        lambda: cuda_scaled.render_frame_scaled_sharded(sd, cfg, 0, mesh),
        2)
    out["scaled"] = {"spheres": sd.n_spheres,
                     "bit_equal": bool(torch.equal(simg_s, simg_1)),
                     "rays": int(srays_s), "rays_single": int(srays_1),
                     "launches": scaled_launches, "ms": sms_s,
                     "ms_single": sms_1}
    check(out["scaled"]["bit_equal"] and int(srays_s) == int(srays_1),
          "sharded scaled frame != single-device frame")
    check(scaled_launches == {"scaled_render": bands},
          f"sharded scaled frame launched {scaled_launches}")
    del sd

    # ---- (d) the sharded training step ------------------------------------
    target, _ = cuda_render.render_frame(scene, cfg, 0, device=dev)
    rng = np.random.RandomState(3)
    pert = scene.replace(
        albedo=(scene.albedo + torch.from_numpy(
            rng.uniform(-0.1, 0.1, (scene.n_spheres, 3)).astype(np.float32)
        ).to(dev)).clamp(0.0, 1.0),
        center=scene.center + torch.from_numpy(
            rng.uniform(-0.02, 0.02, (scene.n_spheres, 3)).astype(np.float32)
        ).to(dev))

    def single_step(c, fields):
        leaves = {f: getattr(pert, f).detach().requires_grad_(True)
                  for f in fields}
        loss = render_loss(pert.replace(**leaves), target, c, 1)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(fields, grads))

    steps = {}
    for name, eps, fields in (("albedo_hard", 0.0, ("albedo",)),
                              ("center_radius_eps0.05", 0.05,
                               ("center", "radius"))):
        c = cfg.replace(soft_silhouette_eps=eps)
        vg = make_sharded_value_and_grad(c, mesh, fields=fields)
        zero()
        ln, gn = vg(pert, target, 1)
        torch.cuda.synchronize()
        launches = counted()
        l1, g1 = single_step(c, fields)
        ms_1, ms_s = in_turns(lambda: single_step(c, fields),
                              lambda: vg(pert, target, 1), 2)
        cmp = grads_vs(gn, g1)
        key = "grad_soft" if eps else "grad"
        steps[name] = {"loss": float(ln), "loss_single": float(l1),
                       "loss_rel": abs(float(ln) - float(l1))
                       / abs(float(l1)),
                       "launches": launches, "grads": cmp,
                       "contract_met": all(v["contract"]
                                           for v in cmp.values()),
                       "ms": ms_s, "ms_single": ms_1}
        check(launches == {"render": bands, key: bands},
              f"sharded step {name} launched {launches}")
        check(steps[name]["loss_rel"] <= 1e-5, f"sharded loss {name}")
        # JAX's contract where it holds; where reassociation over the
        # frame misses it, each field within 1e-5 x its max (printed)
        check(all(v["rel"] <= 1e-5 for v in cmp.values()),
              f"sharded grads {name}: {cmp}")
    out["step"] = steps

    # ---- (e) InverseRenderer(mesh=...) ------------------------------------
    fits = [InverseRenderer(cfg, target, trainable=("albedo",),
                            learning_rate=1e-2, mesh=m, device=dev).fit(
        pert, steps=4, resample=False)[1] for m in (None, mesh)]
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(*fits))
    cfg_soft = RenderConfig(width=64, height=40, samples_per_pixel=2,
                            max_depth=2, soft_silhouette_eps=0.05)
    cams = (CameraSpec(look_from=(0.0, 0.0, 3.0), look_at=(0, 0, 0),
                       aperture=0.0),
            CameraSpec(look_from=(3.0, 0.0, 0.0), look_at=(0, 0, 0),
                       aperture=0.0))

    def one_sphere(z):
        return scene_from_arrays(
            [[0.0, 0.0, z]], [0.6], [[0.8, 0.3, 0.2]], [[0.0, 0.0, 0.0]],
            [0.0], [0.0], (MAT_LAMBERT,), (), cams[0], device=dev)
    truth = one_sphere(0.0)
    targets = torch.stack([cuda_render.render_frame(
        truth.replace(camera=c), cfg_soft, 0, device=dev)[0] for c in cams])
    zero()
    t0 = time.perf_counter()
    fitted, losses = InverseRenderer(
        cfg_soft, targets, trainable=("center",), learning_rate=5e-3,
        cameras=cams, mesh=mesh, device=dev).fit(one_sphere(0.12), steps=60,
                                                 resample=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    errz = float(fitted.center[0, 2].abs())
    out["inverse"] = {"adam_losses": fits[1], "adam_losses_single": fits[0],
                      "adam_loss_rel": loss_rel,
                      "multiview_errz": errz, "multiview_losses":
                      [losses[0], losses[-1]],
                      "multiview_launches": counted(),
                      "multiview_step_ms": fit_s / 60 * 1e3}
    check(loss_rel <= 1e-5, f"InverseRenderer(mesh) losses {fits}")
    check(errz < 0.06 and losses[-1] < 0.5 * losses[0],
          f"multi-view + mesh recovery: errz {errz}, losses {losses[0]} -> "
          f"{losses[-1]}")
    check(out["inverse"]["multiview_launches"].get("grad_soft") ==
          60 * 2 * bands, f"recovery launched {counted()}")

    # ---- (f) NCCL at world size 1 -----------------------------------------
    tmp = tempfile.mkdtemp(prefix="tpt_sharded_")
    vg_hard = make_sharded_value_and_grad(cfg, mesh, fields=("albedo",))
    ln0, gn0 = vg_hard(pert, target, 1)
    dist.init_process_group(backend, init_method=f"file://{tmp}/init1",
                            world_size=1, rank=0)
    try:
        gmesh = make_mesh([dev] * bands, group=dist.group.WORLD)
        img_g, rays_g = render_frame_sharded(scene, cfg, 0, gmesh)
        ln_g, gn_g = make_sharded_value_and_grad(
            cfg, gmesh, fields=("albedo",))(pert, target, 1)
        torch.cuda.synchronize()
        out["nccl_world_1"] = {
            "backend": dist.get_backend(),
            "frame_bit_equal": bool(torch.equal(img_g, img_s))
            and int(rays_g) == int(rays_s),
            "step_bit_equal": float(ln_g) == float(ln0)
            and torch.equal(gn_g["albedo"], gn0["albedo"])}
    finally:
        dist.destroy_process_group()
    check(out["nccl_world_1"]["frame_bit_equal"]
          and out["nccl_world_1"]["step_bit_equal"],
          f"{backend} at world size 1 != no group")

    # ---- (g) two processes sharing the card over gloo ---------------------
    root = os.path.dirname(os.path.abspath(__file__))
    npz = os.path.join(tmp, "rank0.npz")
    per = bands // 2
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "toypathtracer_torch.tools.distributed_smoke",
         str(r), "2", f"file://{tmp}/init2", str(per), str(dev), "gloo",
         npz], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=root, env=dict(os.environ, PYTHONPATH=root)) for r in range(2)]
    try:
        res = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.perf_counter() - t0
    for p, (o, e) in zip(procs, res):
        check(p.returncode == 0, f"worker failed: {o}\n{e[-3000:]}")
    lines = [dict(kv.split("=") for kv in o.split("SMOKE ")[1].split())
             for o, _ in res]
    wcfg = RenderConfig(width=64, height=8 * bands, samples_per_pixel=1,
                        max_depth=3)
    wscene = make_scene(big=True).to(dev)
    wimg, wrays = render_frame_sharded(wscene, wcfg, 0, mesh)
    wl, wg = make_sharded_value_and_grad(wcfg, mesh)(
        wscene.replace(center=wscene.center + 0.03),
        torch.zeros((wcfg.height, 64, 3), device=dev), 1)
    got = np.load(npz)
    g_ok = all(np.allclose(got[f], wg[f].cpu().numpy(), rtol=1e-5,
                           atol=1e-8) for f in wg)
    out["two_processes"] = {
        "lines": lines, "wall_s": wall_s,
        "step_s": [float(x["step_s"]) for x in lines],
        "rays_agree": len({x["rays"] for x in lines}) == 1
        and int(lines[0]["rays"]) == int(wrays),
        "loss_agree": len({x["loss"] for x in lines}) == 1,
        "loss_rel": abs(float(lines[0]["loss"]) - float(wl)) / abs(float(wl)),
        "rows_bit_equal": bool(np.array_equal(got["frame"],
                                              wimg.cpu().numpy())),
        "grads_within": g_ok}
    tp = out["two_processes"]
    check(tp["rays_agree"] and tp["loss_agree"] and tp["loss_rel"] <= 1e-6,
          f"two processes: {lines}")
    check({x["local_rows"] for x in lines} == {str(wcfg.height // 2)},
          "two processes: rows per rank")
    check(tp["rows_bit_equal"], "two processes: rows != single-process")
    check(g_ok, "two processes: grads != single-process 8-band step")
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


GOLDEN_DIR = "tests/golden"


def golden(name):
    """A golden of the reference's compiled C++ (tools/gen_golden.py)."""
    import os

    import numpy as np
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        GOLDEN_DIR, f"{name}.npz")
    with np.load(path) as g:
        return {k: g[k] for k in g.files}


def trace_dir(name: str) -> str:
    """An empty directory build/traces/<name> of this checkout for a
    profiling.trace_to trace."""
    import shutil
    from pathlib import Path
    d = Path(__file__).resolve().parent / "build" / "traces" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return str(d)


def zero_launches():
    from toypathtracer_torch.ops import cuda_grad, cuda_render, cuda_scaled
    for counts in (cuda_render.launches, cuda_grad.launches,
                   cuda_scaled.launches):
        for k in counts:
            counts[k] = 0


def launched():
    """Every kernel launched since zero_launches, by counter."""
    from toypathtracer_torch.ops import cuda_grad, cuda_render, cuda_scaled
    return {k: v for counts in (cuda_render.launches, cuda_grad.launches,
                                cuda_scaled.launches)
            for k, v in counts.items() if v}


def parity_phase(smi, budget_s=45.0):
    """The parity renderer (render/parity.py, plain PyTorch, the
    reference's scalar C++ semantics) on the card against the goldens,
    with tests/test_parity.py's gates; the card's sinf/cosf against
    glibc's on the sampler grid.  tiny_f16 runs where the phase is still
    inside `budget_s`."""
    import numpy as np

    from toypathtracer_torch import (FLAG_ANIMATE, FLAG_PROGRESSIVE,
                                     RenderConfig, make_scene)
    from toypathtracer_torch.ops import libm
    from toypathtracer_torch.ops import tracecore as tc
    from toypathtracer_torch.render.frame import (lerp_factor,
                                                  scene_for_frame)
    from toypathtracer_torch.render.parity import (render_frame_parity_pp,
                                                   render_frames_parity)

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    # the card's float32 sinf/cosf (torch.sin/cos on CUDA) against glibc's
    # (ops/libm on the host) on the 2^24-point sampler grid, both angle forms
    r = torch.arange(1 << 24, dtype=torch.int32).to(torch.float32) \
        * tc.INV_2_24
    trig = {}
    for form, a in (("unit_vector", (r * 2.0) * tc.PI_F),
                    ("light_cone", tc.TWO_PI * r)):
        a_d = a.to(dev)
        for fn, host, card in (("sin", libm.sinf, torch.sin),
                               ("cos", libm.cosf, torch.cos)):
            want = host(a)
            got = card(a_d).cpu()
            ulp = (got.view(torch.int32).to(torch.int64)
                   - want.view(torch.int32).to(torch.int64)).abs()
            trig[f"{form}_{fn}"] = {
                "share_differing": float((got != want).double().mean()),
                "max_ulp": int(ulp.max())}
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 4, 1 << 20).astype(np.float32))
    trig["sqrt_share_differing"] = float(
        (torch.sqrt(x.to(dev)).cpu() != libm.sqrtf(x)).double().mean())
    out = {"phase": "parity", "nvidia_smi": smi, "trig_vs_glibc": trig}

    def frame_gates(a, g):
        d = np.abs(a - g["image"]).max(axis=-1)
        return d, {"median": float(np.median(d)),
                   "tight_share": float((d < 1e-3).mean()),
                   "first_pixel_abs": float(np.abs(a[0, 0]
                                                   - g["image"][0, 0]).max())}

    scene = make_scene(big=True)
    zero_launches()
    t = time.perf_counter()
    (img, rays), = render_frames_parity(scene, RenderConfig(width=64,
                                                            height=36),
                                        [0], device="cuda")
    a, g = img.cpu().numpy(), golden("tiny_f1")
    d, tiny = frame_gates(a, g)
    tiny.update(col0_median=float(np.median(d[:, 0])),
                rays=int(rays), rays_golden=int(g["rays"]),
                rays_rel=abs(int(rays) - int(g["rays"])) / int(g["rays"]),
                seconds=time.perf_counter() - t)
    out["tiny_f1"] = tiny
    for name, depth, flip in (("tiny_pp_d2_f1", 2, 0.0),
                              ("tiny_pp_d3_f1", 3, 0.02)):
        t = time.perf_counter()
        img, rays = render_frame_parity_pp(
            scene, RenderConfig(width=64, height=36, max_depth=depth), 0,
            device="cuda")
        g = golden(name)
        d = np.abs(img.cpu().numpy() - g["image"]).max(axis=-1)
        out[name] = {"flipped_share": float((d >= 2e-4).mean()),
                     "flipped_gate": flip, "median": float(np.median(d)),
                     "max": float(d.max()), "rays": int(rays),
                     "rays_golden": int(g["rays"]),
                     "rays_rel": abs(int(rays) - int(g["rays"]))
                     / int(g["rays"]),
                     "seconds": time.perf_counter() - t}

    def progressive(cfg, frames, flags):
        scenes = [scene_for_frame(scene, np.float32(f / 60.0), flags)
                  for f in range(frames)]
        res = render_frames_parity(scenes, cfg, list(range(frames)),
                                   device="cuda")
        acc = np.zeros((cfg.height, cfg.width, 3), np.float32)
        for f, (im, _) in enumerate(res):
            fac = lerp_factor(f, flags, cfg)
            acc = acc * fac + im.cpu().numpy() * (np.float32(1.0) - fac)
        return acc, [int(rr) for _, rr in res]

    t = time.perf_counter()
    a, pf = progressive(RenderConfig(width=128, height=72), 2,
                        FLAG_ANIMATE | FLAG_PROGRESSIVE)
    g = golden("small_anim_f2")
    _, anim = frame_gates(a, g)
    anim.update(per_frame_rays=pf,
                per_frame_rays_golden=[int(v) for v in g["per_frame_rays"]],
                per_frame_rays_rel=[abs(p - int(q)) / int(q) for p, q in
                                    zip(pf, g["per_frame_rays"])],
                seconds=time.perf_counter() - t)
    out["small_anim_f2"] = anim
    if time.perf_counter() - t_phase < budget_s:
        t = time.perf_counter()
        a, pf = progressive(RenderConfig(width=64, height=36), 16,
                            FLAG_PROGRESSIVE)
        g = golden("tiny_f16")
        blk = [np.sqrt(np.clip(x, 0, None)).reshape(9, 4, 16, 4, 3)
               .mean(axis=(1, 3)) for x in (a, g["image"])]
        bd = np.abs(blk[0] - blk[1])
        out["tiny_f16"] = {"block_mean_abs": float(bd.mean()),
                           "block_max_abs": float(bd.max()),
                           "rays_rel": abs(sum(pf) - int(g["rays"]))
                           / int(g["rays"]),
                           "seconds": time.perf_counter() - t}
    else:
        out["tiny_f16"] = "left out: the phase's budget was spent"
    out["launches"] = launched()
    out["seconds"] = time.perf_counter() - t_phase
    out["gates"] = ("tests/test_parity.py's: tiny_f1 first pixel <= 2e-5, "
                    "col0 median < 1e-3, median < 0.02, tight > 0.25, rays "
                    "< 2%; pp d2/d3 flipped <= 0 / 0.02 (|diff| >= 2e-4), "
                    "median < 5e-7, rays < 2e-3; small_anim_f2 tight > "
                    "0.15, median < 0.02, first pixel <= 2e-5, rays per "
                    "frame < 2%; tiny_f16 4x4 blocks mean < 0.02, max < "
                    "0.2, rays < 2%")
    emit(out)
    check(tiny["first_pixel_abs"] <= 2e-5 and tiny["col0_median"] < 1e-3
          and tiny["median"] < 0.02 and tiny["tight_share"] > 0.25
          and tiny["rays_rel"] < 0.02, f"parity tiny_f1: {tiny}")
    for name in ("tiny_pp_d2_f1", "tiny_pp_d3_f1"):
        p = out[name]
        check(p["flipped_share"] <= p["flipped_gate"] and p["median"] < 5e-7
              and p["rays_rel"] < 2e-3, f"parity {name}: {p}")
    check(anim["tight_share"] > 0.15 and anim["median"] < 0.02
          and anim["first_pixel_abs"] <= 2e-5
          and max(anim["per_frame_rays_rel"]) < 0.02,
          f"parity small_anim_f2: {anim}")
    if isinstance(out["tiny_f16"], dict):
        f16 = out["tiny_f16"]
        check(f16["block_mean_abs"] < 0.02 and f16["block_max_abs"] < 0.2
              and f16["rays_rel"] < 0.02, f"parity tiny_f16: {f16}")
    check(not out["launches"], f"the parity route launched kernels: "
          f"{out['launches']}")
    return out


def viewer_phase(smi):
    """The live viewer (serve.py) on the card at the reference workload:
    its HTTP server on 127.0.0.1, port 0; K1 once a frame; /frame.png the
    session's image; toggles and the 'g' round trip through the plain
    renderer reset the frame count; --batch 8 bit-equal to 8 single
    steps; the HUD's Mray/s beside the session's ms/frame; --scaled
    through the cooperative scaled render kernel."""
    import argparse
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from toypathtracer_torch import io as image_io
    from toypathtracer_torch.render.frame import sum_rays
    from toypathtracer_torch.serve import make_handler, make_viewer

    t_phase = time.perf_counter()
    args = argparse.Namespace(width=1280, height=720, spp=4, max_depth=10,
                              small=False, scaled=0, animate=False, ppl=1,
                              batch=1, backend="auto", device="cuda")
    v, label = make_viewer(args)
    v.time_scale = 0.0
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(v))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path):
        return urllib.request.urlopen(base + path, timeout=60).read()

    def stats():
        return json.loads(get("/stats"))

    out = {"phase": "viewer", "nvidia_smi": smi, "backend": label,
           "size": "1280x720, spp 4, depth 10, 46 spheres"}
    try:
        zero_launches()
        n = 6
        for _ in range(n):
            v.step_once()
        torch.cuda.synchronize()
        out["launches"] = launched()
        s = stats()
        png = get("/frame.png")
        out["frames"] = s["frames"]
        out["png_equal"] = png == image_io.png_bytes(
            v.sess.state.accum.cpu().numpy())
        out["hud"] = s["hud"]
        out["hud_mray_s"] = s["mray_s"]
        hud_s, hud_rays = v.timer.averages()
        out["hud_ms_per_frame"] = hud_s * 1e3
        out["hud_rays_per_frame"] = hud_rays
        # the session's own ms/frame: 8 frames between two syncs
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(8):
            v.sess.step(0.0)
        torch.cuda.synchronize()
        out["session_ms_per_frame"] = (time.perf_counter() - t) / 8 * 1e3
        frames_before = stats()["frames"]
        get("/set?animate=1&progressive=1")
        v.step_once()
        out["toggle"] = {"frames_before": frames_before,
                         "frames_after": stats()["frames"],
                         "animate": stats()["animate"]}
        get("/set?animate=0&progressive=1")
        v.step_once()
        v.step_once()
        zero_launches()
        get("/set?backend=plain")
        v.step_once()
        plain = {"backend": stats()["backend"], "frames": stats()["frames"],
                 "launches": launched()}
        get("/set?backend=cuda")
        v.step_once()
        back = {"backend": stats()["backend"], "frames": stats()["frames"],
                "launches": launched()}
        out["g_round_trip"] = {"plain": plain, "cuda": back,
                               "backends": stats()["backends"]}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    # --batch 8 against 8 single steps (a static view: the same time)
    args.batch = 8
    vb, _ = make_viewer(args)
    args.batch = 1
    vs, _ = make_viewer(args)
    vb.time_scale = vs.time_scale = 0.0
    zero_launches()
    vb.step_once()
    torch.cuda.synchronize()
    batch_launches = launched()
    rays_single = 0
    for _ in range(8):
        vs.step_once()
    torch.cuda.synchronize()
    out["batch8"] = {
        "frames": vb.sess.state.frame,
        "bit_equal": bool(torch.equal(vb.sess.state.accum,
                                      vs.sess.state.accum)),
        "rays_per_frame_batched": vb.timer.averages()[1],
        "rays_per_frame_single": vs.timer.averages()[1],
        "launches": batch_launches, "hud_mray_s": vb.timer.mray_s(),
        "hud_ms_per_frame": vb.timer.averages()[0] * 1e3}
    # --scaled: the cooperative scaled render kernel, one launch a frame
    args.scaled = 100_000
    t = time.perf_counter()
    vsc, sc_label = make_viewer(args)
    vsc.time_scale = 0.0
    zero_launches()
    for _ in range(2):
        vsc.step_once()
    torch.cuda.synchronize()
    out["scaled"] = {"backend": sc_label, "frames": vsc.sess.state.frame,
                     "launches": launched(),
                     "finite": bool(torch.isfinite(
                         vsc.sess.state.accum).all()),
                     "hud_mray_s": vsc.timer.mray_s(),
                     "seconds": time.perf_counter() - t}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    check(out["launches"] == {"render": n},
          f"viewer: {out['launches']} for {n} frames")
    check(out["frames"] == n and out["png_equal"],
          "viewer: /frame.png and /stats")
    check(out["toggle"]["frames_after"] == 1 and out["toggle"]["animate"],
          f"viewer toggle: {out['toggle']}")
    check(plain["backend"] == "plain" and plain["frames"] == 1
          and not plain["launches"], f"viewer g to plain: {plain}")
    check(back["backend"] == "cuda" and back["frames"] == 1
          and back["launches"] == {"render": 1},
          f"viewer g back to the kernel: {back}")
    b8 = out["batch8"]
    check(b8["frames"] == 8 and b8["bit_equal"]
          and b8["rays_per_frame_batched"] == b8["rays_per_frame_single"]
          and b8["launches"] == {"render": 8}, f"viewer batch 8: {b8}")
    check(out["scaled"]["launches"] == {"scaled_render": 2}
          and out["scaled"]["finite"], f"viewer scaled: {out['scaled']}")
    check(out["hud_mray_s"] > 0, "viewer HUD")
    return out


def resume_phase(smi):
    """Resume at 1280x720 on the card: the CLI's 2 frames, --save-state,
    --resume and 2 more equal to 4 straight frames (image bytes, the int64
    rays); InverseRenderer's 2 Adam steps, the train state saved and
    loaded, 2 more equal to 4 straight steps bit for bit (K3's warp form);
    a train state in the JAX package's layout, written on the host, loaded
    onto the card."""
    import json as _json
    import os
    import re
    import tempfile

    import numpy as np

    from toypathtracer_torch import RenderConfig, make_scene
    from toypathtracer_torch import checkpoint as ckpt
    from toypathtracer_torch.cli import main as cli_main
    from toypathtracer_torch.inverse import InverseRenderer
    from toypathtracer_torch.ops import cuda_render
    from toypathtracer_torch.ops.cuda_grad import PARAM_FIELDS

    t_phase = time.perf_counter()
    out = {"phase": "resume", "nvidia_smi": smi,
           "size": "1280x720, spp 4, depth 10, 46 spheres"}
    tmp = tempfile.mkdtemp(prefix="resume_")

    def cli(name, *extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["--output", os.path.join(tmp, name + ".png"),
                           *extra])
        check(rc == 0, f"CLI {name}")
        m = re.search(r"frames \d+-\d+: (\d+) rays", buf.getvalue())
        with open(os.path.join(tmp, name + ".png"), "rb") as f:
            return f.read(), int(m.group(1))

    zero_launches()
    s1, s2, s4 = (os.path.join(tmp, k + ".npz") for k in ("s1", "s2", "s4"))
    _, rays12 = cli("a", "--frames", "2", "--save-state", s1)
    png_b, rays34 = cli("b", "--frames", "2", "--resume", s1,
                        "--save-state", s2)
    png_c, rays_all = cli("c", "--frames", "4", "--save-state", s4)
    cli_launches = launched()
    a = ckpt.load_frame_state(s2)
    b = ckpt.load_frame_state(s4)
    out["cli"] = {"png_equal": png_b == png_c, "rays_1_2": rays12,
                  "rays_3_4": rays34, "rays_straight": rays_all,
                  "accum_bit_equal": bool(torch.equal(a.accum, b.accum)),
                  "frames": [a.frame, b.frame], "launches": cli_launches}

    cfg = RenderConfig()
    scene = make_scene(big=True)
    target, _ = cuda_render.render_frame(scene, cfg, 0)
    start = scene.replace(albedo=scene.albedo * 0.7)

    def renderer():
        return InverseRenderer(cfg, target, trainable=("albedo",),
                               learning_rate=0.02)
    zero_launches()
    t = time.perf_counter()
    straight, losses = renderer().fit(start, 4)
    torch.cuda.synchronize()
    straight_s = time.perf_counter() - t
    r = renderer()
    half, first = r.fit(start, 2)
    path = os.path.join(tmp, "train")
    ckpt.save_train_state(path, half, r.opt_state, step=2)
    loaded, state, step = ckpt.load_train_state(path)
    resumed, second = renderer().fit(loaded, 2, frame0=step,
                                     opt_state=state)
    torch.cuda.synchronize()
    fit_launches = launched()
    out["train"] = {
        "steps": "4 straight; 2, saved, loaded, 2",
        "losses_equal": first + second == losses, "losses": losses,
        "fields_bit_equal": {f: bool(torch.equal(getattr(resumed, f),
                                                 getattr(straight, f)))
                             for f in PARAM_FIELDS},
        "ms_per_step": straight_s / 4 * 1e3, "launches": fit_launches,
        "state_device": str(state["albedo"][0].device)}

    # the JAX package's layout (toypathtracer_tpu/checkpoint.py:84-97),
    # written with numpy alone: the scene's .npz with its JSON meta, the
    # Adam leaves in optax's flatten order
    jpath = os.path.join(tmp, "jax_layout")
    small = make_scene(big=False)
    cam = {k: list(v) if isinstance(v, tuple) else v
           for k, v in vars(small.camera).items()}
    meta = dict(mat_type=list(small.mat_type),
                emissive_ids=list(small.emissive_ids), camera=cam)
    arrays = {f: getattr(small, f).numpy() for f in PARAM_FIELDS}
    np.savez(jpath + ".scene.npz", **arrays, meta=np.frombuffer(
        _json.dumps(meta).encode(), dtype=np.uint8))
    rng = np.random.default_rng(0)
    leaves = [np.asarray(3, np.int32)] + [
        rng.normal(size=arrays[f].shape).astype(np.float32)
        for f in PARAM_FIELDS * 2]
    np.savez(jpath + ".opt.npz", step=np.int64(3),
             **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    js, jstate, jstep = ckpt.load_train_state(jpath)
    n = len(PARAM_FIELDS)
    out["jax_layout"] = {
        "step": jstep, "count": jstate["count"],
        "on_card": all(getattr(js, f).is_cuda for f in PARAM_FIELDS)
        and all(jstate[f][0].is_cuda for f in PARAM_FIELDS),
        "values_equal": all(
            np.array_equal(jstate[f][0].cpu().numpy(), leaves[1 + i])
            and np.array_equal(jstate[f][1].cpu().numpy(), leaves[1 + n + i])
            and np.array_equal(getattr(js, f).cpu().numpy(), arrays[f])
            for i, f in enumerate(PARAM_FIELDS))}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    c = out["cli"]
    check(c["png_equal"] and c["accum_bit_equal"] and c["frames"] == [4, 4]
          and c["rays_1_2"] + c["rays_3_4"] == c["rays_straight"],
          f"resume CLI: {c}")
    check(cli_launches == {"render": 8}, f"resume CLI launches: "
          f"{cli_launches}")
    tr = out["train"]
    check(tr["losses_equal"] and all(tr["fields_bit_equal"].values()),
          f"resumed fit: {tr}")
    check(fit_launches == {"render": 8, "grad": 8},
          f"resumed fit launches: {fit_launches}")
    j = out["jax_layout"]
    check(j["step"] == 3 and j["count"] == 3 and j["on_card"]
          and j["values_equal"], f"JAX-layout train state: {j}")
    return out


def stats_phases(cfg, smi, k1, usage):
    """Phases 11-12: the stats render kernel (K2: its merged form on the
    main path and the per-thread form it replaced, the baseline) against
    the render kernel, each other and the plain version, and its main
    path, the occupancy tool at full size.  `k1` carries K1's bound terms
    from phase 4; `usage` is phase 1's -Xptxas -v table.  Returns K2's
    entries of the `kernels` line."""
    from toypathtracer_torch import make_scene
    from toypathtracer_torch.ops import cuda_render
    from toypathtracer_torch.profiling import time_device_call
    from toypathtracer_torch.render.wavefront import render_tile_stats_plain
    from toypathtracer_torch.tools import occupancy
    from toypathtracer_torch.tools.scenes import crowded_scene

    dev = torch.device("cuda")
    scene_d = make_scene(big=True).to(dev)

    def agreement(c, cnt_k, cnt_p):
        """Pixels whose trip counts differ, and the tiles and warps whose
        counters differ where none of their pixels does."""
        bad = torch.zeros_like(cnt_k.bounces, dtype=torch.bool)
        for a, b in zip(cnt_k[:3], cnt_p[:3]):
            bad |= a != b
        gh, gw = bad.shape[0] // c.tile_h, bad.shape[1] // c.tile_w
        tile_bad = bad.reshape(gh, c.tile_h, gw, c.tile_w).any(3).any(1)
        it_k, wk_k = cuda_render.tile_counters(cnt_k, c)
        it_p, wk_p = cuda_render.tile_counters(cnt_p, c)
        tiles = (it_k != it_p) | (wk_k != wk_p)
        wr, wc = cnt_k.warp_iters.shape
        wbad = torch.zeros((2 * wr, 16 * wc), dtype=torch.bool, device=dev)
        wbad[:bad.shape[0], :bad.shape[1]] = bad
        warp_bad = wbad.reshape(wr, 2, wc, 16).any(3).any(1)
        warps = ((cnt_k.warp_iters != cnt_p.warp_iters)
                 | (cnt_k.warp_work != cnt_p.warp_work))
        return {"pixels": bad.numel(), "pixel_mismatch": int(bad.sum()),
                "pixel_mismatch_frac": float(bad.double().mean()),
                "tiles": tiles.numel(), "tiles_differ": int(tiles.sum()),
                "tiles_differ_unexplained": int((tiles & ~tile_bad).sum()),
                "warps": warps.numel(), "warps_differ": int(warps.sum()),
                "warps_differ_unexplained": int((warps & ~warp_bad).sum()),
                "iters_sum": [int(it_k.sum()), int(it_p.sum())],
                "work_sum": [int(wk_k.sum()), int(wk_p.sum())]}

    def counter_gates(what, a):
        check(a["pixel_mismatch_frac"] <= 1e-4, f"{what}: trip counts")
        check(a["tiles_differ_unexplained"] == 0, f"{what}: tile counters")
        check(a["warps_differ_unexplained"] == 0, f"{what}: warp counters")

    def planes_equal(a, b):
        return all(x.shape == y.shape and bool(torch.equal(x, y))
                   for x, y in zip(a, b))

    # ---- 11. K2 vs K1, its per-thread form and plain, small size ---------
    small = cfg.replace(width=320, height=176, samples_per_pixel=2,
                        max_depth=6)
    cases = {"tile16x128": (scene_d, small),
             "tile32x128_ppl2_merged": (scene_d, small.replace(
                 tile_h=32, pix_per_lane=2, merged_wavefront=True)),
             "crowded_600": (crowded_scene(extra=554).to(dev), small)}
    small_mismatch = 0.0
    forms_equal = {}
    for name, (sc, c) in cases.items():
        for frame in range(2):
            t1 = time.perf_counter()
            img_s, rays_s, cnt_k = cuda_render.render_tile_stats(sc, c,
                                                                 frame)
            img_1, rays_1 = cuda_render.render_tile(sc, c, frame, 0, 0,
                                                    c.height, c.width)
            img_p, rays_p, cnt_p = render_tile_stats_plain(sc, c, frame)
            r = {"phase": "stats_vs_plain", "case": name, "frame": frame,
                 "spheres": sc.n_spheres, "grid": list(cnt_k.bounces.shape)}
            if sc.n_spheres <= cuda_render.MAX_SPHERES:
                img_t, rays_t, cnt_t = cuda_render.render_tile_stats_form(
                    sc, c, frame, "thread")
                r["bit_equal_to_thread_form"] = bool(
                    torch.equal(img_s, img_t)) and int(rays_s) == int(rays_t)
                r["counters_equal_to_thread_form"] = planes_equal(cnt_k,
                                                                  cnt_t)
                forms_equal[f"{name}_frame{frame}"] = (
                    r["bit_equal_to_thread_form"]
                    and r["counters_equal_to_thread_form"])
            torch.cuda.synchronize()
            a = agreement(c, cnt_k, cnt_p)
            small_mismatch = max(small_mismatch, a["pixel_mismatch_frac"])
            r.update({"bit_equal_to_render_kernel": bool(torch.equal(img_s,
                                                                     img_1)),
                      "rays_equal_to_render_kernel": int(rays_s)
                      == int(rays_1),
                      **compare(img_s, rays_s, img_p, rays_p), **a,
                      "seconds": time.perf_counter() - t1})
            emit(r)
            what = f"K2 {name} frame {frame}"
            check(r["bit_equal_to_render_kernel"]
                  and r["rays_equal_to_render_kernel"], f"{what}: != K1")
            check(r["finite"] and r["rays_rel_diff"] <= 5e-4
                  and r["mean_abs_diff"] <= 1e-3, f"{what}: image vs plain")
            if "bit_equal_to_thread_form" in r:
                check(forms_equal[f"{name}_frame{frame}"],
                      f"{what}: the merged form != the per-thread form")
            counter_gates(what, a)

    # ---- 12. the occupancy tool's path at full size ---------------------
    t1 = time.perf_counter()
    for k in cuda_render.launches:
        cuda_render.launches[k] = 0
    occ = occupancy.main([])
    torch.cuda.synchronize()
    occ_launches = dict(cuda_render.launches)
    check(occ_launches == {"render": 0, "render_baseline": 0,
                           "render_counted": 0, "render_stats": 1,
                           "render_stats_baseline": 0},
          f"occupancy path launched {occ_launches}")
    tpu = {"rays": 16772198,               # docs/measured/tpu_parity.json:49
           "work_lane_bounces": 9320687,   # docs/measured/occupancy.json
           "iters_sum": 10823}
    rel = {"rays": abs(occ["rays"] - tpu["rays"]) / tpu["rays"],
           "work_lane_bounces": abs(occ["work_lane_bounces"]
                                    - tpu["work_lane_bounces"])
           / tpu["work_lane_bounces"],
           "iters_sum": abs(occ["iters"]["sum"] - tpu["iters_sum"])
           / tpu["iters_sum"]}
    plain_s, (img_p, rays_p, cnt_p) = time_device_call(
        render_tile_stats_plain, scene_d, cfg, 0)
    img_k, rays_k, cnt_k = cuda_render.render_tile_stats(scene_d, cfg, 0)
    img_t, rays_t, cnt_t = cuda_render.render_tile_stats_form(scene_d, cfg,
                                                              0, "thread")
    torch.cuda.synchronize()
    full = compare(img_k, rays_k, img_p, rays_p)
    a = agreement(cfg, cnt_k, cnt_p)
    full_forms_equal = (bool(torch.equal(img_k, img_t))
                        and int(rays_k) == int(rays_t)
                        and planes_equal(cnt_k, cnt_t))
    forms_equal["1280x720"] = full_forms_equal
    # K2's two forms in turns with the merged K1: K1, K2, K2 per-thread,
    # K2 per-thread, K2, K1
    fns = {"render": (cuda_render.render_tile,
                      (scene_d, cfg, 0, 0, 0, cfg.height, cfg.width)),
           "render_stats": (cuda_render.render_tile_stats, (scene_d, cfg, 0)),
           "render_stats_baseline": (cuda_render.render_tile_stats_form,
                                     (scene_d, cfg, 0, "thread"))}
    times = {k: [] for k in fns}
    for name in ("render", "render_stats", "render_stats_baseline",
                 "render_stats_baseline", "render_stats", "render"):
        fn, args = fns[name]
        times[name].append(time_device_call(fn, *args, repeats=16)[0] * 1e3)
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    eff_plain = float(cnt_p.warp_work.double().sum()
                      / (32 * cnt_p.warp_iters.double().sum()))
    # bound: K1's operations and bytes (phase 4, the same frame) plus the
    # counters: two operations a sample per warp unit (its maximum and its
    # sum), and the counters written
    n_warps = cnt_k.warp_iters.numel()
    ops = k1["ops"] + 2 * cfg.samples_per_pixel * n_warps
    n_bytes = (k1["bytes"] + 4 * 3 * cnt_k.bounces.numel()
               + 4 * 2 * n_warps)
    bound_ms = max(ops / 67e12, n_bytes / 3.35e12) * 1e3
    bound_by = "operations" if ops / 67e12 >= n_bytes / 3.35e12 else "bytes"
    r = {"phase": "occupancy_path", "nvidia_smi": smi,
         "launches": occ_launches, "occupancy": occ,
         "tpu": tpu, "rel_vs_tpu": rel, "vs_plain": full, **a,
         "forms_equal_1280x720": full_forms_equal,
         "k1_ms": ms["render"], "k2_ms": ms["render_stats"],
         "k2_baseline_ms": ms["render_stats_baseline"], "ms_runs": times,
         "k2_over_k1": ms["render_stats"] / ms["render"],
         "k2_over_baseline": ms["render_stats"] / ms["render_stats_baseline"],
         "k1_warp_efficiency_kernel": occ["warp"]["efficiency"],
         "k1_warp_efficiency_plain": eff_plain,
         "plain_ms": plain_s * 1e3, "bound_fp32_ops": ops,
         "bound_bytes": n_bytes, "bound_ms": bound_ms,
         "seconds": time.perf_counter() - t1}
    emit(r)
    check(rel["rays"] <= 5e-4, "occupancy rays vs the TPU's")
    check(rel["work_lane_bounces"] <= 5e-4, "occupancy work vs the TPU's")
    check(rel["iters_sum"] <= 5e-3, "occupancy iters vs the TPU's")
    check(full["finite"] and full["rays_rel_diff"] <= 5e-4
          and full["mean_abs_diff"] <= 1e-3, "K2 full frame vs plain")
    check(full_forms_equal, "K2 full frame: the merged form != the "
                            "per-thread form")
    counter_gates("K2 full frame", a)
    tol = ("image and rays bit-equal to K1's; trip counts equal on all but "
           "1e-4 of the pixels, tile and warp counters equal where their "
           "pixels' counts are; image vs plain as K1's gates")
    return [
        {"name": "render_stats", "route": "cuda",
         "source": "toypathtracer_torch/csrc/render.cu",
         "replaces": "toypathtracer_tpu/ops/pallas_render.py:337",
         "launches": occ_launches["render_stats"],
         "max_abs_err": full["max_abs_diff"], "ms": ms["render_stats"],
         "plain_ms": plain_s * 1e3, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": None,
         "form": "merged (merged_render_kernel<2>: csrc/merged.cuh TripStats)",
         "baseline_ms": ms["render_stats_baseline"],
         "baseline": "the per-thread stats kernel it replaced "
                     "(render_kernel<1>), timed in turns with it",
         "k1_ms": ms["render"],
         "ptxas": usage.get("merged_render_kernel<2>", {}),
         "vs_plain": {"tolerance": tol + "; image, rays and the five "
                                         "counter planes equal to the "
                                         "per-thread form's",
                      "pixel_mismatch_frac_320x176": small_mismatch,
                      "pixel_mismatch_frac_1280x720":
                          a["pixel_mismatch_frac"],
                      "tiles_differ": a["tiles_differ"],
                      "warps_differ": a["warps_differ"],
                      "equal_to_thread_form": forms_equal}},
        {"name": "render_stats_baseline", "route": "cuda",
         "source": "toypathtracer_torch/csrc/render.cu",
         "replaces": "toypathtracer_tpu/ops/pallas_render.py:337",
         "launches": occ_launches["render_stats_baseline"],
         "max_abs_err": float((img_t - img_p).abs().max()),
         "ms": ms["render_stats_baseline"], "plain_ms": plain_s * 1e3,
         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
         "form": "thread (render_kernel<1>)",
         "baseline": "the per-thread stats kernel, kept beside the merged "
                     "one as its A/B and equality baseline; not on the main "
                     "path",
         "ptxas": usage.get("render_kernel<1>", {}),
         "vs_plain": {"tolerance": "bit-equal to the merged form"}}]


def probe_phases(smi):
    """Phase 13: the issue-rate probe (T1) and its launch floor (T2)
    against their plain versions, then the roofline tool's main path.
    Returns their entries of the `kernels` line."""
    from toypathtracer_torch.profiling import time_device_call
    from toypathtracer_torch.tools import roofline

    dev = torch.device("cuda")
    t1 = time.perf_counter()
    n = roofline.grid_blocks(1) * roofline.THREADS
    checks = {}
    for case in roofline.CASES:
        out = torch.empty(n, device=dev)
        k_s, _ = time_device_call(roofline.issue_rate, case, out, 64)
        p_s, want = time_device_call(roofline.chains_plain, case, 64, n, dev)
        err = (out - want).abs()
        checks[case] = {"max_abs_err": float(err.max()),
                        "max_rel_err": float((err / want.abs()).max()),
                        "ms_k64": k_s * 1e3, "plain_ms_k64": p_s * 1e3,
                        "finite": bool(torch.isfinite(out).all())}
        check(checks[case]["finite"] and checks[case]["max_rel_err"] <= 1e-6,
              f"issue_rate {case} vs plain at 64 trips")
    big = roofline.grid_blocks(max(c.waves for c in roofline.CASES.values()))
    out = torch.empty(big * roofline.THREADS, device=dev)
    f_s, _ = time_device_call(roofline.launch_floor, out)
    fp_s, want = time_device_call(roofline.chains_plain, "fma", 1,
                                  out.numel(), dev)
    floor_err = float((out - want).abs().max())
    del want
    check(floor_err == 0.0, "launch floor vs plain")
    emit({"phase": "issue_rate_vs_plain", "threads": n, "trips": 64,
          "tolerance": "max relative error <= 1e-6", "cases": checks,
          "launch_floor": {"threads": out.numel(), "max_abs_err": floor_err,
                           "ms": f_s * 1e3, "plain_ms": fp_s * 1e3},
          "seconds": time.perf_counter() - t1})

    t1 = time.perf_counter()
    for k in roofline.launches:
        roofline.launches[k] = 0
    res = roofline.main([])
    torch.cuda.synchronize()
    launches = dict(roofline.launches)
    cases = res["cases"]
    main_checks = {**{k: v["vs_plain"] for k, v in cases.items()},
                   **{f"floor_{w}_waves": f["vs_plain"]
                      for w, f in res["floors"].items()}}
    emit({"phase": "issue_rate", "nvidia_smi": smi, "launches": launches,
          "vs_plain": main_checks,
          "sm_clock_mhz_under_load": res["sm_clock_mhz_under_load"],
          "sm_clock_max_mhz": res["sm_clock_max_mhz"],
          "floors": res["floors"],
          "ops_per_s": {k: v["ops_per_s"] for k, v in cases.items()},
          "fma_flops_per_s": res["fma_flops_per_s"],
          "fma_vs_fp32_peak": res["fma_vs_fp32_peak"],
          "bound_share": {k: v["bound_s"] / (v["best_time_s"] - v["floor_s"])
                          for k, v in cases.items() if v["bound_s"]},
          "seconds": time.perf_counter() - t1})
    check(launches["issue_rate"] > 0 and launches["launch_floor"] > 0,
          f"roofline path launched {launches}")
    for k, v in main_checks.items():
        check(v["finite"] and v["max_rel_err"] <= 1e-6,
              f"roofline path {k} vs plain, every thread at "
              f"{v['trips']} trips")
    check(all(0 < v["ops_per_s"] < 1e15 for v in cases.values()),
          "issue rates out of range")
    check(all(0 < f["event_s"] < 1 and 0 < f["host_s"] < 1
              for f in res["floors"].values()), "launch floors out of range")
    check(res["bound_clock_mhz"] is not None, "no SM clock from nvidia-smi")
    floors = res["floors"]
    top = str(max(int(w) for w in floors))
    return [
        {"name": "issue_rate", "route": "cuda",
         "source": "toypathtracer_torch/csrc/probe.cu",
         "replaces": "tools/vpu_roofline.py:125",
         "launches": launches["issue_rate"],
         "max_abs_err": max(c["max_abs_err"] for c in (
             *checks.values(), *(v["vs_plain"] for v in cases.values()))),
         "ms": sum(v["best_time_s"] for v in cases.values()) * 1e3,
         "plain_ms": sum(c["plain_ms_k64"] for c in checks.values()),
         "bound_ms": sum(v["bound_s"] for v in cases.values()) * 1e3,
         "bound_by": "operations", "library_ms": None,
         "ms_per_case": {k: v["best_time_s"] * 1e3 for k, v in cases.items()},
         "bound_ms_per_case": {k: v["bound_s"] * 1e3
                               for k, v in cases.items()},
         "note": "ms and bound_ms: one full-size launch of each of the six "
                 "cases (K=2048 trips, each case's grid), summed; plain_ms: "
                 "64 trips on one wave of threads, beside the kernel's ms "
                 "there (vs_plain); max_abs_err: over those and every "
                 "thread of the full-size launches",
         "vs_plain": {"tolerance": "max relative error <= 1e-6",
                      "cases_64_trips": checks,
                      "cases_main_path": {k: v["vs_plain"]
                                          for k, v in cases.items()}}},
        {"name": "launch_floor", "route": "cuda",
         "source": "toypathtracer_torch/csrc/probe.cu",
         "replaces": "tools/vpu_roofline.py:162",
         "launches": launches["launch_floor"],
         "max_abs_err": max(floor_err, *(f["vs_plain"]["max_abs_err"]
                                         for f in floors.values())),
         "ms": floors[top]["event_s"] * 1e3, "plain_ms": fp_s * 1e3,
         "bound_ms": 4 * out.numel() / 3.35e12 * 1e3, "bound_by": "bytes",
         "library_ms": None,
         "ms_per_grid": {w: f["event_s"] * 1e3 for w, f in floors.items()},
         "host_ms_per_grid": {w: f["host_s"] * 1e3
                              for w, f in floors.items()},
         "note": f"ms: the event floor of the {top}-wave grid "
                 f"({out.numel()} threads); bound: its output written once",
         "vs_plain": {"tolerance": "bit-equal", "max_abs_err": floor_err}}]


if __name__ == "__main__":
    sys.exit(main())
