"""CPU-parity renderer: the reference's scalar C++ semantics in plain
PyTorch (counterpart of toypathtracer_tpu/render/parity.py).

Where the render kernel follows the reference's GPU ports, this renderer
replays its CPU core (Cpp/Source/Test.cpp:195-300, Maths.cpp:20-47), so
that its image can be held against a compiled build of the reference
itself (tests/golden/*.npz, written by tools/gen_golden.py):

  * per-ROW RNG seeding `(y*9781 + frame*6271) | 1`, the state threaded
    through every pixel and sample of the row in turn (Test.cpp:280);
  * rejection-loop disk and sphere samplers with a variable draw count,
    and the C library's sinf/cosf (ops/tracecore.CPU_SAMPLERS);
  * the recursion's extra depth == kMaxDepth level with ungated emission,
    and radiance folded backward as the recursion multiplies it
    (tracecore.trace_cpu_exact).

Image rows are the lanes, and each row runs its pixels and samples in
turn (the RNG dependency chain) as a persistent loop: a lane whose path
ends starts its next sample, or its next pixel, at the next step, without
waiting for the other rows' paths (the JAX package runs the rows in
lockstep, pixel by pixel).  Each lane draws and computes exactly what the
row's scalar loop does, so the image is the same; the loop takes about as
many steps as the longest row has bounces, instead of the sum over pixels
of the longest path.  render_frame_parity_pp seeds every pixel on its own
(the reference's GPU formula) and makes every pixel a lane.  The JAX
package has no kernel for this route either: it exists to validate, and
is slow by design.  Use render/frame.py's session or the render kernel
for real work.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..config import RenderConfig, resolve_device
from ..ops import tracecore as tc
from ..ops.cuda_render import pack_scene
from ..scene import Scene
from .wavefront import camera_scalars


def _inputs(scene: Scene, cfg: RenderConfig, device):
    scene = scene.to(resolve_device(device))
    mat = torch.tensor(scene.mat_type, dtype=torch.int64,
                       device=scene.device)
    return scene, pack_scene(scene), mat, camera_scalars(scene, cfg)


def _samples(tab, mat, scene: Scene, cfg: RenderConfig, cam: dict, fx, fy,
             state):
    """spp samples of one pixel per lane from `state`: the reference's
    sample loop (Test.cpp:283-292).  Returns (col vec3, state, int64
    rays)."""
    inv_w = float(np.float32(cfg.inv_width))
    inv_h = float(np.float32(cfg.inv_height))
    zero = torch.zeros_like(fy)
    col = (zero, zero, zero)
    rays = torch.zeros(fy.shape, dtype=torch.int64, device=fy.device)
    for _ in range(cfg.samples_per_pixel):
        state, ur = tc.rand01(state)
        u = (fx + ur) * inv_w
        state, vr = tc.rand01(state)
        v = (fy + vr) * inv_h
        state, ro, rd = tc.camera_get_ray(cam, u, v, state, tc.CPU_SAMPLERS)
        c, state, rc = tc.trace_cpu_exact(tab, mat, scene.emissive_ids, cfg,
                                          ro, rd, state)
        col = tc.add3(col, c)
        rays = rays + rc
    col = tc.scale3(col, float(np.float32(1.0 / cfg.samples_per_pixel)))
    return col, state, rays


def render_frames_parity(scenes: Union[Scene, Sequence[Scene]],
                         cfg: RenderConfig, frames: Sequence[int],
                         device="cuda"):
    """render_frame_parity of several frames at once: the rows of every
    frame are lanes of the same loop, each with its own seed, so each
    row's values are those of its frame rendered alone.  `scenes` is one
    Scene for every frame, or one per frame (an animated sequence: the
    scenes share materials, lights and camera, and each lane reads its own
    frame's table, tracecore.sphere_row).  Returns a list of (image, ray
    count) in the order of `frames`."""
    h, w, spp, depth = (cfg.height, cfg.width, cfg.samples_per_pixel,
                        cfg.max_depth)
    n = len(frames) * h
    if isinstance(scenes, Scene):
        scene, tab, mat, cam = _inputs(scenes, cfg, device)
    else:
        if len(scenes) != len(frames):
            raise ValueError(f"{len(scenes)} scenes for {len(frames)} "
                             "frames")
        first = scenes[0]
        for other in scenes[1:]:
            if (other.mat_type, other.emissive_ids, other.camera) != \
                    (first.mat_type, first.emissive_ids, first.camera):
                raise ValueError("the scenes of one parity batch must "
                                 "share materials, lights and camera")
        scene, _, mat, cam = _inputs(first, cfg, device)
        tabs = torch.stack([pack_scene(sc.to(scene.device))
                            for sc in scenes], dim=1)
        tab = tabs.repeat_interleave(h, dim=1).contiguous()
    dev = scene.device
    ys = torch.arange(h, dtype=torch.int64, device=dev).repeat(len(frames))
    fr = torch.tensor([int(f) & tc.MASK32 for f in frames],
                      dtype=torch.int64, device=dev).repeat_interleave(h)
    state = ((ys * 9781 + fr * 6271) & tc.MASK32) | 1
    fy = ys.to(torch.float32)
    inv_w = float(np.float32(cfg.inv_width))
    inv_h = float(np.float32(cfg.inv_height))
    inv_spp = float(np.float32(1.0 / spp))
    lanes = torch.arange(n, device=dev)
    izero = torch.zeros(n, dtype=torch.int64, device=dev)
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    false = torch.zeros(n, dtype=torch.bool, device=dev)
    x, s, d = izero, izero, izero    # pixel, sample, next part's depth
    alive, do_me, done = false, false, false
    ro = rd = col_sum = (zero, zero, zero)
    work = tc.Work(izero, izero, izero)
    # each sample's parts (e, c) by depth, the tail's at max_depth; a
    # depth the path did not reach keeps (0, 1), as a dead lane's part
    e_parts = torch.zeros((depth + 1, 3, n), dtype=torch.float32, device=dev)
    c_parts = torch.ones_like(e_parts)
    img = torch.zeros((n, w, 3), dtype=torch.float32, device=dev)
    while True:
        start = ~done & ~alive
        if bool(start.any()):
            st, ur = tc.rand01(state)
            u = (x.to(torch.float32) + ur) * inv_w
            st, vr = tc.rand01(st)
            v = (fy + vr) * inv_h
            st, ro2, rd2 = tc.camera_get_ray(cam, u, v, st, tc.CPU_SAMPLERS,
                                             active=start)
            state = torch.where(start, st, state)
            ro = tc.sel3(start, ro2, ro)
            rd = tc.sel3(start, rd2, rd)
            alive = alive | start
            do_me = do_me | start
            d = torch.where(start, 0, d)
            e_parts = torch.where(start, 0.0, e_parts)
            c_parts = torch.where(start, 1.0, c_parts)
        bouncing = alive & (d < depth)
        tailing = alive & (d == depth)
        (ro, rd, scat, do_me, state, work), e, c = tc.bounce(
            tab, mat, scene.emissive_ids, cfg,
            (ro, rd, bouncing, do_me, state, work), samplers=tc.CPU_SAMPLERS,
            skip_empty=True)
        if bool(tailing.any()):
            (_, _, _, _, _, work), e_t, _ = tc.tail_parts(
                tab, mat, cfg, (ro, rd, tailing, do_me, state, work))
            e = tc.sel3(tailing, e_t, e)
            c = tc.sel3(tailing, (zero, zero, zero), c)
        slot = d.clamp(max=depth)
        e_parts[slot, :, lanes] = torch.stack(e, dim=1)
        c_parts[slot, :, lanes] = torch.stack(c, dim=1)
        ended = (bouncing & ~scat) | tailing
        alive = scat
        d = torch.where(bouncing, d + 1, d)
        if bool(ended.any()):
            # radiance folded backward, as the recursion multiplies it
            col = torch.zeros((3, n), dtype=torch.float32, device=dev)
            for k in range(depth, -1, -1):
                col = e_parts[k] + c_parts[k] * col
            col_sum = tc.sel3(ended, tc.add3(col_sum, tuple(col)), col_sum)
            s = torch.where(ended, s + 1, s)
            fin = ended & (s == spp)
            idx = fin.nonzero().squeeze(1)
            if idx.numel():
                avg = torch.stack(tc.scale3(col_sum, inv_spp), dim=-1)
                img[idx, x[idx]] = avg[idx]
                col_sum = tc.sel3(fin, (zero, zero, zero), col_sum)
                s = torch.where(fin, 0, s)
                x = torch.where(fin, x + 1, x)
                done = x == w
                if bool(done.all()):
                    break
    rays = work.traced + work.shadow
    return [(img[k * h:(k + 1) * h], rays[k * h:(k + 1) * h].sum())
            for k in range(len(frames))]


def render_frame_parity(scene: Scene, cfg: RenderConfig, frame: int,
                        device="cuda"):
    """One frame with the reference's CPU-scalar semantics on `device`
    (default: the card; "cpu" with the C library's trig).  Returns
    ((H, W, 3) float32 with row 0 at the bottom, 0-d int64 ray count),
    directly comparable to the reference oracle's backbuffer."""
    return render_frames_parity(scene, cfg, [frame], device)[0]


def render_frame_parity_pp(scene: Scene, cfg: RenderConfig, frame: int,
                           device="cuda"):
    """CPU-scalar semantics with PER-PIXEL seeding (the reference's GPU
    formula, ComputeShader.hlsl:380): the oracle of tools/gen_golden.py
    with pixel_seed=True.  Every pixel is an independent RNG stream and a
    lane, so a flipped rejection-loop branch changes only its own pixel.
    Returns ((H, W, 3) float32, 0-d int64 ray count), on `device` (default:
    the card)."""
    scene, tab, mat, cam = _inputs(scene, cfg, device)
    dev = scene.device
    yy, xx = torch.meshgrid(
        torch.arange(cfg.height, dtype=torch.int64, device=dev),
        torch.arange(cfg.width, dtype=torch.int64, device=dev),
        indexing="ij")
    px, py = xx.reshape(-1), yy.reshape(-1)
    col, _, rays = _samples(tab, mat, scene, cfg, cam, px.to(torch.float32),
                            py.to(torch.float32),
                            tc.seed_pixels(px, py, frame))
    img = torch.stack(col, dim=-1).reshape(cfg.height, cfg.width, 3)
    return img, rays.sum()
