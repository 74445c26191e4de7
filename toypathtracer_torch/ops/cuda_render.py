"""The render kernel's wrappers (counterpart of toypathtracer_tpu/ops/
pallas_render.py).

`render_tile` and `render_frame` launch the hand-written CUDA kernel of
csrc/render.cu (the port of pallas_render.py::_render_kernel) on CUDA
tensors and run the plain PyTorch version (render/wavefront.py) on CPU
tensors.  `render_tile_stats` and `render_frame_stats` do the same for its
stats instance, the counterpart of `render_frame_pallas_stats`: the image,
the rays and the occupancy counters.  There is no fallback: on a CUDA
tensor a failed build or launch raises.  `launches` counts kernel launches
by kernel, so a run can show that its frames went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..camera import camera_to_array, make_camera
from ..config import RenderConfig, resolve_device
from ..scene import Scene
from . import _build

# Largest scene the kernel stages in shared memory (csrc/trace.cuh).
MAX_SPHERES = 512
MAX_LIGHTS = 16

launches = {"render": 0, "render_stats": 0}


def pack_scene(scene: Scene) -> torch.Tensor:
    """Scene -> (SCENE_ROWS, N) float32 table on the scene's device: center
    xyz, radius^2, 1/radius, radius, albedo rgb, emission rgb, roughness,
    ri (pallas_render.py:53-80).  A radius <= 0 (a padded sphere) gets
    1/radius = 0 instead of inf, so normals stay finite."""
    r = scene.radius
    inv_radius = torch.where(r > 0, 1.0 / torch.clamp_min(r, 1e-8), 0.0)
    c, a, e = scene.center, scene.albedo, scene.emissive
    return torch.stack([
        c[:, 0], c[:, 1], c[:, 2], r * r, inv_radius, r,
        a[:, 0], a[:, 1], a[:, 2], e[:, 0], e[:, 1], e[:, 2],
        scene.roughness, scene.ri,
    ]).to(torch.float32).contiguous()


def render_params(scene: Scene, cfg: RenderConfig, frame: int, x0: int,
                  y0: int, height: int, width: int) -> _build.RenderParams:
    """The kernel's scalar arguments (tpt::RenderParams)."""
    f32 = np.float32
    return _build.RenderParams(
        x0=x0, y0=y0, height=height, width=width,
        frame=int(frame) & 0xFFFFFFFF,
        spp=cfg.samples_per_pixel, max_depth=cfg.max_depth,
        light_sampling=int(cfg.do_light_sampling),
        mitsuba=int(cfg.do_mitsuba_compare),
        n_spheres=scene.n_spheres, n_lights=len(scene.emissive_ids),
        inv_w=f32(cfg.inv_width), inv_h=f32(cfg.inv_height),
        inv_spp=f32(1.0 / cfg.samples_per_pixel),
        t_min=f32(cfg.min_t), t_max=f32(cfg.max_t))


def _check_scene(scene: Scene):
    n = scene.n_spheres
    if not 1 <= n <= MAX_SPHERES:
        raise ValueError(f"the render kernel takes 1..{MAX_SPHERES} spheres, "
                         f"got {n}")
    if len(scene.emissive_ids) > MAX_LIGHTS:
        raise ValueError(f"the render kernel takes at most {MAX_LIGHTS} "
                         f"emissive spheres, got {len(scene.emissive_ids)}")
    if any(m not in (0, 1, 2) for m in scene.mat_type):
        raise ValueError(f"material types must be 0, 1 or 2: "
                         f"{scene.mat_type}")
    if any(not 0 <= e < n for e in scene.emissive_ids):
        raise ValueError(f"emissive ids out of range: {scene.emissive_ids}")
    for name in ("center", "radius", "albedo", "emissive", "roughness", "ri"):
        t = getattr(scene, name)
        if t.dtype != torch.float32 or t.shape[0] != n:
            raise ValueError(f"scene.{name} must be float32 with {n} rows, "
                             f"got {t.dtype} {tuple(t.shape)}")


def check_device(scene: Scene, *tensors):
    """Every scene field and every given tensor on the scene's device."""
    dev = scene.device
    for name in ("center", "radius", "albedo", "emissive", "roughness", "ri"):
        if getattr(scene, name).device != dev:
            raise ValueError(f"scene.{name} is on "
                             f"{getattr(scene, name).device}, not {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"a tensor is on {t.device}, not {dev}")


def kernel_inputs(scene: Scene, cfg: RenderConfig):
    """The kernels' static inputs on the scene's device: int32 material
    types, emissive ids and the 22-float camera.  Host data goes up through
    pinned buffers without blocking, so frames queue back to back instead
    of draining the stream at every call."""
    mat = np.array(scene.mat_type, np.int32)
    mat = torch.from_numpy(mat).pin_memory().to(scene.device,
                                                 non_blocking=True)
    return (mat, *kernel_camera(scene, cfg))


def kernel_camera(scene, cfg: RenderConfig):
    """The int32 emissive ids and the 22-float camera on the scene's
    device (a Scene or a ScaledScene), uploaded as kernel_inputs does."""
    dev = scene.device
    ids = np.array(scene.emissive_ids or (0,), np.int32)
    ids = torch.from_numpy(ids).pin_memory().to(dev, non_blocking=True)
    cam = torch.from_numpy(camera_to_array(
        make_camera(scene.camera, cfg.width / cfg.height)))
    cam = cam.pin_memory().to(dev, non_blocking=True)
    return ids, cam


def checked_tab(scene: Scene, x0: int, y0: int, height: int, width: int,
                tab=None) -> torch.Tensor:
    """Validate a kernel call on the (height, width) sub-image at (x0, y0)
    and return the packed table it reads (default pack_scene(scene)):
    (SCENE_ROWS, N) float32, contiguous, detached, on the scene's
    device."""
    _check_scene(scene)
    if not (height >= 1 and width >= 1 and x0 >= 0 and y0 >= 0):
        raise ValueError(f"bad sub-image {height}x{width} at ({x0}, {y0})")
    if tab is None:
        tab = pack_scene(scene)
    if tab.shape != (14, scene.n_spheres) or tab.dtype != torch.float32:
        raise ValueError(f"packed table must be float32 (14, "
                         f"{scene.n_spheres}), got {tab.dtype} "
                         f"{tuple(tab.shape)}")
    check_device(scene, tab)
    return tab.detach().contiguous()


def cuda_call(lib, name: str, code: int):
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({lib.tpt_error_string(code).decode()})")


def launch_forward(kernel: str, scene: Scene, tab: torch.Tensor,
                   cfg: RenderConfig, frame: int, x0: int, y0: int,
                   height: int, width: int, *extra):
    """Launch the forward kernel tpt_<kernel>_launch ("render",
    "render_stats" or "lockstep") on the current stream, with `extra`
    arguments after the ray counter; returns ((height, width, 3) float32
    image, 0-d int64 ray count)."""
    lib = _build.load_library()
    mat, lights, cam = kernel_inputs(scene, cfg)
    dev = scene.device
    out = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    params = render_params(scene, cfg, frame, x0, y0, height, width)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, f"tpt_{kernel}_launch")(
            tab.data_ptr(), mat.data_ptr(), lights.data_ptr(), cam.data_ptr(),
            ctypes.byref(params), out.data_ptr(), rays.data_ptr(), *extra,
            stream)
    cuda_call(lib, kernel, code)
    return out, rays


def render_tile(scene: Scene, cfg: RenderConfig, frame: int, x0: int,
                y0: int, height: int, width: int, tab=None):
    """Render the (height, width) sub-image whose lower-left pixel is the
    global pixel (x0, y0), on the scene's device: the CUDA kernel for a
    scene on a card, the plain PyTorch version for a scene on the CPU.
    `tab` is the packed table to render (default pack_scene(scene)); the
    kernel does not differentiate it (ops/cuda_grad does).

    Returns ((height, width, 3) float32 image, 0-d int64 ray count: every
    camera, bounce and shadow ray of the sub-image's pixels)."""
    tab = checked_tab(scene, x0, y0, height, width, tab)
    if scene.device.type == "cuda":
        out = launch_forward("render", scene, tab, cfg, frame, x0, y0, height,
                             width)
        launches["render"] += 1
        return out
    if scene.device.type == "cpu":
        from ..render.wavefront import render_tile_plain
        return render_tile_plain(scene, cfg, frame, x0, y0, height, width,
                                 tab=tab)
    raise ValueError(f"no renderer for device {scene.device}")


def render_frame(scene: Scene, cfg: RenderConfig, frame: int,
                 device="cuda"):
    """Render one full frame on `device` (default: the card; "cpu" runs
    the plain PyTorch version).  Raises RuntimeError for "cuda" without a
    card.  Returns ((H, W, 3) float32, 0-d int64 ray count)."""
    scene = scene.to(resolve_device(device))
    return render_tile(scene, cfg, frame, 0, 0, cfg.height, cfg.width)


# ---- the stats render (K2) -------------------------------------------------


class StatsCounters(NamedTuple):
    """The stats render's counters, int32 tensors on the scene's device.
    Per pixel of the padded tile grid (grid_h, grid_w): the trip counts
    of csrc/trace.cuh tpt::Trips.  Per warp of the render kernel (16x2
    pixels; row r, column c covers pixel rows 2r, 2r+1 and columns 16c to
    16c+15), over the pixels of the image: `warp_iters`, the sum over
    samples of the warp's deepest lane, and `warp_work`, the lanes'
    bounces summed."""
    bounces: torch.Tensor
    cutoffs: torch.Tensor
    last_cutoff: torch.Tensor
    warp_iters: torch.Tensor
    warp_work: torch.Tensor


def resolve_pix_per_lane(cfg: RenderConfig, pad_h: int, pad_w: int) -> int:
    """The TPU kernel's pixels per lane K for this call
    (pallas_render._resolve_pix_per_lane): cfg.pix_per_lane, or 1 when the
    tile cannot hold K row bands of a multiple of 8 rows."""
    k = cfg.pix_per_lane
    if k <= 1:
        return 1
    if cfg.tile_h % k or (cfg.tile_h // k) % 8:
        return 1
    return k


def padded_grid(cfg: RenderConfig):
    """(grid_h, grid_w): the frame padded up to whole TPU tiles."""
    return (cfg.height + -cfg.height % cfg.tile_h,
            cfg.width + -cfg.width % cfg.tile_w)


def warp_grid(grid_h: int, grid_w: int):
    """Shape of the per-warp counters over a (grid_h, grid_w) launch."""
    return 4 * -(-grid_h // 8), -(-grid_w // 16)


def tile_counters(counters: StatsCounters, cfg: RenderConfig):
    """Per-pixel trip counts -> the TPU kernel's (gh, gw) int32 per-tile
    `iters` (loop trips) and `work` (live lanes summed over trips) for
    cfg's tile, pix_per_lane and loop.  A lane of a (tile_h, tile_w) tile
    with K pixels per lane owns rows r + k*tile_h/K of its column and runs
    L trips: the unmerged loop bounces once a trip and refills in the
    same trip, L = sum(b); the merged loop spends one trip on the first
    refill and an idle one after each depth-cutoff sample but the lane's
    last, L = 1 + sum(b + c) - l_last.  A tile runs its longest lane and
    its work is the lanes' sum.  Padded pixels count, as on the TPU."""
    grid_h, grid_w = padded_grid(cfg)
    th, tw = cfg.tile_h, cfg.tile_w
    k = resolve_pix_per_lane(cfg, grid_h - cfg.height, grid_w - cfg.width)
    gh, gw = grid_h // th, grid_w // tw

    def lanes(x):  # (grid_h, grid_w) -> (gh, K, tile_h/K, gw, tile_w)
        return x.to(torch.int64).reshape(gh, k, th // k, gw, tw)
    b = lanes(counters.bounces).sum(dim=1)
    if cfg.merged_wavefront:
        trips = (1 + b + lanes(counters.cutoffs).sum(dim=1)
                 - lanes(counters.last_cutoff)[:, k - 1])
    else:
        trips = b
    return (trips.amax(dim=(1, 3)).to(torch.int32),
            trips.sum(dim=(1, 3)).to(torch.int32))


def render_tile_stats(scene: Scene, cfg: RenderConfig, frame: int,
                      tab=None):
    """The frame rendered over its padded tile grid with the occupancy
    counters, on the scene's device: the stats instance of the render
    kernel (K2) for a scene on a card, render/wavefront.
    render_tile_stats_plain for a scene on the CPU.  The image and rays
    are the render kernel's, bit for bit.

    Returns ((H, W, 3) float32, 0-d int64 rays of the image's pixels,
    StatsCounters)."""
    H, W = cfg.height, cfg.width
    tab = checked_tab(scene, 0, 0, H, W, tab)
    if scene.device.type == "cpu":
        from ..render.wavefront import render_tile_stats_plain
        return render_tile_stats_plain(scene, cfg, frame, tab=tab)
    if scene.device.type != "cuda":
        raise ValueError(f"no renderer for device {scene.device}")
    grid_h, grid_w = padded_grid(cfg)
    trips = torch.empty((3, grid_h, grid_w), dtype=torch.int32,
                        device=scene.device)
    warps = torch.empty((2, *warp_grid(grid_h, grid_w)), dtype=torch.int32,
                        device=scene.device)
    out, rays = launch_forward("render_stats", scene, tab, cfg, frame, 0, 0,
                               H, W, grid_h, grid_w, trips.data_ptr(),
                               warps.data_ptr())
    launches["render_stats"] += 1
    return out, rays, StatsCounters(*trips, *warps)


def render_frame_stats(scene: Scene, cfg: RenderConfig, frame: int,
                       device="cuda"):
    """Instrumented full-frame render on `device` (default: the card;
    "cpu" runs the plain version), the counterpart of
    render_frame_pallas_stats.  Returns ((H, W, 3) float32, 0-d int64
    rays, iters (gh, gw) int32, work (gh, gw) int32); occupancy of a tile
    = work / (iters * lanes), lanes = tile_h * tile_w / pix_per_lane."""
    scene = scene.to(resolve_device(device))
    img, rays, counters = render_tile_stats(scene, cfg, frame)
    return (img, rays, *tile_counters(counters, cfg))
