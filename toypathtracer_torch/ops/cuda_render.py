"""The render kernel's wrappers (counterpart of toypathtracer_tpu/ops/
pallas_render.py).

`render_tile` and `render_frame` launch the hand-written CUDA kernel of
csrc/render.cu (the port of pallas_render.py::_render_kernel) on CUDA
tensors and run the plain PyTorch version (render/wavefront.py) on CPU
tensors.  The kernel has two forms (`render_tile_form`): "merged", the main
path's (merged_render_kernel: csrc/merged.cuh's merged path loop with
csrc/flat.cuh's warp traversals, any number of spheres and lights), and
"thread", the per-thread kernel it replaced (render_kernel<0>: one thread a
pixel, up to MAX_SPHERES spheres and MAX_LIGHTS lights), kept as the
baseline it is held bit-equal to and timed against.  Each has an
instrumented instance: the merged form's counts its loop's iterations,
busy lanes and cycles by part (LOOP_FIELDS), the per-thread form's its
cycles by part of the per-pixel code (PART_FIELDS).
`render_tile_stats` and `render_frame_stats` run the stats render kernel
(K2), the counterpart of `render_frame_pallas_stats`: the image, the rays
and the occupancy counters.  It has two forms (`render_tile_stats_form`):
"merged", the main path's (merged_render_kernel<2>: the merged loop with the
counter policy csrc/merged.cuh TripStats, any number of spheres and
lights), and "thread", the per-thread kernel's stats instance it replaced
(render_kernel<1>, up to MAX_SPHERES spheres and MAX_LIGHTS lights), kept
as its baseline.  There is no fallback: on a CUDA tensor a failed build or
launch raises.  `launches` counts kernel
launches by kernel, so a run can show that its frames went through the
kernels.
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

# Largest scene the per-thread kernels (K1's baseline, K2, K4's baseline,
# K3) stage in shared memory, and their light cap (csrc/trace.cuh
# kMaxSpheres, kMaxLights).  The merged form has neither cap.
MAX_SPHERES = 512
MAX_LIGHTS = 16

# K1's forms: the argument of render_tile_form, their launch counters and
# the (spheres, lights) their storage takes (None: any).
FORMS = ("merged", "thread")
MAIN_FORM = "merged"
COUNTERS = {"merged": "render", "thread": "render_baseline"}
FORM_CAPS = {"merged": (None, None), "thread": (MAX_SPHERES, MAX_LIGHTS)}

# K2's forms (those of K1, FORMS) and their launch counters.
STATS_COUNTERS = {"merged": "render_stats", "thread": "render_stats_baseline"}

launches = {"render": 0, "render_baseline": 0, "render_counted": 0,
            "render_stats": 0, "render_stats_baseline": 0}

# The merged loops' counters (csrc/merged.cuh kSt*), per kind of ray of the
# chunked traversal (hit, shadow): warp traversal calls, lanes in them, box
# steps, lane slab tests, sphere-loop trips the warp ran, sphere tests its
# lanes needed; then the path loop's iterations and busy lanes, the SM
# cycles its warps spent in the loop, the hit traversals, NEE and NEE's
# shadow traversals, and the shadow rays their own chunk occluded.
STAT_FIELDS = ("calls", "lanes", "boxes", "slabs", "trips", "need")
LOOP_FIELDS = ("iters", "busy", "cycles", "cycles_hit", "cycles_nee",
               "cycles_shadow", "own_chunk_blocked")
STAT_SLOTS = 2 * len(STAT_FIELDS) + len(LOOP_FIELDS)

# The per-thread kernel's clocked instance (csrc/render.cu kPc*), summed
# over threads: SM cycles in camera-ray setup, the nearest-hit sphere
# loops, whole bounces, NEE (with its occlusion loops), the occlusion
# loops, and waiting at each sample's end for the warp's deepest lane; the
# whole thread; then the samples and bounces traced.
PART_FIELDS = ("cycles_camera", "cycles_hit", "cycles_bounce", "cycles_nee",
               "cycles_occlusion", "cycles_wait", "cycles_all", "samples",
               "bounces")


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
        t_min=f32(cfg.min_t), t_max=f32(cfg.max_t),
        soft_eps=f32(cfg.soft_silhouette_eps))


def _check_scene(scene: Scene):
    n = scene.n_spheres
    if n < 1:
        raise ValueError("a scene needs at least one sphere")
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


def check_caps(scene: Scene, caps, kernel: str):
    """The (spheres, lights) limits of a kernel's own storage, None where
    it has none; they bind on a card only, where the kernel runs."""
    if scene.device.type != "cuda":
        return
    max_spheres, max_lights = caps
    if max_spheres is not None and scene.n_spheres > max_spheres:
        raise ValueError(f"{kernel} takes at most {max_spheres} spheres, "
                         f"got {scene.n_spheres}")
    if max_lights is not None and len(scene.emissive_ids) > max_lights:
        raise ValueError(f"{kernel} takes at most {max_lights} emissive "
                         f"spheres, got {len(scene.emissive_ids)}")


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
                tab=None, caps=(None, None),
                kernel: str = "the render kernel") -> torch.Tensor:
    """Validate a kernel call on the (height, width) sub-image at (x0, y0)
    and return the packed table it reads (default pack_scene(scene)):
    (SCENE_ROWS, N) float32, contiguous, detached, on the scene's device.
    `caps` are the kernel's (spheres, lights) limits (check_caps)."""
    _check_scene(scene)
    check_caps(scene, caps, kernel)
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


def pack_records(tab: torch.Tensor) -> torch.Tensor:
    """The merged kernel's (N, 4) float32 sphere records from the packed
    table: center xyz and radius^2 (csrc/flat.cuh Sphere4)."""
    return tab[:4].t().contiguous()


def cuda_call(lib, name: str, code: int):
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({lib.tpt_error_string(code).decode()})")


def launch_forward(kernel: str, scene: Scene, tab: torch.Tensor,
                   cfg: RenderConfig, frame: int, x0: int, y0: int,
                   height: int, width: int, *extra, merged: bool = False):
    """Launch the forward kernel tpt_<kernel>_launch ("render",
    "render_thread", "render_stats", "render_stats_merged" or "lockstep")
    on the current stream,
    with `extra` arguments after the ray counter (merged: after the sphere
    records, which follow the table, and the tile counter, which follows
    the ray counter); returns ((height, width, 3) float32 image, 0-d int64
    ray count)."""
    lib = _build.load_library()
    mat, lights, cam = kernel_inputs(scene, cfg)
    dev = scene.device
    out = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    counters = torch.zeros((2,), dtype=torch.int64, device=dev)  # rays, tile
    params = render_params(scene, cfg, frame, x0, y0, height, width)
    sph = pack_records(tab) if merged else None
    head = (tab.data_ptr(), sph.data_ptr()) if merged else (tab.data_ptr(),)
    tile = (counters[1].data_ptr(),) if merged else ()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, f"tpt_{kernel}_launch")(
            *head, mat.data_ptr(), lights.data_ptr(), cam.data_ptr(),
            ctypes.byref(params), out.data_ptr(), counters.data_ptr(), *tile,
            *extra, stream)
    cuda_call(lib, kernel, code)
    return out, counters[0]


def render_tile(scene: Scene, cfg: RenderConfig, frame: int, x0: int,
                y0: int, height: int, width: int, tab=None):
    """Render the (height, width) sub-image whose lower-left pixel is the
    global pixel (x0, y0), on the scene's device: the CUDA kernel (its
    merged form) for a scene on a card, the plain PyTorch version for a
    scene on the CPU.  `tab` is the packed table to render (default
    pack_scene(scene)); the kernel does not differentiate it (ops/cuda_grad
    does).

    Returns ((height, width, 3) float32 image, 0-d int64 ray count: every
    camera, bounce and shadow ray of the sub-image's pixels)."""
    return render_tile_form(scene, cfg, frame, x0, y0, height, width,
                            MAIN_FORM, tab=tab)


def render_tile_form(scene: Scene, cfg: RenderConfig, frame: int, x0: int,
                     y0: int, height: int, width: int, form: str, tab=None,
                     counted: bool = False):
    """render_tile through K1's form `form` (FORMS); both compute the same
    image and rays.  On the CPU the plain version, whatever the form.
    counted=True launches the form's instrumented instance (on a card) and
    returns a third value: for "merged" its loop counters by LOOP_FIELDS,
    for "thread" its cycles by PART_FIELDS."""
    if form not in FORMS:
        raise ValueError(f"no render kernel form {form!r}")
    tab = checked_tab(scene, x0, y0, height, width, tab, FORM_CAPS[form],
                      f"the render kernel's {form} form")
    if scene.device.type == "cpu":
        if counted:
            raise ValueError("the instrumented instances run on a card")
        from ..render.wavefront import render_tile_plain
        return render_tile_plain(scene, cfg, frame, x0, y0, height, width,
                                 tab=tab)
    if scene.device.type != "cuda":
        raise ValueError(f"no renderer for device {scene.device}")
    fields = LOOP_FIELDS if form == "merged" else PART_FIELDS
    slots = STAT_SLOTS if form == "merged" else len(PART_FIELDS)
    counts = torch.zeros((slots,), dtype=torch.int64, device=scene.device) \
        if counted else None
    ptr = counts.data_ptr() if counted else None
    if form == "merged":
        out, rays = launch_forward("render", scene, tab, cfg, frame, x0, y0,
                                   height, width, ptr, merged=True)
    else:
        out, rays = launch_forward("render_thread", scene, tab, cfg, frame,
                                   x0, y0, height, width, ptr)
    launches["render_counted" if counted else COUNTERS[form]] += 1
    if not counted:
        return out, rays
    v = [int(x) for x in counts.cpu()][slots - len(fields):]
    return out, rays, dict(zip(fields, v))


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
    counters, on the scene's device: the stats render kernel (K2, its
    merged form) for a scene on a card, render/wavefront.
    render_tile_stats_plain for a scene on the CPU.  The image and rays
    are the render kernel's, bit for bit.

    Returns ((H, W, 3) float32, 0-d int64 rays of the image's pixels,
    StatsCounters)."""
    return render_tile_stats_form(scene, cfg, frame, MAIN_FORM, tab=tab)


def render_tile_stats_form(scene: Scene, cfg: RenderConfig, frame: int,
                           form: str, tab=None):
    """render_tile_stats through K2's form `form` (FORMS: "merged" or
    "thread"); both give the same image, rays and counters.  On the CPU the
    plain version, whatever the form."""
    if form not in FORMS:
        raise ValueError(f"no stats render kernel form {form!r}")
    H, W = cfg.height, cfg.width
    tab = checked_tab(scene, 0, 0, H, W, tab, FORM_CAPS[form],
                      f"the stats render kernel's {form} form")
    if scene.device.type == "cpu":
        from ..render.wavefront import render_tile_stats_plain
        return render_tile_stats_plain(scene, cfg, frame, tab=tab)
    if scene.device.type != "cuda":
        raise ValueError(f"no renderer for device {scene.device}")
    dev = scene.device
    grid_h, grid_w = padded_grid(cfg)
    wr, wc = warp_grid(grid_h, grid_w)
    trips = torch.empty((3, grid_h, grid_w), dtype=torch.int32, device=dev)
    if form == "merged":
        # the per-thread layout's warp units: the bounces of their image
        # pixels, and each sample's deepest one, summed over samples here
        work = torch.zeros((wr, wc), dtype=torch.int32, device=dev)
        depth = torch.zeros((wr, wc, cfg.samples_per_pixel),
                            dtype=torch.int32, device=dev)
        out, rays = launch_forward(
            "render_stats_merged", scene, tab, cfg, frame, 0, 0, H, W,
            grid_h, grid_w, trips.data_ptr(), work.data_ptr(),
            depth.data_ptr(), merged=True)
        iters = depth.sum(dim=-1, dtype=torch.int32)
    else:
        warps = torch.empty((2, wr, wc), dtype=torch.int32, device=dev)
        out, rays = launch_forward("render_stats", scene, tab, cfg, frame, 0,
                                   0, H, W, grid_h, grid_w, trips.data_ptr(),
                                   warps.data_ptr())
        iters, work = warps
    launches[STATS_COUNTERS[form]] += 1
    return out, rays, StatsCounters(*trips, iters, work)


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
