"""The gradient and lockstep kernels' wrappers (counterpart of
toypathtracer_tpu/ops/pallas_grad.py).

`render_tile_grad` launches the hand-written CUDA gradient kernel (K3, the
port of pallas_grad.py::_grad_kernel, csrc/grad.cu) and
`render_tile_lockstep` its primal-only twin (K4, ::_lockstep_fwd_kernel)
on CUDA tensors; on CPU tensors they run the plain versions
(render/wavefront.render_tile_grad_plain and render_tile_plain).  There is
no fallback: on a CUDA tensor a failed build or launch raises.

On a card K4 is the render kernel's merged kernel (csrc/render.cu, any
number of spheres): the TPU's K4 computes K3's primal, which here is K1's
function.  `render_tile_lockstep_baseline` runs csrc/grad.cu's per-thread
lockstep_kernel<0,0> (up to 512 spheres), kept as the kernel it is timed
against.

K3 has three forms (`render_tile_grad_form`): "warp", the main path's
(csrc/gradwarp.cuh grad_tiles: stored carries and a warp-level cotangent
table in shared memory, up to 512 spheres); "pool", the same with the
table in device memory (gradwarp.cuh PoolTable, any number of spheres),
which `render_tile_grad` launches past 512 spheres; and "replay", the
kernel the warp form replaced (bounces replayed, a per-thread table, up
to 64 spheres), kept as the baseline it is timed and held against.  The
warp and replaying forms have a stats instance that counts SM cycles by
part; every form has a soft instance that computes the soft-silhouette
estimator's cotangent: a config with soft_silhouette_eps > 0 launches it,
and only it (the eps travels in RenderParams).  The sphere and light caps
of each form's storage bind on a card only; the plain version takes any
scene.  `launches` counts wrapper launches: "grad" the main path's form
(one launch is the kernel and the small kernel that sums its per-block
partials), "grad_soft" its soft instance, "grad_pool", "grad_pool_soft",
"grad_replay", "grad_replay_soft" and "grad_stats" the others, "lockstep"
K4 and "lockstep_baseline" its baseline.  `launch_pool` also runs the
scaled scene's chunked instance (ops/cuda_scaled.
render_tile_scaled_grad_form(..., "chunk")), and `pool_table_launch` the
table of the cooperative chunked form's sweep.  Past 16 lights the warp
form runs its lights instance, which keeps each bounce's seen lights in
words of their own, as the pool form always does.

With cfg.diff_wavefront the differentiable render takes the differentiable
wavefront, the route the JAX package's jnp backend takes
(tracecore.render_pixels_fused_merged(differentiable=True)): on a card a
kernel pair, K1's tape instance (csrc/render.cu merged_render_kernel<4>,
the merged loop staging each bounce's carry record in shared memory and
writing it to a frame tape as whole lines: `render_tile_wave_tape`; its
form "scalar", <3>, the instance it replaced, stays as the baseline) and
a sweep over the tape (`sweep_wave_tape`: csrc/wavesweep.cu, its table
per warp in shared memory up to 512 spheres, a PoolTable past them),
whose cotangent is within 1e-4 of each row's max of the sweep it
replaced (csrc/wavegrad.cu, form "tiles", kept as the baseline), which is
K3's bit for bit on K3's grid; on the CPU autograd through the plain
wavefront (tracecore.render_pixels_wavefront).  `render_tile_grad` takes
the pair (form "wave") under the flag; K3's own forms stay the lockstep
differentiable form and warn under it, as the JAX package's in-kernel
(unrolled) gradient route does (config.warn_diff_wavefront).  Launch
counters "wave_tape" (the staged instance), "wave_tape_baseline",
"wave_sweep", "wave_sweep_baseline", "wave_sweep_tiles_deal",
"wave_sweep_pool", "wave_sweep_pool_baseline" and "wave_sweep_stats".

`render_frame_diff` / `render_tile_diff` are the differentiable renders of
the training step: a torch.autograd.Function on the packed scene table
whose forward is the render kernel (or the lockstep kernel) and whose
backward is the gradient kernel, or under cfg.diff_wavefront on a card
whose forward is the tape instance and whose backward the sweep over the
tape it kept; pack_scene's own autograd carries the table's cotangent back
to the Scene fields.

In this port the kernels compute one per-pixel function (csrc/trace.cuh
render_pixel), so the lockstep primal is bit-equal to the render kernel's
image and `lockstep_primal` changes which kernel runs, not the value.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import RenderConfig, resolve_device, warn_diff_wavefront
from ..render.wavefront import render_tile_grad_plain, render_tile_plain
from ..scene import Scene
from . import _build
from .cuda_render import (MAX_LIGHTS, MAX_SPHERES, check_device,
                          checked_tab, cuda_call, kernel_inputs,
                          launch_forward, pack_scene, render_params,
                          render_tile)

# K3's forms ("replay" and "warp" by their id for tpt_grad_launch; "pool"
# has launchers of its own), their launch counters, and the (spheres,
# lights) each takes on a card:
# the warp form's table is per warp in shared memory, up to
# tpt::kMaxSpheres (MAX_SPHERES, as the per-thread render kernel); the
# replaying form's is per thread (csrc/grad.cu kGradMaxSpheres); the pool
# form's in device memory, any number.  The replaying form keeps a lane's
# seen lights as 16 bits of its carry record (MAX_LIGHTS); the warp form
# past MAX_LIGHTS lights, and the pool form always, keep them in words of
# their own, any number.  The caps bind on a card only
# (cuda_render.check_caps): on the CPU the plain version takes any scene.
# "wave" is the differentiable wavefront's kernel pair (any scene; hard
# selects only, as RenderConfig requires of diff_wavefront).
FORMS = {"replay": 0, "warp": 1}
MAIN_FORM = "warp"
COUNTERS = {"warp": "grad", "replay": "grad_replay", "pool": "grad_pool"}
SOFT_SUFFIX = "_soft"
FORM_CAPS = {"warp": (MAX_SPHERES, None), "replay": (64, MAX_LIGHTS),
             "pool": (None, None), "wave": (None, None)}
TABLES = {"warp": "a (14, N) table per warp in shared memory",
          "replay": "a (14, 64) table per thread",
          "pool": "a table per warp in device memory",
          "wave": "a frame tape and a table per warp"}

# The stats instances' counters (csrc/trace.cuh kGc*), summed over threads:
# SM cycles in the forward trace, the replays, the adjoint sweep, the warp
# form's grouping of lanes, zeroing the tables, the block reduction and the
# whole thread; adjoint bounces, replayed bounces, lane slots of the warp
# form's reverse steps, its hit groups and the lanes in them (in the soft
# instance, a miss lane's silhouette candidate forms its group too), and
# the warp form's cycles in the soft instance's silhouette and
# shadow-boundary scans (inside cycles_adj).
STAT_FIELDS = ("cycles_fwd", "cycles_replay", "cycles_adj", "cycles_group",
               "cycles_zero", "cycles_reduce", "cycles_all", "adj_bounces",
               "replay_bounces", "adj_slots", "hit_groups", "hit_lanes",
               "cycles_soft")

PARAM_FIELDS = ("center", "radius", "albedo", "emissive", "roughness", "ri")

launches = {"grad": 0, "grad_soft": 0, "grad_pool": 0, "grad_pool_soft": 0,
            "grad_replay": 0, "grad_replay_soft": 0, "grad_stats": 0,
            "lockstep": 0, "lockstep_baseline": 0, "wave_tape": 0,
            "wave_tape_baseline": 0, "wave_sweep": 0,
            "wave_sweep_baseline": 0, "wave_sweep_tiles_deal": 0,
            "wave_sweep_pool": 0,
            "wave_sweep_pool_baseline": 0, "wave_sweep_stats": 0}

# The differentiable wavefront's tape instances (render_tile_wave_tape):
# "staged", the main path's (merged_render_kernel<4>: each record staged in
# shared memory and written as whole lines), and "scalar", the one it
# replaced (<3>: a store a word), its baseline; tpt_render_tape_launch's
# form, and their launch counters.
TAPE_FORMS = {"scalar": 0, "staged": 1}
TAPE_MAIN_FORM = "staged"
TAPE_COUNTERS = {"staged": "wave_tape", "scalar": "wave_tape_baseline"}

# The differentiable wavefront's sweeps (sweep_wave_tape): "runs", the
# main path's (csrc/wavesweep.cu wave_run_kernel<true, false>: blocks of 2
# tiles a warp whose samples are sorted by bounces and dealt to the warps,
# the next record fetched during the adjoint, cheaper adds, 128
# registers; past MAX_SPHERES wave_run_pool_kernel); "tiles", the one it
# replaced (csrc/wavegrad.cu wave_sweep_kernel: K3's reverse half on K3's
# grid; wave_sweep_pool_kernel), its baseline; and "runs_on_tiles_deal"
# (wave_run_kernel<false, false>: the redesign's loop on the kept sweep's
# deal, launch bounds and grid with its adds, the kept sweep's cotangent
# bit for bit; no pool instance).  Their launch counters (up to
# MAX_SPHERES spheres, and past them) and their timed and stats instances'
# ptxas labels.  The stats instances' counters (wavesweep.cuh kWc*)
# follow STAT_FIELDS: SM cycles in the tape reads, the queue's claims and
# the bounces' adjoint (inside cycles_adj, the whole sweep loop), and
# waiting at the block's end.
SWEEP_FORMS = ("runs", "runs_on_tiles_deal", "tiles")
SWEEP_MAIN_FORM = "runs"
SWEEP_COUNTERS = {"runs": "wave_sweep",
                  "runs_on_tiles_deal": "wave_sweep_tiles_deal",
                  "tiles": "wave_sweep_baseline"}
POOL_SWEEP_COUNTERS = {"runs": "wave_sweep_pool",
                       "tiles": "wave_sweep_pool_baseline"}
SWEEP_LABELS = {"runs": "wave_run_kernel<1,0>",
                "runs_on_tiles_deal": "wave_run_kernel<0,0>",
                "tiles": "wave_sweep_kernel"}
SWEEP_STATS_LABELS = {"runs": "wave_run_kernel<1,1>",
                      "runs_on_tiles_deal": "wave_run_kernel<0,1>"}
WAVE_STAT_FIELDS = STAT_FIELDS + ("cycles_tape", "cycles_queue",
                                  "cycles_bounce", "cycles_wait")

# The last pool launch's scratch (pool_table_launch): blocks, the slots its
# warps drew and the pool's capacity, the directory blocks they drew and
# their capacity, launches (more than 1 where a pool ran out), and the
# bytes of its directory (with its blocks), pool and, for launch_pool,
# carries.
last_pool = {}


def grad_scratch(scene: Scene, cfg: RenderConfig, frame: int, x0: int,
                 y0: int, height: int, width: int, form: str):
    """The scratch a K3 launch of `form` ("warp" or "replay") takes on the
    scene's card: (rows of its (rows, 14, N) per-block partial sums, floats
    of its stored carries).  A launch of the warp form takes its rows as
    its blocks."""
    if form not in ("warp", "replay"):
        raise ValueError(f"no partial rows for K3's {form!r} form")
    lib = _build.load_library()
    params = render_params(scene, cfg, frame, x0, y0, height, width)
    rows, tape_floats = ctypes.c_int(), ctypes.c_longlong()
    with torch.cuda.device(scene.device):
        cuda_call(lib, "grad", lib.tpt_grad_scratch(
            ctypes.byref(params), FORMS[form], ctypes.byref(rows),
            ctypes.byref(tape_floats)))
    return rows.value, tape_floats.value


def _launch_grad(scene, tab, cfg, frame, g_img, x0, y0, height, width, form,
                 stats):
    lib = _build.load_library()
    mat, lights, cam = kernel_inputs(scene, cfg)
    dev = scene.device
    out = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    params = render_params(scene, cfg, frame, x0, y0, height, width)
    rows, tape_floats = grad_scratch(scene, cfg, frame, x0, y0, height,
                                     width, form)
    n = scene.n_spheres
    partial = torch.empty((rows, 14, n), dtype=torch.float32, device=dev)
    tape = torch.empty((tape_floats,), dtype=torch.float32, device=dev)
    d_tab = torch.empty((14, n), dtype=torch.float32, device=dev)
    counts = torch.zeros((len(STAT_FIELDS),), dtype=torch.int64,
                         device=dev) if stats else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.tpt_grad_launch(
            tab.data_ptr(), mat.data_ptr(), lights.data_ptr(), cam.data_ptr(),
            ctypes.byref(params), g_img.data_ptr(), out.data_ptr(),
            rays.data_ptr(), rows, partial.data_ptr(),
            tape.data_ptr() if tape.numel() else None, d_tab.data_ptr(),
            FORMS[form], counts.data_ptr() if stats else None, stream)
    cuda_call(lib, "grad", code)
    soft = SOFT_SUFFIX if cfg.soft_silhouette_eps > 0.0 else ""
    launches["grad_stats" if stats else COUNTERS[form] + soft] += 1
    if stats:
        return out, rays, d_tab, dict(zip(STAT_FIELDS,
                                          (int(v) for v in counts.cpu())))
    return out, rays, d_tab


def pool_grid(params, dev, chunked: bool, blocks=None):
    """(blocks, floats of carries a block) of a pool launch on `dev`: as
    many blocks as fit on the card at once (the chunked instance's
    occupancy for `chunked`), or `blocks`."""
    lib = _build.load_library()
    rows, tape_floats = ctypes.c_int(), ctypes.c_longlong()
    with torch.cuda.device(dev):
        cuda_call(lib, "grad_pool", lib.tpt_grad_pool_scratch(
            ctypes.byref(params), int(chunked), ctypes.byref(rows),
            ctypes.byref(tape_floats)))
    per_block = tape_floats.value // rows.value
    return (rows.value if blocks is None else int(blocks)), per_block


def pool_table_launch(launch, params, dev, n_blocks: int, cap=None):
    """A launch that adds into a PoolTable a warp (csrc/gradwarp.cuh), then
    csrc/grad.cu's sum_pool: the (14, N) d_tab.  launch(dir, blocks, next,
    block_cap, pool, cap, n_blocks) launches the kernel on the table's
    scratch (next: two int32 counters, the slots' and the blocks').  The
    pool starts at a slot for every two pixel samples (a slot is a sphere
    a warp adds to, 64 bytes; the 100k-sphere frame's warps draw about one
    for every 16 samples, one for every 7 with the soft estimator), and
    the blocks of its directory (64 slot indices for 64 consecutive
    spheres a warp adds to, 256 bytes; never more than the slots) at a
    quarter as many; where the launch's warps drew more of either, it
    runs again with as many as they drew, and a third time where the
    second drew more slots than the first could count (`cap` sets the
    first slot capacity instead).  The directory holds 4 bytes per (64
    spheres, warp), 264 bytes a sphere on a 132-SM H100 (csrc/grad.cu).
    Records the scratch in `last_pool`."""
    lib = _build.load_library()
    n = params.n_spheres
    n_warps = 4 * n_blocks  # csrc/grad.cu kGradWarps
    if cap is None:
        cap = min(n_warps * n, max(1 << 16, params.height * params.width
                                   * params.spp // 2))
    ids = lib.tpt_grad_dir_ids()
    dir_rows = -(-n // ids)
    block_cap = min(n_warps * dir_rows, max(1, cap // 4))
    for attempt in (1, 2, 3):
        direc = torch.full((dir_rows * n_warps,), -1, dtype=torch.int32,
                           device=dev)
        blocks_t = torch.full((block_cap * ids,), -1, dtype=torch.int32,
                              device=dev)
        pool = torch.zeros((cap * 16,), dtype=torch.float32, device=dev)
        nxt = torch.zeros((2,), dtype=torch.int32, device=dev)
        launch(direc, blocks_t, nxt, block_cap, pool, cap, n_blocks)
        drawn, drawn_blocks = (int(v) for v in nxt.cpu())
        if drawn <= cap and drawn_blocks <= block_cap:
            break
        if attempt == 3:
            raise RuntimeError(f"K3's pool ran out three times ({drawn} "
                               f"slots drawn of {cap}, {drawn_blocks} "
                               f"blocks of {block_cap})")
        cap, block_cap = max(cap, drawn), max(block_cap, drawn_blocks)
    d_tab = torch.empty((14, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = lib.tpt_grad_pool_sum_launch(
            direc.data_ptr(), blocks_t.data_ptr(), pool.data_ptr(), n_blocks,
            n, d_tab.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_call(lib, "grad_pool_sum", code)
    last_pool.clear()
    last_pool.update(blocks=n_blocks, slots=drawn, cap=cap,
                     dir_blocks=drawn_blocks, block_cap=block_cap,
                     launches=attempt,
                     dir_bytes=4 * (direc.numel() + blocks_t.numel()),
                     pool_bytes=4 * pool.numel())
    return d_tab


def launch_pool(tab, mat, lights, cam, params, g_img, dev, chunks=None,
                blocks=None, cap=None, stats=False):
    """K3's pool instance on `dev` (csrc/grad.cu pool_grad_kernel, or with
    `chunks`, a dict of the chunked scene's "rows", "box", "sil_box",
    "prox_box", "n_chunks" and "chunk", chunk_grad_kernel): ((height,
    width, 3) image, 0-d int64 rays, (14, N) d_tab) for the pixel cotangent
    g_img.  `blocks`: the grid (default: as many blocks as fit on the card
    at once); the warp form's grid makes the result bit-equal to the warp
    form's.  The table's scratch and its reruns: pool_table_launch (`cap`
    its first slot capacity).  Records the scratch in `last_pool`.
    stats=True (with `chunks`) launches the chunked instance's stats
    instance and returns a fourth value, its counters by STAT_FIELDS."""
    lib = _build.load_library()
    height, width = params.height, params.width
    n_blocks, per_block = pool_grid(params, dev, chunks is not None, blocks)
    tape = torch.empty((n_blocks * per_block,), dtype=torch.float32,
                       device=dev)
    out = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    counts = torch.zeros((len(STAT_FIELDS),), dtype=torch.int64,
                         device=dev) if stats else None
    c = chunks or {}

    def ptr(key):
        t = c.get(key)
        return None if t is None else t.data_ptr()

    def launch(direc, blocks_t, nxt, block_cap, pool, cap, n_blocks):
        rays.zero_()
        if stats:
            counts.zero_()
        with torch.cuda.device(dev):
            code = lib.tpt_grad_pool_launch(
                tab.data_ptr(), mat.data_ptr(), lights.data_ptr(),
                cam.data_ptr(), ptr("rows"), ptr("box"), ptr("sil_box"),
                ptr("prox_box"), c.get("n_chunks", 0), c.get("chunk", 0),
                ctypes.byref(params), g_img.data_ptr(), out.data_ptr(),
                rays.data_ptr(), n_blocks, tape.data_ptr(), direc.data_ptr(),
                blocks_t.data_ptr(), nxt[1:].data_ptr(), block_cap,
                pool.data_ptr(), nxt.data_ptr(), cap,
                counts.data_ptr() if stats else None,
                torch.cuda.current_stream(dev).cuda_stream)
        cuda_call(lib, "grad_pool", code)
    d_tab = pool_table_launch(launch, params, dev, n_blocks, cap)
    last_pool["tape_bytes"] = 4 * tape.numel()
    if stats:
        return out, rays, d_tab, dict(zip(STAT_FIELDS,
                                          (int(v) for v in counts.cpu())))
    return out, rays, d_tab


def sum_partials(partial, form: str):
    """K3's final sum alone: the (14, N) cotangent from a form's (rows, 14,
    N) per-block partial sums, by that form's summing kernel (the
    replaying form's serial sum, the warp form's fixed tree).  For timing
    the sum apart from the kernel; CUDA tensors only."""
    if form not in FORMS:
        raise ValueError(f"no gradient kernel form {form!r}")
    if partial.device.type != "cuda" or partial.dim() != 3:
        raise ValueError("sum_partials takes a (rows, 14, N) CUDA tensor")
    partial = partial.contiguous()
    lib = _build.load_library()
    d_tab = torch.empty(partial.shape[1:], dtype=torch.float32,
                        device=partial.device)
    with torch.cuda.device(partial.device):
        code = lib.tpt_grad_sum_launch(
            partial.data_ptr(), partial.shape[0], d_tab.numel(),
            d_tab.data_ptr(), FORMS[form],
            torch.cuda.current_stream(partial.device).cuda_stream)
    cuda_call(lib, "grad_sum", code)
    return d_tab


def tape_bytes(n_lights: int, cfg: RenderConfig, height: int,
               width: int) -> int:
    """Bytes of the frame tape a tape-writing render keeps for a (height,
    width) sub-image (csrc/tape.cuh FrameTape): a 64-byte record and
    light_words(n_lights) words a (pixel, sample, bounce), and a bounce
    count a (pixel, sample)."""
    samples = height * width * cfg.samples_per_pixel
    words = -(-n_lights // 32)
    return samples * (cfg.max_depth * (64 + 4 * words) + 4)


def alloc_tape(n_lights: int, cfg: RenderConfig, height: int, width: int,
               dev, what: str, remedy: str) -> dict:
    """The tensors of a frame tape on the card `dev`: "rec" (16 floats a
    slot), "see" (the seen lights' words) and "depth".  Allocated directly:
    only where the caching allocator cannot give them (OutOfMemoryError)
    does it ask the card for its free memory, and raise MemoryError naming
    the tape's bytes (tape_bytes), the free memory and what the allocator
    holds unused: `what` names the route and `remedy` the band entry point
    to use instead."""
    slots = height * width * cfg.samples_per_pixel * cfg.max_depth
    words = -(-n_lights // 32)
    try:
        return {"rec": torch.empty((slots * 16,), dtype=torch.float32,
                                   device=dev),
                "see": torch.empty((max(1, slots * words),),
                                   dtype=torch.int32, device=dev),
                "depth": torch.empty((height * width
                                      * cfg.samples_per_pixel,),
                                     dtype=torch.int32, device=dev)}
    except torch.cuda.OutOfMemoryError:
        pass
    need = tape_bytes(n_lights, cfg, height, width)
    free, _ = torch.cuda.mem_get_info(dev)
    # and what the caching allocator holds unused (an earlier step's tape)
    free += torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    rows = max(1, height * free // (2 * need))
    raise MemoryError(
        f"{what}'s tape for {height}x{width} pixels, spp "
        f"{cfg.samples_per_pixel}, depth {cfg.max_depth} takes {need} "
        f"bytes and the card has {free} free: differentiate bands of "
        f"at most {rows} rows ({remedy})")


def render_tile_wave_tape(scene: Scene, cfg: RenderConfig, frame: int,
                          x0: int, y0: int, height: int, width: int,
                          tab=None, form: str = TAPE_MAIN_FORM):
    """The differentiable wavefront's forward on a card: K1's tape instance
    of `form` (TAPE_FORMS; the main path's "staged", csrc/render.cu
    merged_render_kernel<4>, or "scalar", <3>, the one it replaced) over
    the (height, width) sub-image at global pixel (x0, y0).  Returns
    ((height, width, 3) image, 0-d int64 rays, tape): the image and rays
    K1's bit for bit, the tape a dict of its tensors ("rec", "see",
    "depth"; alloc_tape; the same words from either form) and the
    sub-image ("tile") for sweep_wave_tape.  Any number of spheres and
    lights.  Raises where the tape does not fit in the card's free memory;
    it never falls back to another kernel."""
    if form not in TAPE_FORMS:
        raise ValueError(f"no tape instance {form!r}")
    if scene.device.type != "cuda":
        raise ValueError("the tape-writing render runs on a card")
    tab = checked_tab(scene, x0, y0, height, width, tab)
    tape = alloc_tape(len(scene.emissive_ids), cfg, height, width,
                      scene.device, "the differentiable wavefront",
                      "render_tile_diff on sub-images")
    img, rays = launch_forward("render_tape", scene, tab, cfg, frame, x0, y0,
                               height, width, tape["rec"].data_ptr(),
                               tape["see"].data_ptr(),
                               tape["depth"].data_ptr(), TAPE_FORMS[form],
                               merged=True)
    launches[TAPE_COUNTERS[form]] += 1
    tape["tile"] = (frame, x0, y0, height, width)
    return img, rays, tape


def run_scratch(params, dev) -> int:
    """Partial rows (blocks) of the main path's sweep on `dev`
    (wave_run_kernel<true, ..>, wave_run_pool_kernel)."""
    lib = _build.load_library()
    rows = ctypes.c_int()
    with torch.cuda.device(dev):
        cuda_call(lib, "wave_sweep", lib.tpt_wave_run_scratch(
            ctypes.byref(params), ctypes.byref(rows)))
    return rows.value


def sweep_wave_tape(scene: Scene, cfg: RenderConfig, g_img, tape, tab=None,
                    form: str = SWEEP_MAIN_FORM, stats: bool = False):
    """The differentiable wavefront's backward on a card over the tape
    render_tile_wave_tape wrote for the same scene, config and sub-image:
    d_packed (14, N) for the pixel cotangent g_img.  Up to MAX_SPHERES
    spheres the sweep of `form` (SWEEP_FORMS): "runs", the main path's
    (csrc/wavesweep.cu wave_run_kernel<true, ..>); "runs_on_tiles_deal",
    the same loop on the kept sweep's deal, batches and K3's grid, whose
    cotangent is the kept sweep's bit for bit; or "tiles" (csrc/wavegrad.cu
    wave_sweep_kernel on K3's warp-form grid, whose cotangent is K3's bit
    for bit).  Past them "runs" and "tiles" with a PoolTable a warp
    (pool_table_launch: its scratch and reruns, recorded in last_pool):
    "runs" csrc/wavesweep.cu wave_run_pool_kernel, "tiles"
    csrc/wavegrad.cu wave_sweep_pool_kernel on the pool form's grid, the
    pool form's bit for bit.  stats=True launches the stats instance of
    "runs" or "runs_on_tiles_deal" (up to MAX_SPHERES spheres) and returns
    (d_packed, its counters by WAVE_STAT_FIELDS).  Hard selects only (the
    soft estimator has no wavefront route).  Raises where a launch fails;
    there is no fallback to another sweep."""
    if cfg.soft_silhouette_eps > 0.0:
        raise ValueError("the differentiable wavefront has no soft-silhouette "
                         "estimator (RenderConfig refuses the two together)")
    if form not in SWEEP_FORMS:
        raise ValueError(f"no wavefront sweep {form!r}")
    if stats and form not in SWEEP_STATS_LABELS:
        raise ValueError(f"the sweep {form!r} has no stats instance (the "
                         "kept sweep is counted as runs_on_tiles_deal)")
    frame, x0, y0, height, width = tape["tile"]
    tab = checked_tab(scene, x0, y0, height, width, tab)
    if tuple(g_img.shape) != (height, width, 3):
        raise ValueError(f"pixel cotangent must be ({height}, {width}, 3), "
                         f"got {tuple(g_img.shape)}")
    check_device(scene, g_img)
    g_img = g_img.detach().to(torch.float32).contiguous()
    lib = _build.load_library()
    mat, lights, _ = kernel_inputs(scene, cfg)
    params = render_params(scene, cfg, frame, x0, y0, height, width)
    dev, n = scene.device, scene.n_spheres
    head = (tab.data_ptr(), mat.data_ptr(), lights.data_ptr(),
            ctypes.byref(params), g_img.data_ptr())
    taped = (tape["rec"].data_ptr(), tape["see"].data_ptr(),
             tape["depth"].data_ptr())
    if n <= MAX_SPHERES:
        counts = torch.zeros((len(WAVE_STAT_FIELDS),), dtype=torch.int64,
                             device=dev) if stats else None
        if form == "runs":
            rows = run_scratch(params, dev)
        else:
            rows = grad_scratch(scene, cfg, frame, x0, y0, height, width,
                                "warp")[0]
        partial = torch.empty((rows, 14, n), dtype=torch.float32, device=dev)
        d_tab = torch.empty((14, n), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            if form == "tiles":
                code = lib.tpt_wave_sweep_launch(
                    *head, rows, partial.data_ptr(), d_tab.data_ptr(),
                    *taped, stream)
            else:
                code = lib.tpt_wave_run_launch(
                    *head, int(form == "runs"), rows, partial.data_ptr(),
                    d_tab.data_ptr(), *taped,
                    counts.data_ptr() if stats else None, stream)
        cuda_call(lib, SWEEP_COUNTERS[form], code)
        if stats:
            launches["wave_sweep_stats"] += 1
            return d_tab, dict(zip(WAVE_STAT_FIELDS,
                                   (int(v) for v in counts.cpu())))
        launches[SWEEP_COUNTERS[form]] += 1
        return d_tab
    if stats or form not in POOL_SWEEP_COUNTERS:
        raise ValueError(f"past {MAX_SPHERES} spheres the sweeps are "
                         f"{tuple(POOL_SWEEP_COUNTERS)}, with no stats "
                         "instance")

    def launch(direc, blocks_t, nxt, block_cap, pool, cap, n_blocks):
        with torch.cuda.device(dev):
            pool_args = (direc.data_ptr(), blocks_t.data_ptr(),
                         nxt[1:].data_ptr(), block_cap, pool.data_ptr(),
                         nxt.data_ptr(), cap,
                         torch.cuda.current_stream(dev).cuda_stream)
            if form == "runs":
                code = lib.tpt_wave_run_pool_launch(*head, n_blocks, *taped,
                                                    *pool_args)
            else:
                code = lib.tpt_wave_sweep_pool_launch(*head, n_blocks,
                                                      *taped, *pool_args)
        cuda_call(lib, POOL_SWEEP_COUNTERS[form], code)
    if form == "runs":
        n_blocks = run_scratch(params, dev)
    else:
        n_blocks = pool_grid(params, dev, chunked=False)[0]
    d_tab = pool_table_launch(launch, params, dev, n_blocks)
    launches[POOL_SWEEP_COUNTERS[form]] += 1
    return d_tab


def render_tile_lockstep(scene: Scene, cfg: RenderConfig, frame: int,
                         x0: int, y0: int, height: int, width: int, tab=None):
    """The gradient kernel's primal alone (K4) for the (height, width)
    sub-image at global pixel (x0, y0): the render kernel's merged kernel
    on a card, the plain version on the CPU.  Returns ((height, width, 3)
    float32, 0-d int64 ray count of the sub-image's pixels)."""
    tab = checked_tab(scene, x0, y0, height, width, tab)
    if scene.device.type == "cuda":
        out = launch_forward("render", scene, tab, cfg, frame, x0, y0,
                             height, width, None, merged=True)
        launches["lockstep"] += 1
        return out
    return _lockstep_plain(scene, cfg, frame, x0, y0, height, width, tab)


def render_tile_lockstep_baseline(scene: Scene, cfg: RenderConfig,
                                  frame: int, x0: int, y0: int, height: int,
                                  width: int, tab=None):
    """render_tile_lockstep through the per-thread kernel it replaced on a
    card (csrc/grad.cu lockstep_kernel<0,0>, up to MAX_SPHERES spheres and
    MAX_LIGHTS lights), the plain version on the CPU."""
    tab = checked_tab(scene, x0, y0, height, width, tab,
                      (MAX_SPHERES, MAX_LIGHTS), "the per-thread K4")
    if scene.device.type == "cuda":
        out = launch_forward("lockstep", scene, tab, cfg, frame, x0, y0,
                             height, width)
        launches["lockstep_baseline"] += 1
        return out
    return _lockstep_plain(scene, cfg, frame, x0, y0, height, width, tab)


def _lockstep_plain(scene: Scene, cfg: RenderConfig, frame: int, x0: int,
                    y0: int, height: int, width: int, tab):
    if scene.device.type == "cpu":
        return render_tile_plain(scene, cfg, frame, x0, y0, height, width,
                                 tab=tab)
    raise ValueError(f"no renderer for device {scene.device}")


def render_tile_grad(scene: Scene, cfg: RenderConfig, frame: int, g_img,
                     x0: int, y0: int, height: int, width: int, tab=None):
    """Value and packed-scene cotangent of the (height, width) sub-image at
    global pixel (x0, y0) for the pixel cotangent g_img ((height, width, 3)):
    the gradient kernel (K3: its warp form up to MAX_SPHERES spheres, its
    pool form past them) on a card, autograd through the plain version on
    the CPU.  `tab` is the packed table (default pack_scene(scene)).  With
    cfg.soft_silhouette_eps > 0 it is the soft-silhouette estimator's
    cotangent (K3's soft instance on a card); with cfg.diff_wavefront the
    differentiable wavefront's (form "wave": the tape instance and the
    sweep on a card, the plain wavefront on the CPU).

    Returns ((height, width, 3) float32 image, 0-d int64 ray count,
    d_packed (14, N) float32)."""
    if cfg.diff_wavefront:
        form = "wave"
    else:
        form = MAIN_FORM if scene.n_spheres <= MAX_SPHERES else "pool"
    return render_tile_grad_form(scene, cfg, frame, g_img, x0, y0, height,
                                 width, form, tab=tab)


def render_tile_grad_form(scene: Scene, cfg: RenderConfig, frame: int, g_img,
                          x0: int, y0: int, height: int, width: int,
                          form: str, tab=None, stats: bool = False,
                          blocks=None):
    """render_tile_grad through K3's form `form` (FORM_CAPS): on a card that
    form's kernel, on the CPU the plain version whatever the form.
    stats=True launches the form's stats instance (on a card; the warp and
    replaying forms) and returns a fourth value, its counters by
    STAT_FIELDS.  blocks: the pool form's grid (launch_pool).  Form "wave"
    is the differentiable wavefront's pair (two launches:
    render_tile_wave_tape and sweep_wave_tape), the plain wavefront on the
    CPU.  K3's own forms are the lockstep differentiable form: under
    cfg.diff_wavefront they warn, as the JAX package's in-kernel gradient
    route does, and their plain version is lockstep's."""
    if form not in FORM_CAPS:
        raise ValueError(f"no gradient kernel form {form!r}")
    if form == "wave":
        cfg = cfg.replace(merged_wavefront=True, diff_wavefront=True)
    elif cfg.diff_wavefront:
        warn_diff_wavefront(cfg)
        cfg = cfg.replace(diff_wavefront=False)
    if stats and scene.device.type != "cuda":
        raise ValueError("the stats instances run on a card")
    if stats and form in ("pool", "wave"):
        raise ValueError(f"K3's {form} form has no stats instance")
    if (stats and scene.device.type == "cuda"
            and len(scene.emissive_ids) > MAX_LIGHTS):
        raise ValueError(f"the stats instances take at most {MAX_LIGHTS} "
                         f"emissive spheres, got {len(scene.emissive_ids)}")
    tab = checked_tab(scene, x0, y0, height, width, tab, FORM_CAPS[form],
                      f"the gradient kernel K3 ({form} form: "
                      f"{TABLES[form]})")
    if tuple(g_img.shape) != (height, width, 3):
        raise ValueError(f"pixel cotangent must be ({height}, {width}, 3), "
                         f"got {tuple(g_img.shape)}")
    check_device(scene, g_img)
    g_img = g_img.detach().to(torch.float32).contiguous()
    if scene.device.type == "cuda" and form == "wave":
        img, rays, tape = render_tile_wave_tape(scene, cfg, frame, x0, y0,
                                                height, width, tab=tab)
        return img, rays, sweep_wave_tape(scene, cfg, g_img, tape, tab=tab)
    if scene.device.type == "cuda" and form == "pool":
        mat, lights, cam = kernel_inputs(scene, cfg)
        out = launch_pool(tab, mat, lights, cam,
                          render_params(scene, cfg, frame, x0, y0, height,
                                        width), g_img, scene.device,
                          blocks=blocks)
        launches[COUNTERS[form] + (SOFT_SUFFIX if cfg.soft_silhouette_eps
                                   > 0.0 else "")] += 1
        return out
    if scene.device.type == "cuda":
        return _launch_grad(scene, tab, cfg, frame, g_img, x0, y0, height,
                            width, form, stats)
    if scene.device.type == "cpu":
        return render_tile_grad_plain(scene, cfg, frame, g_img, x0, y0,
                                      height, width, tab=tab)
    raise ValueError(f"no renderer for device {scene.device}")


def scene_cotangent_from_packed(scene: Scene, d_packed) -> Scene:
    """Pull a packed-table cotangent back through pack_scene to the Scene
    fields (radius^2, 1/radius with radius <= 0 -> 0, and radius all reach
    `radius`).  Returns a Scene whose fields are the gradients."""
    leaves = {f: getattr(scene, f).detach().requires_grad_(True)
              for f in PARAM_FIELDS}
    with torch.enable_grad():
        tab = pack_scene(scene.replace(**leaves))
        grads = torch.autograd.grad(tab, list(leaves.values()), d_packed)
    return scene.replace(**dict(zip(PARAM_FIELDS, grads)))


class _PackedRender(torch.autograd.Function):
    """image = render(tab): forward the render kernel (or the lockstep
    kernel), backward the gradient kernel."""

    @staticmethod
    def forward(ctx, tab, scene, cfg, frame, tile, lockstep):
        render = render_tile_lockstep if lockstep else render_tile
        img, rays = render(scene, cfg, frame, *tile, tab=tab)
        ctx.save_for_backward(tab)
        ctx.args = (scene, cfg, frame, tile)
        ctx.mark_non_differentiable(rays)
        return img, rays

    @staticmethod
    def backward(ctx, g_img, _g_rays):
        tab, = ctx.saved_tensors
        scene, cfg, frame, (x0, y0, height, width) = ctx.args
        _, _, d_tab = render_tile_grad(scene, cfg, frame, g_img, x0, y0,
                                       height, width, tab=tab)
        return d_tab, None, None, None, None, None


class _WavePackedRender(torch.autograd.Function):
    """image = render(tab) under cfg.diff_wavefront on a card.  Where the
    table requires a gradient the forward is K1's tape instance and the
    backward the sweep over the tape it kept (each path traced once a
    step); else the forward is K1.  Both give K1's image and rays bit for
    bit.  The first backward frees the tape; a second one through a
    retained graph (retain_graph=True) writes it again with the same
    forward."""

    @staticmethod
    def forward(ctx, tab, scene, cfg, frame, tile):
        ctx.tape = None
        if ctx.needs_input_grad[0]:
            img, rays, ctx.tape = render_tile_wave_tape(scene, cfg, frame,
                                                        *tile, tab=tab)
        else:
            img, rays = render_tile(scene, cfg, frame, *tile, tab=tab)
        ctx.save_for_backward(tab)
        ctx.args = (scene, cfg, frame, tile)
        ctx.mark_non_differentiable(rays)
        return img, rays

    @staticmethod
    def backward(ctx, g_img, _g_rays):
        tab, = ctx.saved_tensors
        scene, cfg, frame, tile = ctx.args
        tape, ctx.tape = ctx.tape, None
        if tape is None:
            tape = render_tile_wave_tape(scene, cfg, frame, *tile,
                                         tab=tab)[2]
        d_tab = sweep_wave_tape(scene, cfg, g_img, tape, tab=tab)
        return d_tab, None, None, None, None


def render_tile_diff(scene: Scene, cfg: RenderConfig, frame: int, x0: int,
                     y0: int, height: int, width: int,
                     lockstep_primal: bool = False):
    """Differentiable (height, width) sub-image at global pixel (x0, y0) on
    the scene's device (pallas_grad.render_tile_pallas_diff): forward the
    render kernel (the lockstep kernel with lockstep_primal), backward the
    gradient kernel; the plain versions on the CPU.  With
    cfg.diff_wavefront the differentiable wavefront: on a card the tape
    instance forward and the sweep backward (_WavePackedRender), on the
    CPU autograd through the plain wavefront; lockstep_primal is then not
    read, as the JAX package's jnp backend does not read it
    (toypathtracer_tpu/inverse.py:144-149).  The band unit a multi-device
    step differentiates.  Returns ((height, width, 3) float32, 0-d int64
    ray count)."""
    tab = pack_scene(scene)
    if cfg.diff_wavefront and scene.device.type == "cuda":
        return _WavePackedRender.apply(tab, scene, cfg, frame,
                                       (x0, y0, height, width))
    return _PackedRender.apply(tab, scene, cfg, frame,
                               (x0, y0, height, width), lockstep_primal)


def render_frame_diff(scene: Scene, cfg: RenderConfig, frame: int,
                      lockstep_primal: bool = False, device="cuda"):
    """Differentiable full frame on `device` (default: the card; "cpu"
    runs the plain versions), the counterpart of
    pallas_grad.render_frame_pallas_diff.  Gradients reach the fields of
    `scene` through the move to the device.  Returns ((H, W, 3) float32,
    0-d int64 ray count)."""
    scene = scene.to(resolve_device(device))
    return render_tile_diff(scene, cfg, frame, 0, 0, cfg.height, cfg.width,
                            lockstep_primal)
