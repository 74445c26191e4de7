"""The scaled scene's kernel wrappers (counterpart of toypathtracer_tpu/ops/
scaled_pallas.py and of scaled.py's renderer).

`hit_chunks` (K5, the port of scaled_pallas.py::_hit_kernel) and
`shadow_chunks` (K6, ::_shadow_kernel) take the JAX layout: the
pack_chunks rows and tuples of ray lane planes of any one shape.
`hit_chunks_form` and `shadow_chunks_form` reach both forms of each --
"coop" (the main path's: the warp-cooperative chunk walk of csrc/coop.cuh
with the scene's scaled.chunk_index) and "thread" (the per-thread form it
replaced, the baseline it is held bit-equal to) -- and their counted
instances.
`render_tile_scaled` / `render_frame_scaled` render a ScaledScene through
the scaled render kernel, one launch a frame (the port of
scaled.py::_render_frame_scaled_pallas): the warp-cooperative form
(csrc/coop.cuh); `render_frame_scaled_sharded` splits the frame's rows
into a parallel/mesh.RowMesh's bands, one launch a band.
`render_tile_scaled_form` reaches both forms of that kernel -- "coop" (the main path's) and "lane" (the per-lane form it
replaced, the baseline it is held bit-equal to) -- and their stats
instances, which also return the traversal's work counters.  All are in
csrc/scaled.cu.  CUDA tensors launch the kernels; CPU tensors take the
plain versions (scaled.ChunkTraversal, scaled.render_tile_scaled_plain).
There is no fallback: on a CUDA tensor a failed build, a refused launch or
an unsupported shape raises.  `launches` counts kernel launches, per form.

The scaled scene's gradient (scaled.py:712 render_frame_scaled(...,
differentiable=True), BASELINE config 5 with gradients), K3 over chunks:
on a card its cooperative form (csrc/coopgrad.cuh) is two kernels -- the
scaled render kernel's tape-writing instance (csrc/scaled.cu
tape_render_kernel, `render_tile_scaled_tape`: the image, the rays, and
each bounce's carry record in a frame-sized tape, 64 bytes a (pixel,
sample, bounce) plus a word per 32 lights: 2.5 GB at 1280x720, spp 4,
depth 10) and the reverse sweep over that tape (csrc/chunkgrad.cu
chunk_sweep_kernel, `sweep_scaled_tape`; its soft instance, with the soft
estimator's chunk scans as warp walks, where cfg.soft_silhouette_eps >
0).  `render_tile_scaled_grad` runs both; `render_tile_scaled_grad_form`
also reaches "chunk", the per-lane chunked instance (csrc/grad.cu
chunk_grad_kernel, the per-lane walks, kept as the baseline the
cooperative form's cotangent is held bit-equal to), and its stats
instance.  On the CPU: autograd through the plain version.
`render_tile_scaled_diff` / `render_frame_scaled(..., differentiable=True)`
are the differentiable renders: on a card a torch.autograd.Function on the
packed scene table whose forward is the tape-writing render where the
table requires a gradient (else the scaled render kernel) and whose
backward is the sweep over the tape the forward kept, so a training step
traces each path once; on the CPU autograd through the plain version.  A
frame whose tape does not fit in the card's free memory raises, naming
the row bands (render_tile_scaled_diff on sub-images) that do fit.
Gradients reach every float field of the ScaledScene through pack_scene;
the chunk boxes carry none.

The sphere and chunk limits of the kernels' storage bind on a card only
(`_check_scene`): the per-lane render form and the per-lane chunked K3 keep a
lane's seen lights in 16 bits (MAX_LIGHTS), and K6 answers for 16 lights a
launch (`mask_lights`: 32 a call of its plain version, an int32 mask;
ChunkedScenePort.lights_visible takes any number in groups); every other
kernel here takes any number of lights, and the plain versions any scene.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import RenderConfig, resolve_device, warn_diff_wavefront
from ..parallel.mesh import RowMesh, device_scope, join_bands, replicate
from ..scaled import (ChunkTraversal, ScaledScene, boxes_grouped,
                      chunk_index, group_boxes, pack_chunks,
                      render_tile_scaled_grad_plain,
                      render_tile_scaled_plain, soft_boxes, sphere_records,
                      walk_order)
from . import _build
from .cuda_grad import (alloc_tape, launch_pool, pool_grid,
                        pool_table_launch)
from .cuda_grad import tape_bytes as frame_tape_bytes
from .cuda_render import (LOOP_FIELDS, MAX_LIGHTS, STAT_FIELDS, STAT_SLOTS,
                          cuda_call, kernel_camera, pack_scene,
                          render_params)

# Largest chunk count whose AABBs the kernels stage in shared memory
# (csrc/chunks.cuh kMaxChunks).
MAX_CHUNKS = 4096
# Lights the cooperative render's NEE takes in one pass (csrc/coop.cuh
# kCoopNeeGroup); past them its lights instance, which has no stats
# instance, takes them in passes.
COOP_NEE_GROUP = 16

# The scaled render kernel's forms (tpt_scaled_render_launch's `form`)
# and their launch counters: "scaled_render" counts the main path's form.
FORMS = {"lane": 0, "coop": 1}
MAIN_FORM = "coop"
COUNTERS = {"coop": "scaled_render", "lane": "scaled_render_lane"}

# K5's and K6's forms and their launch counters: "hit_chunks" and
# "shadow_chunks" count the main path's forms, "*_counted" the counted
# instances of either form.
HIT_FORMS = ("coop", "thread")
HIT_MAIN_FORM = "coop"
HIT_COUNTERS = {"coop": "hit_chunks", "thread": "hit_chunks_baseline"}
SHADOW_FORMS = {"thread": 0, "coop": 1}  # tpt_shadow_chunks_launch's form
SHADOW_MAIN_FORM = "coop"
SHADOW_COUNTERS = {"coop": "shadow_chunks",
                   "thread": "shadow_chunks_baseline"}

# The scaled gradient's forms (render_tile_scaled_grad_form): "coop", the main
# path's (the tape-writing render and the sweep), and "chunk", the per-lane
# chunked instance, the baseline.  Launch counters: "scaled_tape" counts the
# tape-writing render, "scaled_grad" / "scaled_grad_soft" the sweep,
# "scaled_grad_baseline" / "scaled_grad_baseline_soft" the per-lane kernel and
# "scaled_grad_stats" its stats instance.
GRAD_FORMS = ("coop", "chunk")
GRAD_MAIN_FORM = "coop"

launches = {"scaled_render": 0, "scaled_render_lane": 0,
            "scaled_render_stats": 0, "scaled_tape": 0, "scaled_grad": 0,
            "scaled_grad_soft": 0, "scaled_grad_baseline": 0,
            "scaled_grad_baseline_soft": 0, "scaled_grad_stats": 0,
            "hit_chunks": 0,
            "hit_chunks_baseline": 0, "hit_chunks_counted": 0,
            "shadow_chunks": 0, "shadow_chunks_baseline": 0,
            "shadow_chunks_counted": 0}


def _check_rows(rows: torch.Tensor, chunk: int):
    if chunk < 1 or rows.dim() != 2 or rows.shape[1] != 4 * chunk + 8:
        raise ValueError(f"chunk rows must be (C, 4 * {chunk} + 8), got "
                         f"{tuple(rows.shape)}")
    if not 1 <= rows.shape[0] <= MAX_CHUNKS:
        raise ValueError(f"the kernels stage 1..{MAX_CHUNKS} chunk boxes in "
                         f"shared memory, got {rows.shape[0]} chunks")
    if rows.dtype != torch.float32 or not rows.is_contiguous():
        raise ValueError("chunk rows must be contiguous float32")


def _planes(planes, shape, dev) -> torch.Tensor:
    """Lane planes of one shape -> a contiguous (len(planes), P) float32
    tensor on `dev`."""
    for p in planes:
        if p.shape != shape or p.dtype != torch.float32 or p.device != dev:
            raise ValueError(f"lane planes must be float32 {tuple(shape)} on "
                             f"{dev}, got {p.dtype} {tuple(p.shape)} on "
                             f"{p.device}")
    return torch.stack([p.reshape(-1) for p in planes]).contiguous()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _f32(x) -> float:
    return float(np.float32(x))


def _check_index(index, rows: torch.Tensor, chunk: int, lib):
    """Refuse a scaled.chunk_index that does not fit the rows."""
    C, dev = rows.shape[0], rows.device
    for name, t, want, dtype in (
            ("order", index.order, (C,), torch.int32),
            ("group boxes", index.gbox, (lib.tpt_scaled_groups(C), 6),
             torch.float32),
            ("sphere records", index.rec, (C * chunk, 4), torch.float32)):
        if (t.shape != want or t.dtype != dtype or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"chunk index {name} must be contiguous "
                             f"{dtype} {want} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def hit_chunks(rows: torch.Tensor, ro, rd, chunk: int, t_min: float,
               t_max: float, index=None):
    """Nearest hit of each ray over all chunks (hit_chunks_tiles):
    (t float32, id int32) in the lanes' shape, t_max and -1 on a miss.
    `rows` is pack_chunks' output; ro and rd are 3 lane planes each.
    index: the rows' scaled.chunk_index, built here when None
    (ChunkedScenePort passes its own)."""
    return hit_chunks_form(rows, ro, rd, chunk, t_min, t_max,
                           HIT_MAIN_FORM, index=index)


def hit_chunks_form(rows: torch.Tensor, ro, rd, chunk: int, t_min: float,
                    t_max: float, form: str, index=None,
                    stats: bool = False):
    """hit_chunks through K5's form `form` (HIT_FORMS); both give the same
    ids and t bit for bit.  stats=True launches the form's counted instance
    and returns a third value (on a card only), its counters as {"hit":
    stats_dict's kind, "groups": {"boxes", "slabs"}}: the chunk walk, and
    the cooperative form's prefilter (0 for the per-thread form).  On the
    CPU the plain version, whatever the form."""
    _check_rows(rows, chunk)
    if form not in HIT_FORMS:
        raise ValueError(f"no K5 form {form!r}")
    dev = rows.device
    shape = ro[0].shape
    R, D = _planes(ro, shape, dev), _planes(rd, shape, dev)
    n = R.shape[1]
    if dev.type == "cpu":
        if stats:
            raise ValueError("K5's counted instances run on a card")
        t, hid, _, _ = ChunkTraversal(rows, chunk).nearest_hit(
            tuple(R), tuple(D), _f32(t_min), _f32(t_max))
        return t.reshape(shape), hid.to(torch.int32).reshape(shape)
    if dev.type != "cuda":
        raise ValueError(f"no traversal for device {dev}")
    lib = _build.load_library()
    coop = form == "coop"
    if coop:
        index = chunk_index(rows, chunk) if index is None else index
        _check_index(index, rows, chunk, lib)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    hid = torch.empty((n,), dtype=torch.int32, device=dev)
    counts = torch.zeros((STAT_SLOTS,), dtype=torch.int64, device=dev) \
        if stats else None
    st = counts.data_ptr() if stats else None
    with torch.cuda.device(dev):
        if coop:
            next_ray = torch.zeros((1,), dtype=torch.int32, device=dev)
            code = lib.tpt_coop_hit_launch(
                rows.data_ptr(), index.order.data_ptr(),
                index.rec.data_ptr(), index.gbox.data_ptr(), rows.shape[0],
                chunk, R.data_ptr(), D.data_ptr(), n, _f32(t_min),
                _f32(t_max), next_ray.data_ptr(), t.data_ptr(),
                hid.data_ptr(), st, _stream(dev))
        else:
            code = lib.tpt_hit_chunks_launch(
                rows.data_ptr(), rows.shape[0], chunk, R.data_ptr(),
                D.data_ptr(), n, _f32(t_min), _f32(t_max), t.data_ptr(),
                hid.data_ptr(), st, _stream(dev))
    cuda_call(lib, "hit_chunks", code)
    launches["hit_chunks_counted" if stats else HIT_COUNTERS[form]] += 1
    out = (t.reshape(shape), hid.reshape(shape))
    if stats:
        # K5 traces no shadow rays: the cooperative form's prefilter counts
        # its group boxes in the shadow kind's box slots (coop.cuh
        # kStGroupBoxes), and the per-thread form leaves them 0
        st = stats_dict(counts.cpu())
        shadow = st.pop("shadow")
        del st["loop"]
        st["groups"] = {"boxes": shadow["boxes"], "slabs": shadow["slabs"]}
        return (*out, st)
    return out


def mask_lights(dev) -> int:
    """The lights one shadow_chunks call takes on `dev`: the kernels' 16
    (a lane's 16-bit mask, coop.cuh nee_pass) on a card, the 32 bits of
    the plain version's int32 mask (ChunkTraversal.occlusion_bits)
    elsewhere."""
    return MAX_LIGHTS if torch.device(dev).type == "cuda" else 32


def shadow_chunks(rows: torch.Tensor, ro, dirs, t_ls, chunk: int,
                  light_ids, t_min: float, index=None):
    """NEE occlusion bitmask (shadow_chunks_tiles): bit k of each ray is
    set when a sphere other than light k overlaps (t_min, t_ls[k]) along
    light k's direction.  ro: 3 lane planes; dirs: 3 * n_l planes, light
    by light; t_ls: n_l planes.  index: the rows' scaled.chunk_index,
    built here when None (ChunkedScenePort passes its own).  Returns int32
    lanes."""
    return shadow_chunks_form(rows, ro, dirs, t_ls, chunk, light_ids, t_min,
                              SHADOW_MAIN_FORM, index=index)


def shadow_chunks_form(rows: torch.Tensor, ro, dirs, t_ls, chunk: int,
                       light_ids, t_min: float, form: str, index=None,
                       stats: bool = False):
    """shadow_chunks through K6's form `form` (SHADOW_FORMS); both give the
    same bits.  stats=True launches the form's counted instance and returns
    a second value, stats_dict of its counters (on a card only).  On the
    CPU the plain version, whatever the form."""
    _check_rows(rows, chunk)
    if form not in SHADOW_FORMS:
        raise ValueError(f"no K6 form {form!r}")
    n_l = len(light_ids)
    if len(dirs) != 3 * n_l or len(t_ls) != n_l:
        raise ValueError(f"{n_l} lights need {3 * n_l} direction and {n_l} "
                         f"t_l planes, got {len(dirs)} and {len(t_ls)}")
    dev = rows.device
    cap = mask_lights(dev)
    if n_l > cap:
        raise ValueError(f"K6's mask on {dev.type} holds at most {cap} "
                         f"lights, got {n_l}: query them in groups "
                         f"(ChunkedScenePort.lights_visible)")
    shape = ro[0].shape
    R = _planes(ro, shape, dev)
    L = _planes(dirs, shape, dev) if n_l else R[:0]
    T = _planes(t_ls, shape, dev) if n_l else R[:0]
    n = R.shape[1]
    if dev.type == "cpu":
        if stats:
            raise ValueError("K6's counted instances run on a card")
        occ, _, _ = ChunkTraversal(rows, chunk).occlusion_bits(
            tuple(R), [tuple(L[3 * k:3 * k + 3]) for k in range(n_l)], T,
            light_ids, _f32(t_min))
        return occ.reshape(shape)
    if dev.type != "cuda":
        raise ValueError(f"no traversal for device {dev}")
    lib = _build.load_library()
    coop = form == "coop"
    if coop:
        index = chunk_index(rows, chunk) if index is None else index
        _check_index(index, rows, chunk, lib)
    # pinned and without blocking, as ops/cuda_render.kernel_camera
    ids = torch.from_numpy(np.array(list(light_ids) or [0], np.int32))
    ids = ids.pin_memory().to(dev, non_blocking=True)
    occ = torch.empty((n,), dtype=torch.int32, device=dev)
    next_ray = torch.zeros((1,), dtype=torch.int32, device=dev)
    counts = torch.zeros((STAT_SLOTS,), dtype=torch.int64, device=dev) \
        if stats else None
    with torch.cuda.device(dev):
        code = lib.tpt_shadow_chunks_launch(
            rows.data_ptr(), *((index.order.data_ptr(), index.rec.data_ptr(),
                                index.gbox.data_ptr()) if coop
                               else (None, None, None)),
            rows.shape[0], chunk, R.data_ptr(), L.data_ptr(), T.data_ptr(),
            ids.data_ptr(), n_l, n, _f32(t_min), SHADOW_FORMS[form],
            next_ray.data_ptr(), occ.data_ptr(),
            counts.data_ptr() if stats else None, _stream(dev))
    cuda_call(lib, "shadow_chunks", code)
    launches["shadow_chunks_counted" if stats else SHADOW_COUNTERS[form]] += 1
    if stats:
        return occ.reshape(shape), stats_dict(counts.cpu())
    return occ.reshape(shape)


def _check_scene(scene: ScaledScene, kernel: str = None):
    """The scene's shapes on any device; on a card also the limits of the
    named kernel's storage: the chunk boxes the kernels stage in shared
    memory, and for the per-lane render form and the per-lane chunked K3
    ("lane", "chunk") the 16 lights of a uint32 mask.  The plain versions
    take any count of lights."""
    n, K = scene.n_spheres, scene.chunk
    if n % K or scene.chunk_aabb.shape != (n // K, 6):
        raise ValueError(f"{n} spheres in chunks of {K} need "
                         f"({n // K}, 6) chunk boxes, got "
                         f"{tuple(scene.chunk_aabb.shape)}")
    if scene.device.type == "cuda" and n // K > MAX_CHUNKS:
        raise ValueError(f"the scaled render kernel stages at most "
                         f"{MAX_CHUNKS} chunk boxes in shared memory, got "
                         f"{n // K}")
    if (scene.device.type == "cuda" and kernel in ("lane", "chunk")
            and len(scene.emissive_ids) > MAX_LIGHTS):
        raise ValueError(f"the {kernel} form takes at most {MAX_LIGHTS} "
                         f"emissive spheres, got "
                         f"{len(scene.emissive_ids)}")
    if any(not 0 <= e < n for e in scene.emissive_ids):
        raise ValueError(f"emissive ids out of range: {scene.emissive_ids}")
    for name in ("center", "radius", "albedo", "emissive", "roughness", "ri",
                 "chunk_aabb"):
        t = getattr(scene, name)
        if t.dtype != torch.float32 or t.device != scene.device:
            raise ValueError(f"scene.{name} must be float32 on "
                             f"{scene.device}, got {t.dtype} on {t.device}")


class ScaledInputs(NamedTuple):
    """A ScaledScene's packed inputs to the scaled render on its device,
    built once where several sub-images share them (the bands of
    render_frame_scaled_sharded on one device): the packed table, the
    pack_chunks rows and, on a card, the group boxes over the rows' order
    and the int32 material ids."""
    tab: torch.Tensor
    rows: torch.Tensor
    gbox: Optional[torch.Tensor]
    mat: Optional[torch.Tensor]


def scaled_inputs(scene: ScaledScene) -> ScaledInputs:
    """The ScaledInputs of `scene` on its device."""
    tab = pack_scene(scene).detach().contiguous()
    rows = pack_chunks(scene)
    if scene.device.type != "cuda":
        return ScaledInputs(tab, rows, None, None)
    return ScaledInputs(tab, rows, group_boxes(rows, scene.chunk),
                        scene.mat_ids().contiguous())


def render_tile_scaled(scene: ScaledScene, cfg: RenderConfig, frame: int,
                       x0: int, y0: int, height: int, width: int,
                       inputs: Optional[ScaledInputs] = None):
    """Render the (height, width) sub-image of a ScaledScene whose
    lower-left pixel is the global pixel (x0, y0), on the scene's device:
    the scaled render kernel on a card, the plain version on the CPU.
    `inputs`: the scene's scaled_inputs, built here when None.
    Returns ((height, width, 3) float32, 0-d int64 ray count)."""
    return render_tile_scaled_form(scene, cfg, frame, x0, y0, height, width,
                                   MAIN_FORM, inputs=inputs)


def stats_dict(v) -> dict:
    """A stats instance's STAT_SLOTS totals as {"hit": {...}, "shadow":
    {...}, "loop": {...}} of ints, with each kind's sphere-loop SIMT
    efficiency need / (32 trips)."""
    v = [int(x) for x in v]
    out = {}
    for k, kind in enumerate(("hit", "shadow")):
        d = dict(zip(STAT_FIELDS, v[6 * k:6 * k + 6]))
        d["simt_efficiency"] = d["need"] / (32 * d["trips"]) \
            if d["trips"] else None
        out[kind] = d
    out["loop"] = dict(zip(LOOP_FIELDS, v[12:]))
    return out


def render_tile_scaled_form(scene: ScaledScene, cfg: RenderConfig,
                            frame: int, x0: int, y0: int, height: int,
                            width: int, form: str, stats: bool = False,
                            inputs: Optional[ScaledInputs] = None):
    """render_tile_scaled through the kernel form `form` (FORMS); both
    forms compute the same image and ray count.  stats=True launches the
    form's stats instance and returns a third value, stats_dict of its
    counters.  `inputs`: the scene's scaled_inputs, built here when
    None.  On the CPU it returns the counts the plain version's work
    counters give that do not depend on warps: the hit rays' sphere tests
    ("need") and, for "lane", whose shadow rays take the chunks in order,
    theirs and the slab tests of both kinds ("slabs")."""
    _check_scene(scene, form)
    if form not in FORMS:
        raise ValueError(f"no scaled render form {form!r}")
    if not (height >= 1 and width >= 1 and x0 >= 0 and y0 >= 0):
        raise ValueError(f"bad sub-image {height}x{width} at ({x0}, {y0})")
    dev = scene.device
    if (stats and dev.type == "cuda"
            and len(scene.emissive_ids) > COOP_NEE_GROUP):
        raise ValueError(f"the stats instances take at most {COOP_NEE_GROUP} "
                         f"emissive spheres, got {len(scene.emissive_ids)}")
    if dev.type == "cpu":
        if not stats:
            if inputs is None:
                return render_tile_scaled_plain(scene, cfg, frame, x0, y0,
                                                height, width)
            return render_tile_scaled_plain(scene, cfg, frame, x0, y0,
                                            height, width, tab=inputs.tab,
                                            rows=inputs.rows)
        img, rays, work = render_tile_scaled_plain(scene, cfg, frame, x0, y0,
                                                   height, width, True)
        counts = {"hit": {"need": int(work.hit_tests.sum())}}
        if form == "lane":
            counts["shadow"] = {"need": int(work.occlusion_tests.sum())}
            counts["slabs"] = int(work.slab_tests.sum())
        return img, rays, counts
    if dev.type != "cuda":
        raise ValueError(f"no renderer for device {dev}")
    lib = _build.load_library()
    tab, rows, gbox, mat = scaled_inputs(scene) if inputs is None else inputs
    if gbox.shape[0] != lib.tpt_scaled_groups(scene.n_chunks):
        raise ValueError("scaled.GROUP differs from the kernel's group size")
    lights, cam = kernel_camera(scene, cfg)
    out = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    counts = torch.zeros((STAT_SLOTS,), dtype=torch.int64, device=dev) \
        if stats else None
    next_tile = torch.zeros((1,), dtype=torch.int32, device=dev)
    params = render_params(scene, cfg, frame, x0, y0, height, width)
    with torch.cuda.device(dev):
        code = lib.tpt_scaled_render_launch(
            tab.data_ptr(), rows.data_ptr(), gbox.data_ptr(), mat.data_ptr(),
            lights.data_ptr(), cam.data_ptr(), ctypes.byref(params),
            scene.n_chunks, scene.chunk, FORMS[form], out.data_ptr(),
            rays.data_ptr(), next_tile.data_ptr(),
            counts.data_ptr() if stats else None, None, None, None,
            _stream(dev))
    cuda_call(lib, "scaled_render", code)
    launches["scaled_render_stats" if stats else COUNTERS[form]] += 1
    if stats:
        return out, rays, stats_dict(counts.cpu())
    return out, rays


def _chunk_inputs(scene: ScaledScene, cfg: RenderConfig, walk: bool):
    """The chunked gradient kernels' scene inputs on the card: the
    pack_chunks rows and chunk boxes, with the soft estimator the scans'
    inflated boxes (scaled.soft_boxes) and, for the cooperative sweep
    (`walk`), a spatial order of the chunks (scaled.walk_order, computed on
    the card: no host round trip a step) and the sphere records, with each
    scan's boxes in that order and their group boxes."""
    C, K = scene.n_chunks, scene.chunk
    rows = pack_chunks(scene)
    box = rows[:, 4 * K:4 * K + 6].contiguous()
    chunks = dict(rows=rows, box=box, n_chunks=C, chunk=K)
    if cfg.soft_silhouette_eps > 0.0:
        rmax = scene.radius.detach().reshape(C, K).amax(dim=1)
        b = soft_boxes(box, rmax, cfg.soft_silhouette_eps)
        chunks.update(sil_box=b["silhouette"], prox_box=b["proximity"])
        if walk:
            order = walk_order(box)
            for key, kind in (("sil", "silhouette"), ("prox", "proximity")):
                wb = b[kind][order.long()].contiguous()
                chunks[key + "_walk"] = wb
                chunks[key + "_gbox"] = boxes_grouped(wb)
            chunks.update(order=order, rec=sphere_records(rows, K),
                          n_groups=chunks["sil_gbox"].shape[0])
    return chunks


def _grad_args(scene: ScaledScene, g_img, x0, y0, height, width, tab):
    if not (height >= 1 and width >= 1 and x0 >= 0 and y0 >= 0):
        raise ValueError(f"bad sub-image {height}x{width} at ({x0}, {y0})")
    if tuple(g_img.shape) != (height, width, 3):
        raise ValueError(f"pixel cotangent must be ({height}, {width}, 3), "
                         f"got {tuple(g_img.shape)}")
    dev = scene.device
    if dev.type == "cuda":
        tab = (pack_scene(scene) if tab is None else tab).detach()
        tab = tab.contiguous()
        if tab.shape != (14, scene.n_spheres) or tab.device != dev:
            raise ValueError(f"packed table must be (14, {scene.n_spheres}) "
                             f"on {dev}, got {tuple(tab.shape)} on "
                             f"{tab.device}")
    return g_img.detach().to(device=dev, dtype=torch.float32).contiguous(), tab


def tape_bytes(scene: ScaledScene, cfg: RenderConfig, height: int,
               width: int) -> int:
    """Bytes of the tape the tape-writing render keeps for a (height,
    width) sub-image (cuda_grad.tape_bytes)."""
    return frame_tape_bytes(len(scene.emissive_ids), cfg, height, width)


def render_tile_scaled_tape(scene: ScaledScene, cfg: RenderConfig,
                            frame: int, x0: int, y0: int, height: int,
                            width: int, tab=None):
    """The scaled render kernel's tape-writing instance on a card (the
    forward of the cooperative chunked gradient): ((height, width, 3)
    image, 0-d int64 rays, tape), the image and rays the scaled render
    kernel's bit for bit, the tape a dict of its tensors ("rec", "see",
    "depth") for sweep_scaled_tape.  Raises where the tape
    (tape_bytes) does not fit in the card's free memory: render the frame
    in row bands instead (render_tile_scaled_diff on sub-images); it never
    falls back to another kernel."""
    _check_scene(scene, "coop")
    if scene.device.type != "cuda":
        raise ValueError("the tape-writing render runs on a card")
    dev = scene.device
    tape = alloc_tape(len(scene.emissive_ids), cfg, height, width, dev,
                      "the scaled gradient",
                      "render_tile_scaled_diff on sub-images")
    lib = _build.load_library()
    tab = (pack_scene(scene) if tab is None else tab).detach().contiguous()
    rows = pack_chunks(scene)
    gbox = group_boxes(rows, scene.chunk)
    mat = scene.mat_ids().contiguous()
    lights, cam = kernel_camera(scene, cfg)
    out = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    next_tile = torch.zeros((1,), dtype=torch.int32, device=dev)
    params = render_params(scene, cfg, frame, x0, y0, height, width)
    with torch.cuda.device(dev):
        code = lib.tpt_scaled_render_launch(
            tab.data_ptr(), rows.data_ptr(), gbox.data_ptr(), mat.data_ptr(),
            lights.data_ptr(), cam.data_ptr(), ctypes.byref(params),
            scene.n_chunks, scene.chunk, 2, out.data_ptr(), rays.data_ptr(),
            next_tile.data_ptr(), None, tape["rec"].data_ptr(),
            tape["see"].data_ptr(), tape["depth"].data_ptr(), _stream(dev))
    cuda_call(lib, "scaled_tape", code)
    launches["scaled_tape"] += 1
    tape["tile"] = (frame, x0, y0, height, width)
    return out, rays, tape


def sweep_scaled_tape(scene: ScaledScene, cfg: RenderConfig, g_img, tape,
                      tab=None):
    """The cooperative chunked gradient's reverse sweep on a card
    (csrc/chunkgrad.cu, its soft instance where cfg.soft_silhouette_eps >
    0) over the tape render_tile_scaled_tape wrote for the same scene,
    config and sub-image: d_packed (14, N) for the pixel cotangent g_img,
    the per-lane chunked instance's cotangent bit for bit (it runs on that
    kernel's grid and sums through the same table).  Records the table's
    scratch in cuda_grad.last_pool."""
    frame, x0, y0, height, width = tape["tile"]
    _check_scene(scene, "coop")
    g_img, tab = _grad_args(scene, g_img, x0, y0, height, width, tab)
    chunks = _chunk_inputs(scene, cfg, walk=True)
    params = render_params(scene, cfg, frame, x0, y0, height, width)
    lights, _ = kernel_camera(scene, cfg)
    mat = scene.mat_ids().contiguous()
    dev = scene.device
    lib = _build.load_library()

    def ptr(key):
        t = chunks.get(key)
        return None if t is None else t.data_ptr()

    def launch(direc, blocks_t, nxt, block_cap, pool, cap, n_blocks):
        with torch.cuda.device(dev):
            code = lib.tpt_chunk_sweep_launch(
                tab.data_ptr(), mat.data_ptr(), lights.data_ptr(),
                ptr("rows"), ptr("box"), ptr("sil_box"), ptr("prox_box"),
                ptr("order"), ptr("rec"), ptr("sil_walk"), ptr("sil_gbox"),
                ptr("prox_walk"), ptr("prox_gbox"), chunks.get("n_groups", 0),
                chunks["n_chunks"], chunks["chunk"], ctypes.byref(params),
                g_img.data_ptr(), n_blocks, tape["rec"].data_ptr(),
                tape["see"].data_ptr(), tape["depth"].data_ptr(),
                direc.data_ptr(), blocks_t.data_ptr(), nxt[1:].data_ptr(),
                block_cap, pool.data_ptr(), nxt.data_ptr(), cap, _stream(dev))
        cuda_call(lib, "scaled_sweep", code)
    n_blocks, _ = pool_grid(params, dev, chunked=True)
    d_tab = pool_table_launch(launch, params, dev, n_blocks)
    launches["scaled_grad_soft" if cfg.soft_silhouette_eps > 0.0
             else "scaled_grad"] += 1
    return d_tab


def render_tile_scaled_grad(scene: ScaledScene, cfg: RenderConfig,
                            frame: int, g_img, x0: int, y0: int, height: int,
                            width: int, tab=None):
    """Value and packed-scene cotangent of the (height, width) sub-image of
    a ScaledScene at global pixel (x0, y0) for the pixel cotangent g_img
    ((height, width, 3)): on a card K3's cooperative chunked form (the
    tape-writing render, then the sweep over its tape; with
    cfg.soft_silhouette_eps > 0 its soft instance), autograd through the
    plain version on the CPU.  `tab`: the packed table (default
    pack_scene(scene)).  Returns ((height, width, 3) float32 image, 0-d
    int64 ray count, d_packed (14, N) float32)."""
    return render_tile_scaled_grad_form(scene, cfg, frame, g_img, x0, y0,
                                        height, width, GRAD_MAIN_FORM,
                                        tab=tab)


def render_tile_scaled_grad_form(scene: ScaledScene, cfg: RenderConfig,
                                 frame: int, g_img, x0: int, y0: int,
                                 height: int, width: int, form: str,
                                 tab=None, stats: bool = False):
    """render_tile_scaled_grad through the form `form` (GRAD_FORMS) on a
    card: "coop" (two launches: render_tile_scaled_tape and
    sweep_scaled_tape) or "chunk" (the per-lane chunk_grad_kernel, one launch,
    at most MAX_LIGHTS lights; stats=True its stats instance, returning a
    fourth value, its counters by cuda_grad.STAT_FIELDS).  Both give the
    same image, rays and cotangent bit for bit on the same grid.  On the
    CPU the plain version, whatever the form."""
    if form not in GRAD_FORMS:
        raise ValueError(f"no scaled gradient form {form!r}")
    if stats and form != "chunk":
        raise ValueError("only the chunk form has a stats instance")
    _check_scene(scene, form)
    g_img, tab = _grad_args(scene, g_img, x0, y0, height, width, tab)
    warn_diff_wavefront(cfg)
    dev = scene.device
    if dev.type == "cpu":
        if stats:
            raise ValueError("the stats instances run on a card")
        return render_tile_scaled_grad_plain(scene, cfg, frame, g_img, x0,
                                             y0, height, width, tab=tab)
    if dev.type != "cuda":
        raise ValueError(f"no renderer for device {dev}")
    if form == "coop":
        img, rays, tape = render_tile_scaled_tape(scene, cfg, frame, x0, y0,
                                                  height, width, tab=tab)
        return img, rays, sweep_scaled_tape(scene, cfg, g_img, tape, tab=tab)
    chunks = _chunk_inputs(scene, cfg, walk=False)
    lights, cam = kernel_camera(scene, cfg)
    out = launch_pool(tab, scene.mat_ids().contiguous(), lights, cam,
                      render_params(scene, cfg, frame, x0, y0, height, width),
                      g_img, dev, chunks=chunks, stats=stats)
    launches["scaled_grad_stats" if stats else "scaled_grad_baseline_soft"
             if cfg.soft_silhouette_eps > 0.0 else "scaled_grad_baseline"] += 1
    return out


class _ScaledPackedRender(torch.autograd.Function):
    """image = render(tab) of a ScaledScene on a card.  Where the table
    requires a gradient the forward is the tape-writing render and the
    backward the sweep over the tape it kept (K3's cooperative chunked
    form: each path traced once a step); else the forward is the scaled
    render kernel.  Both forwards give the scaled render kernel's image
    and rays bit for bit, which is the reference's lockstep primal.  The
    first backward frees the tape; a second one through a retained graph
    (retain_graph=True) writes it again with the same forward."""

    @staticmethod
    def forward(ctx, tab, scene, cfg, frame, tile):
        ctx.tape = None
        if ctx.needs_input_grad[0]:
            img, rays, ctx.tape = render_tile_scaled_tape(scene, cfg, frame,
                                                          *tile, tab=tab)
        else:
            img, rays = render_tile_scaled(scene, cfg, frame, *tile)
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
            tape = render_tile_scaled_tape(scene, cfg, frame, *tile,
                                           tab=tab)[2]
        d_tab = sweep_scaled_tape(scene, cfg, g_img, tape, tab=tab)
        return d_tab, None, None, None, None


def render_tile_scaled_diff(scene: ScaledScene, cfg: RenderConfig,
                            frame: int, x0: int, y0: int, height: int,
                            width: int):
    """Differentiable (height, width) sub-image of a ScaledScene at global
    pixel (x0, y0) on the scene's device: on a card the scaled render
    kernel forward and the chunked K3 backward, on the CPU autograd through
    the plain version (with the soft estimator's chunk scans where
    cfg.soft_silhouette_eps > 0).  Returns ((height, width, 3) float32,
    0-d int64 ray count)."""
    warn_diff_wavefront(cfg)
    tab = pack_scene(scene)
    if scene.device.type == "cuda":
        return _ScaledPackedRender.apply(tab, scene, cfg, frame,
                                         (x0, y0, height, width))
    if scene.device.type != "cpu":
        raise ValueError(f"no renderer for device {scene.device}")
    _check_scene(scene)
    return render_tile_scaled_plain(scene, cfg, frame, x0, y0, height, width,
                                    tab=tab)


def render_frame_scaled(scene: ScaledScene, cfg: RenderConfig, frame: int,
                        device="cuda", row_blocks: int = 8,
                        differentiable: bool = False):
    """Render one full frame of a ScaledScene on `device` (default: the
    card; "cpu" runs the plain version).  `row_blocks` is accepted and
    ignored: it never changes the image.  differentiable=True: the
    differentiable render (render_tile_scaled_diff; the JAX package's
    lockstep form, whose image is the same), gradients reaching the
    scene's float fields through the move to the device.  Returns ((H, W,
    3) float32, 0-d int64 ray count)."""
    scene = scene.to(resolve_device(device))
    if differentiable:
        return render_tile_scaled_diff(scene, cfg, frame, 0, 0, cfg.height,
                                       cfg.width)
    return render_tile_scaled(scene, cfg, frame, 0, 0, cfg.height, cfg.width)


def render_frame_scaled_sharded(scene: ScaledScene, cfg: RenderConfig,
                                frame: int, mesh: RowMesh,
                                pallas: Optional[bool] = None,
                                interpret: bool = False):
    """Render one frame of a ScaledScene with its rows split into the
    mesh's bands (the JAX package's scaled.py:830, BASELINE config 5's
    "tiles + ray batches sharded across a pod slice"): each band is
    render_tile_scaled at its global y0 on its device, the scaled render
    kernel on a card and the plain chunk traversal on the CPU, with the
    scene and its scaled_inputs built once per distinct device; the ray
    counts are summed as parallel/mesh.render_frame_sharded sums them.
    Bit-equal to render_frame_scaled.  `pallas` and `interpret` are
    accepted for the JAX signature and, as row_blocks, never change the
    image or move a card's band off its kernel.

    Returns (image, 0-d int64 ray count of the whole frame): the full (H,
    W, 3) frame on mesh.devices[0], or with a process group this
    process's rows."""
    replicas = replicate(scene, mesh)
    inputs = {}
    for dev, rep in replicas.items():
        _check_scene(rep)
        with device_scope(dev):
            inputs[dev] = scaled_inputs(rep)
    out = []
    for dev, y0, rows in mesh.bands(cfg.height):
        with device_scope(dev):
            out.append(render_tile_scaled(replicas[dev], cfg, frame, 0, y0,
                                          rows, cfg.width,
                                          inputs=inputs[dev]))
    return join_bands(out, mesh)
