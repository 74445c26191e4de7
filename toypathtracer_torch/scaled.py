"""Scaled scenes: 100k procedurally instanced spheres in Morton-sorted
chunks with AABB culling (counterpart of toypathtracer_tpu/scaled.py).

The scene is built on the host with numpy, operation for operation as the
JAX package builds it, so both packages hand their renderers the same
bits: spheres on a jittered disc field, 8 emissive beacons in chunk 0,
Morton-sorted, padded to a chunk multiple with impossible spheres (center
10000, radius 0), chunks ordered front to back from the camera, and one
slab AABB per chunk.

The traversal is a loop over chunks: a ray slab-tests each chunk's AABB
against (t_min, its running best t) and runs the chunk's sphere tests only
when the box can still hold a closer hit, so a culled chunk can never hide
the nearest hit.  NEE's shadow rays do the same against (t_min, t_l) for
each light, excluding the light itself.  `ChunkTraversal` is the plain
PyTorch form of that loop -- the plain version of the traversal kernels
K5 and K6 and of the scaled render kernel (ops/cuda_scaled.py,
csrc/chunks.cuh) -- and the traversal hook it hands ops/tracecore.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .config import RenderConfig
from .ops import tracecore as tc
from .ops.cuda_render import pack_scene
from .scene import (CameraSpec, MAT_DIELECTRIC, MAT_LAMBERT, MAT_METAL,
                    animation_time)

_TENSORS = ("center", "radius", "albedo", "emissive", "roughness", "ri",
            "mat_is_lam", "mat_is_met", "mat_is_die", "chunk_aabb")

# Lanes and (chunk, lane) pairs per batch of the plain traversal, on the
# CPU and on a card: bounds its temporaries to a few hundred MB (a few GB
# on a card) at any ray count.
_BATCHES = {"cpu": (1 << 15, 1 << 14), "cuda": (1 << 18, 1 << 17)}

# Chunks under one group box of the scaled render kernel (csrc/coop.cuh
# kGroup).
GROUP = 16


def _morton3(ix, iy, iz):
    """Interleave 10-bit cell coords into a 30-bit Morton key (numpy)."""
    def spread(v):
        v = v.astype(np.uint64) & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v
    return spread(ix) | (spread(iy) << 1) | (spread(iz) << 2)


@dataclasses.dataclass(frozen=True)
class ScaledScene:
    """Chunked scene for large sphere counts.

    Tensor fields are (N,) / (N, 3) with N a multiple of `chunk`; the
    material is three (N,) bool masks; chunk AABBs are (C, 6):
    (min_xyz, max_xyz).  `chunk`, `n_real`, `emissive_ids` and `camera`
    are static."""

    center: torch.Tensor      # (N, 3)
    radius: torch.Tensor      # (N,)
    albedo: torch.Tensor      # (N, 3)
    emissive: torch.Tensor    # (N, 3)
    roughness: torch.Tensor   # (N,)
    ri: torch.Tensor          # (N,)
    mat_is_lam: torch.Tensor  # (N,) bool
    mat_is_met: torch.Tensor  # (N,) bool
    mat_is_die: torch.Tensor  # (N,) bool
    chunk_aabb: torch.Tensor  # (C, 6)

    chunk: int
    n_real: int
    emissive_ids: Tuple[int, ...]
    camera: CameraSpec

    @property
    def n_chunks(self) -> int:
        return self.chunk_aabb.shape[0]

    @property
    def n_spheres(self) -> int:
        return self.center.shape[0]

    @property
    def device(self) -> torch.device:
        return self.center.device

    def replace(self, **kw) -> "ScaledScene":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "ScaledScene":
        return self.replace(**{k: getattr(self, k).to(device)
                               for k in _TENSORS})

    def mat_ids(self) -> torch.Tensor:
        """(N,) int32 material types (0 Lambert, 1 metal, 2 dielectric)."""
        return torch.where(self.mat_is_met, MAT_METAL, torch.where(
            self.mat_is_die, MAT_DIELECTRIC, MAT_LAMBERT)).to(torch.int32)

    def animate(self, time) -> "ScaledScene":
        """Beacon orbit (scaled.py:103): each emissive beacon circles its
        rest position in the XZ plane at twice its radius with a
        phase-offset vertical bob; the field stays static and the chunk
        AABBs are refreshed, so culling stays exact.  A pure function of
        the base scene, computed in float32; a tensor `time` carries its
        gradient into the centers."""
        nl = len(self.emissive_ids)
        dev = self.center.device
        li = torch.arange(nl, dtype=torch.float32, device=dev)
        t = animation_time(time, dev)
        phase = t + li * float(np.float32(2.0 * np.pi / max(nl, 1)))
        amp = self.radius[:nl] * 2.0
        off = torch.stack([torch.cos(phase) * amp,
                           torch.sin(t * float(np.float32(0.7)) + li)
                           * (amp * 0.5),
                           torch.sin(phase) * amp], dim=1)
        center = self.center.clone()
        center[:nl] = center[:nl] + off
        return refresh_chunk_aabb(self.replace(center=center))


def make_scaled_scene(n: int = 100_000, seed: int = 1234, chunk: int = 256,
                      extent: float = 200.0, device="cpu") -> ScaledScene:
    """Instance `n` spheres on a jittered disc field around the camera,
    Morton-sort, chunk, and compute chunk AABBs (scaled.py:126): ~70%
    Lambert, ~25% metal, ~5% dielectric, 8 emissive beacons first."""
    rng = np.random.default_rng(seed)

    side = int(np.ceil(np.sqrt(n)))
    gx, gz = np.meshgrid(np.arange(side), np.arange(side))
    gx = gx.ravel()[:n].astype(np.float64)
    gz = gz.ravel()[:n].astype(np.float64)
    spacing = 2.0 * extent / side
    x = (gx + rng.uniform(0.2, 0.8, n)) * spacing - extent
    z = (gz + rng.uniform(0.2, 0.8, n)) * spacing - extent
    r = rng.uniform(0.2, 0.5, n)
    y = r
    center = np.stack([x, y, z], axis=1).astype(np.float32)
    radius = r.astype(np.float32)

    albedo = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    emissive = np.zeros((n, 3), np.float32)
    roughness = rng.uniform(0.0, 0.4, n).astype(np.float32)
    ri = np.zeros(n, np.float32)
    u = rng.uniform(0.0, 1.0, n)
    mtype = np.where(u < 0.70, MAT_LAMBERT,
                     np.where(u < 0.95, MAT_METAL, MAT_DIELECTRIC))
    ri[mtype == MAT_DIELECTRIC] = 1.5

    n_lights = 8
    li = np.arange(n_lights)
    center[li, 0] = np.linspace(-extent * 0.6, extent * 0.6, n_lights)
    center[li, 1] = 15.0
    center[li, 2] = np.linspace(-extent * 0.6, extent * 0.6, n_lights)
    radius[li] = 3.0
    mtype[li] = MAT_LAMBERT
    emissive[li] = rng.uniform(10.0, 40.0, (n_lights, 3)).astype(np.float32)

    rest = np.arange(n_lights, n)
    cell = np.clip(((center[rest] + extent) / (2 * extent) * 1023), 0,
                   1023).astype(np.uint32)
    order = rest[np.argsort(_morton3(cell[:, 0], cell[:, 1], cell[:, 2]))]
    perm = np.concatenate([li, order])
    center, radius = center[perm], radius[perm]
    albedo, emissive = albedo[perm], emissive[perm]
    roughness, ri, mtype = roughness[perm], ri[perm], mtype[perm]

    n_pad = -n % chunk
    if n_pad:
        center = np.concatenate(
            [center, np.full((n_pad, 3), 10000.0, np.float32)])
        radius = np.concatenate([radius, np.zeros(n_pad, np.float32)])
        albedo = np.concatenate([albedo, np.zeros((n_pad, 3), np.float32)])
        emissive = np.concatenate(
            [emissive, np.zeros((n_pad, 3), np.float32)])
        roughness = np.concatenate([roughness, np.zeros(n_pad, np.float32)])
        ri = np.concatenate([ri, np.zeros(n_pad, np.float32)])
        mtype = np.concatenate([mtype, np.zeros(n_pad, np.int64)])

    c = center.shape[0] // chunk
    cam_spec = CameraSpec(look_from=(0.0, 8.0, 30.0),
                          look_at=(0.0, 0.0, 0.0),
                          aperture=0.02, focus_dist=30.0)

    # chunks front to back from the camera; chunk 0 (the beacons) pinned
    ccenter = center.reshape(c, chunk, 3).mean(axis=1)
    cam_pos = np.asarray(cam_spec.look_from, np.float64)
    dist = np.linalg.norm(ccenter - cam_pos, axis=1)
    chunk_order = np.concatenate([[0], 1 + np.argsort(dist[1:],
                                                      kind="stable")])

    def reorder(arr):
        blocks = arr.reshape(c, chunk, *arr.shape[1:])
        return blocks[chunk_order].reshape(arr.shape)

    center, radius = reorder(center), reorder(radius)
    albedo, emissive = reorder(albedo), reorder(emissive)
    roughness, ri, mtype = reorder(roughness), reorder(ri), reorder(mtype)

    cmin = (center - radius[:, None]).reshape(c, chunk, 3).min(axis=1)
    cmax = (center + radius[:, None]).reshape(c, chunk, 3).max(axis=1)
    aabb = np.concatenate([cmin, cmax], axis=1).astype(np.float32)

    return scaled_scene_from_arrays(
        center, radius, albedo, emissive, roughness, ri,
        mtype == MAT_LAMBERT, mtype == MAT_METAL, mtype == MAT_DIELECTRIC,
        aabb, chunk=chunk, n_real=n, emissive_ids=tuple(range(n_lights)),
        camera=cam_spec, device=device)


def refresh_chunk_aabb(scene: ScaledScene) -> ScaledScene:
    """Recompute the chunk AABBs from the current centers and radii
    (scaled.py:238); culling is exact only while every sphere lies inside
    its chunk's box.  The boxes carry no gradient."""
    C, K = scene.n_chunks, scene.chunk
    c = scene.center.detach().reshape(C, K, 3)
    r = scene.radius.detach().reshape(C, K, 1)
    aabb = torch.cat([(c - r).amin(dim=1), (c + r).amax(dim=1)], dim=1)
    return scene.replace(chunk_aabb=aabb.to(torch.float32))


def scaled_scene_from_arrays(center, radius, albedo, emissive, roughness, ri,
                             mat_is_lam, mat_is_met, mat_is_die, chunk_aabb,
                             chunk: int, n_real: int, emissive_ids,
                             camera: CameraSpec, device="cpu") -> ScaledScene:
    """Build a ScaledScene from array-likes (numpy, e.g. the JAX
    ScaledScene's fields through np.asarray) plus its static metadata, as
    scene.scene_from_arrays does for Scene."""
    def f32(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=device)

    def flag(a):
        return torch.as_tensor(np.array(a, dtype=bool), device=device)

    scene = ScaledScene(
        center=f32(center), radius=f32(radius), albedo=f32(albedo),
        emissive=f32(emissive), roughness=f32(roughness), ri=f32(ri),
        mat_is_lam=flag(mat_is_lam), mat_is_met=flag(mat_is_met),
        mat_is_die=flag(mat_is_die), chunk_aabb=f32(chunk_aabb),
        chunk=int(chunk), n_real=int(n_real),
        emissive_ids=tuple(int(e) for e in emissive_ids), camera=camera)
    if scene.n_spheres % scene.chunk or \
            scene.chunk_aabb.shape != (scene.n_spheres // scene.chunk, 6):
        raise ValueError(f"{scene.n_spheres} spheres do not make "
                         f"{tuple(scene.chunk_aabb.shape)} chunk boxes of "
                         f"{scene.chunk}")
    return scene


# ---------------------------------------------------------------------------
# The plain traversal (plain version of K5, K6)
# ---------------------------------------------------------------------------


def safe_inv(d):
    """1 / d with |d| < 1e-12 pushed to +-1e-12 (d >= 0, -0.0 included,
    goes to +1e-12), as scaled.py:599-601 and scaled_pallas.py:121-123."""
    safe = torch.where(torch.abs(d) < 1e-12,
                       torch.where(d >= 0, 1e-12, -1e-12).to(d.dtype), d)
    return 1.0 / safe


def sqrt_rn(x):
    """sqrt(max(x, 0)) correctly rounded, as the kernels' sqrtf (and
    XLA's) is: torch's float32 sqrt on the CPU can be 1 ulp off, which a
    root t carries straight into the comparison of hits.  A float32's
    square root taken in float64 and rounded once to float32 is exact."""
    return torch.sqrt(torch.clamp_min(x, 0.0).double()).to(x.dtype)


def _slabs(box, ro, inv, t_min: float):
    """Slab entry and exit of every chunk box for every lane, the chain
    of scaled.py:616-624 without its running upper end: t0 = max over
    axes of min(lo, hi) (from t_min), t1 = min over axes of max(lo, hi).
    The scan's `t0 <= min(t1_init, ...)` is then `t0 <= minimum(t1_init,
    t1)`: min is exact, and torch.maximum/minimum propagate NaN as
    jnp.maximum/minimum do.  Returns two (C, P) tensors."""
    t0 = t1 = None
    for a in range(3):
        lo = (box[:, a, None] - ro[a]) * inv[a]
        hi = (box[:, 3 + a, None] - ro[a]) * inv[a]
        mn, mx = torch.minimum(lo, hi), torch.maximum(lo, hi)
        # clamp_min(NaN, t_min) is NaN, as jnp.maximum(t_min, NaN)
        t0 = torch.clamp_min(mn, t_min) if t0 is None else \
            torch.maximum(t0, mn)
        t1 = mx if t1 is None else torch.minimum(t1, mx)
    return t0, t1


def _spans(n: int, dev, pairs: bool = False):
    """Slices of range(n) in the plain traversal's batches of lanes (or of
    (chunk, lane) pairs) on `dev`."""
    step = _BATCHES.get(dev.type, _BATCHES["cpu"])[int(pairs)]
    for s in range(0, n, step):
        yield slice(s, min(s + step, n))


class ChunkTraversal:
    """The plain chunk traversal over pack_chunks rows (C, 4K+8): the
    plain version of K5 (`nearest_hit`) and K6 (`occluded`), of the soft
    estimator's chunk scans (`silhouette`, `proximity`), and the traversal
    hook ops/tracecore.render_pixels takes for a ScaledScene.

    Each query is the jnp chunk scan's function on 1-D lanes, computed
    without a Python loop over chunks: the slab tests of all chunks at
    once, the sphere tests of every (chunk, lane) pair whose box the ray
    enters at all, then the scan's sequential rule replayed per lane in
    chunk order (a chunk is live when its entry lies within the running
    best; strict `<` across chunks).  Work counters are per lane: slab
    tests and sphere tests as the kernels (csrc/chunks.cuh) do them.

    Under autograd (`tab`, the packed scene table the render reads, given
    and grad enabled) the scans pick their sphere without a graph, and the
    value that carries the gradient is computed again from `tab` for that
    sphere alone, as the JAX scan's argmin and gather hand the gradient to
    the winner only (scaled.py:721-731): the hit's root t (straight
    through: its value is the scan's), the silhouette's and the shadow
    boundary's discriminants.  So the graph holds O(lanes) per bounce, not
    O(lanes x chunks).  The chunk boxes only gate and carry no gradient."""

    def __init__(self, rows: torch.Tensor, chunk: int, tab=None):
        K = chunk
        self.chunk = K
        self.n_chunks = rows.shape[0]
        self.cx, self.cy, self.cz, self.sqr = (rows[:, i * K:(i + 1) * K]
                                               for i in range(4))
        self.box = rows[:, 4 * K:4 * K + 6]
        self.base = rows[:, 4 * K + 6].to(torch.int64)
        self.tab = tab
        self._soft_boxes = {}

    def _grad(self) -> bool:
        return (self.tab is not None and self.tab.requires_grad
                and torch.is_grad_enabled())

    def _column(self, i):
        """The (cx, cy, cz, r^2) table rows at sphere ids i (autograd
        reaches `tab`)."""
        return tuple(self.tab[r][i] for r in (tc.ROW_CX, tc.ROW_CY,
                                              tc.ROW_CZ, tc.ROW_SQR))

    def soft_box(self, kind: str, eps: float):
        """The soft scans' inflated chunk boxes (soft_boxes), kept per
        (kind, eps)."""
        key = (kind, float(eps))
        if key not in self._soft_boxes:
            rmax = self.tab[tc.ROW_R].detach().reshape(
                self.n_chunks, self.chunk).amax(dim=1)
            self._soft_boxes[key] = soft_boxes(self.box, rmax, eps)[kind]
        return self._soft_boxes[key]

    def _pair_geometry(self, ci, pi, ro):
        cox = self.cx[ci] - ro[0][pi, None]
        coy = self.cy[ci] - ro[1][pi, None]
        coz = self.cz[ci] - ro[2][pi, None]
        cq = cox * cox + coy * coy + coz * coz - self.sqr[ci]
        return cox, coy, coz, cq

    def nearest_hit(self, ro, rd, t_min: float, t_max: float, active=None):
        """(t, id, slab tests, sphere tests) per lane: the nearest hit
        over all chunks (scaled.py:575-663), t_max and -1 on a miss and
        on inactive lanes."""
        return self.nearest_hit_roots(ro, rd, t_min, t_max, active)[:4]

    def nearest_hit_roots(self, ro, rd, t_min: float, t_max: float,
                          active=None):
        """nearest_hit's (t, id, slab tests, sphere tests) and per lane
        the root tests: the sphere tests in the chunks it entered whose
        discriminant is positive, where a kernel takes the square root and
        the two roots."""
        P = ro[0].shape[0]
        dev = ro[0].device
        with torch.no_grad():
            t = torch.full((P,), t_max, dtype=torch.float32, device=dev)
            hid = torch.full((P,), -1, dtype=torch.int64, device=dev)
            spheres = torch.zeros((P,), dtype=torch.int64, device=dev)
            roots = torch.zeros((P,), dtype=torch.int64, device=dev)
            lanes = torch.arange(P, device=dev) if active is None else \
                active.nonzero().squeeze(1)
            for s in _spans(lanes.shape[0], dev):
                idx = lanes[s]
                t[idx], hid[idx], spheres[idx], roots[idx] = self._hit_lanes(
                    tuple(x[idx] for x in ro), tuple(x[idx] for x in rd),
                    t_min, t_max)
            slabs = torch.full((P,), self.n_chunks, dtype=torch.int64,
                               device=dev)
            if active is not None:
                slabs = torch.where(active, slabs, 0)
        if self._grad():
            # the winner's root again, for its gradient: the scan's value
            tt, _ = tc.sphere_t(*self._column(hid.clamp_min(0)), ro, rd,
                                t_min)
            t = torch.where(hid >= 0, t + (tt - tt.detach()), t)
        return t, hid, slabs, spheres, roots

    def _hit_lanes(self, ro, rd, t_min, t_max):
        P = ro[0].shape[0]
        dev = ro[0].device
        K = self.chunk
        inv = tuple(safe_inv(d) for d in rd)
        t0, t1 = _slabs(self.box, ro, inv, t_min)
        cand = t0 <= torch.clamp_max(t1, t_max)   # best <= t_max always
        pi, ci = cand.t().nonzero(as_tuple=True)  # lane-major, chunks in order
        n = pi.shape[0]
        t_c = torch.empty((n,), dtype=torch.float32, device=dev)
        jc = torch.empty((n,), dtype=torch.int64, device=dev)
        nr = torch.empty((n,), dtype=torch.int64, device=dev)
        for s in _spans(n, dev, pairs=True):
            c_, p_ = ci[s], pi[s]
            cox, coy, coz, cq = self._pair_geometry(c_, p_, ro)
            nb = cox * rd[0][p_, None] + coy * rd[1][p_, None] \
                + coz * rd[2][p_, None]
            discr = nb * nb - cq
            dsq = sqrt_rn(discr)
            r0 = nb - dsq
            r1 = nb + dsq
            tt = torch.where(r0 > t_min, r0, r1)
            tt = torch.where((discr > 0.0) & (tt > t_min), tt, torch.inf)
            t_c[s], jc[s] = torch.min(tt, dim=1)
            nr[s] = (discr > 0.0).sum(dim=1)
        # replay the scan's sequential rule: rank r = the lane's r-th
        # candidate chunk in chunk order
        counts = cand.sum(dim=0)
        best = torch.full((P,), t_max, dtype=torch.float32, device=dev)
        bid = torch.full((P,), -1, dtype=torch.int64, device=dev)
        live_n = torch.zeros((P,), dtype=torch.int64, device=dev)
        roots = torch.zeros((P,), dtype=torch.int64, device=dev)
        if n == 0:
            return best, bid, live_n, roots
        R = int(counts.max())
        rank = torch.arange(n, device=dev) - (torch.cumsum(counts, 0)
                                              - counts)[pi]
        T0 = torch.full((R, P), torch.inf, device=dev)
        T1 = torch.full((R, P), -torch.inf, device=dev)
        TC = torch.full((R, P), torch.inf, device=dev)
        ID = torch.full((R, P), -1, dtype=torch.int64, device=dev)
        NR = torch.zeros((R, P), dtype=torch.int64, device=dev)
        T0[rank, pi] = t0[ci, pi]
        T1[rank, pi] = t1[ci, pi]
        TC[rank, pi] = t_c
        ID[rank, pi] = self.base[ci] + jc
        NR[rank, pi] = nr
        for r in range(R):
            live = T0[r] <= torch.minimum(best, T1[r])
            upd = live & (TC[r] < best)
            best = torch.where(upd, TC[r], best)
            bid = torch.where(upd, ID[r], bid)
            live_n += live
            roots += torch.where(live, NR[r], 0)
        return best, bid, live_n * K, roots

    def occluded(self, pos, l, light: int, t_min: float, t_l, active=None):
        """(occluded, slab tests, sphere tests) per lane: does any sphere
        but `light` overlap (t_min, t_l) along l from pos
        (scaled.py:299-394, one light)?  The chunks are ORed, so the
        scan's skip of already-occluded lanes changes no result; the
        counters follow a loop that stops at the first occluder."""
        P = pos[0].shape[0]
        dev = pos[0].device
        with torch.no_grad():
            occ = torch.zeros((P,), dtype=torch.bool, device=dev)
            slabs = torch.zeros((P,), dtype=torch.int64, device=dev)
            spheres = torch.zeros((P,), dtype=torch.int64, device=dev)
            lanes = torch.arange(P, device=dev) if active is None else \
                active.nonzero().squeeze(1)
            for s in _spans(lanes.shape[0], dev):
                idx = lanes[s]
                o, sl, sp = self._occ_lanes(
                    tuple(x[idx] for x in pos), tuple(x[idx] for x in l),
                    light, t_min, t_l[idx])
                occ[idx], slabs[idx], spheres[idx] = o, sl, sp
        return occ, slabs, spheres

    def occlusion_bits(self, ro, dirs, t_ls, light_ids, t_min: float):
        """K6's function on 1-D lanes: (int32 bitmask, bit k = light k
        occluded over (t_min, t_ls[k]) along dirs[k]; slab tests; sphere
        tests), the counters summed over the lights."""
        bits = torch.zeros(ro[0].shape, dtype=torch.int32,
                           device=ro[0].device)
        slabs = spheres = 0
        for k, (e, l, t_l) in enumerate(zip(light_ids, dirs, t_ls)):
            occ, sl, sp = self.occluded(ro, l, int(e), t_min, t_l)
            bits |= occ.to(torch.int32) << k
            slabs, spheres = slabs + sl, spheres + sp
        return bits, slabs, spheres

    def _occ_lanes(self, pos, l, light, t_min, t_l):
        P = pos[0].shape[0]
        dev = pos[0].device
        C, K = self.n_chunks, self.chunk
        inv = tuple(safe_inv(d) for d in l)
        t0, t1 = _slabs(self.box, pos, inv, t_min)
        live = t0 <= torch.minimum(t_l, t1)
        ci, pi = live.nonzero(as_tuple=True)
        n = ci.shape[0]
        first = torch.full((n,), K, dtype=torch.int64, device=dev)
        j = torch.arange(K, device=dev)
        for s in _spans(n, dev, pairs=True):
            c_, p_ = ci[s], pi[s]
            cox, coy, coz, cq = self._pair_geometry(c_, p_, pos)
            nb = cox * l[0][p_, None] + coy * l[1][p_, None] \
                + coz * l[2][p_, None]
            blk = tc.occ_test(nb, cq, t_min, t_l[p_, None]) \
                & ((self.base[c_, None] + j) != light)
            hit = blk.any(dim=1)
            first[s] = torch.where(
                hit, torch.argmax(blk.to(torch.int32), dim=1), K)
        blocks = first < K
        occ = torch.zeros((P,), dtype=torch.bool, device=dev)
        occ[pi[blocks]] = True
        # the first occluding chunk of each lane, then the kernel's work:
        # every box up to it, every live chunk before it in full, and its
        # spheres up to the occluder
        c_first = torch.full((P,), C, dtype=torch.int64, device=dev)
        c_first.scatter_reduce_(0, pi[blocks], ci[blocks], "amin")
        before = ci < c_first[pi]
        at = ci == c_first[pi]
        spheres = torch.zeros((P,), dtype=torch.int64, device=dev)
        spheres.index_add_(0, pi, torch.where(before, K, 0)
                           + torch.where(at, first + 1, 0))
        return occ, torch.clamp_max(c_first + 1, C), spheres

    def silhouette(self, ro, rd, t_min: float, hit_id, soft_eps: float,
                   active=None):
        """The silhouette query of the soft estimator (tracecore.Silhouette,
        scaled.py:396 silhouette_chunks) and the sphere tests of each
        lane's candidate scan.  A hit lane's d is its winner's; a lane that
        missed (hit_id < 0) scans the chunks whose box, inflated by
        delta_c = sqrt(rmax_c^2 + 8 eps), its ray enters within (t_min,
        1e7), for the largest d among the spheres in front of it (nb >
        t_min) and not padding (r^2 > 0), the first on ties, from -1e9;
        its candidate is on where that d exceeds -1e8.  Hit lanes scan
        nothing (their candidate is never read), nor misses outside
        `active`.  Needs `tab`."""
        P = ro[0].shape[0]
        dev = ro[0].device
        box = self.soft_box("silhouette", soft_eps)
        with torch.no_grad():
            cand = torch.full((P,), -1, dtype=torch.int64, device=dev)
            tests = torch.zeros((P,), dtype=torch.int64, device=dev)
            miss = hit_id < 0
            lanes = (miss if active is None else miss & active).nonzero() \
                .squeeze(1)
            for s in _spans(lanes.shape[0], dev):
                idx = lanes[s]
                cand[idx], tests[idx] = self._scan_lanes(
                    box, tuple(x[idx] for x in ro), tuple(x[idx] for x in rd),
                    t_min, None, None)
        hit = hit_id >= 0
        key = torch.where(hit, hit_id, cand)
        nb, d = tc.sphere_discr(*self._column(key.clamp_min(0)), ro, rd)
        d = torch.where(key >= 0, d, -1e9)
        cand_on = ~hit & (cand >= 0) & (d > -1e8)
        return tc.Silhouette(d=d, cand=torch.where(cand_on, cand, -1),
                             cand_on=cand_on, nb=nb), tests

    def proximity(self, pos, l, light: int, t_min: float, t_l,
                  soft_eps: float, active=None):
        """The soft shadow boundary's signed occlusion proximity of one
        light (scaled.py:502 lights_occlusion_proximity): over the chunks
        whose box, inflated by sqrt(rmax_c^2 + 8 max(eps, 1)), the shadow
        ray enters within (t_min, t_l), the largest d of the spheres but
        `light` whose closest approach lies in (t_min, t_l), -1e9 where
        there is none; and the sphere tests of the scan.  The chunks are
        gated lane by lane; the JAX scan gates them for a batch of lanes at
        once, so where a lane's largest d lies below the band the
        estimator sees (-8 max(eps, 1)) its value there may be larger,
        which no gradient can tell.  Lanes outside `active` scan nothing.
        Needs `tab`."""
        P = pos[0].shape[0]
        dev = pos[0].device
        box = self.soft_box("proximity", soft_eps)
        with torch.no_grad():
            occ = torch.full((P,), -1, dtype=torch.int64, device=dev)
            tests = torch.zeros((P,), dtype=torch.int64, device=dev)
            lanes = torch.arange(P, device=dev) if active is None else \
                active.nonzero().squeeze(1)
            for s in _spans(lanes.shape[0], dev):
                idx = lanes[s]
                occ[idx], tests[idx] = self._scan_lanes(
                    box, tuple(x[idx] for x in pos), tuple(x[idx] for x in l),
                    t_min, t_l[idx], light)
        _, d = tc.sphere_discr(*self._column(occ.clamp_min(0)), pos, l)
        return torch.where(occ >= 0, d, -1e9), tests

    def _scan_lanes(self, box, ro, rd, t_min, t_l, light):
        """The soft scans on a batch of lanes: with t_l None the
        silhouette candidate's (segment (t_min, 1e7), spheres in front and
        not padding), else the occluder of `light`'s shadow segment (t_min,
        t_l).  The chunks whose `box` the ray enters, in order; the first
        sphere of the largest d above -1e9 (the scans' strict `>` chains).
        Returns (sphere id or -1, sphere tests) per lane."""
        P = ro[0].shape[0]
        dev = ro[0].device
        K = self.chunk
        inv = tuple(safe_inv(d) for d in rd)
        t0, t1 = _slabs(box, ro, inv, t_min)
        live = t0 <= (torch.clamp_max(t1, 1e7) if t_l is None
                      else torch.minimum(t_l, t1))
        pi, ci = live.t().nonzero(as_tuple=True)  # lane-major, chunks in order
        n = pi.shape[0]
        best = torch.empty((n,), dtype=torch.float32, device=dev)
        jb = torch.empty((n,), dtype=torch.int64, device=dev)
        j = torch.arange(K, device=dev)
        for s in _spans(n, dev, pairs=True):
            c_, p_ = ci[s], pi[s]
            cox, coy, coz, cq = self._pair_geometry(c_, p_, ro)
            nb = cox * rd[0][p_, None] + coy * rd[1][p_, None] \
                + coz * rd[2][p_, None]
            d = nb * nb - cq
            if t_l is None:
                keep = (nb > t_min) & (self.sqr[c_] > 0.0)
            else:
                keep = (nb > t_min) & (nb < t_l[p_, None]) \
                    & ((self.base[c_, None] + j) != light)
            best[s], jb[s] = torch.where(keep, d, -1e9).max(dim=1)
        # per lane: the largest chunk best above -1e9, the first chunk of it
        top = torch.full((P,), -1e9, dtype=torch.float32, device=dev)
        top.scatter_reduce_(0, pi, best, "amax")
        win = (best > -1e9) & (best == top[pi])
        c_win = torch.full((P,), self.n_chunks, dtype=torch.int64,
                           device=dev)
        c_win.scatter_reduce_(0, pi[win], ci[win], "amin")
        first = win & (ci == c_win[pi])
        found = torch.full((P,), -1, dtype=torch.int64, device=dev)
        found[pi[first]] = self.base[ci[first]] + jb[first]
        return found, live.sum(dim=0) * K


def soft_boxes(box: torch.Tensor, rmax: torch.Tensor, eps: float) -> dict:
    """The chunk boxes (C, 6) of the soft estimator's two scans, each
    widened on every side by a margin from its chunk's largest radius
    (scaled.py:396, :502): {"silhouette": delta = sqrt(rmax^2 + 8 eps),
    "proximity": sqrt(rmax^2 + 8 max(eps, 1))}, in float32 as the JAX
    package rounds them (min - delta, max + delta), the square root
    correctly rounded.  A ray that misses a widened box passes every
    sphere in it at a discriminant below -8 eps, where the estimator's
    sigmoid and its gradient are below 3.4e-4 of their peak.  The kernels
    take the same boxes (ops/cuda_scaled)."""
    r2 = (rmax * rmax).to(torch.float32)
    out = {}
    for kind, margin in (("silhouette", 8.0 * float(np.float32(eps))),
                         ("proximity", 8.0 * max(float(eps), 1.0))):
        delta = sqrt_rn(r2 + float(np.float32(margin)))[:, None]
        out[kind] = torch.cat([box[:, :3] - delta, box[:, 3:] + delta],
                              dim=1).contiguous()
    return out


def pack_chunks(scene: ScaledScene) -> torch.Tensor:
    """(C, 4K+8) float32 rows on the scene's device, the row layout of
    scaled_pallas.pack_chunks: [cx(K) cy(K) cz(K) r^2(K), aabb(6), base
    index as a float, 0]."""
    C, K = scene.n_chunks, scene.chunk
    dev = scene.device
    c = scene.center
    return torch.cat([
        c[:, 0].reshape(C, K), c[:, 1].reshape(C, K), c[:, 2].reshape(C, K),
        (scene.radius * scene.radius).reshape(C, K),
        scene.chunk_aabb,
        (torch.arange(C, dtype=torch.float32, device=dev) * K)[:, None],
        torch.zeros((C, 1), dtype=torch.float32, device=dev),
    ], dim=1).to(torch.float32).detach().contiguous()


def group_boxes(rows: torch.Tensor, chunk: int,
                group: int = GROUP) -> torch.Tensor:
    """(ceil(C / group), 6) boxes over runs of `group` consecutive chunks
    of pack_chunks rows (C, 4 * chunk + 8): each the min of its children's
    box minima and the max of their maxima (exact: min and max round
    nothing).  The cooperative kernels (the scaled render, K6) test a
    group box before the group's chunk boxes and skip all of them where no
    ray enters it."""
    return boxes_grouped(rows[:, 4 * chunk:4 * chunk + 6], group)


def boxes_grouped(box: torch.Tensor, group: int = GROUP) -> torch.Tensor:
    """group_boxes over (C, 6) boxes (min xyz, max xyz) in their order."""
    C = box.shape[0]
    G = -(-C // group)
    pad = G * group - C
    lo = torch.cat([box[:, :3], box.new_full((pad, 3), torch.inf)])
    hi = torch.cat([box[:, 3:], box.new_full((pad, 3), -torch.inf)])
    return torch.cat([lo.reshape(G, group, 3).amin(dim=1),
                      hi.reshape(G, group, 3).amax(dim=1)], dim=1).contiguous()


class ChunkIndex(NamedTuple):
    """What the cooperative K5 and K6 read beside the chunk rows, built
    once per scene (chunk_index): `order`, the chunks in a spatial order
    (int32), the order K6's walk takes them in; `gbox`, the group boxes
    over runs of GROUP chunks of that order, K6's group skip and K5's
    prefilter (K5 walks the chunks of the groups its rays enter in the
    rows' order); `rec`, the spheres' (cx, cy, cz, r^2) records in the
    rows' order, so that a sphere is one 16-byte load instead of four."""
    order: torch.Tensor
    gbox: torch.Tensor
    rec: torch.Tensor


def sphere_records(rows: torch.Tensor, chunk: int) -> torch.Tensor:
    """The spheres' (cx, cy, cz, r^2) records (C * chunk, 4) of pack_chunks
    rows, in the rows' order."""
    C = rows.shape[0]
    rec = rows[:, :4 * chunk].reshape(C, 4, chunk).transpose(1, 2)
    return rec.reshape(C * chunk, 4).contiguous()


def walk_order(box: torch.Tensor) -> torch.Tensor:
    """chunk_index's spatial order of (C, 6) chunk boxes, computed where
    they lie without a host round trip (the scaled gradient's soft scans
    take it a step): the Morton order of the box centres over 1024 cells
    an axis, the boxes wider than 4 times the median's widest extent last
    (the median here the lower middle value where C is even).  An order
    sets how soon a walk's group boxes skip, never what it finds.  int32
    (C,)."""
    b = box.double()
    mid = (b[:, :3] + b[:, 3:]) * 0.5
    lo = mid.amin(dim=0)
    span = mid.amax(dim=0) - lo
    cell = ((mid - lo) / torch.where(span > 0, span, torch.ones_like(span))
            * 1023).clamp(0, 1023).to(torch.int64)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249
    key = spread(cell[:, 0]) | (spread(cell[:, 1]) << 1) | (
        spread(cell[:, 2]) << 2)
    morton = torch.argsort(key, stable=True)
    extent = (b[:, 3:] - b[:, :3]).amax(dim=1)[morton]
    big = extent > 4 * extent.median()
    return torch.cat([morton[~big], morton[big]]).to(torch.int32)


def chunk_index(rows: torch.Tensor, chunk: int) -> ChunkIndex:
    """The ChunkIndex of pack_chunks rows (C, 4 * chunk + 8).  The order
    takes the chunks in Morton order of their box centers, so that a group
    of GROUP consecutive ones is compact and its box tight, and the chunks
    whose box is more than 4 times the median's widest extent (the
    beacons' chunk, a padded one) last, so that they widen no group of
    compact ones: K6's OR over chunks may take them in any order, and the
    rows' own order (front to back from the camera) makes groups whose
    boxes nearly every ray enters (a camera ray of the 100k scene enters
    5 of its 25 groups in this order, 18 in the rows')."""
    C = rows.shape[0]
    box = rows[:, 4 * chunk:4 * chunk + 6].double().cpu().numpy()
    mid = (box[:, :3] + box[:, 3:]) * 0.5
    lo, span = mid.min(axis=0), np.ptp(mid, axis=0)
    cell = np.clip((mid - lo) / np.where(span > 0, span, 1.0) * 1023, 0,
                   1023).astype(np.uint32)
    morton = np.argsort(_morton3(cell[:, 0], cell[:, 1], cell[:, 2]),
                        kind="stable")
    extent = (box[:, 3:] - box[:, :3]).max(axis=1)[morton]
    big = extent > 4 * np.median(extent)
    order = torch.from_numpy(np.concatenate([morton[~big], morton[big]])
                             .astype(np.int32)).to(rows.device)
    return ChunkIndex(order, group_boxes(rows[order.long()], chunk),
                      sphere_records(rows, chunk))


class ChunkedScenePort:
    """The scaled scene's traversal queries with the JAX package's
    ChunkedScenePort interface (scaled.py:256): `hit_chunks` and
    `lights_visible` on lane planes of any shape, through the kernels K5
    and K6 for a scene on a card and their plain versions for a scene on
    the CPU (ops/cuda_scaled)."""

    def __init__(self, scene: ScaledScene):
        self.scene = scene
        self.rows = pack_chunks(scene)
        self.chunk_index = chunk_index(self.rows, scene.chunk)

    def hit_chunks(self, ro, rd, t_min: float, t_max: float):
        """Nearest (t float32, id int32) over all chunks, id -1 on a
        miss, in the lanes' shape."""
        from .ops import cuda_scaled
        return cuda_scaled.hit_chunks(self.rows, ro, rd, self.scene.chunk,
                                      t_min, t_max, index=self.chunk_index)

    def lights_visible(self, ro, dirs, light_ids, t_min: float,
                       t_max: float):
        """Per light: its own root t_l < t_max and no other sphere over
        (t_min, t_l) (scaled.py:299): a list of bool lane planes.  Any
        number of lights: K6 (or its plain version on the CPU) answers for
        them in groups of cuda_scaled.mask_lights, each a launch."""
        from .ops import cuda_scaled
        s = self.scene
        light_ids, dirs = list(light_ids), list(dirs)
        t_ls, hits = [], []
        for e, l in zip(light_ids, dirs):
            t_l, valid = tc.sphere_t(s.center[e, 0], s.center[e, 1],
                                     s.center[e, 2],
                                     s.radius[e] * s.radius[e], ro, l, t_min)
            t_ls.append(t_l)
            hits.append(valid & (t_l < t_max))
        group = cuda_scaled.mask_lights(s.device)
        seen = []
        for k0 in range(0, len(light_ids), group):
            k1 = k0 + group
            occ = cuda_scaled.shadow_chunks(
                self.rows, ro, tuple(c for l in dirs[k0:k1] for c in l),
                tuple(t_ls[k0:k1]), s.chunk, tuple(light_ids[k0:k1]), t_min,
                index=self.chunk_index)
            seen += [h & (((occ >> k) & 1) == 0)
                     for k, h in enumerate(hits[k0:k1])]
        return seen

    def silhouette_chunks(self, ro, rd, t_min: float, hit_id, eps: float):
        """The soft estimator's silhouette query over chunks (scaled.py:396)
        on lane planes of any shape: tracecore.Silhouette (d, candidate id
        or -1, cand_on, the candidate's nb) in the lanes' shape, through
        the plain chunk scan (ChunkTraversal.silhouette) on any device.
        Autograd reaches the scene's center and radius."""
        shape = ro[0].shape
        q, _ = self._traversal().silhouette(
            _flat(ro), _flat(rd), t_min, hit_id.reshape(-1).to(torch.int64),
            eps)
        return tc.Silhouette(*(x.reshape(shape) for x in q))

    def lights_occlusion_proximity(self, ro, dirs, light_ids, t_min: float,
                                   t_ls, eps: float = 1.0):
        """The soft shadow boundary's occlusion proximity over chunks
        (scaled.py:502), one lane plane per light: the largest discriminant
        of the spheres but the light whose closest approach lies in (t_min,
        t_l), -1e9 where there is none (ChunkTraversal.proximity).  `eps`
        is the soft_silhouette_eps the sigmoid uses: the chunk boxes'
        margin scales with max(eps, 1)."""
        shape = ro[0].shape
        trav = self._traversal()
        return [trav.proximity(_flat(ro), _flat(l), int(e), t_min,
                               t_l.reshape(-1), eps)[0].reshape(shape)
                for e, l, t_l in zip(light_ids, dirs, t_ls)]

    def _traversal(self) -> ChunkTraversal:
        return ChunkTraversal(self.rows, self.scene.chunk,
                              tab=pack_scene(self.scene))


def _flat(planes):
    return tuple(x.reshape(-1) for x in planes)


# ---------------------------------------------------------------------------
# The plain scaled render
# ---------------------------------------------------------------------------


def render_tile_scaled_plain(scene: ScaledScene, cfg: RenderConfig,
                             frame: int, x0: int, y0: int, height: int,
                             width: int, with_work: bool = False, tab=None,
                             rows=None):
    """Render the (height, width) sub-image at global pixel (x0, y0) of a
    ScaledScene on its device: tracecore.render_pixels with the chunk
    traversal -- the plain version of the scaled render kernel, and under
    autograd (`tab`, default pack_scene(scene), requiring grad) the plain
    version of the chunked gradient kernel, with the soft-silhouette
    estimator's chunk scans where cfg.soft_silhouette_eps > 0.  `rows`:
    the scene's pack_chunks rows, packed here when None.  Returns
    ((height, width, 3) float32, 0-d int64 ray count), plus the per-lane
    tracecore.Work when with_work."""
    from .render.wavefront import camera_scalars, gradient_soft_eps
    dev = scene.device
    if tab is None:
        tab = pack_scene(scene)
    yy, xx = torch.meshgrid(
        torch.arange(y0, y0 + height, device=dev, dtype=torch.int64),
        torch.arange(x0, x0 + width, device=dev, dtype=torch.int64),
        indexing="ij")
    col, work = tc.render_pixels(
        tab, scene.mat_ids().to(torch.int64),
        scene.emissive_ids, cfg, camera_scalars(scene, cfg),
        xx.reshape(-1), yy.reshape(-1), frame,
        traversal=ChunkTraversal(pack_chunks(scene) if rows is None
                                 else rows, scene.chunk, tab=tab),
        soft_eps=gradient_soft_eps(cfg, tab))
    img = torch.stack(col, dim=-1).reshape(height, width, 3)
    rays = work.traced.sum() + work.shadow.sum()
    return (img, rays, work) if with_work else (img, rays)


def render_tile_scaled_grad_plain(scene: ScaledScene, cfg: RenderConfig,
                                  frame: int, g_img, x0: int, y0: int,
                                  height: int, width: int, tab=None):
    """Value and packed-scene cotangent of a sub-image of a ScaledScene for
    the pixel cotangent g_img ((height, width, 3)): autograd through
    render_tile_scaled_plain, the chunked gradient kernel's plain version
    (with cfg.soft_silhouette_eps > 0 the soft estimator's cotangent).
    Returns (image, 0-d int64 ray count, d_packed (SCENE_ROWS, N))."""
    if tab is None:
        tab = pack_scene(scene)
    tab = tab.detach().requires_grad_(True)
    with torch.enable_grad():
        img, rays = render_tile_scaled_plain(scene, cfg, frame, x0, y0,
                                             height, width, tab=tab)
        d_tab, = torch.autograd.grad(img, tab, g_img.to(img))
    return img.detach(), rays, d_tab


def render_frame_scaled_plain(scene: ScaledScene, cfg: RenderConfig,
                              frame: int):
    """One full frame of a ScaledScene on its device through the plain
    version.  Returns ((H, W, 3) float32, 0-d int64 ray count)."""
    return render_tile_scaled_plain(scene, cfg, frame, 0, 0, cfg.height,
                                    cfg.width)
