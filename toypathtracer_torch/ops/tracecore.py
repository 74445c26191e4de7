"""Plain PyTorch trace core (the lockstep subset of toypathtracer_tpu/ops/
tracecore.py, with its hard-select and soft-silhouette gradients).

The reference's GPU-port path-tracing math -- XorShift32 RNG, closed-form
samplers, thin-lens camera, ray/sphere nearest hit, Lambert/metal/
dielectric scatter, next-event estimation (NEE) with double-count
suppression -- in eager PyTorch over 1-D batches of pixel lanes.  It is
the plain version of the CUDA kernels (csrc/trace.cuh): the same function,
with the same float32 expression order, evaluated lane-parallel in the
lockstep form (for each sample, for each depth, one masked bounce).

Autograd through it gives the gradient the JAX package's
trace(differentiable=True) gives and the gradient kernel computes:
torch.where and torch.min route a cotangent only into the selected value,
and no masked-out lane produces inf or NaN in the backward (sqrt_pos).
With soft_eps > 0 (RenderConfig.soft_silhouette_eps) bounce and
nee_light_e add the soft-silhouette estimator's terms
(tracecore.bounce_parts(soft=True)): straight-through sigmoids of the
silhouette and shadow-boundary discriminants, which leave every forward
value bit for bit as it was and carry sigma' terms into sphere centers and
radii in the backward.

The parity route (CPU_SAMPLERS, trace_cpu_exact; render/parity.py) replays
the reference's scalar C++ core instead: rejection-loop samplers with a
variable draw count, the root-based shadow test, the extra depth==kMaxDepth
level, radiance folded backward as the recursion does, and the C library's
sinf/cosf (ops/libm.py).

Conventions:
  * a vec3 is a tuple of three equal-shape float32 tensors, so every dot
    product and sum keeps the JAX package's (and the kernel's) left-to-
    right association;
  * RNG states are int64 tensors holding uint32 values (torch on the CPU
    has no `<<` for uint32), masked back to 32 bits after every shift;
  * the scene is the packed (14, N) table of ops/cuda_render.pack_scene,
    the kernel's own input, with the sphere axis broadcast as (P, N);
  * every material branch draws from its own copy of the RNG state and
    the lane's material selects the consuming copy, so each pixel consumes
    exactly the draws a per-pixel loop would.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import KPI, RenderConfig, warn_diff_wavefront
from . import libm

# Rows of the packed (SCENE_ROWS, N) scene table (the layout of
# toypathtracer_tpu/ops/pallas_render.py:53-58 and csrc/trace.cuh).
ROW_CX, ROW_CY, ROW_CZ, ROW_SQR, ROW_INVR, ROW_R = range(6)
ROW_ALB = 6     # 6, 7, 8
ROW_EM = 9      # 9, 10, 11
ROW_ROUGH = 12
ROW_RI = 13
SCENE_ROWS = 14

MASK32 = 0xFFFFFFFF

# Constants the JAX package builds as jnp.float32(<double expression>):
# evaluated in double, rounded once.
TWO_PI = float(np.float32(2.0 * KPI))
PI_F = float(np.float32(KPI))
THIRD = float(np.float32(1.0 / 3.0))
INV_2_24 = 1.0 / 16777216.0


# ---------------------------------------------------------------------------
# vec3 helpers (reference: Maths.h:250-313)
# ---------------------------------------------------------------------------


def add3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul3(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale3(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def neg3(a):
    return (-a[0], -a[1], -a[2])


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        -(a[0] * b[2] - a[2] * b[0]),
        a[0] * b[1] - a[1] * b[0],
    )


def normalize3(a):
    # 1/sqrt, not rsqrt: IEEE division and sqrt round like the reference.
    inv = 1.0 / torch.sqrt(dot3(a, a))
    return scale3(a, inv)


def sel3(mask, a, b):
    return (torch.where(mask, a[0], b[0]),
            torch.where(mask, a[1], b[1]),
            torch.where(mask, a[2], b[2]))


def reflect3(v, n):
    d = dot3(v, n)
    return sub3(v, scale3(n, 2.0 * d))


def sqrt_pos(x):
    """sqrt(max(x, 0)), real-valued everywhere, with a finite gradient
    everywhere (tracecore.safe_sqrt_pos): sqrt(clamp_min(x, 0)) would
    back-propagate 0 * inf = NaN at x <= 0 even where a later torch.where
    drops the value (the double-where trap), so the sqrt only ever sees
    x > 0 or 1."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def schlick(cosine, ri):
    """Fresnel approximation (reference: Maths.h:327-332, with the HLSL
    port's saturate, ComputeShader.hlsl:68-74)."""
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    x = torch.clamp(1.0 - cosine, 0.0, 1.0)
    x2 = x * x
    return r0 + (1.0 - r0) * (x2 * x2 * x)


# ---------------------------------------------------------------------------
# RNG: XorShift32 (reference: Maths.cpp:5-18, ComputeShader.hlsl:3-16)
# ---------------------------------------------------------------------------


def xorshift32(state):
    x = state
    x = x ^ ((x << 13) & MASK32)
    x = x ^ (x >> 17)
    x = x ^ ((x << 15) & MASK32)
    return x


def rand01(state):
    """(XorShift32(state) & 0xFFFFFF) / 16777216 (Maths.cpp:15-18).
    Returns (new_state, float32 value)."""
    state = xorshift32(state)
    return state, (state & 0xFFFFFF).to(torch.float32) * INV_2_24


def seed_pixels(x, y, frame: int):
    """Per-pixel seed (x*1973 + y*9277 + frame*26699) | 1, modulo 2^32
    (ComputeShader.hlsl:380)."""
    s = (x.to(torch.int64) * 1973 + y.to(torch.int64) * 9277
         + (int(frame) & MASK32) * 26699)
    return (s & MASK32) | 1


def random_in_unit_disk(state, active=None):
    """Polar disk sample, 2 draws (ComputeShader.hlsl:18-24).  `active` is
    accepted for the rejection loop's signature: every lane draws."""
    state, r1 = rand01(state)
    a = r1 * TWO_PI
    state, r2 = rand01(state)
    r = torch.sqrt(r2)
    return state, (torch.cos(a) * r, torch.sin(a) * r)


def random_in_unit_sphere(state, active=None):
    """Sphere-volume sample, 3 draws (ComputeShader.hlsl:25-35); the cube
    root is exp(log(x)/3), as in the JAX package.  `active` is accepted
    for the rejection loop's signature: every lane draws."""
    state, r1 = rand01(state)
    z = r1 * 2.0 - 1.0
    state, r2 = rand01(state)
    t = r2 * TWO_PI
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    x = r * torch.cos(t)
    y = r * torch.sin(t)
    state, r3 = rand01(state)
    cube = torch.exp(torch.log(r3) * THIRD)
    return state, (x * cube, y * cube, z * cube)


def random_unit_vector(state):
    """Uniform direction, 2 draws (ComputeShader.hlsl:36-44)."""
    state, r1 = rand01(state)
    z = r1 * 2.0 - 1.0
    state, r2 = rand01(state)
    a = r2 * TWO_PI
    r = torch.sqrt(1.0 - z * z)
    return state, (r * torch.cos(a), r * torch.sin(a), z)


# ---------------------------------------------------------------------------
# The parity route's samplers: the reference's CPU core (Maths.cpp:20-47).
# A rejection loop runs while any lane has not accepted; a lane that has
# accepted draws no more, so each lane's draw count, and with it the rest of
# its RNG stream, is the scalar loop's.
# ---------------------------------------------------------------------------


def _reject(state, draw, active=None):
    """Rejection loop over lanes: draw(state) -> (state, n components)
    until the squared length is < 1.  Lanes outside `active` (whose
    sample is not used) stop after their first draw."""
    st, *p = draw(state)

    def outside(p):
        sq = p[0] * p[0]
        for x in p[1:]:
            sq = sq + x * x
        return sq >= 1.0
    todo = outside(p)
    if active is not None:
        todo = todo & active
    while bool(todo.any()):
        st2, *p2 = draw(st)
        st = torch.where(todo, st2, st)
        p = [torch.where(todo, b, a) for a, b in zip(p, p2)]
        todo = todo & outside(p)
    return st, tuple(p)


def random_in_unit_disk_reject(state, active=None):
    """Rejection-loop disk sample, 2 draws an iteration (Maths.cpp:20-28).
    g++, which builds the reference, evaluates the float3 constructor's
    arguments right to left: the first draw lands in .y, the second in
    .x (tracecore.random_in_unit_disk_reject)."""
    def draw(st):
        st, r1 = rand01(st)
        st, r2 = rand01(st)
        return st, r2 * 2.0 - 1.0, r1 * 2.0 - 1.0
    return _reject(state, draw, active)


def random_in_unit_sphere_reject(state, active=None):
    """Rejection-loop sphere sample, 3 draws an iteration
    (Maths.cpp:30-37); draw order .z, .y, .x, as g++ evaluates them."""
    def draw(st):
        st, r1 = rand01(st)
        st, r2 = rand01(st)
        st, r3 = rand01(st)
        return st, r3 * 2.0 - 1.0, r2 * 2.0 - 1.0, r1 * 2.0 - 1.0
    return _reject(state, draw, active)


def random_unit_vector_exact(state):
    """Uniform direction, 2 draws, in the reference's C++ association
    (Maths.cpp:39-47): the angle is (r * 2.0f) * kPI, and its sin, cos
    and the root are the C library's (ops/libm.py)."""
    state, r1 = rand01(state)
    z = r1 * 2.0 - 1.0
    state, r2 = rand01(state)
    a = (r2 * 2.0) * PI_F
    r = libm.sqrtf(1.0 - z * z)
    return state, (r * libm.cosf(a), r * libm.sinf(a), z)


class Samplers(NamedTuple):
    """A sampler set (tracecore.Samplers).  GPU: the closed-form samplers
    with a fixed draw count, the sqrt-free interval-overlap shadow test and
    torch's sin/cos (the kernels' and every plain version's).  CPU: the
    reference's scalar core, for the parity route only: rejection loops,
    the root-based shadow test that rounds as the C++ does (ExactShadow),
    and the C library's sinf/cosf, also in the light-cone samples."""
    in_unit_disk: Callable
    in_unit_sphere: Callable
    unit_vector: Callable
    exact_shadow: bool
    sin: Callable
    cos: Callable


GPU_SAMPLERS = Samplers(random_in_unit_disk, random_in_unit_sphere,
                        random_unit_vector, False, torch.sin, torch.cos)
CPU_SAMPLERS = Samplers(random_in_unit_disk_reject,
                        random_in_unit_sphere_reject,
                        random_unit_vector_exact, True, libm.sinf, libm.cosf)


# ---------------------------------------------------------------------------
# Geometry queries.  `tab` is the packed (SCENE_ROWS, N) table; per-sphere
# rows broadcast against (P, 1) lane columns into (P, N).
# ---------------------------------------------------------------------------


def sphere_discr(cx, cy, cz, sq_radius, ro, rd):
    """(nb, discr) of the sphere quadratic (Maths.cpp:97-117's -b trick):
    the ray meets the sphere only where discr > 0.  Broadcasts sphere
    scalars/rows against ray lanes."""
    cox = cx - ro[0]
    coy = cy - ro[1]
    coz = cz - ro[2]
    nb = cox * rd[0] + coy * rd[1] + coz * rd[2]
    c = cox * cox + coy * coy + coz * coz - sq_radius
    return nb, nb * nb - c


def sphere_t(cx, cy, cz, sq_radius, ro, rd, t_min):
    """Nearest valid root of the sphere quadratic (Maths.cpp:97-117's -b
    trick).  Returns (t, valid); broadcasts sphere scalars/rows against
    ray lanes."""
    nb, discr = sphere_discr(cx, cy, cz, sq_radius, ro, rd)
    discr_sq = sqrt_pos(discr)
    t0 = nb - discr_sq
    t1 = nb + discr_sq
    t = torch.where(t0 > t_min, t0, t1)
    return t, (discr > 0.0) & (t > t_min)


def occ_test(nb, c, t_min, t_l):
    """Does the root interval [t0, t1] overlap the shadow segment
    (t_min, t_l)?  The JAX package's sqrt-free interval-overlap form
    (tracecore._occ_test), comparison for comparison: d > 0,
    d > b*|b|, d > -(a*|a|) with a = nb - t_min, b = nb - t_l.  It reports
    "occluded" for a ray that starts inside a sphere whose interval spans
    the light, unlike an exact nearest-hit test (scene.validate_scene)."""
    d = nb * nb - c
    a = nb - t_min
    b = nb - t_l
    return (d > 0.0) & (d > b * torch.abs(b)) & (d > -(a * torch.abs(a)))


def _col(x):
    return x[:, None]


def nearest_hit(tab, ro, rd, t_min: float, t_max: float):
    """Nearest hit over all spheres: (hit_t, hit_id), id -1 on a miss.
    The first index of the minimum valid t equals the JAX package's
    strict `<` select chain (tracecore.py:1012-1014)."""
    t, valid = sphere_t(tab[ROW_CX], tab[ROW_CY], tab[ROW_CZ], tab[ROW_SQR],
                        tuple(map(_col, ro)), tuple(map(_col, rd)), t_min)
    t = torch.where(valid, t, torch.inf)
    best, idx = torch.min(t, dim=1)
    hit = best < t_max
    return torch.where(hit, best, t_max), torch.where(hit, idx, -1)


class Work(NamedTuple):
    """Per-lane int64 work counters: camera/bounce rays, NEE shadow rays,
    the sphere tests of the shadow rays' occlusion loops, the sphere root
    tests of the camera/bounce rays, the chunk-box slab tests of both (0
    for the brute-force traversal), and the soft estimator's sphere tests
    (0 without it): the silhouette queries' (a ray that missed: every
    sphere, or for the chunked traversal those of the chunks its scan
    enters; the winner for one that hit) and the shadow-boundary scans'
    (every sphere but the light, or those of the chunks entered, for each
    shadow ray whose light lies in front of the surface)."""
    traced: torch.Tensor
    shadow: torch.Tensor
    occlusion_tests: torch.Tensor
    hit_tests: torch.Tensor = 0
    slab_tests: torch.Tensor = 0
    silhouette_tests: torch.Tensor = 0
    proximity_tests: torch.Tensor = 0


class OcclusionWork(NamedTuple):
    """Per-lane sphere and slab tests of NEE's occlusion loops, and of its
    shadow-boundary scans (soft estimator)."""
    spheres: torch.Tensor
    slabs: torch.Tensor
    proximity: torch.Tensor = 0


class BruteForce(NamedTuple):
    """The default traversal of bounce/nee_light_e/render_pixels: every
    sphere of the packed table for every ray.  A traversal answers
    nearest_hit(ro, rd, t_min, t_max, active) -> (t, id, slab tests,
    sphere tests) and occluded(pos, l, light, t_min, t_l, active) ->
    (occluded, slab tests, sphere tests), with per-lane counters that the
    caller masks; `active` may restrict the lanes it has to answer for.
    The soft-silhouette estimator's scans: silhouette(ro, rd, t_min,
    hit_id, soft_eps, active) -> (Silhouette, the sphere tests of a missed
    ray's candidate scan) and proximity(pos, l, light, t_min, t_l,
    soft_eps, active) -> (d_occ, the sphere tests of the scan); `active`
    may restrict the lanes whose scan is read (the missed rays, the shadow
    rays whose light lies in front of the surface), and a lane outside it
    may take no candidate (occluder).  scaled.ChunkTraversal is the
    chunked one, the port's form of the JAX package's hit_chunks /
    lights_visible / silhouette_chunks / lights_occlusion_proximity
    hooks."""
    tab: torch.Tensor

    def nearest_hit(self, ro, rd, t_min: float, t_max: float, active=None):
        t, i = nearest_hit(self.tab, ro, rd, t_min, t_max)
        return t, i, 0, self.tab.shape[-1]

    def occluded(self, pos, l, light: int, t_min: float, t_l, active=None):
        occ, tests = occluded(self.tab, pos, l, light, t_min, t_l)
        return occ, 0, tests

    def silhouette(self, ro, rd, t_min: float, hit_id, soft_eps: float,
                   active=None):
        return (silhouette_query(self.tab, ro, rd, t_min, hit_id),
                self.tab.shape[1])

    def proximity(self, pos, l, light: int, t_min: float, t_l,
                  soft_eps: float, active=None):
        d_occ, _ = lights_occlusion_proximity(self.tab, pos, l, light, t_min,
                                              t_l)
        return d_occ, self.tab.shape[1] - 1


class ExactShadow(NamedTuple):
    """BruteForce with the parity route's shadow test
    (tracecore.light_visible(exact=True)): a sphere other than the light
    occludes where its nearest valid root lies before the light's,
    t < t_l, from the roots as the reference's nearest-hit test computes
    them, so the comparison rounds as the C++ does.  Every sphere but the
    light is tested."""
    tab: torch.Tensor

    def nearest_hit(self, ro, rd, t_min: float, t_max: float, active=None):
        return BruteForce(self.tab).nearest_hit(ro, rd, t_min, t_max, active)

    def occluded(self, pos, l, light: int, t_min: float, t_l, active=None):
        tab = self.tab
        t, valid = sphere_t(tab[ROW_CX], tab[ROW_CY], tab[ROW_CZ],
                            tab[ROW_SQR], tuple(map(_col, pos)),
                            tuple(map(_col, l)), t_min)
        blocks = valid & (t < _col(t_l))
        blocks[:, light] = False
        return blocks.any(dim=1), 0, tab.shape[-1] - 1


class Winner(NamedTuple):
    """Attributes of the sphere each lane hit (zeros on a miss)."""
    center: tuple
    inv_radius: torch.Tensor
    alb: tuple
    em: tuple
    roughness: torch.Tensor
    ri: torch.Tensor
    mat: torch.Tensor


def sphere_row(tab, row: int, i: int):
    """Entry `row` of sphere i: a 0-d tensor, or (P,) where `tab` is a
    per-lane (SCENE_ROWS, P, N) table (the parity renderer's frames of an
    animated sequence, one scene per lane)."""
    return tab[row][..., i]


def gather_winner(tab, mat, hit_id) -> Winner:
    """Fetch the hit sphere's table columns (tracecore.gather_winner); a
    per-lane table gives each lane its own scene's."""
    hit = hit_id >= 0
    if tab.dim() == 3:
        idx = hit_id.clamp_min(0).view(1, -1, 1).expand(tab.shape[0], -1, 1)
        g = tab.gather(2, idx).squeeze(2)
    else:
        g = tab[:, hit_id.clamp_min(0)]
    g = torch.where(hit, g, 0.0)
    m = torch.where(hit, mat[hit_id.clamp_min(0)], -1)
    return Winner(center=(g[ROW_CX], g[ROW_CY], g[ROW_CZ]),
                  inv_radius=g[ROW_INVR],
                  alb=(g[ROW_ALB], g[ROW_ALB + 1], g[ROW_ALB + 2]),
                  em=(g[ROW_EM], g[ROW_EM + 1], g[ROW_EM + 2]),
                  roughness=g[ROW_ROUGH], ri=g[ROW_RI], mat=m)


def occluded(tab, pos, l, light: int, t_min: float, t_l):
    """OR over every sphere except `light` of occ_test along l from pos.
    Returns (occluded, tests): `tests` counts the spheres that a loop in
    sphere order, stopping at the first occluder and skipping the light,
    tests -- the kernel's work for this shadow ray."""
    cox = tab[ROW_CX] - _col(pos[0])
    coy = tab[ROW_CY] - _col(pos[1])
    coz = tab[ROW_CZ] - _col(pos[2])
    c = cox * cox + coy * coy + coz * coz - tab[ROW_SQR]
    nb = cox * _col(l[0]) + coy * _col(l[1]) + coz * _col(l[2])
    blocks = occ_test(nb, c, t_min, _col(t_l))
    blocks[:, light] = False
    occ = blocks.any(dim=1)
    first = torch.argmax(blocks.to(torch.int32), dim=1)
    tests = torch.where(occ, first + 1 - (first > light).to(first.dtype),
                        blocks.shape[1] - 1)
    return occ, tests


def sky_color(rd, cfg: RenderConfig):
    """Vertical-gradient sky * 0.3, or the Mitsuba-compare constant
    (Test.cpp:224-232; ComputeShader.hlsl:330-338)."""
    if cfg.do_mitsuba_compare:
        z = torch.zeros_like(rd[1])
        return (z + 0.15, z + 0.21, z + 0.3)
    t = 0.5 * (rd[1] + 1.0)
    one_t = 1.0 - t
    return ((one_t * 1.0 + t * 0.5) * 0.3,
            (one_t * 1.0 + t * 0.7) * 0.3,
            (one_t * 1.0 + t * 1.0) * 0.3)


# ---------------------------------------------------------------------------
# The soft-silhouette estimator's queries (differentiable renders only)
# ---------------------------------------------------------------------------


class Silhouette(NamedTuple):
    """silhouette_query's result: the signed discriminant d of each lane
    (the winner's on a hit, the candidate's on a miss), and the miss side's
    candidate: its index (-1 where none), whether it exists, and its
    closest-approach distance nb along the ray."""
    d: torch.Tensor
    cand: torch.Tensor
    cand_on: torch.Tensor
    nb: torch.Tensor


def silhouette_query(tab, ro, rd, t_min: float, hit_id) -> Silhouette:
    """Two-sided silhouette query (tracecore.silhouette_query): on a hit
    lane the winning sphere's discriminant d = nb^2 - c (> 0, -> 0 at its
    silhouette); on a miss lane the largest d over the spheres in front
    (nb > t_min), first index on ties as the JAX package's strict `>`
    chain from -1e9, with that candidate's index and nb.  cand_on: the
    candidate's d exceeds -1e8.  Autograd reaches the selected sphere's
    center and radius^2 rows and the ray."""
    nb, d = sphere_discr(tab[ROW_CX], tab[ROW_CY], tab[ROW_CZ], tab[ROW_SQR],
                         tuple(map(_col, ro)), tuple(map(_col, rd)))
    d_hit = d.gather(1, hit_id.clamp_min(0)[:, None])[:, 0]
    best, cand = torch.where(nb > t_min, d, -1e9).max(dim=1)
    cand_on = best > -1e8
    nb_c = nb.gather(1, cand[:, None])[:, 0]
    return Silhouette(d=torch.where(hit_id >= 0, d_hit, best),
                      cand=torch.where(cand_on, cand, -1), cand_on=cand_on,
                      nb=nb_c)


def lights_occlusion_proximity(tab, pos, l, light: int, t_min: float, t_l):
    """Signed occlusion proximity of one shadow ray
    (tracecore._lights_occlusion_proximity): the largest discriminant
    d = nb^2 - c over the spheres but `light` whose closest approach lies
    inside the shadow segment (t_min < nb < t_l), -1e9 where there is none,
    first index on ties.  d > 0 ~ occluded, d < 0 ~ clear.  Returns
    (d_occ, occluder index)."""
    cox = tab[ROW_CX] - _col(pos[0])
    coy = tab[ROW_CY] - _col(pos[1])
    coz = tab[ROW_CZ] - _col(pos[2])
    nb = cox * _col(l[0]) + coy * _col(l[1]) + coz * _col(l[2])
    c = cox * cox + coy * coy + coz * coz - tab[ROW_SQR]
    d = nb * nb - c
    in_seg = (nb > t_min) & (nb < _col(t_l))
    in_seg[:, light] = False
    return torch.where(in_seg, d, -1e9).max(dim=1)


@torch.no_grad()
def tangent_radiance(tab, mat, emissive_ids, cfg: RenderConfig,
                     q: Silhouette, ro, rd):
    """The radiance a miss lane's ray would carry if it grazed its
    silhouette candidate (tracecore._tangent_radiance): one-bounce shading
    at the tangent point ro + rd * nb.  Lambert: emission + albedo *
    (unoccluded NEE expectation over every light + sky at the normal);
    metal: albedo * sky(rd); dielectric: sky(rd).  Computed without
    autograd: the estimator weighs it by a value that is exactly 0, so its
    gradient is 0.  It runs on every lane, and its guards keep the value
    finite where no candidate exists (rsqrt of max(., 1e-12), d2 >= 1e-8,
    sqrt_pos), since 0 * NaN would reach the image."""
    i = q.cand.clamp_min(0)
    g = tab[:, i]
    m = mat[i]
    pos_t = add3(ro, scale3(rd, q.nb))
    to_c = sub3(pos_t, (g[ROW_CX], g[ROW_CY], g[ROW_CZ]))
    n_t = scale3(to_c, torch.rsqrt(torch.clamp_min(dot3(to_c, to_c), 1e-12)))
    sky_n = sky_color(n_t, cfg)
    sky_d = sky_color(rd, cfg)
    zero = torch.zeros_like(rd[0])
    nee = (zero, zero, zero)
    if cfg.do_light_sampling:
        for e in emissive_ids:
            to_l = sub3((tab[ROW_CX, e], tab[ROW_CY, e], tab[ROW_CZ, e]),
                        pos_t)
            d2 = torch.clamp_min(dot3(to_l, to_l), 1e-8)
            r = tab[ROW_R, e]
            cos_a_max = sqrt_pos(1.0 - r * r / d2)
            omega = TWO_PI * (1.0 - cos_a_max)
            dir_l = scale3(to_l, torch.rsqrt(d2))
            fac = torch.clamp_min(dot3(dir_l, n_t), 0.0) * omega / PI_F
            nee = tuple(nee[k] + tab[ROW_EM + k, e] * fac for k in range(3))
    lam = (q.cand_on & (m == 0)).to(torch.float32)
    met = (q.cand_on & (m == 1)).to(torch.float32)
    die = (q.cand_on & (m == 2)).to(torch.float32)
    return tuple(
        lam * (g[ROW_EM + k] + g[ROW_ALB + k] * (nee[k] + sky_n[k]))
        + met * (g[ROW_ALB + k] * sky_d[k]) + die * sky_d[k]
        for k in range(3))


def soft_weight(d, soft_eps: float):
    """sigmoid(d / eps): the straight-through surrogate's soft weight."""
    return torch.sigmoid(d / soft_eps)


def camera_get_ray(cam: dict, s, t, state, samplers=GPU_SAMPLERS,
                   active=None):
    """Thin-lens ray (Maths.h:437-442): lens offset from the sampler set's
    disk sample, direction ((((llc + s*h) + t*v) - origin) - offset).
    A rejection loop runs only for the `active` lanes (default: all)."""
    state, (dx, dy) = samplers.in_unit_disk(state, active)
    rdx = cam["lens_radius"] * dx
    rdy = cam["lens_radius"] * dy
    off = add3(scale3(cam["u"], rdx), scale3(cam["v"], rdy))
    ro = add3(cam["origin"], off)
    d = sub3(sub3(add3(add3(cam["lower_left"], scale3(cam["horizontal"], s)),
                       scale3(cam["vertical"], t)),
                  cam["origin"]),
             off)
    return state, ro, normalize3(d)


# ---------------------------------------------------------------------------
# Scatter and NEE
# ---------------------------------------------------------------------------


def nee_cones(tab, emissive_ids, pos, hit_id, active, state,
              samplers=GPU_SAMPLERS):
    """Per-light solid-angle cone sample (Test.cpp:94-121): 2 draws per
    light in emissive_ids order, consumed only on lanes where
    active & hit_id != light; the angle's sin and cos are the sampler
    set's.  Returns (state, [(light, lane_on, l, cos_a_max)])."""
    cones = []
    for e in emissive_ids:
        lane_on = active & (hit_id != e)
        sc = (sphere_row(tab, ROW_CX, e), sphere_row(tab, ROW_CY, e),
              sphere_row(tab, ROW_CZ, e))
        r = sphere_row(tab, ROW_R, e)
        sw = normalize3(sub3(sc, pos))
        flat = torch.abs(sw[0]) > 0.01
        up = (torch.where(flat, 0.0, 1.0), torch.where(flat, 1.0, 0.0),
              torch.zeros_like(sw[0]))
        su = normalize3(cross3(up, sw))
        sv = cross3(sw, su)
        dp = sub3(pos, sc)
        d2 = dot3(dp, dp)
        cos_a_max = sqrt_pos(1.0 - r * r / d2)
        st2, eps1 = rand01(state)
        st2, eps2 = rand01(st2)
        state = torch.where(lane_on, st2, state)
        cos_a = 1.0 - eps1 + eps1 * cos_a_max
        sin_a = sqrt_pos(1.0 - cos_a * cos_a)
        phi = TWO_PI * eps2
        l = add3(add3(scale3(su, samplers.cos(phi) * sin_a),
                      scale3(sv, samplers.sin(phi) * sin_a)),
                 scale3(sw, cos_a))
        cones.append((e, lane_on, l, cos_a_max))
    return state, cones


def nee_light_e(tab, cfg: RenderConfig, cones, pos, alb, normal, rd,
                traversal=None, soft_eps: float = 0.0):
    """Visibility and contribution of each cone sample, in light order
    (Test.cpp:123-133; tracecore._nee_light_e).  The light is hit when its
    own root t_l < max_t and no other sphere's root interval overlaps
    (t_min, t_l).  Returns (light_e vec3, shadow ray count, OcclusionWork
    of the occlusion loops): one shadow ray per light with hit_id != light,
    visible or not; the occlusion loop runs only where the light itself is
    hit.  `traversal` answers the occlusion queries (default
    BruteForce(tab)).

    soft_eps > 0: the soft shadow boundary.  Each light's visibility is
    the straight-through sigmoid of -d_occ / eps (the traversal's
    proximity scan, lights_occlusion_proximity for BruteForce), written in the JAX package's association: stop(see -
    sigma) + sigma is `see` bit for bit (Sterbenz), and where the
    interval-overlap test and the sign of d_occ disagree the hard value
    stands with no gradient.  Its scans are counted in
    OcclusionWork.proximity for the lanes whose light lies in front of the
    surface (the others contribute 0)."""
    if traversal is None:
        traversal = BruteForce(tab)
    light_e = tuple(torch.zeros_like(normal[0]) for _ in range(3))
    shadow_cnt = torch.zeros(normal[0].shape, dtype=torch.int64,
                             device=normal[0].device)
    occ_tests = occ_slabs = prox_tests = shadow_cnt
    nl = sel3(dot3(normal, rd) < 0.0, normal, neg3(normal))
    for e, lane_on, l, cos_a_max in cones:
        t_l, valid = sphere_t(sphere_row(tab, ROW_CX, e),
                              sphere_row(tab, ROW_CY, e),
                              sphere_row(tab, ROW_CZ, e),
                              sphere_row(tab, ROW_SQR, e), pos, l, cfg.min_t)
        light_hit = valid & (t_l < cfg.max_t)
        tested = lane_on & light_hit
        occ, slabs, tests = traversal.occluded(pos, l, e, cfg.min_t, t_l,
                                               active=tested)
        see = light_hit & ~occ
        occ_tests = occ_tests + torch.where(tested, tests, 0)
        occ_slabs = occ_slabs + torch.where(tested, slabs, 0)
        omega = TWO_PI * (1.0 - cos_a_max)
        dl = dot3(l, nl)
        fac = torch.clamp_min(dl, 0.0) * omega / PI_F
        em = tuple(sphere_row(tab, ROW_EM + k, e) for k in range(3))
        if soft_eps > 0.0:
            # only lanes whose light lies in front of the surface carry
            # the term (fac = 0 elsewhere); the others take no occluder
            scanned = lane_on & (dl > 0.0)
            d_occ, scan = traversal.proximity(pos, l, e, cfg.min_t,
                                              t_l.detach(), soft_eps,
                                              active=scanned)
            see_f = see.to(torch.float32)
            vis_s = soft_weight(-d_occ, soft_eps)
            agree = see == (d_occ < 0.0)
            vis = torch.where(agree, (see_f - vis_s).detach() + vis_s,
                              see_f)
            lane_f = lane_on.to(torch.float32)
            light_e = tuple(light_e[k] + (alb[k] * em[k]) * fac * vis
                            * lane_f for k in range(3))
            prox_tests = prox_tests + torch.where(scanned, scan, 0)
        else:
            on = lane_on & see
            light_e = tuple(torch.where(
                on, light_e[k] + (alb[k] * em[k]) * fac, light_e[k])
                for k in range(3))
        shadow_cnt = shadow_cnt + lane_on.to(torch.int64)
    return light_e, shadow_cnt, OcclusionWork(occ_tests, occ_slabs,
                                              prox_tests)


def scatter_metal(state, refl, rough, samplers=GPU_SAMPLERS, active=None):
    """Mirror plus roughness fuzz from the sampler set's sphere sample
    (Test.cpp:137-150): 3 draws, or 3 an iteration of the rejection
    loop, which needs to run only for the `active` lanes."""
    state, rius = samplers.in_unit_sphere(state, active)
    return state, normalize3(add3(refl, scale3(rius, rough)))


def scatter_dielectric(state, rd, normal, refl, ri):
    """Schlick-weighted reflect/refract, 1 draw (Test.cpp:151-186)."""
    rdn = dot3(rd, normal)
    entering = rdn <= 0.0
    outward = sel3(entering, normal, neg3(normal))
    safe_ri = torch.where(ri == 0.0, 1.0, ri)
    nint = torch.where(entering, 1.0 / safe_ri, ri)
    cosine = torch.where(entering, -rdn, ri * rdn)
    dt = dot3(rd, outward)
    discr = 1.0 - nint * nint * (1.0 - dt * dt)
    refr = sub3(scale3(sub3(rd, scale3(outward, dt)), nint),
                scale3(outward, sqrt_pos(discr)))
    refl_prob = torch.where(discr > 0.0, schlick(cosine, ri), 1.0)
    state, rr = rand01(state)
    return state, normalize3(sel3(rr < refl_prob, refl, refr))


def bounce(tab, mat, emissive_ids, cfg: RenderConfig, carry,
           traversal=None, soft_eps: float = 0.0, samplers=GPU_SAMPLERS,
           skip_empty: bool = False):
    """One bounce over all lanes (tracecore.bounce_parts with GPU
    samplers and the fused hard-shadow NEE).

    carry = (ro, rd, alive, do_me, state, work).  Returns (carry, e, c),
    with e and c the per-lane emission and continuation attenuation of
    this depth: miss -> (sky, 0); scattered -> (gated emission + NEE,
    albedo); absorbed -> (ungated emission, 0); dead -> (0, 1).
    `traversal` answers the ray queries (default BruteForce(tab)); the
    winner's attributes come from `tab` either way.

    soft_eps > 0 adds the soft-silhouette estimator (bounce_parts(soft=
    True)): the hit/miss select becomes straight-through sigmoids of the
    silhouette discriminant, two-sided (hit lanes blend the hit radiance
    against the sky, miss lanes with a candidate the tangent radiance
    against the sky), and NEE gets the soft shadow boundary.  e and c keep
    their values bit for bit; only the backward changes.

    samplers=CPU_SAMPLERS: the parity route's bounce (tracecore.bounce_parts
    with CPU_SAMPLERS): rejection samplers, the C library's trig, and by
    default the ExactShadow traversal.  skip_empty=True leaves out a
    material branch that no lane takes (tracecore.bounce_parts(
    skip_empty=True)): its placeholders are never selected, so every value
    is the same, at the cost of a host sync per branch."""
    if traversal is None:
        traversal = ExactShadow(tab) if samplers.exact_shadow \
            else BruteForce(tab)
    ro, rd, alive, do_me, state, work = carry
    (traced, shadow, occ_tests, hit_tests, slab_tests, sil_tests,
     prox_tests) = work
    traced = traced + alive.to(torch.int64)
    hit_t, hit_id, slabs, tests = traversal.nearest_hit(
        ro, rd, cfg.min_t, cfg.max_t, active=alive)
    hit_tests = hit_tests + torch.where(alive, tests, 0)
    slab_tests = slab_tests + torch.where(alive, slabs, 0)
    hit = alive & (hit_id >= 0)
    no_hit = alive & (hit_id < 0)
    w = gather_winner(tab, mat, hit_id)
    sky = sky_color(rd, cfg)
    pos = add3(ro, scale3(rd, hit_t))
    normal = scale3(sub3(pos, w.center), w.inv_radius)
    lam_on = hit & (w.mat == 0)
    met_on = hit & (w.mat == 1)
    die_on = hit & (w.mat == 2)
    refl = reflect3(rd, normal)

    def runs(mask):
        return not skip_empty or bool(mask.any())

    # Lambert: direction, then the NEE cones (own RNG thread)
    zero = torch.zeros_like(rd[0])
    light_e = (zero, zero, zero)
    lam_runs = runs(lam_on)
    if lam_runs:
        st_l, ruv = samplers.unit_vector(state)
        sdir_l = normalize3(sub3(add3(add3(pos, normal), ruv), pos))
    else:
        st_l, sdir_l = state, rd
    if cfg.do_light_sampling and lam_runs:
        st_l, cones = nee_cones(tab, emissive_ids, pos, hit_id, lam_on, st_l,
                                samplers)
        light_e, shadow_cnt, occ_work = nee_light_e(
            tab, cfg, cones, pos, w.alb, normal, rd, traversal, soft_eps)
        shadow = shadow + torch.where(lam_on, shadow_cnt, 0)
        occ_tests = occ_tests + torch.where(lam_on, occ_work.spheres, 0)
        slab_tests = slab_tests + torch.where(lam_on, occ_work.slabs, 0)
        prox_tests = prox_tests + torch.where(lam_on, occ_work.proximity, 0)

    rough = torch.zeros_like(w.roughness) if cfg.do_mitsuba_compare \
        else w.roughness
    st_m, sdir_m = scatter_metal(state, refl, rough, samplers, met_on) \
        if runs(met_on) else (state, refl)
    met_ok = dot3(sdir_m, normal) > 0.0
    st_d, sdir_d = scatter_dielectric(state, rd, normal, refl, w.ri) \
        if runs(die_on) else (state, refl)

    new_state = torch.where(lam_on, st_l, torch.where(
        met_on, st_m, torch.where(die_on, st_d, state)))
    scatter_ok = lam_on | (met_on & met_ok) | die_on
    new_dir = sel3(lam_on, sdir_l, sel3(met_on, sdir_m, sdir_d))
    one = torch.ones_like(zero)
    attenuation = sel3(lam_on | met_on, w.alb,
                       sel3(die_on, (one, one, one), (one, zero, one)))

    # emission with NEE double-count suppression (hlsl:314-325)
    mat_e = w.em
    if cfg.do_light_sampling:
        gated_e = sel3(do_me, mat_e, (zero, zero, zero))
        upd = hit & scatter_ok
        do_me = (upd & ~lam_on) | (~upd & do_me)
    else:
        gated_e = mat_e
    scat = hit & scatter_ok
    died = hit & ~scatter_ok
    zero3 = (zero, zero, zero)
    if soft_eps > 0.0:
        # Forward: w is the hard select (stop(1 - sigma) + sigma == 1 on a
        # hit lane, where d > 0 puts sigma >= 0.5; 0 on a miss lane) and
        # w_m is 0.  Backward: sigma' into the winner (hit lanes) or the
        # candidate (miss lanes with one) and the ray.
        q, scan = traversal.silhouette(ro, rd, cfg.min_t, hit_id, soft_eps,
                                       active=no_hit)
        w_hard = hit_id.ge(0).to(torch.float32)
        w_soft = soft_weight(q.d, soft_eps) * w_hard
        w_hit = (w_hard - w_soft).detach() + w_soft
        gate = (no_hit & q.cand_on).to(torch.float32)
        w_m_soft = soft_weight(q.d, soft_eps) * gate
        w_m = w_m_soft - w_m_soft.detach()
        l_est = tangent_radiance(tab, mat, emissive_ids, cfg, q, ro, rd)
        e_hit = sel3(scatter_ok, add3(gated_e, light_e), mat_e)
        c_hit = sel3(scatter_ok, attenuation, zero3)
        e = sel3(alive, tuple(
            w_hit * e_hit[k] + (1.0 - w_hit) * sky[k]
            + w_m * (l_est[k] - sky[k]) for k in range(3)), zero3)
        c = sel3(alive, scale3(c_hit, w_hit), (one, one, one))
        sil_tests = sil_tests + torch.where(
            no_hit, scan, torch.where(hit, 1, 0))
    else:
        e = sel3(scat, add3(gated_e, light_e),
                 sel3(died, mat_e, sel3(no_hit, sky, zero3)))
        c = sel3(scat, attenuation,
                 sel3(died | no_hit, zero3, (one, one, one)))

    ro = sel3(scat, pos, ro)
    rd = sel3(scat, new_dir, rd)
    state = torch.where(hit, new_state, state)
    work = Work(traced, shadow, occ_tests, hit_tests, slab_tests, sil_tests,
                prox_tests)
    return (ro, rd, scat, do_me, state, work), e, c


class Trips(NamedTuple):
    """Per-lane trip counts of render_pixels(stats=True): the plain form of
    the stats render kernel's counters (csrc/trace.cuh tpt::Trips), from
    which the TPU kernel's occupancy counters follow exactly
    (ops/cuda_render.tile_counters).  int64 tensors."""
    bounces: torch.Tensor      # b: bounces over the samples (= Work.traced)
    cutoffs: torch.Tensor      # c: samples still alive after max_depth
    last_cutoff: torch.Tensor  # l: 1 when the last sample was one of them
    depths: torch.Tensor       # (P, spp): each sample's bounces


def render_pixels(tab, mat, emissive_ids, cfg: RenderConfig, cam: dict,
                  px, py, frame: int, traversal=None, stats: bool = False,
                  soft_eps: float = 0.0, samplers=GPU_SAMPLERS):
    """Render 1-D lanes of pixels (px, py: int64 global coordinates, y=0
    the bottom row): seed, spp thin-lens samples each traced for up to
    max_depth bounces, average (tracecore.render_pixels_lockstep; the
    kernel runs the same per-pixel sequence as a loop).

    A sample that scatters at depth max_depth keeps that bounce's
    emission and NEE and adds no sky (ComputeShader.hlsl:300).  Returns
    (col vec3, per-lane Work); the reference's ray count is
    work.traced + work.shadow.  `traversal` answers the ray queries
    (default BruteForce(tab); scaled.ChunkTraversal for a ScaledScene).
    stats=True appends the per-lane Trips; the colour and Work are the
    same either way.  soft_eps > 0 adds the soft-silhouette estimator's
    backward terms (bounce); the colour stays bit for bit as it is.
    `samplers` is the sampler set of the camera and the bounces."""
    state = seed_pixels(px, py, frame)
    fx = px.to(torch.float32)
    fy = py.to(torch.float32)
    inv_w = float(np.float32(cfg.inv_width))
    inv_h = float(np.float32(cfg.inv_height))
    zero = torch.zeros_like(fx)
    col_sum = (zero, zero, zero)
    izero = torch.zeros_like(px, dtype=torch.int64)
    work = Work(izero, izero, izero, izero, izero, izero, izero)
    depths, cuts = [], []
    for _ in range(cfg.samples_per_pixel):
        state, ur = rand01(state)
        u = (fx + ur) * inv_w
        state, vr = rand01(state)
        v = (fy + vr) * inv_h
        state, ro, rd = camera_get_ray(cam, u, v, state, samplers)
        col = (zero, zero, zero)
        atten = (zero + 1.0, zero + 1.0, zero + 1.0)
        alive = torch.ones_like(px, dtype=torch.bool)
        do_me = alive
        traced0 = work.traced
        for _ in range(cfg.max_depth):
            (ro, rd, alive, do_me, state, work), e, c = bounce(
                tab, mat, emissive_ids, cfg,
                (ro, rd, alive, do_me, state, work), traversal, soft_eps,
                samplers)
            col = add3(col, mul3(atten, e))
            atten = mul3(atten, c)
            if not bool(alive.any()):
                break
        col_sum = add3(col_sum, col)
        # still alive here only after max_depth bounces: the depth cutoff
        depths.append(work.traced - traced0)
        cuts.append(alive.to(torch.int64))
    inv_spp = float(np.float32(1.0 / cfg.samples_per_pixel))
    col = scale3(col_sum, inv_spp)
    if not stats:
        return col, work
    return col, work, Trips(work.traced, sum(cuts), cuts[-1],
                            torch.stack(depths, dim=1))


def render_pixels_wavefront(tab, mat, emissive_ids, cfg: RenderConfig,
                            cam: dict, px, py, frame: int):
    """render_pixels in the schedule of the JAX package's merged persistent
    wavefront (tracecore.render_pixels_fused_merged, forward and
    differentiable=True): the lanes are pixels, and each iteration every
    lane with work traces one bounce of its current sample; a lane whose
    sample ends (a miss, an absorbed metal ray, the depth cutoff) adds it
    to its pixel's sum and at once draws its next sample's camera ray from
    the same RNG state, with render_pixels' draws in render_pixels' order,
    until every lane has finished spp samples.  So the loop runs about spp
    x E[depth] iterations, not lockstep's spp x max_depth, and the kernel
    pair on a card (K1's tape instance and csrc/wavegrad.cu's sweep) runs
    the same schedule.  Each lane runs render_pixels' elementwise ops on the
    same values, so the colour is render_pixels' bit for bit per pixel and
    the Work counters equal its.  Returns (col vec3, per-lane Work).

    Under autograd (grad enabled and `tab` requiring it) each iteration
    runs through torch.utils.checkpoint (non-reentrant), so
    the graph keeps the carries and recomputes an iteration's
    intermediates in the backward: JAX's jax.checkpoint per iteration.  An
    eager loop needs no static trip count: a plain `break` once no lane has
    work replaces JAX's fixed-bound fori_loop whose step is a whole-tile
    lax.cond.  Left out, because they change the order in which XLA issues
    ops and not any lane's values: JAX's software pipelining (the hit of
    the next ray carried one iteration ahead) and its merged sphere loop
    (the next ray's argmin and the shadow rays' occlusion in one pass over
    the spheres from the shared hit point); the bounce here is
    render_pixels' (bounce, brute-force traversal, GPU samplers)."""
    remat = torch.is_grad_enabled() and tab.requires_grad
    spp = cfg.samples_per_pixel
    fx = px.to(torch.float32)
    fy = py.to(torch.float32)
    inv_w = float(np.float32(cfg.inv_width))
    inv_h = float(np.float32(cfg.inv_height))
    zero = torch.zeros_like(fx)
    one = zero + 1.0
    zero3, one3 = (zero, zero, zero), (one, one, one)
    izero = torch.zeros_like(px, dtype=torch.int64)
    traversal = BruteForce(tab)

    def camera_sample(state):
        state, ur = rand01(state)
        u = (fx + ur) * inv_w
        state, vr = rand01(state)
        v = (fy + vr) * inv_h
        return camera_get_ray(cam, u, v, state)

    def step(ro, rd, busy, do_me, state, depth, started, col, atten,
             col_sum, work):
        (ro, rd, alive, do_me, state, work), e, c = bounce(
            tab, mat, emissive_ids, cfg, (ro, rd, busy, do_me, state, work),
            traversal)
        col = add3(col, mul3(atten, e))
        atten = mul3(atten, c)
        depth = depth + busy.to(torch.int64)
        ended = busy & (~alive | (depth >= cfg.max_depth))
        col_sum = sel3(ended, add3(col_sum, col), col_sum)
        # the ended lanes' next samples
        refill = ended & (started < spp)
        st2, ro_n, rd_n = camera_sample(state)
        state = torch.where(refill, st2, state)
        ro = sel3(refill, ro_n, ro)
        rd = sel3(refill, rd_n, rd)
        col = sel3(refill, zero3, col)
        atten = sel3(refill, one3, atten)
        do_me = do_me | refill
        depth = torch.where(refill, 0, depth)
        started = started + refill.to(torch.int64)
        busy = (busy & ~ended) | refill
        return (ro, rd, busy, do_me, state, depth, started, col, atten,
                col_sum, work)

    state, ro, rd = camera_sample(seed_pixels(px, py, frame))
    busy = torch.ones_like(px, dtype=torch.bool)
    carry = (ro, rd, busy, busy, state, izero, izero + 1, zero3, one3, zero3,
             Work(izero, izero, izero, izero, izero, izero, izero))
    while bool(carry[2].any()):
        if remat:
            carry = checkpoint(step, *carry, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            carry = step(*carry)
    inv_spp = float(np.float32(1.0 / spp))
    return scale3(carry[9], inv_spp), carry[10]


def render_pixels_diff(tab, mat, emissive_ids, cfg: RenderConfig, cam: dict,
                       px, py, frame: int, traversal=None,
                       soft_eps: float = 0.0, samplers=GPU_SAMPLERS):
    """The differentiable render's dispatch (tracecore.render_pixels with
    differentiable=True): with cfg.diff_wavefront the wavefront
    (render_pixels_wavefront), else lockstep (render_pixels).  As in the
    JAX package the flag falls back to lockstep with a warning
    (config.warn_diff_wavefront) for exact-shadow samplers (the parity
    route) and for a traversal of its own (the chunked scene).  Returns
    (col vec3, per-lane Work)."""
    if cfg.diff_wavefront:
        if samplers.exact_shadow or traversal is not None:
            warn_diff_wavefront(cfg)
        else:
            return render_pixels_wavefront(tab, mat, emissive_ids, cfg, cam,
                                           px, py, frame)
    return render_pixels(tab, mat, emissive_ids, cfg, cam, px, py, frame,
                         traversal, soft_eps=soft_eps, samplers=samplers)


# ---------------------------------------------------------------------------
# The parity route: the reference's scalar C++ recursion (Test.cpp:195-234)
# ---------------------------------------------------------------------------


def tail_parts(tab, mat, cfg: RenderConfig, carry):
    """The recursion's depth == kMaxDepth level (tracecore.tail_parts;
    Test.cpp:195-234 with `depth < kMaxDepth` failing): one more nearest
    hit for each lane still alive, whose emission counts ungated; a miss
    gives the sky; no scatter and no draw.  Returns (carry, e, c) with c =
    0 and every lane dead."""
    ro, rd, alive, do_me, state, work = carry
    hit_t, hit_id = nearest_hit(tab, ro, rd, cfg.min_t, cfg.max_t)
    hit = alive & (hit_id >= 0)
    no_hit = alive & (hit_id < 0)
    w = gather_winner(tab, mat, hit_id)
    sky = sky_color(rd, cfg)
    zero = torch.zeros_like(rd[0])
    zero3 = (zero, zero, zero)
    e = sel3(hit, w.em, sel3(no_hit, sky, zero3))
    work = work._replace(traced=work.traced + alive.to(torch.int64))
    return (ro, rd, torch.zeros_like(alive), do_me, state, work), e, zero3


def trace_cpu_exact(tab, mat, emissive_ids, cfg: RenderConfig, ro, rd,
                    state, traversal=None):
    """The reference's scalar trace of a batch of rays
    (tracecore.trace_cpu_exact): max_depth bounces with CPU_SAMPLERS, the
    tail level, and radiance folded backward as the recursion multiplies
    it on the way up (Test.cpp:216): col = e_d + c_d * col over the
    reversed depths, which rounds differently from render_pixels' forward
    accumulation.  Returns (col vec3, final RNG state, int64 per-lane ray
    count: traced and shadow rays).

    Once no lane is alive the remaining depths are left out: there every
    lane has e = 0 and c = 1 (the tail e = 0 and c = 0 after a last live
    depth's c), which leave the fold, the state and the count as they are,
    bit for bit."""
    zero = torch.zeros_like(ro[0])
    izero = torch.zeros(zero.shape, dtype=torch.int64, device=zero.device)
    alive = torch.ones(zero.shape, dtype=torch.bool, device=zero.device)
    carry = (ro, rd, alive, alive, state, Work(izero, izero, izero))
    parts = []
    for _ in range(cfg.max_depth):
        carry, e, c = bounce(tab, mat, emissive_ids, cfg, carry, traversal,
                             samplers=CPU_SAMPLERS, skip_empty=True)
        parts.append((e, c))
        if not bool(carry[2].any()):
            break
    else:
        carry, e, c = tail_parts(tab, mat, cfg, carry)
        parts.append((e, c))
    col = (zero, zero, zero)
    for e, c in reversed(parts):
        col = add3(e, mul3(c, col))
    work = carry[5]
    return col, carry[4], work.traced + work.shadow
