"""The port's CPU-exact parity route (ops/tracecore.CPU_SAMPLERS,
trace_cpu_exact; render/parity.py) against the reference's own goldens
and against the JAX package's parity route, on the CPU.

Goldens: tests/golden/*.npz, rendered by a compiled build of the
reference's scalar C++ (tools/gen_golden.py), held at tests/test_parity.py's
gates, numbers unchanged.  The port's values measured at the time of
writing: tiny_f1 97% of pixels within 1e-3 (gate 25%), median 4.5e-8;
small_anim_f2 90% (gate 15%); tiny_pp_d2_f1 max 1.1e-4 and no flipped
pixel, rays exact; tiny_pp_d3_f1 0.2% flipped (gate 2%).

JAX: its jitted code contracts a product and a sum into one multiply-add
on this CPU, which the C++ and the port do not (1 - z*z in the unit
vector sampler parts on 16% of lanes), so the JAX side runs in a child
process with XLA_FLAGS=--xla_cpu_max_isa=AVX, as tests/test_torch_soft.py
does.  There the three exact samplers are bit-equal.  torch's float32 sqrt
on the CPU is within 0.5001 ulp, not correctly rounded, so past the
samplers (whose root is libm.sqrtf) the port and XLA part in the last bit
of about 0.5% of roots; through a chaotic path that flips a few lanes'
branches, hence the lane-share gates of the trace and pp tests.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_golden

from toypathtracer_torch import (FLAG_ANIMATE, FLAG_PROGRESSIVE,
                                 RenderConfig, make_scene)
from toypathtracer_torch.ops import cuda_render, libm
from toypathtracer_torch.ops import tracecore as tc
from toypathtracer_torch.render.frame import lerp_factor, scene_for_frame
from toypathtracer_torch.render.parity import (_samples, render_frame_parity,
                                               render_frame_parity_pp,
                                               render_frames_parity)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SAMPLERS = ("random_in_unit_disk_reject", "random_in_unit_sphere_reject",
            "random_unit_vector_exact")
TRACE_N = 4096
TRACE_DEPTH = 3

# The JAX side, FMA contraction off: the exact samplers on 4096 seeded
# states, trace_cpu_exact at depth 3 on seeded rays through ArrayScenePort,
# or (argv[2] == "pp") render_frame_parity_pp's per-pixel function at
# test_parity.py's depth-2 configuration, vmapped over the flat pixels.
JAX_CHILD = r"""
import sys

import jax
import jax.numpy as jnp
import numpy as np

from toypathtracer_tpu import RenderConfig, make_scene
from toypathtracer_tpu.camera import make_camera
from toypathtracer_tpu.ops import tracecore as jtc
from toypathtracer_tpu.render.parity import _render_pixel_pp
from toypathtracer_tpu.render.wavefront import ArrayScenePort

d = dict(np.load(sys.argv[1]))
out = {}
scene = make_scene(big=True)
if sys.argv[2] == "pp":
    cfg = RenderConfig(width=64, height=36, max_depth=2)
    cam = make_camera(scene.camera, cfg.width / cfg.height)
    col, rays = jax.jit(jax.vmap(
        lambda x, y: _render_pixel_pp(scene, cfg, cam, 0, x, y)))(
            jnp.asarray(d["px"]), jnp.asarray(d["py"]))
    out["pp_image"] = np.asarray(col).reshape(36, 64, 3)
    out["pp_rays"] = np.asarray(rays).astype(np.int64).sum()
else:
    s = jnp.asarray(d["states"])
    for name in ("random_in_unit_disk_reject", "random_in_unit_sphere_reject",
                 "random_unit_vector_exact"):
        st, v = jax.jit(jax.vmap(getattr(jtc, name)))(s)
        out[name + "_state"] = np.asarray(st)
        out[name + "_value"] = np.stack([np.asarray(x) for x in v])
    cfg = RenderConfig(width=64, height=36, max_depth=int(d["depth"]))
    port = ArrayScenePort(scene)
    col, st, rays = jax.jit(jax.vmap(
        lambda ro, rd, s: jtc.trace_cpu_exact(port, cfg, ro, rd, s)))(
            tuple(jnp.asarray(x) for x in d["ro"]),
            tuple(jnp.asarray(x) for x in d["rd"]), jnp.asarray(d["st"]))
    out["trace_col"] = np.stack([np.asarray(x) for x in col])
    out["trace_state"] = np.asarray(st)
    out["trace_rays"] = np.asarray(rays)
np.savez(sys.argv[3], **out)
"""


class JaxChild:
    """The JAX side in a child process, started at once and read when
    needed: the module's fixture starts both children together, so the
    pp reference (most of it XLA's compile) runs beside the other
    tests."""

    def __init__(self, tmp_path, mode, **arrays):
        np.savez(tmp_path / "in.npz", **arrays)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_cpu_max_isa=AVX",
                   PYTHONPATH=os.pathsep.join([str(ROOT)]
                                              + [q for q in sys.path if q]))
        self.out = tmp_path / "out.npz"
        self.proc = subprocess.Popen(
            [sys.executable, "-c", JAX_CHILD, str(tmp_path / "in.npz"), mode,
             str(self.out)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    def result(self) -> dict:
        try:
            log, _ = self.proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            raise
        assert self.proc.returncode == 0, log
        with np.load(self.out) as o:
            return dict(o)


def seeded_rays(n, seed):
    """Rays from around the camera into the big scene, and RNG states."""
    rng = np.random.default_rng(seed)
    ro = (np.array([0.0, 2.0, 3.0])[:, None]
          + rng.uniform(-0.05, 0.05, (3, n))).astype(np.float32)
    target = np.stack([rng.uniform(-4, 4, n), rng.uniform(-1, 1.5, n),
                       rng.uniform(-6, 1, n)])
    rd = target - ro
    rd = (rd / np.linalg.norm(rd, axis=0)).astype(np.float32)
    st = rng.integers(1, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    return ro, rd, st


@pytest.fixture(scope="module")
def jax_children(tmp_path_factory):
    rng = np.random.default_rng(21)
    states = rng.integers(1, 2**32, size=4096,
                          dtype=np.uint64).astype(np.uint32)
    ro, rd, st = seeded_rays(TRACE_N, 22)
    yy, xx = np.meshgrid(np.arange(36, dtype=np.int32),
                         np.arange(64, dtype=np.int32), indexing="ij")
    pp = JaxChild(tmp_path_factory.mktemp("parity_pp"), "pp",
                  px=xx.ravel(), py=yy.ravel())
    trace = JaxChild(tmp_path_factory.mktemp("parity_jax"), "trace",
                     states=states, ro=ro, rd=rd, st=st, depth=TRACE_DEPTH)
    yield dict(states=states, ro=ro, rd=rd, st=st), trace, pp
    for child in (trace, pp):
        if child.proc.poll() is None:
            child.proc.kill()
            child.proc.wait()


@pytest.fixture(scope="module")
def jax_ref(jax_children):
    inputs, trace, _ = jax_children
    return dict(trace.result(), **inputs)


def t64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("name", SAMPLERS)
def test_exact_samplers_bit_equal_to_jax(jax_ref, name):
    """Draw counts (the RNG state after the rejection loops) and values
    bit-equal on 4096 seeded states; the g++ draw-to-component order
    (first draw in .y for the disk, .z for the sphere) included."""
    st, v = getattr(tc, name)(t64(jax_ref["states"]))
    np.testing.assert_array_equal(st.numpy(),
                                  jax_ref[name + "_state"].astype(np.int64))
    np.testing.assert_array_equal(torch.stack(v).numpy(),
                                  jax_ref[name + "_value"])


def test_rejection_loop_restricted_to_active_lanes():
    """A lane outside `active` draws once, an active lane as the full
    loop does."""
    s = t64(np.random.default_rng(3).integers(1, 2**32, size=4096,
                                              dtype=np.uint64))
    active = torch.from_numpy(np.random.default_rng(4).random(4096) < 0.3)
    full_st, full_v = tc.random_in_unit_sphere_reject(s)
    st, v = tc.random_in_unit_sphere_reject(s, active)
    once_st = tc.rand01(tc.rand01(tc.rand01(s)[0])[0])[0]
    assert torch.equal(st[active], full_st[active])
    assert torch.equal(st[~active], once_st[~active])
    for a, b in zip(v, full_v):
        assert torch.equal(a[active], b[active])


@pytest.mark.parametrize("angle", ["unit_vector", "light_cone"])
def test_libm_trig_bit_equal_to_jnp_on_the_sampler_grid(angle):
    """The whole 2^24-point sampler grid r = k / 2^24, as the unit vector
    sampler forms its angle, (r * 2.0f) * kPI, and as the light cone does,
    float32(2 kPI) * r: the C library's sinf/cosf (csrc/libm.cpp) equal
    XLA's jnp.sin/jnp.cos, which equal glibc's there (torch.sin parts on
    about 5% of them)."""
    r = torch.arange(1 << 24, dtype=torch.int32).to(torch.float32) \
        * tc.INV_2_24
    a = (r * 2.0) * tc.PI_F if angle == "unit_vector" else tc.TWO_PI * r
    an = a.numpy()
    np.testing.assert_array_equal(libm.sinf(a).numpy(),
                                  np.asarray(jax.jit(jnp.sin)(an)))
    np.testing.assert_array_equal(libm.cosf(a).numpy(),
                                  np.asarray(jax.jit(jnp.cos)(an)))


def test_libm_sqrtf_is_correctly_rounded():
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 4, 100_000).astype(np.float32))
    np.testing.assert_array_equal(libm.sqrtf(x).numpy(),
                                  np.sqrt(x.numpy()))


def test_trace_cpu_exact_against_jax(jax_ref):
    """trace_cpu_exact at depth 3 on 4096 seeded rays into the big scene
    against JAX's through ArrayScenePort: rays and final RNG states equal
    on at least 99% of lanes (the lanes that part are listed), colours
    within 2e-4 on those lanes (measured: every lane, 1.3e-5)."""
    scene = make_scene(big=True)
    cfg = RenderConfig(width=64, height=36, max_depth=TRACE_DEPTH)
    tab = cuda_render.pack_scene(scene)
    mat = torch.tensor(scene.mat_type)
    col, st, rays = tc.trace_cpu_exact(
        tab, mat, scene.emissive_ids, cfg,
        tuple(torch.from_numpy(x) for x in jax_ref["ro"]),
        tuple(torch.from_numpy(x) for x in jax_ref["rd"]),
        t64(jax_ref["st"]))
    same = (rays.numpy() == jax_ref["trace_rays"]) \
        & (st.numpy() == jax_ref["trace_state"].astype(np.int64))
    parted = np.nonzero(~same)[0]
    assert same.mean() >= 0.99, f"lanes that part: {parted.tolist()}"
    d = np.abs(torch.stack(col).numpy() - jax_ref["trace_col"])[:, same]
    assert d.max() <= 2e-4, (d.max(), f"lanes that part: {parted.tolist()}")
    assert (rays.numpy() > 1).mean() > 0.5   # the rays bounce


def test_parity_pp_against_jax(jax_children):
    """render_frame_parity_pp at test_parity.py's depth-2 configuration
    (64x36, spp 4) against JAX's per-pixel function: ray counts within
    2e-3, at most 0.5% of pixels apart by 2e-4 or more, median |diff|
    < 5e-7 (measured: rays equal, one pixel of 2304, median 1.5e-8)."""
    cfg = RenderConfig(width=64, height=36, max_depth=2)
    ref = jax_children[2].result()
    img, rays = render_frame_parity_pp(make_scene(big=True), cfg, 0,
                                       device="cpu")
    d = np.abs(img.numpy() - ref["pp_image"]).max(axis=-1)
    assert (d >= 2e-4).mean() <= 0.005, (d >= 2e-4).mean()
    assert np.median(d) < 5e-7
    assert abs(int(rays) - int(ref["pp_rays"])) / int(ref["pp_rays"]) < 2e-3


# ---- the goldens: tests/test_parity.py's gates ---------------------------


@pytest.fixture(scope="module")
def tiny_result():
    img, rays = render_frame_parity(make_scene(big=True),
                                    RenderConfig(width=64, height=36), 0,
                                    device="cpu")
    return img.numpy(), int(rays)


def test_tiny_first_pixel_and_row_prefix(tiny_result):
    """Pixel (0, 0) within 2e-5 of the C++; each row's first pixel (a
    fresh RNG stream): median max-channel |diff| < 1e-3."""
    g = load_golden("tiny_f1")
    a, _ = tiny_result
    np.testing.assert_allclose(a[0, 0], g["image"][0, 0], atol=2e-5)
    col0 = np.abs(a[:, 0] - g["image"][:, 0]).max(axis=-1)
    assert np.median(col0) < 1e-3, np.median(col0)


def test_tiny_single_frame_structure(tiny_result):
    g = load_golden("tiny_f1")
    a, rays = tiny_result
    d = np.abs(a - g["image"]).max(axis=-1)
    assert np.median(d) < 0.02, np.median(d)
    assert (d < 1e-3).mean() > 0.25, (d < 1e-3).mean()
    assert abs(rays - int(g["rays"])) / int(g["rays"]) < 0.02


@pytest.mark.parametrize("name,depth,max_err,flip_frac", [
    ("tiny_pp_d2_f1", 2, 2e-4, 0.0),
    ("tiny_pp_d3_f1", 3, 2e-4, 0.02),
])
def test_short_depth_full_frame_tight(name, depth, max_err, flip_frac):
    """Per-pixel seeded goldens at depth 2 and 3: flipped share, median
    < 5e-7, rays within 2e-3 (test_parity.py's gates)."""
    g = load_golden(name)
    assert int(g["max_depth"]) == depth and bool(g["pixel_seed"])
    img, rays = render_frame_parity_pp(
        make_scene(big=True), RenderConfig(width=64, height=36,
                                           max_depth=depth), 0, device="cpu")
    d = np.abs(img.numpy() - g["image"]).max(axis=-1)
    assert (d >= max_err).mean() <= flip_frac, ((d >= max_err).mean(),
                                                d.max())
    assert np.median(d) < 5e-7, np.median(d)
    assert abs(int(rays) - int(g["rays"])) / int(g["rays"]) < 2e-3


def progressive(scene, cfg, frames, flags):
    """The reference's frame loop (tools/oracle_main.cpp): each frame
    animated at f / 60 where animating, rendered, blended with the
    lerp factor (Test.cpp:271-276).  The frames render as one parity
    batch."""
    scenes = [scene_for_frame(scene, np.float32(f / 60.0), flags)
              for f in range(frames)]
    out = render_frames_parity(scenes, cfg, list(range(frames)),
                               device="cpu")
    accum = np.zeros((cfg.height, cfg.width, 3), np.float32)
    for f, (img, _) in enumerate(out):
        fac = lerp_factor(f, flags, cfg)
        accum = accum * fac + img.numpy() * (np.float32(1.0) - fac)
    return accum, [int(r) for _, r in out]


def test_small_animated_progressive_2frame():
    """128x72, animated and progressive, 2 frames (golden small_anim_f2):
    tight share > 0.15, median < 0.02, first pixel within 2e-5, rays per
    frame within 2%."""
    g = load_golden("small_anim_f2")
    a, rays = progressive(make_scene(big=True),
                          RenderConfig(width=128, height=72), 2,
                          FLAG_ANIMATE | FLAG_PROGRESSIVE)
    d = np.abs(a - g["image"]).max(axis=-1)
    assert np.median(d) < 0.02, np.median(d)
    assert (d < 1e-3).mean() > 0.15, (d < 1e-3).mean()
    np.testing.assert_allclose(a[0, 0], g["image"][0, 0], atol=2e-5)
    np.testing.assert_allclose(rays, g["per_frame_rays"], rtol=0.02)
    assert abs(sum(rays) - int(g["rays"])) / int(g["rays"]) < 0.02


def test_progressive_16frame_distribution():
    """16 progressive frames (golden tiny_f16): 4x4-block means of the
    sqrt-tonemapped images agree, mean < 0.02 and max < 0.20, total rays
    within 2%."""
    g = load_golden("tiny_f16")
    a, rays = progressive(make_scene(big=True),
                          RenderConfig(width=64, height=36), 16,
                          FLAG_PROGRESSIVE)
    ta = np.sqrt(np.clip(a, 0, None))
    tb = np.sqrt(np.clip(g["image"], 0, None))
    ab = ta.reshape(9, 4, 16, 4, 3).mean(axis=(1, 3))
    bb = tb.reshape(9, 4, 16, 4, 3).mean(axis=(1, 3))
    assert np.abs(ab - bb).mean() < 0.02, np.abs(ab - bb).mean()
    assert np.abs(ab - bb).max() < 0.20, np.abs(ab - bb).max()
    assert abs(sum(rays) - int(g["rays"])) / int(g["rays"]) < 0.02


# ---- the row loop against the scalar order ------------------------------


def test_row_loop_bit_equal_to_pixel_by_pixel():
    """The persistent row loop (a lane starts its next sample when its
    path ends) gives the image and rays of the rows run pixel by pixel,
    each pixel's samples through trace_cpu_exact in lockstep; a batch of
    an animated sequence's frames gives each frame's own values."""
    scene = make_scene(big=True)
    cfg = RenderConfig(width=6, height=5, samples_per_pixel=2)
    img, rays = render_frame_parity(scene, cfg, 3, device="cpu")
    tab = cuda_render.pack_scene(scene)
    mat = torch.tensor(scene.mat_type)
    from toypathtracer_torch.render.wavefront import camera_scalars
    cam = camera_scalars(scene, cfg)
    ys = torch.arange(5, dtype=torch.int64)
    state = ((ys * 9781 + 3 * 6271) & tc.MASK32) | 1
    want = torch.empty(5, 6, 3)
    want_rays = 0
    for x in range(6):
        col, state, rc = _samples(tab, mat, scene, cfg, cam,
                                  torch.full((5,), float(x)),
                                  ys.to(torch.float32), state)
        want[:, x] = torch.stack(col, dim=-1)
        want_rays += int(rc.sum())
    assert torch.equal(img, want) and int(rays) == want_rays

    flags = FLAG_ANIMATE | FLAG_PROGRESSIVE
    scenes = [scene_for_frame(scene, np.float32(f / 60.0), flags)
              for f in (0, 5)]
    both = render_frames_parity(scenes, cfg, [0, 5], device="cpu")
    for sc, f, (im, r) in zip(scenes, (0, 5), both):
        im1, r1 = render_frame_parity(sc, cfg, f, device="cpu")
        assert torch.equal(im, im1) and int(r) == int(r1)


def test_gpu_sampler_default_unchanged():
    """bounce with the default sampler set is the GPU route: closed-form
    samplers and the interval-overlap shadow test."""
    assert tc.GPU_SAMPLERS.exact_shadow is False
    assert tc.GPU_SAMPLERS.in_unit_disk is tc.random_in_unit_disk
    assert tc.CPU_SAMPLERS.exact_shadow is True


def test_parity_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        render_frame_parity(make_scene(big=False),
                            RenderConfig(width=4, height=2), 0)
    with pytest.raises(RuntimeError, match="device"):
        render_frame_parity_pp(make_scene(big=False),
                               RenderConfig(width=4, height=2), 0)
