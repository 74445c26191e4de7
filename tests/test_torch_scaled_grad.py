"""The scaled scene's gradient on the CPU (toypathtracer_tpu/scaled.py:712
render_frame_scaled(..., differentiable=True), BASELINE config 5 with
gradients): the port's plain version (ops/cuda_scaled.render_frame_scaled
(..., differentiable=True): autograd through scaled.ChunkTraversal, whose
scans pick their sphere without a graph and recompute its root or
discriminant for the gradient) against jax.grad, and the soft estimator's
chunk scans (ChunkedScenePort.silhouette_chunks, .lights_occlusion_
proximity) against the JAX package's.

The JAX gradient is taken in a child process whose XLA may not contract a
product and a sum into one multiply-add (XLA_FLAGS=--xla_cpu_max_isa=AVX,
as tests/test_torch_soft.py), op by op: the body of render_frame_scaled
(tracecore.render_pixels over its ChunkedScenePort, differentiable=True) on
the whole frame, without jax.jit.  Compiled, that function parts from its
own op-by-op values on this scene: 751 rays against 733 (the port's count,
and the op-by-op count), 8 of 256 pixels apart by more than 1e-3, one
pixel's gradient of a centre by 4.5% where both images agree (measured;
JAX's own one-pixel evaluation, compiled or not, is the port's there).
Op by op, one pixel of 256 still parts from the port by 1.04e-3, pixel
(row 2, column 19) in both cases (a ray grazing sphere 450, whose
discriminant's square root amplifies the rounding); every other pixel
agrees within 1e-5 (measured).  The cotangent leaves out that pixel,
fixed by its coordinate (EXCLUDED), and with it out the per-field
differences are at most 1.9e-5 of the field's max (measured; with it in,
7.7e-2 on the centres, all of it sphere 450's).

Tolerances: per field, max |diff| <= 1e-3 x the field's max |jax.grad|
(tests/test_torch_soft.py's gate); rays exact; the image within 1e-4 off
EXCLUDED and within 2e-3 on it (measured 1.04e-3; the gate of the card
test of K3's chunked soft instance for the same grazing-hit cause,
tests/test_torch_grad_kernel_cpu.py::
test_chunked_soft_gradient_is_ill_conditioned_at_a_grazing_hit).  The
scans at the 200-sphere
setups of tests/test_scaled.py:199 and :262, in this process: the
discriminants within rtol 1e-4, atol 2e-3 (those tests' own gate between
XLA's fused scan and op-by-op code), the candidates equal wherever the
silhouette is in the gradient-visible band (d >= -8 eps).  The albedo
AD-vs-FD check of tests/test_scaled.py:129 on the port alone (< 5e-2).
"""

import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toypathtracer_torch import RenderConfig, make_scene
from toypathtracer_torch.ops import cuda_grad, cuda_scaled
from toypathtracer_torch.ops import tracecore as tc
from toypathtracer_torch.render.wavefront import camera_scalars
from toypathtracer_torch.scaled import (ChunkedScenePort, make_scaled_scene,
                                        refresh_chunk_aabb)
from toypathtracer_tpu import scaled as jscaled
from toypathtracer_tpu.ops import tracecore as jtc

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("center", "radius", "albedo", "emissive", "roughness", "ri")
SCENE = dict(n=2000, chunk=64, extent=40.0)
CFG = dict(width=32, height=8, samples_per_pixel=1, max_depth=3)
CASES = {"hard": 0.0, "soft": 1.0}
# (row, column) of the pixels the cotangent leaves out: the grazing ray
# off sphere 450 (see above).
EXCLUDED = ((2, 19),)


def kept_pixels():
    """(height, width) bool: every pixel but EXCLUDED."""
    keep = np.ones((CFG["height"], CFG["width"]), dtype=bool)
    for yx in EXCLUDED:
        keep[yx] = False
    return keep


# The JAX references, written to the .npz named by argv[1]: per case the
# op-by-op image and rays and jax.grad of sum(img * w), w off the pixels
# of argv[5].
JAX_REFERENCE = r"""
import sys

import jax
import jax.numpy as jnp
import numpy as np

from toypathtracer_tpu.camera import make_camera
from toypathtracer_tpu.config import RenderConfig
from toypathtracer_tpu.ops import tracecore as tc
from toypathtracer_tpu.scaled import ChunkedScenePort, make_scaled_scene

scene_kw, cfg_kw, cases, excluded = (eval(a) for a in sys.argv[2:6])
s = make_scaled_scene(**scene_kw)
yy, xx = jnp.meshgrid(jnp.arange(cfg_kw["height"], dtype=jnp.int32),
                      jnp.arange(cfg_kw["width"], dtype=jnp.int32),
                      indexing="ij")
w0 = np.random.RandomState(0).rand(cfg_kw["height"], cfg_kw["width"],
                                   3).astype(np.float32)
out = {}
for name, eps in cases.items():
    cfg = RenderConfig(**cfg_kw, soft_silhouette_eps=eps)
    cam = make_camera(s.camera, cfg.width / cfg.height)

    def render(scene):
        col, rays = tc.render_pixels(ChunkedScenePort(scene), cfg, cam, xx,
                                     yy, jnp.int32(0), differentiable=True)
        return jnp.stack(col, axis=-1), jnp.sum(rays)

    img, rays = render(s)
    w = w0.copy()
    for yx in excluded:
        w[yx] = 0.0
    g = jax.grad(lambda sc: jnp.sum(render(sc)[0] * w), allow_int=True)(s)
    for f in ("center", "radius", "albedo", "emissive", "roughness", "ri"):
        out[name + "_" + f] = np.asarray(getattr(g, f))
    out[name + "_img"] = np.asarray(img)
    out[name + "_rays"] = np.asarray(rays)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("scaled_grad_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in sys.path if p]))
    subprocess.run([sys.executable, "-c", JAX_REFERENCE, str(path),
                    repr(SCENE), repr(CFG), repr(CASES), repr(EXCLUDED)],
                   env=env, check=True, timeout=900)
    return dict(np.load(path))


@pytest.fixture(scope="module")
def port_grads(jax_ref):
    """Per case: the port's image, rays and the fields' gradients of
    sum(img * w) over the pixels but EXCLUDED, through the public route on
    the CPU."""
    out = {}
    keep = kept_pixels()
    for name, eps in CASES.items():
        w = np.random.RandomState(0).rand(CFG["height"], CFG["width"],
                                          3).astype(np.float32)
        w = torch.from_numpy(w * keep[..., None])
        scene = make_scaled_scene(**SCENE)
        leaves = {f: getattr(scene, f).clone().requires_grad_(True)
                  for f in FIELDS}
        img, rays = cuda_scaled.render_frame_scaled(
            scene.replace(**leaves), RenderConfig(**CFG,
                                                  soft_silhouette_eps=eps),
            0, device="cpu", differentiable=True)
        (img * w).sum().backward()
        out[name] = (img.detach().numpy(), int(rays),
                     {f: t.grad.numpy() for f, t in leaves.items()})
    return out


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_scaled_gradient_matches_jax(jax_ref, port_grads, case, field):
    """Per field within 1e-3 of the field's max |jax.grad|; rays exact;
    the image within 1e-4 off the excluded pixel and 2e-3 on it."""
    img, rays, grads = port_grads[case]
    assert rays == int(jax_ref[case + "_rays"])
    keep = kept_pixels()
    diff = np.abs(img - jax_ref[case + "_img"]).max(axis=-1)
    assert diff[keep].max() <= 1e-4
    assert diff[~keep].max() <= 2e-3
    want, got = jax_ref[case + "_" + field], grads[field]
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-3 * scale, (
        np.abs(got - want).max(), scale)
    if field != "ri":  # no dielectric is hit at this size
        assert scale > 0


def test_scaled_gradient_reaches_every_field_and_matches_fd():
    """tests/test_scaled.py:129 on the port: reverse mode through the chunk
    traversal reaches every float field with finite values, the centres
    and albedos nonzero, and on the albedo entry with the largest gradient
    AD agrees with central differences (eps 1e-2) within 5e-2."""
    s = make_scaled_scene(**SCENE)
    cfg = RenderConfig(**CFG)

    def loss(scene):
        img, _ = cuda_scaled.render_frame_scaled(scene, cfg, 0, device="cpu",
                                                 differentiable=True)
        return img.mean()

    leaves = {f: getattr(s, f).clone().requires_grad_(True) for f in FIELDS}
    loss(s.replace(**leaves)).backward()
    for f, t in leaves.items():
        assert t.grad is not None and torch.isfinite(t.grad).all(), f
    assert (leaves["albedo"].grad != 0).any()
    assert (leaves["center"].grad != 0).any()
    ga = leaves["albedo"].grad.numpy()
    i, c = np.unravel_index(np.abs(ga).argmax(), ga.shape)
    eps = 1e-2

    def nudged(sign):
        alb = s.albedo.clone()
        alb[i, c] += sign * eps
        return float(loss(s.replace(albedo=alb)))

    fd = (nudged(+1) - nudged(-1)) / (2 * eps)
    assert abs(fd - ga[i, c]) / (abs(fd) + 1e-12) < 5e-2, (fd, ga[i, c])


def test_differentiable_route_contract():
    """render_frame_scaled(differentiable=True): ((H, W, 3) float32, 0-d
    int64 rays), the image and rays those of the forward render bit for
    bit (the lockstep primal is the render's function), with and without
    the soft estimator; a refreshed box (refresh_chunk_aabb) of a centre
    that requires grad carries none."""
    s = make_scaled_scene(n=800, chunk=128, extent=30.0)
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1, max_depth=2)
    want, want_rays = cuda_scaled.render_frame_scaled(s, cfg, 1,
                                                      device="cpu")
    for eps in (0.0, 0.05):
        center = s.center.clone().requires_grad_(True)
        moved = refresh_chunk_aabb(s.replace(center=center))
        assert not moved.chunk_aabb.requires_grad
        img, rays = cuda_scaled.render_frame_scaled(
            moved, cfg.replace(soft_silhouette_eps=eps), 1, device="cpu",
            differentiable=True)
        assert img.shape == (8, 16, 3) and img.dtype == torch.float32
        assert rays.dim() == 0 and rays.dtype == torch.int64
        assert torch.equal(img.detach(), want) and int(rays) == int(want_rays)
        img.sum().backward()
        assert torch.isfinite(center.grad).all() and center.grad.any()


def sil_setup():
    """tests/test_scaled.py:199's rays and scene (200 spheres, chunk 64)."""
    rng = np.random.default_rng(11)
    shape = (8, 16)
    ro = tuple(rng.uniform(-15, 15, shape).astype(np.float32)
               for _ in range(3))
    d = tuple(rng.normal(size=shape).astype(np.float32) for _ in range(3))
    norm = np.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2)
    return ro, tuple(x / norm for x in d)


def test_silhouette_chunks_matches_jax():
    """ChunkedScenePort.silhouette_chunks against the JAX package's on
    tests/test_scaled.py:199's setup (eps 0.05): d within rtol 1e-4, atol
    2e-3 on every lane (the winner's on a hit, the candidate's on a
    miss); on the miss lanes whose silhouette is gradient-visible (d >=
    -8 eps) the candidate on, its centre and radius equal; the band
    exercised."""
    eps = 0.05
    kw = dict(n=200, chunk=64, extent=20.0)
    port = ChunkedScenePort(make_scaled_scene(**kw))
    jport = jscaled.ChunkedScenePort(jscaled.make_scaled_scene(**kw))
    ro, rd = sil_setup()
    jro, jrd = tuple(map(jnp.asarray, ro)), tuple(map(jnp.asarray, rd))
    hit = jtc.hit_spheres(jport, jro, jrd, 1e-3, 1e7, want_material=False)
    hid = np.asarray(hit.hit_id)
    want = jport.silhouette_chunks(jro, jrd, 1e-3, hit.hit_id, eps)
    got = port.silhouette_chunks(tuple(map(torch.from_numpy, ro)),
                                 tuple(map(torch.from_numpy, rd)), 1e-3,
                                 torch.from_numpy(hid.copy()), eps)
    d = got.d.numpy()
    np.testing.assert_allclose(d, np.asarray(want.d), rtol=1e-4, atol=2e-3)
    band = (hid < 0) & (np.asarray(want.d) >= -8.0 * eps)
    assert band.any()
    assert got.cand_on.numpy()[band].all()
    assert np.asarray(want.cand_on)[band].all()
    cand = got.cand.numpy()[band]
    center = port.scene.center.numpy()
    np.testing.assert_array_equal(center[cand, 0], np.asarray(want.cx)[band])
    np.testing.assert_array_equal(port.scene.radius.numpy()[cand],
                                  np.asarray(want.radius)[band])


def test_lights_occlusion_proximity_matches_jax():
    """ChunkedScenePort.lights_occlusion_proximity against the JAX
    package's on tests/test_scaled.py:262's setup (3 lights, eps 1):
    within rtol 1e-4, atol 2e-3 on every lane whose occluder is in the
    gradient-visible band (d_occ >= -8, as that test), and the band
    exercised.  Elsewhere the port's value is no larger than JAX's and
    both lie below the band: the JAX scan gates a chunk for its batch of
    lanes together (a lax.cond on any lane), the port for each lane, so
    a lane there may take spheres the port prunes (measured: 12 of 384
    lanes, all below -8)."""
    kw = dict(n=200, chunk=64, extent=20.0)
    s = make_scaled_scene(**kw)
    port = ChunkedScenePort(s)
    jport = jscaled.ChunkedScenePort(jscaled.make_scaled_scene(**kw))
    rng = np.random.default_rng(3)
    shape = (8, 16)
    pos = tuple(rng.uniform(-15, 15, shape).astype(np.float32)
                for _ in range(3))
    jpos = tuple(map(jnp.asarray, pos))
    lids = list(s.emissive_ids[:3])
    dirs, t_ls = [], []
    for e in lids:
        sp = jport.sphere(e)
        to_l = (sp.cx - jpos[0], sp.cy - jpos[1], sp.cz - jpos[2])
        n = jnp.sqrt(to_l[0] ** 2 + to_l[1] ** 2 + to_l[2] ** 2)
        l = tuple(x / n for x in to_l)
        dirs.append(l)
        t_ls.append(jtc._sphere_t(sp, jpos, l, 1e-3, safe=False)[0])
    want = jport.lights_occlusion_proximity(jpos, dirs, lids, 1e-3, t_ls)
    got = port.lights_occlusion_proximity(
        tuple(map(torch.from_numpy, pos)),
        [tuple(torch.from_numpy(np.array(x)) for x in l) for l in dirs],
        lids, 1e-3, [torch.from_numpy(np.array(t)) for t in t_ls])
    in_band = 0
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        band = b >= -8.0
        np.testing.assert_allclose(a[band], b[band], rtol=1e-4, atol=2e-3)
        assert (a[~band] < -8.0).all()
        assert (a[~band] <= b[~band] + 2e-3 + 1e-4 * np.abs(b[~band])).all()
        in_band += int(band.sum())
    assert in_band > 0


def test_diff_wavefront_warns_on_every_gradient_route():
    """cfg.diff_wavefront: the gradient routes that run the lockstep form
    under it say so, as the JAX package does where it falls back
    (ops/tracecore.py:2554-2568): the scaled route (a chunked port) and
    K3's own forms (the in-kernel route); the flat route
    (render_frame_diff and the gradient it calls) takes the wavefront and
    does not warn (tests/test_torch_wavefront.py holds its values); the
    flag's validation stays JAX's (soft estimator with it: ValueError)."""
    cfg = RenderConfig(width=8, height=4, samples_per_pixel=1, max_depth=2,
                       diff_wavefront=True, merged_wavefront=True)
    scene = make_scene(big=False)
    leaves = {f: getattr(scene, f).clone().requires_grad_(True)
              for f in cuda_grad.PARAM_FIELDS}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        img, _ = cuda_grad.render_frame_diff(scene.replace(**leaves), cfg, 0,
                                             device="cpu")
        img.sum().backward()
    assert torch.isfinite(leaves["albedo"].grad).all()
    with pytest.warns(UserWarning, match="diff_wavefront ignored.*lockstep"):
        cuda_grad.render_tile_grad_form(scene, cfg, 0, torch.ones(4, 8, 3),
                                        0, 0, 4, 8, "warp")
    s = make_scaled_scene(n=800, chunk=128, extent=30.0)
    center = s.center.clone().requires_grad_(True)
    with pytest.warns(UserWarning, match="diff_wavefront ignored.*lockstep"):
        img, _ = cuda_scaled.render_frame_scaled(
            s.replace(center=center), cfg, 0, device="cpu",
            differentiable=True)
        img.sum().backward()
    assert torch.isfinite(center.grad).all()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cuda_scaled.render_frame_scaled(
            s, cfg.replace(diff_wavefront=False, merged_wavefront=False), 0,
            device="cpu", differentiable=True)
    with pytest.raises(ValueError, match="soft-silhouette"):
        RenderConfig(diff_wavefront=True, merged_wavefront=True,
                     soft_silhouette_eps=0.05)


def test_traversal_scans_count_their_tests():
    """The soft scans' work counters (tracecore.Work.silhouette_tests,
    proximity_tests), which give the chunked gradient kernel's bound, on
    the chunk traversal against the brute-force traversal of the same
    spheres: positive, and no more than the brute-force scans' (every
    sphere); the images equal."""
    s = make_scaled_scene(n=800, chunk=128, extent=30.0)
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1, max_depth=2,
                       soft_silhouette_eps=0.05)
    tab = cuda_scaled.pack_scene(s).requires_grad_(True)
    img, _, work = cuda_scaled.render_tile_scaled_plain(
        s, cfg, 0, 0, 0, 8, 16, with_work=True, tab=tab)
    yy, xx = torch.meshgrid(torch.arange(8), torch.arange(16), indexing="ij")
    col, brute = tc.render_pixels(
        tab, s.mat_ids().to(torch.int64), s.emissive_ids, cfg,
        camera_scalars(s, cfg), xx.reshape(-1), yy.reshape(-1), 0,
        soft_eps=cfg.soft_silhouette_eps)
    assert torch.equal(torch.stack(col, -1).reshape(8, 16, 3).detach(),
                       img.detach())
    for name in ("silhouette_tests", "proximity_tests"):
        got, full = getattr(work, name), getattr(brute, name)
        assert 0 < int(got.sum()) < int(full.sum()), name
        assert (got <= full).all(), name
