"""The soft-silhouette gradient estimator of the port's plain version
(ops/tracecore.bounce and nee_light_e with soft_eps > 0, autograd through
render/wavefront.render_tile_plain) against jax.grad of the JAX package's
lockstep route (render_frame(..., differentiable=True) with
RenderConfig.soft_silhouette_eps > 0), on the CPU.

The JAX side runs in a child process whose XLA may not contract a
product and a sum into one fused multiply-add (XLA_FLAGS=
--xla_cpu_max_isa=AVX; tests/torch_jax_rounding.py measures the
contraction), so that both sides round every product and sum on their
own, as the port's plain version and kernels do.  The sigmoids' 1/eps
(50 at eps 0.02) amplifies last-bit differences near the silhouettes:
with contraction the roughness field parts by 1.17e-3 of its max (the
float64 evaluation of the same paths lies between the two float32 ones);
without it, by 7.9e-4.

Tolerances: per field, max |diff| <= 1e-3 x the field's max |jax.grad|
(tests/test_pallas_grad.py's gate), at that file's soft configuration
(the small scene, 16x8, spp 2, depth 3, eps 0.02, the RandomState(0)
cotangent); measured at most 7.9e-4 (roughness), the others at most
6.9e-5.  The one-sphere scene of tests/test_soft_silhouette.py (64x40,
spp 2, depth 2, eps 0.05): d(loss)/d(center) within 1e-3 of JAX's.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from toypathtracer_torch import RenderConfig, make_scene
from toypathtracer_torch.inverse import InverseRenderer, image_l2
from toypathtracer_torch.ops import tracecore as tc
from toypathtracer_torch.ops.cuda_render import pack_scene
from toypathtracer_torch.render.wavefront import (camera_scalars,
                                                  render_tile_grad_plain,
                                                  render_tile_plain)
from toypathtracer_torch.scaled import (ChunkedScenePort, ChunkTraversal,
                                        make_scaled_scene, pack_chunks)
from toypathtracer_torch.scene import MAT_LAMBERT, CameraSpec, \
    scene_from_arrays
from toypathtracer_torch.tools.scenes import shadow_boundary_scene

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("center", "radius", "albedo", "emissive", "roughness", "ri")
SMALL = dict(width=16, height=8, samples_per_pixel=2, max_depth=3,
             soft_silhouette_eps=0.02)
ONE = dict(width=64, height=40, samples_per_pixel=2, max_depth=2,
           soft_silhouette_eps=0.05)

# The JAX references, written to the .npz named by argv[1].
JAX_REFERENCE = r"""
import sys

import jax
import jax.numpy as jnp
import numpy as np

from toypathtracer_tpu import RenderConfig, make_scene
from toypathtracer_tpu.inverse import image_l2
from toypathtracer_tpu.render.wavefront import render_frame
from toypathtracer_tpu.scene import MAT_LAMBERT, CameraSpec, Scene

small, one = eval(sys.argv[2]), eval(sys.argv[3])
out = {}
cfg = RenderConfig(**small)
w = np.random.RandomState(0).rand(cfg.height, cfg.width, 3).astype(np.float32)


def loss(s):
    img, _ = render_frame(s, cfg, jnp.int32(0), differentiable=True)
    return jnp.sum(img * w)


g = jax.grad(loss)(make_scene(big=False))
for f in ("center", "radius", "albedo", "emissive", "roughness", "ri"):
    out["small_" + f] = np.asarray(getattr(g, f))


def one_sphere(cx):
    return Scene(
        center=jnp.array([[cx, 0.0, 0.0]], jnp.float32),
        radius=jnp.array([0.6], jnp.float32),
        albedo=jnp.array([[0.8, 0.3, 0.2]], jnp.float32),
        emissive=jnp.zeros((1, 3), jnp.float32),
        roughness=jnp.zeros((1,), jnp.float32),
        ri=jnp.zeros((1,), jnp.float32), mat_type=(MAT_LAMBERT,),
        emissive_ids=(),
        camera=CameraSpec(look_from=(0.0, 0.0, 3.0), look_at=(0.0, 0.0, 0.0),
                          aperture=0.0))


cfg1 = RenderConfig(**one)
target, _ = render_frame(one_sphere(0.0), cfg1, jnp.int32(0),
                         differentiable=True)


def loss1(c):
    img, _ = render_frame(one_sphere(0.0).replace(center=c), cfg1,
                          jnp.int32(0), differentiable=True)
    return image_l2(img, target)


out["one_center"] = np.asarray(jax.grad(loss1)(
    jnp.array([[0.15, 0.0, 0.0]], jnp.float32)))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("soft_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)).rstrip(os.pathsep))
    subprocess.run([sys.executable, "-c", JAX_REFERENCE, str(path),
                    repr(SMALL), repr(ONE)], check=True, env=env, cwd=ROOT,
                   timeout=600)
    with np.load(path) as d:
        return dict(d)


def field_grads(scene, cfg, w):
    """d(sum(img * w))/d(scene fields) by autograd through the plain
    render."""
    leaves = {f: getattr(scene, f).clone().requires_grad_(True)
              for f in FIELDS}
    img, _ = render_tile_plain(scene.replace(**leaves), cfg, 0, 0, 0,
                               cfg.height, cfg.width)
    (img * torch.as_tensor(w)).sum().backward()
    return {f: leaves[f].grad.numpy() for f in FIELDS}


@pytest.fixture(scope="module")
def small_grads():
    cfg = RenderConfig(**SMALL)
    w = np.random.RandomState(0).rand(cfg.height, cfg.width,
                                      3).astype(np.float32)
    scene = make_scene(big=False)
    return (field_grads(scene, cfg, w),
            field_grads(scene, cfg.replace(soft_silhouette_eps=0.0), w))


@pytest.mark.parametrize("field", FIELDS)
def test_plain_soft_gradient_matches_jax_grad(jax_ref, small_grads, field):
    got = small_grads[0][field]
    want = jax_ref["small_" + field]
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= 1e-3 * scale, (
        np.abs(got - want).max() / scale)


def test_soft_estimator_fires(small_grads):
    """The center and radius gradients differ from the hard selects'
    (tests/test_pallas_grad.py's check that the estimator fires); the
    albedo and emission gradients, which move no silhouette, do not."""
    soft, hard = small_grads
    for f in ("center", "radius"):
        assert np.abs(soft[f] - hard[f]).max() > 1e-2 * np.abs(hard[f]).max()
    for f in ("albedo", "emissive"):
        np.testing.assert_array_equal(soft[f], hard[f])


@pytest.mark.parametrize("which", ["small", "shadow_boundary"])
def test_forward_image_bit_equal_under_grad(which):
    """With eps > 0 and the table requiring grad (the soft terms in the
    graph) the image and rays equal eps 0's bit for bit, as does the value
    render_tile_grad_plain returns."""
    scene = make_scene(big=False) if which == "small" \
        else shadow_boundary_scene()
    cfg = RenderConfig(width=32, height=16, samples_per_pixel=2, max_depth=4,
                       soft_silhouette_eps=0.05)
    ref, ref_rays = render_tile_plain(scene, cfg.replace(
        soft_silhouette_eps=0.0), 1, 0, 0, 16, 32)
    leaves = scene.replace(center=scene.center.clone().requires_grad_(True))
    img, rays = render_tile_plain(leaves, cfg, 1, 0, 0, 16, 32)
    assert img.requires_grad
    assert torch.equal(img.detach(), ref) and int(rays) == int(ref_rays)
    g_img, g_rays, _ = render_tile_grad_plain(scene, cfg, 1,
                                              torch.ones(16, 32, 3), 0, 0,
                                              16, 32)
    assert torch.equal(g_img, ref) and int(g_rays) == int(ref_rays)


def one_sphere_scene(cx: float):
    return scene_from_arrays(
        center=[[cx, 0.0, 0.0]], radius=[0.6], albedo=[[0.8, 0.3, 0.2]],
        emissive=np.zeros((1, 3)), roughness=[0.0], ri=[0.0],
        mat_type=(MAT_LAMBERT,), emissive_ids=(),
        camera=CameraSpec(look_from=(0.0, 0.0, 3.0), look_at=(0.0, 0.0, 0.0),
                          aperture=0.0))


@pytest.fixture(scope="module")
def one_target():
    img, _ = render_tile_plain(one_sphere_scene(0.0), RenderConfig(**ONE), 0,
                               0, 0, ONE["height"], ONE["width"])
    return img


def one_center_grad(cfg, target, cx=0.15):
    center = torch.tensor([[cx, 0.0, 0.0]], requires_grad=True)
    scene = one_sphere_scene(0.0).replace(center=center)
    img, _ = render_tile_plain(scene, cfg, 0, 0, 0, cfg.height, cfg.width)
    image_l2(img, target).backward()
    return center.grad.numpy()


def test_one_sphere_gradient_matches_jax_and_points_home(jax_ref,
                                                         one_target):
    """tests/test_soft_silhouette.py's controlled setup: one Lambert
    sphere shifted +x.  The soft d(loss)/d(center) matches JAX's within
    1e-3 of its largest component, points home (+x), and its x component
    exceeds 3x the hard estimator's."""
    cfg = RenderConfig(**ONE)
    soft = one_center_grad(cfg, one_target)
    hard = one_center_grad(cfg.replace(soft_silhouette_eps=0.0), one_target)
    want = jax_ref["one_center"]
    assert np.abs(soft - want).max() <= 1e-3 * np.abs(want).max()
    assert soft[0, 0] > 0.0
    assert abs(soft[0, 0]) > 3.0 * abs(hard[0, 0])


def test_inverse_renderer_recovers_center_soft_not_hard(one_target):
    """tests/test_soft_silhouette.py::test_soft_recovers_center_hard_does_not
    on the port: InverseRenderer(device="cpu"), Adam lr 5e-3, 60 steps from
    cx = 0.15 on a fixed sample set."""
    start = one_sphere_scene(0.15)
    fits = {}
    for eps in (0.05, 0.0):
        inv = InverseRenderer(RenderConfig(**{**ONE,
                                              "soft_silhouette_eps": eps}),
                              one_target, trainable=("center",),
                              learning_rate=5e-3, device="cpu")
        fitted, losses = inv.fit(start, steps=60, resample=False)
        fits[eps] = (abs(float(fitted.center[0, 0])), losses)
    err_soft, losses_soft = fits[0.05]
    assert err_soft < 0.5 * 0.15, err_soft
    assert losses_soft[-1] < 0.5 * losses_soft[0]
    assert err_soft < fits[0.0][0]


def test_scaled_and_diff_wavefront_routes_raise():
    """The one refusal is the JAX package's own rule: the differentiable
    wavefront has no soft estimator (RenderConfig raises).  The scaled
    scene's soft routes compute: ChunkedScenePort's silhouette and
    shadow-boundary chunk scans answer on lane planes, and a soft render
    over ChunkTraversal gives the hard render's image
    (tests/test_torch_scaled_grad.py holds their values against the JAX
    package's)."""
    scene = make_scaled_scene(800)
    port = ChunkedScenePort(scene)
    ro = (torch.zeros(2, 3), torch.full((2, 3), 8.0), torch.full((2, 3), 30.0))
    rd = (torch.zeros(2, 3), torch.full((2, 3), -0.26), torch.full((2, 3),
                                                                   -0.97))
    hit = torch.full((2, 3), -1, dtype=torch.int32)
    q = port.silhouette_chunks(ro, rd, 1e-3, hit, 0.05)
    assert q.d.shape == (2, 3) and torch.isfinite(q.d).all()
    t_l = torch.full((2, 3), 40.0)
    d_occ = port.lights_occlusion_proximity(ro, [rd], [0], 1e-3, [t_l])
    assert len(d_occ) == 1 and d_occ[0].shape == (2, 3)
    cfg = RenderConfig(width=4, height=2, samples_per_pixel=1, max_depth=2)
    px = torch.arange(8) % 4
    py = torch.arange(8) // 4
    tab = pack_scene(scene).requires_grad_(True)
    cols = [tc.render_pixels(tab, scene.mat_ids().to(torch.int64),
                             scene.emissive_ids, cfg,
                             camera_scalars(scene, cfg), px, py, 0,
                             traversal=ChunkTraversal(pack_chunks(scene),
                                                      scene.chunk, tab=tab),
                             soft_eps=eps)[0] for eps in (0.05, 0.0)]
    assert all(torch.equal(a, b) for a, b in zip(*cols))
    with pytest.raises(ValueError, match="soft-silhouette"):
        RenderConfig(diff_wavefront=True, merged_wavefront=True,
                     soft_silhouette_eps=0.05)
