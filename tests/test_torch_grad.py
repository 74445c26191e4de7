"""Gradients of the port's plain renderer (torch autograd through
render/wavefront.render_tile_plain, the gradient kernel's plain version)
against jax.grad of the JAX package's lockstep path
(render/wavefront.render_frame(..., differentiable=True)), on the CPU.

The loss is sum(img * w), w from np.random.RandomState(0), at the two
configurations of tests/test_pallas_grad.py's scale: the small scene at
16x8, spp 2, depth 3, and the big scene at 32x8, spp 2, depth 4.  The JAX
side runs the jnp route (12-18 s each, under 1 GB), never the
interpret-mode Pallas gradient kernel.

Tolerance: per field, max |diff| <= 1e-3 x the field's max |jax.grad|
(tests/test_pallas_grad.py's gate); measured at most 2.1e-4 (roughness;
float32 transcendentals of torch and XLA differ in the last bits and the
sphere-root and cone cancellations amplify them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toypathtracer_tpu import RenderConfig as JConfig
from toypathtracer_tpu import make_scene as j_make_scene
from toypathtracer_tpu.render.wavefront import render_frame as j_render_frame
from toypathtracer_torch import RenderConfig, make_scene
from toypathtracer_torch.inverse import InverseRenderer, render_loss
from toypathtracer_torch.ops import cuda_grad
from toypathtracer_torch.ops.tracecore import sqrt_pos
from toypathtracer_torch.render.wavefront import (render_tile_grad_plain,
                                                  render_tile_plain)

torch.set_num_threads(1)

FIELDS = ("center", "radius", "albedo", "emissive", "roughness", "ri")
CONFIGS = {"small": (False, dict(width=16, height=8, samples_per_pixel=2,
                                 max_depth=3)),
           "big": (True, dict(width=32, height=8, samples_per_pixel=2,
                              max_depth=4))}


def weights(kw):
    return np.random.RandomState(0).rand(kw["height"], kw["width"],
                                         3).astype(np.float32)


def torch_grads(scene, cfg, w, frame=0):
    leaves = {f: getattr(scene, f).clone().requires_grad_(True)
              for f in FIELDS}
    img, _ = render_tile_plain(scene.replace(**leaves), cfg, frame, 0, 0,
                               cfg.height, cfg.width)
    (img * torch.from_numpy(w)).sum().backward()
    return {f: leaves[f].grad.numpy() for f in FIELDS}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    big, kw = CONFIGS[request.param]
    w = weights(kw)

    def loss(s):
        img, _ = j_render_frame(s, JConfig(**kw), jnp.int32(0),
                                differentiable=True)
        return jnp.sum(img * w)
    jg = jax.grad(loss)(j_make_scene(big=big))
    ref = {f: np.asarray(getattr(jg, f)) for f in FIELDS}
    return make_scene(big=big), RenderConfig(**kw), w, ref


@pytest.mark.parametrize("field", FIELDS)
def test_plain_autograd_matches_jax_grad(case, field):
    scene, cfg, w, ref = case
    got = torch_grads(scene, cfg, w)[field]
    assert np.isfinite(got).all()
    scale = np.abs(ref[field]).max()
    assert scale > 0
    assert np.abs(got - ref[field]).max() <= 1e-3 * scale


@pytest.mark.parametrize("lockstep", [False, True])
def test_frame_diff_matches_jax_grad(case, lockstep):
    """The training step's route on the CPU: ops/cuda_grad's autograd
    Function (plain forward, plain-autograd backward) and the pack_scene
    pullback give the same gradients, with either primal."""
    scene, cfg, w, ref = case
    leaves = {f: getattr(scene, f).clone().requires_grad_(True)
              for f in FIELDS}
    img, _ = cuda_grad.render_frame_diff(scene.replace(**leaves), cfg, 0,
                                         lockstep_primal=lockstep,
                                         device="cpu")
    (img * torch.from_numpy(w)).sum().backward()
    for f in FIELDS:
        scale = np.abs(ref[f]).max()
        assert np.abs(leaves[f].grad.numpy() - ref[f]).max() <= 1e-3 * scale


def test_scene_cotangent_matches_jax_pullback():
    """scene_cotangent_from_packed against the JAX package's
    jax.vjp(pack_scene) on a random packed cotangent, with a zero and a
    negative radius (pack_scene maps 1/radius to 0 there)."""
    from toypathtracer_tpu.ops.pallas_grad import (
        scene_cotangent_from_packed as j_pullback)
    scene = make_scene(big=False)
    radius = scene.radius.clone()
    radius[3], radius[4] = 0.0, -0.5
    scene = scene.replace(radius=radius)
    jscene = j_make_scene(big=False)
    jscene = jscene.replace(radius=jnp.asarray(radius.numpy()))
    d = np.random.RandomState(5).randn(14, scene.n_spheres).astype(
        np.float32)
    got = cuda_grad.scene_cotangent_from_packed(scene, torch.from_numpy(d))
    want = j_pullback(jscene, jnp.asarray(d))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)


def test_bands_sum_to_the_frame():
    """The tile seam a multi-device step will shard: two row bands'
    gradients through render_tile_diff add up to the frame's."""
    scene = make_scene(big=True)
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1, max_depth=3)
    w = torch.from_numpy(np.random.RandomState(4).rand(8, 16, 3)
                         .astype(np.float32))

    def grads(tiles):
        alb = scene.albedo.clone().requires_grad_(True)
        s = scene.replace(albedo=alb)
        loss = sum((cuda_grad.render_tile_diff(s, cfg, 0, 0, y0, h, 16)[0]
                    * w[y0:y0 + h]).sum() for y0, h in tiles)
        loss.backward()
        return alb.grad
    whole, banded = grads([(0, 8)]), grads([(0, 3), (3, 5)])
    torch.testing.assert_close(banded, whole, rtol=1e-5, atol=1e-6)


def test_albedo_grad_matches_finite_differences():
    """Albedo scales radiance and moves no path, so the loss is smooth in
    it: central differences in float64 (h = 1e-2) match autograd within
    1e-3 relative (measured at most 2.9e-5)."""
    scene = make_scene(big=True)
    cfg = RenderConfig(width=32, height=16, samples_per_pixel=2, max_depth=4)
    w = np.random.RandomState(3).rand(16, 32, 3)
    g = torch_grads(scene, cfg, w.astype(np.float32))["albedo"]

    def loss(alb):
        img, _ = render_tile_plain(scene.replace(albedo=alb), cfg, 0, 0, 0,
                                   16, 32)
        return float((img.double() * torch.from_numpy(w)).sum())

    h = 1e-2
    for i, c in ((0, 0), (2, 1), (1, 2)):
        up, dn = scene.albedo.clone(), scene.albedo.clone()
        up[i, c] += h
        dn[i, c] -= h
        fd = (loss(up) - loss(dn)) / (2 * h)
        assert g[i, c] != 0
        assert abs(g[i, c] - fd) <= 1e-3 * abs(fd), (i, c, g[i, c], fd)


def test_gradients_finite_at_depth_10():
    """Every field's gradient stays finite over long paths, without light
    sampling too (sqrt_pos's double-where form; measured at 96x54 over
    three frames on both scenes)."""
    for big, kw in ((True, {}), (True, dict(do_light_sampling=False)),
                    (False, {})):
        cfg = RenderConfig(width=24, height=16, samples_per_pixel=1,
                           max_depth=10, **kw)
        w = np.random.RandomState(1).rand(16, 24, 3).astype(np.float32)
        grads = torch_grads(make_scene(big=big), cfg, w, frame=2)
        for f in FIELDS:
            assert np.isfinite(grads[f]).all(), (big, kw, f)


def test_sqrt_pos_gradient_is_finite_where_clamped():
    x = torch.tensor([-1.0, 0.0, 4.0], requires_grad=True)
    y = sqrt_pos(x)
    torch.where(x > 0, y, 0.0).sum().backward()
    assert y.tolist() == [0.0, 0.0, 2.0]
    assert x.grad.tolist() == [0.0, 0.0, 0.25]


SOFT_ROUTES = ("render_tile_grad", "render_tile_diff", "render_frame_diff",
               "render_loss", "inverse_renderer", "render_tile_plain")


@pytest.mark.parametrize("route", SOFT_ROUTES)
def test_soft_silhouette_on_every_gradient_route(route):
    """soft_silhouette_eps changes the gradient and not the image: every
    gradient route returns the soft-silhouette estimator's gradient, equal
    to the plain route's (render_tile_grad_plain through pack_scene's
    pullback) within 1e-6, and not the hard selects' (the center
    gradient moves), for the loss sum(img * g)."""
    scene = make_scene(big=False)
    cfg = RenderConfig(width=8, height=4, samples_per_pixel=1, max_depth=2,
                       soft_silhouette_eps=0.05)
    g = torch.from_numpy(np.random.RandomState(2).rand(4, 8, 3)
                         .astype(np.float32))

    def plain(c):
        _, _, d = render_tile_grad_plain(scene, c, 0, g, 0, 0, 4, 8)
        return d, cuda_grad.scene_cotangent_from_packed(scene, d)
    d_ref, ref = plain(cfg)
    _, hard = plain(cfg.replace(soft_silhouette_eps=0.0))
    assert (ref.center - hard.center).abs().max() > 1e-3

    def weighted(img, target):
        return (img * target).sum()
    leaves = {f: getattr(scene, f).clone().requires_grad_(True)
              for f in FIELDS}
    s = scene.replace(**leaves)
    if route == "render_tile_grad":
        img, _, d = cuda_grad.render_tile_grad(scene, cfg, 0, g, 0, 0, 4, 8)
        torch.testing.assert_close(d, d_ref, rtol=1e-6, atol=1e-6)
        got = cuda_grad.scene_cotangent_from_packed(scene, d)
        got = {f: getattr(got, f) for f in FIELDS}
    elif route == "inverse_renderer":
        inv = InverseRenderer(cfg, g, trainable=FIELDS, loss_fn=weighted,
                              device="cpu")
        _, got = inv.value_and_grad(scene, 0)
    else:
        if route == "render_tile_diff":
            img, _ = cuda_grad.render_tile_diff(s, cfg, 0, 0, 0, 4, 8)
            loss = weighted(img, g)
        elif route == "render_frame_diff":
            img, _ = cuda_grad.render_frame_diff(s, cfg, 0, device="cpu")
            loss = weighted(img, g)
        elif route == "render_loss":
            loss = render_loss(s, g, cfg, 0, loss_fn=weighted)
        else:
            img, _ = render_tile_plain(s, cfg, 0, 0, 0, 4, 8)
            loss = weighted(img, g)
        got = dict(zip(FIELDS, torch.autograd.grad(loss,
                                                   list(leaves.values()))))
    for f in FIELDS:
        torch.testing.assert_close(got[f], getattr(ref, f), rtol=1e-6,
                                   atol=1e-6, msg=f)
    # the forward render is the hard one's
    img, _ = render_tile_plain(s, cfg, 0, 0, 0, 4, 8)
    ref_img, _ = render_tile_plain(scene, cfg, 0, 0, 0, 4, 8)
    assert torch.equal(img.detach(), ref_img)
