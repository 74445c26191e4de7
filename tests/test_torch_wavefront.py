"""The differentiable wavefront (cfg.diff_wavefront) in the port's plain
version, on the CPU: tracecore.render_pixels_wavefront, the schedule of
the JAX package's merged persistent wavefront
(tracecore.render_pixels_fused_merged), under autograd with each
iteration rematerialized, and the routes that take it.

Held:
  * the wavefront's image bit-equal to render_pixels' (lockstep) per
    pixel, its Work counters equal (no JAX): each lane runs the same ops
    on the same values;
  * at tests/test_diff_wavefront.py's CFG_WF (64x8, spp 2, depth 6, the
    big scene) against the JAX package's render_frame(...,
    differentiable=True) through its wavefront route: rays exact, the
    image within tests/test_torch_render.py's assert_render_close, and
    jax.grad of mean(img) per field within 5e-3 of the field's max |g|
    (the JAX test's gate between formulations: torch's and XLA's float32
    transcendentals differ in the last bits, and XLA contracts
    multiply-adds);
  * the albedo gradient against central finite differences at the JAX
    test's gate (5% + 1e-6);
  * no warning on the flat scene's routes under the flag, while the
    scaled scene's, the exact-shadow samplers' and K3's own forms (the
    in-kernel route) warn, as the JAX package does;
  * row bands over a RowMesh of repeated CPU devices within rtol 1e-4 of
    one device (the JAX test's contract).
The JAX values are computed once for the module, at a configuration the
JAX tests already compile.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toypathtracer_tpu import RenderConfig as JConfig
from toypathtracer_tpu import make_scene as j_make_scene
from toypathtracer_tpu.render.wavefront import render_frame as j_render_frame
from toypathtracer_torch import RenderConfig, make_scene
from toypathtracer_torch.inverse import (InverseRenderer,
                                         make_sharded_value_and_grad,
                                         render_loss)
from toypathtracer_torch.ops import cuda_grad, cuda_render, cuda_scaled
from toypathtracer_torch.ops import tracecore as tc
from toypathtracer_torch.parallel.mesh import make_mesh
from toypathtracer_torch.render.wavefront import camera_scalars
from toypathtracer_torch.scaled import make_scaled_scene
from toypathtracer_torch.scene import CameraSpec, scene_from_arrays

torch.set_num_threads(1)

FIELDS = cuda_grad.PARAM_FIELDS
WF = dict(width=64, height=8, samples_per_pixel=2, max_depth=6,
          merged_wavefront=True, diff_wavefront=True)
CFG_WF = RenderConfig(**WF)
FRAME = 1


def port_scene(j):
    """The port's Scene from a JAX Scene's arrays."""
    return scene_from_arrays(
        *(np.array(getattr(j, f)) for f in FIELDS),
        mat_type=j.mat_type, emissive_ids=j.emissive_ids,
        camera=CameraSpec(**dataclasses.asdict(j.camera)))


def lanes(cfg):
    yy, xx = torch.meshgrid(torch.arange(cfg.height),
                            torch.arange(cfg.width), indexing="ij")
    return xx.reshape(-1), yy.reshape(-1)


@pytest.mark.parametrize("big,frame,light_sampling", [
    (True, 3, True), (True, 0, False), (False, 5, True)])
def test_wavefront_bit_equal_to_lockstep(big, frame, light_sampling):
    """render_pixels_wavefront against render_pixels on the same lanes:
    the colour bit-equal per pixel and every Work counter equal, under
    autograd (each iteration through torch.utils.checkpoint) and not."""
    scene = make_scene(big=big)
    cfg = RenderConfig(width=32, height=8, samples_per_pixel=3, max_depth=5,
                       do_light_sampling=light_sampling)
    tab = cuda_render.pack_scene(scene)
    mat = torch.tensor(scene.mat_type, dtype=torch.int64)
    px, py = lanes(cfg)
    args = (mat, scene.emissive_ids, cfg, camera_scalars(scene, cfg), px, py,
            frame)
    col, work = tc.render_pixels(tab, *args)
    for t in (tab, tab.clone().requires_grad_(True)):
        got, got_work = tc.render_pixels_wavefront(t, *args)
        assert all(torch.equal(a.detach(), b) for a, b in zip(got, col))
        assert all(torch.equal(a, b) for a, b in zip(got_work, work))
    assert int(work.traced.sum()) > 0


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's wavefront route at CFG_WF, frame 1: the image, the rays and
    jax.grad of mean(img)."""
    jscene = j_make_scene(big=True)
    jcfg = JConfig(**WF)

    def loss(s):
        img, rays = j_render_frame(s, jcfg, jnp.int32(FRAME),
                                   differentiable=True)
        return jnp.mean(img), (img, rays)

    (_, (img, rays)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jscene)
    return (port_scene(jscene), np.asarray(img), int(rays),
            {f: np.asarray(getattr(g, f)) for f in FIELDS})


@pytest.fixture(scope="module")
def port_ref(jax_ref):
    """The port's differentiable render at CFG_WF, frame 1, on the CPU
    (ops/cuda_grad.render_frame_diff: the plain wavefront under
    autograd): the image, the rays and the gradient of mean(img)."""
    scene = jax_ref[0]
    leaves = {f: getattr(scene, f).clone().requires_grad_(True)
              for f in FIELDS}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        img, rays = cuda_grad.render_frame_diff(scene.replace(**leaves),
                                                CFG_WF, FRAME, device="cpu")
        img.mean().backward()
    return img.detach(), int(rays), {f: leaves[f].grad.numpy()
                                     for f in FIELDS}


def test_rays_and_image_match_jax(jax_ref, port_ref):
    _, jimg, jrays, _ = jax_ref
    img, rays, _ = port_ref
    assert rays == jrays
    img = img.numpy()
    assert img.shape == jimg.shape and np.isfinite(img).all()
    d = np.abs(img - jimg)
    assert (d.max(axis=-1) <= 1e-4).mean() >= 0.999
    assert d.mean() <= 5e-7


@pytest.mark.parametrize("field", FIELDS)
def test_grads_match_jax_grad(jax_ref, port_ref, field):
    want = jax_ref[3][field]
    got = port_ref[2][field]
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= 5e-3 * scale


def test_albedo_grad_matches_fd():
    """d mean(img) / d albedo[2, 0] through the wavefront route against
    central differences (eps 1e-3, frame 0), the JAX test's gate."""
    scene = port_scene(j_make_scene(big=True))
    albedo = scene.albedo.clone().requires_grad_(True)
    img, _ = cuda_grad.render_frame_diff(scene.replace(albedo=albedo),
                                         CFG_WF, 0, device="cpu")
    img.mean().backward()
    g_ad = float(albedo.grad[2, 0])

    def at(d):
        a = scene.albedo.clone()
        a[2, 0] += d
        return float(cuda_grad.render_frame_diff(scene.replace(albedo=a),
                                                 CFG_WF, 0,
                                                 device="cpu")[0].mean())
    g_fd = (at(1e-3) - at(-1e-3)) / 2e-3
    assert g_ad != 0.0
    assert abs(g_ad - g_fd) <= 0.05 * abs(g_fd) + 1e-6, (g_ad, g_fd)


def test_flat_routes_do_not_warn_and_fallbacks_do():
    """Under cfg.diff_wavefront the flat scene's differentiable routes
    (render_frame_diff, render_loss, InverseRenderer, the sharded step,
    render_tile_grad) run the wavefront with no warning; the routes the
    JAX package falls back on warn with its words: the scaled scene, the
    exact-shadow samplers (CPU_SAMPLERS) and K3's own forms."""
    cfg = RenderConfig(width=8, height=4, samples_per_pixel=1, max_depth=2,
                       merged_wavefront=True, diff_wavefront=True)
    scene = make_scene(big=False)
    target = torch.zeros((4, 8, 3))
    leaves = {f: getattr(scene, f).clone().requires_grad_(True)
              for f in FIELDS}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        loss = render_loss(scene.replace(**leaves), target, cfg, 0)
        loss.backward()
        fit = InverseRenderer(cfg, target, trainable=("albedo",),
                              device="cpu")
        _, losses = fit.fit(scene, 2)
        make_sharded_value_and_grad(cfg, make_mesh([torch.device("cpu")] * 2))(
            scene, target, 0)
        cuda_grad.render_tile_grad(scene, cfg, 0, torch.ones(4, 8, 3), 0, 0,
                                   4, 8)
    assert torch.isfinite(leaves["albedo"].grad).all() and len(losses) == 2
    match = "diff_wavefront ignored: exact-shadow samplers, chunked ports"
    s = make_scaled_scene(n=800, chunk=128, extent=30.0)
    with pytest.warns(UserWarning, match=match):
        cuda_scaled.render_frame_scaled(s, cfg, 0, device="cpu",
                                        differentiable=True)
    tab = cuda_render.pack_scene(scene).requires_grad_(True)
    px, py = lanes(cfg)
    with pytest.warns(UserWarning, match=match):
        col, _ = tc.render_pixels_diff(
            tab, torch.tensor(scene.mat_type), scene.emissive_ids, cfg,
            camera_scalars(scene, cfg), px, py, 0, samplers=tc.CPU_SAMPLERS)
    assert torch.isfinite(col[0]).all()
    with pytest.warns(UserWarning, match=match):
        cuda_grad.render_tile_grad_form(scene, cfg, 0, torch.ones(4, 8, 3),
                                        0, 0, 4, 8, "warp")


def test_sharded_bands_match_single_device():
    """make_sharded_value_and_grad under the flag on 4 bands of repeated
    CPU devices against render_loss on one device, at
    tests/test_diff_wavefront.py's sharded configuration (64x16, spp 1,
    depth 4, centres moved by 0.03): the loss within 1e-6, the gradients
    within rtol 1e-4 (atol 1e-7), the JAX test's contract."""
    cfg = RenderConfig(width=64, height=16, samples_per_pixel=1,
                       max_depth=4, merged_wavefront=True,
                       diff_wavefront=True)
    scene = make_scene(big=True)
    target, _ = cuda_render.render_frame(scene, cfg, 0, device="cpu")
    scene_p = scene.replace(center=scene.center + 0.03)
    fields = ("center", "radius", "albedo", "emissive")
    ln, gn = make_sharded_value_and_grad(
        cfg, make_mesh([torch.device("cpu")] * 4), fields=fields)(
            scene_p, target, 1)
    leaves = {f: getattr(scene_p, f).clone().requires_grad_(True)
              for f in fields}
    l1 = render_loss(scene_p.replace(**leaves), target, cfg, 1)
    g1 = torch.autograd.grad(l1, list(leaves.values()))
    np.testing.assert_allclose(float(ln), float(l1.detach()), rtol=1e-6)
    for f, g in zip(fields, g1):
        np.testing.assert_allclose(gn[f].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=f)
