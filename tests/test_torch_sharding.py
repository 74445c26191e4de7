"""The port's row-sharded rendering and training (toypathtracer_torch/
parallel/mesh.py, ops/cuda_scaled.render_frame_scaled_sharded,
inverse.make_sharded_value_and_grad, InverseRenderer(mesh=...), the CLI's
--backend sharded) on the CPU, against the port's single-device routes
and the JAX package's sharded ones.

The port's bands are 8 CPU devices, make_mesh([cpu] * 8); the JAX mesh is
conftest's 8 virtual CPU devices.  Scenes cross over as numpy arrays
(scene.scene_from_arrays).  Gates:
  - sharded frames (flat and scaled) equal the single-device frame bit
    for bit, rays exact: per-pixel seeds depend only on the global pixel;
  - against JAX's sharded frame, tests/test_torch_render.py's
    assert_render_close (the gate the port's render meets against JAX);
  - sharded gradients against the port's single device, JAX's contract
    for sharded against single-device gradients (tests/test_sharding.py:
    rtol 1e-6, atol 1e-9 + 1e-7 max|g|; the loss within 1e-5), since
    only the order of the sums differs;
  - against JAX's sharded jnp gradient, tests/test_torch_grad.py's gate:
    max |diff| <= 1e-3 x max |g| per field.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_render import assert_render_close
from toypathtracer_tpu import RenderConfig as JConfig
from toypathtracer_tpu import make_scene as j_make_scene
from toypathtracer_tpu import scaled as jscaled
from toypathtracer_tpu.inverse import \
    make_sharded_value_and_grad as j_make_sharded_value_and_grad
from toypathtracer_tpu.parallel.mesh import make_mesh as j_make_mesh
from toypathtracer_tpu.parallel.mesh import render_frame_sharded_jit
from toypathtracer_torch import RenderConfig, make_scaled_scene
from toypathtracer_torch.cli import main as cli_main
from toypathtracer_torch.inverse import (InverseRenderer, image_l2,
                                         image_l2_tonemapped,
                                         make_sharded_value_and_grad,
                                         multiview_render_loss, render_loss)
from toypathtracer_torch.ops import cuda_render, cuda_scaled
from toypathtracer_torch.ops.cuda_grad import PARAM_FIELDS
from toypathtracer_torch.parallel.mesh import make_mesh, render_frame_sharded
from toypathtracer_torch.scaled import scaled_scene_from_arrays
from toypathtracer_torch.scene import CameraSpec, scene_from_arrays

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
# tests/test_sharding.py's configurations: the frame (:18), the scaled
# frame (:118) and the gradients (:140, cameras :172).
CFG = dict(width=128, height=16, samples_per_pixel=2, max_depth=6)
SCALED = dict(width=64, height=16, samples_per_pixel=1, max_depth=3)
GRAD = dict(width=32, height=16, samples_per_pixel=1, max_depth=2)
CAMS = (dict(look_from=(0.0, 2.0, 3.0), aperture=0.0),
        dict(look_from=(3.0, 2.0, 0.0), aperture=0.0))


def port_scene(j):
    """The port's Scene from a JAX Scene's arrays."""
    return scene_from_arrays(
        *(np.array(getattr(j, f)) for f in PARAM_FIELDS),
        mat_type=j.mat_type, emissive_ids=j.emissive_ids,
        camera=CameraSpec(**dataclasses.asdict(j.camera)))


def port_scaled_scene(j):
    return scaled_scene_from_arrays(
        **{f: np.array(getattr(j, f)) for f in (
            *PARAM_FIELDS, "mat_is_lam", "mat_is_met", "mat_is_die",
            "chunk_aabb")},
        chunk=j.chunk, n_real=j.n_real, emissive_ids=j.emissive_ids,
        camera=CameraSpec(**dataclasses.asdict(j.camera)))


@pytest.fixture(scope="module")
def big():
    j = j_make_scene(big=True)
    return port_scene(j), j


@pytest.fixture(scope="module")
def small():
    return port_scene(j_make_scene(big=False))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(CPU8)


def test_sharded_frame_is_bit_equal_to_single_device(big, mesh):
    scene, _ = big
    cfg = RenderConfig(**CFG)
    img, rays = render_frame_sharded(scene, cfg, 1, mesh)
    want, want_rays = cuda_render.render_frame(scene, cfg, 1, device="cpu")
    assert img.shape == (16, 128, 3) and rays.dtype == torch.int64
    assert torch.equal(img, want) and int(rays) == int(want_rays)


def test_sharded_frame_matches_jax_sharded(big, mesh):
    """Against render_frame_sharded_jit on the 8-device JAX mesh: rays
    exact, pixels to assert_render_close."""
    scene, jscene = big
    img, rays = render_frame_sharded(scene, RenderConfig(**CFG), 1, mesh)
    jimg, jrays = render_frame_sharded_jit(jscene, JConfig(**CFG),
                                           jnp.int32(1), j_make_mesh())
    assert int(rays) == int(jrays)
    assert_render_close(img, rays, jimg, jrays)


def test_indivisible_height_and_missing_card_raise(big, mesh):
    scene, _ = big
    with pytest.raises(ValueError, match="divide"):
        render_frame_sharded(scene, RenderConfig(width=128, height=12,
                                                 samples_per_pixel=1), 0,
                             mesh)
    with pytest.raises(ValueError, match="divide"):
        make_sharded_value_and_grad(RenderConfig(width=8, height=12), mesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()


def test_sharded_scaled_frame_is_bit_equal_to_single_device(mesh):
    scene = port_scaled_scene(jscaled.make_scaled_scene(n=2000, chunk=64,
                                                        extent=40.0))
    assert torch.equal(scene.center,
                       make_scaled_scene(n=2000, chunk=64,
                                         extent=40.0).center)
    cfg = RenderConfig(**SCALED)
    img, rays = cuda_scaled.render_frame_scaled_sharded(scene, cfg, 0, mesh)
    want, want_rays = cuda_scaled.render_frame_scaled(scene, cfg, 0,
                                                      device="cpu")
    assert img.shape == (16, 64, 3) and torch.isfinite(img).all()
    assert torch.equal(img, want) and int(rays) == int(want_rays)
    # pallas / interpret never change the image
    again, _ = cuda_scaled.render_frame_scaled_sharded(
        scene, cfg, 0, mesh, pallas=True, interpret=True)
    assert torch.equal(again, want)


def sharded_and_single(scene, cfg, mesh, cameras=None):
    """(loss, grads) of make_sharded_value_and_grad and of the port's
    single-device render_loss / multiview_render_loss with autograd, at a
    zero target and frame 0."""
    H, W = cfg.height, cfg.width
    target = torch.zeros((H, W, 3) if cameras is None
                         else (len(cameras), H, W, 3))
    ln, gn = make_sharded_value_and_grad(cfg, mesh, cameras)(scene, target,
                                                             0)
    leaves = {f: getattr(scene, f).clone().requires_grad_(True)
              for f in PARAM_FIELDS}
    s = scene.replace(**leaves)
    l1 = render_loss(s, target, cfg, 0) if cameras is None else \
        multiview_render_loss(s, cameras, target, cfg, 0)
    g1 = torch.autograd.grad(l1, list(leaves.values()))
    return ln, gn, l1.detach(), dict(zip(PARAM_FIELDS, g1))


@pytest.mark.parametrize("case", ["hard", "soft", "cameras"])
def test_sharded_grads_match_single_device(small, mesh, case):
    """8 bands against the single device at JAX's contract; one band's
    gradients bit for bit, so what differs is the order of the sums.  At
    eps 0.05 the soft terms cancel across pixels, and the 8 bands' order
    puts the centre gradient 4.2e-7 x its field's max from the single
    device's (measured): that case is held at 1e-6 x max |g| in place of
    1e-7."""
    cfg = RenderConfig(**GRAD, soft_silhouette_eps=0.05 if case == "soft"
                       else 0.0)
    cams = tuple(CameraSpec(**c) for c in CAMS) if case == "cameras" \
        else None
    ln, gn, l1, g1 = sharded_and_single(small, cfg, mesh, cams)
    assert abs(float(l1) - float(ln)) < 1e-5 * max(1.0, abs(float(l1)))
    assert float(ln) > 0 and float(g1["albedo"].abs().max()) > 0
    scale = 1e-6 if case == "soft" else 1e-7
    for f in PARAM_FIELDS:
        a, b = g1[f].numpy(), gn[f].numpy()
        np.testing.assert_allclose(b, a, rtol=1e-6,
                                   atol=1e-9 + scale * np.abs(a).max(),
                                   err_msg=f)
    l_one, g_one, _, _ = sharded_and_single(
        small, cfg, make_mesh([torch.device("cpu")]), cams)
    # the views' losses: a sum over views / (V H W 3) against the mean
    # of each view's mean
    assert abs(float(l_one) - float(l1)) <= 1e-6 * abs(float(l1))
    assert all(torch.equal(g_one[f], g1[f]) for f in PARAM_FIELDS)


def test_sharded_grads_match_jax_sharded_jnp(big, mesh):
    """make_sharded_value_and_grad against the JAX package's, jnp
    backend, on the 8-device JAX mesh, at tests/test_torch_grad.py's "big"
    configuration (32x8, spp 2, depth 4): one row a band."""
    scene, jscene = big
    kw = dict(width=32, height=8, samples_per_pixel=2, max_depth=4)
    target = np.zeros((8, 32, 3), np.float32)
    ln, gn = make_sharded_value_and_grad(RenderConfig(**kw), mesh)(
        scene, torch.from_numpy(target), 0)
    jl, jg = jax.jit(j_make_sharded_value_and_grad(JConfig(**kw),
                                                   j_make_mesh()))(
        jscene, jnp.asarray(target), jnp.int32(0))
    assert abs(float(ln) - float(jl)) <= 1e-4 * abs(float(jl))
    for f in PARAM_FIELDS:
        want = np.asarray(getattr(jg, f))
        scale = np.abs(want).max()
        assert scale > 0, f
        assert np.abs(gn[f].numpy() - want).max() <= 1e-3 * scale, f


def test_inverse_renderer_with_mesh_matches_single_device(small, mesh):
    """Three Adam steps on the 8-band mesh against the single-device
    renderer: losses and parameters at the sharded-gradient tolerance."""
    cfg = RenderConfig(**GRAD)
    target, _ = cuda_render.render_frame(small, cfg, 0, device="cpu")
    alb = small.albedo.clone()
    alb[0] = torch.tensor([0.2, 0.9, 0.9])
    start = small.replace(albedo=alb, center=small.center + 0.01)
    fits = [InverseRenderer(cfg, target, trainable=("center", "albedo"),
                            learning_rate=5e-3, mesh=m, device="cpu").fit(
        start, steps=3, resample=False) for m in (None, mesh)]
    (one, l1), (sharded, ln) = fits
    np.testing.assert_allclose(ln, l1, rtol=1e-5)
    assert l1[-1] < l1[0]
    for f in ("center", "albedo"):
        a, b = getattr(one, f).numpy(), getattr(sharded, f).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-6,
                                   atol=1e-9 + 1e-7 * np.abs(a).max(),
                                   err_msg=f)


@pytest.mark.parametrize("kw", [dict(loss_fn=image_l2_tonemapped),
                                dict(lockstep_primal=True)],
                         ids=["loss_fn", "lockstep_primal"])
def test_inverse_renderer_with_mesh_refuses(mesh, kw):
    """JAX's own refusals (toypathtracer_tpu/inverse.py:321-331)."""
    with pytest.raises(ValueError):
        InverseRenderer(RenderConfig(width=8, height=8),
                        torch.zeros(8, 8, 3), mesh=mesh, **kw)
    InverseRenderer(RenderConfig(width=8, height=8), torch.zeros(8, 8, 3),
                    mesh=mesh, loss_fn=image_l2)


def test_cli_sharded_backend(tmp_path, capsys):
    from PIL import Image
    args = ["--device", "cpu", "--width", "32", "--height", "16", "--spp",
            "1", "--max-depth", "3", "--frames", "2"]
    outs = {}
    for backend in ("auto", "sharded"):
        out = tmp_path / f"{backend}.png"
        assert cli_main(args + ["--backend", backend, "--output",
                                str(out)]) == 0
        first = capsys.readouterr().out.splitlines()[0]
        tag = "sharded x1" if backend == "sharded" else "auto"
        assert first.startswith(f"backend={tag} ")
        with Image.open(out) as im:
            outs[backend] = np.asarray(im)
    np.testing.assert_array_equal(outs["sharded"], outs["auto"])
    with pytest.raises(SystemExit):
        cli_main(["--scaled", "800", "--backend", "sharded", "--device",
                  "cpu"])
