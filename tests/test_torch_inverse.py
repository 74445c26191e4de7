"""The port's inverse rendering (toypathtracer_torch/inverse.py) on the
CPU: its Adam step against optax on identical gradients, its losses
against the JAX package's, and the albedo recovery contract of
tests/test_grad.py::test_inverse_rendering_recovers_albedo.
"""

import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from toypathtracer_tpu import inverse as j_inverse
from toypathtracer_torch import RenderConfig, make_scene
from toypathtracer_torch.inverse import (InverseRenderer, adam_update,
                                         image_l2, image_l2_tonemapped,
                                         multiview_render_loss, render_loss,
                                         scene_grad_mask)
from toypathtracer_torch.ops import cuda_render
from toypathtracer_torch.scene import CameraSpec

torch.set_num_threads(1)


@pytest.mark.parametrize("clip_norm", [None, 1.0, 100.0])
def test_adam_matches_optax(clip_norm):
    """Three steps of the port's update and of optax.chain(
    clip_by_global_norm, adam) on the same gradients: parameters within
    1e-6 (measured at most 2.4e-7, two float32 ulps).  clip 1.0 clips
    every step, 100 none."""
    rng = np.random.RandomState(0)
    p0 = {"albedo": rng.rand(9, 3).astype(np.float32),
          "radius": rng.rand(9).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    lr, eps = 2e-2, 1e-3
    adam = optax.adam(lr, eps=eps)
    opt = adam if clip_norm is None else optax.chain(
        optax.clip_by_global_norm(clip_norm), adam)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = opt.init(jp)
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    tstate = {}
    for g in grads:
        upd, jstate = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tp, tstate = adam_update(tp, {k: torch.from_numpy(v)
                                      for k, v in g.items()},
                                 tstate, lr, eps, clip_norm)
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=0)


def test_losses_match_jax():
    rng = np.random.RandomState(1)
    a = rng.rand(4, 8, 3).astype(np.float32) * 5
    b = rng.rand(4, 8, 3).astype(np.float32) * 5
    for ours, theirs in ((image_l2, j_inverse.image_l2),
                         (image_l2_tonemapped, j_inverse.image_l2_tonemapped)):
        got = float(ours(torch.from_numpy(a), torch.from_numpy(b)))
        want = float(theirs(jnp.asarray(a), jnp.asarray(b)))
        assert got == pytest.approx(want, rel=1e-6)


def test_scene_grad_mask():
    scene = make_scene(big=True)
    mask = scene_grad_mask(scene, ("albedo",))
    assert float(mask.albedo.min()) == 1.0
    assert float(mask.center.max()) == 0.0
    with pytest.raises(ValueError):
        scene_grad_mask(scene, ("nope",))
    with pytest.raises(ValueError):
        InverseRenderer(RenderConfig(width=8, height=4), torch.zeros(4, 8, 3),
                        trainable=("nope",), device="cpu")


def test_inverse_renderer_recovers_albedo():
    """tests/test_grad.py's contract at its size (64x16, spp 2, depth 4):
    perturb the floor sphere's albedo, 25 deterministic Adam steps bring
    the loss below 0.3x and the albedo error below 0.5x.  Measured: loss
    6.7e-3 -> 2.0e-4, albedo error 0.267 -> 0.039."""
    scene = make_scene(big=False)
    cfg = RenderConfig(width=64, height=16, samples_per_pixel=2, max_depth=4)
    target, _ = cuda_render.render_frame(scene, cfg, 0, device="cpu")
    alb = scene.albedo.clone()
    alb[0] = torch.tensor([0.2, 0.9, 0.9])
    start = scene.replace(albedo=alb)
    inv = InverseRenderer(cfg, target, trainable=("albedo",),
                          learning_rate=5e-2, device="cpu")
    fitted, losses = inv.fit(start, steps=25, resample=False)
    assert losses[-1] < losses[0] * 0.3, losses
    err0 = float((start.albedo[0] - scene.albedo[0]).abs().mean())
    err1 = float((fitted.albedo[0] - scene.albedo[0]).abs().mean())
    assert err1 < err0 * 0.5, (err0, err1)
    # only the trainable field moved
    assert torch.equal(fitted.center, scene.center)


def test_multiview_loss_is_the_mean_of_the_views():
    scene = make_scene(big=False)
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1, max_depth=3)
    cams = (scene.camera, CameraSpec(look_from=(1.0, 2.0, 3.0)))
    targets = torch.stack([
        cuda_render.render_frame(scene.replace(camera=c), cfg, 0,
                                 device="cpu")[0] * 0.9 for c in cams])
    got = multiview_render_loss(scene, cams, targets, cfg, 0)
    want = sum(render_loss(scene.replace(camera=c), t, cfg, 0)
               for c, t in zip(cams, targets)) / 2
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert float(got) > 0


def test_mesh_and_missing_card_raise():
    """A mesh trains image_l2 only and raises JAX's ValueError
    (toypathtracer_tpu/inverse.py:322) for another loss; "cuda" without a
    card raises."""
    from toypathtracer_torch.parallel.mesh import make_mesh
    cfg = RenderConfig(width=8, height=4)
    target = torch.zeros(4, 8, 3)
    with pytest.raises(ValueError, match="image_l2"):
        InverseRenderer(cfg, target, mesh=make_mesh([torch.device("cpu")]),
                        loss_fn=image_l2_tonemapped)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            InverseRenderer(cfg, target)


def test_demo_inverse_geometry_with_soft_eps(tmp_path, capsys):
    """demo_inverse's geometry recipe on the CPU at a toy size: --soft-eps
    0.05 with --tonemap-loss trains centers and albedo, prints its JSON
    line, and the loss falls."""
    from toypathtracer_torch import demo_inverse
    assert demo_inverse.main([
        "--device", "cpu", "--width", "32", "--height", "18", "--steps",
        "4", "--soft-eps", "0.05", "--tonemap-loss", "--trainable",
        "center,albedo", "--center-jitter", "0.05", "--outdir",
        str(tmp_path)]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["device"] == "cpu" and res["steps"] == 4
    assert np.isfinite(res["center_maxerr_final"])
    assert res["loss_final"] < res["loss_initial"]
