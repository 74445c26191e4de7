"""The CUDA kernels on the card, against their plain PyTorch versions.

Marked `cuda`: these skip without a CUDA device.  On the H100 run them
without the JAX-side conftest (the card's machine has no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the gates of chip_smoke.py.  Render kernel: rays 5e-4
relative, mean |diff| 1e-3; measured on an H100 at 320x176: rays exact,
max |diff| 1.9e-6.  Gradient kernel: rays exact, d_packed per row within
1e-3 x the row's max |plain autograd|; measured on an H100 at 320x176:
at most 4.9e-6.
"""

import numpy as np
import pytest
import torch

from toypathtracer_torch import FLAG_PROGRESSIVE, RenderConfig, make_scene
from toypathtracer_torch.inverse import InverseRenderer
from toypathtracer_torch.ops import cuda_grad, cuda_render
from toypathtracer_torch.render.frame import RenderSession
from toypathtracer_torch.render.wavefront import (render_frame_plain,
                                                  render_tile_grad_plain)

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("big,light_sampling", [(True, True), (True, False),
                                                (False, True)])
def test_kernel_matches_plain(card, big, light_sampling):
    scene = make_scene(big=big).to(card)
    cfg = RenderConfig(width=96, height=40, samples_per_pixel=2, max_depth=6,
                       do_light_sampling=light_sampling)
    before = cuda_render.launches["render"]
    img, rays = cuda_render.render_tile(scene, cfg, 3, 0, 0, 40, 96)
    assert cuda_render.launches["render"] == before + 1
    plain, prays = render_frame_plain(scene, cfg, 3)
    torch.cuda.synchronize()
    assert img.device.type == "cuda" and rays.dtype == torch.int64
    assert torch.isfinite(img).all()
    assert abs(int(rays) - int(prays)) <= 5e-4 * int(prays)
    assert float((img - plain).abs().mean()) <= 1e-3


def test_session_runs_on_the_card(card):
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=1, max_depth=4)
    sess = RenderSession(make_scene(big=True), cfg, flags=FLAG_PROGRESSIVE)
    before = cuda_render.launches["render"]
    img, rays = sess.steps(0.0, 3)
    torch.cuda.synchronize()
    assert cuda_render.launches["render"] == before + 3
    assert img.device.type == "cuda" and torch.isfinite(img).all()
    assert rays.shape == (3,) and int(rays.min()) > 0


@pytest.mark.parametrize("big", [True, False])
def test_grad_kernel_matches_plain_autograd(card, big):
    scene = make_scene(big=big).to(card)
    cfg = RenderConfig(width=96, height=40, samples_per_pixel=2, max_depth=4)
    g = torch.from_numpy(np.random.RandomState(0).rand(40, 96, 3)
                         .astype(np.float32)).to(card)
    before = dict(cuda_grad.launches)
    img, rays, d = cuda_grad.render_tile_grad(scene, cfg, 1, g, 0, 0, 40, 96)
    img2, _, d2 = cuda_grad.render_tile_grad(scene, cfg, 1, g, 0, 0, 40, 96)
    img_l, rays_l = cuda_grad.render_tile_lockstep(scene, cfg, 1, 0, 0, 40,
                                                   96)
    assert cuda_grad.launches["grad"] == before["grad"] + 2
    assert cuda_grad.launches["lockstep"] == before["lockstep"] + 1
    img_p, rays_p, d_p = render_tile_grad_plain(scene, cfg, 1, g, 0, 0, 40,
                                                96)
    torch.cuda.synchronize()
    assert int(rays) == int(rays_p) == int(rays_l)
    assert torch.equal(img_l, img) and torch.equal(d, d2)
    assert float((img - img_p).abs().mean()) <= 1e-3
    for r in range(14):
        scale = float(d_p[r].abs().max())
        assert float((d[r] - d_p[r]).abs().max()) <= 1e-3 * scale, r


@pytest.mark.parametrize("lockstep", [False, True])
def test_frame_diff_runs_one_forward_and_one_gradient_launch(card, lockstep):
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=1, max_depth=4)
    scene = make_scene(big=True)
    alb = scene.albedo.clone().requires_grad_(True)
    before = dict(cuda_render.launches, **cuda_grad.launches)
    img, _ = cuda_grad.render_frame_diff(scene.replace(albedo=alb), cfg, 0,
                                         lockstep_primal=lockstep)
    img.sum().backward()
    torch.cuda.synchronize()
    fwd = "lockstep" if lockstep else "render"
    now = dict(cuda_render.launches, **cuda_grad.launches)
    assert now[fwd] == before[fwd] + 1
    assert now["grad"] == before["grad"] + 1
    assert alb.grad.device.type == "cpu" and torch.isfinite(alb.grad).all()
    assert float(alb.grad.abs().max()) > 0


def test_inverse_renderer_on_the_card(card):
    scene = make_scene(big=False)
    cfg = RenderConfig(width=64, height=16, samples_per_pixel=2, max_depth=4)
    target, _ = cuda_render.render_frame(scene, cfg, 0)
    alb = scene.albedo.clone()
    alb[0] = torch.tensor([0.2, 0.9, 0.9])
    inv = InverseRenderer(cfg, target, trainable=("albedo",),
                          learning_rate=5e-2)
    fitted, losses = inv.fit(scene.replace(albedo=alb), steps=25,
                             resample=False)
    assert fitted.albedo.device.type == "cuda"
    assert losses[-1] < losses[0] * 0.3, losses
