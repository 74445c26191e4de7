"""The CUDA render kernel on the card, against its plain PyTorch version.

Marked `cuda`: these skip without a CUDA device.  On the H100 run them
without the JAX-side conftest (the card's machine has no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the gates of chip_smoke.py (rays 5e-4 relative, mean |diff|
1e-3); measured on an H100 at 320x176: rays exact, max |diff| 1.9e-6.
"""

import pytest
import torch

from toypathtracer_torch import FLAG_PROGRESSIVE, RenderConfig, make_scene
from toypathtracer_torch.ops import cuda_render
from toypathtracer_torch.render.frame import RenderSession
from toypathtracer_torch.render.wavefront import render_frame_plain

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
