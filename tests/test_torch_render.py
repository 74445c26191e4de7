"""The render kernel's module (toypathtracer_torch/ops/cuda_render.py) on
the CPU, where it runs the kernel's plain PyTorch version, against the
JAX package's renderers.

The JAX references run at exactly the configurations tests/test_pallas.py
and tests/test_merged.py compile (128x16, spp 2, depth 10, frame 3), so
the persistent compile cache serves them.

Tolerances (measured on the CPU, then gated at about twice that):
  * ray count: measured exact; gate 1e-4 relative (one ray in 10k: a
    1-ulp transcendental difference may flip one Monte-Carlo decision);
  * pixels within 1e-4: measured 99.95% (one pixel of 2048 at 4.4e-4);
    gate 99.9%;
  * mean |diff|: measured 2.5e-7; gate 5e-7.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toypathtracer_tpu import RenderConfig as JConfig
from toypathtracer_tpu import make_scene as j_make_scene
from toypathtracer_tpu.ops.pallas_render import render_frame_pallas
from toypathtracer_tpu.render import wavefront as j_wavefront
from toypathtracer_torch import RenderConfig, make_scene
from toypathtracer_torch.ops import cuda_render
from toypathtracer_torch.render.frame import RenderSession

torch.set_num_threads(1)

CFG = dict(width=128, height=16, samples_per_pixel=2, max_depth=10,
           tile_h=8, tile_w=128)
CFG_M = dict(CFG, merged_wavefront=True)


def assert_render_close(img, rays, jimg, jrays):
    img, jimg = np.asarray(img), np.asarray(jimg)
    assert img.shape == jimg.shape and np.isfinite(img).all()
    assert abs(int(rays) - int(jrays)) <= 1e-4 * int(jrays)
    d = np.abs(img - jimg)
    assert (d.max(axis=-1) <= 1e-4).mean() >= 0.999
    assert d.mean() <= 5e-7


@pytest.fixture(scope="module")
def big_scenes():
    return make_scene(big=True), j_make_scene(big=True)


@pytest.mark.parametrize("ref,kw", [("jnp", CFG), ("jnp", CFG_M),
                                    ("pallas_interpret", CFG_M)])
def test_render_frame_matches_jax(big_scenes, ref, kw):
    scene, jscene = big_scenes
    img, rays = cuda_render.render_frame(scene, RenderConfig(**kw), 3,
                                         device="cpu")
    assert img.dtype == torch.float32 and rays.dtype == torch.int64
    if ref == "jnp":
        jimg, jrays = j_wavefront.render_frame(jscene, JConfig(**kw),
                                               jnp.int32(3))
    else:
        jimg, jrays = render_frame_pallas(jscene, JConfig(**kw),
                                          jnp.int32(3), interpret=True)
    assert_render_close(img, rays, jimg, jrays)


@pytest.mark.parametrize("x0,y0,h,w", [(8, 4, 12, 40), (100, 9, 7, 28)])
def test_render_tile_offset_matches_jax(big_scenes, x0, y0, h, w):
    """A sub-image at an offset (the row-band unit of sharded rendering):
    global-pixel seeding and the ray count of exactly its pixels.
    Measured: rays exact, max |diff| 1.8e-6."""
    scene, jscene = big_scenes
    cfg, jcfg = RenderConfig(**CFG), JConfig(**CFG)
    img, rays = cuda_render.render_tile(scene, cfg, 3, x0, y0, h, w)
    assert img.shape == (h, w, 3)
    jimg, jrays = jax.jit(lambda: j_wavefront.render_tile(
        jscene, jcfg, jnp.int32(3), x0, y0, h, w))()
    assert_render_close(img, rays, np.transpose(np.asarray(jimg), (1, 2, 0)),
                        jrays)


def test_render_tile_is_a_slice_of_the_frame(big_scenes):
    scene, _ = big_scenes
    cfg = RenderConfig(width=32, height=16, samples_per_pixel=1, max_depth=4)
    full, _ = cuda_render.render_tile(scene, cfg, 2, 0, 0, 16, 32)
    sub, _ = cuda_render.render_tile(scene, cfg, 2, 5, 3, 9, 20)
    np.testing.assert_array_equal(sub.numpy(), full[3:12, 5:25].numpy())


def test_render_tile_rejects_bad_input(big_scenes):
    scene, _ = big_scenes
    cfg = RenderConfig(width=32, height=16)
    with pytest.raises(ValueError):
        cuda_render.render_tile(scene, cfg, 0, 0, 0, 0, 16)
    with pytest.raises(ValueError):
        cuda_render.render_tile(scene.replace(mat_type=(3,) * 46), cfg, 0,
                                0, 0, 16, 32)
    with pytest.raises(ValueError):
        cuda_render.render_tile(scene.replace(emissive_ids=(46,)), cfg, 0,
                                0, 0, 16, 32)


def test_entry_points_default_to_cuda():
    assert inspect.signature(cuda_render.render_frame).parameters[
        "device"].default == "cuda"
    assert inspect.signature(RenderSession).parameters[
        "device"].default == "cuda"


def test_entry_points_raise_without_a_card(big_scenes):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    scene, _ = big_scenes
    cfg = RenderConfig(width=32, height=16)
    with pytest.raises(RuntimeError, match="device"):
        cuda_render.render_frame(scene, cfg, 0)
    with pytest.raises(RuntimeError, match="device"):
        RenderSession(scene, cfg)
    from toypathtracer_torch.cli import main
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--width", "8", "--height", "8", "--frames", "1"])
