"""The port's scene, camera, packed table and config against the JAX
package's, on the CPU.

Tolerances: scene fields, material metadata, pack_scene and the config
rules are exact (the same float32 literals and arithmetic); the camera is
within 2 ulp (XLA and numpy each use their own float32 tan);
Scene.animate within 1 ulp (float32 cos/sin).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toypathtracer_tpu import RenderConfig as JConfig
from toypathtracer_tpu import make_scene as j_make_scene
from toypathtracer_tpu.camera import camera_to_array as j_camera_to_array
from toypathtracer_tpu.camera import make_camera as j_make_camera
from toypathtracer_tpu.checkpoint import save_scene as j_save_scene
from toypathtracer_tpu.ops.pallas_render import pack_scene as j_pack_scene
from toypathtracer_torch import FLAG_ANIMATE, RenderConfig, make_scene
from toypathtracer_torch.camera import (camera_from_array, camera_to_array,
                                        make_camera)
from toypathtracer_torch.ops.cuda_render import pack_scene
from toypathtracer_torch.render.frame import scene_for_frame
from toypathtracer_torch.render.wavefront import render_frame_plain
from toypathtracer_torch.scene import (load_scene_npz,
                                       recompute_emissive_ids,
                                       scene_from_arrays, scene_to_arrays)

torch.set_num_threads(1)

FIELDS = ("center", "radius", "albedo", "emissive", "roughness", "ri")
SCENES = [(True, False), (True, True), (False, False), (False, True)]


def assert_same_scene(t, j):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)))
    assert t.mat_type == j.mat_type
    assert t.emissive_ids == j.emissive_ids
    assert dataclasses.asdict(t.camera) == dataclasses.asdict(j.camera)


@pytest.mark.parametrize("big,mitsuba", SCENES)
def test_make_scene_matches(big, mitsuba):
    assert_same_scene(make_scene(big=big, mitsuba_compare=mitsuba),
                      j_make_scene(big=big, mitsuba_compare=mitsuba))


def test_animate_matches():
    t = make_scene(big=True).animate(1.0).center.numpy()
    j = np.asarray(j_make_scene(big=True).animate(jnp.float32(1.0)).center)
    np.testing.assert_array_max_ulp(t, j, maxulp=1)


def test_animate_time_gradient_matches_jax():
    """d(center)/dt through a tensor time against jax.jacfwd of the JAX
    Scene.animate at t = 0.7, within 1e-6."""
    scene = make_scene(big=True)
    t = torch.tensor(0.7, requires_grad=True)
    got = torch.autograd.functional.jacobian(
        lambda x: scene.animate(x).center, t)
    jscene = j_make_scene(big=True)
    want = np.asarray(jax.jacfwd(lambda x: jscene.animate(x).center)(
        jnp.float32(0.7)))
    assert got.shape == want.shape == (46, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert np.count_nonzero(want) == 2
    # a tensor time gives the float time's centers
    assert torch.equal(scene.animate(t).center.detach(),
                       scene.animate(0.7).center)


def test_motion_gradient_finite_and_nonzero():
    """The port's counterpart of tests/test_motion.py::
    test_motion_gradient_finite_and_nonzero: torch autograd of the mean
    image through the plain render of the animated scene at that file's
    CFG (64x16, spp 2, depth 4) reaches t finite and nonzero."""
    cfg = RenderConfig(width=64, height=16, samples_per_pixel=2,
                       max_depth=4)
    t = torch.tensor(0.7, requires_grad=True)
    scene_t = scene_for_frame(make_scene(big=True), t, FLAG_ANIMATE)
    img, _ = render_frame_plain(scene_t, cfg, 0)
    g, = torch.autograd.grad(img.mean(), t)
    assert torch.isfinite(g) and float(g) != 0.0


@pytest.mark.parametrize("big,mitsuba", SCENES)
@pytest.mark.parametrize("aspect", [1280 / 720, 128 / 16, 0.5])
def test_camera_array_within_2ulp(big, mitsuba, aspect):
    spec = make_scene(big=big, mitsuba_compare=mitsuba).camera
    jspec = j_make_scene(big=big, mitsuba_compare=mitsuba).camera
    t = camera_to_array(make_camera(spec, aspect))
    j = np.asarray(j_camera_to_array(j_make_camera(jspec, aspect)))
    assert t.dtype == np.float32 and t.shape == (22,)
    np.testing.assert_array_max_ulp(t, j, maxulp=2)
    back = camera_to_array(camera_from_array(t))
    np.testing.assert_array_equal(back, t)


@pytest.mark.parametrize("big", [True, False])
def test_pack_scene_equal(big):
    t = pack_scene(make_scene(big=big)).numpy()
    j = np.asarray(j_pack_scene(j_make_scene(big=big)))
    assert t.shape == (14, 46 if big else 9)
    np.testing.assert_array_equal(t, j)


def test_pack_scene_guards_nonpositive_radius():
    s = make_scene(big=False)
    r = s.radius.clone()
    r[3] = 0.0
    r[4] = -1.0
    packed = pack_scene(s.replace(radius=r)).numpy()
    jpacked = np.asarray(j_pack_scene(
        j_make_scene(big=False).replace(radius=jnp.asarray(r.numpy()))))
    assert packed[4, 3] == 0.0 and packed[4, 4] == 0.0
    np.testing.assert_array_equal(packed, jpacked)


def test_scene_carried_over_from_jax_checkpoint(tmp_path):
    """A scene saved by the JAX package loads and round-trips in the port
    (the port's "weights" carry-over)."""
    rng = np.random.default_rng(4)
    j = j_make_scene(big=True)
    j = j.replace(albedo=jnp.asarray(rng.random((46, 3), dtype=np.float32)),
                  center=j.center + jnp.asarray(
                      rng.normal(size=(46, 3)).astype(np.float32) * 0.01))
    path = str(tmp_path / "scene.npz")
    j_save_scene(path, j)
    t = load_scene_npz(path, device="cpu")
    assert_same_scene(t, j)
    arrays = scene_to_arrays(t)
    assert_same_scene(scene_from_arrays(**arrays), j)


def test_recompute_emissive_ids():
    s = make_scene(big=False)
    em = s.emissive.clone()
    em[2] = torch.tensor([1.0, 0.0, 0.0])
    assert recompute_emissive_ids(s.replace(emissive=em)).emissive_ids == \
        (2, 8)


BAD_CONFIGS = [
    dict(max_depth=0), dict(max_depth=256), dict(samples_per_pixel=0),
    dict(samples_per_pixel=256), dict(width=0), dict(height=0),
    dict(pix_per_lane=0), dict(pix_per_lane=64),
    dict(diff_wavefront=True),
    dict(diff_wavefront=True, merged_wavefront=True,
         soft_silhouette_eps=0.1),
]
GOOD_CONFIGS = [dict(), dict(max_depth=255, samples_per_pixel=255),
                dict(width=1, height=1, pix_per_lane=63),
                dict(diff_wavefront=True, merged_wavefront=True)]


@pytest.mark.parametrize("kw", BAD_CONFIGS)
def test_render_config_rejects_like_jax(kw):
    with pytest.raises(ValueError):
        JConfig(**kw)
    with pytest.raises(ValueError):
        RenderConfig(**kw)


@pytest.mark.parametrize("kw", GOOD_CONFIGS)
def test_render_config_accepts_like_jax(kw):
    t, j = RenderConfig(**kw), JConfig(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.inv_width, t.inv_height) == (j.inv_width, j.inv_height)
