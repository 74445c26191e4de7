"""Animation-path gradients of the port (BASELINE config 4), the
counterpart of tests/test_motion.py: d(image)/d(t) through Scene.animate
(sphere 1: y = cos t + 1; sphere 8: z = 0.3 sin t; Test.cpp:304-308) and
the plain render, on the CPU, and the motion demo
(toypathtracer_torch/demo_motion.py).

Tolerance of d(mean image)/dt against jax.grad of the JAX package's
lockstep route at that file's CFG (the big scene, 64x16, spp 2, depth 4,
t = 0.7): 5e-3 relative.  Measured 1.4e-3: XLA's CPU code fuses products
and sums into multiply-adds (tests/torch_jax_rounding.py), and with that
off (XLA_FLAGS=--xla_cpu_max_isa=AVX) the two agree within 1.8e-6.  The
AD-against-finite-differences check of tests/test_motion.py (32 frames a
side, marked slow there) runs on the card, in chip_smoke.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toypathtracer_tpu import FLAG_ANIMATE as J_ANIMATE
from toypathtracer_tpu import RenderConfig as JConfig
from toypathtracer_tpu import make_scene as j_make_scene
from toypathtracer_tpu.render.frame import scene_for_frame as j_scene_for_frame
from toypathtracer_tpu.render.wavefront import render_frame as j_render_frame
from toypathtracer_torch import (FLAG_ANIMATE, FLAG_PROGRESSIVE,
                                 RenderConfig, make_scene)
from toypathtracer_torch import demo_motion
from toypathtracer_torch.render.frame import scene_for_frame
from toypathtracer_torch.render.wavefront import render_frame_plain

torch.set_num_threads(1)

CFG = dict(width=64, height=16, samples_per_pixel=2, max_depth=4)
FIELDS = ("center", "radius", "albedo", "emissive", "roughness", "ri")


def mean_image_grad(eps: float, t_at: float = 0.7) -> float:
    t = torch.tensor(t_at, requires_grad=True)
    scene_t = scene_for_frame(make_scene(big=True), t, FLAG_ANIMATE)
    img, _ = render_frame_plain(scene_t, RenderConfig(
        **CFG, soft_silhouette_eps=eps), 0)
    g, = torch.autograd.grad(img.mean(), t)
    return float(g)


@pytest.fixture(scope="module")
def hard_grad():
    return mean_image_grad(0.0)


def test_motion_gradient_matches_jax_grad(hard_grad):
    big = j_make_scene(big=True)
    cfg = JConfig(**CFG)
    want = float(jax.jit(jax.grad(lambda t: jnp.mean(j_render_frame(
        j_scene_for_frame(big, t, J_ANIMATE), cfg, jnp.int32(0),
        differentiable=True)[0])))(jnp.float32(0.7)))
    assert np.isfinite(hard_grad) and hard_grad != 0.0
    assert abs(hard_grad - want) <= 5e-3 * abs(want), (hard_grad, want)


def test_soft_motion_gradient_differs_from_hard(hard_grad):
    """With the soft-silhouette estimator the moving silhouettes of
    spheres 1 and 8 reach d/dt: finite, nonzero, and not the hard
    selects' shading-only value."""
    soft = mean_image_grad(0.05)
    assert np.isfinite(soft) and soft != 0.0
    assert abs(soft - hard_grad) > 0.5 * abs(hard_grad)


def test_animated_sequence_per_frame_fwd_bwd():
    """tests/test_motion.py::test_animated_sequence_per_frame_fwd_bwd on
    the port: three animated progressive frames, each forward and backward
    to every scene field, finite."""
    cfg = RenderConfig(**CFG)
    for i in range(3):
        scene = make_scene(big=True)
        leaves = {f: getattr(scene, f).clone().requires_grad_(True)
                  for f in FIELDS}
        scene_t = scene_for_frame(scene.replace(**leaves), i / 60.0,
                                  FLAG_ANIMATE | FLAG_PROGRESSIVE)
        img, _ = render_frame_plain(scene_t, cfg, i)
        grads = torch.autograd.grad(img.mean(), list(leaves.values()))
        assert torch.isfinite(img).all()
        for f, g in zip(FIELDS, grads):
            assert torch.isfinite(g).all(), (i, f)


def test_demo_motion_on_the_cpu(capsys):
    """The motion demo at a tiny size on the CPU prints one JSON line with
    the JAX demo's keys (tools/demo_motion.py), and its loss falls."""
    res = demo_motion.main(["--device", "cpu", "--width", "24", "--height",
                            "16", "--steps", "6", "--lr", "0.05"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res
    assert set(line) >= {"t_true", "t_guess", "t_recovered", "t_abs_err",
                         "loss_initial", "loss_final", "steps", "seconds"}
    assert line["device"] == "cpu" and line["steps"] == 6
    assert np.isfinite(line["t_recovered"])
    assert line["loss_final"] < line["loss_initial"]
