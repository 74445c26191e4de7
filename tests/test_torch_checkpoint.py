"""The port's checkpoints (toypathtracer_torch/checkpoint.py): the JAX
package's three contracts (tests/test_checkpoint.py) on the CPU, loads
across the packages both ways, and resumed fits.

Layouts are the JAX package's, so equality across packages is exact: the
arrays pass through .npz unchanged.  One Adam step from a state the JAX
package saved is held against optax's step on the same gradient within
1e-6 (relative where a parameter is above 1, absolute below, as
tests/test_torch_inverse.py's atol): inverse.adam_update computes it as
optax writes it, but XLA contracts optax's (1 - b1) * g + b1 * mu into one
multiply-add, and where the moment nearly cancels the last bit is
amplified (measured at most 9.7e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from toypathtracer_tpu import RenderConfig as JConfig
from toypathtracer_tpu import checkpoint as j_ckpt
from toypathtracer_tpu import make_scene as j_make_scene
from toypathtracer_tpu.render import frame as j_frame
from toypathtracer_torch import RenderConfig, make_scene
from toypathtracer_torch import checkpoint as ckpt
from toypathtracer_torch.inverse import InverseRenderer, adam_update
from toypathtracer_torch.ops.cuda_grad import PARAM_FIELDS
from toypathtracer_torch.render.frame import (init_frame_state,
                                              progressive_step)
from toypathtracer_torch.render.wavefront import render_frame_plain

torch.set_num_threads(1)

CFG = RenderConfig(width=64, height=8, samples_per_pixel=1, max_depth=4)


def test_progressive_resume_bitexact(tmp_path):
    scene = make_scene(big=False)
    state = init_frame_state(CFG, device="cpu")
    for _ in range(3):
        state, _, _ = progressive_step(state, scene, 0.0, CFG)
    path = str(tmp_path / "frame.npz")
    ckpt.save_frame_state(path, state)
    live = state
    for _ in range(2):
        live, img_live, _ = progressive_step(live, scene, 0.0, CFG)
    resumed = ckpt.load_frame_state(path, device="cpu")
    assert resumed.frame == 3
    for _ in range(2):
        resumed, img_res, _ = progressive_step(resumed, scene, 0.0, CFG)
    assert torch.equal(img_live, img_res)


def test_scene_roundtrip(tmp_path):
    scene = make_scene(big=True)
    path = str(tmp_path / "scene.npz")
    ckpt.save_scene(path, scene)
    back = ckpt.load_scene(path, device="cpu")
    assert back.mat_type == scene.mat_type
    assert back.emissive_ids == scene.emissive_ids
    assert back.camera == scene.camera
    for f in PARAM_FIELDS:
        assert torch.equal(getattr(back, f), getattr(scene, f))


def _port_state(scene, fields=PARAM_FIELDS):
    """The port's Adam state after one update with all-ones gradients."""
    params = {f: getattr(scene, f) for f in fields}
    grads = {f: torch.ones_like(p) for f, p in params.items()}
    _, state = adam_update(params, grads, {}, 1e-2, 1e-8, None)
    return state


def test_train_state_roundtrip(tmp_path):
    scene = make_scene(big=False)
    state = _port_state(scene)
    path = str(tmp_path / "train")
    ckpt.save_train_state(path, scene, state, step=7)
    scene2, state2, step = ckpt.load_train_state(path, device="cpu")
    assert step == 7 and state2["count"] == state["count"] == 1
    assert torch.equal(scene2.radius, scene.radius)
    for f in PARAM_FIELDS:
        assert torch.equal(state2[f][0], state[f][0])
        assert torch.equal(state2[f][1], state[f][1])


def test_frame_state_across_packages(tmp_path):
    jcfg = JConfig(width=16, height=8, samples_per_pixel=1, max_depth=3)
    jst = j_frame.init_frame_state(jcfg)
    jst, _, _ = j_frame.progressive_step(jst, j_make_scene(big=False),
                                         jnp.float32(0.0), jcfg)
    j_path = str(tmp_path / "jax.npz")
    j_ckpt.save_frame_state(j_path, jst)
    st = ckpt.load_frame_state(j_path, device="cpu")
    assert st.frame == 1
    np.testing.assert_array_equal(st.accum.numpy(), np.asarray(jst.accum))

    p_path = str(tmp_path / "port.npz")
    ckpt.save_frame_state(p_path, st)
    back = j_ckpt.load_frame_state(p_path)
    assert int(back.frame) == 1 and back.frame.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(back.accum), st.accum.numpy())


def test_scene_across_packages(tmp_path):
    j_path = str(tmp_path / "jax.npz")
    j_ckpt.save_scene(j_path, j_make_scene(big=True))
    scene = ckpt.load_scene(j_path, device="cpu")
    p_path = str(tmp_path / "port.npz")
    ckpt.save_scene(p_path, scene)
    back = j_ckpt.load_scene(p_path)
    ref = j_make_scene(big=True)
    assert (back.mat_type, back.emissive_ids, back.camera) == \
        (ref.mat_type, ref.emissive_ids, ref.camera)
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(ref, f)))


def _adam_state(opt_state):
    """optax's ScaleByAdamState inside a (chained) Adam state."""
    for x in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda n: hasattr(n, "mu")):
        if hasattr(x, "mu"):
            return x
    raise AssertionError("no Adam state")


def _jax_grads(jscene, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)),
        jscene)


@pytest.mark.parametrize("clip", [None, 1.0], ids=["adam", "clipped"])
def test_jax_train_state_loads_and_steps_as_optax(tmp_path, clip):
    """A train state the JAX package saved (optax's flatten order: the
    count, then mu by Scene field, then nu) loads into the port with each
    moment where optax keeps it, and one more step of adam_update from it
    equals optax's on the same gradient within 1e-6 (module docstring);
    a train state the port saved loads back into the JAX package leaf for
    leaf."""
    jscene = j_make_scene(big=False)
    adam = optax.adam(1e-2, eps=1e-8)
    opt = adam if clip is None else optax.chain(
        optax.clip_by_global_norm(clip), adam)
    st = opt.init(jscene)
    for seed in (0, 1):
        _, st = opt.update(_jax_grads(jscene, seed), st, jscene)
    path = str(tmp_path / "train")
    j_ckpt.save_train_state(path, jscene, st, step=2)
    scene, state, step = ckpt.load_train_state(path, device="cpu")
    assert step == 2 and state["count"] == 2
    js = _adam_state(st)
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(state[f][0].numpy(),
                                      np.asarray(getattr(js.mu, f)))
        np.testing.assert_array_equal(state[f][1].numpy(),
                                      np.asarray(getattr(js.nu, f)))

    g = _jax_grads(jscene, 2)
    updates, st3 = opt.update(g, st, jscene)
    want = optax.apply_updates(jscene, updates)
    params = {f: getattr(scene, f) for f in PARAM_FIELDS}
    grads = {f: torch.from_numpy(np.array(getattr(g, f)))
             for f in PARAM_FIELDS}
    new, state3 = adam_update(params, grads, state, 1e-2, 1e-8, clip)
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(new[f].numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-6)

    p_path = str(tmp_path / "port")
    ckpt.save_train_state(p_path, scene.replace(**new), state3, step=3)
    _, back, back_step = j_ckpt.load_train_state(p_path, opt.init(jscene))
    assert back_step == 3
    got = jax.tree_util.tree_leaves(back)
    want_leaves = jax.tree_util.tree_leaves(st3)
    assert len(got) == len(want_leaves) == 2 * len(PARAM_FIELDS) + 1
    assert int(got[0]) == 3 and got[0].dtype == jnp.int32
    for a, b in zip(got[1:], want_leaves[1:]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_untrained_fields_written_as_zero_moments(tmp_path):
    """The port keeps moments only for the fields it trains; optax's
    masked gradients leave the others at zero, and so does the file."""
    scene = make_scene(big=False)
    state = _port_state(scene, fields=("albedo",))
    path = str(tmp_path / "train")
    ckpt.save_train_state(path, scene, state, step=1)
    with np.load(path + ".opt.npz") as d:
        leaves = [d[f"leaf_{i}"] for i in range(13)]
    n = len(PARAM_FIELDS)
    for i, f in enumerate(PARAM_FIELDS):
        for k, leaf in ((0, leaves[1 + i]), (1, leaves[1 + n + i])):
            assert leaf.shape == tuple(getattr(scene, f).shape)
            if f == "albedo":
                np.testing.assert_array_equal(leaf, state[f][k].numpy())
            else:
                assert not leaf.any()


def test_fit_resumed_from_a_train_state_equals_a_straight_fit(tmp_path):
    """InverseRenderer: 2 Adam steps, the train state saved, loaded and 2
    more steps equal 4 straight steps bit for bit (the plain version's
    autograd on the CPU; chip_smoke.py's resume phase holds K3's)."""
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1, max_depth=2)
    scene = make_scene(big=False)
    target, _ = render_frame_plain(scene, cfg, 0)
    start = scene.replace(albedo=scene.albedo * 0.7)

    def renderer():
        return InverseRenderer(cfg, target, trainable=("albedo", "center"),
                               learning_rate=0.05, device="cpu")
    straight, losses = renderer().fit(start, 4)
    r = renderer()
    half, first = r.fit(start, 2)
    path = str(tmp_path / "train")
    ckpt.save_train_state(path, half, r.opt_state, step=2)
    loaded, state, step = ckpt.load_train_state(path, device="cpu")
    resumed, second = renderer().fit(loaded, 2, frame0=step,
                                     opt_state=state)
    assert first + second == losses
    for f in PARAM_FIELDS:
        assert torch.equal(getattr(resumed, f), getattr(straight, f)), f


def test_loads_default_to_the_card(tmp_path, monkeypatch):
    scene = make_scene(big=False)
    path = str(tmp_path / "s")
    ckpt.save_train_state(path, scene, {}, step=0)
    ckpt.save_frame_state(path + ".f.npz", init_frame_state(CFG, "cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for load in (lambda: ckpt.load_train_state(path),
                 lambda: ckpt.load_scene(path + ".scene.npz"),
                 lambda: ckpt.load_frame_state(path + ".f.npz")):
        with pytest.raises(RuntimeError, match="device"):
            load()
