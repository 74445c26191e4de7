"""Checkpoint and resume (counterpart of toypathtracer_tpu/checkpoint.py).

The reference's only persistent state is the progressive accumulation
buffer and its frame counter (Test.cpp:272-276, 293-294; reset on toggles,
TestWin.cpp:424-431).  Here it is saved explicitly, with scenes and the
inverse-rendering train state (scene and Adam state), so that long
progressive renders and fits resume across processes.

The .npz layouts are the JAX package's, so a checkpoint written by either
package loads in the other:
  * frame state: `accum` (H, W, 3) float32 and `frame` int32;
  * scene: the six float32 fields and a JSON `meta` record (mat_type,
    emissive_ids, camera) stored as uint8 bytes;
  * train state: `<path>.scene.npz` and `<path>.opt.npz` holding `step`
    and `leaf_<i>`, the leaves of optax's Adam state in its flatten order
    (`optax.adam`, or `optax.chain(optax.clip_by_global_norm, optax.adam)`:
    the clip adds no leaf): the int32 step count, then the first moments
    by Scene field, then the second moments by field.

The port's Adam state is inverse.adam_update's dict: {"count": int,
field: (mu, nu)} for the fields it trains.  A field it does not train has
zero moments in optax's state (its gradient is masked to zero), and is
written so.  Loads go to the card unless device="cpu" is asked for.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

import numpy as np
import torch

from .config import resolve_device
from .ops.cuda_grad import PARAM_FIELDS
from .render.frame import FrameState
from .scene import Scene, load_scene_npz


def save_frame_state(path: str, state: FrameState) -> None:
    np.savez(path, accum=state.accum.detach().cpu().numpy(),
             frame=np.asarray(state.frame, dtype=np.int32))


def load_frame_state(path: str, device="cuda") -> FrameState:
    device = resolve_device(device)
    with np.load(path) as d:
        accum = torch.from_numpy(np.array(d["accum"], dtype=np.float32))
        frame = int(d["frame"])
    return FrameState(accum=accum.to(device), frame=frame)


def save_scene(path: str, scene: Scene) -> None:
    meta = dict(mat_type=list(scene.mat_type),
                emissive_ids=list(scene.emissive_ids),
                camera=dataclasses.asdict(scene.camera))
    fields = {f: getattr(scene, f).detach().cpu().numpy()
              for f in PARAM_FIELDS}
    np.savez(path, **fields,
             meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))


def load_scene(path: str, device="cuda") -> Scene:
    return load_scene_npz(path, device=device)


def _opt_state_leaves(scene: Scene, opt_state: dict) -> list:
    """The port's Adam state as optax's leaves (numpy), in its order."""
    def moment(f, k):
        if f in opt_state:
            return opt_state[f][k].detach().cpu().numpy()
        return np.zeros(tuple(getattr(scene, f).shape), np.float32)
    return ([np.asarray(opt_state.get("count", 0), dtype=np.int32)]
            + [moment(f, 0) for f in PARAM_FIELDS]
            + [moment(f, 1) for f in PARAM_FIELDS])


def save_train_state(path: str, scene: Scene, opt_state: dict,
                     step: int) -> None:
    """Inverse-rendering checkpoint: the scene and the whole Adam state."""
    save_scene(path + ".scene.npz", scene)
    leaves = _opt_state_leaves(scene, opt_state)
    np.savez(path + ".opt.npz", step=np.int64(step),
             **{f"leaf_{i}": a for i, a in enumerate(leaves)})


def load_train_state(path: str, device="cuda") -> Tuple[Scene, dict, int]:
    """(scene, Adam state for inverse.adam_update, step) on `device`: the
    moments of every field, the ones the fit does not train at zero."""
    device = resolve_device(device)
    scene = load_scene(path + ".scene.npz", device=device)
    n = len(PARAM_FIELDS)
    with np.load(path + ".opt.npz") as d:
        leaves = [d[f"leaf_{i}"] for i in range(2 * n + 1)]
        step = int(d["step"])

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
    state = {"count": int(leaves[0])}
    for i, f in enumerate(PARAM_FIELDS):
        state[f] = (t(leaves[1 + i]), t(leaves[1 + n + i]))
    return scene, state, step
