"""Frame orchestration: animation, progressive accumulation, sessions
(counterpart of toypathtracer_tpu/render/frame.py; reference:
Cpp/Source/Test.cpp:240-367).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..config import FLAG_ANIMATE, FLAG_PROGRESSIVE, RenderConfig, \
    resolve_device
from ..ops import cuda_render, cuda_scaled
from ..scaled import ScaledScene
from ..scene import Scene, validate_scene


@dataclasses.dataclass
class FrameState:
    """Progressive accumulation state (reference: g_Backbuffer +
    frameCount, TestWin.cpp:308-340): the (H, W, 3) float32 running average
    and the number of frames blended into it."""

    accum: torch.Tensor
    frame: int


def init_frame_state(cfg: RenderConfig, device="cuda") -> FrameState:
    """A zeroed accumulator on `device`: the card unless "cpu" is asked
    for."""
    return FrameState(
        accum=torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                          device=resolve_device(device)),
        frame=0)


def lerp_factor(frame: int, flags: int, cfg: RenderConfig) -> np.float32:
    """Progressive blend factor (Test.cpp:272-276), in float32:
    frame/(frame+1), times animate_smoothing when animating, 0 when not
    progressive."""
    f = np.float32(frame)
    fac = f / (f + np.float32(1.0))
    if flags & FLAG_ANIMATE:
        fac = fac * np.float32(cfg.animate_smoothing)
    if not flags & FLAG_PROGRESSIVE:
        fac = np.float32(0.0)
    return fac


def scene_for_frame(scene: Scene, time, flags: int) -> Scene:
    """UpdateTest's scene mutation (Test.cpp:304-308; a ScaledScene's
    beacon orbit)."""
    if flags & FLAG_ANIMATE:
        return scene.animate(time)
    return scene


def progressive_step(state: FrameState, scene: Scene, time,
                     cfg: RenderConfig, flags: int = FLAG_PROGRESSIVE,
                     render_fn: Optional[Callable] = None):
    """One UpdateTest+DrawTest step: animate, render, blend into the
    accumulator.  Returns (state, displayed image, 0-d int64 ray count).

    `render_fn(scene, cfg, frame) -> (img, rays)` defaults to the render
    kernel of the scene's kind on the scene's device.

    The blend updates `state.accum` IN PLACE, and the returned image IS
    that accumulator (the reference GPU port's ping-pong texture pair,
    TestWin.cpp:285-297): copy it before the next step if you keep it.
    Non-finite history values are zeroed first (the Metal port's
    !isfinite(prev) guard)."""
    if render_fn is None:
        render_fn = _render_on_scene_device
    scene_t = scene_for_frame(scene, time, flags)
    img, rays = render_fn(scene_t, cfg, state.frame)
    fac = lerp_factor(state.frame, flags, cfg)
    acc = state.accum
    acc.masked_fill_(~torch.isfinite(acc), 0.0)
    acc.mul_(float(fac)).add_(img * float(np.float32(1.0) - fac))
    state.frame += 1
    return state, acc, rays


def progressive_steps(state: FrameState, scene: Scene, time,
                      cfg: RenderConfig, flags: int, render_fn, n: int):
    """n progressive_step calls with the same `time`.  Returns (state,
    final accumulator, (n,) int64 per-frame ray counts)."""
    rays = []
    img = state.accum
    for _ in range(n):
        state, img, r = progressive_step(state, scene, time, cfg, flags,
                                         render_fn)
        rays.append(r)
    return state, img, torch.stack(rays)


def sum_rays(raycount) -> int:
    """Exact host-side int64 total of a ray count from progressive_step
    (0-d) or progressive_steps ((n,) per frame)."""
    return int(torch.as_tensor(raycount).to(torch.int64).sum())


def _render_on_scene_device(scene, cfg: RenderConfig, frame: int):
    """The whole frame on the scene's device: the render kernel for a
    Scene, the scaled render kernel for a ScaledScene (their plain
    versions on the CPU)."""
    render = cuda_scaled.render_tile_scaled \
        if isinstance(scene, ScaledScene) else cuda_render.render_tile
    return render(scene, cfg, frame, 0, 0, cfg.height, cfg.width)


class RenderSession:
    """Owns a FrameState on one device and resets it on flag toggles
    (reference: TestWin.cpp:419-432).  Renders on the card unless
    device="cpu" is asked for.  `scene` is a Scene or a ScaledScene."""

    def __init__(self, scene, cfg: RenderConfig,
                 flags: int = FLAG_PROGRESSIVE,
                 render_fn: Optional[Callable] = None, device="cuda"):
        self.device = resolve_device(device)
        # the host-side seam every user scene passes through: warn where
        # the interval-overlap shadow test darkens NEE (a ScaledScene's
        # generated layout keeps its beacons above the field)
        if not isinstance(scene, ScaledScene):
            validate_scene(scene)
        self.scene = scene.to(self.device)
        self.cfg = cfg
        self.flags = flags
        self.render_fn = render_fn
        self.state = init_frame_state(cfg, self.device)

    def set_flags(self, flags: int):
        if flags != self.flags:
            self.flags = flags
            self.state = init_frame_state(self.cfg, self.device)

    def step(self, time: float):
        self.state, img, rays = progressive_step(
            self.state, self.scene, time, self.cfg, self.flags,
            self.render_fn)
        return img, rays

    def steps(self, time: float, n: int):
        """n progressive frames; n=1 is exactly step()."""
        if n <= 1:
            return self.step(time)
        self.state, img, rays = progressive_steps(
            self.state, self.scene, time, self.cfg, self.flags,
            self.render_fn, n)
        return img, rays
