"""Performance HUD and device timing (counterpart of toypathtracer_tpu/
profiling.py).

The HUD string is the reference's cross-frontend format
`"%.2fms (%.1f FPS) %.1fMrays/s %.2fMrays/frame frames %i"`
(TestWin.cpp:330, Renderer.mm:251-253, Cs/Program.cs:31).  Ray counting
matches the reference: every primary, bounce and shadow ray counts
(Test.cpp:122, 199).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import torch

HUD_FORMAT = "%s %.2fms (%.1f FPS) %.1fMrays/s %.2fMrays/frame frames %i"


def hud_string(title: str, seconds: float, rays: int, frames: int) -> str:
    """The reference HUD line (reference: TestWin.cpp:328-331)."""
    s = seconds if seconds > 0 else 1e-9
    return HUD_FORMAT % (title, seconds * 1000.0, 1.0 / s,
                         rays / s * 1.0e-6, rays * 1.0e-6, frames)


@dataclass
class FrameTimer:
    """Windowed frame timing (reference: TestWin.cpp:310-336, a 10-frame
    window).  Feed it (dt_seconds, ray_count) per frame; read the averaged
    HUD at any time."""

    window: int = 10
    title: str = "CUDA path tracer"
    _samples: deque = field(default_factory=deque)
    _frames: int = 0

    def add(self, dt: float, rays: int, count: int = 1) -> None:
        """Record `count` frames rendered in `dt` seconds total; one
        per-frame sample is pushed per frame, so the window stays 10
        frames whatever the batching."""
        self._frames += count
        per = (dt / count, rays / count)
        for _ in range(min(count, self.window)):
            self._samples.append(per)
        while len(self._samples) > self.window:
            self._samples.popleft()

    @property
    def frames(self) -> int:
        return self._frames

    def averages(self):
        """(mean seconds/frame, mean rays/frame) over the window."""
        if not self._samples:
            return 0.0, 0
        n = len(self._samples)
        return (sum(s for s, _ in self._samples) / n,
                sum(r for _, r in self._samples) / n)

    def hud(self) -> str:
        s, r = self.averages()
        return hud_string(self.title, s, int(r), self._frames)

    def mray_s(self) -> float:
        s, r = self.averages()
        return r / s * 1e-6 if s > 0 else 0.0


def time_device_call(fn, *args, repeats: int = 1):
    """Device time of `repeats` back-to-back calls of fn(*args) on the
    current CUDA stream, from CUDA events.  Returns (seconds per call,
    last result).  Raises without a card: a device time is never taken
    from the host clock."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_device_call needs a CUDA device")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        out = fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3 / repeats, out
