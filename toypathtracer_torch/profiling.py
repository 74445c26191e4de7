"""Performance HUD and device timing (counterpart of toypathtracer_tpu/
profiling.py).

The HUD string is the reference's cross-frontend format
`"%.2fms (%.1f FPS) %.1fMrays/s %.2fMrays/frame frames %i"`
(TestWin.cpp:330, Renderer.mm:251-253, Cs/Program.cs:31).  Ray counting
matches the reference: every primary, bounce and shadow ray counts
(Test.cpp:122, 199).

`trace_to(log_dir)` records a torch.profiler trace of a block (CPU
activity and, with a card, CUDA kernels and copies) as a Chrome trace
file; `trace_summary` reads one back: each kernel's device time and the
device's idle share of the block.
"""

from __future__ import annotations

import contextlib
import json
import re
from collections import deque
from pathlib import Path
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


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Capture a torch.profiler trace around a block (counterpart of the
    JAX package's trace_to, the analog of the reference's GPU timestamp
    queries): CPU activity and, where torch finds a card, CUDA activity,
    written when the block ends by tensorboard_trace_handler as
    `<worker>.<time>.pt.trace.json` in log_dir.  View it with
    TensorBoard's profiler plugin or any Chrome-trace viewer (Perfetto);
    trace_summary(log_dir) reads the newest one.  Yields the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) \
            as prof:
        yield prof


# Chrome-trace categories of work on the device.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")


def kernel_label(name: str) -> str:
    """A kernel's trace name without its return type, namespaces and
    parameters: "merged_render_kernel<4>"."""
    name = re.sub(r"^void\s+", "", name.strip())
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):  # the parameter list: the first "(" at
        if ch == "<":              # template depth 0 after the name
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0 and name[i - 1] != ":":
            cut = i
            break
    name = name[:cut]
    # drop the namespaces, "(anonymous namespace)::" included
    depth, start = 0, 0
    for i, ch in enumerate(name):
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif ch == ":" and depth == 0 and name[i + 1:i + 2] == ":":
            start = i + 2
    return name[start:]


def traced_kernel(kernels: dict, label: str) -> dict:
    """A trace_summary "kernels" entry by the kernel's ptxas label
    (ops/_build.kernel_label: "wave_run_kernel<1,0>" is
    "wave_run_kernel<true, false>" in a trace); {} where it is not there."""
    def norm(k):
        return re.sub(r"\s", "", k).replace("false", "0").replace("true",
                                                                   "1")
    return next((v for k, v in kernels.items() if norm(k) == label), {})


def trace_summary(path, window: str = None) -> dict:
    """The device's view of a trace_to trace (a *.pt.trace.json file, or
    the directory holding it: its newest): "span_ms", the block's span
    from the first to the last event of any kind, or with `window` the
    last torch.profiler.record_function range of that name; "busy_ms",
    the union of the device's kernel, copy and set intervals within it;
    "idle_share", 1 - busy / span; "kernels", each kernel's device ms and
    launches within it by kernel_label; "copies_ms", the copies' and
    sets' device ms; "runtime", the host's CUDA runtime and driver calls
    that start within it (cudaMemGetInfo, cudaMalloc, ...): host ms and
    calls by name."""
    path = Path(path)
    if path.is_dir():
        files = sorted(path.glob("*.pt.trace.json"),
                       key=lambda f: f.stat().st_mtime)
        if not files:
            raise FileNotFoundError(f"no *.pt.trace.json in {path}")
        path = files[-1]
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    if window is None:
        lo = min((float(e["ts"]) for e in events), default=0.0)
        hi = max((float(e["ts"]) + float(e["dur"]) for e in events),
                 default=0.0)
    else:
        marks = [e for e in events if e.get("cat") == "user_annotation"
                 and e["name"] == window]
        if not marks:
            raise ValueError(f"no record_function {window!r} in {path}")
        lo = float(marks[-1]["ts"])
        hi = lo + float(marks[-1]["dur"])
    device = []
    kernels: dict = {}
    runtime: dict = {}
    copies = 0.0
    for e in events:
        if e.get("cat", "") in RUNTIME_CATEGORIES and lo <= float(e["ts"]) < hi:
            r = runtime.setdefault(e["name"], {"ms": 0.0, "calls": 0})
            r["ms"] += float(e["dur"]) * 1e-3
            r["calls"] += 1
        if e.get("cat", "") not in DEVICE_CATEGORIES:
            continue
        a = max(float(e["ts"]), lo)
        b = min(float(e["ts"]) + float(e["dur"]), hi)
        if b <= a:
            continue
        device.append((a, b))
        if e["cat"] == "kernel":
            k = kernels.setdefault(kernel_label(e["name"]),
                                   {"ms": 0.0, "launches": 0})
            k["ms"] += (b - a) * 1e-3
            k["launches"] += 1
        else:
            copies += (b - a) * 1e-3
    busy, end = 0.0, float("-inf")
    for a, b in sorted(device):
        if b > end:
            busy += b - max(a, end)
            end = b
    span, busy = (hi - lo) * 1e-3, busy * 1e-3
    return {"file": path.name, "window": window, "span_ms": span,
            "busy_ms": busy,
            "idle_share": 1.0 - busy / span if span > 0 else None,
            "kernels": kernels, "copies_ms": copies, "runtime": runtime}
