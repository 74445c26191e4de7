"""Measured issue rates of the card for the render kernels' op classes
(counterpart of the JAX package's tools/vpu_roofline.py).

    python -m toypathtracer_torch.tools.roofline

The bounds in PERF.md divide counted operations by a paper FP32 peak.
This tool measures the ceilings instead, with the issue-rate probe (T1,
csrc/probe.cu): six cases, each a chain step of one op class (CASES),
8 independent chains a thread for K = 2048 trips, on a grid of whole
waves of full occupancy sized so that each case runs for tens of
milliseconds.  Each case's best of 12 CUDA-event times, after a
warm-up, less the launch floor of its grid (T2: the same kernel with one
trip), gives its rate in ops/s under vpu_roofline.py's op-counting
convention; `fma` is also given in FLOP/s against the 67 TFLOP/s FP32
peak of the H100 SXM data sheet.  The timed launches queue behind a busy
kernel, so the events see the device's time alone.  The floor is
reported two ways: launch to launch with CUDA events (16 one-trip
launches queued back to back), and host-synchronised on the wall clock
(one launch from an idle device to its synchronise).  Every thread's
output of the timed launches, each case's and each floor's, is held
against the plain version on the card (`vs_plain` in the JSON).

Each case also gets the least time the card could take for it: its
operations by class (FP32 add/multiply/multiply-add, compare, MUFU) at
the per-SM rates of the CUDA C++ Programming Guide's arithmetic
instruction throughput table for compute capability 9.0, limited also
by issue (4 schedulers x 32 lanes a clock), over all SMs at the SM clock
that nvidia-smi reads while the probe runs.

Writes build/roofline_torch.json at the root of the checkout and prints
the same JSON.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..ops import _build
from ..ops.cuda_render import cuda_call

OUT = Path(__file__).resolve().parents[2] / "build" / "roofline_torch.json"

K = 2048            # trips a chain (vpu_roofline.py K)
CHAINS = 8          # independent chains a thread (csrc/probe.cuh kChains)
THREADS = 256       # a block (csrc/probe.cu kThreads)
BLOCKS_PER_SM = 8   # 8 x 256 = 2048 threads: a full SM
REPEATS = 12
FP32_PEAK = 67e12   # H100 SXM FP32 FLOP/s, NVIDIA data sheet, 700 W

# Results a clock per SM, compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput table): 32-bit floating-point
# add, multiply, multiply-add 128; compare, minimum, maximum 64; 32-bit
# reciprocal, reciprocal square root 16 (MUFU); and 4 schedulers issuing
# one warp instruction a clock each.
ISSUE_PER_CLK = 128
FP32_PER_CLK = 128
ALU_PER_CLK = 64
MUFU_PER_CLK = 16

DECAY = 0.999755859375       # csrc/probe.cuh kDecay, 1 - 2^-12
TENTH = float(np.float32(0.1))


class Case(NamedTuple):
    id: int          # tpt::probe::Case
    ops: int         # vector ops a chain-trip (vpu_roofline.py CASES)
    flops: int       # flops a chain-trip (vpu_roofline.py CASES)
    waves: int       # grid: waves of BLOCKS_PER_SM blocks on every SM
    fp32: int        # FP32 add/multiply/multiply-add a chain-trip
    alu: int         # compares a chain-trip
    mufu: int        # MUFU operations a chain-trip


# The least operations each step needs: fma one FFMA; cmpsel an add and
# a compare that predicates it (no select instruction); sqrt an add (abs is
# an operand modifier) and a square root; div an add, a reciprocal and a
# multiply; rsqrt an add and a reciprocal square root; render_mix 3 x
# (multiply, add) unfused, an add, a multiply and an add, a subtract, the
# sqrt's add (11 FP32), two compares, one square root.  Waves: each case's
# grid, sized for 18-26 ms a launch on an NVIDIA H100 80GB HBM3 at 700 W.
CASES = {
    "fma": Case(0, 1, 2, 128, 1, 0, 0),
    "cmpsel": Case(1, 2, 2, 64, 1, 1, 0),
    "sqrt": Case(2, 3, 3, 16, 1, 0, 1),
    "div": Case(3, 3, 3, 8, 2, 0, 1),
    "rsqrt": Case(4, 3, 3, 8, 1, 0, 1),
    "render_mix": Case(5, 11, 14, 8, 11, 2, 1),
}

# The busy kernel that the timed launches queue behind: the fma case on
# BUSY_WAVES waves (about 2 ms on an NVIDIA H100 80GB HBM3 at 700 W),
# longer than the host takes to enqueue FLOOR_BATCH launches.
BUSY_WAVES = 16
FLOOR_BATCH = 16

launches = {"issue_rate": 0, "launch_floor": 0}


# ---- plain versions (csrc/probe.cuh, operation for operation) --------------


def _sqrt(v):
    # float64 square root rounded once: the correctly rounded sqrtf
    return torch.sqrt(v.double()).to(torch.float32)


def step_plain(case: str, acc, x):
    """One chain step of `case` on float32 tensors (tpt::probe::step)."""
    if case == "fma":
        # product and sum in float64 (exact here), rounded once: fmaf
        return (acc.double() * DECAY + x.double()).to(torch.float32)
    if case == "cmpsel":
        return torch.where(acc < x, acc + x, acc)
    if case == "sqrt":
        return _sqrt(acc.abs() + x)
    if case == "div":
        return x / (acc.abs() + 1.0)
    if case == "rsqrt":
        s = _sqrt(acc.abs() + x)
        return torch.ones_like(s) / s
    if case == "render_mix":
        for _ in range(3):
            acc = acc * DECAY + x
        acc = torch.where(acc > x, acc, acc + x)
        acc = acc * 0.5 + TENTH
        acc = torch.where(acc < 8.0, acc, acc - x)
        return _sqrt(acc.abs() + 0.25)
    raise ValueError(f"unknown case {case!r}; cases: {sorted(CASES)}")


PERIOD = 1024       # thread_x repeats every PERIOD threads


def thread_x(n: int, device) -> torch.Tensor:
    """Each thread's chain input (tpt::probe::thread_x), exact float32."""
    i = torch.arange(n, device=device) & (PERIOD - 1)
    return 1.000244140625 + i.to(torch.float32) * 0.0009765625


def chains_plain(case: str, trips: int, n: int, device="cpu"):
    """The plain version of T1 for n threads: (n,) float32.  Thread i's
    value depends on i mod PERIOD only."""
    x = thread_x(n, device)[None]
    coef = torch.tensor([0.5 + 0.0625 * c for c in range(CHAINS)],
                        dtype=torch.float32, device=device)
    acc = x * coef[:, None]
    for _ in range(trips):
        acc = step_plain(case, acc, x)
    out = acc[0]
    for c in range(1, CHAINS):
        out = out + acc[c]
    return out


def vs_plain(case: str, trips: int, out: torch.Tensor) -> dict:
    """Every element of a launch's `out` held against the plain version
    on out's device: one PERIOD of plain chains is every thread's value."""
    want = chains_plain(case, trips, PERIOD, out.device)
    got = out.view(-1, PERIOD)
    err = (got - want).abs()
    return {"threads": out.numel(), "trips": trips,
            "finite": bool(torch.isfinite(got).all()),
            "max_abs_err": float(err.max()),
            "max_rel_err": float((err / want.abs()).max())}


# ---- wrappers ----------------------------------------------------------------


def _threads(out: torch.Tensor) -> int:
    n = out.numel()
    if (out.dtype != torch.float32 or out.dim() != 1 or n < THREADS
            or n % THREADS or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous 1-D float32 tensor of a "
                         f"multiple of {THREADS} elements, got {out.dtype} "
                         f"{tuple(out.shape)}")
    return n


def _launch(name: str, out: torch.Tensor, fn, *args):
    lib = _build.load_library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        code = getattr(lib, fn)(*args, ctypes.c_void_p(out.data_ptr()),
                                ctypes.c_void_p(stream))
    cuda_call(lib, name, code)
    launches[name] += 1
    return out


def issue_rate(case: str, out: torch.Tensor, trips: int = K):
    """T1: the chains of `case`, `trips` trips, one float per element of
    `out`: the kernel for a CUDA tensor, the plain version for a CPU
    tensor.  Returns out."""
    n = _threads(out)
    if case not in CASES:
        raise ValueError(f"unknown case {case!r}; cases: {sorted(CASES)}")
    if out.device.type == "cpu":
        return out.copy_(chains_plain(case, trips, n))
    if out.device.type != "cuda":
        raise ValueError(f"no probe for device {out.device}")
    return _launch("issue_rate", out, "tpt_probe_launch", CASES[case].id,
                   int(trips), n // THREADS)


def launch_floor(out: torch.Tensor):
    """T2: the probe's one-trip launch over `out`'s grid (the fma case):
    the kernel for a CUDA tensor, the plain version for a CPU tensor."""
    n = _threads(out)
    if out.device.type == "cpu":
        return out.copy_(chains_plain("fma", 1, n))
    if out.device.type != "cuda":
        raise ValueError(f"no probe for device {out.device}")
    return _launch("launch_floor", out, "tpt_probe_launch", CASES["fma"].id,
                   1, n // THREADS)


# ---- measurement ---------------------------------------------------------------


def queued_event_s(fn, busy, n: int = 1, repeats: int = REPEATS) -> float:
    """Best of `repeats` CUDA-event times of n back-to-back fn() calls,
    divided by n, after a warm-up call.  Each repeat queues behind busy(),
    so the host has enqueued every call before the first starts: the
    device's time from launch to launch, without the host's latency."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = math.inf
    for _ in range(repeats):
        busy()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e-3 / n)
    return best


def best_host_s(fn, repeats: int = REPEATS) -> float:
    """Best of `repeats` wall-clock times of fn() ended by a device
    synchronise, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def nvidia_smi(query: str):
    """nvidia-smi's first line for --query-gpu=query, split on commas, or
    None where it cannot say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return [v.strip() for v in out.strip().splitlines()[0].split(",")]


def sm_clock_under_load(out: torch.Tensor, seconds: float, case_s: float):
    """The SM clock in MHz, and its maximum, as nvidia-smi reads them
    while about `seconds` of fma launches of case_s each run; None for a
    value it does not give."""
    for _ in range(max(1, math.ceil(seconds / case_s))):
        issue_rate("fma", out)
    vals = nvidia_smi("clocks.sm,clocks.max.sm")
    torch.cuda.synchronize()

    def mhz(v):
        try:
            return float(v)
        except (TypeError, ValueError):
            return None
    return tuple(mhz(v) for v in (vals or [None, None]))


def grid_blocks(waves: int) -> int:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return waves * sms * BLOCKS_PER_SM


def case_bound_s(c: Case, threads: int, sms: int, clock_hz: float) -> float:
    """Least time for `threads` threads of case c: the busiest of issue,
    the FP32 pipe, compares and MUFU, over all SMs."""
    per_trip = max((c.fp32 + c.alu + c.mufu) / ISSUE_PER_CLK,
                   c.fp32 / FP32_PER_CLK, c.alu / ALU_PER_CLK,
                   c.mufu / MUFU_PER_CLK)
    return threads * K * CHAINS * per_trip / (sms * clock_hz)


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("roofline: torch finds no CUDA device; the issue "
                         "rates are measured on the card only")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    busy_out = torch.empty(grid_blocks(BUSY_WAVES) * THREADS, device=dev)

    def busy():
        issue_rate("fma", busy_out)

    floors = {}
    for waves in sorted({c.waves for c in CASES.values()}):
        out = torch.full((grid_blocks(waves) * THREADS,), math.nan,
                         device=dev)
        floors[waves] = {
            "blocks": grid_blocks(waves),
            "event_s": queued_event_s(lambda: launch_floor(out), busy,
                                      FLOOR_BATCH, REPEATS),
            "host_s": best_host_s(lambda: launch_floor(out), REPEATS),
            "vs_plain": vs_plain("fma", 1, out)}
    cases = {}
    for name, c in CASES.items():
        out = torch.full((grid_blocks(c.waves) * THREADS,), math.nan,
                         device=dev)
        best = queued_event_s(lambda: issue_rate(name, out), busy,
                              repeats=REPEATS)
        floor = floors[c.waves]["event_s"]
        threads = out.numel()
        ops = threads * K * CHAINS * c.ops
        cases[name] = {"waves": c.waves, "blocks": grid_blocks(c.waves),
                       "ops": ops, "best_time_s": best, "floor_s": floor,
                       "ops_per_s": ops / max(best - floor, 1e-9),
                       "flops_per_s": ops / c.ops * c.flops
                       / max(best - floor, 1e-9),
                       "fp32_alu_mufu_per_trip": [c.fp32, c.alu, c.mufu],
                       "vs_plain": vs_plain(name, K, out)}
        if name == "fma":
            fma_out, fma_s = out, best
    sm_mhz, max_mhz = sm_clock_under_load(fma_out, 1.0, fma_s)
    clock_mhz = sm_mhz or max_mhz
    for name, c in CASES.items():
        r = cases[name]
        r["bound_s"] = (case_bound_s(c, r["blocks"] * THREADS, sms,
                                     clock_mhz * 1e6) if clock_mhz else None)
    smi = nvidia_smi("name,power.limit")
    fma = cases["fma"]
    result = {
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": ", ".join(smi) if smi else None,
        "sms": sms, "threads_per_block": THREADS,
        "blocks_per_sm": BLOCKS_PER_SM, "chains": CHAINS, "inner": K,
        "sync": "CUDA events around launches queued behind a busy "
                "kernel, best of repeats after a warm-up",
        "repeats": REPEATS,
        "sm_clock_mhz_under_load": sm_mhz, "sm_clock_max_mhz": max_mhz,
        "bound_clock_mhz": clock_mhz,
        "floor_subtracted": "event floor of the case's grid",
        "floors": {str(w): f for w, f in floors.items()},
        "fma_flops_per_s": fma["flops_per_s"],
        "fma_vs_fp32_peak": fma["flops_per_s"] / FP32_PEAK,
        "fp32_peak": "67 TFLOP/s (H100 SXM data sheet, 700 W)",
        "cases": cases,
    }
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
