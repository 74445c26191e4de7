"""float32 sin, cos and sqrt as the reference's compiled C++ computes
them.

The parity route (tracecore.CPU_SAMPLERS, render/parity.py) replays the
reference's scalar C++ draw for draw, and a path tracer is chaotic: a
last-bit difference in a scatter or light direction grows bounce by bounce
until a comparison flips.  The C++ calls the C library's sinf/cosf
(glibc's on Linux).  torch.sin/torch.cos on the CPU differ from them on
about 5% of the sampler's inputs; the C library's own functions, applied
elementwise through csrc/libm.cpp (built with g++ at first use into
build/torch_host/), agree with them by construction.  On a CUDA tensor
the functions are torch.sin/torch.cos, CUDA's sinf/cosf (PyTorch builds
its kernels without fast math), which differ from glibc's in the last
bits on a share of the inputs that chip_smoke.py reports.

torch.sqrt on the CPU is its vectorised library's (within 0.5001 ulp), not
the correctly rounded sqrtf, and parts from it on about 0.5% of the unit
vector sampler's inputs; sqrtf here takes the root in float64 and rounds
once, which is sqrtf's value (a double has more than twice a float's
precision).  On the card torch.sqrt is the correctly rounded sqrtf.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build_host(
        "tpt_libm", _build.CSRC / "libm.cpp", ("-O2", "-fno-builtin"))))
    for fn in (lib.tpt_sinf, lib.tpt_cosf):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        fn.restype = None
    return lib


def _apply(name: str, x: torch.Tensor) -> torch.Tensor:
    x = x.detach().to(torch.float32).contiguous()
    out = torch.empty_like(x)
    getattr(_library(), name)(x.data_ptr(), out.data_ptr(), x.numel())
    return out


def sinf(x: torch.Tensor) -> torch.Tensor:
    """Elementwise float32 sin: the C library's sinf on the CPU, CUDA's
    sinf on the card."""
    if x.device.type != "cpu":
        return torch.sin(x)
    return _apply("tpt_sinf", x)


def cosf(x: torch.Tensor) -> torch.Tensor:
    """Elementwise float32 cos: the C library's cosf on the CPU, CUDA's
    cosf on the card."""
    if x.device.type != "cpu":
        return torch.cos(x)
    return _apply("tpt_cosf", x)


def sqrtf(x: torch.Tensor) -> torch.Tensor:
    """Elementwise correctly rounded float32 sqrt (sqrtf)."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(torch.float32)
