"""Build the CUDA sources of csrc/ with nvcc at first use and load them
with ctypes.

The library is a plain C interface (no PyTorch headers), so nvcc takes
seconds.  It lands in build/torch_kernels/ at the root of the checkout,
named by a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is loaded as it is.  Nothing is built or loaded at
import time.  A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# -fmad=false: no FMA contraction, so the kernel rounds every product and
# sum as the plain PyTorch version does (see PERF.md).  No --use_fast_math:
# sinf/cosf/expf/logf stay the accurate library functions.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("render.cu",)
HEADERS = ("trace.cuh",)


class RenderParams(ctypes.Structure):
    """ctypes mirror of tpt::RenderParams (csrc/trace.cuh), field for
    field."""
    _fields_ = [
        ("x0", ctypes.c_int32), ("y0", ctypes.c_int32),
        ("height", ctypes.c_int32), ("width", ctypes.c_int32),
        ("frame", ctypes.c_uint32),
        ("spp", ctypes.c_int32), ("max_depth", ctypes.c_int32),
        ("light_sampling", ctypes.c_int32), ("mitsuba", ctypes.c_int32),
        ("n_spheres", ctypes.c_int32), ("n_lights", ctypes.c_int32),
        ("inv_w", ctypes.c_float), ("inv_h", ctypes.c_float),
        ("inv_spp", ctypes.c_float),
        ("t_min", ctypes.c_float), ("t_max", ctypes.c_float),
    ]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels are built at first use")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile csrc/ into build/torch_kernels/libtpt_render_<hash>.so
    unless that file exists; returns its path.  The compile goes to a
    temporary name and is renamed into place, so concurrent processes
    never load a half-written library."""
    out = BUILD_DIR / f"libtpt_render_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C
    interface of csrc/render.cu."""
    lib = ctypes.CDLL(str(build()))
    ptr = ctypes.c_void_p
    lib.tpt_render_launch.argtypes = [ptr, ptr, ptr, ptr,
                                      ctypes.POINTER(RenderParams),
                                      ptr, ptr, ptr]
    lib.tpt_render_launch.restype = ctypes.c_int
    lib.tpt_error_string.argtypes = [ctypes.c_int]
    lib.tpt_error_string.restype = ctypes.c_char_p
    return lib
