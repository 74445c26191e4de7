"""Build the CUDA sources of csrc/ with nvcc at first use and load them
with ctypes; build_host does the same with g++ for a host C++ source.

The library is a plain C interface (no PyTorch headers), so nvcc takes
seconds.  Each source compiles in its own nvcc process, all started
together, and one more links them.  The library lands in
build/torch_kernels/ at the root of the checkout, named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  Nothing is built or loaded at import time.  A failed
build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
HOST_BUILD_DIR = BUILD_DIR.parent / "torch_host"

# -fmad=false: no FMA contraction, so the kernel rounds every product and
# sum as the plain PyTorch version does (see PERF.md).  No --use_fast_math:
# sinf/cosf/expf/logf stay the accurate library functions.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")
SOURCES = ("render.cu", "grad.cu", "scaled.cu", "chunkgrad.cu", "wavegrad.cu",
           "wavesweep.cu", "probe.cu")
HEADERS = ("trace.cuh", "warp.cuh", "merged.cuh", "flat.cuh", "gradwarp.cuh",
           "chunks.cuh", "coop.cuh", "coopgrad.cuh", "tape.cuh",
           "wavesweep.cuh", "probe.cuh", "launch.cuh")


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
        ("soft_eps", ctypes.c_float),
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
    """Compile csrc/ into build/torch_kernels/libtpt_kernels_<hash>.so
    unless that file exists; returns its path.  The objects and the
    library are written in a temporary directory and the library is
    renamed into place, so concurrent processes never load a half-written
    one.  verbose: compile with -Xptxas -v (rebuilding where that report
    is missing), print the compilers' output and keep it beside the
    library for ptxas_usage."""
    out = BUILD_DIR / f"libtpt_kernels_{_digest()}.so"
    report = out.with_suffix(".ptxas.txt")
    if out.exists() and (report.exists() or not verbose):
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in SOURCES:
            cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-c", "-o", os.path.join(tmp, src + ".o"), str(CSRC / src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs = []
        for cmd, proc in jobs:
            stdout, stderr = proc.communicate()
            logs.append((cmd, proc.returncode, stdout, stderr))
        so = os.path.join(tmp, "lib.so")
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", so,
                *(os.path.join(tmp, src + ".o") for src in SOURCES)]
        if all(rc == 0 for _, rc, _, _ in logs):
            proc = subprocess.run(link, capture_output=True, text=True)
            logs.append((link, proc.returncode, proc.stdout, proc.stderr))
        for cmd, rc, stdout, stderr in logs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n"
                                   f"{stdout}{stderr}")
        if verbose:
            text = "".join(o + e for _, _, o, e in logs)
            print(text, flush=True)
            report.write_text(text)
        os.replace(so, out)
    return out


def build_host(name: str, source: Path, flags=("-O2",)) -> Path:
    """Compile one host C++ source with g++ into
    build/torch_host/lib<name>_<hash>.so unless that file exists (the hash
    of the source and the flags); returns its path.  Written to a
    temporary file beside it and renamed into place, so that concurrent
    processes (pytest-xdist workers) never load a half-written library.
    Raises where g++ is missing or fails."""
    source = Path(source)
    flags = (*flags, "-fPIC", "-shared")
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(source.read_bytes())
    out = HOST_BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {source.name} is built at "
                           "first use")
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=HOST_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([gxx, *flags, "-o", tmp, str(source)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on "
                               f"{source}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def ptxas_usage(text: str) -> dict:
    """Registers, stack and spill bytes per kernel from `nvcc -Xptxas -v`
    output (build(verbose=True) keeps it as <library>.ptxas.txt): {label:
    {"registers", "stack", "spill_stores", "spill_loads"}}, the label the
    kernel's name with its template arguments, e.g.
    "coop_render_kernel<0>"."""
    usage, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            name = m.group(1)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            usage.setdefault(name, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage.setdefault(name, {})["registers"] = int(m.group(1))
    out = {}
    for mangled, u in usage.items():
        label = kernel_label(mangled)
        if "registers" in u and label is not None:
            out[label] = u
    return out


def kernel_label(mangled: str):
    """A kernel's name with its template arguments from its mangled name,
    e.g. "coop_render_kernel<0>"; None if it is not a mangled name."""
    # _ZN <length><name>... : the last name of the nested name, then its
    # template arguments
    pos, label = 3 if mangled.startswith("_ZN") else 2, None
    while True:
        m = re.match(r"\d+", mangled[pos:])
        if not m:
            break
        start = pos + m.end()
        pos = start + int(m.group())
        label = mangled[start:pos]
    if label is None:
        return None
    targs = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[pos:])
    if targs:
        label += "<" + ",".join(re.findall(r"\d+", targs.group(1))) + ">"
    return label


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C
    interface of csrc/render.cu, grad.cu, scaled.cu, chunkgrad.cu,
    wavegrad.cu, wavesweep.cu and probe.cu."""
    lib = ctypes.CDLL(str(build()))
    ptr = ctypes.c_void_p
    params = ctypes.POINTER(RenderParams)
    i32, f32 = ctypes.c_int, ctypes.c_float
    lib.tpt_render_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, params, ptr,
                                      ptr, ptr, ptr, ptr]
    lib.tpt_render_tape_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, params,
                                           ptr, ptr, ptr, ptr, ptr, ptr, i32,
                                           ptr]
    lib.tpt_wave_sweep_launch.argtypes = [ptr, ptr, ptr, params, ptr, i32,
                                          ptr, ptr, ptr, ptr, ptr, ptr]
    lib.tpt_wave_sweep_pool_launch.argtypes = [ptr, ptr, ptr, params, ptr,
                                               i32, ptr, ptr, ptr, ptr, ptr,
                                               ptr, i32, ptr, ptr, i32, ptr]
    lib.tpt_wave_run_scratch.argtypes = [params, ptr]
    lib.tpt_wave_run_launch.argtypes = [ptr, ptr, ptr, params, ptr, i32, i32,
                                        ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.tpt_wave_run_pool_launch.argtypes = [ptr, ptr, ptr, params, ptr, i32,
                                             ptr, ptr, ptr, ptr, ptr, ptr,
                                             i32, ptr, ptr, i32, ptr]
    lib.tpt_render_thread_launch.argtypes = [ptr, ptr, ptr, ptr, params, ptr,
                                             ptr, ptr, ptr]
    lib.tpt_render_stats_launch.argtypes = [ptr, ptr, ptr, ptr, params, ptr,
                                            ptr, i32, i32, ptr, ptr, ptr]
    lib.tpt_render_stats_merged_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, params, ptr, ptr, ptr, i32, i32, ptr, ptr,
        ptr, ptr]
    lib.tpt_lockstep_launch.argtypes = [ptr, ptr, ptr, ptr, params, ptr, ptr,
                                        ptr]
    lib.tpt_grad_launch.argtypes = [ptr, ptr, ptr, ptr, params, ptr, ptr, ptr,
                                    i32, ptr, ptr, ptr, i32, ptr, ptr]
    lib.tpt_grad_scratch.argtypes = [params, i32, ptr, ptr]
    lib.tpt_grad_sum_launch.argtypes = [ptr, i32, i32, ptr, i32, ptr]
    lib.tpt_grad_pool_scratch.argtypes = [params, i32, ptr, ptr]
    lib.tpt_grad_pool_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                         ptr, i32, i32, params, ptr, ptr, ptr,
                                         i32, ptr, ptr, ptr, ptr, i32, ptr,
                                         ptr, i32, ptr, ptr]
    lib.tpt_grad_pool_sum_launch.argtypes = [ptr, ptr, ptr, i32, i32, ptr,
                                             ptr]
    lib.tpt_grad_dir_ids.argtypes = []
    lib.tpt_hit_chunks_launch.argtypes = [ptr, i32, i32, ptr, ptr, i32, f32,
                                          f32, ptr, ptr, ptr, ptr]
    lib.tpt_coop_hit_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr,
                                        ptr, i32, f32, f32, ptr, ptr, ptr,
                                        ptr, ptr]
    lib.tpt_shadow_chunks_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32,
                                             ptr, ptr, ptr, ptr, i32, i32,
                                             f32, i32, ptr, ptr, ptr, ptr]
    lib.tpt_scaled_render_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                             params, i32, i32, i32, ptr, ptr,
                                             ptr, ptr, ptr, ptr, ptr, ptr]
    lib.tpt_chunk_sweep_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32,
        i32, i32, params, ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, ptr,
        ptr, i32, ptr]
    lib.tpt_scaled_groups.argtypes = [i32]
    lib.tpt_probe_launch.argtypes = [i32, i32, i32, ptr, ptr]
    for fn in (lib.tpt_render_launch, lib.tpt_render_tape_launch,
               lib.tpt_wave_sweep_launch, lib.tpt_wave_sweep_pool_launch,
               lib.tpt_wave_run_scratch, lib.tpt_wave_run_launch,
               lib.tpt_wave_run_pool_launch,
               lib.tpt_render_thread_launch,
               lib.tpt_render_stats_launch,
               lib.tpt_render_stats_merged_launch, lib.tpt_lockstep_launch,
               lib.tpt_grad_launch, lib.tpt_grad_scratch,
               lib.tpt_grad_sum_launch, lib.tpt_grad_pool_scratch,
               lib.tpt_grad_pool_launch, lib.tpt_grad_pool_sum_launch,
               lib.tpt_grad_dir_ids,
               lib.tpt_hit_chunks_launch,
               lib.tpt_coop_hit_launch,
               lib.tpt_shadow_chunks_launch, lib.tpt_scaled_render_launch,
               lib.tpt_chunk_sweep_launch,
               lib.tpt_scaled_groups, lib.tpt_probe_launch):
        fn.restype = ctypes.c_int
    lib.tpt_error_string.argtypes = [ctypes.c_int]
    lib.tpt_error_string.restype = ctypes.c_char_p
    return lib
