"""ctypes binding of the native host-runtime library native/tptnative.cpp
(counterpart of toypathtracer_tpu/native.py).

The presentation and validation routines in C++: exact sRGB encode
(reference: Cs/Program.cs:40-47, PixelShader.hlsl:1-15), the TGA payload,
image metrics and the progressive blend.  The library is built with g++
from the in-repo source at first use into build/torch_host/ (never into
the JAX package's directory), written to a temporary file and renamed into
place, so concurrent processes never load a half-written one
(ops/_build.build_host).  Where no compiler is found every entry point
falls back to io.py's numpy version, as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import numpy as np

from .ops import _build

SOURCE = Path(__file__).resolve().parents[1] / "native" / "tptnative.cpp"


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    if not SOURCE.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_build.build_host("tptnative", SOURCE,
                                                ("-O3",))))
    except (RuntimeError, OSError):
        return None
    c_f32p = ctypes.POINTER(ctypes.c_float)
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_f64p = ctypes.POINTER(ctypes.c_double)
    lib.tpt_srgb_encode.argtypes = [c_f32p, ctypes.c_int, ctypes.c_int,
                                    c_u8p, ctypes.c_int]
    lib.tpt_srgb_encode_tga.argtypes = lib.tpt_srgb_encode.argtypes
    lib.tpt_image_metrics.argtypes = [c_f32p, c_f32p, ctypes.c_int64,
                                      ctypes.c_float, c_f64p]
    lib.tpt_progressive_blend.argtypes = [c_f32p, c_f32p, ctypes.c_int64,
                                          ctypes.c_float]
    for fn in ("tpt_srgb_encode", "tpt_srgb_encode_tga", "tpt_image_metrics",
               "tpt_progressive_blend", "tpt_version"):
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def available() -> bool:
    return _load() is not None


def _f32c(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _encode(fn: str, img, cheap: bool) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    img = _f32c(img)
    h, w, _ = img.shape
    out = np.empty((h, w, 3), np.uint8)
    rc = getattr(lib, fn)(_ptr(img, ctypes.c_float), h, w,
                          _ptr(out, ctypes.c_uint8), int(cheap))
    return out if rc == 0 else None


def srgb_encode(img, cheap: bool = False) -> Optional[np.ndarray]:
    """(H, W, 3) linear bottom-up float -> (H, W, 3) uint8 top-down sRGB;
    None without the library."""
    return _encode("tpt_srgb_encode", img, cheap)


def srgb_encode_tga(img, cheap: bool = False) -> Optional[np.ndarray]:
    """(H, W, 3) linear bottom-up float -> bottom-up BGR uint8 (the TGA
    payload's byte order); None without the library."""
    return _encode("tpt_srgb_encode_tga", img, cheap)


def image_metrics(a, b, tol: float = 1e-5) -> dict:
    """dict(max_abs, mean_abs, rmse, n_over_tol) comparing two images."""
    af, bf = _f32c(a).ravel(), _f32c(b).ravel()
    if af.shape != bf.shape:
        raise ValueError(f"shapes differ: {af.shape} vs {bf.shape}")
    lib = _load()
    if lib is not None:
        out = np.zeros(4, np.float64)
        rc = lib.tpt_image_metrics(_ptr(af, ctypes.c_float),
                                   _ptr(bf, ctypes.c_float), af.size, tol,
                                   _ptr(out, ctypes.c_double))
        if rc == 0:
            return dict(max_abs=out[0], mean_abs=out[1], rmse=out[2],
                        n_over_tol=int(out[3]))
    d = np.abs(af.astype(np.float64) - bf.astype(np.float64))
    return dict(max_abs=d.max(), mean_abs=d.mean(),
                rmse=float(np.sqrt((d * d).mean())),
                n_over_tol=int((d > tol).sum()))


def progressive_blend(accum, frame, fac: float) -> np.ndarray:
    """Host-side blend (Test.cpp:272-276 with the Metal port's NaN guard)
    into a fresh array: prev * fac + frame * (1 - fac), non-finite history
    zeroed first."""
    lib = _load()
    accum = _f32c(accum)
    framef = _f32c(frame)
    if lib is not None:
        accum = accum.copy()
        rc = lib.tpt_progressive_blend(_ptr(accum, ctypes.c_float),
                                       _ptr(framef, ctypes.c_float),
                                       accum.size, float(fac))
        if rc == 0:
            return accum
    prev = np.where(np.isfinite(accum), accum, 0.0)
    return prev * fac + framef * (1.0 - fac)
