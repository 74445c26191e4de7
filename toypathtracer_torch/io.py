"""Image output: sRGB encoding and TGA/PNG writers (counterpart of
toypathtracer_tpu/io.py).

  * exact sRGB curve `1.055 x^(1/2.4) - 0.055` as the C# CLI's TGA dump
    (reference: Cs/Program.cs:34-59) and the D3D/Metal blit shaders;
  * cheap `sqrt` sRGB as the WASM frontend (Emscripten/main.cpp:63-79).

Images arrive as (H, W, 3) float32 linear radiance with row 0 at the
bottom (the reference backbuffer layout, Test.cpp:278-297); both writers
flip vertically so files read top-down.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def linear_to_srgb(img: np.ndarray) -> np.ndarray:
    """Exact sRGB transfer curve (Cs/Program.cs:40-47): linear part below
    0.0031308."""
    x = np.clip(np.asarray(img, dtype=np.float32), 0.0, 1.0)
    lo = x * 12.92
    hi = 1.055 * np.power(x, 1.0 / 2.4, where=x > 0,
                          out=np.zeros_like(x)) - 0.055
    return np.where(x <= 0.0031308, lo, hi)


def linear_to_srgb_cheap(img: np.ndarray) -> np.ndarray:
    """sqrt approximation (Emscripten/main.cpp:69-71)."""
    return np.sqrt(np.clip(np.asarray(img, dtype=np.float32), 0.0, 1.0))


def to_u8(img: np.ndarray, cheap: bool = False) -> np.ndarray:
    """(H, W, 3) linear bottom-up float -> (H, W, 3) uint8 top-down sRGB,
    by the native C++ encoder (native.py) where it builds, else numpy:
    the same curve (tests/test_torch_native.py)."""
    from . import native
    out = native.srgb_encode(img, cheap=cheap)
    if out is not None:
        return out
    srgb = linear_to_srgb_cheap(img) if cheap else linear_to_srgb(img)
    u8 = np.clip(srgb * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
    return u8[::-1]


def write_tga(path: str, img: np.ndarray, cheap_srgb: bool = False) -> None:
    """Uncompressed 32-bit BGRA TGA, alpha 255, bottom-up rows: the
    reference CLI's dump byte for byte (Cs/Program.cs:34-59)."""
    u8 = to_u8(img, cheap=cheap_srgb)[::-1]
    h, w, _ = u8.shape
    header = struct.pack(
        "<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h, 32, 0)
    bgra = np.concatenate(
        [u8[:, :, ::-1], np.full((h, w, 1), 255, np.uint8)], axis=-1)
    with open(path, "wb") as f:
        f.write(header)
        f.write(bgra.tobytes())


def png_encode(u8: np.ndarray) -> bytes:
    """Minimal stdlib PNG encoder: 8-bit RGB, filter 0, one zlib IDAT."""
    h, w, _ = u8.shape
    raw = b"".join(b"\x00" + u8[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def png_bytes(img: np.ndarray, cheap_srgb: bool = False) -> bytes:
    """(H, W, 3) linear bottom-up float -> PNG file bytes."""
    return png_encode(to_u8(img, cheap=cheap_srgb))


def write_png(path: str, img: np.ndarray, cheap_srgb: bool = False) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img, cheap_srgb=cheap_srgb))


def write_image(path: str, img: np.ndarray, cheap_srgb: bool = False) -> None:
    if path.lower().endswith(".tga"):
        write_tga(path, img, cheap_srgb=cheap_srgb)
    else:
        write_png(path, img, cheap_srgb=cheap_srgb)
