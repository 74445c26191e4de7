"""Thin-lens camera (reference: Cpp/Source/Maths.h:414-450; counterpart of
toypathtracer_tpu/camera.py).

`make_camera` precomputes the derived frame (origin, lowerLeftCorner,
horizontal, vertical, u/v/w basis, lensRadius) on the host in float32,
in the same operation order as the JAX package, so both packages hand
their renderers the same 22 floats.
"""

from __future__ import annotations

import numpy as np

from .config import KPI
from .scene import CameraSpec

_F = np.float32
_NAMES = ("origin", "lower_left", "horizontal", "vertical", "u", "v", "w")


def _v(t):
    return tuple(_F(x) for x in t)


def _norm(a):
    inv = _F(1.0) / np.sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2])
    return (a[0] * inv, a[1] * inv, a[2] * inv)


def _cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        -(a[0] * b[2] - a[2] * b[0]),
        a[0] * b[1] - a[1] * b[0],
    )


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def make_camera(spec: CameraSpec, aspect: float) -> dict:
    """Build the camera dict of float32 scalars (reference:
    Maths.h:418-435)."""
    look_from = _v(spec.look_from)
    look_at = _v(spec.look_at)
    vup = _v(spec.vup)
    focus = _F(spec.focus_dist)
    lens_radius = _F(spec.aperture / 2.0)
    theta = _F(spec.vfov) * _F(KPI / 180.0)
    half_height = np.tan(theta / _F(2.0))
    half_width = _F(aspect) * half_height
    origin = look_from
    w = _norm(_sub(look_from, look_at))
    u = _norm(_cross(vup, w))
    v = _cross(w, u)
    lower_left = _sub(
        _sub(_sub(origin, _scale(u, half_width * focus)),
             _scale(v, half_height * focus)),
        _scale(w, focus),
    )
    horizontal = _scale(u, _F(2.0) * half_width * focus)
    vertical = _scale(v, _F(2.0) * half_height * focus)
    return dict(origin=origin, lower_left=lower_left, horizontal=horizontal,
                vertical=vertical, u=u, v=v, w=w, lens_radius=lens_radius)


def camera_to_array(cam: dict) -> np.ndarray:
    """Flatten the camera dict to the (22,) float32 layout the kernels read
    (the analog of the reference's 88-byte Camera upload,
    TestWin.cpp:132-134)."""
    parts = []
    for k in _NAMES:
        parts.extend(cam[k])
    parts.append(cam["lens_radius"])
    return np.array(parts, dtype=np.float32)


def camera_from_array(arr) -> dict:
    """Inverse of camera_to_array; the values stay float32 scalars."""
    a = np.asarray(arr, dtype=np.float32)
    cam = {k: (a[3 * j], a[3 * j + 1], a[3 * j + 2])
           for j, k in enumerate(_NAMES)}
    cam["lens_radius"] = a[21]
    return cam
