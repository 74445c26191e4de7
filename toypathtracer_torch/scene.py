"""Scene description: spheres and materials as float32 tensors
(counterpart of toypathtracer_tpu/scene.py).

The per-sphere parameter tensors are the scene's "weights"; sphere count,
material types, the emissive index list and the camera are static
metadata.  `scene_from_arrays`, `scene_to_arrays` and `load_scene_npz`
carry a scene across from the JAX package (its `checkpoint.save_scene`
layout) with numpy alone.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Tuple

import numpy as np
import torch

from .config import resolve_device

MAT_LAMBERT = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2

_FIELDS = ("center", "radius", "albedo", "emissive", "roughness", "ri")


@dataclasses.dataclass(frozen=True)
class CameraSpec:
    """Static camera parameters (reference: Test.cpp:309-319, 341)."""

    look_from: Tuple[float, float, float] = (0.0, 2.0, 3.0)
    look_at: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    vup: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    vfov: float = 60.0
    aperture: float = 0.02  # 0.1 * 0.2 for the big scene (Test.cpp:315-319)
    focus_dist: float = 3.0


@dataclasses.dataclass(frozen=True)
class Scene:
    """Spheres and materials (reference: Test.cpp:36-44, Maths.h:354-364).

    Tensor fields are float32 on one device; the rest is static."""

    center: torch.Tensor     # (N, 3)
    radius: torch.Tensor     # (N,)
    albedo: torch.Tensor     # (N, 3)
    emissive: torch.Tensor   # (N, 3)
    roughness: torch.Tensor  # (N,)
    ri: torch.Tensor         # (N,)  index of refraction (dielectrics)

    mat_type: Tuple[int, ...]
    emissive_ids: Tuple[int, ...]
    camera: CameraSpec

    @property
    def n_spheres(self) -> int:
        return len(self.mat_type)

    @property
    def device(self) -> torch.device:
        return self.center.device

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Scene":
        return self.replace(**{k: getattr(self, k).to(device)
                               for k in _FIELDS})

    def animate(self, time) -> "Scene":
        """Reference animation: sphere 1 bobs in y, sphere 8 sways in z
        (reference: Test.cpp:304-308).  `time` is computed in float32; a
        tensor `time` carries its gradient into the centers."""
        t = animation_time(time, self.center.device)
        center = self.center.clone()
        center[1, 1] = torch.cos(t) + 1.0
        center[8, 2] = torch.sin(t) * 0.3
        return self.replace(center=center)


def animation_time(time, device) -> torch.Tensor:
    """`time` as a 0-d float32 tensor on `device`: a tensor keeps its
    autograd graph, a Python or numpy number is rounded to float32 once."""
    if isinstance(time, torch.Tensor):
        return time.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(np.float32(time)), dtype=torch.float32,
                      device=device)


def _base_scene_rows():
    """The 9-sphere base scene (reference: Test.cpp:15-23, 48-56)."""
    spheres = [
        ((0, -100.5, -1), 100.0),
        ((2, 0, -1), 0.5),
        ((0, 0, -1), 0.5),
        ((-2, 0, -1), 0.5),
        ((2, 0, 1), 0.5),
        ((0, 0, 1), 0.5),
        ((-2, 0, 1), 0.5),
        ((0.5, 1, 0.5), 0.5),
        ((-1.5, 1.5, 0.0), 0.3),
    ]
    # (type, albedo, emissive, roughness, ri)
    mats = [
        (MAT_LAMBERT, (0.8, 0.8, 0.8), (0, 0, 0), 0.0, 0.0),
        (MAT_LAMBERT, (0.8, 0.4, 0.4), (0, 0, 0), 0.0, 0.0),
        (MAT_LAMBERT, (0.4, 0.8, 0.4), (0, 0, 0), 0.0, 0.0),
        (MAT_METAL, (0.4, 0.4, 0.8), (0, 0, 0), 0.0, 0.0),
        (MAT_METAL, (0.4, 0.8, 0.4), (0, 0, 0), 0.0, 0.0),
        (MAT_METAL, (0.4, 0.8, 0.4), (0, 0, 0), 0.2, 0.0),
        (MAT_METAL, (0.4, 0.8, 0.4), (0, 0, 0), 0.6, 0.0),
        (MAT_DIELECTRIC, (0.4, 0.4, 0.4), (0, 0, 0), 0.0, 1.5),
        (MAT_LAMBERT, (0.8, 0.6, 0.2), (30, 25, 15), 0.0, 0.0),
    ]
    return spheres, mats


def _big_scene_rows():
    """The 46-sphere big scene (reference: Test.cpp:24-30, 57-63): 36 grid
    spheres in 4 rows of 9 plus a second emissive sphere."""
    spheres, mats = _base_scene_rows()
    for z in (-3, -4, -5, -6):
        for x in (4, 3, 2, 1, 0, -1, -2, -3, -4):
            spheres.append(((float(x), 0.0, float(z)), 0.5))
    spheres.append(((1.5, 1.5, -2.0), 0.3))

    grays = [(0.1 * k,) * 3 for k in range(1, 10)]
    colors = [
        (0.8, 0.1, 0.1), (0.8, 0.5, 0.1), (0.8, 0.8, 0.1),
        (0.4, 0.8, 0.1), (0.1, 0.8, 0.1), (0.1, 0.8, 0.5),
        (0.1, 0.8, 0.8), (0.1, 0.1, 0.8), (0.5, 0.1, 0.8),
    ]
    for alb in grays:
        mats.append((MAT_LAMBERT, alb, (0, 0, 0), 0.0, 0.0))
    for alb in grays:
        mats.append((MAT_METAL, alb, (0, 0, 0), 0.0, 0.0))
    for alb in colors:
        mats.append((MAT_METAL, alb, (0, 0, 0), 0.0, 0.0))
    for alb in colors[:-1]:
        mats.append((MAT_LAMBERT, alb, (0, 0, 0), 0.0, 0.0))
    mats.append((MAT_METAL, colors[-1], (0, 0, 0), 0.0, 0.0))
    mats.append((MAT_LAMBERT, (0.1, 0.2, 0.5), (3, 10, 20), 0.0, 0.0))
    return spheres, mats


def _emissive_ids(emissive: np.ndarray) -> Tuple[int, ...]:
    """Emissive sphere index list (reference: Test.cpp:332-338)."""
    return tuple(i for i in range(emissive.shape[0])
                 if (emissive[i] > 0).any())


def scene_from_arrays(center, radius, albedo, emissive, roughness, ri,
                      mat_type, emissive_ids, camera: CameraSpec,
                      device="cpu") -> Scene:
    """Build a Scene from array-likes (numpy, lists, tensors) plus its
    static metadata."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32),
                               device=device)
    return Scene(center=f32(center), radius=f32(radius), albedo=f32(albedo),
                 emissive=f32(emissive), roughness=f32(roughness), ri=f32(ri),
                 mat_type=tuple(int(m) for m in mat_type),
                 emissive_ids=tuple(int(e) for e in emissive_ids),
                 camera=camera)


def scene_to_arrays(scene: Scene) -> dict:
    """Inverse of scene_from_arrays: numpy float32 fields plus the static
    metadata, keyed by scene_from_arrays' argument names."""
    out = {k: getattr(scene, k).detach().cpu().numpy() for k in _FIELDS}
    out.update(mat_type=scene.mat_type, emissive_ids=scene.emissive_ids,
               camera=scene.camera)
    return out


def load_scene_npz(path: str, device="cuda") -> Scene:
    """Read a scene saved by the JAX package's checkpoint.save_scene: six
    float arrays plus a JSON `meta` record (mat_type, emissive_ids,
    camera) stored as uint8 bytes, onto `device`: the card unless "cpu"
    is asked for."""
    device = resolve_device(device)
    with np.load(path) as d:
        meta = json.loads(bytes(d["meta"]).decode())
        fields = {k: d[k] for k in _FIELDS}
    cam = dict(meta["camera"])
    for k in ("look_from", "look_at", "vup"):
        cam[k] = tuple(cam[k])
    return scene_from_arrays(**fields, mat_type=meta["mat_type"],
                             emissive_ids=meta["emissive_ids"],
                             camera=CameraSpec(**cam), device=device)


def _build(spheres, mats, camera: CameraSpec) -> Scene:
    emissive = np.array([m[2] for m in mats], dtype=np.float32)
    return scene_from_arrays(
        center=[s[0] for s in spheres], radius=[s[1] for s in spheres],
        albedo=[m[1] for m in mats], emissive=emissive,
        roughness=[m[3] for m in mats], ri=[m[4] for m in mats],
        mat_type=[m[0] for m in mats], emissive_ids=_emissive_ids(emissive),
        camera=camera)


def make_scene(big: bool = True, mitsuba_compare: bool = False) -> Scene:
    """Build the reference scene on the CPU (move it with `Scene.to`).

    big=True  -> 46 spheres, 2 emissive (DO_BIG_SCENE=1, Test.cpp:11)
    big=False -> 9 spheres, 1 emissive

    Aperture: 0.1 base, 0 under mitsuba-compare, x0.2 for the big scene
    (reference: Test.cpp:311-319).
    """
    aperture = 0.0 if mitsuba_compare else 0.1
    if big:
        aperture *= 0.2
        spheres, mats = _big_scene_rows()
    else:
        spheres, mats = _base_scene_rows()
    return _build(spheres, mats, CameraSpec(aperture=aperture))


def validate_scene(scene: Scene) -> None:
    """Warn when an emissive sphere's surface is embedded in (or overlaps)
    another sphere: the renderer's interval-overlap shadow test
    (ops/tracecore.occ_test) then reports "occluded" where the reference's
    nearest-valid-root rule reports "visible", darkening NEE.  Impossible
    in the shipped scenes (spheres at most tangent, Test.cpp:13-31)."""
    c = scene.center.detach().cpu().numpy().astype(np.float64)
    r = scene.radius.detach().cpu().numpy().astype(np.float64)
    for e in scene.emissive_ids:
        d = np.sqrt(((c - c[e]) ** 2).sum(axis=1))
        over = (d < r + r[e] - 1e-12)
        over[e] = False
        if over.any():
            j = int(np.argmax(over))
            warnings.warn(
                f"emissive sphere {e} overlaps sphere {j} "
                f"(center distance {d[j]:.4g} < r_sum {r[j] + r[e]:.4g}): "
                "the interval-overlap shadow test darkens NEE for shadow "
                "rays starting inside the overlap", stacklevel=2)


def recompute_emissive_ids(scene: Scene) -> Scene:
    """Rebuild the emissive index list from the current emissive values
    (reference: Test.cpp:321-338).  Call after editing `emissive`."""
    em = scene.emissive.detach().cpu().numpy()
    return scene.replace(emissive_ids=_emissive_ids(em))
