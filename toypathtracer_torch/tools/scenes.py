"""Scenes the measurements and tests build beyond make_scene's two."""

from __future__ import annotations

import numpy as np
import torch

from ..scene import Scene, make_scene


def crowded_scene(extra: int = 84, seed: int = 3) -> Scene:
    """make_scene(big=True) with `extra` small spheres appended on the
    floor in front of the camera (130 spheres by default): Lambert, metal
    and dielectric in turn, albedos and roughness from a seeded numpy
    generator.  More spheres than the gradient kernel's replaying form
    takes (64); its warp form takes up to 512."""
    scene = make_scene(big=True)
    rng = np.random.RandomState(seed)
    idx = np.arange(extra)
    cen = np.stack([-3.3 + 0.6 * (idx % 12), np.full(extra, -0.38),
                    -2.2 + 0.55 * (idx // 12)], 1)

    def cat(field, new):
        return torch.cat([getattr(scene, field),
                          torch.as_tensor(new, dtype=torch.float32)])
    return scene.replace(
        center=cat("center", cen),
        radius=cat("radius", np.full(extra, 0.12)),
        albedo=cat("albedo", rng.uniform(0.2, 0.9, (extra, 3))),
        emissive=cat("emissive", np.zeros((extra, 3))),
        roughness=cat("roughness", rng.uniform(0.0, 0.5, extra)),
        ri=cat("ri", np.where(idx % 3 == 2, 1.5, 0.0)),
        mat_type=scene.mat_type + tuple(int(i % 3) for i in idx))
