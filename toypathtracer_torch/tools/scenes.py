"""Scenes the measurements and tests build beyond make_scene's two."""

from __future__ import annotations

import numpy as np
import torch

from ..scene import CameraSpec, Scene, make_scene, scene_from_arrays


def crowded_scene(extra: int = 84, seed: int = 3) -> Scene:
    """make_scene(big=True) with `extra` small spheres appended on the
    floor in front of the camera (130 spheres by default): Lambert, metal
    and dielectric in turn, albedos and roughness from a seeded numpy
    generator.  More spheres than the gradient kernel's replaying form
    takes (64); its warp form takes up to 512, and with extra=554 (600
    spheres) the route takes its pool form."""
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


def shadow_boundary_scene() -> Scene:
    """Five spheres that put every case of the soft shadow boundary on
    screen: a Lambert floor, a glass sphere sunk into it, a Lambert
    occluder and a metal sphere beside it, and a light low on the right.
    Shadow rays from the floor behind the occluder and the glass are
    occluded with the occluder in the segment (d_occ > 0: the soft term
    applies to an unseen light); those from the floor inside the glass,
    on its side toward the light, are occluded by the glass (the
    interval-overlap test sees it span the segment) while its closest
    approach lies behind them (d_occ < 0): the test and the sign of d_occ
    disagree and the hard value stands.  At 32x16, spp 2, depth 4, frame 1
    the plain version's shadow rays: 324 occluded with the term, 5
    disagreeing, 382 seen."""
    return scene_from_arrays(
        center=[[0.0, -100.5, -1.0], [0.0, -0.3, -1.0], [-1.1, -0.2, -1.3],
                [0.9, -0.1, -0.4], [2.2, 0.4, -1.0]],
        radius=[100.0, 0.5, 0.3, 0.3, 0.25],
        albedo=[[0.8, 0.8, 0.8], [1.0, 1.0, 1.0], [0.7, 0.3, 0.2],
                [0.6, 0.6, 0.9], [0.1, 0.1, 0.1]],
        emissive=[[0.0, 0.0, 0.0]] * 4 + [[8.0, 7.0, 6.0]],
        roughness=[0.0, 0.0, 0.0, 0.2, 0.0], ri=[0.0, 1.5, 0.0, 0.0, 0.0],
        mat_type=[0, 2, 0, 1, 0], emissive_ids=[4],
        camera=CameraSpec(look_from=(0.0, 0.6, 1.2),
                          look_at=(0.2, -0.2, -1.0), aperture=0.0))
