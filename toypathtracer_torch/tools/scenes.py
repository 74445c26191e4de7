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


def _lit(scene: Scene, ids, seed: int) -> Scene:
    """`scene` with the spheres `ids` made dim lights of colours from a
    seeded numpy generator."""
    rng = np.random.RandomState(seed)
    emissive = scene.emissive.clone()
    emissive[torch.as_tensor(ids)] = torch.as_tensor(
        rng.uniform(0.5, 3.0, (len(ids), 3)), dtype=torch.float32)
    lights = tuple(sorted(scene.emissive_ids + tuple(int(i) for i in ids)))
    return scene.replace(emissive=emissive, emissive_ids=lights)


def many_lights_scene(n_lights: int = 40, seed: int = 5) -> Scene:
    """crowded_scene (130 spheres) with n_lights - 2 of its appended
    spheres made emissive beside make_scene's two lights: more lights than
    the gradient kernel's 16-light instances keep in their carry records
    (40 by default, past a word of 32 too), each a dim light of a colour
    from a seeded numpy generator, so that every light's NEE term and its
    gradient are on screen."""
    scene = crowded_scene()
    extra = n_lights - len(scene.emissive_ids)
    return _lit(scene, 46 + np.arange(extra) * (84 // extra), seed)


def few_spheres_many_lights_scene(n_lights: int = 17,
                                  seed: int = 5) -> Scene:
    """make_scene(big=False) (9 spheres, one light) with n_lights - 1 of
    crowded_scene's small floor spheres appended, each a dim light of a
    seeded colour: 17 lights by default, one past the 16 that the gradient
    kernel's 16-light instances keep in a carry record, in a scene small
    enough for the JAX package's jax.grad of its render to compile on a
    CPU core in a couple of minutes (its time grows with the lights)."""
    small = make_scene(big=False)
    extra = n_lights - len(small.emissive_ids)
    floor = crowded_scene(extra=extra)
    fields = ("center", "radius", "albedo", "emissive", "roughness", "ri")
    scene = small.replace(
        **{f: torch.cat([getattr(small, f), getattr(floor, f)[46:]])
           for f in fields},
        mat_type=small.mat_type + floor.mat_type[46:])
    return _lit(scene, small.n_spheres + np.arange(extra), seed)
