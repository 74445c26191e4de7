"""Where the port's plain render and the JAX package's jnp render part, and
why: the readings behind the image gates of
tests/test_torch_render.py::test_render_beyond_512_spheres_matches_jax.

    JAX_PLATFORMS=cpu python tests/torch_jax_rounding.py

prints JSON lines, on the CPU at tiny sizes (about a minute):
  * `contraction`: the share of a jitted `a * b - c` (float32) that XLA's
    CPU code rounds once, as a fused multiply-add, and the share rounded
    twice, as IEEE float32 without contraction (the port's plain version
    and the kernels, built with -fmad=false);
  * `soft_gradient`: the soft-silhouette gradient of the port's plain
    version against `jax.grad` at tests/test_pallas_grad.py's soft
    configuration (the small scene, 16x8, spp 2, depth 3, eps 0.02, the
    RandomState(0) cotangent), per field max |diff| / max |jax.grad|: the
    sigmoids' 1/eps amplifies the rounding differences near silhouettes;
  * `render`: for the 46- and the 600-sphere scene (tools/scenes.py
    crowded_scene(extra=554)) at a few sizes and frames (spp 1, depth 3),
    the port's plain render against JAX's `render_frame`: rays, pixels
    beyond 1e-4, max and mean |diff|, pixels equal; and at the pixels
    beyond 1e-4, the mean |diff| of each side from a float64 evaluation of
    the same paths (tracecore in float64 from the same float32 scene and
    random draws).
Then the same again in a child process whose XLA may not emit FMA
instructions (XLA_FLAGS=--xla_cpu_max_isa=AVX), so that both sides round
every product and sum on its own; what still differs there comes from the
transcendentals (XLA's own sin/cos polynomials against PyTorch's).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from toypathtracer_tpu import RenderConfig as JConfig
from toypathtracer_tpu.render import wavefront as j_wavefront
from toypathtracer_tpu.scene import CameraSpec as JCameraSpec
from toypathtracer_tpu.scene import Scene as JScene
from toypathtracer_torch import RenderConfig, make_scene
from toypathtracer_torch.ops import cuda_render
from toypathtracer_torch.ops import tracecore as tc
from toypathtracer_torch.render.wavefront import (camera_scalars,
                                                  render_tile_plain)
from toypathtracer_torch.tools.scenes import crowded_scene

CASES = ((32, 16, 0), (32, 16, 5), (64, 32, 0), (64, 32, 7))
NO_FMA = "--xla_cpu_max_isa=AVX"


def contraction():
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(100_000).astype(np.float32)
               for _ in range(3))
    got = np.asarray(jax.jit(lambda a, b, c: a * b - c)(a, b, c))
    once = (a.astype(np.float64) * b - c).astype(np.float32)
    return {"single_rounding": float((got == once).mean()),
            "ieee_two_roundings": float((got == a * b - c).mean())}


def render64(scene, cfg, frame):
    """tracecore.render_pixels with the table, pixel coordinates and
    arithmetic in float64 (random draws as the float32 path makes them)."""
    tab = cuda_render.pack_scene(scene).double()
    mat = torch.tensor(scene.mat_type, dtype=torch.int64)
    cam = camera_scalars(scene, cfg)
    yy, xx = torch.meshgrid(torch.arange(cfg.height),
                            torch.arange(cfg.width), indexing="ij")
    px, py = xx.reshape(-1), yy.reshape(-1)
    state = tc.seed_pixels(px, py, frame)
    zero = torch.zeros_like(px, dtype=torch.float64)
    izero = torch.zeros_like(px)
    work = tc.Work(izero, izero, izero, izero, izero)
    total = (zero, zero, zero)
    for _ in range(cfg.samples_per_pixel):
        state, ur = tc.rand01(state)
        state, vr = tc.rand01(state)
        state, ro, rd = tc.camera_get_ray(
            cam, (px + ur.double()) / cfg.width,
            (py + vr.double()) / cfg.height, state)
        col, atten = (zero, zero, zero), (zero + 1, zero + 1, zero + 1)
        alive = torch.ones_like(px, dtype=torch.bool)
        carry = (ro, rd, alive, alive, state, work)
        for _ in range(cfg.max_depth):
            carry, e, c = tc.bounce(tab, mat, scene.emissive_ids, cfg, carry)
            col = tc.add3(col, tc.mul3(atten, e))
            atten = tc.mul3(atten, c)
        state = carry[4]
        total = tc.add3(total, col)
    col = tc.scale3(total, 1.0 / cfg.samples_per_pixel)
    return torch.stack(col, -1).reshape(cfg.height, cfg.width, 3).numpy()


def jax_scene(scene):
    return JScene(
        **{f: jnp.asarray(getattr(scene, f).numpy())
           for f in ("center", "radius", "albedo", "emissive", "roughness",
                     "ri")},
        mat_type=scene.mat_type, emissive_ids=scene.emissive_ids,
        camera=JCameraSpec(**dataclasses.asdict(scene.camera)))


def soft_gradient():
    fields = ("center", "radius", "albedo", "emissive", "roughness", "ri")
    kw = dict(width=16, height=8, samples_per_pixel=2, max_depth=3,
              soft_silhouette_eps=0.02)
    w = np.random.RandomState(0).rand(8, 16, 3).astype(np.float32)
    scene = make_scene(big=False)
    jg = jax.grad(lambda s: jnp.sum(j_wavefront.render_frame(
        s, JConfig(**kw), jnp.int32(0), differentiable=True)[0] * w))(
        jax_scene(scene))
    leaves = {f: getattr(scene, f).clone().requires_grad_(True)
              for f in fields}
    img, _ = render_tile_plain(scene.replace(**leaves), RenderConfig(**kw),
                               0, 0, 0, 8, 16)
    (img * torch.from_numpy(w)).sum().backward()
    rel = {}
    for f in fields:
        want = np.asarray(getattr(jg, f))
        rel[f] = float(np.abs(leaves[f].grad.numpy() - want).max()
                       / np.abs(want).max())
    return rel


def readings(xla_flags: str):
    torch.set_num_threads(2)
    print(json.dumps({"xla_flags": xla_flags, "contraction": contraction()}),
          flush=True)
    print(json.dumps({"xla_flags": xla_flags,
                      "soft_gradient": soft_gradient()}), flush=True)
    for name, scene in (("46", make_scene(big=True)),
                        ("600", crowded_scene(extra=554))):
        jscene = jax_scene(scene)
        for w, h, frame in CASES:
            kw = dict(width=w, height=h, samples_per_pixel=1, max_depth=3)
            img, rays = cuda_render.render_frame(scene, RenderConfig(**kw),
                                                 frame, device="cpu")
            img = img.numpy()
            jimg, jrays = j_wavefront.render_frame(jscene, JConfig(**kw),
                                                   jnp.int32(frame))
            jimg = np.asarray(jimg)
            d = np.abs(img - jimg)
            bad = d.max(axis=-1) > 1e-4
            r = {"xla_flags": xla_flags, "spheres": int(name),
                 "size": f"{w}x{h}", "frame": frame, "rays_port": int(rays),
                 "rays_jax": int(jrays), "pixels_beyond_1e-4": int(bad.sum()),
                 "pixels": int(bad.size),
                 "pixels_equal": int((d.max(axis=-1) == 0).sum()),
                 "max_abs_diff": float(d.max()),
                 "mean_abs_diff": float(d.mean())}
            if bad.any():
                ref = render64(scene, RenderConfig(**kw), frame)
                r["beyond_1e-4_port_vs_f64"] = float(
                    np.abs(img - ref)[bad].mean())
                r["beyond_1e-4_jax_vs_f64"] = float(
                    np.abs(jimg - ref)[bad].mean())
            print(json.dumps(r), flush=True)


if __name__ == "__main__":
    flags = os.environ.get("XLA_FLAGS", "")
    readings(flags)
    if NO_FMA not in flags:
        env = dict(os.environ, XLA_FLAGS=f"{flags} {NO_FMA}".strip())
        sys.exit(subprocess.run([sys.executable, __file__], env=env).returncode)
