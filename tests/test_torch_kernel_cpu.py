"""The CUDA kernel's per-pixel code (toypathtracer_torch/csrc/trace.cuh),
built with g++ for the CPU, against the kernel's plain PyTorch version
(render/wavefront.render_tile_plain).

trace.cuh is all __host__ __device__ code; without nvcc its TPT_HD macro
is plain `inline`, so a small C loop over pixels runs the kernel's own
logic here, through the same tpt::RenderParams the launcher takes.
Tolerances as tests/test_torch_render.py (ray count 1e-4 relative, 99.9%
of pixels within 1e-4, mean |diff| 5e-7); measured at 32x16, spp 2,
depth 4: ray counts exact, max |diff| 7e-6, 99% of pixels bit-equal
(glibc's sinf/cosf/expf/logf against torch's vectorised ones).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from toypathtracer_torch import RenderConfig, make_scene
from toypathtracer_torch.camera import camera_to_array, make_camera
from toypathtracer_torch.ops import _build, cuda_render
from toypathtracer_torch.render.wavefront import render_tile_plain

torch.set_num_threads(1)

HARNESS = r"""
#include "trace.cuh"

extern "C" int tpt_params_size() { return (int)sizeof(tpt::RenderParams); }

extern "C" unsigned long long tpt_render_cpu(
    const float* tab, const int32_t* mat, const int32_t* lights,
    const float* cam, const tpt::RenderParams* p, float* out) {
  tpt::SceneView S;
  S.tab = tab;
  S.mat = mat;
  S.lights = lights;
  S.n = p->n_spheres;
  S.n_lights = p->n_lights;
  unsigned long long rays = 0;
  for (int y = 0; y < p->height; ++y)
    for (int x = 0; x < p->width; ++x)
      rays += tpt::render_pixel(S, cam, *p, p->x0 + x, p->y0 + y,
                                out + ((size_t)y * p->width + x) * 3);
  return rays;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("trace_cpu")
    (d / "host.cpp").write_text(HARNESS)
    so = d / "libtrace_cpu.so"
    # -ffp-contract=off: no FMA contraction, as the CUDA build's -fmad=false
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17",
                    "-ffp-contract=off", f"-I{_build.CSRC}", "-o", str(so),
                    str(d / "host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    ptr = ctypes.c_void_p
    lib.tpt_render_cpu.argtypes = [ptr, ptr, ptr, ptr,
                                   ctypes.POINTER(_build.RenderParams), ptr]
    lib.tpt_render_cpu.restype = ctypes.c_ulonglong
    lib.tpt_params_size.restype = ctypes.c_int
    return lib


def render_host(lib, scene, cfg, frame, x0, y0, h, w):
    """The launcher's inputs, prepared as ops/cuda_render does."""
    tab = cuda_render.pack_scene(scene).numpy()
    mat = np.array(scene.mat_type, np.int32)
    lights = np.array(scene.emissive_ids or (0,), np.int32)
    cam = camera_to_array(make_camera(scene.camera, cfg.width / cfg.height))
    out = np.zeros((h, w, 3), np.float32)
    params = cuda_render.render_params(scene, cfg, frame, x0, y0, h, w)
    rays = lib.tpt_render_cpu(tab.ctypes.data, mat.ctypes.data,
                              lights.ctypes.data, cam.ctypes.data,
                              ctypes.byref(params), out.ctypes.data)
    return out, rays


def test_params_layout_matches_ctypes(host_lib):
    assert host_lib.tpt_params_size() == ctypes.sizeof(_build.RenderParams)


CASES = {
    "big": (dict(big=True), dict()),
    "big_no_nee": (dict(big=True), dict(do_light_sampling=False)),
    "small": (dict(big=False), dict()),
    "mitsuba": (dict(big=False, mitsuba_compare=True),
                dict(do_mitsuba_compare=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("frame,x0,y0", [(0, 0, 0), (5, 40, 7)])
def test_kernel_source_matches_plain(host_lib, case, frame, x0, y0):
    scene_kw, cfg_kw = CASES[case]
    scene = make_scene(**scene_kw)
    cfg = RenderConfig(width=32, height=16, samples_per_pixel=2, max_depth=4,
                       **cfg_kw)
    h, w = 16, 32
    out, rays = render_host(host_lib, scene, cfg, frame, x0, y0, h, w)
    img, prays = render_tile_plain(scene, cfg, frame, x0, y0, h, w)
    img = img.numpy()
    assert np.isfinite(out).all()
    assert abs(rays - int(prays)) <= 1e-4 * int(prays)
    d = np.abs(out - img)
    assert (d.max(axis=-1) <= 1e-4).mean() >= 0.999
    assert d.mean() <= 5e-7


def one_sphere_scene(mat_type, albedo):
    """A convex body seen from z=4 with a pinhole camera, no lights."""
    from toypathtracer_torch.scene import CameraSpec, scene_from_arrays
    return scene_from_arrays(
        center=[(0.0, 0.0, 0.0)], radius=[1.0], albedo=[albedo],
        emissive=[(0.0, 0.0, 0.0)], roughness=[0.0], ri=[0.0],
        mat_type=[mat_type], emissive_ids=[],
        camera=CameraSpec(look_from=(0.0, 0.0, 4.0), look_at=(0.0, 0.0, 0.0),
                          aperture=0.0, focus_dist=4.0))


@pytest.mark.parametrize("mat_type,albedo", [(0, (0.7, 0.5, 0.3)),
                                             (1, (0.9, 0.6, 0.2))])
@pytest.mark.parametrize("renderer", ["kernel_source", "plain"])
def test_furnace_exact(request, renderer, mat_type, albedo):
    """Closed-form ground truth (tests/test_analytic.py's furnace): a
    convex Lambert or mirror-metal body under the constant Mitsuba sky
    returns every path exactly albedo * sky, since no scattered ray can
    re-hit it; misses return the sky.  Float tolerance 2e-6 only."""
    scene = one_sphere_scene(mat_type, albedo)
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=2, max_depth=4,
                       do_mitsuba_compare=True, do_light_sampling=False)
    if renderer == "plain":
        img = render_tile_plain(scene, cfg, 0, 0, 0, 32, 32)[0].numpy()
    else:
        img = render_host(request.getfixturevalue("host_lib"), scene, cfg,
                          0, 0, 0, 32, 32)[0]
    sky = np.array([0.15, 0.21, 0.3], np.float32)
    want = np.asarray(albedo, np.float32) * sky
    np.testing.assert_allclose(img[12:20, 12:20],
                               np.broadcast_to(want, (8, 8, 3)), atol=2e-6,
                               rtol=0)
    np.testing.assert_allclose(img[0, 0], sky, atol=2e-6, rtol=0)
