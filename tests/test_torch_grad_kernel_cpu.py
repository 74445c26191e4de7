"""The gradient kernel's per-pixel code (csrc/trace.cuh grad_pixel, the
body of csrc/grad.cu's K3) and the lockstep kernel's (render_pixel, K4),
built with g++ for the CPU, against autograd through the plain version
(render/wavefront.render_tile_grad_plain).

trace.cuh is all __host__ __device__ code; without nvcc its TPT_HD macro
is plain `inline`, so a C loop over pixels runs the kernels' own logic
here, through the same tpt::RenderParams the launchers take.  The loop
adds every pixel's cotangent into one table; the card sums them in
another order (per block, then over blocks), which the sub-image test
stands in for.

Tolerances: d_packed row by row within 1e-3 x the row's max |plain|
(measured at most 1.5e-5 over these cases); ray counts exact
(measured); the image as tests/test_torch_kernel_cpu.py; K4's image
bit-equal to K3's primal (the same function); sub-images summed within
1e-5 of the whole image (float sums in another order).
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
from toypathtracer_torch.render.wavefront import render_tile_grad_plain

torch.set_num_threads(1)

HARNESS = r"""
#include "trace.cuh"

static tpt::SceneView view(const float* tab, const int32_t* mat,
                           const int32_t* lights, const tpt::RenderParams* p) {
  tpt::SceneView S;
  S.tab = tab;
  S.mat = mat;
  S.lights = lights;
  S.n = p->n_spheres;
  S.n_lights = p->n_lights;
  return S;
}

extern "C" unsigned long long tpt_grad_cpu(
    const float* tab, const int32_t* mat, const int32_t* lights,
    const float* cam, const tpt::RenderParams* p, const float* g, float* out,
    float* acc) {
  tpt::SceneView S = view(tab, mat, lights, p);
  unsigned long long rays = 0;
  for (int y = 0; y < p->height; ++y)
    for (int x = 0; x < p->width; ++x) {
      size_t o = ((size_t)y * p->width + x) * 3;
      rays += tpt::grad_pixel(S, cam, *p, p->x0 + x, p->y0 + y, g + o,
                              out + o, acc);
    }
  return rays;
}

extern "C" unsigned long long tpt_lockstep_cpu(
    const float* tab, const int32_t* mat, const int32_t* lights,
    const float* cam, const tpt::RenderParams* p, float* out) {
  tpt::SceneView S = view(tab, mat, lights, p);
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
    d = tmp_path_factory.mktemp("grad_cpu")
    (d / "host.cpp").write_text(HARNESS)
    so = d / "libgrad_cpu.so"
    # -ffp-contract=off: no FMA contraction, as the CUDA build's -fmad=false
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17",
                    "-ffp-contract=off", f"-I{_build.CSRC}", "-o", str(so),
                    str(d / "host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    ptr = ctypes.c_void_p
    params = ctypes.POINTER(_build.RenderParams)
    lib.tpt_grad_cpu.argtypes = [ptr, ptr, ptr, ptr, params, ptr, ptr, ptr]
    lib.tpt_grad_cpu.restype = ctypes.c_ulonglong
    lib.tpt_lockstep_cpu.argtypes = [ptr, ptr, ptr, ptr, params, ptr]
    lib.tpt_lockstep_cpu.restype = ctypes.c_ulonglong
    return lib


def inputs(scene, cfg):
    """The launchers' inputs, prepared as ops/cuda_render does."""
    tab = cuda_render.pack_scene(scene).numpy()
    mat = np.array(scene.mat_type, np.int32)
    lights = np.array(scene.emissive_ids or (0,), np.int32)
    cam = camera_to_array(make_camera(scene.camera, cfg.width / cfg.height))
    return tab, mat, lights, cam


def grad_host(lib, scene, cfg, frame, g, x0, y0):
    """K3's per-pixel code over a sub-image: (image, rays, d_packed)."""
    h, w, _ = g.shape
    tab, mat, lights, cam = inputs(scene, cfg)
    out = np.zeros((h, w, 3), np.float32)
    acc = np.zeros_like(tab)
    params = cuda_render.render_params(scene, cfg, frame, x0, y0, h, w)
    g = np.ascontiguousarray(g, np.float32)
    rays = lib.tpt_grad_cpu(tab.ctypes.data, mat.ctypes.data,
                            lights.ctypes.data, cam.ctypes.data,
                            ctypes.byref(params), g.ctypes.data,
                            out.ctypes.data, acc.ctypes.data)
    return out, rays, acc


def lockstep_host(lib, scene, cfg, frame, x0, y0, h, w):
    tab, mat, lights, cam = inputs(scene, cfg)
    out = np.zeros((h, w, 3), np.float32)
    params = cuda_render.render_params(scene, cfg, frame, x0, y0, h, w)
    rays = lib.tpt_lockstep_cpu(tab.ctypes.data, mat.ctypes.data,
                                lights.ctypes.data, cam.ctypes.data,
                                ctypes.byref(params), out.ctypes.data)
    return out, rays


def assert_rows_close(got, want, rtol):
    for r in range(want.shape[0]):
        scale = np.abs(want[r]).max()
        assert np.abs(got[r] - want[r]).max() <= rtol * scale, (
            r, np.abs(got[r] - want[r]).max(), scale)


CASES = {
    "big": (dict(big=True), dict()),
    "big_no_nee": (dict(big=True), dict(do_light_sampling=False)),
    "small": (dict(big=False), dict()),
    "mitsuba": (dict(big=False, mitsuba_compare=True),
                dict(do_mitsuba_compare=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("frame,x0,y0", [(1, 0, 0), (4, 40, 7)])
def test_grad_source_matches_plain_autograd(host_lib, case, frame, x0, y0):
    scene_kw, cfg_kw = CASES[case]
    scene = make_scene(**scene_kw)
    cfg = RenderConfig(width=32, height=16, samples_per_pixel=2, max_depth=4,
                       **cfg_kw)
    g = np.random.RandomState(frame).rand(16, 32, 3).astype(np.float32)
    out, rays, acc = grad_host(host_lib, scene, cfg, frame, g, x0, y0)
    img, prays, d = render_tile_grad_plain(scene, cfg, frame,
                                           torch.from_numpy(g), x0, y0, 16, 32)
    assert rays == int(prays)
    assert np.isfinite(acc).all()
    assert_rows_close(acc, d.numpy(), 1e-3)
    diff = np.abs(out - img.numpy())
    assert (diff.max(axis=-1) <= 1e-4).mean() >= 0.999
    assert diff.mean() <= 5e-7
    # K4: the primal alone, bit for bit
    l_out, l_rays = lockstep_host(host_lib, scene, cfg, frame, x0, y0, 16, 32)
    np.testing.assert_array_equal(l_out, out)
    assert l_rays == rays


def test_sub_images_sum_to_the_whole(host_lib):
    """A 24x16 image as 2x2 sub-images at offsets: the sub-images' scene
    cotangents add up to the whole image's, their primals tile it."""
    scene = make_scene(big=True)
    cfg = RenderConfig(width=24, height=16, samples_per_pixel=1, max_depth=3)
    g = np.random.RandomState(2).rand(16, 24, 3).astype(np.float32)
    whole, rays, d = grad_host(host_lib, scene, cfg, 0, g, 0, 0)
    parts = np.zeros_like(d)
    total = 0
    for y0, h in ((0, 8), (8, 8)):
        for x0, w in ((0, 16), (16, 8)):
            out, r, acc = grad_host(host_lib, scene, cfg, 0,
                                    g[y0:y0 + h, x0:x0 + w], x0, y0)
            np.testing.assert_array_equal(out, whole[y0:y0 + h, x0:x0 + w])
            parts += acc
            total += r
    assert total == rays
    assert_rows_close(parts, d, 1e-5)


def test_zero_cotangent_gives_zero_gradient(host_lib):
    scene = make_scene(big=True)
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=2, max_depth=4)
    _, _, acc = grad_host(host_lib, scene, cfg, 0,
                          np.zeros((8, 8, 3), np.float32), 0, 0)
    assert not acc.any()
