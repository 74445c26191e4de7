"""The render kernel's device code, built with g++ for the CPU: the
per-pixel code of the per-thread kernel (toypathtracer_torch/csrc/
trace.cuh render_pixel) against the kernel's plain PyTorch version
(render/wavefront.render_tile_plain), and the main path's merged path loop
(csrc/merged.cuh render_tiles_merged with csrc/flat.cuh's traversals)
against render_pixel.

The headers are __host__ __device__ code; without nvcc their TPT_HD and
TPT_WARP macros are plain `inline`, so a small C loop runs the kernel's own
logic here, through the same tpt::RenderParams the launcher takes.  The
merged loop runs under a one-lane warp (HostLane) and in a warp of 32 host
threads (csrc/hostwarp.h ThreadWarp, where a collective that not every
lane reaches stalls the warp), and must give render_pixel's image and rays
bit for bit: the same arithmetic, each pixel's samples in order on one RNG
state, the lights' contributions in emissive-id order.
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
from toypathtracer_torch.scene import recompute_emissive_ids
from toypathtracer_torch.tools.scenes import crowded_scene

torch.set_num_threads(1)

HARNESS = r"""
#include <thread>
#include <vector>

#include "flat.cuh"
#include "hostwarp.h"

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

// The merged kernel's warp over the whole sub-image, as
// merged_render_kernel runs it: the sphere records, the table, the material
// and emissive ids copied into a block's buffers first up to kMaxSpheres
// spheres, read where they lie beyond.  width 1: a one-lane warp; 32: a
// warp of 32 host threads.  Returns the rays, or -1 if the warp stalled.
extern "C" long long tpt_render_merged_cpu(
    const float* tab, const float* sph, const int32_t* mat,
    const int32_t* lights, const float* cam, const tpt::RenderParams* p,
    float* out, int width) {
  const int n = p->n_spheres, nl = p->n_lights;
  const tpt::Sphere4* recs = reinterpret_cast<const tpt::Sphere4*>(sph);
  std::vector<tpt::Sphere4> s_sph;
  std::vector<float> s_tab;
  std::vector<int32_t> s_mat, s_lights;
  tpt::FlatView S;
  S.n = n;
  S.n_lights = nl;
  if (n <= tpt::kMaxSpheres) {
    s_sph.assign(recs, recs + n);
    s_tab.assign(tab, tab + tpt::SCENE_ROWS * n);
    s_mat.assign(mat, mat + n);
    s_lights.assign(lights, lights + nl);
    S.sph = s_sph.data();
    S.tab = s_tab.data();
    S.mat = s_mat.data();
    S.lights = s_lights.data();
  } else {
    S.sph = recs;
    S.tab = tab;
    S.mat = mat;
    S.lights = lights;
  }
  std::vector<float> nee(tpt::flat_nee_words(nl, width) + 1);
  S.nee = nee.data();
  int next_tile = 0;
  tpt::NoCoopCount none;
  if (width == 1) {
    tpt::HostLane w;
    return (long long)tpt::render_tiles_merged(w, S, cam, *p, &next_tile,
                                               out, none);
  }
  tpt::Lanes lanes;
  unsigned long long lane_rays[32];
  std::vector<std::thread> threads;
  for (int l = 0; l < 32; ++l)
    threads.emplace_back([&, l] {
      tpt::ThreadWarp w{&lanes, l};
      tpt::NoCoopCount c;
      lane_rays[l] =
          tpt::render_tiles_merged(w, S, cam, *p, &next_tile, out, c);
    });
  for (auto& t : threads) t.join();
  if (lanes.broken) return -1;
  long long rays = 0;
  for (int l = 0; l < 32; ++l) rays += (long long)lane_rays[l];
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
                    "-ffp-contract=off", "-pthread", f"-I{_build.CSRC}",
                    "-o", str(so), str(d / "host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    ptr = ctypes.c_void_p
    params = ctypes.POINTER(_build.RenderParams)
    lib.tpt_render_cpu.argtypes = [ptr, ptr, ptr, ptr, params, ptr]
    lib.tpt_render_cpu.restype = ctypes.c_ulonglong
    lib.tpt_render_merged_cpu.argtypes = [ptr, ptr, ptr, ptr, ptr, params,
                                          ptr, ctypes.c_int]
    lib.tpt_render_merged_cpu.restype = ctypes.c_longlong
    lib.tpt_params_size.restype = ctypes.c_int
    return lib


def inputs(scene, cfg):
    """The launchers' inputs, prepared as ops/cuda_render does."""
    tab = cuda_render.pack_scene(scene)
    sph = cuda_render.pack_records(tab).numpy()
    mat = np.array(scene.mat_type, np.int32)
    lights = np.array(scene.emissive_ids or (0,), np.int32)
    cam = camera_to_array(make_camera(scene.camera, cfg.width / cfg.height))
    return tab.numpy(), sph, mat, lights, cam


def render_host(lib, scene, cfg, frame, x0, y0, h, w):
    """render_pixel over the sub-image (the per-thread kernel's code)."""
    tab, _, mat, lights, cam = inputs(scene, cfg)
    out = np.zeros((h, w, 3), np.float32)
    params = cuda_render.render_params(scene, cfg, frame, x0, y0, h, w)
    rays = lib.tpt_render_cpu(tab.ctypes.data, mat.ctypes.data,
                              lights.ctypes.data, cam.ctypes.data,
                              ctypes.byref(params), out.ctypes.data)
    return out, rays


def render_merged_host(lib, scene, cfg, frame, x0, y0, h, w, width):
    """The merged loop over the sub-image in a warp of `width` lanes."""
    tab, sph, mat, lights, cam = inputs(scene, cfg)
    out = np.full((h, w, 3), np.nan, np.float32)
    params = cuda_render.render_params(scene, cfg, frame, x0, y0, h, w)
    rays = lib.tpt_render_merged_cpu(tab.ctypes.data, sph.ctypes.data,
                                     mat.ctypes.data, lights.ctypes.data,
                                     cam.ctypes.data, ctypes.byref(params),
                                     out.ctypes.data, width)
    assert rays >= 0, "a 32-lane warp stalled at a collective"
    return out, rays


def test_params_layout_matches_ctypes(host_lib):
    assert host_lib.tpt_params_size() == ctypes.sizeof(_build.RenderParams)


CASES = {
    "big": (dict(big=True), dict()),
    "big_no_nee": (dict(big=True), dict(do_light_sampling=False)),
    "small": (dict(big=False), dict()),
    "mitsuba": (dict(big=False, mitsuba_compare=True),
                dict(do_mitsuba_compare=True)),
    "crowded_600": (None, dict()),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("frame,x0,y0", [(0, 0, 0), (5, 40, 7)])
def test_kernel_source_matches_plain(host_lib, case, frame, x0, y0):
    """crowded_600: 600 spheres (tools/scenes.crowded_scene(extra=554)),
    more than the per-thread kernels stage; the plain version takes them."""
    scene_kw, cfg_kw = CASES[case]
    scene = crowded_scene(extra=554) if scene_kw is None \
        else make_scene(**scene_kw)
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


def lit_crowd():
    """crowded_scene(extra=20) with six of its appended spheres emissive:
    8 lights, two groups of nee_warp's kNeeGroup = 4."""
    scene = crowded_scene(extra=20)
    em = scene.emissive.clone()
    em[[50, 53, 56, 59, 62, 65]] = torch.tensor([2.0, 1.5, 1.0])
    scene = recompute_emissive_ids(scene.replace(emissive=em))
    assert len(scene.emissive_ids) == 8
    return scene


MERGED_CASES = {
    "big": (lambda: make_scene(big=True), dict()),
    "big_no_nee": (lambda: make_scene(big=True),
                   dict(do_light_sampling=False)),
    "small": (lambda: make_scene(big=False), dict()),
    "mitsuba": (lambda: make_scene(big=False, mitsuba_compare=True),
                dict(do_mitsuba_compare=True)),
    "crowded_600": (lambda: crowded_scene(extra=554), dict()),
    "eight_lights": (lit_crowd, dict()),
}


@pytest.mark.parametrize("case", sorted(MERGED_CASES))
@pytest.mark.parametrize("width", [1, 32], ids=["one_lane", "32_lanes"])
def test_merged_loop_bit_equal_to_render_pixel(host_lib, case, width):
    """The main path's merged loop, bit-equal to render_pixel (image and
    rays) on a 32x16 sub-image at (40, 7), spp 2, depth 6: the 46-sphere
    scene with and without light sampling, the 9-sphere scene, its Mitsuba
    form, 600 spheres (more than the kernel stages: the records and the
    table read where they lie) and 8 lights (two groups of shadow rays)."""
    make, cfg_kw = MERGED_CASES[case]
    scene = make()
    cfg = RenderConfig(width=320, height=176, samples_per_pixel=2,
                       max_depth=6, **cfg_kw)
    out, rays = render_host(host_lib, scene, cfg, 3, 40, 7, 16, 32)
    m_out, m_rays = render_merged_host(host_lib, scene, cfg, 3, 40, 7, 16,
                                       32, width)
    np.testing.assert_array_equal(m_out, out)
    assert m_rays == rays
