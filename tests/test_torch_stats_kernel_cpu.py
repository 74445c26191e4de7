"""The stats render kernel's per-pixel code and the issue-rate probe's
chains (toypathtracer_torch/csrc/trace.cuh, probe.cuh), built with g++ for
the CPU, against their plain PyTorch versions.

render_pixel with a trip counter runs the stats kernel's own logic (K2);
without one, the render kernel's (K1).  Held: its image and per-pixel
rays bit-equal to the counter-free render_pixel's; its trip counts (b, c,
l) and per-sample bounces exactly equal to the plain version's
(render/wavefront.render_tile_stats_plain), and so the warp counters
reduced from them; a pixel that is not live traces nothing and still
reports every sample.  The probe's six chain steps at 64 trips against
toypathtracer_torch/tools/roofline.py's plain versions: tolerance 1e-6
relative (each op rounds once on both sides; measured bit-equal).
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
from toypathtracer_torch.render.wavefront import (render_tile_stats_plain,
                                                  warp_counters)
from toypathtracer_torch.tools import roofline

torch.set_num_threads(1)

HARNESS = r"""
#include "trace.cuh"
#include "probe.cuh"

// A trip counter that also records each sample's bounces.
struct Rec : tpt::Trips {
  int32_t* depths;
  int calls = 0;
  bool on = true;
  bool live() const { return on; }
  void sample(int depth, bool cut) {
    tpt::Trips::sample(depth, cut);
    depths[calls++] = depth;
  }
};

extern "C" void tpt_render_stats_cpu(
    const float* tab, const int32_t* mat, const int32_t* lights,
    const float* cam, const tpt::RenderParams* p, int grid_h, int grid_w,
    int live, float* out, float* out_k1, int64_t* rays, int64_t* rays_k1,
    int32_t* trips, int32_t* depths, int32_t* calls) {
  tpt::SceneView S;
  S.tab = tab;
  S.mat = mat;
  S.lights = lights;
  S.n = p->n_spheres;
  S.n_lights = p->n_lights;
  const size_t plane = (size_t)grid_h * grid_w;
  for (int y = 0; y < grid_h; ++y)
    for (int x = 0; x < grid_w; ++x) {
      const size_t i = (size_t)y * grid_w + x;
      Rec r;
      r.depths = depths + i * p->spp;
      r.on = live != 0;
      rays[i] = tpt::render_pixel(S, cam, *p, x, y, out + 3 * i, r);
      rays_k1[i] = tpt::render_pixel(S, cam, *p, x, y, out_k1 + 3 * i);
      trips[i] = r.bounces;
      trips[plane + i] = r.cutoffs;
      trips[2 * plane + i] = r.last_cutoff;
      calls[i] = r.calls;
    }
}

template <int kCase>
void run(int trips, int n, float* out) {
  for (int i = 0; i < n; ++i)
    out[i] = tpt::probe::chains<kCase>(tpt::probe::thread_x(i), trips);
}

extern "C" void tpt_probe_cpu(int which, int trips, int n, float* out) {
  switch (which) {
    case 0: run<0>(trips, n, out); break;
    case 1: run<1>(trips, n, out); break;
    case 2: run<2>(trips, n, out); break;
    case 3: run<3>(trips, n, out); break;
    case 4: run<4>(trips, n, out); break;
    case 5: run<5>(trips, n, out); break;
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("stats_cpu")
    (d / "host.cpp").write_text(HARNESS)
    so = d / "libstats_cpu.so"
    # -ffp-contract=off: no FMA contraction, as the CUDA build's -fmad=false
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17",
                    "-ffp-contract=off", f"-I{_build.CSRC}", "-o", str(so),
                    str(d / "host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tpt_render_stats_cpu.argtypes = [
        ptr, ptr, ptr, ptr, ctypes.POINTER(_build.RenderParams), i32, i32,
        i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.tpt_probe_cpu.argtypes = [i32, i32, i32, ptr]
    return lib


def render_stats_host(lib, scene, cfg, frame, live=True):
    """The stats launcher's inputs over cfg's padded tile grid, prepared
    as ops/cuda_render does; per-pixel outputs of both render_pixels."""
    gh, gw = cuda_render.padded_grid(cfg)
    tab = cuda_render.pack_scene(scene).numpy()
    mat = np.array(scene.mat_type, np.int32)
    lights = np.array(scene.emissive_ids or (0,), np.int32)
    cam = camera_to_array(make_camera(scene.camera, cfg.width / cfg.height))
    params = cuda_render.render_params(scene, cfg, frame, 0, 0, cfg.height,
                                       cfg.width)
    o = dict(out=np.zeros((gh, gw, 3), np.float32),
             out_k1=np.zeros((gh, gw, 3), np.float32),
             rays=np.zeros((gh, gw), np.int64),
             rays_k1=np.zeros((gh, gw), np.int64),
             trips=np.zeros((3, gh, gw), np.int32),
             depths=np.zeros((gh, gw, cfg.samples_per_pixel), np.int32),
             calls=np.zeros((gh, gw), np.int32))
    lib.tpt_render_stats_cpu(
        tab.ctypes.data, mat.ctypes.data, lights.ctypes.data, cam.ctypes.data,
        ctypes.byref(params), gh, gw, int(live),
        *(o[k].ctypes.data for k in ("out", "out_k1", "rays", "rays_k1",
                                     "trips", "depths", "calls")))
    return o


CFGS = {
    # 40x12 in 16x128 tiles: 4 padded rows, 88 padded columns
    "padded": dict(width=40, height=12, samples_per_pixel=2, max_depth=4,
                   tile_h=16, tile_w=128),
    # depth 3 so that samples end by the cutoff
    "cutoff": dict(width=64, height=16, samples_per_pixel=3, max_depth=3,
                   tile_h=16, tile_w=64, pix_per_lane=2,
                   merged_wavefront=True),
}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_stats_render_pixel_matches_plain(host_lib, name):
    cfg = RenderConfig(**CFGS[name])
    scene = make_scene(big=True)
    o = render_stats_host(host_lib, scene, cfg, 2)
    # the trip counter changes nothing of the image or the rays
    np.testing.assert_array_equal(o["out"], o["out_k1"])
    np.testing.assert_array_equal(o["rays"], o["rays_k1"])
    img, rays, cnt = render_tile_stats_plain(scene, cfg, 2)
    H, W = cfg.height, cfg.width
    assert int(o["rays"][:H, :W].sum()) == int(rays)
    d = np.abs(o["out"][:H, :W] - img.numpy())
    assert (d.max(axis=-1) <= 1e-4).mean() >= 0.999 and d.mean() <= 5e-7
    # trip counts exact, over the padded grid
    for k, plain in enumerate(cnt[:3]):
        np.testing.assert_array_equal(o["trips"][k], plain.numpy())
    assert (o["calls"] == cfg.samples_per_pixel).all()
    np.testing.assert_array_equal(o["depths"].sum(axis=-1), o["trips"][0])
    it, wk = warp_counters(torch.from_numpy(o["depths"]), H, W)
    assert torch.equal(it, cnt.warp_iters) and torch.equal(wk, cnt.warp_work)
    if name == "cutoff":
        assert o["trips"][1].sum() > 0 and o["trips"][2].sum() > 0


def test_stats_render_pixel_not_live_traces_nothing(host_lib):
    cfg = RenderConfig(**CFGS["padded"])
    o = render_stats_host(host_lib, make_scene(big=True), cfg, 0, live=False)
    assert (o["calls"] == cfg.samples_per_pixel).all()
    assert not o["rays"].any() and not o["trips"].any()
    assert not o["depths"].any() and not o["out"].any()
    assert o["rays_k1"].all()


@pytest.mark.parametrize("case", list(roofline.CASES))
def test_probe_chains_match_plain(host_lib, case):
    n, trips = 2048, 64
    out = np.zeros(n, np.float32)
    host_lib.tpt_probe_cpu(roofline.CASES[case].id, trips, n,
                           out.ctypes.data)
    want = roofline.chains_plain(case, trips, n).numpy()
    assert np.isfinite(out).all() and np.unique(out).size > 100
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=0)
