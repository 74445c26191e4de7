"""The stats render kernel's per-pixel code and the issue-rate probe's
chains (toypathtracer_torch/csrc/trace.cuh, merged.cuh, probe.cuh), built
with g++ for the CPU, against their plain PyTorch versions.

render_pixel with a trip counter runs the per-thread stats kernel's own
logic (K2's baseline); without one, the render kernel's (K1).  Held: its
image and per-pixel rays bit-equal to the counter-free render_pixel's; its
trip counts (b, c, l) and per-sample bounces exactly equal to the plain
version's (render/wavefront.render_tile_stats_plain), and so the warp
counters reduced from them; a pixel that is not live traces nothing and
still reports every sample.  K2 on the main path, the merged loop with the
TripStats counter (csrc/merged.cuh) over the padded grid, under a one-lane
warp and in a warp of 32 host threads (csrc/hostwarp.h): image and rays
bit-equal to render_pixel's, trip counts and warp counters exactly its,
and so the TPU's tile counters, merged and unmerged.  The probe's six
chain steps at 64 trips against toypathtracer_torch/tools/roofline.py's
plain versions: tolerance 1e-6 relative (each op rounds once on both
sides; measured bit-equal).
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
from toypathtracer_torch.tools.scenes import crowded_scene

torch.set_num_threads(1)

HARNESS = r"""
#include <thread>
#include <vector>

#include "flat.cuh"
#include "hostwarp.h"
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

// K2's merged loop (merged_render_kernel<2>'s) over the (grid_h, grid_w) grid
// with the records and the table read where they lie: width 1, a one-lane
// warp; 32, a warp of 32 host threads.  Returns the rays, or -1 if the warp
// stalled.
extern "C" long long tpt_render_stats_merged_cpu(
    const float* tab, const float* sph, const int32_t* mat,
    const int32_t* lights, const float* cam, const tpt::RenderParams* p,
    int grid_h, int grid_w, float* out, int32_t* trips, int32_t* work,
    int32_t* depth, int width) {
  tpt::FlatView S;
  S.sph = reinterpret_cast<const tpt::Sphere4*>(sph);
  S.tab = tab;
  S.mat = mat;
  S.lights = lights;
  S.n = p->n_spheres;
  S.n_lights = p->n_lights;
  std::vector<float> nee(tpt::flat_nee_words(p->n_lights, width) + 1);
  S.nee = nee.data();
  tpt::TripStats proto;
  proto.grid_h = grid_h;
  proto.grid_w = grid_w;
  proto.wc = (grid_w + 15) / 16;
  proto.spp = p->spp;
  proto.trips = trips;
  proto.work = work;
  proto.depth = depth;
  int next_tile = 0;
  if (width == 1) {
    tpt::HostLane w;
    tpt::TripStats ts = proto;
    return (long long)tpt::render_tiles_merged(w, S, cam, *p, &next_tile,
                                               out, ts);
  }
  tpt::Lanes lanes;
  unsigned long long lane_rays[32];
  std::vector<std::thread> threads;
  for (int l = 0; l < 32; ++l)
    threads.emplace_back([&, l] {
      tpt::ThreadWarp w{&lanes, l};
      tpt::TripStats ts = proto;
      lane_rays[l] =
          tpt::render_tiles_merged(w, S, cam, *p, &next_tile, out, ts);
    });
  for (auto& t : threads) t.join();
  if (lanes.broken) return -1;
  long long rays = 0;
  for (int l = 0; l < 32; ++l) rays += (long long)lane_rays[l];
  return rays;
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
                    "-ffp-contract=off", "-pthread", f"-I{_build.CSRC}",
                    "-o", str(so), str(d / "host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    params = ctypes.POINTER(_build.RenderParams)
    lib.tpt_render_stats_cpu.argtypes = [
        ptr, ptr, ptr, ptr, params, i32, i32, i32, ptr, ptr, ptr, ptr, ptr,
        ptr, ptr]
    lib.tpt_render_stats_merged_cpu.argtypes = [
        ptr, ptr, ptr, ptr, ptr, params, i32, i32, ptr, ptr, ptr, ptr, i32]
    lib.tpt_render_stats_merged_cpu.restype = ctypes.c_longlong
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


def render_stats_merged_host(lib, scene, cfg, frame, width):
    """K2's merged loop over cfg's padded grid in a warp of `width` lanes,
    its inputs and outputs prepared as ops/cuda_render does."""
    gh, gw = cuda_render.padded_grid(cfg)
    wr, wc = cuda_render.warp_grid(gh, gw)
    tab = cuda_render.pack_scene(scene)
    sph = cuda_render.pack_records(tab).numpy()
    tab = tab.numpy()
    mat = np.array(scene.mat_type, np.int32)
    lights = np.array(scene.emissive_ids or (0,), np.int32)
    cam = camera_to_array(make_camera(scene.camera, cfg.width / cfg.height))
    params = cuda_render.render_params(scene, cfg, frame, 0, 0, cfg.height,
                                       cfg.width)
    o = dict(out=np.full((cfg.height, cfg.width, 3), np.nan, np.float32),
             trips=np.full((3, gh, gw), -1, np.int32),
             work=np.zeros((wr, wc), np.int32),
             depth=np.zeros((wr, wc, cfg.samples_per_pixel), np.int32))
    o["rays"] = lib.tpt_render_stats_merged_cpu(
        tab.ctypes.data, sph.ctypes.data, mat.ctypes.data,
        lights.ctypes.data, cam.ctypes.data, ctypes.byref(params), gh, gw,
        *(o[k].ctypes.data for k in ("out", "trips", "work", "depth")),
        width)
    assert o["rays"] >= 0, "a 32-lane warp stalled at a collective"
    return o


MERGED_STATS = {
    "padded_46": (lambda: make_scene(big=True), "padded"),
    "cutoff_46": (lambda: make_scene(big=True), "cutoff"),
    "padded_600": (lambda: crowded_scene(extra=554), "padded"),
}


@pytest.mark.parametrize("case", sorted(MERGED_STATS))
@pytest.mark.parametrize("width", [1, 32], ids=["one_lane", "32_lanes"])
def test_merged_stats_loop_matches_render_pixel(host_lib, case, width):
    """K2 on the merged loop against render_pixel with Trips (the
    per-thread stats kernel's code), at 46 and 600 spheres on a padded
    grid: the image and rays bit-equal, the trip counts and both warp
    counters exactly equal, and the TPU's tile counters from them equal
    for the merged and the unmerged wavefront loop."""
    make, cfg_name = MERGED_STATS[case]
    scene = make()
    cfg = RenderConfig(**CFGS[cfg_name])
    H, W = cfg.height, cfg.width
    want = render_stats_host(host_lib, scene, cfg, 2)
    got = render_stats_merged_host(host_lib, scene, cfg, 2, width)
    np.testing.assert_array_equal(got["out"], want["out"][:H, :W])
    assert got["rays"] == int(want["rays"][:H, :W].sum())
    np.testing.assert_array_equal(got["trips"], want["trips"])
    it, wk = warp_counters(torch.from_numpy(want["depths"]), H, W)
    iters = torch.from_numpy(got["depth"].sum(axis=-1, dtype=np.int32))
    assert torch.equal(iters, it) and torch.equal(
        torch.from_numpy(got["work"]), wk)
    assert int(it.sum()) > 0 and (got["trips"][0] > 0).all()
    for merged in (False, True):
        c = cfg.replace(merged_wavefront=merged)
        counters = [cuda_render.StatsCounters(
            *(torch.from_numpy(t) for t in o["trips"]), it, wk)
            for o in (got, want)]
        for a, b in zip(*(cuda_render.tile_counters(x, c)
                          for x in counters)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("case", list(roofline.CASES))
def test_probe_chains_match_plain(host_lib, case):
    n, trips = 2048, 64
    out = np.zeros(n, np.float32)
    host_lib.tpt_probe_cpu(roofline.CASES[case].id, trips, n,
                           out.ctypes.data)
    want = roofline.chains_plain(case, trips, n).numpy()
    assert np.isfinite(out).all() and np.unique(out).size > 100
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=0)
