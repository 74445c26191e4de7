"""The differentiable wavefront's kernel pair (K1's tape instances, csrc/
render.cu merged_render_kernel<4> and <3>, and the sweep of
csrc/wavegrad.cu), its per-lane code built with g++ for the CPU and held
bit for bit against the kernels it stands beside.

Without nvcc the TPT_HD and TPT_WARP macros are plain `inline`, and the
warp policies of csrc/warp.cuh (HostLane, one lane) and csrc/hostwarp.h
(ThreadWarp, 32 host threads: a collective that not every lane reaches
stalls it) run the kernels' own warp code.

Held exactly: the tape-writing merged loop on the flat scene
(merged.cuh render_tiles_merged over flat.cuh's FlatView with a TapeSink,
flat.cuh nee_warp's kTape hook) writes for every (pixel, sample, bounce)
the record trace.cuh's trace_sample_tape writes, and each sample's
bounces, and its image and rays are the merged loop's without the tape;
so does the loop with a StagedTapeSink (tape.cuh: each record staged in
the lane's slot and written in quarters by four lanes, the staged
instance's writer), word for word the TapeSink's tape;
the sweep (coopgrad.cuh sweep_tiles over the flat SceneView) gives the
cotangent of K3's warp form (gradwarp.cuh grad_tiles, its 16-light
WarpTape records or past 16 lights LightTapeOf's) on the same warps, and
with a PoolTable a warp the pool form's at 600 spheres.  At 40 lights the
pair's cotangent against plain autograd through the plain wavefront, row
by row within 1e-3 of the row's max, as the other K3 CPU tests.
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
from toypathtracer_torch.tools.scenes import crowded_scene, many_lights_scene

torch.set_num_threads(1)

HARNESS = r"""
#include <thread>
#include <vector>

#include "coopgrad.cuh"
#include "flat.cuh"
#include "hostwarp.h"
#include "tape.cuh"
#include "wavesweep.cuh"

struct Flat {
  const float* tab;
  const float* sph;
  const int32_t* mat;
  const int32_t* lights;
  const float* cam;
};

static tpt::SceneView scene_view(const Flat& s, const tpt::RenderParams* p) {
  tpt::SceneView S;
  S.tab = s.tab;
  S.mat = s.mat;
  S.lights = s.lights;
  S.n = p->n_spheres;
  S.n_lights = p->n_lights;
  return S;
}

static tpt::FrameTape frame_tape(const tpt::RenderParams* p, float* rec,
                                 uint32_t* see, int32_t* depth) {
  tpt::FrameTape t;
  t.rec = rec;
  t.see = see;
  t.depth = depth;
  t.words = tpt::light_words(p->n_lights);
  t.spp = p->spp;
  t.max_depth = p->max_depth;
  t.width = p->width;
  return t;
}

// Runs f(warp policy, warp, lane) in n_warps warps of `lanes` lanes (1:
// HostLane; 32: ThreadWarp), one warp after the other; false if a warp
// stalled.
template <class F>
static bool run_warps(int n_warps, int lanes, F f) {
  for (int wi = 0; wi < n_warps; ++wi) {
    if (lanes == 1) {
      tpt::HostLane w;
      f(w, wi, 0);
      continue;
    }
    tpt::Lanes ls;
    std::vector<std::thread> threads;
    for (int l = 0; l < 32; ++l)
      threads.emplace_back([&, l] {
        tpt::ThreadWarp w{&ls, l};
        f(w, wi, l);
      });
    for (auto& t : threads) t.join();
    if (ls.broken) return false;
  }
  return true;
}

// A warp's cotangent table: kind 0 a (SCENE_ROWS, n) table a warp (the
// shared-memory instances), kind 1 a PoolTable a warp over a launch's
// shared directory, blocks and pool (the pool instances).  sum adds each
// entry's warps in warp order to acc.
struct Tables {
  int n, n_warps, dir_rows, block_cap, cap, next = 0, next_block = 0;
  std::vector<float> dense;
  std::vector<int> dir, blocks;
  std::vector<float> pool;
  Tables(int n_, int warps, bool pooled)
      : n(n_), n_warps(warps),
        dir_rows((n_ + tpt::kDirIds - 1) / tpt::kDirIds),
        block_cap(pooled ? dir_rows * warps : 0), cap(pooled ? n_ * warps : 0),
        dense(pooled ? 0 : (size_t)warps * tpt::SCENE_ROWS * n_, 0.0f),
        dir(pooled ? (size_t)dir_rows * warps : 0, -1),
        blocks((size_t)block_cap * tpt::kDirIds, -1),
        pool((size_t)cap * tpt::kSlotFloats, 0.0f) {}
  float* table(int wi) {
    return dense.data() + (size_t)wi * tpt::SCENE_ROWS * n;
  }
  tpt::PoolTable pool_table(int wi) {
    return tpt::PoolTable{dir.data() + wi, n_warps, blocks.data(),
                          &next_block, block_cap, pool.data(), &next, cap};
  }
  void sum(float* acc) const {
    for (int i = 0; i < n; ++i)
      for (int r = 0; r < tpt::SCENE_ROWS; ++r) {
        float s = 0.0f;
        for (int wi = 0; wi < n_warps; ++wi) {
          if (!dense.empty()) {
            s += dense[((size_t)wi * tpt::SCENE_ROWS + r) * n + i];
            continue;
          }
          const int b = dir[(size_t)(i / tpt::kDirIds) * n_warps + wi];
          if (b < 0) continue;
          const int slot =
              blocks[(size_t)b * tpt::kDirIds + i % tpt::kDirIds];
          if (slot >= 0) s += pool[(size_t)slot * tpt::kSlotFloats + r];
        }
        acc[(size_t)r * n + i] += s;
      }
  }
};

// The merged loop (K1) over the whole sub-image in one warp of `lanes`
// lanes, the table read where it lies: with tape 1 K1's scalar tape
// instance (a TapeSink a lane writing the FrameTape rec, see, depth), with
// tape 2 its staged instance (a StagedTapeSink a lane over the warp's
// staging slots), else K1.  Returns the rays, or -1 if the warp stalled.
extern "C" long long tpt_wave_tape_cpu(const Flat* s,
                                       const tpt::RenderParams* p,
                                       float* out, float* rec, uint32_t* see,
                                       int32_t* depth, int lanes, int tape) {
  tpt::FlatView S;
  static_cast<tpt::SceneView&>(S) = scene_view(*s, p);
  S.sph = reinterpret_cast<const tpt::Sphere4*>(s->sph);
  std::vector<float> nee(tpt::flat_nee_words(p->n_lights, lanes) + 1);
  S.nee = nee.data();
  const tpt::FrameTape ft = frame_tape(p, rec, see, depth);
  int next_tile = 0;
  unsigned long long lane_rays[32] = {};
  std::vector<float> stage(lanes * tpt::StagedTapeSink::kStageWords);
  const bool ok = run_warps(1, lanes, [&](auto& w, int, int l) {
    if (tape == 2) {
      tpt::StagedTapeSink sink;
      sink.tape = ft;
      sink.stage = stage.data();
      sink.lane = l;
      lane_rays[l] = tpt::render_tiles_merged(w, S, s->cam, *p, &next_tile,
                                              out, sink);
    } else if (tape) {
      tpt::TapeSink sink;
      sink.tape = ft;
      lane_rays[l] = tpt::render_tiles_merged(w, S, s->cam, *p, &next_tile,
                                              out, sink);
    } else {
      tpt::NoCoopCount none;
      lane_rays[l] = tpt::render_tiles_merged(w, S, s->cam, *p, &next_tile,
                                              out, none);
    }
  });
  if (!ok) return -1;
  long long rays = 0;
  for (int l = 0; l < 32; ++l) rays += lane_rays[l];
  return rays;
}

// The records trace_sample_tape writes for every (pixel, sample, bounce)
// of the sub-image in the FrameTape layout, each sample's bounces, and
// render_pixel's image and rays.
extern "C" long long tpt_wave_reference_cpu(const Flat* s,
                                            const tpt::RenderParams* p,
                                            float* out, float* rec,
                                            uint32_t* see, int32_t* depth) {
  const tpt::SceneView S = scene_view(*s, p);
  const tpt::FrameTape ft = frame_tape(p, rec, see, depth);
  long long rays = 0;
  for (int py = 0; py < p->height; ++py)
    for (int px = 0; px < p->width; ++px) {
      const int pix = py * p->width + px;
      uint32_t st = tpt::seed_pixel((uint32_t)(p->x0 + px),
                                    (uint32_t)(p->y0 + py), p->frame);
      uint32_t r = 0;
      tpt::V3 sum = tpt::v3(0.0f, 0.0f, 0.0f);
      for (int j = 0; j < p->spp; ++j) {
        tpt::V3 ro, rd;
        tpt::sample_ray(s->cam, *p, p->x0 + px, p->y0 + py, st, ro, rd);
        int d = 0;
        sum = tpt::add(sum, tpt::trace_sample_tape(
                                S, *p, ro, rd, st, r, d, ft,
                                (int)ft.slot(pix, j, 0)));
        depth[(size_t)pix * p->spp + j] = d;
      }
      out[(size_t)pix * 3] = sum.x * p->inv_spp;
      out[(size_t)pix * 3 + 1] = sum.y * p->inv_spp;
      out[(size_t)pix * 3 + 2] = sum.z * p->inv_spp;
      rays += r;
    }
  return rays;
}

// The sweep (csrc/wavegrad.cu wave_sweep_kernel, or with pooled
// wave_sweep_pool_kernel) over a tape: n_warps warps of `lanes` lanes,
// their tables summed in warp order into acc.  Returns 0, or -1 if a warp
// stalled.
extern "C" int tpt_wave_sweep_cpu(const Flat* s, const tpt::RenderParams* p,
                                  const float* g, float* acc, float* rec,
                                  uint32_t* see, int32_t* depth, int n_warps,
                                  int lanes, int pooled) {
  const tpt::SceneView S = scene_view(*s, p);
  const tpt::FrameTape ft = frame_tape(p, rec, see, depth);
  Tables t(p->n_spheres, n_warps, pooled != 0);
  std::vector<float> ws(tpt::grad_scratch_words(lanes));
  const bool ok = run_warps(n_warps, lanes, [&](auto& w, int wi, int) {
    tpt::NoGradCount none;
    if (pooled)
      tpt::sweep_tiles<false>(w, S, *p, g, t.pool_table(wi), ft, ws.data(),
                              wi, n_warps, none);
    else
      tpt::sweep_tiles<false>(w, S, *p, g, t.table(wi), ft, ws.data(), wi,
                              n_warps, none);
  });
  if (!ok) return -1;
  t.sum(acc);
  return 0;
}

// The redesigned sweep (csrc/wavesweep.cu wave_run_kernel: wavesweep.cuh
// sweep_runs, with fused its cheaper adds, bounce_adj_fused) over a tape,
// in warps of `lanes` lanes: run > 0, blocks of block_warps warps, each
// block's share run x block_warps tiles whose items depth_order sorts
// (under the same warp policy) and SortedQueue deals to its warps; run 0,
// sweep_tiles' deal over n_warps warps.  The warps' tables (with
// pooled a PoolTable a warp) summed in warp order into acc.
// Returns 0, or -1 if a warp stalled.
extern "C" int tpt_wave_run_cpu(const Flat* s, const tpt::RenderParams* p,
                                const float* g, float* acc, float* rec,
                                uint32_t* see, int32_t* depth, int n_warps,
                                int lanes, int run, int fused,
                                int block_warps, int pooled) {
  const tpt::SceneView S = scene_view(*s, p);
  const tpt::FrameTape ft = frame_tape(p, rec, see, depth);
  const int tw = lanes == 32 ? 8 : 1, th = lanes / tw;
  const int tiles = ((p->width + tw - 1) / tw) * ((p->height + th - 1) / th);
  const int per_block = run > 0 ? run * block_warps : 1;
  const int blocks = run > 0 ? (tiles + per_block - 1) / per_block : 0;
  if (run > 0) n_warps = blocks * block_warps;
  Tables t(p->n_spheres, n_warps, pooled != 0);
  std::vector<float> ws(tpt::run_scratch_words(lanes));
  const int items = per_block * p->spp * lanes;
  std::vector<int> dep(items), order(items), cnt(p->max_depth + 2);
  auto with_table = [&](auto& w, const auto& q, auto T) {
    tpt::NoGradCount none;
    if (fused)
      tpt::sweep_runs<true>(w, S, *p, g, T, ft, ws.data(), q, none);
    else
      tpt::sweep_runs(w, S, *p, g, T, ft, ws.data(), q, none);
  };
  auto sweep = [&](auto& w, int wi, const auto& q) {
    if (pooled)
      with_table(w, q, t.pool_table(wi));
    else
      with_table(w, q, t.table(wi));
  };
  if (run == 0)
    return run_warps(n_warps, lanes, [&](auto& w, int wi, int) {
             sweep(w, wi, tpt::TileQueue{tpt::tiles_deal(wi, n_warps,
                                                         tiles)});
           }) ? (t.sum(acc), 0) : -1;
  for (int b = 0; b < blocks; ++b) {
    tpt::RunDeal share{b * per_block, 1, tiles - b * per_block < per_block
                                             ? tiles - b * per_block
                                             : per_block};
    const int n = share.count * p->spp * lanes;
    for (int i = 0; i < n; ++i)
      dep[i] = lanes == 32 ? tpt::item_depth<32>(share, *p, ft, i)
                           : tpt::item_depth<1>(share, *p, ft, i);
    int valid = 0;
    if (!run_warps(1, lanes, [&](auto& w, int, int l) {
          const int v = tpt::depth_order(w, dep.data(), n, p->max_depth,
                                         cnt.data(), order.data());
          if (l == 0) valid = v;
        }))
      return -1;
    for (int wi = 0; wi < block_warps; ++wi)
      if (!run_warps(1, lanes, [&](auto& w, int, int) {
            sweep(w, b * block_warps + wi,
                  tpt::SortedQueue{share, dep.data(), order.data(), valid, wi,
                                   block_warps});
          }))
        return -1;
  }
  t.sum(acc);
  return 0;
}

// depth_order over dep[0..n) into order in one warp of `lanes` lanes;
// returns its count of items with a bounce, or -1 if the warp stalled.
extern "C" int tpt_depth_order_cpu(const int* dep, int n, int max_depth,
                                   int* order, int lanes) {
  std::vector<int> cnt(max_depth + 1);
  int valid = 0;
  const bool ok = run_warps(1, lanes, [&](auto& w, int, int l) {
    const int v = tpt::depth_order(w, dep, n, max_depth, cnt.data(), order);
    if (l == 0) valid = v;
  });
  return ok ? valid : -1;
}

// K3's warp form (csrc/grad.cu warp_grad_kernel: WarpTape records up to
// kMaxLights lights, lights_warp_grad_kernel's LightTapeOf<false> past
// them), or with pooled its pool form (pool_grad_kernel: LightTapeOf<true>
// records, a PoolTable a warp): n_warps warps of `lanes` lanes, their
// tables summed in warp order into acc.  Returns the rays, or -1 if a warp
// stalled.
extern "C" long long tpt_warp_form_cpu(const Flat* s,
                                       const tpt::RenderParams* p,
                                       const float* g, float* out, float* acc,
                                       int n_warps, int lanes, int pooled) {
  const tpt::SceneView S = scene_view(*s, p);
  Tables t(p->n_spheres, n_warps, pooled != 0);
  const int words = tpt::light_words(p->n_lights);
  const size_t slots = (size_t)lanes * tpt::grad_batch(*p) * p->max_depth;
  std::vector<float> recs(slots * tpt::kRecWords);
  std::vector<uint32_t> see(slots * words + 1);
  std::vector<float> ws(tpt::grad_scratch_words(lanes));
  unsigned long long lane_rays[32] = {};
  const bool ok = run_warps(n_warps, lanes, [&](auto& w, int wi, int l) {
    tpt::NoGradCount none;
    auto light_tape = [&](auto t) {
      t.base = recs.data();
      t.width = lanes;
      t.lane = l;
      t.see = see.data();
      t.words = words;
      return t;
    };
    if (pooled) {
      lane_rays[l] += tpt::grad_tiles<false>(
          w, S, s->cam, *p, g, out, t.pool_table(wi),
          light_tape(tpt::LightTapeOf<true>()), ws.data(), wi, n_warps, none);
    } else if (p->n_lights > tpt::kMaxLights) {
      lane_rays[l] += tpt::grad_tiles<false>(
          w, S, s->cam, *p, g, out, t.table(wi),
          light_tape(tpt::LightTapeOf<false>()), ws.data(), wi, n_warps,
          none);
    } else {
      const tpt::WarpTape tape{recs.data(), lanes, l};
      lane_rays[l] += tpt::grad_tiles<false>(w, S, s->cam, *p, g, out,
                                             t.table(wi), tape, ws.data(), wi,
                                             n_warps, none);
    }
  });
  if (!ok) return -1;
  t.sum(acc);
  long long rays = 0;
  for (int l = 0; l < 32; ++l) rays += lane_rays[l];
  return rays;
}
"""


class FlatArgs(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "tab", "sph", "mat", "lights", "cam")]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("wave_kernel_cpu")
    (d / "host.cpp").write_text(HARNESS)
    so = d / "libwave_cpu.so"
    # -ffp-contract=off: no FMA contraction, as the CUDA build's -fmad=false
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17",
                    "-ffp-contract=off", "-pthread", f"-I{_build.CSRC}",
                    "-o", str(so), str(d / "host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    ptr = ctypes.c_void_p
    params = ctypes.POINTER(_build.RenderParams)
    flat = ctypes.POINTER(FlatArgs)
    i32 = ctypes.c_int
    lib.tpt_wave_tape_cpu.argtypes = [flat, params, ptr, ptr, ptr, ptr, i32,
                                      i32]
    lib.tpt_wave_tape_cpu.restype = ctypes.c_longlong
    lib.tpt_wave_reference_cpu.argtypes = [flat, params, ptr, ptr, ptr, ptr]
    lib.tpt_wave_reference_cpu.restype = ctypes.c_longlong
    lib.tpt_wave_sweep_cpu.argtypes = [flat, params, ptr, ptr, ptr, ptr, ptr,
                                       i32, i32, i32]
    lib.tpt_wave_run_cpu.argtypes = [flat, params, ptr, ptr, ptr, ptr, ptr,
                                     i32, i32, i32, i32, i32, i32]
    lib.tpt_depth_order_cpu.argtypes = [ptr, i32, i32, ptr, i32]
    lib.tpt_warp_form_cpu.argtypes = [flat, params, ptr, ptr, ptr, i32, i32,
                                      i32]
    lib.tpt_warp_form_cpu.restype = ctypes.c_longlong
    return lib


class Case:
    """A flat scene's kernel inputs, prepared as ops/cuda_render does, a
    config and a sub-image, with empty tapes of the FrameTape layout."""

    def __init__(self, scene, cfg, frame=1, x0=0, y0=0):
        tab = cuda_render.pack_scene(scene)
        self.keep = dict(
            tab=tab.numpy(),
            sph=np.ascontiguousarray(cuda_render.pack_records(tab).numpy()),
            mat=np.array(scene.mat_type, np.int32),
            lights=np.array(scene.emissive_ids or (0,), np.int32),
            cam=camera_to_array(make_camera(scene.camera,
                                            cfg.width / cfg.height)))
        self.args = FlatArgs(**{k: v.ctypes.data
                                for k, v in self.keep.items()})
        h, w = cfg.height, cfg.width
        self.params = cuda_render.render_params(scene, cfg, frame, x0, y0, h,
                                                w)
        self.scene, self.cfg, self.frame, self.x0, self.y0 = (
            scene, cfg, frame, x0, y0)
        self.shape = (h, w, 3)

    def tape(self):
        """An empty tape (every word 0x7fc00001, a NaN no kernel writes)."""
        cfg = self.cfg
        samples = self.shape[0] * self.shape[1] * cfg.samples_per_pixel
        slots = samples * cfg.max_depth
        words = -(-len(self.scene.emissive_ids) // 32)
        return {"rec": np.full(slots * 16, 0x7fc00001, np.uint32),
                "see": np.full(max(1, slots * words), 0x7fc00001, np.uint32),
                "depth": np.full(samples, -7, np.int32)}

    def forward(self, lib, which, lanes=1):
        """which: "tape" (K1's scalar tape instance), "staged" (its staged
        instance), "k1" (K1) or "reference" (trace_sample_tape).  Returns
        (image, rays, tape)."""
        out = np.zeros(self.shape, np.float32)
        t = self.tape()
        ptrs = (out.ctypes.data, t["rec"].ctypes.data, t["see"].ctypes.data,
                t["depth"].ctypes.data)
        if which == "reference":
            rays = lib.tpt_wave_reference_cpu(ctypes.byref(self.args),
                                              ctypes.byref(self.params),
                                              *ptrs)
        else:
            rays = lib.tpt_wave_tape_cpu(ctypes.byref(self.args),
                                         ctypes.byref(self.params), *ptrs,
                                         lanes, WRITERS[which])
        assert rays >= 0, "a 32-lane warp stalled at a collective"
        return out, rays, t

    def sweep(self, lib, g, tape, n_warps, lanes, pooled=False):
        acc = np.zeros_like(self.keep["tab"])
        g = np.ascontiguousarray(g, np.float32)
        code = lib.tpt_wave_sweep_cpu(
            ctypes.byref(self.args), ctypes.byref(self.params),
            g.ctypes.data, acc.ctypes.data, tape["rec"].ctypes.data,
            tape["see"].ctypes.data, tape["depth"].ctypes.data, n_warps,
            lanes, int(pooled))
        assert code == 0, "a 32-lane warp stalled at a collective"
        return acc

    def run_sweep(self, lib, g, tape, n_warps, lanes, run, fused=False,
                  block_warps=4, pooled=False):
        """The redesigned sweep (sweep_runs; fused: with bounce_adj_fused's
        adds) over `tape`: run > 0, sorted blocks of block_warps warps and
        run tiles a warp; run 0, the kept sweep's deal and batches over
        n_warps warps; pooled: a PoolTable a warp."""
        acc = np.zeros_like(self.keep["tab"])
        g = np.ascontiguousarray(g, np.float32)
        code = lib.tpt_wave_run_cpu(
            ctypes.byref(self.args), ctypes.byref(self.params),
            g.ctypes.data, acc.ctypes.data, tape["rec"].ctypes.data,
            tape["see"].ctypes.data, tape["depth"].ctypes.data, n_warps,
            lanes, run, int(fused), block_warps, int(pooled))
        assert code == 0, "a 32-lane warp stalled at a collective"
        return acc

    def warp_form(self, lib, g, n_warps, lanes, pooled=False):
        out = np.zeros(self.shape, np.float32)
        acc = np.zeros_like(self.keep["tab"])
        g = np.ascontiguousarray(g, np.float32)
        rays = lib.tpt_warp_form_cpu(
            ctypes.byref(self.args), ctypes.byref(self.params),
            g.ctypes.data, out.ctypes.data, acc.ctypes.data, n_warps, lanes,
            int(pooled))
        assert rays >= 0, "a 32-lane warp stalled at a collective"
        return out, rays, acc


# tpt_wave_tape_cpu's tape argument
WRITERS = {"k1": 0, "tape": 1, "staged": 2}


def cotangent(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def assert_tapes_equal(got, want):
    for k in ("rec", "see", "depth"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("lanes", [1, 32])
@pytest.mark.parametrize("case", ["big", "small_no_nee", "forty_lights"])
def test_tape_loop_writes_trace_sample_tape_records(host_lib, case, lanes):
    """K1's tape instance: image and rays bit-equal to K1 (the merged loop
    without the tape) and to render_pixel, every (pixel, sample, bounce)
    record and every sample's bounces equal to trace_sample_tape's, the
    slots no sample reached untouched; at 40 lights the seen lights span
    two words."""
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=2, max_depth=4)
    scene = make_scene(big=True)
    if case == "small_no_nee":
        scene = make_scene(big=False)
        cfg = cfg.replace(do_light_sampling=False)
    elif case == "forty_lights":
        scene = many_lights_scene()
        cfg = cfg.replace(width=8, height=4, max_depth=3)
    c = Case(scene, cfg, frame=2, x0=3, y0=5)
    img_t, rays_t, tape = c.forward(host_lib, "tape", lanes)
    img_k, rays_k, untouched = c.forward(host_lib, "k1", lanes)
    img_r, rays_r, ref = c.forward(host_lib, "reference")
    np.testing.assert_array_equal(img_t, img_k)
    np.testing.assert_array_equal(img_t, img_r)
    assert rays_t == rays_k == rays_r
    assert_tapes_equal(tape, ref)
    assert_tapes_equal(untouched, c.tape())  # K1 writes no tape
    assert (tape["depth"] >= 1).all()


@pytest.mark.parametrize("lanes", [1, 32])
@pytest.mark.parametrize("case", ["big", "small_no_nee", "forty_lights"])
def test_staged_tape_loop_writes_tape_sink_records(host_lib, case, lanes):
    """K1's staged tape instance (StagedTapeSink: each record staged in
    the lane's slot and handed to the tape in quarters, four lanes a
    record): image and rays bit-equal to K1, every word of the tape (rec,
    see, depth) equal to TapeSink's and to trace_sample_tape's, the slots
    no sample reached untouched; at 40 lights the seen lights span two
    words, without light sampling no Lambert lane writes one."""
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=2, max_depth=4)
    scene = make_scene(big=True)
    if case == "small_no_nee":
        scene = make_scene(big=False)
        cfg = cfg.replace(do_light_sampling=False)
    elif case == "forty_lights":
        scene = many_lights_scene()
        cfg = cfg.replace(width=8, height=4, max_depth=3)
    c = Case(scene, cfg, frame=2, x0=3, y0=5)
    img_s, rays_s, staged = c.forward(host_lib, "staged", lanes)
    img_t, rays_t, tape = c.forward(host_lib, "tape", lanes)
    img_r, rays_r, ref = c.forward(host_lib, "reference")
    np.testing.assert_array_equal(img_s, img_t)
    np.testing.assert_array_equal(img_s, img_r)
    assert rays_s == rays_t == rays_r
    assert_tapes_equal(staged, tape)
    assert_tapes_equal(staged, ref)
    assert (staged["depth"] >= 1).all()
    # the slots past each sample's last bounce keep the empty tape's NaN
    reached = (np.arange(cfg.max_depth)[None, :]
               < staged["depth"].reshape(-1, 1))
    rec = staged["rec"].reshape(-1, cfg.max_depth, 16)
    assert (rec[~reached] == 0x7fc00001).all()
    assert (rec[reached] != 0x7fc00001).any(axis=-1).all()


@pytest.mark.parametrize("lanes,n_warps", [(1, 3), (32, 3)])
@pytest.mark.parametrize("spp,depth", [(6, 4), (2, 10)])
def test_sweep_bit_equal_to_warp_form(host_lib, spp, depth, lanes, n_warps):
    """The sweep over the tape instance's tape: the cotangent of K3's warp
    form on the same warps (the same tiles, batches and queue), bit for
    bit, over two sample batches (spp 6) and at depth 10; the warp form's
    image and rays the tape instance's."""
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=spp,
                       max_depth=depth)
    c = Case(make_scene(big=True), cfg, frame=1)
    g = cotangent(c.shape, 7)
    img_t, rays_t, tape = c.forward(host_lib, "tape", 1)
    d_sweep = c.sweep(host_lib, g, tape, n_warps, lanes)
    img_w, rays_w, d_warp = c.warp_form(host_lib, g, n_warps, lanes)
    np.testing.assert_array_equal(img_w, img_t)
    assert rays_w == rays_t
    np.testing.assert_array_equal(d_sweep, d_warp)
    assert np.abs(d_sweep).max() > 0


@pytest.mark.parametrize("lanes", [1, 32])
def test_pool_sweep_bit_equal_to_pool_form(host_lib, lanes):
    """Past 512 spheres (600, tools/scenes.crowded_scene): the sweep with a
    PoolTable a warp bit-equal to K3's pool form on the same warps."""
    cfg = RenderConfig(width=16, height=4, samples_per_pixel=1, max_depth=3)
    c = Case(crowded_scene(extra=554), cfg, frame=0)
    g = cotangent(c.shape, 3)
    _, _, tape = c.forward(host_lib, "tape", 1)
    d_sweep = c.sweep(host_lib, g, tape, 2, lanes, pooled=True)
    _, _, d_pool = c.warp_form(host_lib, g, 2, lanes, pooled=True)
    np.testing.assert_array_equal(d_sweep, d_pool)
    assert np.abs(d_sweep).max() > 0


@pytest.mark.parametrize("lanes", [1, 32])
def test_run_pool_sweep_against_kept_pool_sweep(host_lib, lanes):
    """Past 512 spheres (600, tools/scenes.crowded_scene): the redesigned
    sweep with a PoolTable a warp (csrc/wavesweep.cu wave_run_pool_kernel:
    sorted blocks, the fused adds) within 1e-4 x each row's max of the kept
    pool sweep on the same tape, two runs bit-equal."""
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=2, max_depth=3)
    c = Case(crowded_scene(extra=554), cfg, frame=0)
    g = cotangent(c.shape, 3)
    _, _, tape = c.forward(host_lib, "staged", 1)
    d_kept = c.sweep(host_lib, g, tape, 2, lanes, pooled=True)
    d_run = c.run_sweep(host_lib, g, tape, 0, lanes, 1, True, 2, True)
    assert_rows_close(d_run, d_kept, 1e-4)
    np.testing.assert_array_equal(
        c.run_sweep(host_lib, g, tape, 0, lanes, 1, True, 2, True), d_run)
    assert np.abs(d_run).max() > 0


def test_forty_lights_pair_matches_plain_wavefront(host_lib):
    """40 lights (tools/scenes.many_lights_scene): the pair's cotangent
    bit-equal to K3's lights instance on the same warps and, row by row,
    within 1e-3 of the row's max of autograd through the plain wavefront
    (the sum orders differ)."""
    cfg = RenderConfig(width=8, height=4, samples_per_pixel=2, max_depth=3,
                       merged_wavefront=True, diff_wavefront=True)
    scene = many_lights_scene()
    c = Case(scene, cfg, frame=0)
    g = cotangent(c.shape, 11)
    _, _, tape = c.forward(host_lib, "tape", 32)
    d_sweep = c.sweep(host_lib, g, tape, 1, 32)
    _, _, d_warp = c.warp_form(host_lib, g, 1, 32)
    np.testing.assert_array_equal(d_sweep, d_warp)
    _, _, d_plain = render_tile_grad_plain(scene, cfg, 0,
                                           torch.from_numpy(g), 0, 0, 4, 8)
    d_plain = d_plain.numpy()
    for r in range(14):
        scale = np.abs(d_plain[r]).max()
        np.testing.assert_allclose(d_sweep[r], d_plain[r], rtol=0,
                                   atol=1e-3 * scale + 1e-12, err_msg=r)


def assert_rows_close(got, want, rel):
    """Per row of a (14, N) table: max |got - want| <= rel x the row's max
    |want| (exact where the row is zero)."""
    for r in range(want.shape[0]):
        scale = np.abs(want[r]).max()
        np.testing.assert_allclose(got[r], want[r], rtol=0,
                                   atol=rel * scale, err_msg=r)


@pytest.mark.parametrize("lanes,n_warps", [(1, 3), (32, 3)])
@pytest.mark.parametrize("spp,depth", [(6, 4), (2, 10)])
def test_run_sweep_against_kept_sweep(host_lib, spp, depth, lanes, n_warps):
    """The redesigned sweep (sweep_runs): on the kept sweep's deal (run 0)
    bit-equal to it on the same warps -- the same claims in the same order,
    with the next sample claimed and the next record fetched before the
    adjoint -- over two sample batches (spp 6) and at depth 10; with its
    blocks' items sorted by bounces and dealt to 1, 2 or 4 warps (runs of 1,
    2 and 3 tiles a warp), with and without the fused adds, within 1e-4 x
    each row's max of it, each two runs bit-equal."""
    cfg = RenderConfig(width=24, height=12, samples_per_pixel=spp,
                       max_depth=depth)
    c = Case(make_scene(big=True), cfg, frame=1, x0=2, y0=3)
    g = cotangent(c.shape, 5)
    _, _, tape = c.forward(host_lib, "staged", 1)
    d_kept = c.sweep(host_lib, g, tape, n_warps, lanes)
    assert np.abs(d_kept).max() > 0
    np.testing.assert_array_equal(c.run_sweep(host_lib, g, tape, n_warps,
                                              lanes, 0), d_kept)
    for run, fused, bw in ((1, False, 4), (3, False, 2), (1, True, 1),
                           (3, True, 4), (2, True, 2), (0, True, 4)):
        d_run = c.run_sweep(host_lib, g, tape, n_warps, lanes, run, fused,
                            bw)
        assert_rows_close(d_run, d_kept, 1e-4)
        np.testing.assert_array_equal(
            c.run_sweep(host_lib, g, tape, n_warps, lanes, run, fused, bw),
            d_run)


@pytest.mark.parametrize("lanes", [1, 32])
def test_run_sweep_edge_tiles_and_forty_lights(host_lib, lanes):
    """Past the sub-image's edge (a 13x6 sub-image: tiles with pixels
    outside it, whose items the queue passes over and the sort puts last)
    and at 40 lights (the seen lights in two words, the second read where
    it lies): the redesigned sweep bit-equal to the kept one on its deal
    and within 1e-4 x each row's max with sorted blocks, its adds and the
    fused ones; within 1e-3 x each row's max of autograd through the plain
    wavefront."""
    cfg = RenderConfig(width=13, height=6, samples_per_pixel=2, max_depth=3,
                       merged_wavefront=True, diff_wavefront=True)
    scene = many_lights_scene()
    c = Case(scene, cfg, frame=0)
    g = cotangent(c.shape, 13)
    _, _, tape = c.forward(host_lib, "staged", lanes)
    d_kept = c.sweep(host_lib, g, tape, 2, lanes)
    np.testing.assert_array_equal(c.run_sweep(host_lib, g, tape, 2, lanes, 0),
                                  d_kept)
    d_run = c.run_sweep(host_lib, g, tape, 2, lanes, 2, False, 2)
    assert_rows_close(d_run, d_kept, 1e-4)
    d_fused = c.run_sweep(host_lib, g, tape, 2, lanes, 1, True, 4)
    assert_rows_close(d_fused, d_kept, 1e-4)
    _, _, d_plain = render_tile_grad_plain(scene, cfg, 0, torch.from_numpy(g),
                                           0, 0, 6, 13)
    assert_rows_close(d_run, d_plain.numpy(), 1e-3)


@pytest.mark.parametrize("lanes", [1, 32])
def test_depth_order_is_a_stable_sort_by_bounces(host_lib, lanes):
    """depth_order (wavesweep.cuh: a block's items from the most bounces to
    the fewest, each count's items in index order) under one lane and 32
    host threads: numpy's stable argsort of -bounces, over 0..max_depth
    bounces and lengths that are not a multiple of the warp's width; the
    count of items with a bounce returned."""
    rng = np.random.default_rng(17)
    for n, max_depth in ((1, 1), (45, 10), (300, 3), (1024, 255)):
        dep = rng.integers(0, max_depth + 1, n).astype(np.int32)
        order = np.full(n, -1, np.int32)
        valid = host_lib.tpt_depth_order_cpu(dep.ctypes.data, n, max_depth,
                                             order.ctypes.data, lanes)
        np.testing.assert_array_equal(order, np.argsort(-dep, kind="stable"))
        assert valid == int((dep > 0).sum())
