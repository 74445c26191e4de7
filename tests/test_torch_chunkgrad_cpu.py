"""K3's cooperative chunked form (csrc/coopgrad.cuh: the scaled render's
merged loop writing a frame tape, the reverse sweep over it, the soft
scans as warp walks), built with g++ for the CPU and held against the per-lane
chunked instance (gradwarp.cuh grad_tiles over chunks.cuh's
GradChunkedView with a PoolTable a warp), its g++ form here too.

Without nvcc the TPT_HD and TPT_WARP macros are plain `inline`, and the
warp policies of csrc/warp.cuh (HostLane, one lane) and csrc/hostwarp.h
(ThreadWarp, 32 host threads: a collective that not every lane reaches
stalls it) run the kernels' own warp code.

Held exactly, bit for bit: the tape-writing loop's image and rays against
the baseline's (its primal is the per-lane render), its tape against the
records trace.cuh's trace_sample_tape writes for every (pixel, sample,
bounce) and the bounces of every sample; the sweep's cotangent against the
baseline's on the same warps (the same tiles dealt to the same warps, the
same adds in the same order), hard and soft (eps 1.0, where the scans
matter most), in one-lane warps and in two 32-lane warps.  The
cooperative scans alone: silhouette_warp and occluder_warp against
chunks.cuh's sequential scans on random rays, including ties forced by
duplicated spheres and rays with NaN components.  And past 32 lights: a
40-light scaled scene, the cooperative form's cotangent against plain
autograd (row by row within 1e-3 of the row's max, as the other K3 CPU
tests).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from toypathtracer_torch import RenderConfig
from toypathtracer_torch.camera import camera_to_array, make_camera
from toypathtracer_torch.ops import _build, cuda_render
from toypathtracer_torch.scaled import (boxes_grouped, chunk_index,
                                        group_boxes, make_scaled_scene,
                                        pack_chunks,
                                        render_tile_scaled_grad_plain,
                                        soft_boxes)

torch.set_num_threads(1)

HARNESS = r"""
#include <thread>
#include <vector>

#include "coopgrad.cuh"
#include "hostwarp.h"

struct Scene {
  const float* tab;
  const int32_t* mat;
  const int32_t* lights;
  const float* rows;
  const float* box;
  const float* sil_box;
  const float* prox_box;
  const int32_t* order;
  const float* rec;
  const float* sil_walk;
  const float* sil_gbox;
  const float* prox_walk;
  const float* prox_gbox;
  const float* gbox;  // the render's group boxes over the rows' order
  int n_groups, render_groups, n_chunks, chunk;
};

static tpt::CoopGradView grad_view(const Scene& s,
                                   const tpt::RenderParams* p) {
  tpt::CoopGradView S;
  S.tab = s.tab;
  S.mat = s.mat;
  S.lights = s.lights;
  S.rows = s.rows;
  S.box = s.box;
  S.n = p->n_spheres;
  S.n_lights = p->n_lights;
  S.chunk = s.chunk;
  S.n_chunks = s.n_chunks;
  S.sil_box = s.sil_box;
  S.prox_box = s.prox_box;
  S.order = s.order;
  S.rec = reinterpret_cast<const tpt::Sphere4*>(s.rec);
  S.sil_walk = s.sil_walk;
  S.sil_gbox = s.sil_gbox;
  S.prox_walk = s.prox_walk;
  S.prox_gbox = s.prox_gbox;
  S.n_groups = s.n_groups;
  S.scan = nullptr;
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

// Runs f(warp policy, lane) in n_warps warps of `lanes` lanes (1:
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

// A PoolTable a warp over a launch's shared directory, blocks and pool,
// and the sum of each sphere's slots in warp order into acc.
struct Pool {
  int n, n_warps, dir_rows, block_cap, cap, next = 0, next_block = 0;
  std::vector<int> dir, blocks;
  std::vector<float> pool;
  Pool(int n_, int warps)
      : n(n_), n_warps(warps),
        dir_rows((n_ + tpt::kDirIds - 1) / tpt::kDirIds),
        block_cap(dir_rows * warps), cap(n_ * warps),
        dir((size_t)dir_rows * warps, -1),
        blocks((size_t)block_cap * tpt::kDirIds, -1),
        pool((size_t)cap * tpt::kSlotFloats, 0.0f) {}
  tpt::PoolTable table(int wi) {
    return tpt::PoolTable{dir.data() + wi, n_warps, blocks.data(),
                          &next_block, block_cap, pool.data(), &next, cap};
  }
  void sum(float* acc) const {
    for (int i = 0; i < n; ++i)
      for (int r = 0; r < tpt::SCENE_ROWS; ++r) {
        float s = 0.0f;
        for (int wi = 0; wi < n_warps; ++wi) {
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

// The per-lane chunked instance (csrc/grad.cu chunk_grad_kernel): grad_tiles
// over GradChunkedView with WideTape carries; its soft instance where
// p->soft_eps > 0.  Returns the rays, or -1 if a warp stalled.
extern "C" long long tpt_chunk_baseline_cpu(
    const Scene* s, const float* cam, const tpt::RenderParams* p,
    const float* g, float* out, float* acc, int n_warps, int lanes) {
  const tpt::CoopGradView C = grad_view(*s, p);
  const tpt::GradChunkedView& V = C;
  Pool pool(p->n_spheres, n_warps);
  std::vector<float> recs((size_t)lanes * tpt::grad_batch(*p) *
                          p->max_depth * tpt::kRecWords);
  std::vector<float> ws(tpt::grad_scratch_words(lanes));
  unsigned long long lane_rays[32] = {};
  const bool ok = run_warps(n_warps, lanes, [&](auto& w, int wi, int l) {
    const tpt::WideTape tape{recs.data(), lanes, l};
    tpt::NoGradCount none;
    lane_rays[l] += p->soft_eps > 0.0f
        ? tpt::grad_tiles<true>(w, V, cam, *p, g, out, pool.table(wi), tape,
                                ws.data(), wi, n_warps, none)
        : tpt::grad_tiles<false>(w, V, cam, *p, g, out, pool.table(wi), tape,
                                 ws.data(), wi, n_warps, none);
  });
  if (!ok) return -1;
  pool.sum(acc);
  long long rays = 0;
  for (int l = 0; l < 32; ++l) rays += lane_rays[l];
  return rays;
}

// The records trace_sample_tape writes for every (pixel, sample, bounce)
// of the sub-image, in the FrameTape layout, with each sample's bounces;
// the image and the rays of render_pixel.
extern "C" long long tpt_reference_tape_cpu(
    const Scene* s, const float* cam, const tpt::RenderParams* p, float* out,
    float* rec, uint32_t* see, int32_t* depth) {
  const tpt::CoopGradView C = grad_view(*s, p);
  const tpt::ChunkedView& V = C;
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
        tpt::sample_ray(cam, *p, p->x0 + px, p->y0 + py, st, ro, rd);
        int d = 0;
        sum = tpt::add(sum, tpt::trace_sample_tape(
                                V, *p, ro, rd, st, r, d, ft,
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

// The tape-writing forward (csrc/scaled.cu tape_render_kernel's loop):
// render_tiles_merged over the view of its instance (CoopView, or
// CoopViewLights past kCoopNeeGroup lights) with a TapeSink a lane, one
// warp of `lanes` lanes.  Returns the rays, or -1 if the warp stalled.
template <class View>
static long long tape_forward(const Scene* s, const float* cam,
                              const tpt::RenderParams* p, float* out,
                              float* rec, uint32_t* see, int32_t* depth,
                              int lanes) {
  const tpt::CoopGradView C = grad_view(*s, p);
  View S;
  static_cast<tpt::ChunkedView&>(S) = C;
  S.gbox = s->gbox;
  S.n_groups = s->render_groups;
  std::vector<float> nee(
      tpt::nee_words(tpt::nee_group(p->n_lights), lanes) + 1);
  S.nee = nee.data();
  const tpt::FrameTape ft = frame_tape(p, rec, see, depth);
  int next_tile = 0;
  unsigned long long lane_rays[32] = {};
  const bool ok = run_warps(1, lanes, [&](auto& w, int, int l) {
    tpt::TapeSink sink;
    sink.tape = ft;
    lane_rays[l] = tpt::render_tiles_merged(w, S, cam, *p, &next_tile, out,
                                            sink);
  });
  if (!ok) return -1;
  long long rays = 0;
  for (int l = 0; l < 32; ++l) rays += lane_rays[l];
  return rays;
}

extern "C" long long tpt_tape_forward_cpu(
    const Scene* s, const float* cam, const tpt::RenderParams* p, float* out,
    float* rec, uint32_t* see, int32_t* depth, int lanes) {
  return p->n_lights > tpt::kCoopNeeGroup
             ? tape_forward<tpt::CoopViewLights>(s, cam, p, out, rec, see,
                                                 depth, lanes)
             : tape_forward<tpt::CoopView>(s, cam, p, out, rec, see, depth,
                                           lanes);
}

// The reverse sweep (csrc/chunkgrad.cu chunk_sweep_kernel) over a tape:
// n_warps warps of `lanes` lanes, a PoolTable a warp, the slots summed in
// warp order into acc.  Returns 0, or -1 if a warp stalled.
extern "C" int tpt_sweep_cpu(const Scene* s, const tpt::RenderParams* p,
                             const float* g, float* acc, float* rec,
                             uint32_t* see, int32_t* depth, int n_warps,
                             int lanes) {
  tpt::CoopGradView C = grad_view(*s, p);
  std::vector<float> scan(tpt::scan_words(lanes));
  C.scan = scan.data();
  const tpt::FrameTape ft = frame_tape(p, rec, see, depth);
  Pool pool(p->n_spheres, n_warps);
  std::vector<float> ws(tpt::grad_scratch_words(lanes));
  const bool ok = run_warps(n_warps, lanes, [&](auto& w, int wi, int) {
    tpt::NoGradCount none;
    if (p->soft_eps > 0.0f) {
      tpt::sweep_tiles<true>(w, C, *p, g, pool.table(wi), ft, ws.data(), wi,
                             n_warps, none);
    } else {
      const tpt::GradChunkedView& V = C;
      tpt::sweep_tiles<false>(w, V, *p, g, pool.table(wi), ft, ws.data(), wi,
                              n_warps, none);
    }
  });
  if (!ok) return -1;
  pool.sum(acc);
  return 0;
}

// The cooperative scans on n rays, in warps of `lanes` lanes: kind 0 the
// silhouette candidate (d, nb, id) against chunks.cuh's
// silhouette_candidate, kind 1 the shadow-boundary occluder (d, id) of
// light `lights_of[i]` over (t_min, t_l[i]) against shadow_occluder.  Lanes
// past n take part with no ray.  Writes both answers: got (n, 3), want
// (n, 3).  Returns 0, or -1 if a warp stalled.
extern "C" int tpt_scans_cpu(const Scene* s, const tpt::RenderParams* p,
                             int kind, const float* ro, const float* rd,
                             const float* t_l, const int32_t* lights_of,
                             int n, float t_min, int lanes, float* got,
                             float* want) {
  const tpt::CoopGradView C = grad_view(*s, p);
  const tpt::GradChunkedView& V = C;
  const int warps = (n + lanes - 1) / lanes;
  return run_warps(warps, lanes, [&](auto& w, int wi, int l) {
    const int i = wi * lanes + l;
    const bool valid = i < n;
    const int k = valid ? i : 0;
    const tpt::V3 o = tpt::v3(ro[3 * k], ro[3 * k + 1], ro[3 * k + 2]);
    const tpt::V3 d = tpt::v3(rd[3 * k], rd[3 * k + 1], rd[3 * k + 2]);
    float gd = 0.0f, gnb = 0.0f;
    int gid;
    if (kind == 0)
      gid = tpt::silhouette_warp(w, C, valid, o, d, t_min, gd, gnb);
    else
      gid = tpt::occluder_warp(w, C, valid, o, d, lights_of[k], t_min,
                               t_l[k], gd);
    if (!valid) return;
    float wd = 0.0f, wnb = 0.0f;
    const int wid =
        kind == 0 ? tpt::silhouette_candidate(V, o, d, t_min, wd, wnb)
                  : tpt::shadow_occluder(V, o, d, lights_of[k], t_min,
                                         t_l[k], wd);
    got[3 * i] = gd;
    got[3 * i + 1] = gnb;
    got[3 * i + 2] = (float)gid;
    want[3 * i] = wd;
    want[3 * i + 1] = wnb;
    want[3 * i + 2] = (float)wid;
  }) ? 0 : -1;
}
"""


class SceneArgs(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "tab", "mat", "lights", "rows", "box", "sil_box", "prox_box",
        "order", "rec", "sil_walk", "sil_gbox", "prox_walk", "prox_gbox",
        "gbox")] + [(name, ctypes.c_int) for name in (
            "n_groups", "render_groups", "n_chunks", "chunk")]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("chunkgrad_cpu")
    (d / "host.cpp").write_text(HARNESS)
    so = d / "libchunkgrad_cpu.so"
    # -ffp-contract=off: no FMA contraction, as the CUDA build's -fmad=false
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17",
                    "-ffp-contract=off", "-pthread", f"-I{_build.CSRC}",
                    "-o", str(so), str(d / "host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    ptr = ctypes.c_void_p
    params = ctypes.POINTER(_build.RenderParams)
    scene = ctypes.POINTER(SceneArgs)
    i32 = ctypes.c_int
    lib.tpt_chunk_baseline_cpu.argtypes = [scene, ptr, params, ptr, ptr, ptr,
                                           i32, i32]
    lib.tpt_chunk_baseline_cpu.restype = ctypes.c_longlong
    lib.tpt_reference_tape_cpu.argtypes = [scene, ptr, params, ptr, ptr, ptr,
                                           ptr]
    lib.tpt_reference_tape_cpu.restype = ctypes.c_longlong
    lib.tpt_tape_forward_cpu.argtypes = [scene, ptr, params, ptr, ptr, ptr,
                                         ptr, i32]
    lib.tpt_tape_forward_cpu.restype = ctypes.c_longlong
    lib.tpt_sweep_cpu.argtypes = [scene, params, ptr, ptr, ptr, ptr, ptr, i32,
                                  i32]
    lib.tpt_scans_cpu.argtypes = [scene, params, i32, ptr, ptr, ptr, ptr, i32,
                                  ctypes.c_float, i32, ptr, ptr]
    return lib


class Inputs:
    """A ScaledScene's kernel inputs for the harness, prepared as
    ops/cuda_scaled does (the soft boxes at cfg's eps, or 1.0 where the
    config is hard, so the scans have boxes to walk)."""

    def __init__(self, scene, cfg):
        K = scene.chunk
        rows = pack_chunks(scene)
        box = rows[:, 4 * K:4 * K + 6].contiguous()
        rmax = scene.radius.reshape(-1, K).amax(dim=1)
        soft = soft_boxes(box, rmax, cfg.soft_silhouette_eps or 1.0)
        index = chunk_index(rows, K)
        order = index.order.long()
        walk = {k: soft[k][order].contiguous()
                for k in ("silhouette", "proximity")}
        arrays = dict(
            tab=cuda_render.pack_scene(scene), mat=scene.mat_ids(),
            lights=torch.tensor(list(scene.emissive_ids) or [0],
                                dtype=torch.int32),
            rows=rows, box=box, sil_box=soft["silhouette"],
            prox_box=soft["proximity"], order=index.order, rec=index.rec,
            sil_walk=walk["silhouette"],
            sil_gbox=boxes_grouped(walk["silhouette"]),
            prox_walk=walk["proximity"],
            prox_gbox=boxes_grouped(walk["proximity"]),
            gbox=group_boxes(rows, K))
        self.keep = {k: np.ascontiguousarray(v.detach().numpy())
                     for k, v in arrays.items()}
        self.args = SceneArgs(
            **{k: v.ctypes.data for k, v in self.keep.items()},
            n_groups=self.keep["sil_gbox"].shape[0],
            render_groups=self.keep["gbox"].shape[0],
            n_chunks=scene.n_chunks, chunk=K)
        self.cam = camera_to_array(make_camera(scene.camera,
                                               cfg.width / cfg.height))
        self.scene, self.cfg = scene, cfg

    def params(self, frame, x0, y0, h, w):
        return cuda_render.render_params(self.scene, self.cfg, frame, x0, y0,
                                         h, w)


def new_tape(inp, h, w):
    cfg = inp.cfg
    samples = h * w * cfg.samples_per_pixel
    words = -(-len(inp.scene.emissive_ids) // 32)
    return (np.full(samples * cfg.max_depth * 16, np.nan, np.float32),
            np.full(max(1, samples * cfg.max_depth * words), 0xFFFFFFFF,
                    np.uint32),
            np.full(samples, -1, np.int32))


def reference_tape(lib, inp, frame, x0, y0, h, w):
    out = np.zeros((h, w, 3), np.float32)
    tape = new_tape(inp, h, w)
    rays = lib.tpt_reference_tape_cpu(
        ctypes.byref(inp.args), inp.cam.ctypes.data,
        ctypes.byref(inp.params(frame, x0, y0, h, w)), out.ctypes.data,
        *(t.ctypes.data for t in tape))
    return out, rays, tape


def tape_forward(lib, inp, frame, x0, y0, h, w, lanes):
    out = np.zeros((h, w, 3), np.float32)
    tape = new_tape(inp, h, w)
    rays = lib.tpt_tape_forward_cpu(
        ctypes.byref(inp.args), inp.cam.ctypes.data,
        ctypes.byref(inp.params(frame, x0, y0, h, w)), out.ctypes.data,
        *(t.ctypes.data for t in tape), lanes)
    assert rays >= 0, "a 32-lane warp stalled at a collective"
    return out, rays, tape


def sweep(lib, inp, frame, x0, y0, g, tape, n_warps, lanes):
    h, w, _ = g.shape
    acc = np.zeros_like(inp.keep["tab"])
    g = np.ascontiguousarray(g, np.float32)
    code = lib.tpt_sweep_cpu(
        ctypes.byref(inp.args), ctypes.byref(inp.params(frame, x0, y0, h, w)),
        g.ctypes.data, acc.ctypes.data, *(t.ctypes.data for t in tape),
        n_warps, lanes)
    assert code == 0, "a 32-lane warp stalled at a collective"
    return acc


def baseline(lib, inp, frame, x0, y0, g, n_warps, lanes):
    h, w, _ = g.shape
    out = np.zeros((h, w, 3), np.float32)
    acc = np.zeros_like(inp.keep["tab"])
    g = np.ascontiguousarray(g, np.float32)
    rays = lib.tpt_chunk_baseline_cpu(
        ctypes.byref(inp.args), inp.cam.ctypes.data,
        ctypes.byref(inp.params(frame, x0, y0, h, w)), g.ctypes.data,
        out.ctypes.data, acc.ctypes.data, n_warps, lanes)
    assert rays >= 0, "a 32-lane warp stalled at a collective"
    return out, rays, acc


def assert_rows_close(got, want, rtol):
    for r in range(want.shape[0]):
        scale = np.abs(want[r]).max()
        assert np.abs(got[r] - want[r]).max() <= rtol * scale, (
            r, np.abs(got[r] - want[r]).max(), scale)


@pytest.fixture(scope="module")
def scene_2048():
    return make_scaled_scene(n=2048, chunk=64, extent=40.0)


@pytest.mark.parametrize("lanes", [1, 32])
def test_tape_forward_writes_trace_sample_tapes_records(host_lib, scene_2048,
                                                        lanes):
    """The merged loop with a TapeSink, one warp of one lane or of 32
    threads, at 32x8, spp 2, depth 3 on the 2048-sphere scene: the image
    and rays render_pixel's bit for bit, and every record and bounce count
    of the tape the ones trace_sample_tape writes (the unused slots of
    samples that ended early left as they were)."""
    cfg = RenderConfig(width=32, height=8, samples_per_pixel=2, max_depth=3)
    inp = Inputs(scene_2048, cfg)
    out, rays, tape = tape_forward(host_lib, inp, 1, 0, 0, 8, 32, lanes)
    r_out, r_rays, r_tape = reference_tape(host_lib, inp, 1, 0, 0, 8, 32)
    assert rays == r_rays and rays > 2 * 8 * 32
    np.testing.assert_array_equal(out, r_out)
    np.testing.assert_array_equal(tape[2], r_tape[2])
    assert tape[2].min() >= 1 and tape[2].max() <= 3
    np.testing.assert_array_equal(tape[0].view(np.uint32),
                                  r_tape[0].view(np.uint32))
    np.testing.assert_array_equal(tape[1], r_tape[1])


@pytest.mark.parametrize("eps", [0.0, 1.0], ids=["hard", "soft"])
@pytest.mark.parametrize("warps,lanes", [(1, 1), (3, 1), (2, 32)])
def test_sweep_bit_equal_to_chunked_instance(host_lib, scene_2048, eps, warps,
                                             lanes):
    """The tape-writing loop and the sweep over its tape against the
    per-lane chunked instance on the same warps (2048 spheres, chunk 64,
    32x8, spp 1, depth 3, hard and eps 1.0; one one-lane warp, three, and
    two 32-lane warps): image, rays and d_packed bit for bit, and d_packed
    within 1e-3 of plain autograd row by row."""
    cfg = RenderConfig(width=32, height=8, samples_per_pixel=1, max_depth=3,
                       soft_silhouette_eps=eps)
    inp = Inputs(scene_2048, cfg)
    g = np.random.RandomState(0).rand(8, 32, 3).astype(np.float32)
    b_out, b_rays, b_acc = baseline(host_lib, inp, 0, 0, 0, g, warps, lanes)
    out, rays, tape = tape_forward(host_lib, inp, 0, 0, 0, 8, 32, lanes)
    acc = sweep(host_lib, inp, 0, 0, 0, g, tape, warps, lanes)
    np.testing.assert_array_equal(out, b_out)
    assert rays == b_rays
    np.testing.assert_array_equal(acc, b_acc)
    if warps == 1 and lanes == 1:
        _, prays, d = render_tile_scaled_grad_plain(
            scene_2048, cfg, 0, torch.from_numpy(g), 0, 0, 8, 32)
        assert rays == int(prays)
        assert_rows_close(acc, d.numpy(), 1e-3)


def test_sweep_sample_batches_and_offset(host_lib, scene_2048):
    """spp 6 (two batches of grad_batch's 4 at depth 4) on a 24x12
    sub-image at (8, 4), soft, two 32-lane warps: bit-equal to the
    per-lane chunked instance."""
    cfg = RenderConfig(width=48, height=24, samples_per_pixel=6, max_depth=4,
                       soft_silhouette_eps=0.5)
    inp = Inputs(scene_2048, cfg)
    g = np.random.RandomState(3).rand(12, 24, 3).astype(np.float32)
    b_out, b_rays, b_acc = baseline(host_lib, inp, 2, 8, 4, g, 2, 32)
    out, rays, tape = tape_forward(host_lib, inp, 2, 8, 4, 12, 24, 32)
    acc = sweep(host_lib, inp, 2, 8, 4, g, tape, 2, 32)
    np.testing.assert_array_equal(out, b_out)
    assert rays == b_rays
    np.testing.assert_array_equal(acc, b_acc)


def scan_rays(scene, n, seed):
    """Rays from points in the scene's box in random directions, a few
    with NaN or zero components, and rays through sphere centres."""
    rng = np.random.RandomState(seed)
    c = scene.center.numpy()
    lo, hi = c.min(axis=0), c.max(axis=0)
    ro = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3))
    target = rng.randint(0, len(c), n - n // 2)
    target[:20] = np.arange(20)
    rd[n // 2:] = c[target] - ro[n // 2:]
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    rd[0, 1] = np.nan
    ro[1, 0] = np.nan
    rd[2] = (0.0, -0.0, 1.0)
    return ro, rd


@pytest.mark.parametrize("kind", [0, 1], ids=["silhouette", "occluder"])
@pytest.mark.parametrize("lanes", [1, 32])
def test_cooperative_scans_equal_sequential(host_lib, kind, lanes):
    """silhouette_warp and occluder_warp against chunks.cuh's scans: the
    same id, d (and nb) bit for bit on 200 rays of a 3000-sphere scene
    whose spheres 0-63 are duplicated at ids 2000-2063 (equal d in two
    chunks: the least id must win), rays with NaN and zero components,
    per-ray lights and bounds, t_l NaN on one ray."""
    scene = make_scaled_scene(n=3072, chunk=64, extent=40.0)
    cen, rad = scene.center.clone(), scene.radius.clone()
    cen[2000:2064], rad[2000:2064] = cen[:64], rad[:64]
    from toypathtracer_torch.scaled import refresh_chunk_aabb
    scene = refresh_chunk_aabb(scene.replace(center=cen, radius=rad))
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1, max_depth=2,
                       soft_silhouette_eps=0.5)
    inp = Inputs(scene, cfg)
    n = 200
    ro, rd = scan_rays(scene, n, 7 + kind)
    rng = np.random.RandomState(11)
    t_l = rng.uniform(1.0, 60.0, n).astype(np.float32)
    t_l[5] = np.nan
    lights_of = rng.randint(0, 8, n).astype(np.int32)
    lights_of[6] = 2000
    got = np.zeros((n, 3), np.float32)
    want = np.zeros((n, 3), np.float32)
    code = host_lib.tpt_scans_cpu(
        ctypes.byref(inp.args), ctypes.byref(inp.params(0, 0, 0, 8, 8)), kind,
        ro.ctypes.data, rd.ctypes.data, t_l.ctypes.data,
        lights_of.ctypes.data, n, np.float32(1e-3), lanes, got.ctypes.data,
        want.ctypes.data)
    assert code == 0, "a 32-lane warp stalled at a collective"
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    found = want[:, 2] >= 0
    assert 20 <= found.sum() < n
    if kind == 0:  # ties between a sphere and its duplicate: the first
        assert (want[found, 2] < 64).any()


def test_forty_lights_scaled_scene_matches_plain_autograd(host_lib):
    """A scaled scene with 40 lights (emissive ids 0-39 of the 2048-sphere
    scene: past a word of 32 seen-light bits), 16x8, spp 1, depth 3, soft
    eps 1.0: the cooperative form in two 32-lane warps within 1e-3 of
    plain autograd row by row, rays exact, the image within 1e-4, and its
    one-lane run bit-equal to the two-warp run's image and rays."""
    scene = make_scaled_scene(n=2048, chunk=64, extent=40.0)
    scene = scene.replace(emissive_ids=tuple(range(40)))
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1, max_depth=3,
                       soft_silhouette_eps=1.0)
    inp = Inputs(scene, cfg)
    g = np.random.RandomState(4).rand(8, 16, 3).astype(np.float32)
    out, rays, tape = tape_forward(host_lib, inp, 0, 0, 0, 8, 16, 32)
    acc = sweep(host_lib, inp, 0, 0, 0, g, tape, 2, 32)
    one_out, one_rays, _ = tape_forward(host_lib, inp, 0, 0, 0, 8, 16, 1)
    np.testing.assert_array_equal(one_out, out)
    assert one_rays == rays
    img, prays, d = render_tile_scaled_grad_plain(
        scene, cfg, 0, torch.from_numpy(g), 0, 0, 8, 16)
    assert rays == int(prays)
    assert np.abs(out - img.numpy()).max() <= 1e-4
    assert np.isfinite(acc).all()
    assert_rows_close(acc, d.numpy(), 1e-3)


@pytest.mark.parametrize("kw", [dict(n=100_000), dict(n=2000, chunk=64,
                                                        extent=40.0)],
                         ids=["100k", "2000"])
def test_walk_order_is_chunk_index_order(kw):
    """scaled.walk_order, the soft scans' walk order computed where the
    boxes lie (the sweep takes it each step), is chunk_index's order on
    the 100k scene and the reference's 2000-sphere scene, and a
    permutation; the sphere records are chunk_index's."""
    from toypathtracer_torch.scaled import sphere_records, walk_order
    scene = make_scaled_scene(**kw)
    rows = pack_chunks(scene)
    K = scene.chunk
    index = chunk_index(rows, K)
    order = walk_order(rows[:, 4 * K:4 * K + 6])
    assert order.dtype == torch.int32
    assert torch.equal(order, index.order)
    assert torch.equal(torch.sort(order.long()).values,
                       torch.arange(scene.n_chunks))
    assert torch.equal(sphere_records(rows, K), index.rec)
