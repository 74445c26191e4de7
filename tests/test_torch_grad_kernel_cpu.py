"""The gradient kernel's per-pixel code (csrc/trace.cuh grad_pixel, the
body of csrc/grad.cu's replaying K3) and the lockstep kernel's
(render_pixel, K4), built with g++ for the CPU, against autograd through
the plain version (render/wavefront.render_tile_grad_plain).

Without nvcc the TPT_HD and TPT_WARP macros of trace.cuh and warp.cuh are
plain `inline`, so a C loop over pixels runs the kernels' own logic here,
through the same tpt::RenderParams the launchers take.  The loop
adds every pixel's cotangent into one table; the card sums them in
another order (per block, then over blocks), which the sub-image test
stands in for.

The stored-carry form (grad_pixel_stored) and the warp form under a
one-lane warp (gradwarp.cuh grad_tiles with HostLane) are held bit-equal
to grad_pixel, image, rays and table; the warp form with 32-lane warps of
host threads (csrc/hostwarp.h ThreadWarp: a collective that not every
lane reaches stalls it) against plain autograd, and its grouped add,
emulated lane by lane, exact against the sequential sum.

The soft instances (the soft-silhouette estimator: grad_pixel<true>,
grad_tiles<true>, run wherever RenderParams::soft_eps > 0) are held the
same way: grad_pixel<true> against plain autograd with the estimator on,
the one-lane warp form bit-equal to it, the 32-lane warp form against
plain autograd, on the four scenes and on tools/scenes.py's
shadow_boundary_scene, whose shadow rays include occluded lights with the
soft term and lanes where the interval-overlap test and the sign of d_occ
disagree (measured at most 3.6e-5; the disagreeing lanes' fallback moves
the table by 2.4e-3 at eps 0.5 where it is dropped, and occluded lights
by 1.5e-2 at eps 0.05, in a copy with each removed).

Tolerances: d_packed row by row within 1e-3 x the row's max |plain|
(measured at most 1.5e-5 over these cases); ray counts exact
(measured); the image as tests/test_torch_kernel_cpu.py; K4's image
bit-equal to K3's primal (the same function); sub-images summed within
1e-5 of the whole image (float sums in another order).
"""

import ctypes
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from toypathtracer_torch import RenderConfig, make_scene
from toypathtracer_torch.camera import camera_to_array, make_camera
from toypathtracer_torch.ops import _build, cuda_grad, cuda_render
from toypathtracer_torch.ops import tracecore as tc
from toypathtracer_torch.render.wavefront import (camera_scalars,
                                                  render_tile_grad_plain,
                                                  render_tile_plain)
from toypathtracer_torch.scaled import (ScaledScene, make_scaled_scene,
                                        pack_chunks,
                                        render_tile_scaled_grad_plain,
                                        soft_boxes)
from toypathtracer_torch.tools import grad_stats
from toypathtracer_torch.tools.scenes import (crowded_scene,
                                              few_spheres_many_lights_scene,
                                              many_lights_scene,
                                              shadow_boundary_scene)

torch.set_num_threads(1)

HARNESS = r"""
#include <thread>
#include <vector>

#include "chunks.cuh"
#include "gradwarp.cuh"
#include "hostwarp.h"

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

// Each entry point runs the soft instance where p->soft_eps > 0, as the
// launcher does.
template <bool kSoft>
static unsigned long long grad_loop(const tpt::SceneView& S,
                                    const float* cam,
                                    const tpt::RenderParams* p,
                                    const float* g, float* out, float* acc) {
  unsigned long long rays = 0;
  for (int y = 0; y < p->height; ++y)
    for (int x = 0; x < p->width; ++x) {
      size_t o = ((size_t)y * p->width + x) * 3;
      rays += tpt::grad_pixel<kSoft>(S, cam, *p, p->x0 + x, p->y0 + y, g + o,
                                     out + o, acc);
    }
  return rays;
}

extern "C" unsigned long long tpt_grad_cpu(
    const float* tab, const int32_t* mat, const int32_t* lights,
    const float* cam, const tpt::RenderParams* p, const float* g, float* out,
    float* acc) {
  tpt::SceneView S = view(tab, mat, lights, p);
  return p->soft_eps > 0.0f ? grad_loop<true>(S, cam, p, g, out, acc)
                            : grad_loop<false>(S, cam, p, g, out, acc);
}

// grad_tiles, its soft instance where p->soft_eps > 0.
template <class W, class View, class Tab, class Tape>
static unsigned long long tiles(const W& w, const View& S, const float* cam,
                                const tpt::RenderParams* p, const float* g,
                                float* out, Tab T, const Tape& tape,
                                float* ws, int warp, int n_warps) {
  tpt::NoGradCount none;
  return p->soft_eps > 0.0f
             ? tpt::grad_tiles<true>(w, S, cam, *p, g, out, T, tape, ws,
                                     warp, n_warps, none)
             : tpt::grad_tiles<false>(w, S, cam, *p, g, out, T, tape, ws,
                                      warp, n_warps, none);
}

// form 1: grad_pixel_stored a pixel at a time; form 2: the warp form
// under a one-lane warp over the whole sub-image.
extern "C" unsigned long long tpt_grad_form_cpu(
    const float* tab, const int32_t* mat, const int32_t* lights,
    const float* cam, const tpt::RenderParams* p, const float* g, float* out,
    float* acc, int form) {
  tpt::SceneView S = view(tab, mat, lights, p);
  std::vector<tpt::Carry> carries(p->max_depth);
  tpt::ArrayTape tape{carries.data()};
  unsigned long long rays = 0;
  if (form == 2) {
    tpt::HostLane w;
    std::vector<float> recs(tpt::grad_batch(*p) * p->max_depth *
                            tpt::kRecWords);
    std::vector<float> ws(tpt::grad_scratch_words(1));
    const tpt::WarpTape tape{recs.data(), 1, 0};
    return tiles(w, S, cam, p, g, out, acc, tape, ws.data(), 0, 1);
  }
  for (int y = 0; y < p->height; ++y)
    for (int x = 0; x < p->width; ++x) {
      size_t o = ((size_t)y * p->width + x) * 3;
      rays += tpt::grad_pixel_stored(S, cam, *p, p->x0 + x, p->y0 + y,
                                     g + o, out + o, acc, tape);
    }
  return rays;
}

// The warp form with 32-lane warps of host threads: n_warps warps, each
// with its own table, run one after the other; the tables are then summed
// in warp order into acc, as the kernel's block does.  Returns the rays,
// or -1 if a warp stalled.
extern "C" long long tpt_grad_warp32_cpu(
    const float* tab, const int32_t* mat, const int32_t* lights,
    const float* cam, const tpt::RenderParams* p, const float* g, float* out,
    float* acc, int n_warps) {
  tpt::SceneView S = view(tab, mat, lights, p);
  const int m = tpt::SCENE_ROWS * p->n_spheres;
  std::vector<float> tables((size_t)n_warps * m, 0.0f);
  long long rays = 0;
  for (int wi = 0; wi < n_warps; ++wi) {
    tpt::Lanes lanes;
    unsigned long long lane_rays[32];
    std::vector<float> recs(32 * tpt::grad_batch(*p) * p->max_depth *
                            tpt::kRecWords);
    std::vector<float> ws(tpt::grad_scratch_words(32));
    std::vector<std::thread> threads;
    for (int l = 0; l < 32; ++l)
      threads.emplace_back([&, l] {
        tpt::ThreadWarp w{&lanes, l};
        float* table = tables.data() + (size_t)wi * m;
        const tpt::WarpTape tape{recs.data(), 32, l};
        lane_rays[l] = tiles(w, S, cam, p, g, out, table, tape, ws.data(),
                             wi, n_warps);
      });
    for (auto& t : threads) t.join();
    if (lanes.broken) return -1;
    for (int l = 0; l < 32; ++l) rays += lane_rays[l];
  }
  for (int j = 0; j < m; ++j) {
    float s = 0.0f;
    for (int wi = 0; wi < n_warps; ++wi) s += tables[(size_t)wi * m + j];
    acc[j] += s;
  }
  return rays;
}

// The warp form's instance past 16 lights (csrc/grad.cu
// lights_warp_grad_kernel): grad_tiles with LightTapeOf<false> carries,
// the seen lights in words of their own, n_warps warps of `lanes` lanes
// (1: HostLane, 32: ThreadWarp), each with its own table, summed in warp
// order into acc.  Returns the rays, or -1 if a warp stalled.
extern "C" long long tpt_grad_lights_cpu(
    const float* tab, const int32_t* mat, const int32_t* lights,
    const float* cam, const tpt::RenderParams* p, const float* g, float* out,
    float* acc, int n_warps, int lanes) {
  tpt::SceneView S = view(tab, mat, lights, p);
  const int m = tpt::SCENE_ROWS * p->n_spheres;
  const int words = tpt::light_words(p->n_lights);
  const size_t slots = (size_t)lanes * tpt::grad_batch(*p) * p->max_depth;
  std::vector<float> tables((size_t)n_warps * m, 0.0f);
  long long rays = 0;
  for (int wi = 0; wi < n_warps; ++wi) {
    std::vector<float> recs(slots * tpt::kRecWords);
    std::vector<uint32_t> see(slots * words);
    std::vector<float> ws(tpt::grad_scratch_words(lanes));
    float* table = tables.data() + (size_t)wi * m;
    auto tape = [&](int l) {
      tpt::LightTapeOf<false> t;
      t.base = recs.data();
      t.width = lanes;
      t.lane = l;
      t.see = see.data();
      t.words = words;
      return t;
    };
    if (lanes == 1) {
      tpt::HostLane w;
      rays += tiles(w, S, cam, p, g, out, table, tape(0), ws.data(), wi,
                    n_warps);
      continue;
    }
    tpt::Lanes ls;
    unsigned long long lane_rays[32];
    std::vector<std::thread> threads;
    for (int l = 0; l < 32; ++l)
      threads.emplace_back([&, l] {
        tpt::ThreadWarp w{&ls, l};
        lane_rays[l] = tiles(w, S, cam, p, g, out, table, tape(l), ws.data(),
                             wi, n_warps);
      });
    for (auto& t : threads) t.join();
    if (ls.broken) return -1;
    for (int l = 0; l < 32; ++l) rays += lane_rays[l];
  }
  for (int j = 0; j < m; ++j) {
    float s = 0.0f;
    for (int wi = 0; wi < n_warps; ++wi) s += tables[(size_t)wi * m + j];
    acc[j] += s;
  }
  return rays;
}

// The pool instances (csrc/grad.cu pool_grad_kernel, chunk_grad_kernel):
// grad_tiles with a PoolTable a warp, over the flat scene (rows null;
// LightTapeOf<true> carries, any number of lights) or the chunked one
// (GradChunkedView on pack_chunks rows, the chunk boxes and, for the soft
// instance, the soft scans' inflated boxes; WideTape carries).  n_warps
// warps of `lanes` lanes (1: HostLane, 32: ThreadWarp) run one after the
// other, sharing the pool and the directory's blocks by their counters as
// a launch's warps do; acc gets each sphere's slots summed in warp order,
// as the kernel's block does.  *slots: the slots drawn, slots[1] the
// directory blocks.  Returns the rays, or -1 if a warp stalled.
extern "C" long long tpt_grad_pool_cpu(
    const float* tab, const int32_t* mat, const int32_t* lights,
    const float* cam, const tpt::RenderParams* p, const float* g, float* out,
    float* acc, int n_warps, int lanes, const float* rows, const float* box,
    const float* sil_box, const float* prox_box, int n_chunks, int chunk,
    long long* slots) {
  const int n = p->n_spheres;
  const int dir_rows = (n + tpt::kDirIds - 1) / tpt::kDirIds;
  std::vector<int> dir((size_t)dir_rows * n_warps, -1);
  const int block_cap = dir_rows * n_warps;
  std::vector<int> blocks((size_t)block_cap * tpt::kDirIds, -1);
  const int cap = n * n_warps;
  std::vector<float> pool((size_t)cap * tpt::kSlotFloats, 0.0f);
  int next = 0, next_block = 0;
  const int words = tpt::light_words(p->n_lights);
  const tpt::SceneView S = view(tab, mat, lights, p);
  tpt::GradChunkedView C;
  C.tab = tab;
  C.mat = mat;
  C.lights = lights;
  C.rows = rows;
  C.box = box;
  C.n = n;
  C.n_lights = p->n_lights;
  C.chunk = chunk;
  C.n_chunks = n_chunks;
  C.sil_box = sil_box;
  C.prox_box = prox_box;
  long long rays = 0;
  for (int wi = 0; wi < n_warps; ++wi) {
    const tpt::PoolTable T{dir.data() + wi, n_warps, blocks.data(),
                           &next_block, block_cap, pool.data(), &next, cap};
    const size_t n_slots = (size_t)lanes * tpt::grad_batch(*p) *
                           p->max_depth;
    std::vector<float> recs(n_slots * tpt::kRecWords);
    std::vector<uint32_t> see(n_slots * words);
    std::vector<float> ws(tpt::grad_scratch_words(lanes));
    auto light_tape = [&](int l) {
      tpt::LightTapeOf<true> t;
      t.base = recs.data();
      t.width = lanes;
      t.lane = l;
      t.see = see.data();
      t.words = words;
      return t;
    };
    if (lanes == 1) {
      tpt::HostLane w;
      const tpt::WideTape tape{recs.data(), 1, 0};
      rays += rows ? tiles(w, C, cam, p, g, out, T, tape, ws.data(), wi,
                           n_warps)
                   : tiles(w, S, cam, p, g, out, T, light_tape(0), ws.data(),
                           wi, n_warps);
      continue;
    }
    tpt::Lanes ls;
    unsigned long long lane_rays[32];
    std::vector<std::thread> threads;
    for (int l = 0; l < 32; ++l)
      threads.emplace_back([&, l] {
        tpt::ThreadWarp w{&ls, l};
        const tpt::WideTape tape{recs.data(), 32, l};
        lane_rays[l] = rows ? tiles(w, C, cam, p, g, out, T, tape, ws.data(),
                                    wi, n_warps)
                            : tiles(w, S, cam, p, g, out, T, light_tape(l),
                                    ws.data(), wi, n_warps);
      });
    for (auto& t : threads) t.join();
    if (ls.broken) return -1;
    for (int l = 0; l < 32; ++l) rays += lane_rays[l];
  }
  for (int i = 0; i < n; ++i)
    for (int r = 0; r < tpt::SCENE_ROWS; ++r) {
      float s = 0.0f;
      for (int wi = 0; wi < n_warps; ++wi) {
        const int b = dir[(size_t)(i / tpt::kDirIds) * n_warps + wi];
        if (b < 0) continue;
        const int slot = blocks[(size_t)b * tpt::kDirIds + i % tpt::kDirIds];
        if (slot >= 0) s += pool[(size_t)slot * tpt::kSlotFloats + r];
      }
      acc[(size_t)r * n + i] += s;
    }
  slots[0] = next;
  slots[1] = next_block;
  return rays;
}

// The 32-lane grouped add of csrc/gradwarp.cuh (group_tree, group_add)
// emulated lane by lane: lanes with key >= 0 add vals[lane] to
// table[key]; the shuffles of a step all read the values before it.
extern "C" void tpt_group_add_model(const int* keys, const float* vals,
                                    float* table) {
  unsigned mask[32];
  int most = 0;
  for (int l = 0; l < 32; ++l) {
    mask[l] = 1u << l;
    if (keys[l] >= 0)
      for (int k = 0; k < 32; ++k)
        if (k != l && keys[k] == keys[l]) mask[l] |= 1u << k;
    const int c = tpt::popc(mask[l]);
    most = c > most ? c : most;
  }
  tpt::Group g[32];
  float v[32], o[32];
  for (int l = 0; l < 32; ++l) {
    g[l] = tpt::group_tree(mask[l], l, most, keys[l] >= 0);
    v[l] = vals[l];
  }
  for (int k = 0; k < g[0].steps; ++k) {
    for (int l = 0; l < 32; ++l) o[l] = v[(g[l].tree >> (5 * k)) & 31u];
    for (int l = 0; l < 32; ++l)
      if ((g[l].tree >> (25 + k)) & 1u) v[l] = v[l] + o[l];
  }
  for (int l = 0; l < 32; ++l)
    if (g[l].lead) table[keys[l]] += v[l];
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
                    "-ffp-contract=off", "-pthread", f"-I{_build.CSRC}",
                    "-o", str(so),
                    str(d / "host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    ptr = ctypes.c_void_p
    params = ctypes.POINTER(_build.RenderParams)
    lib.tpt_grad_cpu.argtypes = [ptr, ptr, ptr, ptr, params, ptr, ptr, ptr]
    lib.tpt_grad_cpu.restype = ctypes.c_ulonglong
    lib.tpt_grad_form_cpu.argtypes = [ptr, ptr, ptr, ptr, params, ptr, ptr,
                                      ptr, ctypes.c_int]
    lib.tpt_grad_form_cpu.restype = ctypes.c_ulonglong
    lib.tpt_group_add_model.argtypes = [ptr, ptr, ptr]
    lib.tpt_grad_warp32_cpu.argtypes = [ptr, ptr, ptr, ptr, params, ptr, ptr,
                                        ptr, ctypes.c_int]
    lib.tpt_grad_warp32_cpu.restype = ctypes.c_longlong
    lib.tpt_grad_pool_cpu.argtypes = [ptr, ptr, ptr, ptr, params, ptr, ptr,
                                      ptr, ctypes.c_int, ctypes.c_int, ptr,
                                      ptr, ptr, ptr, ctypes.c_int,
                                      ctypes.c_int, ptr]
    lib.tpt_grad_pool_cpu.restype = ctypes.c_longlong
    lib.tpt_grad_lights_cpu.argtypes = [ptr, ptr, ptr, ptr, params, ptr, ptr,
                                        ptr, ctypes.c_int, ctypes.c_int]
    lib.tpt_grad_lights_cpu.restype = ctypes.c_longlong
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


def grad_form_host(lib, scene, cfg, frame, g, x0, y0, form):
    """As grad_host through the stored-carry form (1), the warp form under
    a one-lane warp (2), or the warp form in warps of 32 host threads,
    `form` - 30 of them (form >= 31)."""
    h, w, _ = g.shape
    tab, mat, lights, cam = inputs(scene, cfg)
    out = np.zeros((h, w, 3), np.float32)
    acc = np.zeros_like(tab)
    params = cuda_render.render_params(scene, cfg, frame, x0, y0, h, w)
    g = np.ascontiguousarray(g, np.float32)
    args = (tab.ctypes.data, mat.ctypes.data, lights.ctypes.data,
            cam.ctypes.data, ctypes.byref(params), g.ctypes.data,
            out.ctypes.data, acc.ctypes.data)
    if form > 30:
        rays = lib.tpt_grad_warp32_cpu(*args, form - 30)
        assert rays >= 0, "a 32-lane warp stalled at a collective"
    else:
        rays = lib.tpt_grad_form_cpu(*args, form)
    return out, rays, acc


def grad_lights_host(lib, scene, cfg, frame, g, x0, y0, n_warps=1, lanes=1):
    """K3's warp form past 16 lights (LightTapeOf records) over a
    sub-image: (image, rays, d_packed)."""
    h, w, _ = g.shape
    tab, mat, lights, cam = inputs(scene, cfg)
    out = np.zeros((h, w, 3), np.float32)
    acc = np.zeros_like(tab)
    params = cuda_render.render_params(scene, cfg, frame, x0, y0, h, w)
    g = np.ascontiguousarray(g, np.float32)
    rays = lib.tpt_grad_lights_cpu(
        tab.ctypes.data, mat.ctypes.data, lights.ctypes.data,
        cam.ctypes.data, ctypes.byref(params), g.ctypes.data,
        out.ctypes.data, acc.ctypes.data, n_warps, lanes)
    assert rays >= 0, "a 32-lane warp stalled at a collective"
    return out, rays, acc


def grad_pool_host(lib, scene, cfg, frame, g, x0, y0, n_warps=1, lanes=1):
    """K3's pool instance over a sub-image (n_warps warps of `lanes`
    lanes), on the flat scene or, for a ScaledScene, on its chunks:
    (image, rays, d_packed, slots drawn)."""
    h, w, _ = g.shape
    chunked = isinstance(scene, ScaledScene)
    if chunked:
        tab = cuda_render.pack_scene(scene).numpy()
        mat = scene.mat_ids().numpy()
        lights = np.array(scene.emissive_ids, np.int32)
        cam = camera_to_array(make_camera(scene.camera,
                                          cfg.width / cfg.height))
        K = scene.chunk
        rows = pack_chunks(scene)
        box = rows[:, 4 * K:4 * K + 6].contiguous()
        rmax = scene.radius.reshape(-1, K).amax(dim=1)
        soft = soft_boxes(box, rmax, cfg.soft_silhouette_eps)
        chunk = [np.ascontiguousarray(x.numpy()) for x in (
            rows, box, soft["silhouette"], soft["proximity"])]
        chunk_args = [x.ctypes.data for x in chunk] + [scene.n_chunks, K]
    else:
        tab, mat, lights, cam = inputs(scene, cfg)
        chunk_args = [None] * 4 + [0, 0]
    out = np.zeros((h, w, 3), np.float32)
    acc = np.zeros_like(tab)
    params = cuda_render.render_params(scene, cfg, frame, x0, y0, h, w)
    g = np.ascontiguousarray(g, np.float32)
    slots = (ctypes.c_longlong * 2)()
    rays = lib.tpt_grad_pool_cpu(
        tab.ctypes.data, mat.ctypes.data, lights.ctypes.data,
        cam.ctypes.data, ctypes.byref(params), g.ctypes.data,
        out.ctypes.data, acc.ctypes.data, n_warps, lanes, *chunk_args,
        ctypes.byref(slots))
    assert rays >= 0, "a 32-lane warp stalled at a collective"
    return out, rays, acc, slots[0]


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


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("frame,x0,y0", [(1, 0, 0), (4, 40, 7)])
@pytest.mark.parametrize("form", [1, 2], ids=["stored", "warp_one_lane"])
def test_forms_bit_equal_to_replays(host_lib, case, frame, x0, y0, form):
    """Stored carries instead of replays (form 1), and the warp form under
    a one-lane warp (form 2): image, rays and table bit-equal to
    grad_pixel's loop over pixels."""
    scene_kw, cfg_kw = CASES[case]
    scene = make_scene(**scene_kw)
    cfg = RenderConfig(width=32, height=16, samples_per_pixel=2, max_depth=4,
                       **cfg_kw)
    g = np.random.RandomState(frame).rand(16, 32, 3).astype(np.float32)
    out, rays, acc = grad_host(host_lib, scene, cfg, frame, g, x0, y0)
    f_out, f_rays, f_acc = grad_form_host(host_lib, scene, cfg, frame, g, x0,
                                          y0, form)
    np.testing.assert_array_equal(f_out, out)
    assert f_rays == rays
    np.testing.assert_array_equal(f_acc, acc)


@pytest.mark.parametrize("case", sorted(CASES))
def test_warp_form_32_lanes_matches_plain_autograd(host_lib, case):
    """The warp form in 32-lane warps (2 warps of 16x2-pixel tiles over a
    32x8 image): the image bit-equal to grad_pixel's, rays exact, the table
    within 1e-3 of plain autograd row by row and within 1e-5 of the
    sequential sum, and two runs bit-equal."""
    scene_kw, cfg_kw = CASES[case]
    scene = make_scene(**scene_kw)
    cfg = RenderConfig(width=32, height=8, samples_per_pixel=1, max_depth=4,
                       **cfg_kw)
    g = np.random.RandomState(6).rand(8, 32, 3).astype(np.float32)
    out, rays, acc = grad_host(host_lib, scene, cfg, 2, g, 0, 0)
    w_out, w_rays, w_acc = grad_form_host(host_lib, scene, cfg, 2, g, 0, 0,
                                          32)
    np.testing.assert_array_equal(w_out, out)
    assert w_rays == rays
    assert_rows_close(w_acc, acc, 1e-5)
    _, _, d = render_tile_grad_plain(scene, cfg, 2, torch.from_numpy(g), 0,
                                     0, 8, 32)
    assert_rows_close(w_acc, d.numpy(), 1e-3)
    _, _, again = grad_form_host(host_lib, scene, cfg, 2, g, 0, 0, 32)
    np.testing.assert_array_equal(again, w_acc)


@pytest.mark.parametrize("lanes", ["one_group", "groups_and_idle",
                                   "all_distinct", "random"])
def test_group_add_exact(host_lib, lanes):
    """The 32-lane grouped add against the sequential sum: values that are
    multiples of 1/4 below 2^10 sum exactly in any order, so the tree must
    give the sequential sum bit for bit; lanes with key -1 add nothing."""
    rng = np.random.RandomState(len(lanes))
    keys = {"one_group": np.full(32, 5),
            "groups_and_idle": np.array([3, 3, -1, 5, 3] + [7] * 10 +
                                        [-1] * 5 + [5] * 12),
            "all_distinct": np.arange(32) * 2,
            "random": rng.randint(-1, 6, 32)}[lanes].astype(np.int32)
    vals = (rng.randint(-400, 400, 32) * 0.25).astype(np.float32)
    table = (rng.randint(0, 8, 64) * 0.5).astype(np.float32)
    want = table.copy()
    for k, v in zip(keys, vals):
        if k >= 0:
            want[k] += v
    host_lib.tpt_group_add_model(keys.ctypes.data, vals.ctypes.data,
                                 table.ctypes.data)
    np.testing.assert_array_equal(table, want)


@pytest.mark.parametrize("form", [2, 31], ids=["one_lane", "32_lanes"])
def test_warp_form_beyond_64_spheres(host_lib, form):
    """130 spheres (the replaying form takes 64): the warp form within 1e-3 of
    plain autograd row by row at 16x8, spp 1, depth 4, rays exact, and
    gradients reach the appended spheres."""
    scene = crowded_scene()
    assert scene.n_spheres == 130
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1, max_depth=4)
    g = np.random.RandomState(8).rand(8, 16, 3).astype(np.float32)
    out, rays, acc = grad_form_host(host_lib, scene, cfg, 0, g, 0, 0, form)
    img, prays, d = render_tile_grad_plain(scene, cfg, 0,
                                           torch.from_numpy(g), 0, 0, 8, 16)
    assert rays == int(prays)
    assert_rows_close(acc, d.numpy(), 1e-3)
    assert np.abs(out - img.numpy()).max() <= 1e-4
    assert np.count_nonzero(np.abs(acc[:, 64:]).sum(axis=0)) >= 5


@pytest.mark.parametrize("spp,depth", [(5, 4), (3, 15)])
@pytest.mark.parametrize("form", [2, 31], ids=["one_lane", "32_lanes"])
def test_warp_form_sample_batches(host_lib, spp, depth, form):
    """More samples than one batch holds (grad_batch: 4 at depth 4, 2 at
    depth 15): the image bit-equal to grad_pixel's, rays exact, and the
    table bit-equal under a one-lane warp, within 1e-5 row by row in
    32-lane warps."""
    scene = make_scene(big=True)
    cfg = RenderConfig(width=16, height=4, samples_per_pixel=spp,
                       max_depth=depth)
    g = np.random.RandomState(spp).rand(4, 16, 3).astype(np.float32)
    out, rays, acc = grad_host(host_lib, scene, cfg, 3, g, 0, 0)
    w_out, w_rays, w_acc = grad_form_host(host_lib, scene, cfg, 3, g, 0, 0,
                                          form)
    np.testing.assert_array_equal(w_out, out)
    assert w_rays == rays
    if form == 2:
        np.testing.assert_array_equal(w_acc, acc)
    else:
        assert_rows_close(w_acc, acc, 1e-5)


def test_wrapper_caps_and_forms_on_the_cpu(monkeypatch):
    """render_tile_grad takes any scene on the CPU (plain autograd): the
    forms' caps bind on a card only (the warp form's 512 spheres, the
    replaying form's 64 and 16 lights; the warp form past 16 lights and
    the pool form keep the seen lights in words of their own, any
    number), the card has no other form, and the stats instances (none
    for the pool form) and the cycle tool need a card."""
    scene = crowded_scene()
    cfg = RenderConfig(width=8, height=4, samples_per_pixel=1, max_depth=2)
    g = torch.ones((4, 8, 3))
    img, rays, d = cuda_grad.render_tile_grad(scene, cfg, 0, g, 0, 0, 4, 8)
    assert d.shape == (14, 130) and torch.isfinite(d).all() and int(rays) > 0
    _, _, d_replay = cuda_grad.render_tile_grad_form(scene, cfg, 0, g, 0, 0,
                                                     4, 8, "replay")
    assert torch.equal(d_replay, d)
    card = SimpleNamespace(device=torch.device("cuda"), n_spheres=600,
                           emissive_ids=tuple(range(17)))
    for form, match in (("replay", "at most 64 spheres"),
                        ("warp", "at most 512 spheres")):
        with pytest.raises(ValueError, match=match):
            cuda_render.check_caps(card, cuda_grad.FORM_CAPS[form], form)
    cuda_render.check_caps(card, cuda_grad.FORM_CAPS["pool"], "pool")
    lit = SimpleNamespace(device=torch.device("cuda"), n_spheres=60,
                          emissive_ids=tuple(range(40)))
    with pytest.raises(ValueError, match="at most 16 emissive"):
        cuda_render.check_caps(lit, cuda_grad.FORM_CAPS["replay"], "replay")
    for form in ("warp", "pool"):
        cuda_render.check_caps(lit, cuda_grad.FORM_CAPS[form], form)
    small = make_scene(big=False)
    for form in ("lane", "stored"):
        with pytest.raises(ValueError, match="no gradient kernel form"):
            cuda_grad.render_tile_grad_form(small, cfg, 0, g, 0, 0, 4, 8,
                                            form)
    for form in ("warp", "pool"):
        with pytest.raises(ValueError, match="on a card"):
            cuda_grad.render_tile_grad_form(small, cfg, 0, g, 0, 0, 4, 8,
                                            form, stats=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        grad_stats.main(["--width", "8", "--height", "4"])


def test_plain_gradient_past_512_spheres_matches_fd():
    """600 spheres (tools/scenes.crowded_scene(extra=554)), past the warp
    form's shared table: the plain gradient computes on the CPU, and on
    the albedo entry with the largest gradient agrees with central
    differences of sum(img * w) in float64 (h 1e-2: albedo moves no path)
    within 1e-3."""
    scene = crowded_scene(extra=554)
    assert scene.n_spheres == 600
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1, max_depth=3)
    w = torch.from_numpy(np.random.RandomState(5).rand(8, 16, 3)
                         .astype(np.float32))
    _, _, d = cuda_grad.render_tile_grad(scene, cfg, 0, w, 0, 0, 8, 16)
    leaves = scene.albedo.clone().requires_grad_(True)
    img, _ = cuda_grad.render_frame_diff(scene.replace(albedo=leaves), cfg,
                                         0, device="cpu")
    (img * w).sum().backward()
    ga = leaves.grad.numpy()
    np.testing.assert_allclose(ga.T, d[tc.ROW_ALB:tc.ROW_ALB + 3].numpy(),
                               rtol=1e-6, atol=1e-7)
    i, c = np.unravel_index(np.abs(ga).argmax(), ga.shape)
    h = 1e-2

    def loss(sign):
        alb = scene.albedo.clone()
        alb[i, c] += sign * h
        img, _ = cuda_render.render_frame(scene.replace(albedo=alb), cfg, 0,
                                          device="cpu")
        return float((img.double() * w.double()).sum())

    fd = (loss(+1) - loss(-1)) / (2 * h)
    assert abs(fd - ga[i, c]) <= 1e-3 * abs(fd), (fd, ga[i, c])


@pytest.mark.parametrize("case", ["big", "crowded"])
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("lanes", [1, 32])
def test_pool_instance_bit_equal_to_shared_table(host_lib, case, soft,
                                                 lanes):
    """K3's pool instance (gradwarp.cuh PoolTable, WideTape) against the
    warp form's shared table at 46 and 130 spheres: image, rays and table
    bit-equal, one one-lane warp over the image and two 32-lane warps of
    host threads (the slots summed in warp order, as sum_pool's block
    does)."""
    scene = make_scene(big=True) if case == "big" else crowded_scene()
    cfg = RenderConfig(width=32, height=8, samples_per_pixel=1, max_depth=4,
                       soft_silhouette_eps=0.05 if soft else 0.0)
    g = np.random.RandomState(6).rand(8, 32, 3).astype(np.float32)
    out, rays, acc = grad_form_host(host_lib, scene, cfg, 2, g, 0, 0,
                                    2 if lanes == 1 else 32)
    p_out, p_rays, p_acc, slots = grad_pool_host(
        host_lib, scene, cfg, 2, g, 0, 0, 1 if lanes == 1 else 2, lanes)
    np.testing.assert_array_equal(p_out, out)
    assert p_rays == rays
    np.testing.assert_array_equal(p_acc, acc)
    assert 0 < slots <= scene.n_spheres * (1 if lanes == 1 else 2)


@pytest.mark.parametrize("lanes", [1, 32])
def test_pool_instance_past_512_spheres_matches_plain_autograd(host_lib,
                                                               lanes):
    """The pool instance at 600 spheres (crowded_scene(extra=554)), 16x8,
    spp 1, depth 4: within 1e-3 of plain autograd row by row (measured
    4.7e-6), rays exact, the image within 1e-4, and gradients reach the
    appended spheres."""
    scene = crowded_scene(extra=554)
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1, max_depth=4)
    g = np.random.RandomState(8).rand(8, 16, 3).astype(np.float32)
    out, rays, acc, _ = grad_pool_host(host_lib, scene, cfg, 0, g, 0, 0,
                                       1 if lanes == 1 else 2, lanes)
    img, prays, d = render_tile_grad_plain(scene, cfg, 0,
                                           torch.from_numpy(g), 0, 0, 8, 16)
    assert rays == int(prays)
    assert_rows_close(acc, d.numpy(), 1e-3)
    assert np.abs(out - img.numpy()).max() <= 1e-4
    assert np.count_nonzero(np.abs(acc[:, 46:]).sum(axis=0)) >= 5


@pytest.mark.parametrize("lanes", [1, 32])
@pytest.mark.parametrize("eps", [0.0, 1.0], ids=["hard", "soft"])
def test_chunked_instance_matches_plain_autograd(host_lib, eps, lanes):
    """K3's chunked instance (GradChunkedView: the chunk walks forward, the
    soft scans over the inflated chunk boxes) on tests/test_scaled.py:129's
    scene (2000 spheres in chunks of 64), 32x8, spp 1, depth 3, hard and
    eps 1.0: within 1e-3 of plain autograd through the chunk traversal row
    by row (measured 1.2e-5 hard, 1.1e-4 soft), rays exact, the image
    within 1e-4."""
    scene = make_scaled_scene(n=2000, chunk=64, extent=40.0)
    cfg = RenderConfig(width=32, height=8, samples_per_pixel=1, max_depth=3,
                       soft_silhouette_eps=eps)
    g = np.random.RandomState(0).rand(8, 32, 3).astype(np.float32)
    out, rays, acc, _ = grad_pool_host(host_lib, scene, cfg, 0, g, 0, 0,
                                       1 if lanes == 1 else 2, lanes)
    img, prays, d = render_tile_scaled_grad_plain(
        scene, cfg, 0, torch.from_numpy(g), 0, 0, 8, 32)
    assert rays == int(prays)
    assert np.isfinite(acc).all()
    assert_rows_close(acc, d.numpy(), 1e-3)
    assert np.abs(out - img.numpy()).max() <= 1e-4


SOFT_CASES = {
    "big": (lambda: make_scene(big=True), dict(), 0.02),
    "big_no_nee": (lambda: make_scene(big=True),
                   dict(do_light_sampling=False), 0.05),
    "small": (lambda: make_scene(big=False), dict(), 0.05),
    "mitsuba": (lambda: make_scene(big=False, mitsuba_compare=True),
                dict(do_mitsuba_compare=True), 0.05),
    "shadow_boundary": (shadow_boundary_scene, dict(), 0.05),
    "shadow_boundary_wide": (shadow_boundary_scene, dict(), 0.5),
}


def soft_case(case, frame=1):
    make, cfg_kw, eps = SOFT_CASES[case]
    cfg = RenderConfig(width=32, height=16, samples_per_pixel=2, max_depth=4,
                       soft_silhouette_eps=eps, **cfg_kw)
    g = np.random.RandomState(frame).rand(16, 32, 3).astype(np.float32)
    return make(), cfg, g


def test_shadow_boundary_scene_has_every_case():
    """shadow_boundary_scene's shadow rays at the soft cases' size (frame
    1) through the plain version: occluded lights whose soft term applies
    (the occluder in the segment, d_occ >= 0), occluded lights where the
    interval-overlap test and the sign of d_occ disagree (the hard value
    stands), and seen lights.  Measured 324, 5 and 382."""
    counts = []

    class Recording(tc.BruteForce):
        def occluded(self, pos, l, light, t_min, t_l, active=None):
            occ, slabs, tests = super().occluded(pos, l, light, t_min, t_l,
                                                 active)
            d_occ, _ = tc.lights_occlusion_proximity(self.tab, pos, l, light,
                                                     t_min, t_l)
            counts.append([int((active & x).sum()) for x in (
                occ & (d_occ >= 0.0), occ & (d_occ < 0.0), ~occ)])
            return occ, slabs, tests

    scene, cfg, _ = soft_case("shadow_boundary")
    tab = cuda_render.pack_scene(scene)
    yy, xx = torch.meshgrid(torch.arange(16), torch.arange(32),
                            indexing="ij")
    tc.render_pixels(tab, torch.tensor(scene.mat_type), scene.emissive_ids,
                     cfg, camera_scalars(scene, cfg), xx.reshape(-1),
                     yy.reshape(-1), 1, traversal=Recording(tab),
                     soft_eps=cfg.soft_silhouette_eps)
    agree_occluded, disagree, seen = np.sum(counts, axis=0)
    assert agree_occluded > 0 and disagree > 0 and seen > 0, counts


@pytest.mark.parametrize("case", sorted(SOFT_CASES))
def test_soft_grad_source_matches_plain_autograd(host_lib, case):
    """K3's soft per-pixel code (grad_pixel<true>) against autograd through
    the plain version with the estimator on: d_packed within 1e-3 row by
    row, rays exact, the image bit-equal to the hard instance's, and the
    table not the hard instance's."""
    scene, cfg, g = soft_case(case)
    out, rays, acc = grad_host(host_lib, scene, cfg, 1, g, 0, 0)
    img, prays, d = render_tile_grad_plain(scene, cfg, 1, torch.from_numpy(g),
                                           0, 0, 16, 32)
    assert rays == int(prays)
    assert np.isfinite(acc).all()
    assert_rows_close(acc, d.numpy(), 1e-3)
    h_out, h_rays, h_acc = grad_host(
        host_lib, scene, cfg.replace(soft_silhouette_eps=0.0), 1, g, 0, 0)
    np.testing.assert_array_equal(out, h_out)
    assert rays == h_rays
    assert np.abs(acc[:4] - h_acc[:4]).max() > 1e-3 * np.abs(h_acc[:4]).max()


@pytest.mark.parametrize("case", sorted(SOFT_CASES))
def test_soft_warp_forms(host_lib, case):
    """The soft warp form (grad_tiles<true>) under a one-lane warp:
    image, rays and table bit-equal to grad_pixel<true>'s; in 32-lane
    warps of host threads: image bit-equal, rays exact, the table within
    1e-3 of plain autograd row by row and within 1e-5 of the sequential
    sum."""
    scene, cfg, g = soft_case(case)
    out, rays, acc = grad_host(host_lib, scene, cfg, 1, g, 0, 0)
    o1, r1, a1 = grad_form_host(host_lib, scene, cfg, 1, g, 0, 0, 2)
    np.testing.assert_array_equal(o1, out)
    assert r1 == rays
    np.testing.assert_array_equal(a1, acc)
    o32, r32, a32 = grad_form_host(host_lib, scene, cfg, 1, g, 0, 0, 31)
    np.testing.assert_array_equal(o32, out)
    assert r32 == rays
    assert_rows_close(a32, acc, 1e-5)
    _, _, d = render_tile_grad_plain(scene, cfg, 1, torch.from_numpy(g), 0,
                                     0, 16, 32)
    assert_rows_close(a32, d.numpy(), 1e-3)


def test_chunked_soft_gradient_is_ill_conditioned_at_a_grazing_hit(host_lib):
    """Where K3's chunked soft instance and plain autograd part most on
    tests/test_scaled.py:129's scene at 64x32 (spp 1, depth 3, eps 1.0:
    the inverse-radius entry of beacon 1, 1.04e-3 of its row's max over
    the frame), one pixel, (22, 27), carries it: its bounce off the beacon
    grazes sphere 962 (discriminant 6e-5 of nb^2), whose silhouette term
    sends a cotangent some 4000 times larger back into the beacon's
    normal.  There the gradient moves by more than the two part when the
    grazed sphere's centre moves by one float32 ulp (measured: the two
    part by 1.3e-3 of the entry, one ulp moves it by 9.2e-4 and by 40%,
    two by 41%): rounding, not a different function.  So the chunked soft
    instance's card gate at that size is 2e-3 (tests/test_torch_cuda.py);
    the hard instance there agrees within 1.6e-5."""
    scene = make_scaled_scene(n=2000, chunk=64, extent=40.0)
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=1, max_depth=3,
                       soft_silhouette_eps=1.0)
    x, y = 22, 27
    g = np.random.RandomState(0).rand(32, 64, 3).astype(np.float32)
    gp = np.ascontiguousarray(g[y:y + 1, x:x + 1])
    _, _, acc, _ = grad_pool_host(host_lib, scene, cfg, 0, gp, x, y)
    row, sph = tc.ROW_INVR, 1

    def plain(center_x):
        c = scene.center.clone()
        c[962, 0] = float(center_x)
        return float(render_tile_scaled_grad_plain(
            scene.replace(center=c), cfg, 0, torch.from_numpy(gp), x, y, 1,
            1)[2][row, sph])

    x0 = np.float32(scene.center[962, 0])
    want = plain(x0)
    parted = abs(acc[row, sph] - want)
    assert 1e-4 * abs(want) < parted < 2e-3 * abs(want)
    moved = [abs(plain(np.nextafter(x0, np.float32(s * np.inf),
                                    dtype=np.float32)) - want)
             for s in (1, -1)]
    assert max(moved) > 10 * parted, (moved, parted)
    hard = cfg.replace(soft_silhouette_eps=0.0)
    _, _, acc_h, _ = grad_pool_host(host_lib, scene, hard, 0, gp, x, y)
    _, _, d_h = render_tile_scaled_grad_plain(
        scene, hard, 0, torch.from_numpy(gp), x, y, 1, 1)
    assert_rows_close(acc_h, d_h.numpy(), 1e-4)


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("lanes", [1, 32])
def test_forty_lights_warp_and_pool_forms_match_plain_autograd(host_lib,
                                                               soft, lanes):
    """40 lights (tools/scenes.many_lights_scene: past the 16 bits of `see`
    a carry record holds, and past a word of 32): K3's warp form with the
    seen lights in words of their own (lights_warp_grad_kernel's
    LightTapeOf<false>) and the pool form (LightTapeOf<true>), in one
    one-lane warp and in two 32-lane warps, 16x8, spp 1, depth 3, hard and
    eps 0.05: within 1e-3 of plain autograd row by row, rays exact, the
    image within 1e-4, the two forms' tables bit-equal on the same warps,
    and gradients reach the emission of the lights past the 32nd."""
    scene = many_lights_scene()
    assert len(scene.emissive_ids) == 40
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1, max_depth=3,
                       soft_silhouette_eps=0.05 if soft else 0.0)
    g = np.random.RandomState(9).rand(8, 16, 3).astype(np.float32)
    warps = 1 if lanes == 1 else 2
    out, rays, acc = grad_lights_host(host_lib, scene, cfg, 0, g, 0, 0, warps,
                                      lanes)
    p_out, p_rays, p_acc, _ = grad_pool_host(host_lib, scene, cfg, 0, g, 0, 0,
                                             warps, lanes)
    np.testing.assert_array_equal(p_out, out)
    assert p_rays == rays
    np.testing.assert_array_equal(p_acc, acc)
    img, prays, d = render_tile_grad_plain(scene, cfg, 0, torch.from_numpy(g),
                                           0, 0, 8, 16)
    assert rays == int(prays)
    assert np.abs(out - img.numpy()).max() <= 1e-4
    assert_rows_close(acc, d.numpy(), 1e-3)
    late = list(scene.emissive_ids[32:])
    assert np.abs(acc[tc.ROW_EM:tc.ROW_EM + 3][:, late]).max() > 0


FIELDS = ("center", "radius", "albedo", "emissive", "roughness", "ri")
LIGHTS_CFG = dict(width=16, height=8, samples_per_pixel=1, max_depth=1)

# jax.grad of sum(img * w) through the JAX package's differentiable render
# of the scene in the .npz argv[1] (its fields, mat_type, emissive_ids,
# camera and w), config argv[3]; the fields' gradients to argv[2].
JAX_LIGHTS = r"""
import sys

import jax
import jax.numpy as jnp
import numpy as np

from toypathtracer_tpu import RenderConfig
from toypathtracer_tpu.render.wavefront import render_frame
from toypathtracer_tpu.scene import CameraSpec, Scene

d = dict(np.load(sys.argv[1], allow_pickle=True))
fields = ("center", "radius", "albedo", "emissive", "roughness", "ri")
scene = Scene(**{f: jnp.asarray(d[f]) for f in fields},
              mat_type=tuple(int(m) for m in d["mat_type"]),
              emissive_ids=tuple(int(e) for e in d["emissive_ids"]),
              camera=CameraSpec(**d["camera"].item()))
cfg = RenderConfig(**eval(sys.argv[3]))


def loss(s):
    img, _ = render_frame(s, cfg, jnp.int32(0), differentiable=True)
    return jnp.sum(img * d["w"])


g = jax.grad(loss)(scene)
np.savez(sys.argv[2], **{f: np.asarray(getattr(g, f)) for f in fields})
"""


@pytest.fixture(scope="module")
def lights_jax_ref(tmp_path_factory):
    """(scene, w, JAX's gradients) of tools/scenes.
    few_spheres_many_lights_scene (17 lights) at LIGHTS_CFG, jax.grad in a
    child process whose XLA may not contract a product and a sum into one
    multiply-add (XLA_FLAGS=--xla_cpu_max_isa=AVX, as tests/
    test_torch_soft.py), so that it rounds as the port does."""
    scene = few_spheres_many_lights_scene()
    w = np.random.RandomState(9).rand(8, 16, 3).astype(np.float32)
    d = tmp_path_factory.mktemp("lights_ref")
    np.savez(d / "scene.npz", w=w, mat_type=np.array(scene.mat_type),
             emissive_ids=np.array(scene.emissive_ids),
             camera=np.array(dataclasses.asdict(scene.camera), dtype=object),
             **{f: getattr(scene, f).numpy() for f in FIELDS})
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX",
               PYTHONPATH=os.pathsep.join([str(root)]
                                          + [q for q in sys.path if q]))
    subprocess.run([sys.executable, "-c", JAX_LIGHTS, str(d / "scene.npz"),
                    str(d / "grad.npz"), repr(LIGHTS_CFG)], env=env,
                   check=True, cwd=root, timeout=900)
    with np.load(d / "grad.npz") as g:
        return scene, w, dict(g)


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("source", ["plain", "kernel"])
def test_seventeen_lights_gradient_matches_jax(host_lib, lights_jax_ref,
                                               source, field):
    """17 lights (one past the 16 bits of `see` a carry record holds)
    against jax.grad of the JAX package's differentiable render, 16x8,
    spp 1, depth 1, the RandomState(9) cotangent: the port's plain
    version (autograd through render/wavefront.render_tile_plain) and
    K3's warp form past 16 lights (LightTapeOf records, two 32-lane
    warps) carried to the fields through pack_scene.  Per field, max
    |diff| <= 1e-3 x the field's max |jax.grad| (tests/test_torch_soft.py's
    gate); measured at most 3.4e-6 of it for the plain version and
    2.6e-6 for the kernel (the centres).
    At depth 1 no path scatters again, so roughness and ri take no
    gradient on either side; the emission of the lights past the 16th
    does."""
    scene, w, want = lights_jax_ref
    cfg = RenderConfig(**LIGHTS_CFG)
    leaves = {f: getattr(scene, f).clone().requires_grad_(True)
              for f in FIELDS}
    live = scene.replace(**leaves)
    if source == "plain":
        img, _ = render_tile_plain(live, cfg, 0, 0, 0, 8, 16)
        (img * torch.from_numpy(w)).sum().backward()
    else:
        _, _, acc = grad_lights_host(host_lib, scene, cfg, 0, w, 0, 0, 2, 32)
        cuda_render.pack_scene(live).backward(torch.from_numpy(acc))
    got = leaves[field].grad.numpy()
    scale = np.abs(want[field]).max()
    assert np.isfinite(got).all()
    assert np.abs(got - want[field]).max() <= 1e-3 * scale, (
        np.abs(got - want[field]).max(), scale)
    if field in ("roughness", "ri"):
        assert scale == 0.0 and not got.any()
    else:
        assert scale > 0
    if field == "emissive":
        late = list(scene.emissive_ids[16:])
        assert np.abs(want[field][late]).max() > 0


@pytest.mark.parametrize("lanes", [1, 32])
def test_lights_instance_bit_equal_to_16_light_instance(host_lib, lanes):
    """On the 46-sphere scene (2 lights) the warp form's lights instance
    (seen lights in words of their own) gives the 16-light instance's
    image, rays and table bit for bit, soft at eps 0.05."""
    scene = make_scene(big=True)
    cfg = RenderConfig(width=32, height=8, samples_per_pixel=2, max_depth=4,
                       soft_silhouette_eps=0.05)
    g = np.random.RandomState(6).rand(8, 32, 3).astype(np.float32)
    form = 2 if lanes == 1 else 31
    out, rays, acc = grad_form_host(host_lib, scene, cfg, 2, g, 0, 0, form)
    l_out, l_rays, l_acc = grad_lights_host(host_lib, scene, cfg, 2, g, 0, 0,
                                            1, lanes)
    np.testing.assert_array_equal(l_out, out)
    assert l_rays == rays
    np.testing.assert_array_equal(l_acc, acc)
