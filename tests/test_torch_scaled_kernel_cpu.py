"""The scaled kernels' per-ray code (toypathtracer_torch/csrc/chunks.cuh and
render_pixel<ChunkedView> of csrc/trace.cuh), built with g++ for the CPU,
against their plain PyTorch versions (scaled.ChunkTraversal and
scaled.render_tile_scaled_plain); and the warp-cooperative form of the
scaled render kernel (csrc/coop.cuh) against the per-lane form.

The traversal is held exactly: the same ids, the same t, the same
occlusion bits, on the rays of tests/test_scaled.py plus rays along the
axes (zero and negative-zero direction components take the +-1e-12
reciprocal) and rays with a NaN component (jnp's NaN-propagating slab test
lets them enter no chunk).  The render is held with
tests/test_torch_kernel_cpu.py's gates (ray count 1e-4 relative, 99.9% of
pixels within 1e-4, mean |diff| 5e-7): glibc's sinf/cosf/expf/logf
against torch's vectorised ones.

The cooperative form is held exactly: a warp of 32 lanes emulated here
(each lane's share of a chunk's spheres, then the butterfly combine of
(t, j) in the warp's xor order; the shadow vote step by step) gives the
sequential traversal's ids, t and bits, on those rays and on a chunk
whose duplicated spheres force equal roots; the group boxes pass every
ray that one of their chunks passes, on the 100k scene; and
render_tiles_merged, under the one-lane warp policy, renders the per-lane
form's image and rays bit for bit.  K6's cooperative routine
(shadow_chunks_warp, coop_shadow_kernel's) gives occluded_chunks' bits
exactly, in a one-lane warp and in a warp of 32 host threads
(csrc/hostwarp.h), with its own threshold and with thresholds that force
each branch of the walk: 8 lights, NaN and zero direction components, a
NaN t_l, origins inside a light's chunk, a tail of 45 rays.
"""

import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from toypathtracer_torch import RenderConfig
from toypathtracer_torch.camera import camera_to_array, make_camera
from toypathtracer_torch.ops import _build, cuda_render
from toypathtracer_torch.scaled import (ChunkTraversal, group_boxes,
                                        make_scaled_scene, pack_chunks,
                                        render_tile_scaled_plain,
                                        chunk_index)

torch.set_num_threads(1)

HARNESS = r"""
#include <thread>
#include <vector>

#include "coop.cuh"
#include "hostwarp.h"

static tpt::ChunkedView view(const float* rows, const float* box, int C,
                             int K) {
  tpt::ChunkedView V;
  V.tab = nullptr; V.mat = nullptr; V.lights = nullptr;
  V.rows = rows; V.box = box;
  V.n = C * K; V.n_lights = 0; V.chunk = K; V.n_chunks = C;
  return V;
}

extern "C" void tpt_hit_cpu(const float* rows, const float* box, int C,
                            int K, const float* ro, const float* rd, int n,
                            float t_min, float t_max, float* t,
                            int32_t* id) {
  tpt::ChunkedView V = view(rows, box, C, K);
  for (int i = 0; i < n; ++i)
    id[i] = tpt::hit_chunks_ray(V, tpt::v3(ro[i], ro[n + i], ro[2 * n + i]),
                                tpt::v3(rd[i], rd[n + i], rd[2 * n + i]),
                                t_min, t_max, t[i]);
}

extern "C" void tpt_occ_cpu(const float* rows, const float* box, int C,
                            int K, const float* ro, const float* dirs,
                            const float* t_ls, const int32_t* ids, int n_l,
                            int n, float t_min, int32_t* out) {
  tpt::ChunkedView V = view(rows, box, C, K);
  for (int i = 0; i < n; ++i) {
    int32_t bits = 0;
    for (int k = 0; k < n_l; ++k) {
      const float* d = dirs + (size_t)3 * k * n;
      if (tpt::occluded_chunks(
              V, tpt::v3(ro[i], ro[n + i], ro[2 * n + i]),
              tpt::v3(d[i], d[n + i], d[2 * n + i]), ids[k], t_min,
              t_ls[(size_t)k * n + i]))
        bits |= 1 << k;
    }
    out[i] = bits;
  }
}

extern "C" unsigned long long tpt_scaled_render_cpu(
    const float* tab, const float* rows, const float* box,
    const int32_t* mat, const int32_t* lights, const float* cam,
    const tpt::RenderParams* p, int C, int K, float* out) {
  tpt::ChunkedView S = view(rows, box, C, K);
  S.tab = tab; S.mat = mat; S.lights = lights;
  S.n = p->n_spheres; S.n_lights = p->n_lights;
  unsigned long long rays = 0;
  for (int y = 0; y < p->height; ++y)
    for (int x = 0; x < p->width; ++x)
      rays += tpt::render_pixel(S, cam, *p, p->x0 + x, p->y0 + y,
                                out + ((size_t)y * p->width + x) * 3);
  return rays;
}

// The counting traversals of the per-lane stats instance, with a counter
// that sums each lane's chunk steps and sphere tests: answers into t/id or
// out, steps and tests into work (2, n).
struct HostCount {
  static constexpr bool kOn = true;
  long long steps = 0, tests = 0;
  void call(bool) {}
  void chunk(bool, bool, int t) { ++steps; tests += t; }
};

extern "C" void tpt_hit_counted_cpu(const float* rows, const float* box,
                                    int C, int K, const float* ro,
                                    const float* rd, int n, float t_min,
                                    float t_max, float* t, int32_t* id,
                                    long long* work) {
  tpt::ChunkedView V = view(rows, box, C, K);
  for (int i = 0; i < n; ++i) {
    HostCount cnt;
    id[i] = tpt::hit_chunks_ray(
        V, tpt::v3(ro[i], ro[n + i], ro[2 * n + i]),
        tpt::v3(rd[i], rd[n + i], rd[2 * n + i]), t_min, t_max, t[i], cnt);
    work[i] = cnt.steps;
    work[n + i] = cnt.tests;
  }
}

extern "C" void tpt_occ_counted_cpu(const float* rows, const float* box,
                                    int C, int K, const float* ro,
                                    const float* dir, const float* t_l,
                                    int light, int n, float t_min,
                                    int32_t* out, long long* work) {
  tpt::ChunkedView V = view(rows, box, C, K);
  for (int i = 0; i < n; ++i) {
    HostCount cnt;
    out[i] = tpt::occluded_chunks(
        V, tpt::v3(ro[i], ro[n + i], ro[2 * n + i]),
        tpt::v3(dir[i], dir[n + i], dir[2 * n + i]), light, t_min, t_l[i],
        cnt);
    work[i] = cnt.steps;
    work[n + i] = cnt.tests;
  }
}

// The cooperative form's per-pixel loop under the one-lane warp policy.
extern "C" unsigned long long tpt_merged_render_cpu(
    const float* tab, const float* rows, const float* box, const float* gbox,
    int G, const int32_t* mat, const int32_t* lights, const float* cam,
    const tpt::RenderParams* p, int C, int K, float* out) {
  tpt::CoopView S;
  static_cast<tpt::ChunkedView&>(S) = view(rows, box, C, K);
  S.tab = tab; S.mat = mat; S.lights = lights;
  S.n = p->n_spheres; S.n_lights = p->n_lights;
  float nee[tpt::kMaxLights * 7];  // nee_words(kMaxLights, 1)
  S.gbox = gbox; S.n_groups = G; S.nee = nee;
  const tpt::HostLane w;
  tpt::NoCoopCount none;
  int next_tile = 0;
  return tpt::render_tiles_merged(w, S, cam, *p, &next_tile, out, none);
}

// A warp of 32 lanes, emulated: every chunk a ray enters is tested by all
// lanes (lane l: spheres l, l + 32, ...) and their (t, j) combined in the
// butterfly order of the card's shfl_xor reduction.
extern "C" void tpt_warp_hit_cpu(const float* rows, const float* box, int C,
                                 int K, const float* ro, const float* rd,
                                 int n, float t_min, float t_max, float* t,
                                 int32_t* id) {
  tpt::ChunkedView V = view(rows, box, C, K);
  for (int i = 0; i < n; ++i) {
    const tpt::V3 o = tpt::v3(ro[i], ro[n + i], ro[2 * n + i]);
    const tpt::V3 d = tpt::v3(rd[i], rd[n + i], rd[2 * n + i]);
    const tpt::V3 inv = tpt::v3(tpt::safe_inv(d.x), tpt::safe_inv(d.y),
                                tpt::safe_inv(d.z));
    float best = t_max;
    int hid = -1;
    if (!tpt::any_nan(o) && !tpt::any_nan(inv))
      for (int c = 0; c < C; ++c) {
        if (!tpt::slab(V.box + 6 * c, o, inv, t_min, best)) continue;
        float bt[32], nt[32];
        int bj[32], nj[32];
        for (int l = 0; l < 32; ++l)
          tpt::coop_hit_lane(V.chunk_row(c), K, l, 32, o, d, t_min, best,
                             bt[l], bj[l]);
        for (int off = 16; off > 0; off >>= 1) {
          for (int l = 0; l < 32; ++l) {
            nt[l] = bt[l];
            nj[l] = bj[l];
            tpt::coop_combine(nt[l], nj[l], bt[l ^ off], bj[l ^ off]);
          }
          for (int l = 0; l < 32; ++l) {
            bt[l] = nt[l];
            bj[l] = nj[l];
          }
        }
        for (int l = 1; l < 32; ++l)
          if (bt[l] != bt[0] || bj[l] != bj[0]) { id[i] = -2; return; }
        if (bj[0] < K) {
          best = bt[0];
          hid = c * K + bj[0];
        }
      }
    t[i] = best;
    id[i] = hid;
  }
}

// The shadow test of an emulated warp: per chunk a ray enters, steps of
// 32 spheres, one a lane, until a step holds an occluder.
extern "C" void tpt_warp_occ_cpu(const float* rows, const float* box, int C,
                                 int K, const float* ro, const float* dirs,
                                 const float* t_ls, const int32_t* ids,
                                 int n_l, int n, float t_min, int32_t* out) {
  tpt::ChunkedView V = view(rows, box, C, K);
  for (int i = 0; i < n; ++i) {
    int32_t bits = 0;
    const tpt::V3 pos = tpt::v3(ro[i], ro[n + i], ro[2 * n + i]);
    for (int k = 0; k < n_l; ++k) {
      const float* dk = dirs + (size_t)3 * k * n;
      const tpt::V3 l = tpt::v3(dk[i], dk[n + i], dk[2 * n + i]);
      const float t_l = t_ls[(size_t)k * n + i];
      const tpt::V3 inv = tpt::v3(tpt::safe_inv(l.x), tpt::safe_inv(l.y),
                                  tpt::safe_inv(l.z));
      if (tpt::any_nan(pos) || tpt::any_nan(inv) || tpt::is_nan(t_l))
        continue;
      bool occ = false;
      for (int c = 0; c < C && !occ; ++c) {
        if (!tpt::slab(V.box + 6 * c, pos, inv, t_min, t_l)) continue;
        for (int s = 0; s * 32 < K && !occ; ++s)
          for (int lane = 0; lane < 32; ++lane)
            occ = occ || tpt::coop_occ_lane(V.chunk_row(c), K, c * K, lane,
                                            32, s, pos, l, ids[k], t_min,
                                            t_l);
      }
      if (occ) bits |= 1 << k;
    }
    out[i] = bits;
  }
}

// K6's cooperative routine over n rays in a warp of `width` lanes (1: the
// one-lane warp; 32: 32 host threads), box holding the chunk boxes in the
// walk's order `order`, with the shadow walk's threshold
// kShadowCoopMin (mode 0), 1 (mode 1: every entered chunk run by its
// lanes' own loops) or 33 (mode 2: every one voted on by the warp).
// Returns 0, or -1 if the warp stalled.
template <int kMin>
int coop_shadow(const tpt::CoopView& V, const int32_t* order,
                const tpt::Sphere4* rec, const float* ro, const float* dirs,
                const float* t_ls, const int32_t* ids, int n_l, int n,
                float t_min, int32_t* out, int width) {
  int next = 0;
  if (width == 1) {
    tpt::HostLane w;
    tpt::NoCoopCount none;
    tpt::shadow_chunks_warp<kMin>(w, V, order, rec, ro, dirs, t_ls, ids,
                                  n_l, n, t_min, &next, out, none);
    return 0;
  }
  tpt::Lanes lanes;
  std::vector<std::thread> threads;
  for (int l = 0; l < 32; ++l)
    threads.emplace_back([&, l] {
      tpt::ThreadWarp w{&lanes, l};
      tpt::NoCoopCount none;
      tpt::shadow_chunks_warp<kMin>(w, V, order, rec, ro, dirs, t_ls, ids,
                                    n_l, n, t_min, &next, out, none);
    });
  for (auto& t : threads) t.join();
  return lanes.broken ? -1 : 0;
}

extern "C" int tpt_coop_shadow_cpu(const float* rows, const int32_t* order,
                                   const float* rec4, const float* box,
                                   const float* gbox, int G, int C, int K,
                                   const float* ro, const float* dirs,
                                   const float* t_ls, const int32_t* ids,
                                   int n_l, int n, float t_min, int32_t* out,
                                   int width, int mode) {
  tpt::CoopView V;
  static_cast<tpt::ChunkedView&>(V) = view(rows, box, C, K);
  V.gbox = gbox;
  V.n_groups = G;
  V.nee = nullptr;
  const tpt::Sphere4* rec = reinterpret_cast<const tpt::Sphere4*>(rec4);
  if (mode == 1)
    return coop_shadow<1>(V, order, rec, ro, dirs, t_ls, ids, n_l, n, t_min,
                          out, width);
  if (mode == 2)
    return coop_shadow<33>(V, order, rec, ro, dirs, t_ls, ids, n_l, n, t_min,
                           out, width);
  return coop_shadow<tpt::kShadowCoopMin>(V, order, rec, ro, dirs, t_ls, ids,
                                          n_l, n, t_min, out, width);
}

// K5's cooperative routine over n rays in a warp of `width` lanes (1: the
// one-lane warp; 32: 32 host threads), box holding the chunk boxes in the
// rows' order and gbox the group boxes over `order`, with the threshold
// kHitCoopMin (mode 0), 1 (mode 1: every entered chunk run by its lanes'
// own loops) or 33 (mode 2: every one decided by the whole warp).  Returns
// 0, or -1 if the warp stalled.
template <int kMin>
int coop_hit(const tpt::CoopView& V, const int32_t* order,
             const tpt::Sphere4* rec, const float* ro, const float* rd, int n,
             float t_min, float t_max, float* t, int32_t* id, int width) {
  int next = 0;
  std::vector<unsigned> mask(tpt::chunk_words(V.n_chunks));
  if (width == 1) {
    tpt::HostLane w;
    tpt::NoCoopCount none;
    tpt::hit_chunks_warp<kMin>(w, V, order, rec, mask.data(), ro, rd, n,
                               t_min, t_max, &next, t, id, none);
    return 0;
  }
  tpt::Lanes lanes;
  std::vector<std::thread> threads;
  for (int l = 0; l < 32; ++l)
    threads.emplace_back([&, l] {
      tpt::ThreadWarp w{&lanes, l};
      tpt::NoCoopCount none;
      tpt::hit_chunks_warp<kMin>(w, V, order, rec, mask.data(), ro, rd, n,
                                 t_min, t_max, &next, t, id, none);
    });
  for (auto& th : threads) th.join();
  return lanes.broken ? -1 : 0;
}

extern "C" int tpt_coop_hit_cpu(const float* rows, const int32_t* order,
                                const float* rec4, const float* box,
                                const float* gbox, int G, int C, int K,
                                const float* ro, const float* rd, int n,
                                float t_min, float t_max, float* t,
                                int32_t* id, int width, int mode) {
  tpt::CoopView V;
  static_cast<tpt::ChunkedView&>(V) = view(rows, box, C, K);
  V.gbox = gbox;
  V.n_groups = G;
  V.nee = nullptr;
  const tpt::Sphere4* rec = reinterpret_cast<const tpt::Sphere4*>(rec4);
  if (mode == 1)
    return coop_hit<1>(V, order, rec, ro, rd, n, t_min, t_max, t, id, width);
  if (mode == 2)
    return coop_hit<33>(V, order, rec, ro, rd, n, t_min, t_max, t, id, width);
  return coop_hit<tpt::kHitCoopMin>(V, order, rec, ro, rd, n, t_min, t_max, t,
                                    id, width);
}

// K5's prefilter for each ray alone (a one-lane warp) against the chunks
// hit_chunks_ray enters: counts[0] the entered chunks the mask lacks,
// counts[1] the entered chunks, counts[2] the mask's chunks, summed over
// the rays.
struct EnterLog {
  static constexpr bool kOn = true;
  std::vector<int> entered;
  int c = 0;
  void call(bool) {}
  void chunk(bool, bool e, int) {
    if (e) entered.push_back(c);
    ++c;
  }
};

extern "C" void tpt_hit_mask_cpu(const float* rows, const int32_t* order,
                                 const float* box, const float* gbox, int G,
                                 int C, int K, const float* ro,
                                 const float* rd, int n, float t_min,
                                 float t_max, long long* counts) {
  tpt::CoopView V;
  static_cast<tpt::ChunkedView&>(V) = view(rows, box, C, K);
  V.gbox = gbox;
  V.n_groups = G;
  V.nee = nullptr;
  std::vector<unsigned> mask(tpt::chunk_words(C));
  counts[0] = counts[1] = counts[2] = 0;
  for (int i = 0; i < n; ++i) {
    const tpt::V3 o = tpt::v3(ro[i], ro[n + i], ro[2 * n + i]);
    const tpt::V3 d = tpt::v3(rd[i], rd[n + i], rd[2 * n + i]);
    const tpt::V3 inv = tpt::v3(tpt::safe_inv(d.x), tpt::safe_inv(d.y),
                                tpt::safe_inv(d.z));
    const bool part = !tpt::any_nan(o) && !tpt::any_nan(inv);
    tpt::HostLane w;
    tpt::NoCoopCount none;
    tpt::hit_prefilter(w, V, order, part, o, inv, t_min, t_max, mask.data(),
                       none);
    EnterLog log;
    float t;
    tpt::hit_chunks_ray(V, o, d, t_min, t_max, t, log);
    for (int c : log.entered)
      if (!((mask[c / 32] >> (c % 32)) & 1u)) ++counts[0];
    counts[1] += static_cast<long long>(log.entered.size());
    for (unsigned word : mask) counts[2] += __builtin_popcount(word);
  }
}

// Per ray, the root tests of hit_chunks_ray's scan: the sphere tests in
// the chunks it enters whose discriminant is positive (sphere_root's
// arithmetic), into roots (n,).
extern "C" void tpt_hit_roots_cpu(const float* rows, const float* box, int C,
                                  int K, const float* ro, const float* rd,
                                  int n, float t_min, float t_max,
                                  long long* roots) {
  tpt::ChunkedView V = view(rows, box, C, K);
  for (int i = 0; i < n; ++i) {
    const tpt::V3 o = tpt::v3(ro[i], ro[n + i], ro[2 * n + i]);
    const tpt::V3 d = tpt::v3(rd[i], rd[n + i], rd[2 * n + i]);
    EnterLog log;
    float t;
    tpt::hit_chunks_ray(V, o, d, t_min, t_max, t, log);
    roots[i] = 0;
    for (int c : log.entered) {
      const float* r = V.chunk_row(c);
      for (int j = 0; j < K; ++j) {
        const float cox = r[j] - o.x;
        const float coy = r[K + j] - o.y;
        const float coz = r[2 * K + j] - o.z;
        const float nb = cox * d.x + coy * d.y + coz * d.z;
        const float cq = cox * cox + coy * coy + coz * coz - r[3 * K + j];
        if (nb * nb - cq > 0.0f) ++roots[i];
      }
    }
  }
}

// (ray, chunk) pairs where the chunk's slab test passes and its group's
// fails (counts[0]), and where the chunk's passes (counts[1]), for rays
// against (t_min, t1[i]).
extern "C" void tpt_group_check_cpu(const float* box, const float* gbox,
                                    int C, int group, const float* ro,
                                    const float* rd, const float* t1, int n,
                                    float t_min, long long* counts) {
  counts[0] = counts[1] = 0;
  for (int i = 0; i < n; ++i) {
    const tpt::V3 o = tpt::v3(ro[i], ro[n + i], ro[2 * n + i]);
    const tpt::V3 inv = tpt::v3(tpt::safe_inv(rd[i]),
                                tpt::safe_inv(rd[n + i]),
                                tpt::safe_inv(rd[2 * n + i]));
    for (int c = 0; c < C; ++c) {
      if (!tpt::slab(box + 6 * c, o, inv, t_min, t1[i])) continue;
      ++counts[1];
      if (!tpt::slab(gbox + 6 * (c / group), o, inv, t_min, t1[i]))
        ++counts[0];
    }
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("chunks_cpu")
    (d / "host.cpp").write_text(HARNESS)
    so = d / "libchunks_cpu.so"
    # -ffp-contract=off: no FMA contraction, as the CUDA build's -fmad=false
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17",
                    "-ffp-contract=off", "-pthread", f"-I{_build.CSRC}",
                    "-o", str(so), str(d / "host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpt_coop_shadow_cpu.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32,
                                        i32, ptr, ptr, ptr, ptr, i32, i32,
                                        f32, ptr, i32, i32]
    lib.tpt_hit_cpu.argtypes = [ptr, ptr, i32, i32, ptr, ptr, i32, f32, f32,
                                ptr, ptr]
    lib.tpt_occ_cpu.argtypes = [ptr, ptr, i32, i32, ptr, ptr, ptr, ptr, i32,
                                i32, f32, ptr]
    lib.tpt_scaled_render_cpu.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ctypes.POINTER(_build.RenderParams),
        i32, i32, ptr]
    lib.tpt_scaled_render_cpu.restype = ctypes.c_ulonglong
    lib.tpt_merged_render_cpu.argtypes = [
        ptr, ptr, ptr, ptr, i32, ptr, ptr, ptr,
        ctypes.POINTER(_build.RenderParams), i32, i32, ptr]
    lib.tpt_merged_render_cpu.restype = ctypes.c_ulonglong
    lib.tpt_hit_counted_cpu.argtypes = [ptr, ptr, i32, i32, ptr, ptr, i32,
                                        f32, f32, ptr, ptr, ptr]
    lib.tpt_occ_counted_cpu.argtypes = [ptr, ptr, i32, i32, ptr, ptr, ptr,
                                        i32, i32, f32, ptr, ptr]
    lib.tpt_warp_hit_cpu.argtypes = lib.tpt_hit_cpu.argtypes
    lib.tpt_warp_occ_cpu.argtypes = lib.tpt_occ_cpu.argtypes
    lib.tpt_group_check_cpu.argtypes = [ptr, ptr, i32, i32, ptr, ptr, ptr,
                                        i32, f32, ptr]
    lib.tpt_coop_hit_cpu.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                     ptr, ptr, i32, f32, f32, ptr, ptr, i32,
                                     i32]
    lib.tpt_hit_mask_cpu.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr,
                                     ptr, i32, f32, f32, ptr]
    lib.tpt_hit_roots_cpu.argtypes = [ptr, ptr, i32, i32, ptr, ptr, i32, f32,
                                      f32, ptr]
    return lib


def c_ptr(a: np.ndarray):
    return a.ctypes.data


def chunk_inputs(scene):
    rows = pack_chunks(scene).numpy()
    K = scene.chunk
    box = np.ascontiguousarray(rows[:, 4 * K:4 * K + 6])
    return rows, box


def scaled_rays(n_lanes=8192):
    """The ray batch of tests/test_scaled.py:101 (n=3000, chunk 256,
    2x32x128 lanes) with a few special rays appended."""
    rng = np.random.default_rng(5)
    ro = rng.uniform(-30, 30, (3, n_lanes)).astype(np.float32)
    d = rng.normal(size=(3, n_lanes)).astype(np.float32)
    rd = d / np.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2)
    axes = np.array([[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0],
                     [0, 0, 1], [0, 0, -1], [-0.0, -1, -0.0],
                     [0.6, 0.0, -0.8], [np.nan, 0, 1], [0, -1, 0]],
                    np.float32).T
    ro_axes = np.array([[0, 5, 0], [0, 5, 0], [-30, 0.3, 0], [30, 0.3, 2],
                        [1, 0.3, -30], [1, 0.3, 30], [3, 9, 3],
                        [-10, 0.35, 10], [0, 1, 0], [np.nan, 5, 0]],
                       np.float32).T
    return (np.ascontiguousarray(np.concatenate([ro, ro_axes], 1)),
            np.ascontiguousarray(np.concatenate([rd, axes], 1)))


def test_hit_chunks_ray_matches_plain(host_lib):
    scene = make_scaled_scene(n=3000, chunk=256, extent=40.0)
    rows, box = chunk_inputs(scene)
    ro, rd = scaled_rays()
    n = ro.shape[1]
    t = np.zeros(n, np.float32)
    hid = np.zeros(n, np.int32)
    host_lib.tpt_hit_cpu(c_ptr(rows), c_ptr(box), rows.shape[0], 256,
                         c_ptr(ro), c_ptr(rd), n, 1e-3, 1e7, c_ptr(t),
                         c_ptr(hid))
    pt, pid, _, _ = ChunkTraversal(torch.from_numpy(rows), 256).nearest_hit(
        tuple(torch.from_numpy(ro)), tuple(torch.from_numpy(rd)),
        float(np.float32(1e-3)), 1e7)
    np.testing.assert_array_equal(hid, pid.numpy())
    np.testing.assert_array_equal(t, pt.numpy())
    assert (hid >= 0).sum() > 100 and hid[-2] == hid[-1] == -1
    assert (hid[-10:-2] >= 0).sum() >= 4  # the axis rays hit the field


def shadow_inputs(scene, n=8192):
    """tests/test_scaled.py:169's shadow rays: toward 4 beacons with
    jittered directions, t_l from the beacon's own root.  Returns the
    origins (3, n), directions (4, 3, n), t_l (4, n) and light ids."""
    from toypathtracer_torch.ops import tracecore as tc
    rng = np.random.default_rng(3)
    ro = rng.uniform(-30, 30, (3, n)).astype(np.float32)
    c = scene.center.numpy()
    r2 = scene.radius.numpy() ** 2
    lights = [0, 1, 2, 3]
    dirs, t_ls = [], []
    for e in lights:
        d = (c[e][:, None] - ro + rng.normal(0, 2, (3, n))).astype(np.float32)
        d = d / np.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2)
        dirs.append(d)
        t_l, _ = tc.sphere_t(*(float(x) for x in c[e]), float(r2[e]),
                             tuple(torch.from_numpy(ro)),
                             tuple(torch.from_numpy(d)),
                             float(np.float32(1e-3)))
        t_ls.append(t_l.numpy())
    return (ro, np.ascontiguousarray(np.stack(dirs)),
            np.ascontiguousarray(np.stack(t_ls)), np.array(lights, np.int32))


def occlusion_bits(fn, rows, box, ro, D, T, ids):
    n = ro.shape[1]
    out = np.zeros(n, np.int32)
    fn(c_ptr(rows), c_ptr(box), rows.shape[0], 256, c_ptr(ro), c_ptr(D),
       c_ptr(T), c_ptr(ids), len(ids), n, 1e-3, c_ptr(out))
    return out


def test_occluded_chunks_matches_plain(host_lib):
    """tests/test_scaled.py:169's shadow rays: toward 4 beacons with
    jittered directions, t_l from the beacon's own root."""
    scene = make_scaled_scene(n=3000, chunk=256, extent=40.0)
    rows, box = chunk_inputs(scene)
    ro, D, T, ids = shadow_inputs(scene)
    n = ro.shape[1]
    out = occlusion_bits(host_lib.tpt_occ_cpu, rows, box, ro, D, T, ids)
    trav = ChunkTraversal(torch.from_numpy(rows), 256)
    want = np.zeros(n, np.int32)
    for k, e in enumerate(ids):
        occ, slabs, spheres = trav.occluded(
            tuple(torch.from_numpy(ro)), tuple(torch.from_numpy(D[k])),
            int(e), float(np.float32(1e-3)), torch.from_numpy(T[k]))
        want |= occ.numpy().astype(np.int32) << k
        assert (slabs.numpy() <= rows.shape[0]).all()
        assert (spheres.numpy() <= 256 * slabs.numpy()).all()
    np.testing.assert_array_equal(out, want)
    assert 0 < (out != 0).mean() < 1


@pytest.mark.parametrize("kind", ["hit", "shadow"])
def test_counted_traversals_match_plain(host_lib, kind):
    """K5's and K6's traversals with a counter (the per-lane stats
    instance's) give their answers and count the plain version's slab and
    sphere tests exactly."""
    scene = make_scaled_scene(n=3000, chunk=256, extent=40.0)
    rows, box = chunk_inputs(scene)
    trav = ChunkTraversal(torch.from_numpy(rows), 256)
    t_min = float(np.float32(1e-3))
    if kind == "hit":
        ro, rd = scaled_rays()
        n = ro.shape[1]
        t = np.zeros(n, np.float32)
        hid = np.zeros(n, np.int32)
        work = np.zeros((2, n), np.int64)
        host_lib.tpt_hit_counted_cpu(c_ptr(rows), c_ptr(box), rows.shape[0],
                                     256, c_ptr(ro), c_ptr(rd), n, 1e-3, 1e7,
                                     c_ptr(t), c_ptr(hid), c_ptr(work))
        pt, pid, slabs, spheres = trav.nearest_hit(
            tuple(torch.from_numpy(ro)), tuple(torch.from_numpy(rd)), t_min,
            1e7)
        np.testing.assert_array_equal(hid, pid.numpy())
        np.testing.assert_array_equal(t, pt.numpy())
        live = ~np.isnan(ro).any(0) & ~np.isnan(rd).any(0)
    else:
        ro, D, T, ids = shadow_inputs(scene)
        n = ro.shape[1]
        occ = np.zeros(n, np.int32)
        work = np.zeros((2, n), np.int64)
        host_lib.tpt_occ_counted_cpu(c_ptr(rows), c_ptr(box), rows.shape[0],
                                     256, c_ptr(ro), c_ptr(D[1]), c_ptr(T[1]),
                                     int(ids[1]), n, 1e-3, c_ptr(occ),
                                     c_ptr(work))
        pocc, slabs, spheres = trav.occluded(
            tuple(torch.from_numpy(ro)), tuple(torch.from_numpy(D[1])),
            int(ids[1]), t_min, torch.from_numpy(T[1]))
        np.testing.assert_array_equal(occ, pocc.numpy().astype(np.int32))
        assert 0 < occ.mean() < 1
        live = np.ones(n, bool)
    np.testing.assert_array_equal(work[0][live], slabs.numpy()[live])
    np.testing.assert_array_equal(work[1], spheres.numpy())
    assert work[1].sum() > 0


def tie_inputs():
    """The n=3000 field with sphere 17 of chunk 2 copied to its spheres 49
    (the same lane of a warp, one step later), 20, 130 and 255 (other
    lanes), and rays aimed at its center from around it: their nearest
    roots tie between the copies, and the first copy has to win."""
    scene = make_scaled_scene(n=3000, chunk=256, extent=40.0)
    rows, _ = chunk_inputs(scene)
    K, c, j0 = 256, 2, 17
    for j in (49, 20, 130, 255):
        for q in range(4):
            rows[c, q * K + j] = rows[c, q * K + j0]
    box = np.ascontiguousarray(rows[:, 4 * K:4 * K + 6])
    center = rows[c, [j0, K + j0, 2 * K + j0]]
    rng = np.random.default_rng(11)
    n = 2048
    ro = (center[:, None]
          + rng.normal(0, 1, (3, n)) * rng.uniform(2, 12, n)
          ).astype(np.float32)
    ro[1] = np.abs(ro[1]) + 0.5
    d = (center[:, None] + rng.normal(0, 0.05, (3, n)) - ro).astype(np.float32)
    rd = (d / np.sqrt((d * d).sum(axis=0))).astype(np.float32)
    return rows, box, np.ascontiguousarray(ro), np.ascontiguousarray(rd), \
        c * K + j0


@pytest.mark.parametrize("case", ["field", "ties"])
def test_warp_hit_matches_sequential(host_lib, case):
    """The emulated warp's chunk test -- 32 lanes' shares combined over
    (t, j) -- against hit_chunks_ray, the sequential scan: ids and t
    exact, the first of equal roots winning."""
    if case == "field":
        rows, box = chunk_inputs(make_scaled_scene(n=3000, chunk=256,
                                                   extent=40.0))
        ro, rd = scaled_rays()
    else:
        rows, box, ro, rd, first = tie_inputs()
    n = ro.shape[1]
    got = []
    for fn in (host_lib.tpt_hit_cpu, host_lib.tpt_warp_hit_cpu):
        t = np.zeros(n, np.float32)
        hid = np.zeros(n, np.int32)
        fn(c_ptr(rows), c_ptr(box), rows.shape[0], 256, c_ptr(ro),
           c_ptr(rd), n, 1e-3, 1e7, c_ptr(t), c_ptr(hid))
        got.append((t, hid))
    (t_s, id_s), (t_w, id_w) = got
    np.testing.assert_array_equal(id_w, id_s)
    np.testing.assert_array_equal(t_w, t_s)
    assert (id_s >= 0).sum() > 100
    if case == "ties":
        assert (id_s == first).mean() > 0.5
        assert not np.isin(id_s, first + np.array([3, 32, 113, 238])).any()


def test_warp_shadow_matches_sequential(host_lib):
    """The emulated warp's shadow vote against occluded_chunks: the same
    bits for every ray and light."""
    scene = make_scaled_scene(n=3000, chunk=256, extent=40.0)
    rows, box = chunk_inputs(scene)
    args = (rows, box, *shadow_inputs(scene))
    want = occlusion_bits(host_lib.tpt_occ_cpu, *args)
    got = occlusion_bits(host_lib.tpt_warp_occ_cpu, *args)
    np.testing.assert_array_equal(got, want)
    assert 0 < (want != 0).mean() < 1


def k6_inputs(scene, n, seed=7):
    """Shadow rays of K6's layout toward the scene's 8 beacons from seeded
    origins over the field (half of them among its spheres, in some chunk's
    box), directions jittered, t_l from each beacon's own root; then the
    edge cases: ray 0's first direction has a NaN
    component, ray 1's second is (0, 1, 0) and ray 2's third (-0.0, -1,
    0.0) with exact zero components, ray 3's fourth t_l is NaN, ray 4's
    origin is NaN, rays 5-12 start inside their light's chunk box (at the
    beacon's center and beside it).  Returns origins (3, n), directions
    (8, 3, n), t_l (8, n) and the light ids."""
    from toypathtracer_torch.ops import tracecore as tc
    rng = np.random.default_rng(seed)
    ro = rng.uniform((-30, 0.0, -30), (30, 12, 30), (n, 3)).astype(
        np.float32).T.copy()
    ro[1, 1::2] *= np.float32(0.1)  # half of them in the chunks' boxes
    c = scene.center.numpy()
    r2 = scene.radius.numpy() ** 2
    lights = list(scene.emissive_ids)
    assert len(lights) == 8
    for j, e in enumerate(lights):
        ro[:, 5 + j] = c[e] + np.float32(0.3) * j
    dirs, t_ls = [], []
    for k, e in enumerate(lights):
        d = (c[e][:, None] - ro + rng.normal(0, 1.5, (3, n))).astype(
            np.float32)
        d = d / np.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2)
        if k == 0:
            d[1, 0] = np.nan
        if k == 1:
            d[:, 1] = (0.0, 1.0, 0.0)
        if k == 2:
            d[:, 2] = (-0.0, -1.0, 0.0)
        dirs.append(d)
        t_l, _ = tc.sphere_t(*(float(x) for x in c[e]), float(r2[e]),
                             tuple(torch.from_numpy(ro)),
                             tuple(torch.from_numpy(d)),
                             float(np.float32(1e-3)))
        t_l = t_l.numpy().copy()
        if k == 3:
            t_l[3] = np.nan
        t_ls.append(t_l)
    ro[0, 4] = np.nan
    return (np.ascontiguousarray(ro), np.ascontiguousarray(np.stack(dirs)),
            np.ascontiguousarray(np.stack(t_ls)), np.array(lights, np.int32))


def coop_bits(lib, rows, ro, D, T, ids, width, mode):
    """K6's cooperative routine's bits, with the scene's chunk_index as
    ops/cuda_scaled passes it."""
    n = ro.shape[1]
    out = np.full(n, -1, np.int32)
    index = chunk_index(torch.from_numpy(rows), 256)
    order, rec, gbox = (t.numpy() for t in (index.order, index.rec,
                                            index.gbox))
    box = np.ascontiguousarray(rows[order, 4 * 256:4 * 256 + 6])
    code = lib.tpt_coop_shadow_cpu(
        c_ptr(rows), c_ptr(order), c_ptr(rec), c_ptr(box), c_ptr(gbox),
        gbox.shape[0], rows.shape[0], 256, c_ptr(ro), c_ptr(D), c_ptr(T),
        c_ptr(ids), len(ids), n, 1e-3, c_ptr(out), width, mode)
    assert code == 0, "a 32-lane warp stalled at a collective"
    return out


COOP_SHADOW = {  # (warp width, rays, coop_shadow_cpu mode)
    "one_lane-kShadowCoopMin": (1, 4096, 0),
    "one_lane-own_loops": (1, 4096, 1),
    "one_lane-votes": (1, 4096, 2),
    "32_lanes_tail45-kShadowCoopMin": (32, 45, 0),
    "32_lanes_tail45-own_loops": (32, 45, 1),
}


@pytest.mark.parametrize("case", list(COOP_SHADOW))
def test_coop_shadow_matches_occluded_chunks(host_lib, case):
    """K6's cooperative routine against occluded_chunks (the per-thread
    K6's code) on the 3072-sphere field with its 8 beacons: the same bits
    for every ray and light, the edge cases included.  A warp of 32 host
    threads takes 45 rays: a full batch, then a tail whose lanes past n
    take part with no ray; with its own threshold the warp both votes and
    runs its lanes' own loops (a forced all-votes walk runs in the one-lane
    warp only: 32 host threads' collectives are slow here)."""
    width, n, mode = COOP_SHADOW[case]
    scene = make_scaled_scene(n=3000, chunk=256, extent=40.0)
    rows, box = chunk_inputs(scene)
    ro, D, T, ids = k6_inputs(scene, n)
    want = occlusion_bits(host_lib.tpt_occ_cpu, rows, box, ro, D, T, ids)
    got = coop_bits(host_lib, rows, ro, D, T, ids, width, mode)
    np.testing.assert_array_equal(got, want)
    # the NaN cases give 0 for their light; the rest are occluded often
    # enough to test both answers
    assert not want[0] & 1 and not want[3] & 8 and not want[4]
    assert 0.05 < float(np.mean([(want >> k) & 1 for k in range(8)])) < 0.95


def test_group_boxes_are_conservative(host_lib):
    """On the 100k scene (391 chunks, 25 groups, the last one partial) and
    131,072 seeded rays against a far and a near bound: no chunk's slab
    test passes where its group's fails, so skipping a group the warp does
    not enter skips no chunk that a ray enters."""
    scene = make_scaled_scene(100_000)
    rows_t = pack_chunks(scene)
    K = scene.chunk
    gbox_t = group_boxes(rows_t, K)
    rows = rows_t.numpy()
    box = np.ascontiguousarray(rows[:, 4 * K:4 * K + 6])
    C = box.shape[0]
    G = gbox_t.shape[0]
    assert (C, G) == (391, 25)
    pad = np.concatenate([box, np.tile([np.inf] * 3 + [-np.inf] * 3,
                                       (16 * G - C, 1))]).reshape(G, 16, 6)
    want = np.concatenate([pad[:, :, :3].min(1), pad[:, :, 3:].max(1)], 1)
    gbox = gbox_t.numpy()
    np.testing.assert_array_equal(gbox, want.astype(np.float32))
    rng = np.random.default_rng(2024)
    n = 1 << 17
    ro = rng.uniform((-150.0, 0.2, -150.0), (150.0, 30.0, 150.0),
                     (n, 3)).astype(np.float32).T.copy()
    d = rng.normal(size=(3, n)).astype(np.float32)
    rd = (d / np.sqrt((d * d).sum(axis=0))).astype(np.float32)
    t1 = np.where(np.arange(n) % 2 == 0, np.float32(1e7),
                  rng.uniform(0.01, 300.0, n)).astype(np.float32)
    counts = np.zeros(2, np.int64)
    host_lib.tpt_group_check_cpu(c_ptr(box), c_ptr(gbox), C, 16, c_ptr(ro),
                                 c_ptr(rd), c_ptr(t1), n, 1e-3,
                                 c_ptr(counts))
    assert counts[0] == 0
    assert counts[1] > n


def test_shadow_index_orders_chunks_with_tight_groups():
    """scaled.chunk_index on the 100k scene: its order is a permutation of
    the 391 chunks with the outsized boxes last (the beacons' chunk 0 and
    the padded last one among them); its group boxes are group_boxes over
    that order and far tighter than over the rows' own order; its records
    are the rows' spheres, (cx, cy, cz, r^2) each."""
    scene = make_scaled_scene(100_000)
    rows = pack_chunks(scene)
    K = scene.chunk
    index = chunk_index(rows, K)
    order = index.order.numpy()
    assert index.order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(391))
    box = rows[:, 4 * K:4 * K + 6].numpy()
    extent = (box[:, 3:] - box[:, :3]).max(axis=1)
    n_big = int((extent > 4 * np.median(extent)).sum())
    assert n_big >= 2 and {0, 390} <= set(order[-n_big:].tolist())
    assert (extent[order[-n_big:]] > 4 * np.median(extent)).all()
    assert torch.equal(index.gbox, group_boxes(rows[index.order.long()], K))

    def median_extent(g):
        return float(np.median((g[:, 3:] - g[:, :3]).numpy().max(axis=1)))
    assert median_extent(index.gbox) < 0.6 * median_extent(
        group_boxes(rows, K))
    rec = index.rec.numpy().reshape(391, K, 4)
    for q in range(4):
        np.testing.assert_array_equal(rec[:, :, q],
                                      rows[:, q * K:(q + 1) * K].numpy())


def render_host(lib, scene, cfg, frame, x0, y0, h, w):
    """The scaled launcher's inputs, prepared as ops/cuda_scaled does."""
    tab = cuda_render.pack_scene(scene).numpy()
    rows, box = chunk_inputs(scene)
    mat = scene.mat_ids().numpy()
    lights = np.array(scene.emissive_ids, np.int32)
    cam = camera_to_array(make_camera(scene.camera, cfg.width / cfg.height))
    out = np.zeros((h, w, 3), np.float32)
    params = cuda_render.render_params(scene, cfg, frame, x0, y0, h, w)
    rays = lib.tpt_scaled_render_cpu(
        c_ptr(tab), c_ptr(rows), c_ptr(box), c_ptr(mat), c_ptr(lights),
        c_ptr(cam), ctypes.byref(params), scene.n_chunks, scene.chunk,
        out.ctypes.data)
    return out, rays


@pytest.mark.parametrize("frame,x0,y0", [(0, 0, 0), (5, 40, 7)])
def test_scaled_render_source_matches_plain(host_lib, frame, x0, y0):
    scene = make_scaled_scene(n=800, chunk=128)
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=2, max_depth=4)
    h, w = 16, 32
    out, rays = render_host(host_lib, scene, cfg, frame, x0, y0, h, w)
    img, prays = render_tile_scaled_plain(scene, cfg, frame, x0, y0, h, w)
    img = img.numpy()
    assert np.isfinite(out).all() and out.max() > 0.05
    assert abs(rays - int(prays)) <= 1e-4 * int(prays)
    d = np.abs(out - img)
    assert (d.max(axis=-1) <= 1e-4).mean() >= 0.999
    assert d.mean() <= 5e-7


def render_merged_host(lib, scene, cfg, frame, x0, y0, h, w):
    """render_tiles_merged over the tile, under the one-lane warp."""
    tab = cuda_render.pack_scene(scene).numpy()
    rows_t = pack_chunks(scene)
    gbox = group_boxes(rows_t, scene.chunk).numpy()
    rows, box = chunk_inputs(scene)
    mat = scene.mat_ids().numpy()
    lights = np.array(scene.emissive_ids, np.int32)
    cam = camera_to_array(make_camera(scene.camera, cfg.width / cfg.height))
    out = np.zeros((h, w, 3), np.float32)
    params = cuda_render.render_params(scene, cfg, frame, x0, y0, h, w)
    rays = lib.tpt_merged_render_cpu(
        c_ptr(tab), c_ptr(rows), c_ptr(box), c_ptr(gbox), gbox.shape[0],
        c_ptr(mat), c_ptr(lights), c_ptr(cam), ctypes.byref(params),
        scene.n_chunks, scene.chunk, out.ctypes.data)
    return out, rays


@pytest.mark.parametrize("n,chunk,extent,nee,frame,x0,y0", [
    (800, 128, 100.0, True, 0, 0, 0),
    (800, 128, 100.0, True, 5, 40, 7),
    (3000, 256, 40.0, True, 2, 16, 9),
    (3000, 256, 40.0, False, 3, 8, 4)])
def test_merged_render_bit_equal_to_per_lane(host_lib, n, chunk, extent, nee,
                                             frame, x0, y0):
    """The cooperative form's path loop (merged samples, the compacted
    shadow rays with their own chunks first, the group and chunk skips)
    renders the per-lane form's image and ray count bit for bit."""
    scene = make_scaled_scene(n=n, chunk=chunk, extent=extent)
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=2, max_depth=4,
                       do_light_sampling=nee)
    h, w = 16, 32
    want, rays = render_host(host_lib, scene, cfg, frame, x0, y0, h, w)
    got, mrays = render_merged_host(host_lib, scene, cfg, frame, x0, y0, h,
                                    w)
    assert want.max() > 0.05 and rays > 2 * h * w
    np.testing.assert_array_equal(got, want)
    assert mrays == rays


# ---- K5's cooperative routine (hit_chunks_warp) ----------------------------


@functools.lru_cache(maxsize=None)
def scene_100k():
    return make_scaled_scene(100_000)


@functools.lru_cache(maxsize=None)
def field_100k():
    """The 100k-sphere scene's rows (391 chunks of 256, 25 groups)."""
    return pack_chunks(scene_100k()).numpy()


def camera_rays_100k(px, py):
    """Frame 0's first camera rays of pixels (px, py) at 1280x720 on the
    100k scene, as the render draws them."""
    from toypathtracer_torch.tools.shadow_stats import camera_rays
    cfg = RenderConfig(width=1280, height=720, samples_per_pixel=4,
                       max_depth=10)
    ro, rd, _ = camera_rays(scene_100k(), cfg, 0, torch.as_tensor(px),
                            torch.as_tensor(py))
    return (np.ascontiguousarray(torch.stack(ro).numpy()),
            np.ascontiguousarray(torch.stack(rd).numpy()))


def set_box(rows, K, c):
    """Chunk c's box in its row, from its spheres."""
    ctr = rows[c, :3 * K].reshape(3, K)
    r = np.sqrt(rows[c, 3 * K:4 * K])
    rows[c, 4 * K:4 * K + 3] = (ctr - r).min(axis=1)
    rows[c, 4 * K + 3:4 * K + 6] = (ctr + r).max(axis=1)


def aimed_rays(center, rng, n):
    """Rays aimed at `center` from around it (above the ground)."""
    ro = (center[:, None]
          + rng.normal(0, 1, (3, n)) * rng.uniform(2, 12, n)
          ).astype(np.float32)
    ro[1] = np.abs(ro[1]) + 0.5
    d = (center[:, None] + rng.normal(0, 0.05, (3, n)) - ro).astype(np.float32)
    return ro, (d / np.sqrt((d * d).sum(axis=0))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def hit_inputs(name):
    """(rows, ro, rd, check) of K5's g++ cases, made once and read only;
    the last 45 rays are the 32-lane warp's (a full batch and a 13-ray
    tail)."""
    rows, ro, rd, check = make_hit_inputs(name)
    for a in (rows, ro, rd):
        a.flags.writeable = False
    return rows, ro, rd, check


@functools.lru_cache(maxsize=None)
def hit_index(name):
    """(order, rec, gbox) of hit_inputs(name)'s rows' chunk_index, as
    ops/cuda_scaled passes it."""
    rows = hit_inputs(name)[0]
    index = chunk_index(torch.from_numpy(rows.copy()),
                        (rows.shape[1] - 8) // 4)
    return tuple(x.numpy() for x in (index.order, index.rec, index.gbox))


def make_hit_inputs(name):
    rng = np.random.default_rng(31)
    if name == "camera_100k":
        # every 24th pixel of the frame, then 45 consecutive ones of a row
        yy, xx = np.meshgrid(np.arange(0, 720, 24), np.arange(0, 1280, 24),
                             indexing="ij")
        px = np.concatenate([xx.ravel(), np.arange(600, 645)])
        py = np.concatenate([yy.ravel(), np.full(45, 361)])
        return (field_100k(), *camera_rays_100k(px, py), None)
    if name == "origins_in_chunk0_100k":
        # origins inside chunk 0's box (it holds the 8 beacons and spans
        # the field): at the beacons' centers, inside their spheres, and
        # among the field's spheres
        rows = field_100k()
        K = 256
        n = 1024
        ro = rng.uniform((-150.0, 0.2, -150.0), (150.0, 14.0, 150.0),
                         (n, 3)).astype(np.float32).T.copy()
        beacons = rows[0, :3 * K].reshape(3, K)[:, :8]
        ro[:, -8:] = beacons
        ro[:, -16:-8] = beacons + np.float32(1.0)
        d = rng.normal(size=(3, n)).astype(np.float32)
        rd = (d / np.sqrt((d * d).sum(axis=0))).astype(np.float32)
        lo, hi = rows[0, 4 * K:4 * K + 3], rows[0, 4 * K + 3:4 * K + 6]
        assert ((ro >= lo[:, None]) & (ro <= hi[:, None])).all(axis=0).mean() \
            > 0.5
        return rows, np.ascontiguousarray(ro), rd, None
    scene = make_scaled_scene(n=3000, chunk=32, extent=40.0)
    rows, _ = chunk_inputs(scene)
    K = 32
    if name == "random":
        # scaled_rays: the last 10 are the axis rays, a NaN direction
        # component, a NaN origin, zero and -0.0 components
        ro, rd = scaled_rays(4096)
        return rows, ro, rd, None
    if name == "ties_across_groups":
        # sphere 5 of chunk 60 copied over sphere 9 of chunk 7, whose
        # group in the spatial order is another: equal roots in two
        # chunks, and the lower id (chunk 7's) has to win
        c1, j1, c2, j2 = 60, 5, 7, 9
        for q in range(4):
            rows[c2, q * K + j2] = rows[c1, q * K + j1]
        set_box(rows, K, c2)
        order = chunk_index(torch.from_numpy(rows), K).order.numpy()
        pos = np.argsort(order)
        assert pos[c1] // 16 != pos[c2] // 16
        ro, rd = aimed_rays(rows[c1, [j1, K + j1, 2 * K + j1]], rng, 1024)
        return rows, ro, rd, ("first", c2 * K + j2, c1 * K + j1)
    if name == "ties_within_chunk":
        rows, _, ro, rd, first = tie_inputs()
        return rows, ro, rd, ("first", first, None)
    # grazing: tangent to spheres (offset by a few ulps either way), then
    # in the planes of chunk box faces and along their edges, from just
    # inside, on and just outside them
    real = np.nonzero(rows[:, 3 * K:4 * K].ravel() > 0)[0]
    n = 2048
    idx = rng.choice(real, n)
    ctr = np.stack([rows[:, q * K:(q + 1) * K].ravel()[idx]
                    for q in range(3)])
    r = np.sqrt(rows[:, 3 * K:4 * K].ravel()[idx])
    d = rng.normal(size=(3, n))
    d /= np.sqrt((d * d).sum(axis=0))
    u = rng.normal(size=(3, n))
    u -= (u * d).sum(axis=0) * d
    u /= np.sqrt((u * u).sum(axis=0))
    scale = 1.0 + rng.choice([-3e-7, -1e-7, 0.0, 1e-7, 3e-7], n)
    ro = (ctr + u * r * scale - d * rng.uniform(1, 40, n)).astype(np.float32)
    rd = d.astype(np.float32)
    m = 512
    c = rng.integers(0, rows.shape[0] - 1, m)
    box = rows[c, 4 * K:4 * K + 6].T
    axis = rng.integers(0, 3, m)
    side = rng.integers(0, 2, m)
    fo = np.stack([rng.uniform(box[a], box[a + 3]) for a in range(3)])
    fd = rng.normal(size=(3, m))
    for k in range(m):
        a = axis[k]
        plane = np.float32(box[a + 3 * side[k], k])
        fo[a, k] = np.nextafter(plane, np.float32(
            [-np.inf, 0, np.inf][k % 3]), dtype=np.float32) \
            if k % 3 != 1 else plane
        fd[a, k] = [0.0, -0.0][k % 2]
        if k % 5 == 0:  # along an edge: a second face's plane too
            b = (a + 1) % 3
            fo[b, k] = box[b + 3 * (k % 2), k]
            fd[b, k] = 0.0
    fd /= np.sqrt((fd * fd).sum(axis=0))
    # back off along the ray: the face coordinates stay (their d is 0)
    fo = (fo - fd * rng.uniform(1, 30, m)).astype(np.float32)
    ro = np.concatenate([ro, fo], axis=1)
    rd = np.concatenate([rd, fd.astype(np.float32)], axis=1)
    return rows, np.ascontiguousarray(ro), np.ascontiguousarray(rd), None


def hit_sequential(lib, rows, ro, rd, K, t_max=1e7):
    n = ro.shape[1]
    t = np.zeros(n, np.float32)
    hid = np.zeros(n, np.int32)
    box = np.ascontiguousarray(rows[:, 4 * K:4 * K + 6])
    lib.tpt_hit_cpu(c_ptr(rows), c_ptr(box), rows.shape[0], K, c_ptr(ro),
                    c_ptr(rd), n, 1e-3, t_max, c_ptr(t), c_ptr(hid))
    return t, hid


def hit_coop(lib, inputs, ro, rd, width, mode, t_max=1e7):
    """K5's cooperative routine on the rows of hit_inputs(inputs) with
    their chunk_index."""
    rows = hit_inputs(inputs)[0]
    K = (rows.shape[1] - 8) // 4
    n = ro.shape[1]
    t = np.full(n, np.nan, np.float32)
    hid = np.full(n, -2, np.int32)
    order, rec, gbox = hit_index(inputs)
    box = np.ascontiguousarray(rows[:, 4 * K:4 * K + 6])
    code = lib.tpt_coop_hit_cpu(
        c_ptr(rows), c_ptr(order), c_ptr(rec), c_ptr(box), c_ptr(gbox),
        gbox.shape[0], rows.shape[0], K, c_ptr(ro), c_ptr(rd), n, 1e-3,
        t_max, c_ptr(t), c_ptr(hid), width, mode)
    assert code == 0, "a 32-lane warp stalled at a collective"
    return t, hid


HIT_INPUTS = ["camera_100k", "origins_in_chunk0_100k", "random",
              "ties_across_groups", "ties_within_chunk", "grazing"]
HIT_WARPS = {  # (warp width, coop_hit_cpu mode, rays: all or the last 45)
    "one_lane": (1, 0, None),
    "32_lanes_tail45": (32, 0, 45),
    "32_lanes_tail45-own_loops": (32, 1, 45),
    "32_lanes_tail45-votes": (32, 2, 45),
}
HIT_CASES = [(i, w) for i in HIT_INPUTS for w in ("one_lane",
                                                  "32_lanes_tail45")] + [
    ("random", "32_lanes_tail45-own_loops"),
    ("random", "32_lanes_tail45-votes"),
    ("ties_within_chunk", "32_lanes_tail45-votes")]


@pytest.mark.parametrize("inputs,warp", HIT_CASES)
def test_coop_hit_bit_equal_to_hit_chunks_ray(host_lib, inputs, warp):
    """K5's cooperative routine against hit_chunks_ray (the per-thread
    K5): ids and t bit for bit, in a one-lane warp and in a warp of 32 host
    threads
    (with its own threshold, and forced to run every entered chunk by its
    lanes' own loops or by the whole warp's votes), on the 100k scene's
    camera rays and origins inside chunk 0's box, and on a field of 94
    chunks in 6 groups: random rays with NaN and zero direction
    components, equal roots in two chunks of different groups and within
    one chunk (the first wins), rays grazing spheres and chunk boxes."""
    rows, ro, rd, check = hit_inputs(inputs)
    width, mode, tail = HIT_WARPS[warp]
    if tail:
        ro = np.ascontiguousarray(ro[:, -tail:])
        rd = np.ascontiguousarray(rd[:, -tail:])
    K = (rows.shape[1] - 8) // 4
    t_s, id_s = hit_sequential(host_lib, rows, ro, rd, K)
    t_w, id_w = hit_coop(host_lib, inputs, ro, rd, width, mode)
    np.testing.assert_array_equal(id_w, id_s)
    np.testing.assert_array_equal(t_w.view(np.int32), t_s.view(np.int32))
    assert (id_s >= 0).mean() > 0.05
    if check and not tail:
        _, first, second = check
        assert (id_s == first).mean() > 0.5
        if second is not None:
            assert not (id_s == second).any()


@pytest.mark.parametrize("inputs", ["camera_100k", "random", "grazing"])
def test_hit_prefilter_keeps_every_entered_chunk(host_lib, inputs):
    """The prefilter's chunk mask, each ray alone, holds every chunk that
    hit_chunks_ray enters, and far fewer than all chunks on the 100k
    scene's camera rays."""
    rows, ro, rd, _ = hit_inputs(inputs)
    K = (rows.shape[1] - 8) // 4
    order, _, gbox = hit_index(inputs)
    box = np.ascontiguousarray(rows[:, 4 * K:4 * K + 6])
    counts = np.zeros(3, np.int64)
    n = ro.shape[1]
    host_lib.tpt_hit_mask_cpu(c_ptr(rows), c_ptr(order), c_ptr(box),
                              c_ptr(gbox), gbox.shape[0], rows.shape[0], K,
                              c_ptr(ro), c_ptr(rd), n, 1e-3, 1e7,
                              c_ptr(counts))
    missing, entered, kept = counts
    assert missing == 0 and entered > n
    if inputs == "camera_100k":
        assert kept < 0.4 * rows.shape[0] * n


def test_hit_stats_plain_counts(host_lib):
    """tools.hit_stats' counts from the plain slab chain, on the CPU at the
    94-chunk field: the chunk boxes a ray crosses are the ones
    hit_chunks_ray's counter sees it enter at its initial bound (at least
    those it enters under its running best), the groups a warp enters
    hold those its rays enter, and the spatial order's groups are entered
    less often than the rows' order's."""
    from toypathtracer_torch.scaled import ChunkedScenePort
    from toypathtracer_torch.tools import hit_stats
    scene = make_scaled_scene(n=3000, chunk=32, extent=40.0)
    port = ChunkedScenePort(scene)
    rows = port.rows.numpy()
    ro, rd = scaled_rays(2048)
    ro, rd = ro[:, :2048], rd[:, :2048]   # no NaN rays: 64 full warps
    cfg = RenderConfig(width=64, height=32)
    _, hid = hit_sequential(host_lib, rows, ro, rd, 32, t_max=cfg.max_t)
    res = hit_stats.plain_counts(
        port, tuple(torch.from_numpy(ro)), tuple(torch.from_numpy(rd)),
        torch.from_numpy(hid).long(), cfg)
    n = ro.shape[1]
    work = np.zeros((2, n), np.int64)
    box = np.ascontiguousarray(rows[:, 4 * 32:4 * 32 + 6])
    t = np.zeros(n, np.float32)
    host_lib.tpt_hit_counted_cpu(c_ptr(rows), c_ptr(box), rows.shape[0], 32,
                                 c_ptr(ro), c_ptr(rd), n, 1e-3, cfg.max_t,
                                 c_ptr(t), c_ptr(hid), c_ptr(work))
    entered = work[1].sum() / 32 / n
    assert res["chunk_boxes_crossed_per_ray"] >= entered > 0
    assert res["rays_hit"] == pytest.approx(float((hid >= 0).mean()))
    assert 0 < res["rays_entering_chunk0"] <= 1
    g = res["groups"]
    for k in g:
        assert 0 < g[k]["entered_per_ray"] <= g[k]["entered_per_warp"] \
            <= g[k]["of"]
    assert g["groups_index_order"]["entered_per_ray"] < \
        g["groups_rows_order"]["entered_per_ray"]


@pytest.mark.parametrize("inputs", ["camera_100k", "random"])
def test_plain_root_tests_match_hit_chunks_ray(host_lib, inputs):
    """ChunkTraversal.nearest_hit_roots' root tests (the bound's count of
    the square roots K5 takes) ray by ray against hit_chunks_ray's scan:
    the sphere tests with a positive discriminant in the chunks it
    enters, NaN and zero direction components included."""
    rows, ro, rd, _ = hit_inputs(inputs)
    K = (rows.shape[1] - 8) // 4
    n = ro.shape[1]
    want = np.zeros(n, np.int64)
    box = np.ascontiguousarray(rows[:, 4 * K:4 * K + 6])
    host_lib.tpt_hit_roots_cpu(c_ptr(rows), c_ptr(box), rows.shape[0], K,
                               c_ptr(ro), c_ptr(rd), n, 1e-3, 1e7,
                               c_ptr(want))
    t_s, id_s = hit_sequential(host_lib, rows, ro, rd, K)
    t, hid, _, spheres, roots = ChunkTraversal(
        torch.from_numpy(rows.copy()), K).nearest_hit_roots(
        tuple(torch.from_numpy(ro.copy())), tuple(torch.from_numpy(rd.copy())),
        float(np.float32(1e-3)), 1e7)
    np.testing.assert_array_equal(hid.numpy(), id_s)
    np.testing.assert_array_equal(roots.numpy(), want)
    assert 0 < want.sum() < spheres.sum().item()
