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
                                        shadow_index)

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
    """K6's cooperative routine's bits, with the scene's shadow_index as
    ops/cuda_scaled passes it."""
    n = ro.shape[1]
    out = np.full(n, -1, np.int32)
    index = shadow_index(torch.from_numpy(rows), 256)
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
    """scaled.shadow_index on the 100k scene: its order is a permutation of
    the 391 chunks with the outsized boxes last (the beacons' chunk 0 and
    the padded last one among them); its group boxes are group_boxes over
    that order and far tighter than over the rows' own order; its records
    are the rows' spheres, (cx, cy, cz, r^2) each."""
    scene = make_scaled_scene(100_000)
    rows = pack_chunks(scene)
    K = scene.chunk
    index = shadow_index(rows, K)
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
