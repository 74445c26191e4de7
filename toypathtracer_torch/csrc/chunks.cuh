// Chunk traversal of the scaled scene, per ray: the bodies of the
// traversal kernels (K5 hit_chunks_kernel, K6 shadow_chunks_kernel) and of
// the scaled render kernel (csrc/scaled.cu).
//
// Replaces the TPU kernels toypathtracer_tpu/ops/scaled_pallas.py::
// _hit_kernel and ::_shadow_kernel.  Those walk (32, 128) ray tiles over a
// (tiles, chunks) grid, skip a chunk for the whole tile with pl.when and
// stream each chunk's sphere scalars through SMEM, because Mosaic allows
// no per-lane gathers and only 128-aligned dynamic VMEM indices.  A GPU
// thread gates its own ray, which is the semantics of the jnp chunk scan
// (scaled.py:575-663, :299-394) that the TPU kernels reproduce: for each
// chunk in order, a slab test of the chunk's AABB against (t_min, the
// ray's running best t) -- (t_min, t_l) for a shadow ray -- and the
// chunk's sphere tests only when the box can still hold a closer hit (an
// occluder).
//
// Arithmetic is the JAX code's, comparison for comparison:
// (aabb - ro) * inv with inv = 1 / (d, or +-1e-12 where |d| < 1e-12; -0.0
// goes to +1e-12), never a division by d in the slab; an inclusive t0 <=
// t1; a sphere wins with discr > 0 && t > t_min && t < best (strict `<`,
// so the first sphere of least t wins across and within chunks).
// jnp.maximum / jnp.minimum propagate NaN, so a ray whose origin, inverse
// direction or t_l is NaN enters no chunk there; the loops below test that
// once per ray and then select without NaN (no other input can make one:
// every other operand is finite, |inv| <= 1e12).
//
// Everything is __host__ __device__, so tests build it with g++.

#pragma once

#include "trace.cuh"

namespace tpt {

// Largest chunk count whose AABBs the kernels stage in shared memory
// (24 bytes a chunk; ops/cuda_scaled.MAX_CHUNKS).
constexpr int kMaxChunks = 4096;

// The scaled scene as the kernels read it: the packed (SCENE_ROWS, n)
// table for shading, the pack_chunks rows (n_chunks, 4 * chunk + 8:
// cx, cy, cz, r^2 of the chunk's spheres, aabb, base, pad) for the sphere
// tests, and the chunk AABBs (n_chunks, 6), staged in shared memory.
struct ChunkedView {
  const float* tab;       // (SCENE_ROWS, n)
  const int32_t* mat;     // (n,)
  const int32_t* lights;  // (n_lights,)
  const float* rows;      // (n_chunks, 4 * chunk + 8)
  const float* box;       // (n_chunks, 6)
  int n, n_lights, chunk, n_chunks;
  TPT_HD float at(int row, int i) const { return tab[row * n + i]; }
  TPT_HD const float* chunk_row(int c) const {
    return rows + static_cast<size_t>(c) * (4 * chunk + 8);
  }
};

TPT_HD float safe_inv(float d) {
  const float s = fabsf(d) < 1e-12f ? (d >= 0.0f ? 1e-12f : -1e-12f) : d;
  return 1.0f / s;
}

TPT_HD bool is_nan(float x) { return x != x; }
TPT_HD bool any_nan(V3 a) { return is_nan(a.x) || is_nan(a.y) || is_nan(a.z); }
TPT_HD float fmin_sel(float a, float b) { return a < b ? a : b; }
TPT_HD float fmax_sel(float a, float b) { return a > b ? a : b; }

// Does the ray enter box b = (min xyz, max xyz) within [t0, t1]?  The
// slab chain of scaled.py:616-624 on NaN-free operands.
TPT_HD bool slab(const float* b, V3 ro, V3 inv, float t0, float t1) {
  float lo = (b[0] - ro.x) * inv.x;
  float hi = (b[3] - ro.x) * inv.x;
  t0 = fmax_sel(t0, fmin_sel(lo, hi));
  t1 = fmin_sel(t1, fmax_sel(lo, hi));
  lo = (b[1] - ro.y) * inv.y;
  hi = (b[4] - ro.y) * inv.y;
  t0 = fmax_sel(t0, fmin_sel(lo, hi));
  t1 = fmin_sel(t1, fmax_sel(lo, hi));
  lo = (b[2] - ro.z) * inv.z;
  hi = (b[5] - ro.z) * inv.z;
  t0 = fmax_sel(t0, fmin_sel(lo, hi));
  t1 = fmin_sel(t1, fmax_sel(lo, hi));
  return t0 <= t1;
}

// Sphere j of a chunk row r (chunk size K) for one ray: its nearest valid
// root tt (Maths.cpp:97-117) and whether it is one (discr > 0, tt > t_min).
TPT_HD bool sphere_root(const float* r, int K, int j, V3 ro, V3 rd,
                        float t_min, float& tt) {
  const float cox = r[j] - ro.x;
  const float coy = r[K + j] - ro.y;
  const float coz = r[2 * K + j] - ro.z;
  const float nb = cox * rd.x + coy * rd.y + coz * rd.z;
  const float cq = cox * cox + coy * coy + coz * coz - r[3 * K + j];
  const float discr = nb * nb - cq;
  const float ds = sqrt_pos(discr);
  const float r0 = nb - ds;
  const float r1 = nb + ds;
  tt = r0 > t_min ? r0 : r1;
  return discr > 0.0f && tt > t_min;
}

// Does sphere j of a chunk row overlap (t_min, t_l) along l from pos?  The
// interval-overlap test of tracecore._occ_test.
TPT_HD bool sphere_overlaps(const float* r, int K, int j, V3 pos, V3 l,
                            float t_min, float t_l) {
  const float cox = r[j] - pos.x;
  const float coy = r[K + j] - pos.y;
  const float coz = r[2 * K + j] - pos.z;
  const float cq = cox * cox + coy * coy + coz * coz - r[3 * K + j];
  const float nb = cox * l.x + coy * l.y + coz * l.z;
  const float d = nb * nb - cq;
  const float a = nb - t_min;
  const float b = nb - t_l;
  return d > 0.0f && d > b * fabsf(b) && d > -(a * fabsf(a));
}

// Spheres j = j0, j0 + step, ... of a chunk for one ray, with a strict `<`
// against the ray's best t: lowers t to the nearest root below it and
// returns that sphere's index, or K if none is below it.  (j0, step) =
// (0, 1) is the sequential scan of one chunk; (lane, 32) is one lane's
// share of a warp's test of the whole chunk (csrc/coop.cuh).
TPT_HD int nearest_in_chunk(const float* r, int K, int j0, int step, V3 ro,
                            V3 rd, float t_min, float& t) {
  int jw = K;
  for (int j = j0; j < K; j += step) {
    float tt;
    if (sphere_root(r, K, j, ro, rd, t_min, tt) && tt < t) {
      t = tt;
      jw = j;
    }
  }
  return jw;
}

// The first sphere of a chunk (global ids base..base+K-1) but `light` that
// overlaps (t_min, t_l) along l from pos: its index, or K if none.
TPT_HD int first_overlap_in_chunk(const float* r, int K, int base, V3 pos,
                                  V3 l, int light, float t_min, float t_l) {
  for (int j = 0; j < K; ++j)
    if (sphere_overlaps(r, K, j, pos, l, t_min, t_l) && base + j != light)
      return j;
  return K;
}

// A traversal counter that counts nothing: K5, K6 and the timed render
// kernels.  A counter's call(shadow) runs at the start of a traversal and
// its chunk(shadow, entered, tests) after each chunk step, by every lane of
// the loop: whether the lane's ray entered the chunk and how many of its
// spheres it tested (the per-lane scaled render's stats instance,
// csrc/scaled.cu, counts them).
struct NoChunkCount {
  static constexpr bool kOn = false;
  TPT_HD void call(bool) {}
  TPT_HD void chunk(bool, bool, int) {}
};

// K5 for one ray: the nearest hit over all chunks; sets t (t_max on a
// miss) and returns the sphere's global id, -1 on a miss.
template <class Count>
TPT_HD int hit_chunks_ray(const ChunkedView& V, V3 ro, V3 rd, float t_min,
                          float t_max, float& t, Count& cnt) {
  cnt.call(false);
  t = t_max;
  int id = -1;
  const V3 inv = v3(safe_inv(rd.x), safe_inv(rd.y), safe_inv(rd.z));
  if (any_nan(ro) || any_nan(inv)) return -1;
  const int K = V.chunk;
  for (int c = 0; c < V.n_chunks; ++c) {
    const bool entered = slab(V.box + 6 * c, ro, inv, t_min, t);
    if (entered) {
      // nearest_in_chunk's scan with the global id set in the loop: K5
      // keeps its 40 registers (a returned index compiles to 38)
      const float* r = V.chunk_row(c);
      for (int j = 0; j < K; ++j) {
        float tt;
        if (sphere_root(r, K, j, ro, rd, t_min, tt) && tt < t) {
          t = tt;
          id = c * K + j;
        }
      }
    }
    cnt.chunk(false, entered, entered ? K : 0);
  }
  return id;
}

TPT_HD int hit_chunks_ray(const ChunkedView& V, V3 ro, V3 rd, float t_min,
                          float t_max, float& t) {
  NoChunkCount none;
  return hit_chunks_ray(V, ro, rd, t_min, t_max, t, none);
}

// K6 for one ray and one light: does any sphere but `light` (a global id)
// overlap (t_min, t_l) along l from pos?  The answer is an OR over chunks,
// so the loop stops at the first occluder.
template <class Count>
TPT_HD bool occluded_chunks(const ChunkedView& V, V3 pos, V3 l, int light,
                            float t_min, float t_l, Count& cnt) {
  cnt.call(true);
  const V3 inv = v3(safe_inv(l.x), safe_inv(l.y), safe_inv(l.z));
  if (any_nan(pos) || any_nan(inv) || is_nan(t_l)) return false;
  const int K = V.chunk;
  for (int c = 0; c < V.n_chunks; ++c) {
    const bool entered = slab(V.box + 6 * c, pos, inv, t_min, t_l);
    const float* r = V.chunk_row(c);
    if constexpr (Count::kOn) {
      // every lane of the loop reports the step together, then returns
      const int j = entered ? first_overlap_in_chunk(r, K, c * K, pos, l,
                                                     light, t_min, t_l)
                            : K;
      cnt.chunk(true, entered, entered ? (j < K ? j + 1 : K) : 0);
      if (j < K) return true;
    } else if (entered) {
      // sphere_overlaps written out: through the helper (or
      // first_overlap_in_chunk), K6 and the per-lane render kernel ran
      // ~15% and ~11% slower on an H100, with the same registers (PERF.md)
      const int base = c * K;
      for (int j = 0; j < K; ++j) {
        const float cox = r[j] - pos.x;
        const float coy = r[K + j] - pos.y;
        const float coz = r[2 * K + j] - pos.z;
        const float cq = cox * cox + coy * coy + coz * coz - r[3 * K + j];
        const float nb = cox * l.x + coy * l.y + coz * l.z;
        const float d = nb * nb - cq;
        const float a = nb - t_min;
        const float b = nb - t_l;
        if (d > 0.0f && d > b * fabsf(b) && d > -(a * fabsf(a)) &&
            base + j != light)
          return true;
      }
    }
  }
  return false;
}

TPT_HD bool occluded_chunks(const ChunkedView& V, V3 pos, V3 l, int light,
                            float t_min, float t_l) {
  NoChunkCount none;
  return occluded_chunks(V, pos, l, light, t_min, t_l, none);
}

// The traversal of the scaled render: render_pixel<ChunkedView> (trace.cuh)
// finds these by argument-dependent lookup.
TPT_HD int nearest_hit(const ChunkedView& S, V3 ro, V3 rd, float t_min,
                       float t_max, float& hit_t) {
  return hit_chunks_ray(S, ro, rd, t_min, t_max, hit_t);
}

TPT_HD bool occluded(const ChunkedView& S, V3 pos, V3 l, int light,
                     float t_min, float t_l) {
  return occluded_chunks(S, pos, l, light, t_min, t_l);
}

// The scaled scene as the gradient kernel's chunked instances read it
// (csrc/grad.cu chunk_grad_kernel): a ChunkedView, its box read where it
// lies, and the chunk boxes of the soft-silhouette estimator's two scans,
// inflated by margins the wrapper computes (scaled.soft_boxes): each
// chunk's box widened by delta_c = sqrt(rmax_c^2 + 8 eps) for the
// silhouette scan, by sqrt(rmax_c^2 + 8 max(eps, 1)) for the shadow
// boundary's (scaled.py:396, :502).  A ray that misses an inflated box
// passes every sphere in it at a discriminant below -8 eps, where the
// estimator's sigmoid and its gradient are below 3.4e-4 of their peak: the
// scans skip such chunks, as the plain version and the JAX package do.
struct GradChunkedView : ChunkedView {
  const float* sil_box;   // (n_chunks, 6); null in the hard instance
  const float* prox_box;  // (n_chunks, 6)
};

// The chunked form of trace.cuh's silhouette_candidate (the miss side of
// scaled.ChunkTraversal.silhouette): over the chunks whose silhouette box
// the ray enters within (t_min, 1e7), in order, the sphere with the
// largest d among those in front of the ray (nb > t_min) and not padding
// (r^2 > 0), the first on ties, from -1e9; -1 unless its d exceeds -1e8.
TPT_HD int silhouette_candidate(const GradChunkedView& S, V3 ro, V3 rd,
                                float t_min, float& d_best, float& nb_best) {
  int cand = -1;
  d_best = -1e9f;
  nb_best = 0.0f;
  const V3 inv = v3(safe_inv(rd.x), safe_inv(rd.y), safe_inv(rd.z));
  if (any_nan(ro) || any_nan(inv)) return -1;
  const int K = S.chunk;
  for (int c = 0; c < S.n_chunks; ++c) {
    if (!slab(S.sil_box + 6 * c, ro, inv, t_min, 1e7f)) continue;
    const float* r = S.chunk_row(c);
    for (int j = 0; j < K; ++j) {
      const float cox = r[j] - ro.x;
      const float coy = r[K + j] - ro.y;
      const float coz = r[2 * K + j] - ro.z;
      const float nb = cox * rd.x + coy * rd.y + coz * rd.z;
      const float cq = cox * cox + coy * coy + coz * coz - r[3 * K + j];
      const float d = nb * nb - cq;
      if (nb > t_min && r[3 * K + j] > 0.0f && d > d_best) {
        d_best = d;
        nb_best = nb;
        cand = c * K + j;
      }
    }
  }
  return d_best > -1e8f ? cand : -1;
}

// The chunked form of trace.cuh's shadow_occluder (scaled.ChunkTraversal.
// proximity): over the chunks whose shadow-boundary box the shadow ray
// enters within (t_min, t_l), the largest d of the spheres but the light
// whose closest approach lies inside (t_min, t_l), the first on ties; -1
// where there is none (d_occ = -1e9).
TPT_HD int shadow_occluder(const GradChunkedView& S, V3 pos, V3 l, int light,
                           float t_min, float t_l, float& d_occ) {
  int j = -1;
  d_occ = -1e9f;
  const V3 inv = v3(safe_inv(l.x), safe_inv(l.y), safe_inv(l.z));
  if (any_nan(pos) || any_nan(inv) || is_nan(t_l)) return -1;
  const int K = S.chunk;
  for (int c = 0; c < S.n_chunks; ++c) {
    if (!slab(S.prox_box + 6 * c, pos, inv, t_min, t_l)) continue;
    const float* r = S.chunk_row(c);
    for (int i = 0; i < K; ++i) {
      const float cox = r[i] - pos.x;
      const float coy = r[K + i] - pos.y;
      const float coz = r[2 * K + i] - pos.z;
      const float nb = cox * l.x + coy * l.y + coz * l.z;
      const float cq = cox * cox + coy * coy + coz * coz - r[3 * K + i];
      const float d = nb * nb - cq;
      if (nb > t_min && nb < t_l && c * K + i != light && d > d_occ) {
        d_occ = d;
        j = c * K + i;
      }
    }
  }
  return j;
}

}  // namespace tpt
