// The warp-cooperative form of the scaled render (csrc/scaled.cu's
// coop_render_kernel): one path loop that keeps a warp's 32 lanes together
// at every traversal, and a chunk traversal that the warp runs as one.
//
// Why.  In the per-lane form (render_pixel<ChunkedView>, chunks.cuh) a
// warp runs a chunk's 256-sphere loop whenever any of its active lanes
// entered that chunk, so it pays for the union of its lanes' chunk sets;
// and a lane whose sample has ended waits at the bounce loop's exit for
// the warp's deepest lane.  Here:
//   1. the merged path loop (csrc/merged.cuh render_tiles_merged): every
//      lane traces one ray an iteration, and a lane whose sample or pixel
//      ended takes the next one, so all lanes reach each traversal
//      together; NEE's loop over the lights is warp-uniform for the same
//      reason.  This header gives the loop its chunked traversals,
//      nearest_hit_warp and nee_warp.
//   2. nearest_hit_warp / coop_occluded walk the chunks once for the warp:
//      for each chunk each participating lane runs the slab test against
//      its own running bound, and a ballot skips the chunk when no lane
//      entered it.  When many lanes entered (kCoopMin or more), each runs
//      its own sequential sphere loop, every lane reading the same sphere
//      (a broadcast).  When few did, the whole warp tests one entering
//      ray at a time, 8 spheres a lane at j = lane + 32 s; the nearest hit
//      is a butterfly reduction over (t, j), least t and then least j,
//      which is exactly the sequential scan's "first sphere of least t"
//      against the best carried from earlier chunks; a shadow ray's answer
//      is a vote, stopped at the first step that holds an occluder.
//   3. NEE's shadow rays are compacted across lights, 32 to a pass, and
//      each is first tested against its own chunk (the hit sphere's),
//      where most occluders lie: an OR over chunks may take them in any
//      order.  The rays that pass are compacted again and walk the rest.
//   4. Boxes over runs of kGroup consecutive Morton chunks: a group box no
//      lane enters skips its children.  Rounding of (b - o) * inv is
//      monotone in b, so a child box's slab interval lies inside its
//      group's, and a child that passes has a group that passes.
// The NEE occlusion kernel K6 (coop_shadow_kernel) runs the same walk on
// its own rays: shadow_chunks_warp below, over a spatial order of the
// chunks and with each light's chunk last.  The chunk-traversal kernel K5
// (coop_hit_kernel) runs hit_chunks_warp below: the chunks in the rows'
// order, but only those of the spatial groups that some lane enters.
// The image and the ray count are bit-equal to the per-lane form: each
// pixel's samples run in order on the same RNG state, whichever lane takes
// it, each ray's arithmetic is the same, and each chunk's slab test sees
// the ray's best as it stood after the chunks before it.
//
// Tensor cores do not serve this test: a matrix-product form of c.d and
// c.o rounds differently from (c - o) first under -fmad=false, which
// would break the bit-equality and the plain version's gates.  Copying each
// entered chunk into a per-warp double buffer in shared memory (cp.async)
// was tried and was slower than reading the rows through L1 (PERF.md).
//
// The collectives come from a warp policy W (csrc/warp.cuh): DeviceWarp
// on the card, and a warp of one lane for the g++ tests, under which this
// code is the sequential scan.  Counters (kOn false compiles to nothing)
// report the work: merged.cuh's kSt* slots.

#pragma once

#include "chunks.cuh"
#include "merged.cuh"

namespace tpt {

// A chunk's entering lanes at or above which each runs its own sphere loop
// (the fastest of 16, 24 and 32 in this kernel's timings on an H100;
// PERF.md).
constexpr int kCoopMin = 24;
// The same threshold for K6's rays (shadow_chunks_warp; the fastest of
// 16, 20, 24, 28 and 32 in its timings on an H100, 28 and 32 alike).
constexpr int kShadowCoopMin = 28;
// The same threshold for K5's rays (hit_chunks_warp): only a chunk that
// every lane entered is run by the lanes' own loops (the fastest of 8, 16,
// 24, 28, 32 and 33 in its timings on an H100, 24-32 within 1%; PERF.md).
constexpr int kHitCoopMin = 32;
// Chunks under one group box.
constexpr int kGroup = 16;

// The scaled scene as the cooperative kernel reads it: ChunkedView plus the
// group boxes (n_groups, 6) and this warp's scratch for NEE (nee_words), in
// shared memory.
struct CoopView : ChunkedView {
  const float* gbox;
  int n_groups;
  float* nee;
};

// The sequential answer of one warp-cooperative combine step: (t, j)
// becomes the lesser of itself and (ot, oj), least t and then least j.
TPT_HD void coop_combine(float& t, int& j, float ot, int oj) {
  if (ot < t || (ot == t && oj < j)) {
    t = ot;
    j = oj;
  }
}

// One lane's share of the few-lane hit test (item 2 above): spheres lane,
// lane + width, ... of a chunk against the entering ray with best tb.  The
// warp then combines the lanes' (bt, bj) with coop_combine; bj = K where a
// lane found no root below tb.
TPT_HD void coop_hit_lane(const float* r, int K, int lane, int width, V3 ro,
                          V3 rd, float t_min, float tb, float& bt, int& bj) {
  bt = tb;
  bj = nearest_in_chunk(r, K, lane, width, ro, rd, t_min, bt);
}

// One lane's share of one step of the few-lane shadow test: sphere
// j = lane + width * s of a chunk (global ids base..), but `light`.
TPT_HD bool coop_occ_lane(const float* r, int K, int base, int lane,
                          int width, int s, V3 pos, V3 l, int light,
                          float t_min, float t_l) {
  const int j = lane + width * s;
  return j < K && sphere_overlaps(r, K, j, pos, l, t_min, t_l) &&
         base + j != light;
}

// The next chunk at or after c that a lane with `part` set enters against
// its own bound t1, skipping every group of kGroup chunks whose box no such
// lane enters; sets m to the entering lanes.  V.n_chunks if none.  Two
// chunk boxes a step: their slab chains are independent and overlap, and
// the second's answer is dropped where the first is entered (the bounds
// may change there).
template <class W, class Cnt>
TPT_WARP int next_chunk(const W& w, const CoopView& V, bool part, V3 o,
                        V3 inv, float t_min, float t1, int c, unsigned& m,
                        Cnt& cnt, int kind) {
  const unsigned pm = w.ballot(part);
  m = 0;
  if (!pm) return V.n_chunks;
  while (c < V.n_chunks) {
    if (c % kGroup == 0) {
      if constexpr (Cnt::kOn) {
        cnt.add(kind + kStBoxes, 1);
        cnt.add(kind + kStSlabs, popc(pm));
      }
      if (!w.any(part && slab(V.gbox + 6 * (c / kGroup), o, inv, t_min,
                              t1))) {
        c += kGroup;
        continue;
      }
    }
    const bool two = c + 1 < V.n_chunks && (c + 1) % kGroup != 0;
    if constexpr (Cnt::kOn) {
      cnt.add(kind + kStBoxes, two ? 2 : 1);
      cnt.add(kind + kStSlabs, popc(pm) * (two ? 2 : 1));
    }
    const bool e1 = part && slab(V.box + 6 * c, o, inv, t_min, t1);
    const bool e2 =
        two && part && slab(V.box + 6 * (c + 1), o, inv, t_min, t1);
    m = w.ballot(e1);
    const unsigned m2 = w.ballot(e2);
    if (m) return c;
    if (m2) {
      m = m2;
      return c + 1;
    }
    c += two ? 2 : 1;
  }
  return V.n_chunks;
}

// Walks the chunks that some lane enters, in order, calling
// visit(c, m, row) with the entering lanes m and the chunk's sphere rows.
// bound() gives a lane's current upper bound and part() whether it still
// takes part; both may change inside visit, and each chunk's test sees them
// as they stand after the chunks before it.
template <class W, class Cnt, class Bound, class Part, class Visit>
TPT_WARP void walk_chunks(const W& w, const CoopView& V, V3 o, V3 inv,
                          float t_min, Bound bound, Part part, Cnt& cnt,
                          int kind, Visit visit) {
  unsigned m;
  for (int c = next_chunk(w, V, part(), o, inv, t_min, bound(), 0, m, cnt,
                          kind);
       c < V.n_chunks; c = next_chunk(w, V, part(), o, inv, t_min, bound(),
                                      c + 1, m, cnt, kind))
    visit(c, m, V.chunk_row(c));
}

// The nearest hit over all chunks of each participating lane's ray, as
// hit_chunks_ray: t (t_max on a miss) and the global id, -1 on a miss.
// Every lane of the warp calls it; lanes with part false get -1.
template <class W, class Cnt>
TPT_WARP int nearest_hit_warp(const W& w, const CoopView& V, bool part,
                              V3 ro, V3 rd, float t_min, float t_max,
                              float& t, Cnt& cnt) {
  t = t_max;
  int id = -1;
  const V3 inv = v3(safe_inv(rd.x), safe_inv(rd.y), safe_inv(rd.z));
  part = part && !any_nan(ro) && !any_nan(inv);
  if constexpr (Cnt::kOn) {
    const unsigned pm = w.ballot(part);
    if (pm) {
      cnt.add(kStCalls, 1);
      cnt.add(kStLanes, popc(pm));
    }
  }
  const int K = V.chunk;
  const int lane = w.lane();
  walk_chunks(
      w, V, ro, inv, t_min, [&] { return t; }, [&] { return part; }, cnt, 0,
      [&](int c, unsigned m, const float* r) {
        const int n = popc(m);
        if constexpr (Cnt::kOn)
          cnt.add(kStNeed, static_cast<unsigned long long>(n) * K);
        if (n >= kCoopMin) {
          if ((m >> lane) & 1u) {
            const int j = nearest_in_chunk(r, K, 0, 1, ro, rd, t_min, t);
            if (j < K) id = c * K + j;
          }
          if constexpr (Cnt::kOn) cnt.add(kStTrips, K);
        } else {
          while (m) {
            const int L = lowest(m);
            m &= m - 1;
            const V3 o =
                v3(w.shfl(ro.x, L), w.shfl(ro.y, L), w.shfl(ro.z, L));
            const V3 d =
                v3(w.shfl(rd.x, L), w.shfl(rd.y, L), w.shfl(rd.z, L));
            float bt;
            int bj;
            coop_hit_lane(r, K, lane, W::kWidth, o, d, t_min, w.shfl(t, L),
                          bt, bj);
            for (int off = W::kWidth / 2; off > 0; off >>= 1)
              coop_combine(bt, bj, w.shfl_xor(bt, off), w.shfl_xor(bj, off));
            if (lane == L && bj < K) {
              t = bt;
              id = c * K + bj;
            }
            if constexpr (Cnt::kOn)
              cnt.add(kStTrips, (K + W::kWidth - 1) / W::kWidth);
          }
        }
      });
  return id;
}

// The whole warp tests lane L's shadow ray against chunk c (sphere rows r),
// two spheres a lane per step (two independent tests and votes), and stops
// at the first step that holds an occluder: returns that sphere's index in
// the chunk, or K.
template <class W, class Cnt>
TPT_WARP int vote_chunk(const W& w, const float* r, int K, int c, int L,
                        V3 pos, V3 l, int light, float t_min, float t_l,
                        Cnt& cnt) {
  const int lane = w.lane();
  const V3 o = v3(w.shfl(pos.x, L), w.shfl(pos.y, L), w.shfl(pos.z, L));
  const V3 d = v3(w.shfl(l.x, L), w.shfl(l.y, L), w.shfl(l.z, L));
  const float tl = w.shfl(t_l, L);
  const int e = w.shfl(light, L);
  int first = K;
  int s = 0;
  for (; s * W::kWidth < K; s += 2) {
    const unsigned h1 = w.ballot(
        coop_occ_lane(r, K, c * K, lane, W::kWidth, s, o, d, e, t_min, tl));
    const unsigned h2 = w.ballot(coop_occ_lane(r, K, c * K, lane, W::kWidth,
                                               s + 1, o, d, e, t_min, tl));
    if (h1 | h2) {
      first = h1 ? s * W::kWidth + lowest(h1)
                 : (s + 1) * W::kWidth + lowest(h2);
      s += 1;
      break;
    }
  }
  if constexpr (Cnt::kOn) {
    cnt.add(kStKind + kStTrips, first < K ? s + 1 : s);
    cnt.add(kStKind + kStNeed, first < K ? first + 1 : K);
  }
  return first;
}

// Does any sphere but `light` overlap (t_min, t_l) along l from pos, for
// each participating lane, as occluded_chunks, leaving out chunk `skip`
// (-1: none), which the caller has tested?  Every lane calls it; a lane
// stops taking part once its ray is occluded.
template <class W, class Cnt>
TPT_WARP bool coop_occluded(const W& w, const CoopView& V, bool part, V3 pos,
                            V3 l, int light, float t_min, float t_l, int skip,
                            Cnt& cnt) {
  const V3 inv = v3(safe_inv(l.x), safe_inv(l.y), safe_inv(l.z));
  part = part && !any_nan(pos) && !any_nan(inv) && !is_nan(t_l);
  if constexpr (Cnt::kOn) {
    const unsigned pm = w.ballot(part);
    if (pm) {
      cnt.add(kStKind + kStCalls, 1);
      cnt.add(kStKind + kStLanes, popc(pm));
    }
  }
  bool occ = false;
  const int K = V.chunk;
  const int lane = w.lane();
  walk_chunks(
      w, V, pos, inv, t_min, [&] { return t_l; },
      [&] { return part && !occ; }, cnt, kStKind,
      [&](int c, unsigned m, const float* r) {
        m &= ~w.ballot(skip == c);
        const int n = popc(m);
        if (n >= kCoopMin) {
          int tests = 0;
          if ((m >> lane) & 1u) {
            const int j = first_overlap_in_chunk(r, K, c * K, pos, l, light,
                                                 t_min, t_l);
            occ = j < K;
            tests = occ ? j + 1 : K;
          }
          if constexpr (Cnt::kOn) {
            cnt.add(kStKind + kStTrips, w.reduce_max(tests));
            cnt.add(kStKind + kStNeed, w.reduce_add(tests));
          }
        } else {
          while (m) {
            const int L = lowest(m);
            m &= m - 1;
            if (vote_chunk(w, r, K, c, L, pos, l, light, t_min, t_l, cnt) <
                    K &&
                lane == L)
              occ = true;
          }
        }
      });
  return occ;
}

// K6's test of chunk c against the entering lanes m (their pairs' rays
// pos + t l, t in (t_min, t_l), the light's sphere `light`, a global id
// and the same for every lane, left out): as coop_occluded's, with the
// overlap test written out in both loops.  Through sphere_overlaps or
// first_overlap_in_chunk, or one helper on the 16-byte record shared by
// the two loops (by value or by reference), K6 ran slower on an H100: the
// helper 3.78 ms against 2.99 (PERF.md).
// Many entering lanes run their own loops over the chunk, reading the same
// sphere (a broadcast); few are decided one at a time by the whole warp,
// two spheres a lane per step.  Sets occ for the lanes that find an
// occluder.
template <int kMin, class W, class Cnt>
TPT_WARP void shadow_chunk_test(const W& w, const CoopView& V,
                                const Sphere4* rec, int c, unsigned m,
                                V3 pos, V3 l, int light, float t_min,
                                float t_l, bool& occ, Cnt& cnt) {
  const int K = V.chunk;
  const int lane = w.lane();
  const int base = c * K;
  const Sphere4* r = rec + base;
  if (popc(m) >= kMin) {
    int tests = 0;
    if ((m >> lane) & 1u) {
      int j = K;
      for (int q = 0; q < K; ++q) {
        const Sphere4 sp = r[q];
        const float cox = sp.x - pos.x;
        const float coy = sp.y - pos.y;
        const float coz = sp.z - pos.z;
        const float cq = cox * cox + coy * coy + coz * coz - sp.r2;
        const float nb = cox * l.x + coy * l.y + coz * l.z;
        const float d = nb * nb - cq;
        const float a = nb - t_min;
        const float b = nb - t_l;
        if (d > 0.0f && d > b * fabsf(b) && d > -(a * fabsf(a)) &&
            base + q != light) {
          j = q;
          break;
        }
      }
      occ = j < K;
      tests = occ ? j + 1 : K;
    }
    if constexpr (Cnt::kOn) {
      cnt.add(kStKind + kStTrips, w.reduce_max(tests));
      cnt.add(kStKind + kStNeed, w.reduce_add(tests));
    }
    return;
  }
  const int WD = W::kWidth;
  while (m) {
    const int L = lowest(m);
    m &= m - 1;
    const V3 o = v3(w.shfl(pos.x, L), w.shfl(pos.y, L), w.shfl(pos.z, L));
    const V3 d = v3(w.shfl(l.x, L), w.shfl(l.y, L), w.shfl(l.z, L));
    const float tl = w.shfl(t_l, L);
    auto hit = [&](int j) {
      if (j >= K) return false;
      const Sphere4 sp = r[j];
      const float cox = sp.x - o.x;
      const float coy = sp.y - o.y;
      const float coz = sp.z - o.z;
      const float cq = cox * cox + coy * coy + coz * coz - sp.r2;
      const float nb = cox * d.x + coy * d.y + coz * d.z;
      const float dd = nb * nb - cq;
      const float a = nb - t_min;
      const float b = nb - tl;
      return dd > 0.0f && dd > b * fabsf(b) && dd > -(a * fabsf(a)) &&
             base + j != light;
    };
    int first = K;
    int s = 0;
    for (; s * WD < K; s += 2) {
      const unsigned h1 = w.ballot(hit(lane + WD * s));
      const unsigned h2 = w.ballot(hit(lane + WD * (s + 1)));
      if (h1 | h2) {
        first = h1 ? s * WD + lowest(h1) : (s + 1) * WD + lowest(h2);
        s += 1;
        break;
      }
    }
    if (first < K && lane == L) occ = true;
    if constexpr (Cnt::kOn) {
      cnt.add(kStKind + kStTrips, first < K ? s + 1 : s);
      cnt.add(kStKind + kStNeed, first < K ? first + 1 : K);
    }
  }
}

// The NEE occlusion bitmask K6 (csrc/scaled.cu's coop_shadow_kernel) for
// the warp: it takes batches of W::kWidth consecutive rays from the
// launch-wide counter *next (zeroed by the caller), a ray a lane, and
// decides each lane's ray against each light in turn; each lane ORs its
// ray's bits and writes them once: bit k of out[i] set when a sphere other
// than light_ids[k] (a global id) overlaps (t_min, t_ls[k]) along light
// k's direction.  ro: (3, n); dirs: (n_lights, 3, n); t_ls: (n_lights, n);
// out: (n,); rec: the spheres' (x, y, z, r^2) records, chunk by chunk.
// Lanes past n take part in every collective with no ray.  A pair's
// chunks are tested (shadow_chunk_test) by coop_occluded's walk
// (walk_chunks) over the chunks in the order `order` (V.box holds their
// boxes in that order, V.gbox the group boxes over it), which
// scaled.chunk_index makes spatial so that the group boxes skip; but the
// light's chunk comes last: the ray ends in the light's sphere, so it
// enters that chunk whenever it gets that far, and a pair occluded before
// never scans it.  The bits are occluded_chunks', since an OR over spheres
// does not depend on the order the chunks are taken in.
template <int kMin, class W, class Cnt>
TPT_WARP void shadow_chunks_warp(const W& w, const CoopView& V,
                                 const int32_t* order, const Sphere4* rec,
                                 const float* ro, const float* dirs,
                                 const float* t_ls, const int32_t* light_ids,
                                 int n_lights, int n, float t_min, int* next,
                                 int32_t* out, Cnt& cnt) {
  const int WD = W::kWidth;
  const int K = V.chunk;
  const int n_batches = (n + WD - 1) / WD;
  for (int b = w.grab(next); b < n_batches; b = w.grab(next)) {
    const int i = b * WD + w.lane();
    const bool valid = i < n;
    V3 pos = v3(0.0f, 0.0f, 0.0f);
    if (valid) pos = v3(ro[i], ro[n + i], ro[2 * n + i]);
    int32_t bits = 0;
    for (int k = 0; k < n_lights; ++k) {
      V3 l = v3(0.0f, 0.0f, 0.0f);
      float t_l = 0.0f;
      if (valid) {
        const float* d = dirs + static_cast<size_t>(3 * k) * n;
        l = v3(d[i], d[n + i], d[2 * n + i]);
        t_l = t_ls[static_cast<size_t>(k) * n + i];
      }
      const int light = light_ids[k];
      const int last = light / K;
      const V3 inv = v3(safe_inv(l.x), safe_inv(l.y), safe_inv(l.z));
      const bool part = valid && !any_nan(pos) && !any_nan(inv) &&
                        !is_nan(t_l);
      if constexpr (Cnt::kOn) {
        const unsigned pm = w.ballot(part);
        if (pm) {
          cnt.add(kStKind + kStCalls, 1);
          cnt.add(kStKind + kStLanes, popc(pm));
        }
      }
      bool occ = false;
      walk_chunks(
          w, V, pos, inv, t_min, [&] { return t_l; },
          [&] { return part && !occ; }, cnt, kStKind,
          [&](int c, unsigned m, const float*) {
            if (order[c] != last)
              shadow_chunk_test<kMin>(w, V, rec, order[c], m, pos, l, light,
                                      t_min, t_l, occ, cnt);
          });
      // the light's chunk
      const bool go = part && !occ;
      if constexpr (Cnt::kOn) {
        const unsigned gm = w.ballot(go);
        if (gm) {
          cnt.add(kStKind + kStBoxes, 1);
          cnt.add(kStKind + kStSlabs, popc(gm));
        }
      }
      const unsigned m = w.ballot(
          go && slab(V.chunk_row(last) + 4 * K, pos, inv, t_min, t_l));
      if (m)
        shadow_chunk_test<kMin>(w, V, rec, last, m, pos, l, light, t_min,
                                t_l, occ, cnt);
      if (occ) bits |= 1 << k;
    }
    if (valid) out[i] = bits;
  }
}

// Spheres j = j0, j0 + step, ... of a chunk's 16-byte records r (K of them)
// for one ray, as nearest_in_chunk: lowers t to the nearest root below it
// (strict `<`) and returns that sphere's index, or K if none is below it.
// sphere_root's arithmetic, operation for operation, with the root taken
// only where discr > 0: elsewhere sphere_root's answer is false whatever
// the root, so the result is the same and a warp whose lanes all miss a
// sphere skips the square root.
TPT_HD int nearest_in_records(const Sphere4* r, int K, int j0, int step,
                              V3 ro, V3 rd, float t_min, float& t) {
  int jw = K;
  for (int j = j0; j < K; j += step) {
    const Sphere4 sp = r[j];
    const float cox = sp.x - ro.x;
    const float coy = sp.y - ro.y;
    const float coz = sp.z - ro.z;
    const float nb = cox * rd.x + coy * rd.y + coz * rd.z;
    const float cq = cox * cox + coy * coy + coz * coz - sp.r2;
    const float discr = nb * nb - cq;
    if (discr > 0.0f) {
      const float ds = sqrtf(discr);
      const float r0 = nb - ds;
      const float tt = r0 > t_min ? r0 : nb + ds;
      if (tt > t_min && tt < t) {
        t = tt;
        jw = j;
      }
    }
  }
  return jw;
}

// K5's counters: the prefilter's group boxes go to the shadow kind's box
// slots (K5 traces no shadow rays), the chunk walk to the hit kind's.
constexpr int kStGroupBoxes = kStKind + kStBoxes;
constexpr int kStGroupSlabs = kStKind + kStSlabs;

// Words of K5's chunk mask for n_chunks chunks (hit_chunks_warp's `mask`).
TPT_HD int chunk_words(int n_chunks) { return (n_chunks + 31) / 32; }

// K5's exact prefilter for the warp: sets `mask` (chunk_words(V.n_chunks)
// words, this warp's scratch) to the chunks of every group of kGroup
// consecutive chunks of `order` (V.gbox holds their boxes) whose box some
// lane with `part` set enters at its initial bound (t_min, t_max).  A chunk
// left out fails its own slab test at every t1 <= t_max, for every lane:
// its group's box holds its box, so its slab interval lies inside its
// group's (item 4 above), and a slab test passes for t1 if it passes for a
// smaller one.  Every lane calls it.
template <class W, class Cnt>
TPT_WARP void hit_prefilter(const W& w, const CoopView& V,
                            const int32_t* order, bool part, V3 o, V3 inv,
                            float t_min, float t_max, unsigned* mask,
                            Cnt& cnt) {
  const int WD = W::kWidth;
  const int words = chunk_words(V.n_chunks);
  for (int q = w.lane(); q < words; q += WD) mask[q] = 0u;
  w.sync();
  if constexpr (Cnt::kOn) {
    const unsigned pm = w.ballot(part);
    if (pm) {
      cnt.add(kStGroupBoxes, V.n_groups);
      cnt.add(kStGroupSlabs,
              static_cast<unsigned long long>(popc(pm)) * V.n_groups);
    }
  }
  for (int g = 0; g < V.n_groups; ++g) {
    if (!w.any(part && slab(V.gbox + 6 * g, o, inv, t_min, t_max))) continue;
    const int end = (g + 1) * kGroup < V.n_chunks ? (g + 1) * kGroup
                                                  : V.n_chunks;
    for (int q = g * kGroup + w.lane(); q < end; q += WD) {
      const int c = order[q];
      w.or_mask(mask + c / 32, 1u << (c % 32));
    }
  }
  w.sync();
}

// K5's test of chunk c (records r) against its entering lanes m, each with
// its own ray (o, d) and best (t, id): as hit_chunks_ray's scan of the
// chunk.  kMin or more entering lanes run their own loops over the chunk,
// reading the same sphere (a broadcast); fewer are decided one at a time
// by the whole warp, spheres lane, lane + 32, ... a lane, and the
// butterfly over (t, j), least t and then least j, that nearest_hit_warp
// uses.
template <int kMin, class W, class Cnt>
TPT_WARP void hit_chunk_test(const W& w, const Sphere4* r, int K, int c,
                             unsigned m, V3 o, V3 d, float t_min, float& t,
                             int& id, Cnt& cnt) {
  const int lane = w.lane();
  const int n = popc(m);
  if constexpr (Cnt::kOn)
    cnt.add(kStNeed, static_cast<unsigned long long>(n) * K);
  if (n >= kMin) {
    if ((m >> lane) & 1u) {
      const int j = nearest_in_records(r, K, 0, 1, o, d, t_min, t);
      if (j < K) id = c * K + j;
    }
    if constexpr (Cnt::kOn) cnt.add(kStTrips, K);
    return;
  }
  while (m) {
    const int L = lowest(m);
    m &= m - 1;
    const V3 oL = v3(w.shfl(o.x, L), w.shfl(o.y, L), w.shfl(o.z, L));
    const V3 dL = v3(w.shfl(d.x, L), w.shfl(d.y, L), w.shfl(d.z, L));
    float bt = w.shfl(t, L);
    int bj = nearest_in_records(r, K, lane, W::kWidth, oL, dL, t_min, bt);
    for (int off = W::kWidth / 2; off > 0; off >>= 1)
      coop_combine(bt, bj, w.shfl_xor(bt, off), w.shfl_xor(bj, off));
    if (lane == L && bj < K) {
      t = bt;
      id = c * K + bj;
    }
    if constexpr (Cnt::kOn)
      cnt.add(kStTrips, (K + W::kWidth - 1) / W::kWidth);
  }
}

// The chunk-traversal kernel K5 (csrc/scaled.cu's coop_hit_kernel) for the
// warp: it takes batches of W::kWidth consecutive rays from the
// launch-wide counter *next (zeroed by the caller), a ray a lane, and
// writes each ray's nearest hit as hit_chunks_ray does: out_t (t_max on a
// miss) and out_id (the global id, -1 on a miss).  ro, rd: (3, n) planes;
// rec: the spheres' (x, y, z, r^2) records, chunk by chunk; V.box: the
// chunk boxes in the rows' order; V.gbox: the group boxes over `order`
// (scaled.chunk_index's spatial order); mask: this warp's
// chunk_words(V.n_chunks) words of scratch.  Lanes past n take part in
// every collective with no ray.
// The prefilter (hit_prefilter) keeps the chunks of the spatial groups
// that some lane enters; the warp then walks the kept chunks in ascending
// index, the rows' order, each lane slab-testing each against its own
// running best and a ballot skipping the chunk where no lane entered it.
// So every lane tests the chunks that hit_chunks_ray enters, in the same
// order, against the same running t, with the same arithmetic: the ids and
// t are hit_chunks_ray's, ties and grazing roots included.  (A walk in the
// spatial order with a (t, id) combine would not be: a sphere's computed
// root can lie below its box's computed entry where nb^2 - cq cancels, and
// a running t from a later chunk would then cut a chunk whose hit
// hit_chunks_ray finds.)
template <int kMin, class W, class Cnt>
TPT_WARP void hit_chunks_warp(const W& w, const CoopView& V,
                              const int32_t* order, const Sphere4* rec,
                              unsigned* mask, const float* ro,
                              const float* rd, int n, float t_min,
                              float t_max, int* next, float* out_t,
                              int32_t* out_id, Cnt& cnt) {
  const int WD = W::kWidth;
  const int K = V.chunk;
  const int words = chunk_words(V.n_chunks);
  const int n_batches = (n + WD - 1) / WD;
  for (int b = w.grab(next); b < n_batches; b = w.grab(next)) {
    const int i = b * WD + w.lane();
    const bool valid = i < n;
    V3 o = v3(0.0f, 0.0f, 0.0f), d = v3(0.0f, 0.0f, 0.0f);
    if (valid) {
      o = v3(ro[i], ro[n + i], ro[2 * n + i]);
      d = v3(rd[i], rd[n + i], rd[2 * n + i]);
    }
    const V3 inv = v3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
    const bool part = valid && !any_nan(o) && !any_nan(inv);
    if constexpr (Cnt::kOn) {
      const unsigned pm = w.ballot(part);
      if (pm) {
        cnt.add(kStCalls, 1);
        cnt.add(kStLanes, popc(pm));
      }
    }
    float t = t_max;
    int id = -1;
    hit_prefilter(w, V, order, part, o, inv, t_min, t_max, mask, cnt);
    for (int q = 0; q < words; ++q) {
      for (unsigned bits = mask[q]; bits; bits &= bits - 1) {
        const int c = 32 * q + lowest(bits);
        if constexpr (Cnt::kOn) {
          const unsigned pm = w.ballot(part);
          if (pm) {
            cnt.add(kStBoxes, 1);
            cnt.add(kStSlabs, popc(pm));
          }
        }
        const unsigned m =
            w.ballot(part && slab(V.box + 6 * c, o, inv, t_min, t));
        if (m) hit_chunk_test<kMin>(w, rec + c * K, K, c, m, o, d, t_min, t,
                                    id, cnt);
      }
    }
    if (valid) {
      out_t[i] = t;
      out_id[i] = id;
    }
    // every lane has read the mask before the next batch clears it
    w.sync();
  }
}

// Lights whose shadow rays one pass of nee_warp holds: the scaled scene's
// 8 beacons and any scene up to kMaxLights take one pass (CoopView), more
// lights take passes of kCoopNeeGroup in light order (CoopViewLights).
constexpr int kCoopNeeGroup = 16;

// The lights of one pass of nee_warp for a scene of n_lights lights.
TPT_HD int nee_group(int n_lights) {
  return n_lights < kCoopNeeGroup ? n_lights : kCoopNeeGroup;
}

// Words of per-warp scratch one pass of nee_warp keeps for g lights
// (nee_group) and a warp of `width` lanes: each (light, lane) pair's
// direction, t_l and cone cosine, the queue of candidate pairs, and per
// light the occluded lanes.
TPT_HD int nee_words(int g, int width) {
  return g * (6 * width + 1);
}

// One pass of nee_warp past kCoopNeeGroup lights: the lights k0 .. k0 +
// G - 1 (G the pass's size, kCoopNeeGroup or fewer), their contributions
// added to light_e in light order; `word` carries a kTape counter's seen
// lights of the current 32 from pass to pass.
template <class W, class Cnt>
TPT_WARP V3 nee_pass(const W& w, const CoopView& S, const RenderParams& p,
                     bool lambert, V3 pos, V3 normal, V3 rd, V3 alb,
                     int hit_id, uint32_t& st, uint32_t& rays, Cnt& cnt,
                     int k0, int G, V3 light_e, uint32_t& word) {
  const int n_l = S.n_lights;
  const int WD = W::kWidth;
  const int lane = w.lane();
  float* lx = S.nee;
  float* ly = lx + G * WD;
  float* lz = ly + G * WD;
  float* tl = lz + G * WD;
  float* cm = tl + G * WD;
  int* queue = reinterpret_cast<int*>(cm + G * WD);
  unsigned* occ = reinterpret_cast<unsigned*>(queue + G * WD);
  const int g = n_l - k0 < G ? n_l - k0 : G;
  // the lanes' shadow rays, light by light (the draws of nee); occ[j]
  // starts as the lanes without a candidate for light k0 + j
  int n_q = 0;
  for (int j = 0; j < g; ++j) {
    const int e = S.lights[k0 + j];
    bool cand = false;
    if (lambert && e != hit_id) {  // self-skip (hlsl:204)
      float eps1 = rand01(st);
      float eps2 = rand01(st);
      ++rays;
      Cone q = cone(S, e, pos, eps1, eps2);
      float t_l;
      cand = sphere_t(S, e, pos, q.l, p.t_min, t_l) && t_l < p.t_max;
      const int i = j * WD + lane;
      lx[i] = q.l.x;
      ly[i] = q.l.y;
      lz[i] = q.l.z;
      tl[i] = t_l;
      cm[i] = q.cos_a_max;
    }
    const unsigned m = w.ballot(cand);
    if (cand) queue[n_q + popc(m & ((1u << lane) - 1u))] = j * WD + lane;
    if (lane == 0) occ[j] = ~m;
    n_q += popc(m);
  }
  w.sync();
  // the candidates' shadow tests, a warp's width at a time.  First each
  // one's own chunk (its hit sphere's) where its box passes: most occluders
  // lie next to the ray's origin, and an OR over chunks may take them in any
  // order.  The rays that it leaves are compacted in the queue, then walk
  // the other chunks.
  long long c0 = 0;
  if constexpr (Cnt::kOn) c0 = w.clock();
  const int K = S.chunk;
  struct Ray {
    bool valid;
    int code, k, owner, own;
    V3 o, l;
    float t_l;
  };
  // this lane's candidate of queue[i], for i < n
  auto ray = [&](int i, int n) {
    Ray r;
    r.valid = i < n;
    r.code = r.valid ? queue[i] : lane;
    r.k = r.code / WD;
    r.owner = r.code % WD;
    r.o = v3(w.shfl(pos.x, r.owner), w.shfl(pos.y, r.owner),
             w.shfl(pos.z, r.owner));
    r.own = w.shfl(hit_id, r.owner) / K;
    r.l = r.valid ? v3(lx[r.code], ly[r.code], lz[r.code])
                  : v3(0.0f, 0.0f, 0.0f);
    r.t_l = r.valid ? tl[r.code] : 0.0f;
    return r;
  };
  int n_s = 0;
  for (int b = 0; b < n_q; b += WD) {
    const Ray r = ray(b + lane, n_q);
    const int light = S.lights[k0 + r.k];
    const V3 inv = v3(safe_inv(r.l.x), safe_inv(r.l.y), safe_inv(r.l.z));
    const bool part = r.valid && !any_nan(r.o) && !any_nan(inv) &&
                      !is_nan(r.t_l);
    unsigned m =
        w.ballot(part && slab(S.box + 6 * r.own, r.o, inv, p.t_min, r.t_l));
    if constexpr (Cnt::kOn) {
      cnt.add(kStKind + kStBoxes, 1);
      cnt.add(kStKind + kStSlabs, popc(w.ballot(part)));
    }
    bool blocked = false;
    while (m) {
      const int L = lowest(m);
      m &= m - 1;
      const int c = w.shfl(r.own, L);
      if (vote_chunk(w, S.chunk_row(c), K, c, L, r.o, r.l, light, p.t_min,
                     r.t_l, cnt) < K &&
          lane == L)
        blocked = true;
    }
    if (blocked) w.or_mask(occ + r.k, 1u << r.owner);
    const unsigned left = w.ballot(r.valid && !blocked);
    if constexpr (Cnt::kOn) cnt.add(kStOwnBlocked, popc(w.ballot(blocked)));
    w.sync();
    if (r.valid && !blocked)
      queue[n_s + popc(left & ((1u << lane) - 1u))] = r.code;
    n_s += popc(left);
  }
  w.sync();
  for (int b = 0; b < n_s; b += WD) {
    const Ray r = ray(b + lane, n_s);
    if (coop_occluded(w, S, r.valid, r.o, r.l, S.lights[k0 + r.k], p.t_min,
                      r.t_l, r.own, cnt))
      w.or_mask(occ + r.k, 1u << r.owner);
  }
  if constexpr (Cnt::kOn) cnt.add(kStCycShadow, w.clock() - c0);
  w.sync();
  // the visible lights' contributions, in light order
  const V3 nl = dot(normal, rd) < 0.0f ? normal : neg(normal);
  for (int j = 0; j < g; ++j) {
    const int k = k0 + j;
    const bool seen = !((occ[j] >> lane) & 1u);
    if constexpr (Cnt::kTape) {
      if (seen) word |= 1u << (k & 31);
      if ((k & 31) == 31 || k == n_l - 1) {
        if (lambert) cnt.see_word(k >> 5, word);
        word = 0;
      }
    }
    if (!seen) continue;
    const int e = S.lights[k];
    const int i = j * WD + lane;
    const V3 l = v3(lx[i], ly[i], lz[i]);
    float omega = TPT_TWO_PI * (1.0f - cm[i]);
    float fac = max0(dot(l, nl)) * omega / TPT_PI;
    V3 em = v3(S.at(ROW_EM, e), S.at(ROW_EM + 1, e), S.at(ROW_EM + 2, e));
    light_e = v3(light_e.x + (alb.x * em.x) * fac,
                 light_e.y + (alb.y * em.y) * fac,
                 light_e.z + (alb.z * em.z) * fac);
  }
  w.sync();
  return light_e;
}

// The cooperative view of a scene with more than kCoopNeeGroup lights:
// nee_warp takes its lights in passes (csrc/scaled.cu's lights instances).
struct CoopViewLights : CoopView {};

// NEE (trace.cuh nee) for the warp.  Each lane that hit a Lambert sphere
// draws, counts and builds its shadow rays light by light exactly as nee
// does; the warp then tests the candidates 32 at a time, (light, lane)
// pairs in light-major order from a queue in S.nee, so that each shadow
// traversal runs with the warp full and not with the lanes that one light
// leaves (an OR over chunks does not depend on which rays share a pass);
// last each lane adds its visible lights in light order.  A CoopView holds
// at most kCoopNeeGroup lights, which take one pass; a CoopViewLights any
// number, in passes (nee_pass).  A counter with kTape set (the
// tape-writing instance of csrc/scaled.cu) receives each Lambert lane's
// seen lights (see_word).
template <class W, class Cnt>
TPT_WARP V3 nee_warp(const W& w, const CoopView& S, const RenderParams& p,
                       bool lambert, V3 pos, V3 normal, V3 rd, V3 alb,
                       int hit_id, uint32_t& st, uint32_t& rays, Cnt& cnt) {
  const int n_l = S.n_lights;
  const int WD = W::kWidth;
  const int lane = w.lane();
  float* lx = S.nee;
  float* ly = lx + n_l * WD;
  float* lz = ly + n_l * WD;
  float* tl = lz + n_l * WD;
  float* cm = tl + n_l * WD;
  int* queue = reinterpret_cast<int*>(cm + n_l * WD);
  unsigned* occ = reinterpret_cast<unsigned*>(queue + n_l * WD);
  // the lanes' shadow rays, light by light (the draws of nee)
  unsigned cands = 0;
  int n_q = 0;
  for (int k = 0; k < n_l; ++k) {
    const int e = S.lights[k];
    bool cand = false;
    if (lambert && e != hit_id) {  // self-skip (hlsl:204)
      float eps1 = rand01(st);
      float eps2 = rand01(st);
      ++rays;
      Cone q = cone(S, e, pos, eps1, eps2);
      float t_l;
      cand = sphere_t(S, e, pos, q.l, p.t_min, t_l) && t_l < p.t_max;
      const int i = k * WD + lane;
      lx[i] = q.l.x;
      ly[i] = q.l.y;
      lz[i] = q.l.z;
      tl[i] = t_l;
      cm[i] = q.cos_a_max;
    }
    const unsigned m = w.ballot(cand);
    if (cand) {
      cands |= 1u << k;
      queue[n_q + popc(m & ((1u << lane) - 1u))] = k * WD + lane;
    }
    if (lane == 0) occ[k] = 0;
    n_q += popc(m);
  }
  w.sync();
  // the candidates' shadow tests, a warp's width at a time.  First each
  // one's own chunk (its hit sphere's) where its box passes: most occluders
  // lie next to the ray's origin, and an OR over chunks may take them in any
  // order.  The rays that it leaves are compacted in the queue, then walk
  // the other chunks.
  long long c0 = 0;
  if constexpr (Cnt::kOn) c0 = w.clock();
  const int K = S.chunk;
  struct Ray {
    bool valid;
    int code, k, owner, own;
    V3 o, l;
    float t_l;
  };
  // this lane's candidate of queue[i], for i < n
  auto ray = [&](int i, int n) {
    Ray r;
    r.valid = i < n;
    r.code = r.valid ? queue[i] : lane;
    r.k = r.code / WD;
    r.owner = r.code % WD;
    r.o = v3(w.shfl(pos.x, r.owner), w.shfl(pos.y, r.owner),
             w.shfl(pos.z, r.owner));
    r.own = w.shfl(hit_id, r.owner) / K;
    r.l = r.valid ? v3(lx[r.code], ly[r.code], lz[r.code])
                  : v3(0.0f, 0.0f, 0.0f);
    r.t_l = r.valid ? tl[r.code] : 0.0f;
    return r;
  };
  int n_s = 0;
  for (int b = 0; b < n_q; b += WD) {
    const Ray r = ray(b + lane, n_q);
    const V3 inv = v3(safe_inv(r.l.x), safe_inv(r.l.y), safe_inv(r.l.z));
    const bool part = r.valid && !any_nan(r.o) && !any_nan(inv) &&
                      !is_nan(r.t_l);
    unsigned m =
        w.ballot(part && slab(S.box + 6 * r.own, r.o, inv, p.t_min, r.t_l));
    if constexpr (Cnt::kOn) {
      cnt.add(kStKind + kStBoxes, 1);
      cnt.add(kStKind + kStSlabs, popc(w.ballot(part)));
    }
    bool blocked = false;
    while (m) {
      const int L = lowest(m);
      m &= m - 1;
      const int c = w.shfl(r.own, L);
      if (vote_chunk(w, S.chunk_row(c), K, c, L, r.o, r.l, S.lights[r.k],
                     p.t_min, r.t_l, cnt) < K &&
          lane == L)
        blocked = true;
    }
    if (blocked) w.or_mask(occ + r.k, 1u << r.owner);
    const unsigned left = w.ballot(r.valid && !blocked);
    if constexpr (Cnt::kOn) cnt.add(kStOwnBlocked, popc(w.ballot(blocked)));
    w.sync();
    if (r.valid && !blocked)
      queue[n_s + popc(left & ((1u << lane) - 1u))] = r.code;
    n_s += popc(left);
  }
  w.sync();
  for (int b = 0; b < n_s; b += WD) {
    const Ray r = ray(b + lane, n_s);
    if (coop_occluded(w, S, r.valid, r.o, r.l, S.lights[r.k], p.t_min, r.t_l,
                      r.own, cnt))
      w.or_mask(occ + r.k, 1u << r.owner);
  }
  if constexpr (Cnt::kOn) cnt.add(kStCycShadow, w.clock() - c0);
  w.sync();
  // the visible lights' contributions, in light order
  V3 light_e = v3(0.0f, 0.0f, 0.0f);
  V3 nl = dot(normal, rd) < 0.0f ? normal : neg(normal);
  uint32_t seen = 0;  // kTape
  for (int k = 0; k < n_l; ++k) {
    if (!((cands >> k) & 1u) || ((occ[k] >> lane) & 1u)) continue;
    if constexpr (Cnt::kTape) seen |= 1u << k;
    const int e = S.lights[k];
    const int i = k * WD + lane;
    const V3 l = v3(lx[i], ly[i], lz[i]);
    float omega = TPT_TWO_PI * (1.0f - cm[i]);
    float fac = max0(dot(l, nl)) * omega / TPT_PI;
    V3 em = v3(S.at(ROW_EM, e), S.at(ROW_EM + 1, e), S.at(ROW_EM + 2, e));
    light_e = v3(light_e.x + (alb.x * em.x) * fac,
                 light_e.y + (alb.y * em.y) * fac,
                 light_e.z + (alb.z * em.z) * fac);
  }
  if constexpr (Cnt::kTape) {
    if (lambert && n_l > 0) cnt.see_word(0, seen);
  }
  w.sync();
  return light_e;
}

// nee_warp past kCoopNeeGroup lights: passes of kCoopNeeGroup (nee_pass),
// each drawn, tested and added in light order, so that the draws, the rays
// and the sum are nee's.
template <class W, class Cnt>
TPT_WARP V3 nee_warp(const W& w, const CoopViewLights& S,
                       const RenderParams& p, bool lambert, V3 pos,
                       V3 normal, V3 rd, V3 alb, int hit_id, uint32_t& st,
                       uint32_t& rays, Cnt& cnt) {
  const int n_l = S.n_lights;
  const int G = nee_group(n_l);
  uint32_t word = 0;  // kTape: the seen lights of the current 32
  V3 light_e = v3(0.0f, 0.0f, 0.0f);
  for (int k0 = 0; k0 < n_l; k0 += G)
    light_e = nee_pass(w, S, p, lambert, pos, normal, rd, alb, hit_id, st,
                       rays, cnt, k0, G, light_e, word);
  return light_e;
}

}  // namespace tpt
