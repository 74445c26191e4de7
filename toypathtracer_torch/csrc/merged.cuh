// The merged path loop that the render kernel K1 (csrc/render.cu's
// merged_render_kernel, on the flat scene: csrc/flat.cuh) and the scaled
// render kernel (csrc/scaled.cu's coop_render_kernel, on the chunked scene:
// csrc/coop.cuh) share.
//
// render_tiles_merged runs one loop of iterations in which every lane of a
// warp traces one ray: its pixel's sample's next bounce, or the camera ray
// of the next sample once the last one ended, or of the next pixel of the
// warp's tiles once its pixel is done (the per-lane form of the TPU's
// refilling wavefront, tracecore.render_pixels_fused_merged).  A lane with
// no pixel left stays in the loop with no ray, so all lanes reach each
// traversal together, and NEE's loop over the lights is warp-uniform for
// the same reason.  Each pixel's samples run in order on one RNG state,
// whichever lane takes them, and each ray's arithmetic is render_pixel's:
// the image and the ray count are bit-equal to it.
//
// The view decides how a ray meets the scene: the loop calls
// nearest_hit_warp and nee_warp, which each view's header overloads (found
// by argument-dependent lookup where the loop is instantiated).
//
// The collectives come from a warp policy W (csrc/warp.cuh): DeviceWarp on
// the card, and HostLane or a warp of host threads for the g++ tests.
// Counters (kOn false compiles to nothing) report the work: the kSt* slots
// below.  A counter with kTrips set (TripStats, the stats render kernel
// K2's) makes the loop walk a padded pixel grid and report each pixel's
// samples; kTrips false compiles to the loop without it.  A counter with
// kTape set (csrc/tape.cuh TapeSink or StagedTapeSink, the gradients'
// tape-writing forwards) receives each bounce's carry record: the ray, RNG
// state and attenuation it started from (head), its hit, gate and
// dielectric draw (hit, refl), its emission and whether the path went on
// (tail), and each sample's bounces (sample_depth); after tail every lane
// calls flush with the iteration's busy lanes, where a staging counter
// hands the records to the tape; kTape false compiles to the loop without
// it.

#pragma once

#include "warp.cuh"

namespace tpt {

// Slots of the merged loops' counters.  Per kind of traversal (hit rays
// 0-5, shadow rays 6-11; the chunked view's): warp calls, lanes that took
// part, box steps (chunk or group boxes the warp tested), lane slab tests,
// sphere-loop trips the warp ran, and the sphere tests its lanes needed
// (each ray: all K spheres of each chunk it entered, or up to the first
// occluder).  Then the path loop's iterations and the lanes with a ray in
// them, the SM clock cycles each warp spent in the whole loop, in the hit
// traversals, in NEE and, within NEE, in the shadow traversals, and the
// shadow rays that their own chunk occluded (the chunked view only).  A
// ray's tests are counted in the order its form visits chunks: for hit
// rays, and for the per-lane scaled form's shadow rays, that is the
// sequential scan's count.
enum {
  kStCalls = 0, kStLanes, kStBoxes, kStSlabs, kStTrips, kStNeed,
  kStKind = 6,
  kStLoopIters = 2 * kStKind, kStLoopBusy,
  kStCycLoop, kStCycHit, kStCycNee, kStCycShadow, kStOwnBlocked, kStSlots
};

// The counter the timed kernels pass.
struct NoCoopCount {
  static constexpr bool kOn = false;
  static constexpr bool kTrips = false;
  static constexpr bool kTape = false;
  TPT_HD void add(int, unsigned long long) {}
};

#ifdef __CUDACC__
// The counted instances' counter: the counts are warp-uniform, lane 0
// keeps them.
struct LoopStats {
  static constexpr bool kOn = true;
  static constexpr bool kTrips = false;
  static constexpr bool kTape = false;
  unsigned long long v[kStSlots] = {};
  bool lead;
  __device__ explicit LoopStats(int tid) : lead((tid & 31) == 0) {}
  __device__ void add(int i, unsigned long long x) {
    if (lead) v[i] += x;
  }
};

// Adds each of a thread's kStSlots counters, summed over its warp, to the
// launch's totals.  Every lane of the warp calls it.
__device__ __forceinline__ void flush_loop_stats(
    const unsigned long long* v, unsigned long long* __restrict__ stats,
    int tid) {
  for (int i = 0; i < kStSlots; ++i) {
    unsigned long long x = v[i];
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if ((tid & 31) == 0 && x) atomicAdd(stats + i, x);
  }
}
#endif

TPT_HD void atomic_max_i32(int32_t* p, int32_t v) {
#ifdef __CUDA_ARCH__
  atomicMax(p, v);
#else
  int32_t cur = __atomic_load_n(p, __ATOMIC_RELAXED);
  while (cur < v && !__atomic_compare_exchange_n(p, &cur, v, true,
                                                 __ATOMIC_RELAXED,
                                                 __ATOMIC_RELAXED)) {
  }
#endif
}

TPT_HD void atomic_add_i32(int32_t* p, int32_t v) {
#ifdef __CUDA_ARCH__
  atomicAdd(p, v);
#else
  __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
#endif
}

// The stats render kernel's counter (K2, csrc/render.cu's
// merged_render_kernel<2>): the loop walks the (grid_h, grid_w) padded tile
// grid, and a pixel outside the image is traced for its counts only (no
// image write, no rays).  Per pixel of the grid it writes render_pixel's
// tpt::Trips to trips (3, grid_h, grid_w); per 16x2-pixel warp unit of
// the per-thread kernel's layout (row py / 2, column px / 16, wc columns)
// it adds the image pixels' bounces to work (rows, wc) and keeps each
// sample's deepest image pixel in depth (rows, wc, spp), which the wrapper
// sums over samples into the per-thread kernel's warp_iters.  Both are
// zeroed by the caller and exact whatever the order of the lanes' samples.
// One per lane: it holds the lane's pixel's trips.
struct TripStats {
  static constexpr bool kOn = false;
  static constexpr bool kTrips = true;
  static constexpr bool kTape = false;
  int grid_h, grid_w, wc, spp;
  int32_t* trips;
  int32_t* work;
  int32_t* depth;
  Trips t;
  TPT_HD void add(int, unsigned long long) {}
  TPT_HD int unit(int px, int py) const { return (py / 2) * wc + px / 16; }
  // sample s of pixel (px, py) ended after d bounces, cut by the depth
  // cutoff or not
  TPT_HD void sample(int px, int py, int s, int d, bool cut, bool image) {
    t.sample(d, cut);
    if (image && d > 0) atomic_max_i32(depth + unit(px, py) * spp + s, d);
  }
  // the pixel's samples are done
  TPT_HD void pixel(int px, int py, bool image) {
    const size_t plane = static_cast<size_t>(grid_h) * grid_w;
    const size_t i = static_cast<size_t>(py) * grid_w + px;
    trips[i] = t.bounces;
    trips[plane + i] = t.cutoffs;
    trips[2 * plane + i] = t.last_cutoff;
    if (image && t.bounces) atomic_add_i32(work + unit(px, py), t.bounces);
    t = Trips();
  }
};

// One bounce of a lane's ray when busy (trace.cuh bounce, with vis true and
// the view's warp traversals): every lane calls it; lanes that are not busy
// draw nothing, count nothing and return false.
template <class W, class View, class Cnt>
TPT_WARP bool bounce_merged(const W& w, const View& S, const RenderParams& p,
                            bool busy, V3& ro, V3& rd, uint32_t& st,
                            bool& do_me, uint32_t& rays, V3& e, V3& c,
                            Cnt& cnt) {
  if (busy) ++rays;
  float t;
  long long c0 = 0;
  if constexpr (Cnt::kOn) c0 = w.clock();
  const int id =
      nearest_hit_warp(w, S, busy, ro, rd, p.t_min, p.t_max, t, cnt);
  if constexpr (Cnt::kOn) cnt.add(kStCycHit, w.clock() - c0);
  const bool hit = busy && id >= 0;
  if constexpr (Cnt::kTape) cnt.hit(id, t, !p.light_sampling || do_me);
  c = v3(0.0f, 0.0f, 0.0f);
  if (busy && !hit) e = sky_color(rd, p.mitsuba != 0);
  V3 pos = v3(0.0f, 0.0f, 0.0f), normal = pos, alb = pos, em = pos;
  V3 refl = pos, dir = pos;
  int mt = -1;
  if (hit) {
    pos = add(ro, scale(rd, t));
    V3 cen = v3(S.at(ROW_CX, id), S.at(ROW_CY, id), S.at(ROW_CZ, id));
    normal = scale(sub(pos, cen), S.at(ROW_INVR, id));
    alb = v3(S.at(ROW_ALB, id), S.at(ROW_ALB + 1, id), S.at(ROW_ALB + 2, id));
    em = v3(S.at(ROW_EM, id), S.at(ROW_EM + 1, id), S.at(ROW_EM + 2, id));
    mt = S.mat[id];
    refl = reflect(rd, normal);
    if (mt == MAT_LAMBERT) {
      V3 ruv = unit_vector(st);
      dir = normalize(sub(add(add(pos, normal), ruv), pos));
    }
  }
  V3 light_e = v3(0.0f, 0.0f, 0.0f);
  if constexpr (Cnt::kOn) c0 = w.clock();
  if (p.light_sampling)
    light_e = nee_warp(w, S, p, hit && mt == MAT_LAMBERT, pos, normal, rd,
                       alb, id, st, rays, cnt);
  if constexpr (Cnt::kOn) cnt.add(kStCycNee, w.clock() - c0);
  if (!hit) return false;
  V3 attenuation = alb;
  if (mt == MAT_METAL) {
    float rough = p.mitsuba ? 0.0f : S.at(ROW_ROUGH, id);
    V3 rius = unit_sphere(st);
    dir = normalize(add(refl, scale(rius, rough)));
    if (!(dot(dir, normal) > 0.0f)) {
      e = em;
      return false;
    }
  } else if (mt != MAT_LAMBERT) {
    bool took_refl;
    dir = scatter_dielectric(st, rd, normal, refl, S.at(ROW_RI, id),
                             took_refl);
    if constexpr (Cnt::kTape) cnt.refl(took_refl);
    attenuation = v3(1.0f, 1.0f, 1.0f);
  }
  V3 gated = (!p.light_sampling || do_me) ? em : v3(0.0f, 0.0f, 0.0f);
  if (p.light_sampling) do_me = mt != MAT_LAMBERT;
  e = add(gated, light_e);
  c = attenuation;
  ro = pos;
  rd = dir;
  return true;
}

// The warp's pixels through the merged path loop: render_pixel's image and
// rays, bit for bit, for every pixel of the (p.height, p.width) sub-image
// at (p.x0, p.y0) that this warp takes.  Pixels come in tiles of W::kTileW
// x W::kTileH (row-major over the sub-image); *next_tile counts the tiles
// handed out over the whole launch.  A lane whose pixel is done writes it
// to out (height, width, 3) and takes the next pixel of the warp's tile, or
// of a new tile, so that the warp's lanes stay busy until the tiles run
// out; a lane with no pixel left only takes part in the collectives.
// Returns the rays of this lane's pixels.  With a kTrips counter the tiles
// cover its (grid_h, grid_w) grid instead, and only the image's pixels
// write and count rays.
template <class W, class View, class Cnt>
TPT_WARP unsigned long long render_tiles_merged(const W& w, const View& S,
                                                const float* cam,
                                                const RenderParams& p,
                                                int* next_tile, float* out,
                                                Cnt& cnt) {
  const int TW = W::kTileW;
  const int TP = W::kTileW * W::kTileH;
  int span_h = p.height, span_w = p.width;
  if constexpr (Cnt::kTrips) {
    span_h = cnt.grid_h;
    span_w = cnt.grid_w;
  }
  const int tiles_x = (span_w + TW - 1) / TW;
  const int n_tiles = tiles_x * ((span_h + W::kTileH - 1) / W::kTileH);
  const int lane = w.lane();
  int tile = 0;
  int cursor = TP;  // the next pixel of `tile` to hand out
  unsigned long long total = 0;
  bool has = false;  // this lane holds a pixel
  bool busy = false;
  int px = 0, py = 0, left = 0, depth = 0;
  uint32_t st = 0, rays = 0;
  V3 sum = v3(0.0f, 0.0f, 0.0f);
  V3 ro = sum, rd = sum, col = sum, atten = sum;
  bool do_me = true;
  long long c0 = 0;
  if constexpr (Cnt::kOn) c0 = w.clock();
  for (;;) {
    // lanes without a pixel take the next ones of the warp's tiles; a new
    // tile is taken only when one is needed, so that every warp gets work
    for (;;) {
      const unsigned need = w.ballot(!has);
      if (!need) break;
      if (cursor == TP && tile < n_tiles) {
        tile = w.grab(next_tile);
        cursor = 0;
      }
      if (tile >= n_tiles) break;
      const int avail = TP - cursor;
      const int rank = popc(need & ((1u << lane) - 1u));
      if (!has && rank < avail) {
        const int i = cursor + rank;
        px = (tile % tiles_x) * TW + i % TW;
        py = (tile / tiles_x) * W::kTileH + i / TW;
        if (px < span_w && py < span_h) {  // else: ask again
          has = true;
          st = seed_pixel((uint32_t)(p.x0 + px), (uint32_t)(p.y0 + py),
                          p.frame);
          rays = 0;
          sum = v3(0.0f, 0.0f, 0.0f);
          left = p.spp;
        }
      }
      cursor += popc(need) < avail ? popc(need) : avail;
    }
    if (has && !busy) {  // the pixel's next sample
      sample_ray(cam, p, p.x0 + px, p.y0 + py, st, ro, rd);
      col = v3(0.0f, 0.0f, 0.0f);
      atten = v3(1.0f, 1.0f, 1.0f);
      do_me = true;
      depth = 0;
      busy = true;
      --left;
    }
    const unsigned bm = w.ballot(busy);
    if (!bm) break;
    if constexpr (Cnt::kOn) {
      cnt.add(kStLoopIters, 1);
      cnt.add(kStLoopBusy, popc(bm));
    }
    V3 e, c;
    if constexpr (Cnt::kTape)
      cnt.head(busy, px, py, p.spp - 1 - left, depth, ro, rd, st, atten);
    const bool go =
        bounce_merged(w, S, p, busy, ro, rd, st, do_me, rays, e, c, cnt);
    if constexpr (Cnt::kTape) {
      cnt.tail(busy, go, e);
      cnt.flush(w, bm);
    }
    if (busy) {
      col = add(col, mul(atten, e));
      ++depth;
      if (go && depth < p.max_depth) {
        atten = mul(atten, c);
      } else {
        sum = add(sum, col);
        busy = false;
        if constexpr (Cnt::kTape)
          cnt.sample_depth(px, py, p.spp - 1 - left, depth);
        bool image = true;
        if constexpr (Cnt::kTrips) {
          image = px < p.width && py < p.height;
          cnt.sample(px, py, p.spp - 1 - left, depth, go, image);
        }
        if (left == 0) {  // the pixel is done
          if (image) {
            float* o = out + (static_cast<size_t>(py) * p.width + px) * 3;
            o[0] = sum.x * p.inv_spp;
            o[1] = sum.y * p.inv_spp;
            o[2] = sum.z * p.inv_spp;
            total += rays;
          }
          if constexpr (Cnt::kTrips) cnt.pixel(px, py, image);
          has = false;
        }
      }
    }
  }
  if constexpr (Cnt::kOn) cnt.add(kStCycLoop, w.clock() - c0);
  return total;
}

}  // namespace tpt
