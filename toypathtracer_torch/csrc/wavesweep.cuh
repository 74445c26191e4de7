// The differentiable wavefront's sweep redesigned for Hopper (csrc/
// wavesweep.cu wave_run_kernel, the main path's sweep under
// RenderConfig.diff_wavefront), beside the sweep it replaced: coopgrad.cuh
// sweep_tiles, K3's reverse half, which csrc/wavegrad.cu wave_sweep_kernel
// keeps as the baseline.
//
// sweep_tiles keeps K3's schedule so that its cotangent is K3's bit for bit:
// 8x4 tiles dealt round robin over one wave of warps, each batch of a tile's
// samples swept as a queue that drains before the next batch starts, on K3's
// launch bounds (40 registers and 776 B of spill stores for sm_90a), with
// bounce_adj_warp's grouped adds: a group tree for each of a bounce's six
// batches of adds.  Counted through sweep_runs on its deal (below), most
// of its threads' cycles go to the adjoint and 77% of its lane steps are
// busy (PERF.md).
// sweep_runs sweeps the same FrameTape with:
//   1. a queue over a block's share of tiles (SortedQueue): the share's
//      samples from the most bounces to the fewest (depth_order), dealt
//      round robin to the block's warps, so that each warp's last samples
//      are its shortest and the warps' work comes out nearly equal; a lane
//      whose sample ends takes its warp's next one, whichever tile it lies
//      in;
//   2. the next step's inputs fetched during this step: a lane on its
//      sample's last bounce claims its next sample before the adjoint runs
//      (the same claims, in the same order, as claims made after it), and
//      each lane's next record and first seen-lights word are copied from
//      the tape into the warp's shared slots (cp.async) while the adjoint
//      runs;
//   3. cheaper adds (bounce_adj_fused): a bounce's adds to the hit sphere
//      summed in the lane and grouped once, and each light's summed over
//      the warp by a butterfly;
//   4. a grid and launch bounds of its own (wavesweep.cu): 128 registers,
//      many short blocks that the card starts as earlier ones end.
// On sweep_tiles' deal (a TileQueue) with bounce_adj_warp its adds come in
// sweep_tiles' order and the cotangent is sweep_tiles' bit for bit: the
// stats instances count the kept schedule's parts that way.
//
// Determinism: which warp takes which samples follows from its index and
// the bounce counts, which lane takes which sample from the bounce counts
// alone, the adds are grouped in a fixed order into the warp's table, and
// the blocks' rows are summed in a fixed order: two launches on the same
// inputs are bit-equal.  Written against a warp policy (csrc/warp.cuh), so
// the g++ tests run it under HostLane and in 32-thread ThreadWarps.

#pragma once

#include <string.h>

#include <type_traits>

#include "gradwarp.cuh"
#include "tape.cuh"

namespace tpt {

// The sweeps' stats counters past K3's (trace.cuh kGc*): SM cycles in the
// tape reads (waiting for and reading the fetched records, issuing the
// next fetch), in the queue's claims (with the bounce-count window), in
// the adjoint of the bounces
// (bounce_adj_warp or bounce_adj_fused with its grouped adds; within it
// kGcCycGroup, the hit's grouping), and waiting at the block's end for its
// other warps.  kGcCycAdj is the whole sweep loop.
enum {
  kWcCycTape = kGcSlots, kWcCycQueue, kWcCycBounce, kWcCycWait, kWcSlots
};

// A record's seen lights: its first word held (fetched with the record),
// the others read where they lie.  `see >> k` as LightBits gives it.
struct SeeWords {
  uint32_t w0;
  const uint32_t* w;
};

TPT_HD uint32_t operator>>(const SeeWords& s, int k) {
  return k < 32 ? s.w0 >> k : s.w[k >> 5] >> (k & 31);
}

// Asynchronous copies from the tape into a warp's shared slots (cp.async on
// the card; a plain copy on the host).  wait_copies waits for this thread's.
TPT_HD void copy16_async(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
#else
  memcpy(dst, src, 16);
#endif
}

TPT_HD void copy4_async(uint32_t* dst, const uint32_t* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
#else
  *dst = *src;
#endif
}

TPT_HD void commit_copies() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

TPT_HD void wait_copies() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// The adds `a` of the lanes that pass `on` to one key (the same for every
// such lane), summed over the warp by a butterfly (the others adding 0) and
// added by lane 0 to the table T: for a key every lane shares, the
// grouping's tree and its rank walk are not needed.  Every lane calls it.
template <class W, int N, class Tab>
TPT_WARP void warp_sum_add(const W& w, Tab T, int n, int key, bool on,
                           Adds<N> a) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (!on) a.v[i] = 0.0f;
  for (int off = W::kWidth / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) a.v[i] += w.shfl_xor(a.v[i], off);
  }
  w.sync();
  if constexpr (std::is_pointer<Tab>::value) {
    if (w.lane() == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) T[a.row[i] * n + key] += a.v[i];
    }
  } else {
    T.add(w, w.lane() == 0, key, a);
  }
}

// gradwarp.cuh nee_adj_warp<false> (hard selects) with cheaper adds: a
// light's albedo cotangent for the hit sphere summed in the lane into
// g_alb (bounce_adj_fused adds it with the hit's other adds), and the
// light's own adds summed by warp_sum_add.  The same arithmetic; the sums
// associate differently.  Every lane calls it.
template <class W, class View, class Tab, class See>
TPT_WARP void nee_adj_fused(const W& w, const View& S, const RenderParams& p,
                            bool lam, V3 pos, V3 normal, V3 rd, V3 alb,
                            int hit_id, uint32_t st, See see, V3 g_le, Tab T,
                            V3& g_pos, V3& g_n, V3& g_alb) {
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  if (!w.any(lam)) return;  // every add would be 0
  const bool front = dot(normal, rd) < 0.0f;
  const V3 nl = front ? normal : neg(normal);
  V3 g_nl = zero;
  for (int k = 0; k < S.n_lights; ++k) {
    const int e = S.lights[k];
    const bool on = lam && e != hit_id;
    float eps1 = 0.0f, eps2 = 0.0f;
    if (on) {
      eps1 = rand01(st);
      eps2 = rand01(st);
    }
    const bool at = on && ((see >> k) & 1u);
    if (!w.any(at)) continue;  // every add of this light would be 0
    V3 g_em = zero, g_sc = zero;
    float g_r = 0.0f;
    if (at) {
      Cone q = cone(S, e, pos, eps1, eps2);
      float omega = TPT_TWO_PI * (1.0f - q.cos_a_max);
      float dl = dot(q.l, nl);
      float fac = max0(dl) * omega / TPT_PI;
      V3 em = v3(S.at(ROW_EM, e), S.at(ROW_EM + 1, e), S.at(ROW_EM + 2, e));
      g_alb = add(g_alb, mul(g_le, scale(em, fac)));
      g_em = mul(g_le, scale(alb, fac));
      if (dl > 0.0f) {
        float g_fac = dot(g_le, mul(alb, em));
        float g_dl = g_fac * omega / TPT_PI;
        float g_cam = -TPT_TWO_PI * (g_fac * dl / TPT_PI);
        g_nl = add(g_nl, scale(q.l, g_dl));
        cone_adj_vals(q, eps1, scale(nl, g_dl), g_cam, g_pos, g_r, g_sc);
      }
    }
    warp_sum_add(w, T, S.n, e, at,
                 Adds<7>{{ROW_EM, ROW_EM + 1, ROW_EM + 2, ROW_R, ROW_CX,
                          ROW_CY, ROW_CZ},
                         {g_em.x, g_em.y, g_em.z, g_r, g_sc.x, g_sc.y,
                          g_sc.z}});
  }
  if (lam) g_n = add(g_n, front ? g_nl : neg(g_nl));
}

// gradwarp.cuh bounce_adj_warp<false> (hard selects) with cheaper adds:
// the hit sphere's adds of the bounce (its emission and albedo, NEE's
// albedo terms, roughness, index, centre, radius) summed in the lane and
// grouped once, a single tree of 13 rows where bounce_adj_warp makes one
// for each of its batches; the lights' adds as nee_adj_fused's.  The same
// arithmetic; the sums associate differently, so the cotangent is within
// rounding of bounce_adj_warp's, not bit-equal.  Every lane calls it.
template <class W, class Cnt, class View, class Tab, class Rec>
TPT_WARP void bounce_adj_fused(const W& w, const View& S,
                               const RenderParams& p, bool active, V3 ro,
                               V3 rd, uint32_t st, const Rec& rec, V3 e,
                               V3 g_e, V3 g_c, V3& g_ro, V3& g_rd, Tab T,
                               Cnt& cnt) {
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  const V3 g_pos_out = g_ro;
  const V3 g_dir = g_rd;
  g_ro = zero;
  g_rd = zero;
  const bool hit = active && rec.id >= 0;
  if (active && !hit && !p.mitsuba)  // e = sky_color(rd)
    g_rd.y = 0.5f * (g_e.x * ((0.5f - 1.0f) * 0.3f) +
                     g_e.y * ((0.7f - 1.0f) * 0.3f));
  const int id = hit ? rec.id : -1;
  const bool sc = hit && rec.scattered;
  V3 pos = zero, pc = zero, normal = zero;
  float invr = 0.0f;
  int mt = -1;
  if (sc) {
    pos = add(ro, scale(rd, rec.t));
    pc = sub(pos, v3(S.at(ROW_CX, id), S.at(ROW_CY, id), S.at(ROW_CZ, id)));
    invr = S.at(ROW_INVR, id);
    normal = scale(pc, invr);
    mt = S.mat[id];
  }
  const V3 g_em = hit && (rec.gated || !rec.scattered) ? g_e : zero;
  V3 g_alb = sc && mt != MAT_DIELECTRIC ? g_c : zero;  // c = albedo
  V3 g_pos = g_pos_out;
  V3 g_n = zero;
  V3 g_refl = zero;
  const bool lam = sc && mt == MAT_LAMBERT;
  V3 alb = zero;
  if (lam) {
    V3 ruv = unit_vector(st);
    // (pos + normal + ruv) - pos: its derivative in pos is exactly 0
    g_n = normalize_adj(sub(add(add(pos, normal), ruv), pos), g_dir);
    alb = v3(S.at(ROW_ALB, id), S.at(ROW_ALB + 1, id), S.at(ROW_ALB + 2, id));
  }
  if (p.light_sampling)
    nee_adj_fused(w, S, p, lam, pos, normal, rd, alb, id, st, rec.see, g_e,
                  T, g_pos, g_n, g_alb);
  float g_rough = 0.0f, g_ri = 0.0f;
  if (sc && mt == MAT_METAL) {
    V3 rius = unit_sphere(st);
    float rough = p.mitsuba ? 0.0f : S.at(ROW_ROUGH, id);
    g_refl =
        normalize_adj(add(reflect(rd, normal), scale(rius, rough)), g_dir);
    if (!p.mitsuba) g_rough = dot(rius, g_refl);
  } else if (sc && mt == MAT_DIELECTRIC) {
    if (rec.refl)
      g_refl = normalize_adj(reflect(rd, normal), g_dir);
    else
      g_ri = refract_adj_vals(S, id, rd, normal, g_dir, g_rd, g_n);
  }
  V3 g_pc = zero, g_co = zero;
  float g_invr = 0.0f, g_sqr = 0.0f;
  if (sc) {
    // refl = rd - normal * (2 (rd . normal))
    float dn = dot(rd, normal);
    float ng = dot(normal, g_refl);
    g_rd = add(g_rd, sub(g_refl, scale(normal, 2.0f * ng)));
    g_n = sub(g_n, add(scale(g_refl, 2.0f * dn), scale(rd, 2.0f * ng)));
    // normal = (pos - center) * inv_radius
    g_pc = scale(g_n, invr);
    g_pos = add(g_pos, g_pc);
    g_invr = dot(pc, g_n);
    // pos = ro + rd * t
    g_ro = add(g_ro, g_pos);
    g_rd = add(g_rd, scale(g_pos, rec.t));
    sphere_t_adj_vals(S, id, ro, rd, p.t_min, dot(g_pos, rd), g_ro, g_rd,
                      g_co, g_sqr);
  }
  long long c0 = 0;
  if constexpr (Cnt::kOn) c0 = w.clock();
  const Group gh = make_group(w, id);
  if constexpr (Cnt::kOn) {
    cnt.add(kGcCycGroup, w.clock() - c0);
    cnt.add(kGcHitGroups, gh.lead ? 1 : 0);
    cnt.add(kGcHitLanes, id >= 0 ? 1 : 0);
  }
  const V3 g_cen = sub(g_co, g_pc);
  group_add(w, gh, T, S.n, id,
            Adds<13>{{ROW_EM, ROW_EM + 1, ROW_EM + 2, ROW_ALB, ROW_ALB + 1,
                      ROW_ALB + 2, ROW_ROUGH, ROW_RI, ROW_CX, ROW_CY, ROW_CZ,
                      ROW_INVR, ROW_SQR},
                     {g_em.x, g_em.y, g_em.z, g_alb.x, g_alb.y, g_alb.z,
                      g_rough, g_ri, g_cen.x, g_cen.y, g_cen.z, g_invr,
                      g_sqr}});
}

// Floats of a warp's scratch for sweep_runs with `width` lanes: two slots a
// lane of a record (kRecWords) and its first seen-lights word.
TPT_HD constexpr int run_scratch_words(int width) {
  return 2 * width * (kRecWords + 1);
}

// A share of the sweep: tiles first, first + step, ... (count of them) of
// the sub-image's GradTile tiles, their samples its items (item_at).
struct RunDeal {
  int first, step, count;
};

// sweep_tiles' round robin: warp `warp` of n_warps takes tiles warp, warp +
// n_warps, ...
TPT_HD RunDeal tiles_deal(int warp, int n_warps, int n_tiles) {
  RunDeal r;
  r.first = warp;
  r.step = n_warps;
  r.count = warp < n_tiles ? (n_tiles - warp + n_warps - 1) / n_warps : 0;
  return r;
}

// Where an item lies: item i of a share is sample (i / width) % spp of
// lane i % width's pixel of the share's tile i / (spp * width); pix -1
// outside the sub-image.
struct ItemAt {
  int pix, s;
};

template <int kWidth>
TPT_HD ItemAt item_at(const RunDeal& r, const RenderParams& p, int item) {
  const int TW = GradTile<kWidth>::kW, TH = GradTile<kWidth>::kH;
  const int tiles_x = (p.width + TW - 1) / TW;
  const int per_tile = p.spp * kWidth;
  const int k = item / per_tile;
  const int o = item % kWidth;
  const int tile = r.first + k * r.step;
  const int px = (tile % tiles_x) * TW + o % TW;
  const int py = (tile / tiles_x) * TH + o / TW;
  ItemAt a;
  a.s = (item % per_tile) / kWidth;
  a.pix = px < p.width && py < p.height ? py * p.width + px : -1;
  return a;
}

// The bounces of item i of the share (0 outside the sub-image).
template <int kWidth>
TPT_HD int item_depth(const RunDeal& r, const RenderParams& p,
                      const FrameTape& ft, int item) {
  const ItemAt a = item_at<kWidth>(r, p, item);
  return a.pix < 0 ? 0 : ft.depth[static_cast<size_t>(a.pix) * p.spp + a.s];
}

// A warp's queue in its share's item order, sweep_tiles' (the kept sweep's
// deal, tiles_deal): a queue for each batch of grad_batch(p) samples of a
// tile, which drains before the next starts.  Position i is item i.
struct TileQueue {
  RunDeal r;
  template <int kWidth>
  TPT_HD int total(const RenderParams& p) const {
    return r.count * p.spp * kWidth;
  }
  // the end of the queue that starts at position `begin`
  template <int kWidth>
  TPT_HD int end(const RenderParams& p, int begin) const {
    const int per_tile = p.spp * kWidth;
    const int tile0 = begin - begin % per_tile;
    const int s0 = (begin % per_tile) / kWidth;
    const int s1 = s0 + grad_batch(p) < p.spp ? s0 + grad_batch(p) : p.spp;
    return tile0 + s1 * kWidth;
  }
  template <int kWidth>
  TPT_HD int depth(const RenderParams& p, const FrameTape& ft, int pos,
                   int end) const {
    return pos < end ? item_depth<kWidth>(r, p, ft, pos) : 0;
  }
  template <int kWidth>
  TPT_HD ItemAt at(const RenderParams& p, int pos) const {
    return item_at<kWidth>(r, p, pos);
  }
};

// Writes order[0..n): the n items of a share whose bounces are dep[0..n),
// from the most bounces to the fewest, each count's items in index order
// (a stable counting sort: cnt holds max_depth + 1 ints of scratch), and
// returns how many have a bounce.  Every lane of one warp calls it.
template <class W>
TPT_WARP int depth_order(const W& w, const int* dep, int n, int max_depth,
                         int* cnt, int* order) {
  const int WD = W::kWidth;
  const int lane = w.lane();
  const unsigned below = (1u << lane) - 1u;
  for (int d = lane; d <= max_depth; d += WD) cnt[d] = 0;
  w.sync();
  for (int c = 0; c < n; c += WD) {
    const int d = c + lane < n ? dep[c + lane] : -1;
    const unsigned same = w.match_any(d);
    if (d >= 0 && lowest(same) == lane) cnt[d] += popc(same);
    w.sync();
  }
  const int empty = w.shfl(cnt[0], 0);
  if (lane == 0) {
    int start = 0;
    for (int d = max_depth; d >= 0; --d) {
      const int k = cnt[d];
      cnt[d] = start;
      start += k;
    }
  }
  w.sync();
  for (int c = 0; c < n; c += WD) {
    const int d = c + lane < n ? dep[c + lane] : -1;
    const unsigned same = w.match_any(d);
    if (d >= 0) order[cnt[d] + popc(same & below)] = c + lane;
    w.sync();
    if (d >= 0 && lowest(same) == lane) cnt[d] += popc(same);
    w.sync();
  }
  return n - empty;
}

// A warp's queue over a block's share (its items' bounces dep and their
// depth_order, of which n_valid have a bounce) dealt to the block's
// `warps` warps: the warp's position i is the share's item
// order[i * warps + warp], so each warp takes every warps-th of the items
// from the most bounces down.  The warps' work comes out nearly equal, and
// each queue's last samples are its shortest.
struct SortedQueue {
  RunDeal r;
  const int* dep;
  const int* order;
  int n_valid, warp, warps;
  template <int kWidth>
  TPT_HD int total(const RenderParams&) const {
    return n_valid > warp ? (n_valid - warp + warps - 1) / warps : 0;
  }
  template <int kWidth>
  TPT_HD int end(const RenderParams& p, int) const {
    return total<kWidth>(p);
  }
  template <int kWidth>
  TPT_HD int depth(const RenderParams&, const FrameTape&, int pos,
                   int end) const {
    return pos < end ? dep[order[pos * warps + warp]] : 0;
  }
  template <int kWidth>
  TPT_HD ItemAt at(const RenderParams& p, int pos) const {
    return item_at<kWidth>(r, p, order[pos * warps + warp]);
  }
};

// Fetches the record at `slot` and its first seen-lights word into a
// lane's shared slot (rec: kRecWords floats, 16-byte aligned).
TPT_HD void fetch_record(const FrameTape& ft, size_t slot, float* rec,
                         uint32_t* see) {
  const float* q = ft.rec + slot * kRecWords;
  for (int j = 0; j < kRecWords; j += 4) copy16_async(rec + j, q + j);
  if (ft.words > 0) copy4_async(see, ft.see + slot * ft.words);
}

// The record a lane's shared slot holds, as FrameTape::get reads it from
// the tape, its seen lights SeeWords over the tape's words at `slot`.
TPT_HD Carry read_record(const FrameTape& ft, size_t slot, const float* rec,
                         const uint32_t* see, BounceRecOf<SeeWords>& r) {
  float w[kRecWords];
#ifdef __CUDA_ARCH__
  for (int j = 0; j < kRecWords; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(rec + j);
    w[j] = v.x;
    w[j + 1] = v.y;
    w[j + 2] = v.z;
    w[j + 3] = v.w;
  }
#else
  for (int j = 0; j < kRecWords; ++j) w[j] = rec[j];
#endif
  Carry c;
  c.ro = v3(w[0], w[1], w[2]);
  c.rd = v3(w[3], w[4], w[5]);
  c.t = w[6];
  c.st = FrameTape::as_bits(w[7]);
  c.bits = FrameTape::as_bits(w[8]);
  c.e = v3(w[9], w[10], w[11]);
  c.atten = v3(w[12], w[13], w[14]);
  const BounceRec b = unpack_rec(c.bits, c.t);
  r.id = static_cast<int>(FrameTape::as_bits(w[15])) - 1;
  r.t = b.t;
  r.scattered = b.scattered;
  r.gated = b.gated;
  r.refl = b.refl;
  r.see = SeeWords{ft.words > 0 ? *see : 0u, ft.see + slot * ft.words};
  return c;
}

// The reverse sweep over the FrameTape ft of the warp's queue q (a
// TileQueue or SortedQueue) of the (p.height, p.width) sub-image's
// samples, adding into the warp's table T: each lane sweeps one sample's
// bounces last to first and takes the queue's next item when its sample
// ends (an item with no bounces is passed over); the adjoint of each
// bounce is bounce_adj_warp's, or with kFused bounce_adj_fused's.  g: the
// pixel cotangent (height, width, 3); ws: the warp's scratch
// (run_scratch_words).  Every lane calls it.
template <bool kFused = false, class W, class Cnt, class View, class Tab,
          class Queue>
TPT_WARP void sweep_runs(const W& w, const View& S, const RenderParams& p,
                         const float* g, Tab T, const FrameTape& ft,
                         float* ws, const Queue& q, Cnt& cnt) {
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  const int WD = W::kWidth;
  const int lane = w.lane();
  const unsigned below = (1u << lane) - 1u;
  float* recs = ws + lane * kRecWords;  // slot b at recs + b * WD * kRecWords
  uint32_t* sees = reinterpret_cast<uint32_t*>(ws + 2 * WD * kRecWords) + lane;
  const int total = q.template total<W::kWidth>(p);
  for (int begin = 0; begin < total;) {
    long long c0 = 0, c1 = 0;
    if constexpr (Cnt::kOn) c0 = w.clock();
    const int end = q.template end<W::kWidth>(p, begin);
    int cursor = begin;
    // this lane's sample: its pixel, sample, next bounce, cotangent and the
    // adjoint's carries; the sample it takes next
    bool has = false, nhas = false;
    int pix = 0, s = 0, d = 0, npix = 0, ns = 0, nd = 0;
    V3 G = zero, nG = zero, g_atten = zero, g_ro = zero, g_rd = zero;
    int win = q.template depth<W::kWidth>(p, ft, cursor + lane, end);
    // the lanes in `free` take the next items (those with no bounces passed
    // over): sweep_tiles' claims
    auto claim = [&](bool free) {
      nhas = false;
      int nitem = 0;
      for (;;) {
        const unsigned need = w.ballot(free && !nhas);
        if (!need || cursor >= end) break;
        const int rank = popc(need & below);
        const int dep = w.shfl(win, rank);
        if (free && !nhas && cursor + rank < end) {
          nitem = cursor + rank;
          nd = dep - 1;
          nhas = nd >= 0;
        }
        cursor += popc(need);
        win = q.template depth<W::kWidth>(p, ft, cursor + lane, end);
      }
      if (nhas) {
        const ItemAt a = q.template at<W::kWidth>(p, nitem);
        npix = a.pix;
        ns = a.s;
        const size_t o = static_cast<size_t>(npix) * 3;
        nG = v3(g[o] * p.inv_spp, g[o + 1] * p.inv_spp, g[o + 2] * p.inv_spp);
      }
    };
    claim(true);
    has = nhas;
    pix = npix;
    s = ns;
    d = nd;
    G = nG;
    int buf = 0;
    if (has)
      fetch_record(ft, ft.slot(pix, s, d), recs, sees);
    commit_copies();
    if constexpr (Cnt::kOn) {
      c1 = w.clock();
      cnt.add(kWcCycQueue, c1 - c0);
    }
    for (;;) {
      if (!w.any(has)) break;
      long long t0 = 0;
      if constexpr (Cnt::kOn) t0 = w.clock();
      // this step's record, fetched during the last one
      wait_copies();
      Carry k;
      k.ro = k.rd = k.e = k.atten = zero;
      k.st = 0;
      BounceRecOf<SeeWords> rec;
      rec.id = -1;
      rec.t = 0.0f;
      rec.scattered = rec.gated = rec.refl = false;
      rec.see = SeeWords{0u, nullptr};
      const size_t slot = ft.slot(pix, s, d);
      if (has)
        k = read_record(ft, slot, recs + buf * WD * kRecWords,
                        sees + buf * WD, rec);
      long long t1 = 0;
      if constexpr (Cnt::kOn) {
        t1 = w.clock();
        cnt.add(kWcCycTape, t1 - t0);
      }
      // the next sample of each lane on its last bounce
      const bool last = has && d == 0;
      if (w.any(last) && cursor < end) claim(last);
      else nhas = false;
      long long t2 = 0;
      if constexpr (Cnt::kOn) {
        t2 = w.clock();
        cnt.add(kWcCycQueue, t2 - t1);
      }
      // the next step's record
      float* nrec = recs + (buf ^ 1) * WD * kRecWords;
      uint32_t* nsee = sees + (buf ^ 1) * WD;
      if (has && d > 0)
        fetch_record(ft, slot - 1, nrec, nsee);
      else if (last && nhas)
        fetch_record(ft, ft.slot(npix, ns, nd), nrec, nsee);
      commit_copies();
      long long t3 = 0;
      if constexpr (Cnt::kOn) {
        t3 = w.clock();
        cnt.add(kWcCycTape, t3 - t2);
      }
      V3 g_e = zero, g_c = zero;
      if (has) {
        // col += atten * e; atten *= c -- reversed
        g_e = mul(k.atten, G);
        g_c = mul(g_atten, k.atten);
        g_atten = add(mul(G, k.e), mul(g_atten, carry_c(S, rec)));
      }
      if constexpr (kFused)
        bounce_adj_fused(w, S, p, has, k.ro, k.rd, k.st, rec, k.e, g_e, g_c,
                         g_ro, g_rd, T, cnt);
      else
        bounce_adj_warp<false>(w, S, p, has, k.ro, k.rd, k.st, rec, k.e, g_e,
                               g_c, g_ro, g_rd, T, cnt);
      if constexpr (Cnt::kOn) {
        cnt.add(kWcCycBounce, w.clock() - t3);
        cnt.add(kGcAdjBounces, has ? 1 : 0);
        cnt.add(kGcAdjSlots, 1);
      }
      if (last) {
        has = nhas;
        pix = npix;
        s = ns;
        d = nd;
        G = nG;
        g_atten = g_ro = g_rd = zero;
      } else if (has) {
        --d;
      }
      buf ^= 1;
    }
    w.sync();
    if constexpr (Cnt::kOn) cnt.add(kGcCycAdj, w.clock() - c0);
    begin = end;
  }
}

}  // namespace tpt
