// The warp form of the gradient kernel's per-pixel code (csrc/grad.cu's
// warp_grad_kernel, on the training step's path): a warp's 32 lanes take
// 32 pixels, trace a batch of each pixel's samples forward once with
// stored carries (trace.cuh trace_sample_tape, records in WarpTape), and
// then sweep the batch's samples in reverse together, a bounce of one
// sample per lane and step, every lane taking the next sample of the
// warp's queue when its own is done (grad_tiles).
//
// Why.  The replaying form (grad_pixel, one thread a pixel) replays
// bounces 0..d-1 before differentiating bounce d and adds each adjoint
// into a dense (SCENE_ROWS, 64) table of its own in local memory: 3.5 KB
// a thread, zeroed and reduced on every launch, and a cap of 64 spheres.
// Here the table is one per warp, (SCENE_ROWS, n) in shared memory, and
// every add into it is a warp collective at a point every lane reaches:
// lanes that add to the same sphere are grouped (match_any), each group
// sums its values by a fixed tree over its lanes' ranks, and the group's
// lowest lane adds the sum to the table.  The adds of one bounce come in
// a few batches whose trees run together (group_add).  A lane with
// nothing to add passes key -1, or adds 0 in its sphere's group; a table
// entry starts at +0 and is never -0, so adding 0 leaves it bit for bit.
//
// The adjoint below is trace.cuh's bounce_adj and nee_adj written out so
// that their adds happen at warp-uniform points (the leaf adjoints,
// sphere_t_adj_vals, cone_adj_vals and refract_adj_vals, are shared): the
// same arithmetic, and for each table entry the same adds in the same
// order for each lane.  So under HostLane (a warp of one lane: the
// sequential loop over pixels) the image, the rays and the table are
// bit-equal to grad_pixel's; the soft instance (kSoft: the
// soft-silhouette estimator, trace.cuh's bounce_adj<true>) to
// grad_pixel<true>'s.  Its silhouette term adds into the groups of the
// lane's winner, or of a missed ray's silhouette candidate (whose other
// adds are 0), and each light's occluder adds through groups of its own.  bounce_adj itself stays as it was: the
// replaying kernel is the baseline and keeps its registers.  Written once
// against a warp policy and run by the replaying kernel under a one-lane
// warp, the adjoint moved that kernel from 116 registers and no spills to
// 128 registers and 36 B of spill stores, and to 128 and none with each
// add made at once (-Xptxas -v for sm_90a; PERF.md).
//
// Determinism: a warp's pixels follow from its index (tiles dealt round
// robin), which lane sweeps which sample follows from the depths alone,
// each group sums in a fixed order, and nothing is added with a
// floating-point atomic, so two launches on the same inputs are bit-equal.

#pragma once

#include <string.h>

#include <type_traits>

#include "trace.cuh"
#include "warp.cuh"

namespace tpt {

// Position of the n-th (from 0) set bit of m, for n < popc(m).
TPT_HD int nth_set(unsigned m, int n) {
  int pos = 0;
  for (int w = 16; w > 0; w >>= 1) {
    const unsigned low = m & ((1u << w) - 1u);
    const int c = popc(low);
    if (n >= c) {
      n -= c;
      m >>= w;
      pos += w;
    } else {
      m = low;
    }
  }
  return pos;
}

// A lane's place in the grouped sums of one key.  The group's lanes
// (mask) sum by a tree over their ranks: at step k the lane of rank r,
// r % 2^(k+1) == 0, adds the value of the lane of rank r + 2^k if there
// is one.  tree packs, for step k, the lane to read (bits 5k..5k+4) and
// whether to add it (bit 25+k); steps is the warp's most.
struct Group {
  unsigned tree;
  int steps;
  bool lead;  // rank 0 of a group whose key is a sphere
};

// The lane of rank r's tree over a group of `size` lanes (mask);
// `most` is the largest group of the warp.
TPT_HD Group group_tree(unsigned mask, int lane, int most, bool keyed) {
  const int size = popc(mask);
  const int rank = popc(mask & ((1u << lane) - 1u));
  Group g;
  g.tree = 0;
  g.lead = keyed && rank == 0;
  g.steps = 0;
  while ((1 << g.steps) < most) ++g.steps;
  for (int k = 0; k < g.steps; ++k) {
    const int s = 1 << k;
    unsigned src = (unsigned)lane;
    if (rank % (2 * s) == 0 && rank + s < size) {
      src = (unsigned)nth_set(mask, rank + s);
      g.tree |= 1u << (25 + k);
    }
    g.tree |= src << (5 * k);
  }
  return g;
}

// The groups of `key` (a sphere, or -1: nothing to add).
template <class W>
TPT_WARP Group make_group(const W& w, int key) {
  const unsigned mask = w.match_any(key);
  const unsigned m = key < 0 ? 1u << w.lane() : mask;
  return group_tree(m, w.lane(), (int)w.reduce_max((unsigned)popc(m)),
                    key >= 0);
}

// As make_group for a key that every lane that passes one shares.
template <class W>
TPT_WARP Group make_group_uniform(const W& w, int key) {
  const unsigned keyed = w.ballot(key >= 0);
  return group_tree(key < 0 ? 1u << w.lane() : keyed, w.lane(), popc(keyed),
                    key >= 0);
}

// N adds of one group: T[row[i]][key] += the group's sum of v[i].
template <int N>
struct Adds {
  int row[N];
  float v[N];
};

// The next value of a launch-wide int counter (an integer atomic: the
// order in which lanes draw changes nothing that is summed).
TPT_HD int claim(int* counter) {
#ifdef __CUDA_ARCH__
  return atomicAdd(counter, 1);
#else
  return __atomic_fetch_add(counter, 1, __ATOMIC_RELAXED);
#endif
}

// Floats of a PoolTable slot: one sphere's SCENE_ROWS entries, padded to
// 64 bytes.
constexpr int kSlotFloats = 16;
// Sphere ids a block of a PoolTable's directory covers: ids b * kDirIds ..
// b * kDirIds + kDirIds - 1.
constexpr int kDirIds = 64;
// A directory entry whose claim found its pool empty: later adds to it
// claim nothing, so that the counters count each entry the launch needs
// once.
constexpr int kDropped = -2;

// A warp's cotangent table in device memory, for scenes of any size
// (the pool instances of csrc/grad.cu).  A dense (SCENE_ROWS, n) table a
// warp does not scale: 5.6 MB a warp at n = 100,096, tens of GB over the
// resident warps.  Here a sphere gets a row of entries (a slot of
// kSlotFloats floats, zeroed before the launch) the first time this warp
// adds something other than +-0 to it, drawn from a pool the launch's
// warps share by an integer counter.  The warp finds the slot in two
// steps: its column of a block directory, dir[(sphere / kDirIds) *
// stride], holds the block of kDirIds slot indices (-1 before the launch)
// that the warp drew, from a second pool, the first time it added to one
// of those kDirIds spheres; the sphere's index in the block holds its
// slot.  So the scratch is the slots the launch's warps touch (64 bytes
// each), the blocks they touch (256 bytes each, never more than the
// slots) and 4 bytes per (kDirIds spheres, warp) of directory: 264 bytes a
// sphere over an H100's 4,224 resident warps, where one entry per (sphere,
// warp) took 16,896.  Each slot belongs to one warp and its entries take
// the same adds in the same order as the shared table's; adds of +-0,
// which the shared table makes and this one skips, leave an entry that
// starts at +0 bit for bit (it is never -0), so the two tables hold the
// same bits.  csrc/grad.cu's sum_pool then sums the warps in the shared
// instance's order.  Where either pool runs out the claim adds nothing and
// marks its entry kDropped, and the counters, which count every entry
// claimed, tell the launcher how many to give the relaunch.  The group
// leads of one add may need the same new block (two spheres of one run of
// kDirIds): the warp claims it once, by the lowest such lane, and the
// others read it after a warp sync; a slot has one lead.  Every lane of
// the warp calls add.
struct PoolTable {
  int* dir;  // this warp's block directory column: dir[block * stride]
  int stride;
  int* blocks;  // kDirIds slot indices a block
  int* next_block;
  int block_cap;
  float* pool;
  int* next;
  int cap;
  template <class W, int N>
  TPT_WARP void add(const W& w, bool lead, int key, const Adds<N>& a) const {
    bool some = false;
#pragma unroll
    for (int i = 0; i < N; ++i) some = some || a.v[i] != 0.0f;
    some = some && lead;
    int* d = dir + static_cast<size_t>(some ? key / kDirIds : 0) * stride;
    int b = some ? *d : kDropped;
    const bool need = some && b == -1;
    if (w.any(need)) {
      // one claim for each run of kDirIds spheres the leads need
      const unsigned same = w.match_any(need ? key / kDirIds : -1 - w.lane());
      if (need && lowest(same) == w.lane()) {
        b = claim(next_block);
        *d = b < block_cap ? b : kDropped;
      }
      w.sync();
      if (need) b = *d;
    }
    if (b < 0) return;
    int* q = blocks + static_cast<size_t>(b) * kDirIds + key % kDirIds;
    int s = *q;
    if (s < 0) {
      if (s == kDropped) return;
      s = claim(next);
      if (s >= cap) {
        *q = kDropped;
        return;
      }
      *q = s;
    }
    float* e = pool + static_cast<size_t>(s) * kSlotFloats;
#pragma unroll
    for (int i = 0; i < N; ++i) e[a.row[i]] += a.v[i];
  }
};

// The adds of `a`, summed over each group of g: the N trees run together,
// then the group's first lane adds the sums in order to the table T: a
// warp's (SCENE_ROWS, n) table in shared memory (a float*: entry (row,
// sphere) at T[row * n + sphere]) or a PoolTable (n unused).  Every lane
// calls it.  The warp syncs first: an entry that another lane added to at
// an earlier call is read after that write.
template <class W, int N, class Tab>
TPT_WARP void group_add(const W& w, const Group& g, Tab T, int n, int key,
                        Adds<N> a) {
  w.sync();
  for (int k = 0; k < g.steps; ++k) {
    const int src = (int)((g.tree >> (5 * k)) & 31u);
    const bool take = (g.tree >> (25 + k)) & 1u;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float o = w.shfl(a.v[i], src);
      if (take) a.v[i] = a.v[i] + o;
    }
  }
  if constexpr (std::is_pointer<Tab>::value) {
    if (g.lead) {
#pragma unroll
      for (int i = 0; i < N; ++i) T[a.row[i] * n + key] += a.v[i];
    }
  } else {
    T.add(w, g.lead, key, a);
  }
}

// A warp's carries: record (slot, lane) at base[(slot * width + lane) *
// kRecWords], a Carry and a word of padding, so that a lane writes its
// records and reads any lane's as four 16-byte words.  Slot j * max_depth
// + d holds bounce d of the j-th sample of a batch.  The packed bits hold
// a sphere id below 1023 (trace.cuh pack_rec); kWide keeps the id whole
// in the padding word instead, for scenes of any size.
enum { kRecWords = 16 };

template <bool kWide>
struct WarpTapeOf {
  using Rec = BounceRec;
  float* base;
  int width;  // lanes
  int lane;
  TPT_HD void bind(Rec&, int) const {}
  TPT_HD static Rec none() { return unpack_rec(0u, 0.0f); }
  TPT_HD static float as_float(uint32_t u) {
    float f;
    memcpy(&f, &u, sizeof f);
    return f;
  }
  TPT_HD static uint32_t as_bits(float f) {
    uint32_t u;
    memcpy(&u, &f, sizeof u);
    return u;
  }
  TPT_HD float* rec(int owner, int slot) const {
    return base + (static_cast<size_t>(slot) * width + owner) * kRecWords;
  }
  TPT_HD void put(int slot, const Carry& c, const BounceRec& r) const {
    uint32_t bits = c.bits;
    float pad = 0.0f;
    if constexpr (kWide) {
      BounceRec flags = r;
      flags.id = -1;
      bits = pack_rec(flags);
      pad = as_float(static_cast<uint32_t>(r.id + 1));
    }
    const float w[kRecWords] = {
        c.ro.x, c.ro.y, c.ro.z, c.rd.x, c.rd.y, c.rd.z, c.t,
        as_float(c.st), as_float(bits), c.e.x, c.e.y, c.e.z,
        c.atten.x, c.atten.y, c.atten.z, pad};
    float* q = rec(lane, slot);
#ifdef __CUDA_ARCH__
    for (int j = 0; j < kRecWords; j += 4)
      *reinterpret_cast<float4*>(q + j) =
          make_float4(w[j], w[j + 1], w[j + 2], w[j + 3]);
#else
    for (int j = 0; j < kRecWords; ++j) q[j] = w[j];
#endif
  }
  // The record (slot, owner) and, in r, its bounce record.
  TPT_HD Carry get(int owner, int slot, BounceRec& r) const {
    const float* q = rec(owner, slot);
    float w[kRecWords];
#ifdef __CUDA_ARCH__
    for (int j = 0; j < kRecWords; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(q + j);
      w[j] = v.x;
      w[j + 1] = v.y;
      w[j + 2] = v.z;
      w[j + 3] = v.w;
    }
#else
    for (int j = 0; j < kRecWords; ++j) w[j] = q[j];
#endif
    Carry c;
    c.ro = v3(w[0], w[1], w[2]);
    c.rd = v3(w[3], w[4], w[5]);
    c.t = w[6];
    c.st = as_bits(w[7]);
    c.bits = as_bits(w[8]);
    c.e = v3(w[9], w[10], w[11]);
    c.atten = v3(w[12], w[13], w[14]);
    r = unpack_rec(c.bits, c.t);
    if constexpr (kWide) r.id = static_cast<int>(as_bits(w[15])) - 1;
    return c;
  }
};

using WarpTape = WarpTapeOf<false>;
using WideTape = WarpTapeOf<true>;

// A record with its seen lights in LightBits, from one with the flags.
TPT_HD BounceRecOf<LightBits> with_bits(const BounceRec& b, LightBits see) {
  BounceRecOf<LightBits> r;
  r.id = b.id;
  r.t = b.t;
  r.scattered = b.scattered;
  r.gated = b.gated;
  r.refl = b.refl;
  r.see = see;
  return r;
}

// WarpTapeOf whose records keep their seen lights in words of their own,
// LightBits of light_words(n_lights) words a record at see[(slot * width +
// lane) * words]: the gradient kernels' instances past kMaxLights lights
// (the record's 16 bits of `see` and, in WideTape, its padding word are
// taken).
template <bool kWide>
struct LightTapeOf : WarpTapeOf<kWide> {
  using Rec = BounceRecOf<LightBits>;
  uint32_t* see;
  int words;
  TPT_HD LightBits bits(int owner, int slot) const {
    return LightBits{see + (static_cast<size_t>(slot) * this->width + owner) *
                               words};
  }
  TPT_HD static Rec none() {
    return with_bits(unpack_rec(0u, 0.0f), LightBits{nullptr});
  }
  TPT_HD void bind(Rec& r, int slot) const { r.see = bits(this->lane, slot); }
  TPT_HD void put(int slot, const Carry& c, const Rec& r) const {
    BounceRec b = unpack_rec(0u, r.t);
    b.id = r.id;
    b.scattered = r.scattered;
    b.gated = r.gated;
    b.refl = r.refl;
    WarpTapeOf<kWide>::put(slot, c, b);
  }
  TPT_HD Carry get(int owner, int slot, Rec& r) const {
    BounceRec b;
    const Carry c = WarpTapeOf<kWide>::get(owner, slot, b);
    r = with_bits(b, bits(owner, slot));
    return c;
  }
};

// Whether a view's soft scans run as warp walks (the cooperative sweep of
// csrc/coopgrad.cuh specializes it for its view): bounce_adj_warp then
// calls them with every lane, and nee_adj_coop takes nee_adj_warp's place
// in the soft instance.
template <class View>
struct coop_scans {
  static constexpr bool value = false;
};

// nee_adj for the lanes with lam (a Lambert hit with NEE on); every lane
// runs the light loop and its adds.  gh: the groups of the hit sphere,
// formed with key hit_id.  kSoft: with the soft shadow boundary, whose
// occluders add through groups of their own.
template <bool kSoft, class W, class Cnt, class View, class Tab, class See>
TPT_WARP void nee_adj_warp(const W& w, const View& S, const RenderParams& p,
                           bool lam, V3 pos, V3 normal, V3 rd, V3 alb,
                           int hit_id, uint32_t st, See see, V3 g_le,
                           const Group& gh, Tab T, V3& g_pos, V3& g_n,
                           Cnt& cnt) {
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
    // kSoft: every light of the lane may add (an occluded one through its
    // occluder)
    const bool run = kSoft ? on : at;
    if (!w.any(run)) continue;  // every add of this light would be 0
    V3 g_alb = zero, g_em = zero, g_sc = zero, g_co = zero;
    float g_r = 0.0f, g_sqr = 0.0f;
    int j = -1;
    if (run) {
      Cone q = cone(S, e, pos, eps1, eps2);
      float omega = TPT_TWO_PI * (1.0f - q.cos_a_max);
      float dl = dot(q.l, nl);
      float fac = max0(dl) * omega / TPT_PI;
      V3 em = v3(S.at(ROW_EM, e), S.at(ROW_EM + 1, e), S.at(ROW_EM + 2, e));
      if (at) {
        g_alb = mul(g_le, scale(em, fac));
        g_em = mul(g_le, scale(alb, fac));
      }
      if (dl > 0.0f) {
        float g_fac = dot(g_le, mul(alb, em));
        V3 g_l = zero;
        float g_cam = 0.0f;
        if (at) {
          float g_dl = g_fac * omega / TPT_PI;
          g_cam = -TPT_TWO_PI * (g_fac * dl / TPT_PI);
          g_nl = add(g_nl, scale(q.l, g_dl));
          g_l = scale(nl, g_dl);
        }
        if constexpr (kSoft) {
          long long c0 = 0;
          if constexpr (Cnt::kOn) c0 = w.clock();
          j = shadow_adj_vals(S, p, e, pos, q.l, at, fac * g_fac, g_l, g_pos,
                              g_co, g_sqr);
          if constexpr (Cnt::kOn) cnt.add(kGcCycSoft, w.clock() - c0);
        }
        if (at || j >= 0)
          cone_adj_vals(q, eps1, g_l, g_cam, g_pos, g_r, g_sc);
      }
    }
    group_add(w, gh, T, S.n, hit_id,
              Adds<3>{{ROW_ALB, ROW_ALB + 1, ROW_ALB + 2},
                      {g_alb.x, g_alb.y, g_alb.z}});
    const Group ge = make_group_uniform(w, at || j >= 0 ? e : -1);
    group_add(w, ge, T, S.n, e,
              Adds<7>{{ROW_EM, ROW_EM + 1, ROW_EM + 2, ROW_R, ROW_CX,
                       ROW_CY, ROW_CZ},
                      {g_em.x, g_em.y, g_em.z, g_r, g_sc.x, g_sc.y,
                       g_sc.z}});
    if constexpr (kSoft) {
      const Group gj = make_group(w, j);
      group_add(w, gj, T, S.n, j,
                Adds<4>{{ROW_CX, ROW_CY, ROW_CZ, ROW_SQR},
                        {g_co.x, g_co.y, g_co.z, g_sqr}});
    }
  }
  if (lam) g_n = add(g_n, front ? g_nl : neg(g_nl));
}

// bounce_adj for the lanes with `active`; every lane calls it.  The
// groups of the hit sphere are formed once and serve all its adds.
// kSoft: with the soft-silhouette terms; a miss lane's groups are then
// those of its silhouette candidate, which its silhouette term adds to
// (its other adds are 0).
template <bool kSoft, class W, class Cnt, class View, class Tab, class Rec>
TPT_WARP void bounce_adj_warp(const W& w, const View& S,
                              const RenderParams& p, bool active, V3 ro,
                              V3 rd, uint32_t st, const Rec& rec, V3 e,
                              V3 g_e, V3 g_c, V3& g_ro, V3& g_rd,
                              Tab T, Cnt& cnt) {
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  const V3 g_pos_out = g_ro;
  const V3 g_dir = g_rd;
  g_ro = zero;
  g_rd = zero;
  const int n = S.n;
  const bool hit = active && rec.id >= 0;
  if (active && !hit && !p.mitsuba)  // e = sky_color(rd)
    g_rd.y = 0.5f * (g_e.x * ((0.5f - 1.0f) * 0.3f) +
                     g_e.y * ((0.7f - 1.0f) * 0.3f));
  const int id = hit ? rec.id : -1;
  const bool sc = hit && rec.scattered;
  long long c0 = 0;
  // the sphere whose groups the lane's adds take: the winner, or kSoft's
  // silhouette candidate of a miss
  int key = id;
  float d_sil = 0.0f, g_w = 0.0f;
  if constexpr (kSoft) {
    if constexpr (Cnt::kOn) c0 = w.clock();
    if constexpr (coop_scans<View>::value) {
      // the warp walks the miss lanes' scans together
      float nb, d_c;
      const int cand =
          silhouette_warp(w, S, active && !hit, ro, rd, p.t_min, d_c, nb);
      if (active && !hit) {
        key = cand;
        d_sil = d_c;
        if (key >= 0)
          g_w = dot(g_e, sub(tangent_radiance(S, p, key, nb, ro, rd),
                             sky_color(rd, p.mitsuba != 0)));
      } else if (hit) {
        d_sil = discr(S, id, ro, rd);
        g_w = hit_weight_grad(S, p, rec, rd, e, g_e, g_c);
      }
    } else if (active && !hit) {  // e += w_m (L - sky), w_m = 0
      float nb;
      key = silhouette_candidate(S, ro, rd, p.t_min, d_sil, nb);
      if (key >= 0)
        g_w = dot(g_e, sub(tangent_radiance(S, p, key, nb, ro, rd),
                           sky_color(rd, p.mitsuba != 0)));
    } else if (hit) {
      d_sil = discr(S, id, ro, rd);
      g_w = hit_weight_grad(S, p, rec, rd, e, g_e, g_c);
    }
    if constexpr (Cnt::kOn) cnt.add(kGcCycSoft, w.clock() - c0);
  }
  if constexpr (Cnt::kOn) c0 = w.clock();
  const Group gh = make_group(w, key);
  if constexpr (Cnt::kOn) {
    cnt.add(kGcCycGroup, w.clock() - c0);
    cnt.add(kGcHitGroups, gh.lead ? 1 : 0);
    cnt.add(kGcHitLanes, key >= 0 ? 1 : 0);
  }
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
  {
    const V3 em = hit && (rec.gated || !rec.scattered) ? g_e : zero;
    const V3 alb = sc && mt != MAT_DIELECTRIC ? g_c : zero;  // c = albedo
    group_add(w, gh, T, n, key,
              Adds<6>{{ROW_EM, ROW_EM + 1, ROW_EM + 2, ROW_ALB, ROW_ALB + 1,
                       ROW_ALB + 2},
                      {em.x, em.y, em.z, alb.x, alb.y, alb.z}});
  }
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
  if constexpr (kSoft && coop_scans<View>::value) {
    if (p.light_sampling)
      nee_adj_coop(w, S, p, lam, pos, normal, rd, alb, key, st, rec.see, g_e,
                   gh, T, g_pos, g_n, cnt);
  } else if (p.light_sampling) {
    nee_adj_warp<kSoft>(w, S, p, lam, pos, normal, rd, alb, key, st, rec.see,
                        g_e, gh, T, g_pos, g_n, cnt);
  }
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
  if constexpr (kSoft) {
    V3 g_co_s = zero;
    float g_sqr_s = 0.0f;
    if (key >= 0)
      discr_adj_vals(S, key, ro, rd, soft_grad(d_sil, p.soft_eps, g_w), g_ro,
                     g_rd, g_co_s, g_sqr_s);
    group_add(w, gh, T, n, key,
              Adds<14>{{ROW_ROUGH, ROW_RI, ROW_CX, ROW_CY, ROW_CZ, ROW_INVR,
                        ROW_CX, ROW_CY, ROW_CZ, ROW_SQR, ROW_CX, ROW_CY,
                        ROW_CZ, ROW_SQR},
                       {g_rough, g_ri, -g_pc.x, -g_pc.y, -g_pc.z, g_invr,
                        g_co.x, g_co.y, g_co.z, g_sqr, g_co_s.x, g_co_s.y,
                        g_co_s.z, g_sqr_s}});
  } else {
    group_add(w, gh, T, n, id,
              Adds<10>{{ROW_ROUGH, ROW_RI, ROW_CX, ROW_CY, ROW_CZ, ROW_INVR,
                        ROW_CX, ROW_CY, ROW_CZ, ROW_SQR},
                       {g_rough, g_ri, -g_pc.x, -g_pc.y, -g_pc.z, g_invr,
                        g_co.x, g_co.y, g_co.z, g_sqr}});
  }
}

// Samples a lane traces forward before the warp's reverse sweep of them:
// at most kGradBatch, and at most kGradSlots bounces of carries a lane.
constexpr int kGradBatch = 4;
constexpr int kGradSlots = 40;

TPT_HD int grad_batch(const RenderParams& p) {
  const int by_slots = p.max_depth < kGradSlots ? kGradSlots / p.max_depth : 1;
  const int b = by_slots < kGradBatch ? by_slots : kGradBatch;
  return p.spp < b ? p.spp : b;
}

// The pixels a warp takes at a time: 8x4 for a warp of 32 lanes (more
// coherent than the render kernels' 16x2: 3% faster in this kernel's
// timings on an H100), one for a one-lane warp.
template <int kWidth>
struct GradTile {
  static constexpr int kW = kWidth == 32 ? 8 : 1;
  static constexpr int kH = kWidth / kW;
};

// Floats of a warp's scratch for grad_tiles with `width` lanes: each
// lane's pixel cotangent, and the bounces of each sample of a batch.
TPT_HD int grad_scratch_words(int width) { return (3 + kGradBatch) * width; }

// The warp's pixels of the (p.height, p.width) sub-image at (p.x0, p.y0):
// tiles of GradTile pixels, row-major, the warp taking tiles
// warp, warp + n_warps, ...; a lane a pixel.  Writes each pixel's image to
// out (height, width, 3), adds the pixels' scene cotangent for the pixel
// cotangent g (height, width, 3) to the warp's table T (SCENE_ROWS, n),
// and returns this lane's rays.  `tape` holds grad_batch(p) * max_depth
// slots of the warp's lanes; `ws` is the warp's scratch
// (grad_scratch_words).
//
// Each lane traces grad_batch(p) samples of its pixel forward, back to
// back, storing their carries.  Then the warp sweeps the batch's samples
// in reverse as a queue: sample j of lane o is item j * width + o, and a
// lane whose sample is done takes the next item, whichever lane traced
// it, so that the lanes stay busy until the queue runs out (a lane with
// nothing left only takes part in the collectives).  Which lane sweeps
// which sample follows from the depths alone, so the order of every add
// is the same from launch to launch.  Under a one-lane warp the samples
// are swept in order after their forward traces, and the adds come in
// grad_pixel's order.
template <bool kSoft = false, class W, class Cnt, class View, class Tab,
          class Tape>
TPT_WARP unsigned long long grad_tiles(const W& w, const View& S,
                                       const float* cam,
                                       const RenderParams& p, const float* g,
                                       float* out, Tab T,
                                       const Tape& tape, float* ws,
                                       int warp, int n_warps, Cnt& cnt) {
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  const int WD = W::kWidth;
  const int TW = GradTile<W::kWidth>::kW, TH = GradTile<W::kWidth>::kH;
  const int tiles_x = (p.width + TW - 1) / TW;
  const int n_tiles = tiles_x * ((p.height + TH - 1) / TH);
  const int lane = w.lane();
  float* s_g = ws;                                    // (WD, 3)
  int* s_depth = reinterpret_cast<int*>(ws + 3 * WD);  // (kGradBatch, WD)
  unsigned long long total = 0;
  for (int tile = warp; tile < n_tiles; tile += n_warps) {
    const int px = (tile % tiles_x) * TW + lane % TW;
    const int py = (tile / tiles_x) * TH + lane / TW;
    const bool valid = px < p.width && py < p.height;
    const int x = p.x0 + px, y = p.y0 + py;
    const size_t o = valid ? (static_cast<size_t>(py) * p.width + px) * 3 : 0;
    uint32_t st = seed_pixel((uint32_t)x, (uint32_t)y, p.frame);
    uint32_t rays = 0;
    // img = (sum of sample radiances) * inv_spp
    for (int c = 0; c < 3; ++c)
      s_g[3 * lane + c] = valid ? g[o + c] * p.inv_spp : 0.0f;
    V3 sum = zero;
    const int batch = grad_batch(p);
    for (int s0 = 0; s0 < p.spp; s0 += batch) {
      const int nb = p.spp - s0 < batch ? p.spp - s0 : batch;
      long long c0 = 0;
      if constexpr (Cnt::kOn) c0 = w.clock();
      for (int j = 0; j < nb; ++j) {
        int depth = 0;
        if (valid) {
          V3 ro0, rd0;
          sample_ray(cam, p, x, y, st, ro0, rd0);
          sum = add(sum, trace_sample_tape(S, p, ro0, rd0, st, rays, depth,
                                           tape, j * p.max_depth));
        }
        s_depth[j * WD + lane] = depth;
      }
      w.sync();
      if constexpr (Cnt::kOn) {
        const long long c1 = w.clock();
        cnt.add(kGcCycFwd, c1 - c0);
        c0 = c1;
      }
      const int n_items = nb * WD;
      int cursor = 0;  // the next item to hand out
      bool has = false;
      int item = 0, d = -1;
      V3 G = zero, g_atten = zero, g_ro = zero, g_rd = zero;
      for (;;) {
        // lanes without a sample take the next items of the queue
        for (;;) {
          const unsigned need = w.ballot(!has);
          if (!need || cursor >= n_items) break;
          const int rank = popc(need & ((1u << lane) - 1u));
          if (!has && cursor + rank < n_items) {
            item = cursor + rank;
            d = s_depth[item] - 1;
            if (d >= 0) {  // else: an empty pixel; ask again
              const int owner = item % WD;
              has = true;
              G = v3(s_g[3 * owner], s_g[3 * owner + 1], s_g[3 * owner + 2]);
              g_atten = g_ro = g_rd = zero;
            }
          }
          cursor += popc(need);
        }
        if (!w.any(has)) break;
        Carry k;
        k.ro = k.rd = k.e = zero;
        k.st = 0;
        typename Tape::Rec rec = Tape::none();  // id -1
        V3 g_e = zero, g_c = zero;
        if (has) {
          k = tape.get(item % WD, (item / WD) * p.max_depth + d, rec);
          // col += atten * e; atten *= c -- reversed
          g_e = mul(k.atten, G);
          g_c = mul(g_atten, k.atten);
          g_atten = add(mul(G, k.e), mul(g_atten, carry_c(S, rec)));
        }
        bounce_adj_warp<kSoft>(w, S, p, has, k.ro, k.rd, k.st, rec, k.e, g_e,
                               g_c, g_ro, g_rd, T, cnt);
        if constexpr (Cnt::kOn) {
          cnt.add(kGcAdjBounces, has ? 1 : 0);
          cnt.add(kGcAdjSlots, 1);
        }
        if (has && --d < 0) has = false;
      }
      w.sync();  // the next batch rewrites s_depth
      if constexpr (Cnt::kOn) cnt.add(kGcCycAdj, w.clock() - c0);
    }
    if (valid) {
      out[o] = sum.x * p.inv_spp;
      out[o + 1] = sum.y * p.inv_spp;
      out[o + 2] = sum.z * p.inv_spp;
      total += rays;
    }
  }
  return total;
}

}  // namespace tpt
