// The cooperative form of the scaled scene's gradient (csrc/chunkgrad.cu):
// K3 over chunks split in two kernels, its forward on the scaled render's
// warp-cooperative path loop and its reverse sweep reading what the forward
// wrote, with the soft estimator's chunk scans run as warp walks.
//
// Why.  The per-lane chunked instance (csrc/grad.cu chunk_grad_kernel:
// grad_tiles over chunks.cuh's GradChunkedView) traces each sample forward
// lane by lane through the per-lane chunk walks (the design the scaled render
// left behind: 169.5 ms a frame against the cooperative form's 49.18 on an
// H100), and runs each soft scan -- a missed ray's silhouette candidate, a
// Lambert bounce's shadow-boundary occluder per light -- as a per-lane loop
// over every chunk's inflated box.  Here:
//   1. the forward is the scaled render kernel's merged loop
//      (merged.cuh render_tiles_merged with coop.cuh's nearest_hit_warp
//      and nee_warp) with a TapeSink: each bounce's carry record goes to a
//      frame-sized FrameTape (tape.cuh) indexed by (pixel, sample,
//      bounce), and each sample's bounces beside it.  The image and rays
//      are the scaled render kernel's, bit for bit, and each record holds
//      what trace.cuh's trace_sample_tape stores for that bounce (the ray,
//      the RNG state and attenuation it started from, its root, hit and
//      flags, its seen lights, its emission): a lane traces the same ray
//      with the same arithmetic whichever lane of whichever warp takes its
//      sample.
//   2. the reverse sweep (sweep_tiles) is gradwarp.cuh grad_tiles' reverse
//      half over the FrameTape: the same tiles dealt to the same warps, the
//      same sample batches and queue, so each warp's PoolTable takes the
//      same adds in the same order and the cotangent is the per-lane
//      chunked instance's bit for bit on the same grid.
//   3. the soft scans walk the chunks as the cooperative K6 does
//      (coop.cuh walk_chunks): the inflated boxes in a Morton order of
//      the chunks (scaled.walk_order, chunk_index's) with group boxes over
//      runs of kGroup, each lane slab-testing its own ray, a ballot
//      skipping a chunk no lane enters, the entering lanes' own loops
//      where many entered and the whole warp on one ray at a time where
//      few did.  The winner is the largest d and then the least global
//      id, in any visit order: the sequential scan's first on ties, so
//      the result is bit-equal.  A Lambert bounce's boundary scans, one
//      per light, are compacted across lights, a warp's width of rays a
//      pass (nee_adj_coop), as nee_warp compacts shadow rays.
// Records keep the seen lights in words of their own (LightBits), so any
// number of lights goes.
//
// Everything is written against a warp policy (csrc/warp.cuh), so the g++
// tests run it under HostLane and in 32-thread ThreadWarps.

#pragma once

#include "coop.cuh"
#include "gradwarp.cuh"
#include "tape.cuh"

namespace tpt {

// Lights whose boundary scans one pass of nee_adj_coop holds.
constexpr int kScanGroup = 4;

// Words of per-warp scratch nee_adj_coop keeps for a warp of `width`
// lanes: each (light, lane) pair's shadow direction, t_l, occluder d and
// id, and the queue of pairs to scan, for kScanGroup lights.
TPT_HD int scan_words(int width) { return kScanGroup * 7 * width; }

// The scaled scene as the cooperative sweep reads it: GradChunkedView, a
// spatial walk order (scaled.walk_order) and 16-byte sphere records (in
// the rows' order), each soft scan's inflated boxes in walk order with
// their group boxes over runs of kGroup, and this warp's scratch
// (scan_words).
struct CoopGradView : GradChunkedView {
  const int32_t* order;
  const Sphere4* rec;
  const float* sil_walk;
  const float* sil_gbox;
  const float* prox_walk;
  const float* prox_gbox;
  int n_groups;
  float* scan;
};

template <>
struct coop_scans<CoopGradView> {
  static constexpr bool value = true;
};

// The better of (d, id, nb) and (od, oid, onb): the larger d, then the
// lesser id (a candidate is never taken at d <= -1e9, the scans' start).
TPT_HD void scan_combine(float& d, int& id, float& nb, float od, int oid,
                         float onb) {
  if (od > d || (od == d && oid < id)) {
    d = od;
    id = oid;
    nb = onb;
  }
}

// Spheres j0, j0 + step, ... of a chunk's records r (global ids base..)
// for one ray, as chunks.cuh's scans: kSil, silhouette_candidate's (in
// front of the ray, not padding); else shadow_occluder's (closest approach
// inside (t_min, t_hi), not `light`).  Keeps the better of each and
// (best, bid, bnb).
template <bool kSil>
TPT_HD void scan_chunk(const Sphere4* r, int K, int base, int j0, int step,
                       V3 o, V3 d, float t_min, float t_hi, int light,
                       float& best, int& bid, float& bnb) {
  for (int j = j0; j < K; j += step) {
    const Sphere4 sp = r[j];
    const float cox = sp.x - o.x;
    const float coy = sp.y - o.y;
    const float coz = sp.z - o.z;
    const float nb = cox * d.x + coy * d.y + coz * d.z;
    const float cq = cox * cox + coy * coy + coz * coz - sp.r2;
    const float dd = nb * nb - cq;
    const bool ok = kSil ? nb > t_min && sp.r2 > 0.0f
                         : nb > t_min && nb < t_hi && base + j != light;
    if (ok && (dd > best || (dd == best && base + j < bid))) {
      best = dd;
      bid = base + j;
      bnb = nb;
    }
  }
}

// The chunks a scan walks: one of the soft boxes in walk order and its
// group boxes, as coop.cuh's walk reads them.
TPT_HD CoopView scan_view(const CoopGradView& S, const float* box,
                          const float* gbox) {
  CoopView V;
  V.tab = S.tab;
  V.mat = S.mat;
  V.lights = S.lights;
  V.rows = S.rows;
  V.box = box;
  V.n = S.n;
  V.n_lights = S.n_lights;
  V.chunk = S.chunk;
  V.n_chunks = S.n_chunks;
  V.gbox = gbox;
  V.n_groups = S.n_groups;
  V.nee = nullptr;
  return V;
}

// One scan for each participating lane's ray (o, d), its slab bound t_hi
// and, for the boundary scan, its light: the chunks whose box (in walk
// order) some lane enters, each lane testing its own, a ballot skipping a
// chunk no lane enters; kCoopMin or more entering lanes run their own
// loops over the chunk (a broadcast), fewer are decided one at a time by
// the whole warp, spheres lane, lane + 32, ... a lane and a butterfly over
// (d, id).  Every lane calls it.
template <bool kSil, class W>
TPT_WARP void scan_walk(const W& w, const CoopGradView& S, bool part, V3 o,
                        V3 d, V3 inv, float t_min, float t_hi, int light,
                        const float* box, const float* gbox, float& best,
                        int& bid, float& bnb) {
  const CoopView V = scan_view(S, box, gbox);
  NoCoopCount none;
  const int K = S.chunk;
  const int lane = w.lane();
  walk_chunks(
      w, V, o, inv, t_min, [&] { return t_hi; }, [&] { return part; }, none,
      0, [&](int c, unsigned m, const float*) {
        const int ch = S.order[c];
        const Sphere4* r = S.rec + static_cast<size_t>(ch) * K;
        if (popc(m) >= kCoopMin) {
          if ((m >> lane) & 1u)
            scan_chunk<kSil>(r, K, ch * K, 0, 1, o, d, t_min, t_hi, light,
                             best, bid, bnb);
          return;
        }
        while (m) {
          const int L = lowest(m);
          m &= m - 1;
          const V3 oL = v3(w.shfl(o.x, L), w.shfl(o.y, L), w.shfl(o.z, L));
          const V3 dL = v3(w.shfl(d.x, L), w.shfl(d.y, L), w.shfl(d.z, L));
          float bd = -1e9f, bn = 0.0f;
          int bi = -1;
          scan_chunk<kSil>(r, K, ch * K, lane, W::kWidth, oL, dL, t_min,
                           w.shfl(t_hi, L), w.shfl(light, L), bd, bi, bn);
          for (int off = W::kWidth / 2; off > 0; off >>= 1)
            scan_combine(bd, bi, bn, w.shfl_xor(bd, off), w.shfl_xor(bi, off),
                         w.shfl_xor(bn, off));
          if (lane == L) scan_combine(best, bid, bnb, bd, bi, bn);
        }
      });
}

// chunks.cuh silhouette_candidate for each lane with `part`, the warp
// together: the same candidate, d and nb.
template <class W>
TPT_WARP int silhouette_warp(const W& w, const CoopGradView& S, bool part,
                             V3 ro, V3 rd, float t_min, float& d_best,
                             float& nb_best) {
  int cand = -1;
  d_best = -1e9f;
  nb_best = 0.0f;
  const V3 inv = v3(safe_inv(rd.x), safe_inv(rd.y), safe_inv(rd.z));
  part = part && !any_nan(ro) && !any_nan(inv);
  scan_walk<true>(w, S, part, ro, rd, inv, t_min, 1e7f, -1, S.sil_walk,
                  S.sil_gbox, d_best, cand, nb_best);
  return d_best > -1e8f ? cand : -1;
}

// chunks.cuh shadow_occluder for each lane with `part`, the warp together:
// the same occluder (or -1) and d_occ.
template <class W>
TPT_WARP int occluder_warp(const W& w, const CoopGradView& S, bool part,
                           V3 pos, V3 l, int light, float t_min, float t_l,
                           float& d_occ) {
  int j = -1;
  d_occ = -1e9f;
  float nb = 0.0f;
  const V3 inv = v3(safe_inv(l.x), safe_inv(l.y), safe_inv(l.z));
  part = part && !any_nan(pos) && !any_nan(inv) && !is_nan(t_l);
  scan_walk<false>(w, S, part, pos, l, inv, t_min, t_l, light, S.prox_walk,
                   S.prox_gbox, d_occ, j, nb);
  return j;
}

// gradwarp.cuh nee_adj_warp<true> (the soft shadow boundary) with its
// boundary scans compacted across lights: for kScanGroup lights at a time,
// each lane draws and builds the shadow rays whose boundary term runs
// (nee_adj_warp's draws), the warp scans them a warp's width at a time
// (occluder_warp), and then runs nee_adj_warp's light loop over the group
// with each ray's occluder from the scans, redrawing the same samples.
// The adds are nee_adj_warp's, in its order.  Every lane calls it.
template <class W, class Cnt, class Tab, class See>
TPT_WARP void nee_adj_coop(const W& w, const CoopGradView& S,
                           const RenderParams& p, bool lam, V3 pos,
                           V3 normal, V3 rd, V3 alb, int hit_id, uint32_t st,
                           See see, V3 g_le, const Group& gh, Tab T,
                           V3& g_pos, V3& g_n, Cnt& cnt) {
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  if (!w.any(lam)) return;  // every add would be 0
  const int WD = W::kWidth;
  const int lane = w.lane();
  float* lx = S.scan;
  float* ly = lx + kScanGroup * WD;
  float* lz = ly + kScanGroup * WD;
  float* tl = lz + kScanGroup * WD;
  float* dv = tl + kScanGroup * WD;
  int* jv = reinterpret_cast<int*>(dv + kScanGroup * WD);
  int* queue = jv + kScanGroup * WD;
  const bool front = dot(normal, rd) < 0.0f;
  const V3 nl = front ? normal : neg(normal);
  V3 g_nl = zero;
  for (int k0 = 0; k0 < S.n_lights; k0 += kScanGroup) {
    const int g = S.n_lights - k0 < kScanGroup ? S.n_lights - k0 : kScanGroup;
    long long c0 = 0;
    if constexpr (Cnt::kOn) c0 = w.clock();
    // the shadow rays whose boundary term runs: nee_adj_warp<true> calls
    // shadow_adj_vals where the light is on and dot(l, nl) > 0
    uint32_t s1 = st;
    int n_q = 0;
    for (int j = 0; j < g; ++j) {
      const int e = S.lights[k0 + j];
      const bool on = lam && e != hit_id;
      bool scan = false;
      if (on) {
        const float eps1 = rand01(s1);
        const float eps2 = rand01(s1);
        const Cone q = cone(S, e, pos, eps1, eps2);
        if (dot(q.l, nl) > 0.0f) {
          scan = true;
          float t_l;
          sphere_t(S, e, pos, q.l, p.t_min, t_l);
          const int i = j * WD + lane;
          lx[i] = q.l.x;
          ly[i] = q.l.y;
          lz[i] = q.l.z;
          tl[i] = t_l;
        }
      }
      const unsigned m = w.ballot(scan);
      if (scan) queue[n_q + popc(m & ((1u << lane) - 1u))] = j * WD + lane;
      n_q += popc(m);
    }
    w.sync();
    // their occluders, a warp's width of rays at a time
    for (int b = 0; b < n_q; b += WD) {
      const bool valid = b + lane < n_q;
      const int code = valid ? queue[b + lane] : lane;
      const int owner = code % WD;
      const V3 o = v3(w.shfl(pos.x, owner), w.shfl(pos.y, owner),
                      w.shfl(pos.z, owner));
      const V3 l = valid ? v3(lx[code], ly[code], lz[code]) : zero;
      float d_occ;
      const int occ = occluder_warp(w, S, valid, o, l,
                                    S.lights[k0 + code / WD], p.t_min,
                                    valid ? tl[code] : 0.0f, d_occ);
      if (valid) {
        jv[code] = occ;
        dv[code] = d_occ;
      }
    }
    w.sync();
    if constexpr (Cnt::kOn) cnt.add(kGcCycSoft, w.clock() - c0);
    // nee_adj_warp's light loop over the group
    for (int jj = 0; jj < g; ++jj) {
      const int k = k0 + jj;
      const int e = S.lights[k];
      const bool on = lam && e != hit_id;
      float eps1 = 0.0f, eps2 = 0.0f;
      if (on) {
        eps1 = rand01(st);
        eps2 = rand01(st);
      }
      const bool at = on && ((see >> k) & 1u);
      if (!w.any(on)) continue;  // every add of this light would be 0
      V3 g_alb = zero, g_em = zero, g_sc = zero, g_co = zero;
      float g_r = 0.0f, g_sqr = 0.0f;
      int j = -1;
      if (on) {
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
          // trace.cuh shadow_adj_vals with the scan's occluder
          const int i = jj * WD + lane;
          const int occ = jv[i];
          const float d_occ = dv[i];
          if (occ >= 0 && at == (d_occ < 0.0f)) {
            j = occ;
            discr_adj_vals(S, j, pos, q.l,
                           -soft_grad(-d_occ, p.soft_eps, fac * g_fac),
                           g_pos, g_l, g_co, g_sqr);
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
      const Group gj = make_group(w, j);
      group_add(w, gj, T, S.n, j,
                Adds<4>{{ROW_CX, ROW_CY, ROW_CZ, ROW_SQR},
                        {g_co.x, g_co.y, g_co.z, g_sqr}});
    }
    w.sync();  // the next group rewrites the scratch
  }
  if (lam) g_n = add(g_n, front ? g_nl : neg(g_nl));
}

// The reverse sweep of gradwarp.cuh grad_tiles over the FrameTape ft the
// forward wrote (the image and rays are the forward's): the warp's pixels
// of the (p.height, p.width) sub-image in tiles of GradTile pixels dealt
// round robin by warp index, their samples in batches of grad_batch(p),
// each batch's samples swept in reverse as a queue, exactly as grad_tiles
// does after its forward trace, so the adds to the warp's table T come in
// grad_tiles' order.  g: the pixel cotangent (height, width, 3); ws: the
// warp's scratch (grad_scratch_words).
template <bool kSoft, class W, class Cnt, class View, class Tab>
TPT_WARP void sweep_tiles(const W& w, const View& S, const RenderParams& p,
                          const float* g, Tab T, const FrameTape& ft,
                          float* ws, int warp, int n_warps, Cnt& cnt) {
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  const int WD = W::kWidth;
  const int TW = GradTile<W::kWidth>::kW, TH = GradTile<W::kWidth>::kH;
  const int tiles_x = (p.width + TW - 1) / TW;
  const int n_tiles = tiles_x * ((p.height + TH - 1) / TH);
  const int lane = w.lane();
  float* s_g = ws;                                    // (WD, 3)
  int* s_depth = reinterpret_cast<int*>(ws + 3 * WD);  // (kGradBatch, WD)
  for (int tile = warp; tile < n_tiles; tile += n_warps) {
    const int tx = (tile % tiles_x) * TW, ty = (tile / tiles_x) * TH;
    const int px = tx + lane % TW;
    const int py = ty + lane / TW;
    const bool valid = px < p.width && py < p.height;
    const size_t o = valid ? (static_cast<size_t>(py) * p.width + px) * 3 : 0;
    for (int c = 0; c < 3; ++c)
      s_g[3 * lane + c] = valid ? g[o + c] * p.inv_spp : 0.0f;
    const int batch = grad_batch(p);
    for (int s0 = 0; s0 < p.spp; s0 += batch) {
      const int nb = p.spp - s0 < batch ? p.spp - s0 : batch;
      long long c0 = 0;
      if constexpr (Cnt::kOn) c0 = w.clock();
      for (int j = 0; j < nb; ++j)
        s_depth[j * WD + lane] =
            valid ? ft.depth[(static_cast<size_t>(py) * p.width + px) *
                                 p.spp + s0 + j]
                  : 0;
      w.sync();
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
        FrameTape::Rec rec = FrameTape::none();  // id -1
        V3 g_e = zero, g_c = zero;
        if (has) {
          const int owner = item % WD;
          const int pix = (ty + owner / TW) * p.width + tx + owner % TW;
          k = ft.get(ft.slot(pix, s0 + item / WD, d), rec);
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
  }
}

}  // namespace tpt
