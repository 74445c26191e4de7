// The flat scene's traversals for the merged path loop (csrc/merged.cuh):
// the render kernel K1 on the main path, csrc/render.cu's
// merged_render_kernel, which K4 also runs.
//
// Why.  In the per-thread kernel (render_kernel<0>: tpt::render_pixel, a
// thread a pixel) a warp runs each sample's bounce loop as long as its
// deepest lane, and NEE only on the lanes that hit a Lambert sphere while
// the metal and dielectric lanes idle: the stats render kernel (K2)
// measured half of a warp's lane-steps busy.  Here the warp runs the
// merged loop, every lane a ray each iteration, refilled from 16x2 tiles,
// and:
//   1. nearest_hit_warp: the sphere loop the warp's 32 lanes run together,
//      one 16-byte (cx, cy, cz, r^2) record a sphere, every lane reading
//      the same record (a broadcast); the square root only where the
//      discriminant is positive, where sphere_t uses its value.
//   2. nee_warp: the lanes' shadow rays, light by light in emissive-id
//      order (the draws of trace.cuh nee), are compacted across lights
//      into a per-warp queue, and the warp tests them 32 at a time, each
//      lane one ray's occlusion loop; then each lane adds its visible
//      lights in emissive-id order.  Lights go in groups of kNeeGroup, so
//      the per-warp scratch is bounded whatever the light count.
// The image and the ray count are bit-equal to render_pixel's: the same
// arithmetic in the same order for each ray.
//
// The table lives where the kernel put it: staged in shared memory up to
// kMaxSpheres, read from device memory (through L1) beyond; the code is the
// same, only the view's pointers differ.  The square root stays behind the
// discriminant's branch: computed for every sphere, as sphere_t does, it
// made the kernel slower in its timings on an H100 (PERF.md).
//
// Tensor cores do not serve the sphere test: a matrix-product form of c.d
// and c.o rounds differently from (c - o) first under -fmad=false (see
// coop.cuh).

#pragma once

#include "merged.cuh"

namespace tpt {

// The flat scene as the merged kernel reads it: SceneView's table, plus
// the sphere records and this warp's NEE scratch.
struct FlatView : SceneView {
  const Sphere4* sph;
  float* nee;
};

// Lights whose shadow rays one pass of nee_warp holds.
constexpr int kNeeGroup = 4;

// Words of per-warp scratch nee_warp keeps for n_lights lights and a warp
// of `width` lanes: each (light, lane) pair's direction, t_l and cone
// cosine, the queue of candidate pairs, and per light the occluded lanes.
TPT_HD int flat_nee_words(int n_lights, int width) {
  const int g = n_lights < kNeeGroup ? n_lights : kNeeGroup;
  return g * (6 * width + 1);
}

// The nearest hit of each lane's ray (trace.cuh nearest_hit), every lane
// of the warp together; lanes with part false get -1.
template <class W, class Cnt>
TPT_WARP int nearest_hit_warp(const W&, const FlatView& S, bool part, V3 ro,
                              V3 rd, float t_min, float t_max, float& hit_t,
                              Cnt&) {
  int id = -1;
  hit_t = t_max;
  for (int i = 0; i < S.n; ++i) {
    const Sphere4 s = S.sph[i];
    const float cox = s.x - ro.x;
    const float coy = s.y - ro.y;
    const float coz = s.z - ro.z;
    const float nb = cox * rd.x + coy * rd.y + coz * rd.z;
    const float c = cox * cox + coy * coy + coz * coz - s.r2;
    const float discr = nb * nb - c;
    if (part && discr > 0.0f) {  // sphere_t's root, its value unused else
      const float ds = sqrtf(discr);
      const float t0 = nb - ds;
      const float t = t0 > t_min ? t0 : nb + ds;
      if (t > t_min && t < hit_t) {
        hit_t = t;
        id = i;
      }
    }
  }
  return id;
}

// trace.cuh occluded on the records, the overlap test written out: a
// helper function for it, or testing two or four spheres before the exit,
// made the kernel slower in its timings on an H100 (PERF.md).
TPT_HD bool occluded_flat(const FlatView& S, V3 pos, V3 l, int light,
                          float t_min, float t_l) {
  for (int i = 0; i < S.n; ++i) {
    const Sphere4 s = S.sph[i];
    const float cox = s.x - pos.x;
    const float coy = s.y - pos.y;
    const float coz = s.z - pos.z;
    const float c = cox * cox + coy * coy + coz * coz - s.r2;
    const float nb = cox * l.x + coy * l.y + coz * l.z;
    const float d = nb * nb - c;
    const float a = nb - t_min;
    const float b = nb - t_l;
    if (d > 0.0f && d > b * fabsf(b) && d > -(a * fabsf(a)) && i != light)
      return true;
  }
  return false;
}

// NEE (trace.cuh nee) for the warp: item 2 above.  Every lane calls it;
// lanes with lambert false draw and count nothing and get 0.  A counter
// with kTape set (the tape instance of csrc/render.cu) receives each
// Lambert lane's seen lights, 32 to a word (see_word), for any number of
// lights; kTape false compiles to the loop without it.
template <class W, class Cnt>
TPT_WARP V3 nee_warp(const W& w, const FlatView& S, const RenderParams& p,
                     bool lambert, V3 pos, V3 normal, V3 rd, V3 alb,
                     int hit_id, uint32_t& st, uint32_t& rays, Cnt& cnt) {
  const int WD = W::kWidth;
  const int lane = w.lane();
  const int G = S.n_lights < kNeeGroup ? S.n_lights : kNeeGroup;
  float* lx = S.nee;
  float* ly = lx + G * WD;
  float* lz = ly + G * WD;
  float* tl = lz + G * WD;
  float* cm = tl + G * WD;
  int* queue = reinterpret_cast<int*>(cm + G * WD);
  unsigned* occ = reinterpret_cast<unsigned*>(queue + G * WD);
  V3 light_e = v3(0.0f, 0.0f, 0.0f);
  const V3 nl = dot(normal, rd) < 0.0f ? normal : neg(normal);
  uint32_t word = 0;  // kTape: the seen lights of the current 32
  for (int k0 = 0; k0 < S.n_lights; k0 += G) {
    const int g = S.n_lights - k0 < G ? S.n_lights - k0 : G;
    // the lanes' shadow rays of this group's lights, light by light
    unsigned cands = 0;
    int n_q = 0;
    for (int j = 0; j < g; ++j) {
      const int e = S.lights[k0 + j];
      bool cand = false;
      if (lambert && e != hit_id) {  // self-skip (hlsl:204)
        const float eps1 = rand01(st);
        const float eps2 = rand01(st);
        ++rays;
        const Cone q = cone(S, e, pos, eps1, eps2);
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
      if (cand) {
        cands |= 1u << j;
        queue[n_q + popc(m & ((1u << lane) - 1u))] = j * WD + lane;
      }
      if (lane == 0) occ[j] = 0;
      n_q += popc(m);
    }
    w.sync();
    // their occlusion loops, a warp's width of rays at a time
    long long c0 = 0;
    if constexpr (Cnt::kOn) c0 = w.clock();
    for (int b = 0; b < n_q; b += WD) {
      const int i = b + lane;
      const bool valid = i < n_q;
      const int code = valid ? queue[i] : lane;
      const int owner = code % WD;
      const V3 o = v3(w.shfl(pos.x, owner), w.shfl(pos.y, owner),
                      w.shfl(pos.z, owner));
      if (valid && occluded_flat(S, o, v3(lx[code], ly[code], lz[code]),
                                 S.lights[k0 + code / WD], p.t_min,
                                 tl[code]))
        w.or_mask(occ + code / WD, 1u << owner);
    }
    if constexpr (Cnt::kOn) cnt.add(kStCycShadow, w.clock() - c0);
    w.sync();
    // the visible lights' contributions, in light order
    for (int j = 0; j < g; ++j) {
      if constexpr (Cnt::kTape) {
        const int k = k0 + j;
        if (((cands >> j) & 1u) && !((occ[j] >> lane) & 1u))
          word |= 1u << (k & 31);
        if ((k & 31) == 31 || k == S.n_lights - 1) {
          if (lambert) cnt.see_word(k >> 5, word);
          word = 0;
        }
      }
      if (!((cands >> j) & 1u) || ((occ[j] >> lane) & 1u)) continue;
      const int e = S.lights[k0 + j];
      const int i = j * WD + lane;
      const V3 l = v3(lx[i], ly[i], lz[i]);
      const float omega = TPT_TWO_PI * (1.0f - cm[i]);
      const float fac = max0(dot(l, nl)) * omega / TPT_PI;
      const V3 em =
          v3(S.at(ROW_EM, e), S.at(ROW_EM + 1, e), S.at(ROW_EM + 2, e));
      light_e = v3(light_e.x + (alb.x * em.x) * fac,
                   light_e.y + (alb.y * em.y) * fac,
                   light_e.z + (alb.z * em.z) * fac);
    }
    w.sync();
  }
  return light_e;
}

}  // namespace tpt
