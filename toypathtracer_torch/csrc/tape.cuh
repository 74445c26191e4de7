// The frame tape of the gradient's tape-writing forwards and the reverse
// sweeps that read it: each bounce's carry record at a slot indexed by
// (pixel, sample, bounce) of the sub-image, written by the merged path loop
// (csrc/merged.cuh) through a TapeSink counter.  Two forwards write it:
// the scaled render's tape instance (csrc/scaled.cu tape_render_kernel, on
// coop.cuh's traversals) and K1's (csrc/render.cu merged_render_kernel's
// tape instance, on flat.cuh's); coopgrad.cuh's sweep_tiles reads it back
// (csrc/chunkgrad.cu over the chunked scene, csrc/wavegrad.cu over the
// flat one).  It needs no traversal, so render.cu includes it without
// coop.cuh.

#pragma once

#include <string.h>

#include "gradwarp.cuh"

namespace tpt {

// The forward's records: 16 words a bounce, laid out as WideTape's (ro,
// rd, t, RNG state, flags with id -1, e, atten, id + 1), at slot ((pixel *
// spp) + sample) * max_depth + bounce of the sub-image's pixels, the seen
// lights in light_words(n_lights) words a slot, and the bounces of each
// (pixel, sample).
struct FrameTape {
  using Rec = BounceRecOf<LightBits>;
  float* rec;
  uint32_t* see;
  int32_t* depth;
  int words, spp, max_depth, width;
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
  TPT_HD size_t slot(int pix, int s, int d) const {
    return (static_cast<size_t>(pix) * spp + s) * max_depth + d;
  }
  TPT_HD LightBits bits(size_t slot) const {
    return LightBits{see + slot * words};
  }
  TPT_HD static Rec none() {
    return with_bits(unpack_rec(0u, 0.0f), LightBits{nullptr});
  }
  TPT_HD static uint32_t flags(bool scattered, bool gated, bool refl) {
    BounceRec b = unpack_rec(0u, 0.0f);
    b.scattered = scattered;
    b.gated = gated;
    b.refl = refl;
    return pack_rec(b);
  }
  // trace_sample_tape's interface: the reference the g++ tests write
  TPT_HD void bind(Rec& r, size_t slot) const { r.see = bits(slot); }
  TPT_HD void put(size_t slot, const Carry& c, const Rec& r) const {
    float* q = rec + slot * kRecWords;
    const float w[kRecWords] = {
        c.ro.x, c.ro.y, c.ro.z, c.rd.x, c.rd.y, c.rd.z, c.t, as_float(c.st),
        as_float(flags(r.scattered, r.gated, r.refl)), c.e.x, c.e.y, c.e.z,
        c.atten.x, c.atten.y, c.atten.z,
        as_float(static_cast<uint32_t>(r.id + 1))};
    for (int j = 0; j < kRecWords; ++j) q[j] = w[j];
  }
  // The record at `slot` and, in r, its bounce record.
  TPT_HD Carry get(size_t slot, Rec& r) const {
    const float* q = rec + slot * kRecWords;
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
    BounceRec b = unpack_rec(c.bits, c.t);
    b.id = static_cast<int>(as_bits(w[15])) - 1;
    r = with_bits(b, bits(slot));
    return c;
  }
};

// The merged loop's counter that writes the FrameTape (merged.cuh kTape):
// one per lane, holding the slot of the bounce its lane traces.
struct TapeSink {
  static constexpr bool kOn = false;
  static constexpr bool kTrips = false;
  static constexpr bool kTape = true;
  FrameTape tape;
  size_t cur = 0;
  int id = -1;
  float t = 0.0f;
  bool gated = false, took = false;
  TPT_HD void add(int, unsigned long long) {}
  // the bounce's inputs, before it runs; its seen lights start empty
  TPT_HD void head(bool busy, int px, int py, int s, int d, V3 ro, V3 rd,
                   uint32_t st, V3 atten) {
    if (!busy) return;
    cur = tape.slot(py * tape.width + px, s, d);
    float* q = tape.rec + cur * kRecWords;
    q[0] = ro.x;
    q[1] = ro.y;
    q[2] = ro.z;
    q[3] = rd.x;
    q[4] = rd.y;
    q[5] = rd.z;
    q[7] = FrameTape::as_float(st);
    q[12] = atten.x;
    q[13] = atten.y;
    q[14] = atten.z;
    for (int i = 0; i < tape.words; ++i) tape.see[cur * tape.words + i] = 0u;
  }
  TPT_HD void hit(int id_, float t_, bool gated_) {
    id = id_;
    t = t_;
    gated = gated_;
    took = false;
  }
  TPT_HD void refl(bool r) { took = r; }
  TPT_HD void see_word(int i, uint32_t word) const {
    tape.see[cur * tape.words + i] = word;
  }
  // the bounce's outputs: its root, flags, emission and hit
  TPT_HD void tail(bool busy, bool go, V3 e) const {
    if (!busy) return;
    float* q = tape.rec + cur * kRecWords;
    q[6] = t;
    q[8] = FrameTape::as_float(FrameTape::flags(go, gated, took));
    q[9] = e.x;
    q[10] = e.y;
    q[11] = e.z;
    q[15] = FrameTape::as_float(static_cast<uint32_t>(id + 1));
  }
  TPT_HD void sample_depth(int px, int py, int s, int d) const {
    tape.depth[static_cast<size_t>(py * tape.width + px) * tape.spp + s] = d;
  }
};

}  // namespace tpt
