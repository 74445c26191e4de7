// The frame tape of the gradient's tape-writing forwards and the reverse
// sweeps that read it: each bounce's carry record at a slot indexed by
// (pixel, sample, bounce) of the sub-image, written by the merged path loop
// (csrc/merged.cuh) through a tape counter (kTape).  Two forwards write it:
// the scaled render's tape instance (csrc/scaled.cu tape_render_kernel, on
// coop.cuh's traversals, with a TapeSink) and K1's (csrc/render.cu
// merged_render_kernel's tape instances, on flat.cuh's: the staged one
// with a StagedTapeSink, and beside it the TapeSink one it replaced);
// coopgrad.cuh's sweep_tiles reads it back (csrc/chunkgrad.cu over the
// chunked scene, csrc/wavegrad.cu over the flat one).  It needs no
// traversal, so render.cu includes it without coop.cuh.

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

// The merged loop's counter that writes the FrameTape (merged.cuh kTape)
// with a store a word: one per lane, holding the slot of the bounce its
// lane traces.  The 32 lanes of a warp hold 32 different (pixel, sample)
// slots, so each store touches 32 lines, 4 bytes of a sector each.
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
  // the records are written: nothing to hand off
  template <class W>
  TPT_HD void flush(const W&, unsigned) const {}
};

// The n-th (from 0) set bit of m, or -1 where m has no more.
TPT_HD int nth_bit(unsigned m, int n) {
  for (int i = 0; i < n && m; ++i) m &= m - 1u;
  return m ? lowest(m) : -1;
}

// The merged loop's counter that writes the FrameTape through a staging
// slot a lane (kStageWords floats; the warp's W::kWidth slots in shared
// memory on the card): K1's staged tape instance (csrc/render.cu
// merged_render_kernel<4>).  head puts the bounce's inputs in the lane's
// slot before the bounce runs, hit its root and id, tail its flags and
// emission, so no word of the record is carried across the bounce; flush
// (every lane, after tail) hands the busy lanes' records to the tape as
// whole 64-byte lines in 16-byte stores, four lanes a record and
// W::kWidth / 4 records a round, between two warp barriers.  The seen
// lights' words are written once each: by see_word for a Lambert hit, as
// zeros by tail for any other busy lane.  The tape is TapeSink's word for
// word.  Slots are ints: a tape of 2^31 slots would hold 128 GiB of
// records.  Quarter q of lane l's record lies at quarter q ^ ((l / 2) % 4)
// of its staging slot, so that the 8 lanes of a shared-memory phase that
// store the same quarter reach 8 different bank groups.
struct StagedTapeSink {
  static constexpr bool kOn = false;
  static constexpr bool kTrips = false;
  static constexpr bool kTape = true;
  static constexpr int kStageWords = kRecWords;
  FrameTape tape;
  float* stage;  // the warp's slots, kStageWords floats a lane
  int lane = 0;
  int slot = 0;
  bool gated = false, took = false, seen = false;
  TPT_HD float* quarter(int owner, int q) const {
    return stage + owner * kStageWords + ((q ^ ((owner >> 1) & 3)) << 2);
  }
  TPT_HD void put4(int q, float a, float b, float c, float d) const {
    float* o = quarter(lane, q);
#ifdef __CUDA_ARCH__
    *reinterpret_cast<float4*>(o) = make_float4(a, b, c, d);
#else
    o[0] = a;
    o[1] = b;
    o[2] = c;
    o[3] = d;
#endif
  }
  TPT_HD void add(int, unsigned long long) {}
  // the bounce's inputs, before it runs; its root and id come from hit
  TPT_HD void head(bool busy, int px, int py, int s, int d, V3 ro, V3 rd,
                   uint32_t st, V3 atten) {
    if (!busy) return;
    slot = ((py * tape.width + px) * tape.spp + s) * tape.max_depth + d;
    seen = false;
    put4(0, ro.x, ro.y, ro.z, rd.x);
    put4(1, rd.y, rd.z, 0.0f, FrameTape::as_float(st));
    put4(3, atten.x, atten.y, atten.z, 0.0f);
  }
  TPT_HD void hit(int id_, float t_, bool gated_) {
    quarter(lane, 1)[2] = t_;
    quarter(lane, 3)[3] = FrameTape::as_float(static_cast<uint32_t>(id_ + 1));
    gated = gated_;
    took = false;
  }
  TPT_HD void refl(bool r) { took = r; }
  TPT_HD void see_word(int i, uint32_t word) {
    tape.see[static_cast<size_t>(slot) * tape.words + i] = word;
    seen = true;
  }
  // the bounce's outputs: its flags and emission; a busy lane whose seen
  // lights no see_word wrote saw none
  TPT_HD void tail(bool busy, bool go, V3 e) const {
    if (!busy) return;
    put4(2, FrameTape::as_float(FrameTape::flags(go, gated, took)), e.x,
         e.y, e.z);
    if (!seen)
      for (int i = 0; i < tape.words; ++i)
        tape.see[static_cast<size_t>(slot) * tape.words + i] = 0u;
  }
  TPT_HD void sample_depth(int px, int py, int s, int d) const {
    tape.depth[static_cast<size_t>(py * tape.width + px) * tape.spp + s] = d;
  }
  // The busy lanes' (bm) records from their slots to the tape.  Every
  // lane of the warp calls it.
  template <class W>
  TPT_WARP void flush(const W& w, unsigned bm) const {
    w.sync();
    const int n = 4 * popc(bm);
    for (int base = 0; base < n; base += W::kWidth) {
      const int i = base + w.lane();
      const int owner = i < n ? nth_bit(bm, i >> 2) : w.lane();
      const int at = w.shfl(slot, owner);
      if (i < n) {
        const float* src = quarter(owner, i & 3);
        float* dst = tape.rec + static_cast<size_t>(at) * kRecWords +
                     ((i & 3) << 2);
#ifdef __CUDA_ARCH__
        *reinterpret_cast<float4*>(dst) =
            *reinterpret_cast<const float4*>(src);
#else
        for (int j = 0; j < 4; ++j) dst[j] = src[j];
#endif
      }
    }
    w.sync();
  }
};

}  // namespace tpt
