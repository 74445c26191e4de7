// Issue-rate probe (T1) and its launch floor (T2): the per-thread code of
// csrc/probe.cu, the port of tools/vpu_roofline.py's Pallas kernels
// (run_case, measure_floor).
//
// Each case is one step of an accumulator chain, the op classes the render
// kernel issues: fma, compare+select, sqrt, division, reciprocal square
// root and a render-like mix (vpu_roofline.py:70-118).  A thread runs
// kChains independent chains for `trips` trips, enough independent work to
// hide each instruction's latency, and folds the chains into its output so
// nothing is dead.  The op counts per chain-trip follow vpu_roofline.py's
// convention (toypathtracer_torch/tools/roofline.py CASES): a multiply-add
// is one op, a select two (compare and select), sqrt/div/rsqrt of an
// (abs, add)-prepared operand three.
//
// `fma` calls fmaf, so it measures the FFMA rate.  The other cases build
// with the kernels' own flags (-fmad=false, accurate sqrtf, IEEE division,
// 1.0f/sqrtf for rsqrt as trace.cuh writes it), so `render_mix` issues what
// the render kernel's code issues: its a * k + x is a multiply and an add.
//
// __host__ __device__ and free of CUDA-only constructs, so the tests build
// it with g++ and hold it against the plain versions.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define TPT_PROBE_HD __host__ __device__ __forceinline__
#else
#define TPT_PROBE_HD inline
#endif

namespace tpt {
namespace probe {

constexpr int kChains = 8;
enum Case { FMA = 0, CMPSEL = 1, SQRT = 2, DIV = 3, RSQRT = 4, MIX = 5,
            N_CASES = 6 };

constexpr float kDecay = 0.999755859375f;  // 1 - 2^-12

template <int kCase>
TPT_PROBE_HD float step(float acc, float x) {
  if constexpr (kCase == FMA) {
    return fmaf(acc, kDecay, x);
  } else if constexpr (kCase == CMPSEL) {
    return acc < x ? acc + x : acc;
  } else if constexpr (kCase == SQRT) {
    return sqrtf(fabsf(acc) + x);
  } else if constexpr (kCase == DIV) {
    return x / (fabsf(acc) + 1.0f);
  } else if constexpr (kCase == RSQRT) {
    return 1.0f / sqrtf(fabsf(acc) + x);
  } else {
    // ~70% multiply/add, ~20% compare/select, ~10% special: 4 multiply-adds
    // (1 op each), 2 selects (2 each), sqrt(abs + add) (3) = 11 ops
    for (int i = 0; i < 3; ++i) acc = acc * kDecay + x;
    acc = acc > x ? acc : acc + x;
    acc = acc * 0.5f + 0.1f;
    acc = acc < 8.0f ? acc : acc - x;
    return sqrtf(fabsf(acc) + 0.25f);
  }
}

// Thread i's chain input: 1 + 2^-12 (vpu_roofline.py's constant) plus
// (i mod 1024) * 2^-10, exact in float32, so threads differ.
TPT_PROBE_HD float thread_x(uint32_t i) {
  return 1.000244140625f + (float)(i & 1023u) * 0.0009765625f;
}

// One thread's work: kChains chains from x * (0.5 + c/16), `trips` steps
// each, summed in chain order.
template <int kCase>
TPT_PROBE_HD float chains(float x, int trips) {
  float acc[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) acc[c] = x * (0.5f + 0.0625f * (float)c);
  for (int t = 0; t < trips; ++t) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) acc[c] = step<kCase>(acc[c], x);
  }
  float out = acc[0];
#pragma unroll
  for (int c = 1; c < kChains; ++c) out = out + acc[c];
  return out;
}

}  // namespace probe
}  // namespace tpt
