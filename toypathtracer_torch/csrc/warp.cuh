// The warp policies that the warp-level code of csrc/coop.cuh (the scaled
// render) and csrc/gradwarp.cuh (the gradient kernel) is written against:
// DeviceWarp on the card, whose collectives are the warp intrinsics, and
// HostLane, a warp of one lane for the g++ tests, under which every
// collective is the identity and the warp code is the sequential loop.
// Every lane of a warp calls each collective at the same point.

#pragma once

#include "trace.cuh"

#ifdef __CUDACC__
#define TPT_WARP __device__ __forceinline__
#else
#define TPT_WARP inline
#endif

namespace tpt {

TPT_HD int popc(unsigned m) {
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

// Index of the lowest set bit of a non-zero mask.
TPT_HD int lowest(unsigned m) {
#ifdef __CUDA_ARCH__
  return __ffs(m) - 1;
#else
  return __builtin_ffs(static_cast<int>(m)) - 1;
#endif
}

struct HostLane {
  static constexpr int kWidth = 1;
  static constexpr int kTileW = 1, kTileH = 1;
  int lane() const { return 0; }
  unsigned ballot(bool b) const { return b ? 1u : 0u; }
  bool any(bool b) const { return b; }
  unsigned match_any(int) const { return 1u; }
  float shfl(float v, int) const { return v; }
  int shfl(int v, int) const { return v; }
  float shfl_xor(float v, int) const { return v; }
  int shfl_xor(int v, int) const { return v; }
  unsigned reduce_max(unsigned v) const { return v; }
  unsigned reduce_add(unsigned v) const { return v; }
  void sync() const {}
  void or_mask(unsigned* p, unsigned bits) const { *p |= bits; }
  long long clock() const { return 0; }
  int grab(int* counter) const { return (*counter)++; }
};

#ifdef __CUDACC__
// The warp of the calling thread; pixels come in 16x2 tiles.
struct DeviceWarp {
  static constexpr unsigned kFull = 0xffffffffu;
  static constexpr int kWidth = 32;
  static constexpr int kTileW = 16, kTileH = 2;
  int lane_;
  __device__ explicit DeviceWarp(int tid) : lane_(tid & 31) {}
  __device__ int lane() const { return lane_; }
  __device__ unsigned ballot(bool b) const { return __ballot_sync(kFull, b); }
  __device__ bool any(bool b) const { return __any_sync(kFull, b); }
  // The lanes whose key equals this lane's.
  __device__ unsigned match_any(int key) const {
    return __match_any_sync(kFull, key);
  }
  __device__ float shfl(float v, int src) const {
    return __shfl_sync(kFull, v, src);
  }
  __device__ int shfl(int v, int src) const {
    return __shfl_sync(kFull, v, src);
  }
  __device__ float shfl_xor(float v, int m) const {
    return __shfl_xor_sync(kFull, v, m);
  }
  __device__ int shfl_xor(int v, int m) const {
    return __shfl_xor_sync(kFull, v, m);
  }
  __device__ unsigned reduce_max(unsigned v) const {
    return __reduce_max_sync(kFull, v);
  }
  __device__ unsigned reduce_add(unsigned v) const {
    return __reduce_add_sync(kFull, v);
  }
  // Orders this warp's shared-memory writes before its later reads.
  __device__ void sync() const { __syncwarp(); }
  __device__ long long clock() const { return clock64(); }
  // The next value of a launch-wide counter, for the whole warp.
  __device__ int grab(int* counter) const {
    int v = 0;
    if (lane_ == 0) v = atomicAdd(counter, 1);
    return __shfl_sync(kFull, v, 0);
  }
  __device__ void or_mask(unsigned* p, unsigned bits) const {
    atomicOr(p, bits);
  }
};
#endif

}  // namespace tpt
