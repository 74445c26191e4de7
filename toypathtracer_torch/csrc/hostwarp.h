// A warp of 32 host threads for the g++ tests of the warp-level code
// (csrc/merged.cuh with flat.cuh, csrc/gradwarp.cuh): the warp policy of
// csrc/warp.cuh with DeviceWarp's collectives, each a barrier, an exchange
// through shared slots and a second barrier, so that a collective that not
// every lane reaches stalls the warp.  A lane arrives with an atomic count;
// the last one advances the generation, and the others yield a few times
// before they sleep on the condition variable (a barrier that only slept
// made the 32-thread tests wait on the scheduler twice a collective).  A
// barrier that waits 20 s marks the warp broken and every later one
// returns at once; the caller reports the run as stalled.  Host code
// only: the card never includes it.

#pragma once

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <mutex>
#include <thread>

namespace tpt {

struct Lanes {
  std::mutex m;
  std::condition_variable cv;
  std::atomic<int> count{0};
  std::atomic<unsigned> gen{0};
  std::atomic<bool> broken{false};
  int ikey[32];
  float f[32];
  unsigned u[32];
  void wait() {
    if (broken.load(std::memory_order_acquire)) return;
    const unsigned g = gen.load(std::memory_order_acquire);
    if (count.fetch_add(1, std::memory_order_acq_rel) == 31) {
      count.store(0, std::memory_order_relaxed);
      {
        std::lock_guard<std::mutex> l(m);
        gen.store(g + 1, std::memory_order_release);
      }
      cv.notify_all();
      return;
    }
    for (int i = 0; i < 64; ++i) {
      if (gen.load(std::memory_order_acquire) != g) return;
      std::this_thread::yield();
    }
    std::unique_lock<std::mutex> l(m);
    if (!cv.wait_for(l, std::chrono::seconds(20), [&] {
          return gen.load(std::memory_order_acquire) != g ||
                 broken.load(std::memory_order_acquire);
        })) {
      broken.store(true, std::memory_order_release);
      cv.notify_all();
    }
  }
};

struct ThreadWarp {
  static constexpr int kWidth = 32;
  static constexpr int kTileW = 16, kTileH = 2;
  Lanes* L;
  int lane_;
  int lane() const { return lane_; }
  unsigned ballot(bool b) const {
    L->u[lane_] = b;
    L->wait();
    unsigned m = 0;
    for (int l = 0; l < 32; ++l) m |= L->u[l] ? 1u << l : 0u;
    L->wait();
    return m;
  }
  bool any(bool b) const { return ballot(b) != 0; }
  unsigned match_any(int key) const {
    L->ikey[lane_] = key;
    L->wait();
    unsigned m = 0;
    for (int l = 0; l < 32; ++l) m |= L->ikey[l] == key ? 1u << l : 0u;
    L->wait();
    return m;
  }
  float shfl(float v, int src) const {
    L->f[lane_] = v;
    L->wait();
    const float r = L->f[src];
    L->wait();
    return r;
  }
  int shfl(int v, int src) const {
    L->ikey[lane_] = v;
    L->wait();
    const int r = L->ikey[src];
    L->wait();
    return r;
  }
  float shfl_xor(float v, int m) const { return shfl(v, lane_ ^ m); }
  int shfl_xor(int v, int m) const { return shfl(v, lane_ ^ m); }
  unsigned reduce_max(unsigned v) const {
    L->u[lane_] = v;
    L->wait();
    unsigned r = 0;
    for (int l = 0; l < 32; ++l) r = L->u[l] > r ? L->u[l] : r;
    L->wait();
    return r;
  }
  unsigned reduce_add(unsigned v) const {
    L->u[lane_] = v;
    L->wait();
    unsigned r = 0;
    for (int l = 0; l < 32; ++l) r += L->u[l];
    L->wait();
    return r;
  }
  void sync() const { L->wait(); }
  long long clock() const { return 0; }
  // The next value of a launch-wide counter, for the whole warp.
  int grab(int* counter) const {
    return shfl(lane_ == 0 ? (*counter)++ : 0, 0);
  }
  void or_mask(unsigned* p, unsigned bits) const {
    __atomic_fetch_or(p, bits, __ATOMIC_RELAXED);
  }
};

}  // namespace tpt
