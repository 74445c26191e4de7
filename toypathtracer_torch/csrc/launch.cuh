// Host-side launch helpers of the kernels' C interfaces (csrc/render.cu,
// grad.cu, scaled.cu).

#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <vector>

namespace tpt {

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// As many blocks of the persistent kernel `timed` (`threads` a block,
// `smem` bytes of dynamic shared memory) as fit on the current device at
// once, after the shared-memory opt-in of `timed` and of each of `also`,
// its instrumented instances, which are launched with its block count so
// that they deal work as it does.  The opt-ins and the occupancy query run
// once for each kernel, device and size; later calls read the cache.
template <class Timed, class... Also>
cudaError_t cached_capacity(int threads, size_t smem, int* capacity,
                            Timed timed, Also... also) {
  struct Entry {
    const void* fn;
    int dev;
    size_t smem;
    int capacity;
  };
  static std::mutex lock;
  static std::vector<Entry> cache;
  const void* fn = reinterpret_cast<const void*>(timed);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  for (const Entry& e : cache)
    if (e.fn == fn && e.dev == dev && e.smem == smem) {
      *capacity = e.capacity;
      return cudaSuccess;
    }
  err = allow_smem(timed, smem);
  ((err = err == cudaSuccess ? allow_smem(also, smem) : err), ...);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, timed,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  cache.push_back({fn, dev, smem, sms * per_sm});
  *capacity = sms * per_sm;
  return cudaSuccess;
}

}  // namespace tpt
