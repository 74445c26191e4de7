// Issue-rate probe kernels for NVIDIA Hopper (sm_90a): the port of the TPU
// kernels of tools/vpu_roofline.py, run_case (T1, :125) and measure_floor
// (T2, :162).
//
// T1: probe_kernel<case>, one thread per grid slot, 256 threads a block,
// runs tpt::probe::chains (probe.cuh) for `trips` trips and writes one
// float.  The wrapper (toypathtracer_torch/tools/roofline.py) sizes the
// grid in waves of full occupancy (8 blocks of 256 threads on every SM),
// so every SM's four schedulers always have warps to issue from; the TPU's
// grid of (32, 128) blocks has no meaning here.  Bound: instruction issue
// and the pipe of each case's op class (FP32 128, compare 64, MUFU
// 16 results a clock per SM on compute capability 9.0); the output write
// is 4 bytes per 16,384 chain steps.
//
// T2: the fma instance with one trip on the same grid, launched through
// tpt_probe_launch under its own counter in the wrapper: the launch, the
// blocks' dispatch, the chains' set-up and the output write, everything
// of a case's time but the steps.  The wrapper subtracts it, as
// vpu_roofline.py:150 subtracts its dispatch floor.

#include <cuda_runtime.h>

#include "probe.cuh"

namespace {

constexpr int kThreads = 256;

template <int kCase>
__global__ void __launch_bounds__(kThreads)
probe_kernel(int trips, float* __restrict__ out) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  out[i] = tpt::probe::chains<kCase>(tpt::probe::thread_x(i), trips);
}

}  // namespace

extern "C" {

// T1: `blocks` blocks of 256 threads of case `which` (tpt::probe::Case),
// `trips` steps a chain, one float a thread into `out`.  Returns
// cudaGetLastError().
int tpt_probe_launch(int which, int trips, int blocks, float* out,
                     void* stream) {
  if (blocks < 1 || trips < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case tpt::probe::FMA:
      probe_kernel<tpt::probe::FMA><<<blocks, kThreads, 0, s>>>(trips, out);
      break;
    case tpt::probe::CMPSEL:
      probe_kernel<tpt::probe::CMPSEL><<<blocks, kThreads, 0, s>>>(trips,
                                                                   out);
      break;
    case tpt::probe::SQRT:
      probe_kernel<tpt::probe::SQRT><<<blocks, kThreads, 0, s>>>(trips, out);
      break;
    case tpt::probe::DIV:
      probe_kernel<tpt::probe::DIV><<<blocks, kThreads, 0, s>>>(trips, out);
      break;
    case tpt::probe::RSQRT:
      probe_kernel<tpt::probe::RSQRT><<<blocks, kThreads, 0, s>>>(trips,
                                                                  out);
      break;
    case tpt::probe::MIX:
      probe_kernel<tpt::probe::MIX><<<blocks, kThreads, 0, s>>>(trips, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
