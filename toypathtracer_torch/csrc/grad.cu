// Gradient kernel (K3) and lockstep forward kernel (K4) for NVIDIA Hopper
// (sm_90a): the ports of the TPU kernels
// toypathtracer_tpu/ops/pallas_grad.py::_grad_kernel and
// ::_lockstep_fwd_kernel.
//
// One thread per pixel over 16x16 blocks; the block stages the packed scene,
// material types, emissive ids and camera in shared memory as the render
// kernel does.  K3's thread runs tpt::grad_pixel (trace.cuh): the pixel's
// primal, bit-equal to tpt::render_pixel, and its reverse sweep seeded by
// the pixel's cotangent, adding the pixel's (SCENE_ROWS, n) scene cotangent
// into a table in its own local memory.  K4's thread runs tpt::render_pixel
// itself, so its image is bit-equal to K3's primal (and to the render
// kernel's: in this port the lockstep and the fused formulations run the
// same per-pixel sequence).
//
// The scene cotangent is reduced without atomics, so two launches on the
// same inputs give bit-equal results: each block sums its threads' tables
// in a fixed order (warp shuffles, then the warps in turn) into one partial
// per block, and a second kernel adds the partials in block order, in
// double.  On the TPU the sequential grid carried the sum instead.
//
// Bound: FP32 ALU work, as the render kernel: the forward trace, the
// reverse sweep's replays (O(L^2) bounces for a path of L bounces; the
// replays before the differentiated bounce skip NEE's shadow tests) and
// the adjoint arithmetic.  Memory traffic is the cotangent read, the
// image write and the per-thread table in local memory (3.5 KB a thread
// at kGradMaxSpheres).  A simple kernel that is right comes first.

#include <cuda_runtime.h>

#include "trace.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 16;
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kWarps = kThreads / 32;
// The per-thread cotangent table has SCENE_ROWS * kGradMaxSpheres floats
// (ops/cuda_grad.MAX_SPHERES).
constexpr int kGradMaxSpheres = 64;
// Table entries reduced per round of the block reduction.
constexpr int kChunk = 32;

template <bool kGrad>
__global__ void __launch_bounds__(kThreads)
lockstep_kernel(const float* __restrict__ tab, const int32_t* __restrict__ mat,
                const int32_t* __restrict__ lights,
                const float* __restrict__ cam, tpt::RenderParams p,
                const float* __restrict__ g, float* __restrict__ out,
                unsigned long long* __restrict__ rays,
                float* __restrict__ partial) {
  extern __shared__ float smem[];
  __shared__ unsigned long long warp_rays[kWarps];
  __shared__ float warp_part[kWarps][kChunk];
  const int n = p.n_spheres;
  float* s_tab = smem;
  int32_t* s_mat = reinterpret_cast<int32_t*>(s_tab + tpt::SCENE_ROWS * n);
  int32_t* s_lights = s_mat + n;
  float* s_cam = reinterpret_cast<float*>(s_lights + p.n_lights);

  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  for (int i = tid; i < tpt::SCENE_ROWS * n; i += kThreads) s_tab[i] = tab[i];
  for (int i = tid; i < n; i += kThreads) s_mat[i] = mat[i];
  if (tid < p.n_lights) s_lights[tid] = lights[tid];
  if (tid < tpt::kCameraFloats) s_cam[tid] = cam[tid];
  __syncthreads();

  const int m = tpt::SCENE_ROWS * n;
  float acc[kGrad ? tpt::SCENE_ROWS * kGradMaxSpheres : 1];
  if (kGrad)
    for (int j = 0; j < m; ++j) acc[j] = 0.0f;

  const int lx = blockIdx.x * kBlockX + threadIdx.x;
  const int ly = blockIdx.y * kBlockY + threadIdx.y;
  unsigned long long count = 0;
  if (lx < p.width && ly < p.height) {
    tpt::SceneView S;
    S.tab = s_tab;
    S.mat = s_mat;
    S.lights = s_lights;
    S.n = n;
    S.n_lights = p.n_lights;
    const size_t o = (static_cast<size_t>(ly) * p.width + lx) * 3;
    float c[3];
    if (kGrad)
      count = tpt::grad_pixel(S, s_cam, p, p.x0 + lx, p.y0 + ly, g + o, c,
                              acc);
    else
      count = tpt::render_pixel(S, s_cam, p, p.x0 + lx, p.y0 + ly, c);
    out[o] = c[0];
    out[o + 1] = c[1];
    out[o + 2] = c[2];
  }
  // Threads outside the image count nothing (and hold a zero table) but
  // take part in the full-warp shuffles below.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if (lane == 0) warp_rays[warp] = count;
  __syncthreads();
  if (tid == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_rays[w];
    if (total) atomicAdd(rays, total);
  }
  if (!kGrad) return;

  // The block's tables, summed in a fixed order: kChunk entries a round,
  // each warp's 32 by a shuffle tree, then the warps in order.
  const size_t block =
      static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  for (int base = 0; base < m; base += kChunk) {
    for (int j = 0; j < kChunk; ++j) {
      float v = base + j < m ? acc[base + j] : 0.0f;
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) warp_part[warp][j] = v;
    }
    __syncthreads();
    if (tid < kChunk && base + tid < m) {
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w) s += warp_part[w][tid];
      partial[block * m + base + tid] = s;
    }
    __syncthreads();
  }
}

// d_tab[j] = sum over blocks, in block order, of partial[block][j].
__global__ void sum_partials(const float* __restrict__ partial, int blocks,
                             int m, float* __restrict__ d_tab) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b)
    s += partial[static_cast<size_t>(b) * m + j];
  d_tab[j] = static_cast<float>(s);
}

bool bad_params(const tpt::RenderParams* p, int max_spheres) {
  return p->n_spheres < 1 || p->n_spheres > max_spheres ||
         p->n_lights < 0 || p->n_lights > tpt::kMaxLights || p->height < 1 ||
         p->width < 1;
}

size_t stage_bytes(const tpt::RenderParams* p) {
  return sizeof(float) * tpt::SCENE_ROWS * p->n_spheres +
         sizeof(int32_t) * (p->n_spheres + p->n_lights) +
         sizeof(float) * tpt::kCameraFloats;
}

dim3 grid_of(const tpt::RenderParams* p) {
  return dim3((p->width + kBlockX - 1) / kBlockX,
              (p->height + kBlockY - 1) / kBlockY);
}

}  // namespace

extern "C" {

// Blocks of the gradient kernel's grid: the rows of its `partial` scratch.
int tpt_grad_blocks(const tpt::RenderParams* p) {
  const dim3 grid = grid_of(p);
  return static_cast<int>(grid.x * grid.y);
}

// K3 on `stream`: image `out` (height, width, 3), ray count added to `rays`
// (zeroed by the caller), scene cotangent d_tab (SCENE_ROWS, n) for the
// pixel cotangent `g` (height, width, 3).  `partial` is scratch of
// tpt_grad_blocks(p) * SCENE_ROWS * n floats.  Returns cudaGetLastError()
// after both launches (0 when both were accepted).
int tpt_grad_launch(const float* tab, const int32_t* mat,
                    const int32_t* lights, const float* cam,
                    const tpt::RenderParams* p, const float* g, float* out,
                    unsigned long long* rays, float* partial, float* d_tab,
                    void* stream) {
  if (bad_params(p, kGradMaxSpheres))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(p);
  lockstep_kernel<true><<<grid, dim3(kBlockX, kBlockY), stage_bytes(p), s>>>(
      tab, mat, lights, cam, *p, g, out, rays, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m = tpt::SCENE_ROWS * p->n_spheres;
  sum_partials<<<(m + 127) / 128, 128, 0, s>>>(
      partial, static_cast<int>(grid.x * grid.y), m, d_tab);
  return static_cast<int>(cudaGetLastError());
}

// K4 on `stream`: the primal of K3 alone.
int tpt_lockstep_launch(const float* tab, const int32_t* mat,
                        const int32_t* lights, const float* cam,
                        const tpt::RenderParams* p, float* out,
                        unsigned long long* rays, void* stream) {
  if (bad_params(p, tpt::kMaxSpheres))
    return static_cast<int>(cudaErrorInvalidValue);
  lockstep_kernel<false><<<grid_of(p), dim3(kBlockX, kBlockY), stage_bytes(p),
                           static_cast<cudaStream_t>(stream)>>>(
      tab, mat, lights, cam, *p, nullptr, out, rays, nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
