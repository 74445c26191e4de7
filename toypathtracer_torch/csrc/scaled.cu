// The scaled scene's kernels for NVIDIA Hopper (sm_90a): the chunk
// traversal K5, the fused shadow test K6, and the scaled render kernel.
//
// K5 hit_chunks_kernel replaces toypathtracer_tpu/ops/scaled_pallas.py::
// _hit_kernel, K6 shadow_chunks_kernel replaces ::_shadow_kernel (bit k of
// a ray's mask = light k occluded), and scaled_render_kernel replaces the
// whole of toypathtracer_tpu/scaled.py::_render_frame_scaled_pallas, the
// jnp wavefront that calls K5 and K6 once per bounce: it runs
// tpt::render_pixel<ChunkedView> (trace.cuh, chunks.cuh), so a frame is one
// launch and the traversal bodies are inlined into the bounce loop.  On a
// GPU the per-bounce glue between kernel calls would be the cost.
//
// One thread per ray (K5, K6; 128-thread blocks) or per pixel (the render
// kernel; 16x8 blocks, the ray count reduced as csrc/render.cu does).  Each
// block stages the chunk AABBs (24 bytes a chunk: 9.4 KB at 100k spheres in
// 391 chunks), and the render kernel also the emissive ids and the camera,
// in shared memory.  Sphere data is read from device memory as each thread
// needs it: the 14-row table (5.6 MB at 100k spheres) and the pack_chunks
// rows (1.6 MB) sit in the 50 MB L2.
//
// Bound: FP32 ALU work, ~12 operations per chunk slab test (every chunk for
// every ray) and ~19-20 per sphere test in the chunks a ray enters, against
// a few MB of scene data and the outputs.  The simple kernel comes first:
// a warp whose rays enter different chunks serialises their 256-sphere
// loops (divergence), which a later, faster version has to attack.

#include <cuda_runtime.h>

#include "chunks.cuh"

namespace {

constexpr int kRayThreads = 128;
constexpr int kBlockX = 16;
constexpr int kBlockY = 8;
constexpr int kWarps = kBlockX * kBlockY / 32;

__device__ void stage_boxes(const float* __restrict__ rows, int n_chunks,
                            int chunk, float* box, int tid, int threads) {
  const size_t stride = 4 * chunk + 8;
  for (int i = tid; i < 6 * n_chunks; i += threads)
    box[i] = rows[(i / 6) * stride + 4 * chunk + i % 6];
}

__device__ tpt::ChunkedView rows_view(const float* rows, const float* box,
                                      int n_chunks, int chunk) {
  tpt::ChunkedView V;
  V.tab = nullptr;
  V.mat = nullptr;
  V.lights = nullptr;
  V.rows = rows;
  V.box = box;
  V.n = n_chunks * chunk;
  V.n_lights = 0;
  V.chunk = chunk;
  V.n_chunks = n_chunks;
  return V;
}

// ro, rd: (3, n) planes; out_t, out_id: (n,).
__global__ void __launch_bounds__(kRayThreads)
hit_chunks_kernel(const float* __restrict__ rows, int n_chunks, int chunk,
                  const float* __restrict__ ro, const float* __restrict__ rd,
                  int n, float t_min, float t_max, float* __restrict__ out_t,
                  int32_t* __restrict__ out_id) {
  extern __shared__ float s_box[];
  stage_boxes(rows, n_chunks, chunk, s_box, threadIdx.x, blockDim.x);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const tpt::ChunkedView V = rows_view(rows, s_box, n_chunks, chunk);
  float t;
  out_id[i] = tpt::hit_chunks_ray(V, tpt::v3(ro[i], ro[n + i], ro[2 * n + i]),
                                  tpt::v3(rd[i], rd[n + i], rd[2 * n + i]),
                                  t_min, t_max, t);
  out_t[i] = t;
}

// ro: (3, n); dirs: (n_lights, 3, n); t_ls: (n_lights, n); out: (n,) bits.
__global__ void __launch_bounds__(kRayThreads)
shadow_chunks_kernel(const float* __restrict__ rows, int n_chunks, int chunk,
                     const float* __restrict__ ro,
                     const float* __restrict__ dirs,
                     const float* __restrict__ t_ls,
                     const int32_t* __restrict__ light_ids, int n_lights,
                     int n, float t_min, int32_t* __restrict__ out) {
  extern __shared__ float s_box[];
  stage_boxes(rows, n_chunks, chunk, s_box, threadIdx.x, blockDim.x);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const tpt::ChunkedView V = rows_view(rows, s_box, n_chunks, chunk);
  const tpt::V3 pos = tpt::v3(ro[i], ro[n + i], ro[2 * n + i]);
  int32_t bits = 0;
  for (int k = 0; k < n_lights; ++k) {
    const float* d = dirs + static_cast<size_t>(3 * k) * n;
    if (tpt::occluded_chunks(V, pos, tpt::v3(d[i], d[n + i], d[2 * n + i]),
                             light_ids[k], t_min,
                             t_ls[static_cast<size_t>(k) * n + i]))
      bits |= 1 << k;
  }
  out[i] = bits;
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
scaled_render_kernel(const float* __restrict__ tab,
                     const float* __restrict__ rows,
                     const int32_t* __restrict__ mat,
                     const int32_t* __restrict__ lights,
                     const float* __restrict__ cam, tpt::RenderParams p,
                     int n_chunks, int chunk, float* __restrict__ out,
                     unsigned long long* __restrict__ rays) {
  extern __shared__ float smem[];
  __shared__ unsigned long long warp_rays[kWarps];
  float* s_box = smem;
  float* s_cam = s_box + 6 * n_chunks;
  int32_t* s_lights = reinterpret_cast<int32_t*>(s_cam + tpt::kCameraFloats);

  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  stage_boxes(rows, n_chunks, chunk, s_box, tid, kBlockX * kBlockY);
  if (tid < tpt::kCameraFloats) s_cam[tid] = cam[tid];
  if (tid < p.n_lights) s_lights[tid] = lights[tid];
  __syncthreads();

  const int lx = blockIdx.x * kBlockX + threadIdx.x;
  const int ly = blockIdx.y * kBlockY + threadIdx.y;
  unsigned long long count = 0;
  if (lx < p.width && ly < p.height) {
    tpt::ChunkedView S = rows_view(rows, s_box, n_chunks, chunk);
    S.tab = tab;
    S.mat = mat;
    S.lights = s_lights;
    S.n = p.n_spheres;
    S.n_lights = p.n_lights;
    float c[3];
    count = tpt::render_pixel(S, s_cam, p, p.x0 + lx, p.y0 + ly, c);
    const size_t o = (static_cast<size_t>(ly) * p.width + lx) * 3;
    out[o] = c[0];
    out[o + 1] = c[1];
    out[o + 2] = c[2];
  }
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if ((tid & 31) == 0) warp_rays[tid >> 5] = count;
  __syncthreads();
  if (tid == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_rays[w];
    if (total) atomicAdd(rays, total);
  }
}

bool bad_chunks(int n_chunks, int chunk) {
  return n_chunks < 1 || n_chunks > tpt::kMaxChunks || chunk < 1;
}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// K5 on `stream` for n rays; returns cudaGetLastError() (0 when the launch
// was accepted).
int tpt_hit_chunks_launch(const float* rows, int n_chunks, int chunk,
                          const float* ro, const float* rd, int n,
                          float t_min, float t_max, float* out_t,
                          int32_t* out_id, void* stream) {
  if (bad_chunks(n_chunks, chunk) || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const size_t smem = sizeof(float) * 6 * n_chunks;
  cudaError_t err = allow_smem(hit_chunks_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  hit_chunks_kernel<<<(n + kRayThreads - 1) / kRayThreads, kRayThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      rows, n_chunks, chunk, ro, rd, n, t_min, t_max, out_t, out_id);
  return static_cast<int>(cudaGetLastError());
}

// K6 on `stream` for n rays and n_lights lights.
int tpt_shadow_chunks_launch(const float* rows, int n_chunks, int chunk,
                             const float* ro, const float* dirs,
                             const float* t_ls, const int32_t* light_ids,
                             int n_lights, int n, float t_min, int32_t* out,
                             void* stream) {
  if (bad_chunks(n_chunks, chunk) || n < 0 || n_lights < 0 ||
      n_lights > tpt::kMaxLights)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const size_t smem = sizeof(float) * 6 * n_chunks;
  cudaError_t err = allow_smem(shadow_chunks_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  shadow_chunks_kernel<<<(n + kRayThreads - 1) / kRayThreads, kRayThreads,
                         smem, static_cast<cudaStream_t>(stream)>>>(
      rows, n_chunks, chunk, ro, dirs, t_ls, light_ids, n_lights, n, t_min,
      out);
  return static_cast<int>(cudaGetLastError());
}

// The scaled render kernel on `stream`: image `out` (height, width, 3) and
// the ray count added to `rays` (zeroed by the caller).
int tpt_scaled_render_launch(const float* tab, const float* rows,
                             const int32_t* mat, const int32_t* lights,
                             const float* cam, const tpt::RenderParams* p,
                             int n_chunks, int chunk, float* out,
                             unsigned long long* rays, void* stream) {
  if (bad_chunks(n_chunks, chunk) || p->n_spheres != n_chunks * chunk ||
      p->n_lights < 0 || p->n_lights > tpt::kMaxLights || p->height < 1 ||
      p->width < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (6 * n_chunks + tpt::kCameraFloats) +
                      sizeof(int32_t) * p->n_lights;
  cudaError_t err = allow_smem(scaled_render_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((p->width + kBlockX - 1) / kBlockX,
                  (p->height + kBlockY - 1) / kBlockY);
  scaled_render_kernel<<<grid, block, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      tab, rows, mat, lights, cam, *p, n_chunks, chunk, out, rays);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
