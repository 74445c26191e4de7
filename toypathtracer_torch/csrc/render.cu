// Render kernel for NVIDIA Hopper (sm_90a): the port of the TPU kernel
// toypathtracer_tpu/ops/pallas_render.py::_render_kernel.
//
// One thread per pixel over 16x8 blocks (the HLSL port's 8x8 thread groups,
// widened to four warps).  Each block first copies the packed scene table,
// the material types, the emissive ids and the camera into shared memory
// (the HLSL's groupshared staging, ComputeShader.hlsl:356-375); every
// thread then runs tpt::render_pixel (trace.cuh) and writes its pixel of the
// (height, width, 3) float32 image.  The ray count is reduced per warp with
// shuffles, per block through shared memory, and added to one 64-bit
// counter with a single atomic per block (the HLSL's InterlockedAdd).
//
// Bound: FP32 ALU work (sphere tests x rays); memory traffic is the image
// write alone.  A correct, simple kernel comes first; divergence between
// short and long paths inside a warp is the first thing to attack later.

#include <cuda_runtime.h>

#include "trace.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;
constexpr int kWarps = kBlockX * kBlockY / 32;

__global__ void __launch_bounds__(kBlockX * kBlockY)
render_kernel(const float* __restrict__ tab, const int32_t* __restrict__ mat,
              const int32_t* __restrict__ lights,
              const float* __restrict__ cam, tpt::RenderParams p,
              float* __restrict__ out, unsigned long long* __restrict__ rays) {
  extern __shared__ float smem[];
  __shared__ unsigned long long warp_rays[kWarps];
  const int n = p.n_spheres;
  float* s_tab = smem;
  int32_t* s_mat = reinterpret_cast<int32_t*>(s_tab + tpt::SCENE_ROWS * n);
  int32_t* s_lights = s_mat + n;
  float* s_cam = reinterpret_cast<float*>(s_lights + p.n_lights);

  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  for (int i = tid; i < tpt::SCENE_ROWS * n; i += kBlockX * kBlockY)
    s_tab[i] = tab[i];
  for (int i = tid; i < n; i += kBlockX * kBlockY) s_mat[i] = mat[i];
  if (tid < p.n_lights) s_lights[tid] = lights[tid];
  if (tid < tpt::kCameraFloats) s_cam[tid] = cam[tid];
  __syncthreads();

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
    float c[3];
    count = tpt::render_pixel(S, s_cam, p, p.x0 + lx, p.y0 + ly, c);
    const size_t o = (static_cast<size_t>(ly) * p.width + lx) * 3;
    out[o] = c[0];
    out[o + 1] = c[1];
    out[o + 2] = c[2];
  }
  // Threads outside the image count nothing but still take part in the
  // full-warp shuffles below.
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

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted).  `rays` must be zeroed by the caller; the kernel adds to it.
int tpt_render_launch(const float* tab, const int32_t* mat,
                      const int32_t* lights, const float* cam,
                      const tpt::RenderParams* p, float* out,
                      unsigned long long* rays, void* stream) {
  if (p->n_spheres < 1 || p->n_spheres > tpt::kMaxSpheres ||
      p->n_lights < 0 || p->n_lights > tpt::kMaxLights || p->height < 1 ||
      p->width < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * tpt::SCENE_ROWS * p->n_spheres +
                      sizeof(int32_t) * (p->n_spheres + p->n_lights) +
                      sizeof(float) * tpt::kCameraFloats;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((p->width + kBlockX - 1) / kBlockX,
                  (p->height + kBlockY - 1) / kBlockY);
  render_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      tab, mat, lights, cam, *p, out, rays);
  return static_cast<int>(cudaGetLastError());
}

const char* tpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
