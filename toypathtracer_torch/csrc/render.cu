// Render kernel for NVIDIA Hopper (sm_90a): the port of the TPU kernel
// toypathtracer_tpu/ops/pallas_render.py::_render_kernel, in its two
// instances: the render kernel K1 (render_tile_pallas, :282) and the stats
// render kernel K2 (render_frame_pallas_stats, :337), which adds the
// occupancy counters.
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
//
// K2 is the same kernel, template argument kStats = true, launched over the
// frame padded to the TPU's tile grid.  The TPU kernel counts, per tile,
// the trips of its persistent wavefront loop and the live lanes of each
// trip; those follow exactly from three trip counts per pixel (tpt::Trips:
// bounces, depth-cutoff samples, whether the last sample was one), which
// this kernel writes per pixel as int32 and ops/cuda_render.tile_counters
// turns into the TPU's (iters, work).  Pixels of the padded grid outside
// the image are rendered for their counts only: they write no image and
// count no rays.  The kernel also counts its own warps, the GPU's form of
// the occupancy counter: per sample, the warp's bounce loop runs as long as
// its deepest lane (__reduce_max_sync of the depths, summed over samples:
// the warp's trips if it reconverges after each sample), and its work is
// the lanes' bounces summed (__reduce_add_sync); pixels outside the image
// count 0, as K1's idle threads do.  So sum(work) / (32 sum(iters)) is K1's
// warp work efficiency, measured by the kernel itself.  Its bound is K1's
// FP32 work plus two warp reductions per sample.  Triton does not serve
// here: the kernel shares the per-pixel code of trace.cuh with K1.

#include <cuda_runtime.h>

#include "trace.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;
constexpr int kWarps = kBlockX * kBlockY / 32;

// Outputs of the stats instance (K2); unused by K1.
struct StatsOut {
  int32_t* trips;          // (3, grid_h, grid_w): bounces, cutoffs, last
  int32_t* warps;          // (2, gridDim.y * kWarps, gridDim.x): iters, work
  int32_t grid_h, grid_w;  // the padded tile grid
};

// K2's per-thread counter: the pixel's trip counts where it lies in the
// padded grid, and its warp's counters over the pixels of the image.
struct WarpTrips : tpt::Trips {
  bool in_grid, in_image;
  int32_t warp_iters = 0, warp_work = 0;
  __device__ WarpTrips(bool grid, bool image)
      : in_grid(grid), in_image(image) {}
  __device__ bool live() const { return in_grid; }
  __device__ void sample(int depth, bool cut) {
    tpt::Trips::sample(depth, cut);
    const int d = in_image ? depth : 0;
    warp_iters += __reduce_max_sync(0xffffffffu, d);
    warp_work += __reduce_add_sync(0xffffffffu, d);
  }
};

template <bool kStats>
__global__ void __launch_bounds__(kBlockX * kBlockY)
render_kernel(const float* __restrict__ tab, const int32_t* __restrict__ mat,
              const int32_t* __restrict__ lights,
              const float* __restrict__ cam, tpt::RenderParams p,
              float* __restrict__ out, unsigned long long* __restrict__ rays,
              StatsOut so) {
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
  const bool in_image = lx < p.width && ly < p.height;
  tpt::SceneView S;
  S.tab = s_tab;
  S.mat = s_mat;
  S.lights = s_lights;
  S.n = n;
  S.n_lights = p.n_lights;
  unsigned long long count = 0;
  float c[3];
  if constexpr (kStats) {
    // Every thread of the warp runs render_pixel, those past the padded
    // grid with depth 0, so the warp reductions see all 32 lanes.
    WarpTrips t(lx < so.grid_w && ly < so.grid_h, in_image);
    const uint32_t r =
        tpt::render_pixel(S, s_cam, p, p.x0 + lx, p.y0 + ly, c, t);
    if (in_image) {
      count = r;
      const size_t o = (static_cast<size_t>(ly) * p.width + lx) * 3;
      out[o] = c[0];
      out[o + 1] = c[1];
      out[o + 2] = c[2];
    }
    if (t.in_grid) {
      const size_t plane = static_cast<size_t>(so.grid_h) * so.grid_w;
      const size_t i = static_cast<size_t>(ly) * so.grid_w + lx;
      so.trips[i] = t.bounces;
      so.trips[plane + i] = t.cutoffs;
      so.trips[2 * plane + i] = t.last_cutoff;
    }
    if ((tid & 31) == 0) {
      const size_t plane =
          static_cast<size_t>(gridDim.y) * kWarps * gridDim.x;
      const size_t w =
          (static_cast<size_t>(blockIdx.y) * kWarps + (tid >> 5)) *
              gridDim.x + blockIdx.x;
      so.warps[w] = t.warp_iters;
      so.warps[plane + w] = t.warp_work;
    }
  } else if (in_image) {
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

bool bad_params(const tpt::RenderParams* p) {
  return p->n_spheres < 1 || p->n_spheres > tpt::kMaxSpheres ||
         p->n_lights < 0 || p->n_lights > tpt::kMaxLights || p->height < 1 ||
         p->width < 1;
}

size_t smem_bytes(const tpt::RenderParams* p) {
  return sizeof(float) * tpt::SCENE_ROWS * p->n_spheres +
         sizeof(int32_t) * (p->n_spheres + p->n_lights) +
         sizeof(float) * tpt::kCameraFloats;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted).  `rays` must be zeroed by the caller; the kernel adds to it.
int tpt_render_launch(const float* tab, const int32_t* mat,
                      const int32_t* lights, const float* cam,
                      const tpt::RenderParams* p, float* out,
                      unsigned long long* rays, void* stream) {
  if (bad_params(p)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((p->width + kBlockX - 1) / kBlockX,
                  (p->height + kBlockY - 1) / kBlockY);
  render_kernel<false><<<grid, block, smem_bytes(p),
                         static_cast<cudaStream_t>(stream)>>>(
      tab, mat, lights, cam, *p, out, rays, StatsOut{});
  return static_cast<int>(cudaGetLastError());
}

// The stats render kernel (K2) over the (grid_h, grid_w) padded tile grid
// of the (p->height, p->width) image: `trips` is (3, grid_h, grid_w) int32
// and `warps` (2, 4 * ceil(grid_h / 8), ceil(grid_w / 16)) int32, both
// written in full; `rays` as for tpt_render_launch.
int tpt_render_stats_launch(const float* tab, const int32_t* mat,
                            const int32_t* lights, const float* cam,
                            const tpt::RenderParams* p, float* out,
                            unsigned long long* rays, int grid_h, int grid_w,
                            int32_t* trips, int32_t* warps, void* stream) {
  if (bad_params(p) || grid_h < p->height || grid_w < p->width)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((grid_w + kBlockX - 1) / kBlockX,
                  (grid_h + kBlockY - 1) / kBlockY);
  render_kernel<true><<<grid, block, smem_bytes(p),
                        static_cast<cudaStream_t>(stream)>>>(
      tab, mat, lights, cam, *p, out, rays,
      StatsOut{trips, warps, grid_h, grid_w});
  return static_cast<int>(cudaGetLastError());
}

const char* tpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
