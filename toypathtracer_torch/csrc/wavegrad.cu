// The reverse sweep of the differentiable wavefront on NVIDIA Hopper
// (sm_90a): the backward half of the flat scene's gradient when
// RenderConfig.diff_wavefront asks for the merged wavefront run in reverse
// mode.  It ports no Pallas kernel: the JAX package runs that route as jnp
// under XLA (toypathtracer_tpu/ops/tracecore.py:2223
// render_pixels_fused_merged(differentiable=True), reached from
// render_pixels at :2548), because Mosaic cannot reverse a lax loop and
// its Pallas gradient kernel runs lockstep (ops/pallas_grad.py:151-156).
//
// The forward is K1's tape instance (csrc/render.cu
// merged_render_kernel<3>): the merged path loop, each lane refilling with
// its pixel's next sample as soon as one ends, writing each bounce's carry
// record to a frame-sized FrameTape (tape.cuh).  The sweep here runs
// gradwarp.cuh grad_tiles' reverse half over that tape (coopgrad.cuh
// sweep_tiles on the flat SceneView, the hard adjoint): the same 8x4 tiles
// dealt to the same warps, the same sample batches and queue as K3's warp
// form, so that on K3's grid each warp's table takes the same adds in the
// same order and the cotangent is K3's bit for bit.  So K3's forward trace
// (53% of its cycles, PERF.md) is done once, by the render the step runs
// anyway, and not again inside the gradient kernel.
//
// Up to kMaxSpheres spheres wave_sweep_kernel keeps each warp's (SCENE_ROWS,
// n) table in shared memory beside the staged scene, the block sums its
// warps' tables in warp order into its partial row, and grad.cu's sum_rows
// adds the rows (csrc/grad.cu warp_grad_body's layout and order).  Past
// them wave_sweep_pool_kernel adds into a PoolTable a warp (gradwarp.cuh)
// on K3's pool grid, summed by grad.cu's sum_pool, bit for bit the pool
// form's.  Any number of lights: the tape keeps the seen lights in words of
// their own.  Nothing is added with a floating-point atomic, and the tiles
// are dealt by warp index: two launches on the same inputs are bit-equal.
//
// Bound: the adjoint's FP32 work (K3's operations without its forward)
// against the tape's used part read once: a 64-byte record and the seen
// lights' words for each bounce the samples took, and each sample's bounce
// count.

#include <cuda_runtime.h>

#include "coopgrad.cuh"
#include "launch.cuh"

extern "C" int tpt_grad_sum_launch(const float* partial, int rows, int m,
                                   float* d_tab, int form, void* stream);

namespace {

// As K3's warp form (csrc/grad.cu kWarpThreads, kGradWarps, kWarpBlocks)
// and its pool form (kPoolBlocks).
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocks = 12;
constexpr int kPoolBlocks = 8;

// The tape a launch reads, as tpt_render_tape_launch wrote it.
tpt::FrameTape frame_tape(const tpt::RenderParams* p, float* rec,
                          uint32_t* see, int32_t* depth) {
  tpt::FrameTape ft;
  ft.rec = rec;
  ft.see = see;
  ft.depth = depth;
  ft.words = tpt::light_words(p->n_lights);
  ft.spp = p->spp;
  ft.max_depth = p->max_depth;
  ft.width = p->width;
  return ft;
}

// Dynamic shared memory: [scene table] [material ids] [emissive ids]
// [kWarps cotangent tables of SCENE_ROWS * n] [kWarps scratches of
// sweep_tiles]; `partial` gets the block's row, its warps' tables summed in
// warp order.
__global__ void __launch_bounds__(kThreads, kBlocks)
wave_sweep_kernel(const float* __restrict__ tab,
                  const int32_t* __restrict__ mat,
                  const int32_t* __restrict__ lights, tpt::RenderParams p,
                  const float* __restrict__ g, tpt::FrameTape ft,
                  float* __restrict__ partial) {
  extern __shared__ float smem[];
  const int n = p.n_spheres;
  const int m = tpt::SCENE_ROWS * n;
  float* s_tab = smem;
  int32_t* s_mat = reinterpret_cast<int32_t*>(s_tab + m);
  int32_t* s_lights = s_mat + n;
  float* s_acc = reinterpret_cast<float*>(s_lights + p.n_lights);
  float* s_ws = s_acc + kWarps * m;
  const int tid = threadIdx.x;
  for (int i = tid; i < m; i += kThreads) s_tab[i] = tab[i];
  for (int i = tid; i < n; i += kThreads) s_mat[i] = mat[i];
  for (int i = tid; i < p.n_lights; i += kThreads) s_lights[i] = lights[i];
  for (int i = tid; i < kWarps * m; i += kThreads) s_acc[i] = 0.0f;
  __syncthreads();
  tpt::SceneView S;
  S.tab = s_tab;
  S.mat = s_mat;
  S.lights = s_lights;
  S.n = n;
  S.n_lights = p.n_lights;
  const int warp = tid >> 5;
  const tpt::DeviceWarp w(tid);
  tpt::NoGradCount none;
  tpt::sweep_tiles<false>(w, S, p, g, s_acc + warp * m, ft,
                          s_ws + warp * tpt::grad_scratch_words(32),
                          blockIdx.x * kWarps + warp, gridDim.x * kWarps,
                          none);
  __syncthreads();
  float* row = partial + static_cast<size_t>(blockIdx.x) * m;
  for (int j = tid; j < m; j += kThreads) {
    float s = 0.0f;
    for (int k = 0; k < kWarps; ++k) s += s_acc[k * m + j];
    row[j] = s;
  }
}

// csrc/grad.cu PoolArgs.
struct PoolArgs {
  int* dir;
  int* blocks;
  int* next_block;
  int block_cap;
  float* pool;
  int* next;
  int cap;
};

// Past kMaxSpheres: the scene read where it lies, a PoolTable a warp.
__global__ void __launch_bounds__(kThreads, kPoolBlocks)
wave_sweep_pool_kernel(const float* __restrict__ tab,
                       const int32_t* __restrict__ mat,
                       const int32_t* __restrict__ lights,
                       tpt::RenderParams p, const float* __restrict__ g,
                       tpt::FrameTape ft, PoolArgs a) {
  __shared__ float s_ws[kWarps * (3 + tpt::kGradBatch) * 32];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const tpt::DeviceWarp w(tid);
  const int gw = blockIdx.x * kWarps + warp;
  const int n_warps = gridDim.x * kWarps;
  const tpt::PoolTable T{a.dir + gw, n_warps, a.blocks, a.next_block,
                         a.block_cap, a.pool, a.next, a.cap};
  tpt::SceneView S;
  S.tab = tab;
  S.mat = mat;
  S.lights = lights;
  S.n = p.n_spheres;
  S.n_lights = p.n_lights;
  tpt::NoGradCount none;
  tpt::sweep_tiles<false>(w, S, p, g, T, ft,
                          s_ws + warp * tpt::grad_scratch_words(32), gw,
                          n_warps, none);
}

bool bad_params(const tpt::RenderParams* p, int max_spheres) {
  return p->n_spheres < 1 || p->n_spheres > max_spheres ||
         p->n_lights < 0 || p->height < 1 || p->width < 1 ||
         p->soft_eps > 0.0f;
}

// Bytes of wave_sweep_kernel's dynamic shared memory.
size_t sweep_smem(const tpt::RenderParams* p) {
  const size_t n = p->n_spheres;
  return 4 * (tpt::SCENE_ROWS * n + n + p->n_lights +
              kWarps * (tpt::SCENE_ROWS * n + tpt::grad_scratch_words(32)));
}

}  // namespace

extern "C" {

// The shared-table sweep on `stream` (at most kMaxSpheres spheres, hard
// selects; the soft estimator has no wavefront route): `rows` blocks, each
// writing its partial row of SCENE_ROWS * n floats to `partial`, then
// grad.cu's sum_rows into d_tab (SCENE_ROWS, n), for the pixel cotangent g
// (height, width, 3), reading the FrameTape (tape_rec, tape_see,
// tape_depth) that tpt_render_tape_launch wrote for the same sub-image and
// parameters.  On the rows tpt_grad_scratch gives K3's warp form its
// cotangent is that form's bit for bit.  Returns cudaGetLastError() after
// both launches.
int tpt_wave_sweep_launch(const float* tab, const int32_t* mat,
                          const int32_t* lights, const tpt::RenderParams* p,
                          const float* g, int rows, float* partial,
                          float* d_tab, float* tape_rec, uint32_t* tape_see,
                          int32_t* tape_depth, void* stream) {
  if (bad_params(p, tpt::kMaxSpheres) || rows < 1 || !partial || !d_tab ||
      !tape_rec || !tape_depth || (p->n_lights > 0 && !tape_see))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sweep_smem(p);
  cudaError_t err = tpt::allow_smem(wave_sweep_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wave_sweep_kernel<<<rows, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      tab, mat, lights, *p, g, frame_tape(p, tape_rec, tape_see, tape_depth),
      partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return tpt_grad_sum_launch(partial, rows, tpt::SCENE_ROWS * p->n_spheres,
                             d_tab, 1, stream);
}

// The pool sweep on `stream` (any number of spheres, hard selects): `rows`
// blocks adding into the PoolTable of (dir, blocks, next_block, block_cap,
// pool, next, cap) as csrc/grad.cu tpt_grad_pool_launch does, reading the
// FrameTape as tpt_wave_sweep_launch.  On the rows tpt_grad_pool_scratch
// gives the flat pool form, grad.cu's sum_pool then gives that form's
// cotangent bit for bit.  The launcher reads *next and *next_block
// afterwards: past cap or block_cap the launch dropped adds and must run
// again with that many.  Returns cudaGetLastError().
int tpt_wave_sweep_pool_launch(const float* tab, const int32_t* mat,
                               const int32_t* lights,
                               const tpt::RenderParams* p, const float* g,
                               int rows, float* tape_rec, uint32_t* tape_see,
                               int32_t* tape_depth, int* dir, int* blocks,
                               int* next_block, int block_cap, float* pool,
                               int* next, int cap, void* stream) {
  if (bad_params(p, 1 << 30) || rows < 1 || !tape_rec || !tape_depth ||
      (p->n_lights > 0 && !tape_see) || !dir || !blocks || !next_block ||
      block_cap < 0 || !pool || !next || cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const PoolArgs a{dir, blocks, next_block, block_cap, pool, next, cap};
  wave_sweep_pool_kernel<<<rows, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      tab, mat, lights, *p, g, frame_tape(p, tape_rec, tape_see, tape_depth),
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
