// Gradient kernel (K3) and lockstep forward kernel (K4) for NVIDIA Hopper
// (sm_90a): the ports of the TPU kernels
// toypathtracer_tpu/ops/pallas_grad.py::_grad_kernel and
// ::_lockstep_fwd_kernel.
//
// K3 on the main path is warp_grad_kernel (csrc/gradwarp.cuh grad_tiles):
// persistent 128-thread blocks whose warps take 8x4-pixel tiles round
// robin by warp index, a lane a pixel.  A lane traces a batch of its
// pixel's samples once, keeping each bounce's carries (16 words) in the
// warp's scratch in device memory; then the warp sweeps the batch's
// samples in reverse, a lane taking the next sample of the warp's queue
// when its own is done, and every add into the scene cotangent is a warp
// collective into the warp's (SCENE_ROWS, n) table in shared memory: lanes
// that add to one sphere sum in a fixed tree and one of them adds the sum.
// The block then sums its warps' tables in warp order into its partial
// row, and sum_rows adds the rows, one warp an entry, in a fixed order.
// No floating-point atomic, and the pixels of a warp follow from its
// index: two launches on the same inputs give bit-equal results.
//
// K4 on the main path is the render kernel K1's merged kernel
// (csrc/render.cu merged_render_kernel), launched by ops/cuda_grad.py: the
// TPU's K4 computes K3's primal, which here is render_pixel, K1's function,
// so its image is bit-equal to K3's primal and to K1's.
//
// lockstep_kernel is the first design, one thread a pixel over 16x16
// blocks with the scene staged in shared memory.  kMode 0 is K4's
// baseline, kept as the kernel the merged one is timed against:
// render_pixel a thread.  kMode 1 is the replaying K3 that the warp form
// replaced, kept as the baseline it is timed against: tpt::grad_pixel
// replays bounces 0..d-1 before differentiating bounce d and adds into a
// (SCENE_ROWS, 64) table in the thread's local memory; the block sums its
// threads' tables and sum_partials adds the blocks' partials serially in
// double.  The stats instances (kStats) count SM cycles by part (trace.cuh
// kGc*).
//
// With RenderParams::soft_eps > 0 each form launches its soft instance
// (soft_warp_grad_kernel; lockstep_kernel kMode 2): the soft-silhouette
// estimator's adjoint (trace.cuh, grad_pixel<true>; gradwarp.cuh,
// grad_tiles<true>), which finds each missed ray's silhouette candidate
// and each shadow ray's occluder again in the reverse sweep.  The hard
// instances keep their code: every soft term sits behind `if constexpr`.
//
// Bound: FP32 ALU work -- the forward trace and the adjoint arithmetic --
// against a few hundred MB of traffic (the carries written and read once,
// the cotangent read, the image written).  The replaying form also spends
// the replays (O(L^2) bounces for a path of L) and a 3.5 KB table a
// thread.

#include <cuda_runtime.h>

#include "chunks.cuh"
#include "gradwarp.cuh"
#include "launch.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 16;
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kWarps = kThreads / 32;
// The replaying form's per-thread cotangent table has SCENE_ROWS *
// kGradMaxSpheres floats (ops/cuda_grad.FORM_MAX_SPHERES).
constexpr int kGradMaxSpheres = 64;
// Table entries reduced per round of the replaying form's block reduction.
constexpr int kChunk = 32;
// The warp form: 4 warps a block; 12 blocks an SM cap its registers at 40
// a thread, which spills but keeps 48 warps an SM in flight to hide the
// latency of its shared-memory, shuffle and local-memory chains (the
// fastest of 3-13 blocks in this kernel's timings on an H100: PERF.md).
constexpr int kWarpThreads = 128;
constexpr int kGradWarps = kWarpThreads / 32;
constexpr int kWarpBlocks = 12;
constexpr unsigned kFull = 0xffffffffu;

// The stats instances' counters: kGcSlots per thread, summed over the
// block by flush_stats.
struct GradStats {
  static constexpr bool kOn = true;
  unsigned long long v[tpt::kGcSlots] = {};
  // __host__ __device__ only because grad_pixel, which calls it, is; it
  // runs on the card alone.
  __host__ __device__ void add(int i, unsigned long long x) { v[i] += x; }
};

// Adds a thread's counters, summed over its warp, to the launch's totals.
// Every lane of the warp calls it.
__device__ void flush_stats(const GradStats& cs,
                            unsigned long long* __restrict__ stats, int tid) {
  for (int i = 0; i < tpt::kGcSlots; ++i) {
    unsigned long long x = cs.v[i];
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(kFull, x, off);
    if ((tid & 31) == 0 && x) atomicAdd(stats + i, x);
  }
}

// Sums each warp's rays and adds the block's total to `rays` with one
// atomic.  Every thread of the block calls it.
template <int kBlockWarps>
__device__ __forceinline__ void add_rays(
    unsigned long long count, unsigned long long* warp_rays,
    unsigned long long* __restrict__ rays, int tid) {
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(kFull, count, off);
  if ((tid & 31) == 0) warp_rays[tid >> 5] = count;
  __syncthreads();
  if (tid == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kBlockWarps; ++w) total += warp_rays[w];
    if (total) atomicAdd(rays, total);
  }
}

template <int kMode, bool kStats>
__global__ void __launch_bounds__(kThreads)
lockstep_kernel(const float* __restrict__ tab, const int32_t* __restrict__ mat,
                const int32_t* __restrict__ lights,
                const float* __restrict__ cam, tpt::RenderParams p,
                const float* __restrict__ g, float* __restrict__ out,
                unsigned long long* __restrict__ rays,
                float* __restrict__ partial,
                unsigned long long* __restrict__ stats) {
  constexpr bool kGrad = kMode != 0;
  constexpr bool kSoft = kMode == 2;
  extern __shared__ float smem[];
  __shared__ unsigned long long warp_rays[kWarps];
  __shared__ float warp_part[kWarps][kChunk];
  const int n = p.n_spheres;
  float* s_tab = smem;
  int32_t* s_mat = reinterpret_cast<int32_t*>(s_tab + tpt::SCENE_ROWS * n);
  int32_t* s_lights = s_mat + n;
  float* s_cam = reinterpret_cast<float*>(s_lights + p.n_lights);
  GradStats cs;
  long long c_all = 0, c0 = 0;
  if constexpr (kStats) c_all = clock64();

  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  for (int i = tid; i < tpt::SCENE_ROWS * n; i += kThreads) s_tab[i] = tab[i];
  for (int i = tid; i < n; i += kThreads) s_mat[i] = mat[i];
  if (tid < p.n_lights) s_lights[tid] = lights[tid];
  if (tid < tpt::kCameraFloats) s_cam[tid] = cam[tid];
  __syncthreads();

  const int m = tpt::SCENE_ROWS * n;
  float acc[kGrad ? tpt::SCENE_ROWS * kGradMaxSpheres : 1];
  if constexpr (kStats) c0 = clock64();
  if (kGrad)
    for (int j = 0; j < m; ++j) acc[j] = 0.0f;
  if constexpr (kStats) cs.add(tpt::kGcCycZero, clock64() - c0);

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
    if constexpr (!kGrad)
      count = tpt::render_pixel(S, s_cam, p, p.x0 + lx, p.y0 + ly, c);
    else if constexpr (kStats)
      count = tpt::grad_pixel<kSoft>(S, s_cam, p, p.x0 + lx, p.y0 + ly,
                                     g + o, c, acc, cs);
    else
      count = tpt::grad_pixel<kSoft>(S, s_cam, p, p.x0 + lx, p.y0 + ly,
                                     g + o, c, acc);
    out[o] = c[0];
    out[o + 1] = c[1];
    out[o + 2] = c[2];
  }
  // Threads outside the image count nothing (and hold a zero table) but
  // take part in the full-warp shuffles below.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  add_rays<kWarps>(count, warp_rays, rays, tid);
  if (!kGrad) return;

  // The block's tables, summed in a fixed order: kChunk entries a round,
  // each warp's 32 by a shuffle tree, then the warps in order.
  if constexpr (kStats) c0 = clock64();
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
  if constexpr (kStats) {
    const long long c1 = clock64();
    cs.add(tpt::kGcCycReduce, c1 - c0);
    cs.add(tpt::kGcCycAll, c1 - c_all);
    flush_stats(cs, stats, tid);
  }
}

// d_tab[j] = sum over blocks, in block order, of partial[block][j]: the
// serial sum, a thread an entry.
__global__ void sum_partials(const float* __restrict__ partial, int blocks,
                             int m, float* __restrict__ d_tab) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b)
    s += partial[static_cast<size_t>(b) * m + j];
  d_tab[j] = static_cast<float>(s);
}

// Floats of one warp's carries (csrc/gradwarp.cuh WarpTape).
__host__ __device__ size_t warp_tape_floats(const tpt::RenderParams& p) {
  return static_cast<size_t>(32) * tpt::kRecWords * p.max_depth *
         tpt::grad_batch(p);
}

// Floats of one warp's carries with their seen lights in words of their
// own (csrc/gradwarp.cuh LightTapeOf): the records, then the words.
__host__ __device__ size_t light_tape_floats(const tpt::RenderParams& p) {
  return warp_tape_floats(p) + static_cast<size_t>(32) * p.max_depth *
                                   tpt::grad_batch(p) *
                                   tpt::light_words(p.n_lights);
}

// The tape of warp gw with LightBits (LightTapeOf), in tape's
// light_tape_floats(p) floats a warp.
template <bool kWide>
__device__ __forceinline__ tpt::LightTapeOf<kWide> light_tape(
    float* tape, const tpt::RenderParams& p, int gw, int lane) {
  float* base = tape + static_cast<size_t>(gw) * light_tape_floats(p);
  tpt::LightTapeOf<kWide> t;
  t.base = base;
  t.width = 32;
  t.lane = lane;
  t.see = reinterpret_cast<uint32_t*>(base + warp_tape_floats(p));
  t.words = tpt::light_words(p.n_lights);
  return t;
}

// The warp form of K3 (csrc/gradwarp.cuh grad_tiles<kSoft>), the body of
// warp_grad_kernel and soft_warp_grad_kernel.  Dynamic shared memory:
// [scene table] [material ids] [emissive ids] [camera] [kGradWarps
// cotangent tables of SCENE_ROWS * n] [kGradWarps scratches of
// grad_tiles].
// `tape`: warp_tape_floats(p) floats for each warp of the grid
// (light_tape_floats(p) for kLights: the instances past kMaxLights lights,
// whose records keep the seen lights in words of their own).
template <bool kStats, bool kSoft, bool kLights = false>
__device__ __forceinline__ void warp_grad_body(
    const float* __restrict__ tab, const int32_t* __restrict__ mat,
    const int32_t* __restrict__ lights, const float* __restrict__ cam,
    const tpt::RenderParams& p, const float* __restrict__ g,
    float* __restrict__ out, unsigned long long* __restrict__ rays,
    float* tape, float* __restrict__ partial,
    unsigned long long* __restrict__ stats) {
  extern __shared__ float smem[];
  __shared__ unsigned long long warp_rays[kGradWarps];
  const int n = p.n_spheres;
  const int m = tpt::SCENE_ROWS * n;
  float* s_tab = smem;
  int32_t* s_mat = reinterpret_cast<int32_t*>(s_tab + m);
  int32_t* s_lights = s_mat + n;
  float* s_cam = reinterpret_cast<float*>(s_lights + p.n_lights);
  float* s_acc = s_cam + tpt::kCameraFloats;
  float* s_ws = s_acc + kGradWarps * m;
  GradStats cs;
  tpt::NoGradCount none;
  long long c_all = 0, c0 = 0;
  if constexpr (kStats) c_all = clock64();

  const int tid = threadIdx.x;
  for (int i = tid; i < m; i += kWarpThreads) s_tab[i] = tab[i];
  for (int i = tid; i < n; i += kWarpThreads) s_mat[i] = mat[i];
  if (tid < p.n_lights) s_lights[tid] = lights[tid];
  if constexpr (kLights)
    for (int i = tid + kWarpThreads; i < p.n_lights; i += kWarpThreads)
      s_lights[i] = lights[i];
  if (tid < tpt::kCameraFloats) s_cam[tid] = cam[tid];
  if constexpr (kStats) c0 = clock64();
  for (int i = tid; i < kGradWarps * m; i += kWarpThreads) s_acc[i] = 0.0f;
  if constexpr (kStats) cs.add(tpt::kGcCycZero, clock64() - c0);
  __syncthreads();

  tpt::SceneView S;
  S.tab = s_tab;
  S.mat = s_mat;
  S.lights = s_lights;
  S.n = n;
  S.n_lights = p.n_lights;
  const int warp = tid >> 5;
  const tpt::DeviceWarp w(tid);
  const int gw = blockIdx.x * kGradWarps + warp;
  const tpt::WarpTape t{tape + static_cast<size_t>(gw) * warp_tape_floats(p),
                        32, tid & 31};
  float* ws = s_ws + warp * tpt::grad_scratch_words(32);
  unsigned long long count;
  if constexpr (kLights)
    count = tpt::grad_tiles<kSoft>(w, S, s_cam, p, g, out, s_acc + warp * m,
                                   light_tape<false>(tape, p, gw, tid & 31),
                                   ws, gw, gridDim.x * kGradWarps, none);
  else if constexpr (kStats)
    count = tpt::grad_tiles<kSoft>(w, S, s_cam, p, g, out, s_acc + warp * m,
                                   t, ws, gw, gridDim.x * kGradWarps, cs);
  else
    count = tpt::grad_tiles<kSoft>(w, S, s_cam, p, g, out, s_acc + warp * m,
                                   t, ws, gw, gridDim.x * kGradWarps, none);
  add_rays<kGradWarps>(count, warp_rays, rays, tid);  // syncs the block

  // the block's partial row: its warps' tables in warp order
  if constexpr (kStats) c0 = clock64();
  float* row = partial + static_cast<size_t>(blockIdx.x) * m;
  for (int j = tid; j < m; j += kWarpThreads) {
    float s = 0.0f;
    for (int k = 0; k < kGradWarps; ++k) s += s_acc[k * m + j];
    row[j] = s;
  }
  if constexpr (kStats) {
    const long long c1 = clock64();
    cs.add(tpt::kGcCycReduce, c1 - c0);
    cs.add(tpt::kGcCycAll, c1 - c_all);
    flush_stats(cs, stats, tid);
  }
}

// K3's warp form, hard selects (the training step's default).
template <bool kStats>
__global__ void __launch_bounds__(kWarpThreads, kWarpBlocks)
warp_grad_kernel(const float* __restrict__ tab,
                 const int32_t* __restrict__ mat,
                 const int32_t* __restrict__ lights,
                 const float* __restrict__ cam, tpt::RenderParams p,
                 const float* __restrict__ g, float* __restrict__ out,
                 unsigned long long* __restrict__ rays, float* tape,
                 float* __restrict__ partial,
                 unsigned long long* __restrict__ stats) {
  warp_grad_body<kStats, false>(tab, mat, lights, cam, p, g, out, rays, tape,
                                partial, stats);
}

// K3's warp form with the soft-silhouette estimator (p.soft_eps > 0).
template <bool kStats>
__global__ void __launch_bounds__(kWarpThreads, kWarpBlocks)
soft_warp_grad_kernel(const float* __restrict__ tab,
                      const int32_t* __restrict__ mat,
                      const int32_t* __restrict__ lights,
                      const float* __restrict__ cam, tpt::RenderParams p,
                      const float* __restrict__ g, float* __restrict__ out,
                      unsigned long long* __restrict__ rays, float* tape,
                      float* __restrict__ partial,
                      unsigned long long* __restrict__ stats) {
  warp_grad_body<kStats, true>(tab, mat, lights, cam, p, g, out, rays, tape,
                               partial, stats);
}

// K3's warp form past kMaxLights lights (hard, or soft where p.soft_eps >
// 0): its records keep the seen lights in words of their own; the 16-light
// instances above keep them in the record's bits and their code.
template <bool kSoft>
__global__ void __launch_bounds__(kWarpThreads, kWarpBlocks)
lights_warp_grad_kernel(const float* __restrict__ tab,
                        const int32_t* __restrict__ mat,
                        const int32_t* __restrict__ lights,
                        const float* __restrict__ cam, tpt::RenderParams p,
                        const float* __restrict__ g, float* __restrict__ out,
                        unsigned long long* __restrict__ rays, float* tape,
                        float* __restrict__ partial) {
  warp_grad_body<false, kSoft, true>(tab, mat, lights, cam, p, g, out, rays,
                                     tape, partial, nullptr);
}

// d_tab[j] = the sum of partial[.][j] over `rows` rows, one warp an entry:
// lane l adds rows l, l + 32, ... in double, then a fixed shuffle tree.
constexpr int kSumThreads = 256;
__global__ void __launch_bounds__(kSumThreads)
sum_rows(const float* __restrict__ partial, int rows, int m,
         float* __restrict__ d_tab) {
  const int j = blockIdx.x * (kSumThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= m) return;  // the whole warp
  double s = 0.0;
  for (int b = lane; b < rows; b += 32)
    s += partial[static_cast<size_t>(b) * m + j];
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) d_tab[j] = static_cast<float>(s);
}

// ---- The pool instances: K3 past the shared table ----
//
// The TPU kernel takes any number of spheres; the warp form's (SCENE_ROWS,
// n) tables in shared memory take 512.  The pool instances run grad_tiles
// with a PoolTable a warp (gradwarp.cuh: a slot of device memory for each
// sphere the warp adds to, found through a directory) and WideTape
// carries (the sphere id whole), everything else as the warp form:
// pool_grad_kernel reads the flat scene where it lies, and
// chunk_grad_kernel the chunked one (chunks.cuh GradChunkedView: K5's and
// K6's per-ray walks in the forward trace, the soft scans over inflated
// chunk boxes), the scaled scene's gradient.  sum_pool then sums the
// warps' slots in the shared instance's order, so that a launch on a
// scene of up to 512 spheres, on the warp form's grid, is bit-equal to the
// warp form's.  Both are plain forms: 8 blocks an SM (64 registers a
// thread), no staging of the scene.
//
// The directory is keyed per (kDirIds spheres, warp) (gradwarp.cuh
// PoolTable): 4 bytes per 64 spheres for each of the launch's 4 x 8 x (SMs)
// warps -- 264 bytes a sphere on a 132-SM H100, 26.4 MB at n = 100,096 --
// plus the blocks of 64 slot indices the warps draw (256 bytes each, no more
// than the slots).  The dense (sphere, warp) directory it replaced took 16,896
// bytes a sphere, 1.69 GB there, and alone filled an 80 GB card at about 4.7
// million spheres; this one alone fills it at about 300 million, and with the
// scene's own storage and its gradient (about 250 bytes a sphere more) at
// about 150 million.  The pool instance for the flat scene keeps the seen
// lights in words of their own (LightTapeOf: any number of lights); the
// chunked instance keeps the per-lane walks and 16 lights, kept as the
// baseline of csrc/chunkgrad.cu's cooperative form.

constexpr int kPoolBlocks = 8;

// A pool launch's table (gradwarp.cuh PoolTable): the (ceil(n /
// kDirIds), warps) block directory (-1: no block), block_cap blocks of
// kDirIds slot indices (-1) and their counter (0), the pool of cap slots
// (zeroed) and its counter (0).
struct PoolArgs {
  int* dir;
  int* blocks;
  int* next_block;
  int block_cap;
  float* pool;
  int* next;
  int cap;
};

// The chunked scene: pack_chunks rows, the chunk boxes and the soft
// scans' inflated boxes (null in the hard instance).
struct ChunkArgs {
  const float* rows;
  const float* box;
  const float* sil_box;
  const float* prox_box;
  int n_chunks, chunk;
};

// kLights: LightTapeOf records (any number of lights), else WideTape's (at
// most kMaxLights); `tape` holds light_tape_floats(p) or warp_tape_floats(p)
// floats a warp.
template <bool kSoft, bool kStats = false, bool kLights = false, class View>
__device__ __forceinline__ void pool_grad_body(
    const View& S, const float* __restrict__ cam, const tpt::RenderParams& p,
    const float* __restrict__ g, float* __restrict__ out,
    unsigned long long* __restrict__ rays, float* tape, const PoolArgs& a,
    unsigned long long* __restrict__ stats = nullptr) {
  __shared__ unsigned long long warp_rays[kGradWarps];
  __shared__ float s_cam[tpt::kCameraFloats];
  // kGradWarps scratches of grad_tiles (grad_scratch_words(32) floats)
  __shared__ float s_ws[kGradWarps * (3 + tpt::kGradBatch) * 32];
  long long c_all = 0;
  if constexpr (kStats) c_all = clock64();
  const int tid = threadIdx.x;
  if (tid < tpt::kCameraFloats) s_cam[tid] = cam[tid];
  __syncthreads();
  const int warp = tid >> 5;
  const tpt::DeviceWarp w(tid);
  const int gw = blockIdx.x * kGradWarps + warp;
  const int n_warps = gridDim.x * kGradWarps;
  const tpt::PoolTable T{a.dir + gw, n_warps, a.blocks, a.next_block,
                         a.block_cap, a.pool, a.next, a.cap};
  float* ws = s_ws + warp * tpt::grad_scratch_words(32);
  if constexpr (kLights) {
    tpt::NoGradCount none;
    const unsigned long long count = tpt::grad_tiles<kSoft>(
        w, S, s_cam, p, g, out, T, light_tape<true>(tape, p, gw, tid & 31),
        ws, gw, n_warps, none);
    add_rays<kGradWarps>(count, warp_rays, rays, tid);
  } else {
    const tpt::WideTape t{
        tape + static_cast<size_t>(gw) * warp_tape_floats(p), 32, tid & 31};
    if constexpr (kStats) {
      GradStats cs;
      const unsigned long long count = tpt::grad_tiles<kSoft>(
          w, S, s_cam, p, g, out, T, t, ws, gw, n_warps, cs);
      add_rays<kGradWarps>(count, warp_rays, rays, tid);
      cs.add(tpt::kGcCycAll, clock64() - c_all);
      flush_stats(cs, stats, tid);
    } else {
      tpt::NoGradCount none;
      const unsigned long long count = tpt::grad_tiles<kSoft>(
          w, S, s_cam, p, g, out, T, t, ws, gw, n_warps, none);
      add_rays<kGradWarps>(count, warp_rays, rays, tid);
    }
  }
}

template <bool kSoft>
__global__ void __launch_bounds__(kWarpThreads, kPoolBlocks)
pool_grad_kernel(const float* __restrict__ tab,
                 const int32_t* __restrict__ mat,
                 const int32_t* __restrict__ lights,
                 const float* __restrict__ cam, tpt::RenderParams p,
                 const float* __restrict__ g, float* __restrict__ out,
                 unsigned long long* __restrict__ rays, float* tape,
                 PoolArgs a) {
  tpt::SceneView S;
  S.tab = tab;
  S.mat = mat;
  S.lights = lights;
  S.n = p.n_spheres;
  S.n_lights = p.n_lights;
  pool_grad_body<kSoft, false, true>(S, cam, p, g, out, rays, tape, a);
}

template <bool kSoft>
__global__ void __launch_bounds__(kWarpThreads, kPoolBlocks)
chunk_grad_kernel(const float* __restrict__ tab,
                  const int32_t* __restrict__ mat,
                  const int32_t* __restrict__ lights,
                  const float* __restrict__ cam, ChunkArgs c,
                  tpt::RenderParams p, const float* __restrict__ g,
                  float* __restrict__ out,
                  unsigned long long* __restrict__ rays, float* tape,
                  PoolArgs a) {
  tpt::GradChunkedView S;
  S.tab = tab;
  S.mat = mat;
  S.lights = lights;
  S.rows = c.rows;
  S.box = c.box;
  S.n = p.n_spheres;
  S.n_lights = p.n_lights;
  S.chunk = c.chunk;
  S.n_chunks = c.n_chunks;
  S.sil_box = c.sil_box;
  S.prox_box = c.prox_box;
  pool_grad_body<kSoft>(S, cam, p, g, out, rays, tape, a);
}

// The chunked instance's stats instance: its SM cycles by part (trace.cuh
// kGc*: the forward trace, the reverse sweep, within it the grouping and
// the soft scans), added to `stats`, on the timed instance's grid.
template <bool kSoft>
__global__ void __launch_bounds__(kWarpThreads, kPoolBlocks)
chunk_grad_stats_kernel(const float* __restrict__ tab,
                        const int32_t* __restrict__ mat,
                        const int32_t* __restrict__ lights,
                        const float* __restrict__ cam, ChunkArgs c,
                        tpt::RenderParams p, const float* __restrict__ g,
                        float* __restrict__ out,
                        unsigned long long* __restrict__ rays, float* tape,
                        PoolArgs a, unsigned long long* __restrict__ stats) {
  tpt::GradChunkedView S;
  S.tab = tab;
  S.mat = mat;
  S.lights = lights;
  S.rows = c.rows;
  S.box = c.box;
  S.n = p.n_spheres;
  S.n_lights = p.n_lights;
  S.chunk = c.chunk;
  S.n_chunks = c.n_chunks;
  S.sil_box = c.sil_box;
  S.prox_box = c.prox_box;
  pool_grad_body<kSoft, true>(S, cam, p, g, out, rays, tape, a, stats);
}

// d_tab[r][i] for the pool launch of `rows` blocks, one warp a sphere:
// block b's partial is its warps' slots summed in warp order in float from
// +0 (a warp without a slot adds nothing), and the partials are summed as
// sum_rows sums the warp form's partial rows, so that the result is the
// warp form's bit for bit where both run on one grid.  The warps of a
// block of this kernel read one row of the block directory.
__global__ void __launch_bounds__(kSumThreads)
sum_pool(const int* __restrict__ dir, const int* __restrict__ blocks,
         const float* __restrict__ pool, int rows, int n,
         float* __restrict__ d_tab) {
  const int i = blockIdx.x * (kSumThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n) return;  // the whole warp
  const int* col = dir + static_cast<size_t>(i / tpt::kDirIds) * rows *
                             kGradWarps;
  const int* ids = blocks + i % tpt::kDirIds;
  double s[tpt::SCENE_ROWS];
#pragma unroll
  for (int r = 0; r < tpt::SCENE_ROWS; ++r) s[r] = 0.0;
  for (int b = lane; b < rows; b += 32) {
    float q[tpt::SCENE_ROWS];
#pragma unroll
    for (int r = 0; r < tpt::SCENE_ROWS; ++r) q[r] = 0.0f;
    for (int k = 0; k < kGradWarps; ++k) {
      const int block = col[b * kGradWarps + k];
      if (block < 0) continue;
      const int slot = ids[static_cast<size_t>(block) * tpt::kDirIds];
      if (slot < 0) continue;
      const float* e = pool + static_cast<size_t>(slot) * tpt::kSlotFloats;
#pragma unroll
      for (int r = 0; r < tpt::SCENE_ROWS; ++r) q[r] += e[r];
    }
#pragma unroll
    for (int r = 0; r < tpt::SCENE_ROWS; ++r) s[r] += q[r];
  }
#pragma unroll
  for (int r = 0; r < tpt::SCENE_ROWS; ++r) {
    double v = s[r];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0)
      d_tab[static_cast<size_t>(r) * n + i] = static_cast<float>(v);
  }
}

// Blocks of a pool instance that fit on an SM at once.
template <bool kSoft>
cudaError_t pool_per_sm(bool chunked, int* per_sm) {
  if (chunked)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, chunk_grad_kernel<kSoft>, kWarpThreads, 0);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, pool_grad_kernel<kSoft>, kWarpThreads, 0);
}

bool bad_params(const tpt::RenderParams* p, int max_spheres,
                int max_lights = tpt::kMaxLights) {
  return p->n_spheres < 1 || p->n_spheres > max_spheres ||
         p->n_lights < 0 || p->n_lights > max_lights || p->height < 1 ||
         p->width < 1;
}

// Launches past kMaxLights lights take the instances whose records keep
// the seen lights in words of their own.
bool many_lights(const tpt::RenderParams* p) {
  return p->n_lights > tpt::kMaxLights;
}

size_t stage_bytes(const tpt::RenderParams* p) {
  return sizeof(float) * tpt::SCENE_ROWS * p->n_spheres +
         sizeof(int32_t) * (p->n_spheres + p->n_lights) +
         sizeof(float) * tpt::kCameraFloats;
}

size_t warp_smem(const tpt::RenderParams* p) {
  return stage_bytes(p) +
         sizeof(float) * kGradWarps *
             (tpt::SCENE_ROWS * p->n_spheres + tpt::grad_scratch_words(32));
}

dim3 grid_of(const tpt::RenderParams* p) {
  return dim3((p->width + kBlockX - 1) / kBlockX,
              (p->height + kBlockY - 1) / kBlockY);
}

// The soft instances run where the soft-silhouette estimator is on.
bool soft(const tpt::RenderParams* p) { return p->soft_eps > 0.0f; }

// Blocks of the warp form: as many as fit on the card at once (the timed
// instance's occupancy, so that the stats instance deals the same tiles to
// the same warps), or as the tiles need.
cudaError_t warp_grid(const tpt::RenderParams* p, int* blocks) {
  const size_t smem = warp_smem(p);
  auto timed = soft(p) ? soft_warp_grad_kernel<false> : warp_grad_kernel<false>;
  cudaError_t err;
  if (many_lights(p)) {
    auto lights = soft(p) ? lights_warp_grad_kernel<true>
                          : lights_warp_grad_kernel<false>;
    err = tpt::allow_smem(lights, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, lights, kWarpThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const int tiles = ((p->width + 7) / 8) * ((p->height + 3) / 4);
    const int need = (tiles + kGradWarps - 1) / kGradWarps;
    *blocks = need < sms * per_sm ? need : sms * per_sm;
    return cudaSuccess;
  }
  err = tpt::allow_smem(timed, smem);
  if (err == cudaSuccess)
    err = tpt::allow_smem(
        soft(p) ? soft_warp_grad_kernel<true> : warp_grad_kernel<true>, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, timed, kWarpThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = ((p->width + 7) / 8) * ((p->height + 3) / 4);
  const int need = (tiles + kGradWarps - 1) / kGradWarps;
  *blocks = need < sms * per_sm ? need : sms * per_sm;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The scratch a K3 launch of form `form` (0: the replaying form; 1: the
// warp form) takes: *rows rows of SCENE_ROWS * n partial sums (for the
// warp form, its blocks) and *tape_floats floats of carries (0 for the
// replaying form).  For the warp form it also lets both instances (hard,
// or soft where p->soft_eps > 0) take the dynamic shared memory the
// launch needs.  Returns 0, or a CUDA error code.
int tpt_grad_scratch(const tpt::RenderParams* p, int form, int* rows,
                     long long* tape_floats) {
  if (form < 0 || form > 1) return static_cast<int>(cudaErrorInvalidValue);
  *tape_floats = 0;
  if (form == 0) {
    const dim3 grid = grid_of(p);
    *rows = static_cast<int>(grid.x * grid.y);
    return 0;
  }
  const cudaError_t err = warp_grid(p, rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  *tape_floats = static_cast<long long>(*rows) * kGradWarps *
                 static_cast<long long>(many_lights(p)
                                            ? light_tape_floats(*p)
                                            : warp_tape_floats(*p));
  return 0;
}

// K3 of form `form` on `stream`: image `out` (height, width, 3), ray
// count added to `rays` (zeroed by the caller), scene cotangent d_tab
// (SCENE_ROWS, n) for the pixel cotangent `g` (height, width, 3).
// `rows`, `partial` and `tape` are the scratch tpt_grad_scratch gave for
// these parameters (it must have run first); stats: null, or kGcSlots
// zeroed totals that the form's stats instance adds to.  p->soft_eps > 0
// launches the form's soft instance, and only then; past kMaxLights lights
// the warp form launches its lights instance (no stats instance).  Returns
// cudaGetLastError() after both launches (0 when both were accepted).
int tpt_grad_launch(const float* tab, const int32_t* mat,
                    const int32_t* lights, const float* cam,
                    const tpt::RenderParams* p, const float* g, float* out,
                    unsigned long long* rays, int rows, float* partial,
                    float* tape, float* d_tab, int form,
                    unsigned long long* stats, void* stream) {
  if (form < 0 || form > 1 ||
      bad_params(p, form == 1 ? tpt::kMaxSpheres : kGradMaxSpheres,
                 form == 1 && !stats ? 1 << 30 : tpt::kMaxLights) ||
      rows < 1 || (form == 1 && !tape))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = tpt::SCENE_ROWS * p->n_spheres;
  if (form == 1 && many_lights(p)) {
    auto kernel = soft(p) ? lights_warp_grad_kernel<true>
                          : lights_warp_grad_kernel<false>;
    kernel<<<rows, kWarpThreads, warp_smem(p), s>>>(
        tab, mat, lights, cam, *p, g, out, rays, tape, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sum_rows<<<(m + kSumThreads / 32 - 1) / (kSumThreads / 32), kSumThreads,
               0, s>>>(partial, rows, m, d_tab);
    return static_cast<int>(cudaGetLastError());
  }
  if (form == 1) {
    auto kernel = soft(p)
                      ? (stats ? soft_warp_grad_kernel<true>
                               : soft_warp_grad_kernel<false>)
                      : (stats ? warp_grad_kernel<true>
                               : warp_grad_kernel<false>);
    kernel<<<rows, kWarpThreads, warp_smem(p), s>>>(
        tab, mat, lights, cam, *p, g, out, rays, tape, partial, stats);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sum_rows<<<(m + kSumThreads / 32 - 1) / (kSumThreads / 32), kSumThreads,
               0, s>>>(partial, rows, m, d_tab);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid = grid_of(p);
  if (static_cast<unsigned>(rows) != grid.x * grid.y)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = soft(p) ? (stats ? lockstep_kernel<2, true>
                                 : lockstep_kernel<2, false>)
                        : (stats ? lockstep_kernel<1, true>
                                 : lockstep_kernel<1, false>);
  kernel<<<grid, dim3(kBlockX, kBlockY), stage_bytes(p), s>>>(
      tab, mat, lights, cam, *p, g, out, rays, partial, stats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials<<<(m + 127) / 128, 128, 0, s>>>(partial, rows, m, d_tab);
  return static_cast<int>(cudaGetLastError());
}

// The final sum of a K3 launch of form `form` alone, on `stream`: d_tab
// from `rows` partial rows.  For timing it apart from the kernel.
int tpt_grad_sum_launch(const float* partial, int rows, int m, float* d_tab,
                        int form, void* stream) {
  if (rows < 1 || m < 1 || form < 0 || form > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 1)
    sum_rows<<<(m + kSumThreads / 32 - 1) / (kSumThreads / 32), kSumThreads,
               0, s>>>(partial, rows, m, d_tab);
  else
    sum_partials<<<(m + 127) / 128, 128, 0, s>>>(partial, rows, m, d_tab);
  return static_cast<int>(cudaGetLastError());
}

// The scratch of a pool launch (chunked: the chunked instance): *rows
// blocks, as many as fit on the card at once or as the tiles need, and
// *tape_floats floats of carries.  Returns 0, or a CUDA error code.
int tpt_grad_pool_scratch(const tpt::RenderParams* p, int chunked, int* rows,
                          long long* tape_floats) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = soft(p) ? pool_per_sm<true>(chunked, &per_sm)
                  : pool_per_sm<false>(chunked, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles = ((p->width + 7) / 8) * ((p->height + 3) / 4);
  const int need = (tiles + kGradWarps - 1) / kGradWarps;
  *rows = need < sms * per_sm ? need : sms * per_sm;
  *tape_floats = static_cast<long long>(*rows) * kGradWarps *
                 static_cast<long long>(chunked ? warp_tape_floats(*p)
                                                : light_tape_floats(*p));
  return 0;
}

// Sphere ids a block of the pool's directory covers (gradwarp.cuh
// kDirIds).
int tpt_grad_dir_ids() { return tpt::kDirIds; }

// K3's pool instance on `stream` (chunk_rows null: the flat scene, else the
// chunked one, with its n_chunks boxes `box` and, where p->soft_eps > 0,
// the soft scans' inflated boxes): image `out` (height, width, 3), ray
// count added to `rays`, the warps' slots found through dir
// (ceil(n_spheres / kDirIds) x rows * kGradWarps ints, -1) and blocks
// (block_cap x kDirIds ints, -1; next_block 0), in pool (cap slots, 0;
// next 0).  `rows` blocks
// (any number; the warp form's grid makes the sum bit-equal to its) and
// their `tape`.  The launcher reads *next and *next_block afterwards: past
// cap or block_cap the launch dropped adds and must be run again with that
// many.  The flat scene takes any number of lights, the chunked one (the
// per-lane walks, kept as the baseline) kMaxLights.  stats: null,
// or kGcSlots zeroed totals that the chunked instance's stats instance
// adds to (chunked only).  Returns cudaGetLastError() after the launch.
int tpt_grad_pool_launch(const float* tab, const int32_t* mat,
                         const int32_t* lights, const float* cam,
                         const float* chunk_rows, const float* box,
                         const float* sil_box, const float* prox_box,
                         int n_chunks, int chunk, const tpt::RenderParams* p,
                         const float* g, float* out, unsigned long long* rays,
                         int rows, float* tape, int* dir, int* blocks,
                         int* next_block, int block_cap, float* pool,
                         int* next, int cap, unsigned long long* stats,
                         void* stream) {
  if (bad_params(p, 1 << 30, chunk_rows ? tpt::kMaxLights : 1 << 30) ||
      rows < 1 || !tape || !dir || !blocks || !next_block || block_cap < 0 ||
      !pool || !next || cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunk_rows &&
      (!box || n_chunks < 1 || chunk < 1 || n_chunks * chunk != p->n_spheres ||
       (soft(p) && (!sil_box || !prox_box))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PoolArgs a{dir, blocks, next_block, block_cap, pool, next, cap};
  if (chunk_rows) {
    const ChunkArgs c{chunk_rows, box, sil_box, prox_box, n_chunks, chunk};
    if (stats) {
      auto kernel = soft(p) ? chunk_grad_stats_kernel<true>
                            : chunk_grad_stats_kernel<false>;
      kernel<<<rows, kWarpThreads, 0, s>>>(tab, mat, lights, cam, c, *p, g,
                                           out, rays, tape, a, stats);
      return static_cast<int>(cudaGetLastError());
    }
    auto kernel = soft(p) ? chunk_grad_kernel<true> : chunk_grad_kernel<false>;
    kernel<<<rows, kWarpThreads, 0, s>>>(tab, mat, lights, cam, c, *p, g, out,
                                         rays, tape, a);
  } else {
    if (stats) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = soft(p) ? pool_grad_kernel<true> : pool_grad_kernel<false>;
    kernel<<<rows, kWarpThreads, 0, s>>>(tab, mat, lights, cam, *p, g, out,
                                         rays, tape, a);
  }
  return static_cast<int>(cudaGetLastError());
}

// d_tab (SCENE_ROWS, n) from a pool launch of `rows` blocks (sum_pool).
int tpt_grad_pool_sum_launch(const int* dir, const int* blocks,
                             const float* pool, int rows, int n, float* d_tab,
                             void* stream) {
  if (rows < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  sum_pool<<<(n + kSumThreads / 32 - 1) / (kSumThreads / 32), kSumThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(dir, blocks, pool, rows, n,
                                                  d_tab);
  return static_cast<int>(cudaGetLastError());
}

// K4's baseline on `stream`: the primal of K3 alone, a thread a pixel.
int tpt_lockstep_launch(const float* tab, const int32_t* mat,
                        const int32_t* lights, const float* cam,
                        const tpt::RenderParams* p, float* out,
                        unsigned long long* rays, void* stream) {
  if (bad_params(p, tpt::kMaxSpheres))
    return static_cast<int>(cudaErrorInvalidValue);
  lockstep_kernel<0, false><<<grid_of(p), dim3(kBlockX, kBlockY),
                              stage_bytes(p),
                              static_cast<cudaStream_t>(stream)>>>(
      tab, mat, lights, cam, *p, nullptr, out, rays, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
