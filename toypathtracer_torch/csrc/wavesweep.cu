// The differentiable wavefront's sweep on NVIDIA Hopper (sm_90a), as the
// main path runs it under RenderConfig.diff_wavefront: wave_run_kernel,
// csrc/wavesweep.cuh sweep_runs over the FrameTape that K1's tape instance
// wrote (csrc/render.cu merged_render_kernel<4>).  It ports no Pallas
// kernel: the JAX package runs that route as jnp under XLA
// (toypathtracer_tpu/ops/tracecore.py:2223 render_pixels_fused_merged(
// differentiable=True)).  csrc/wavegrad.cu keeps the sweep it replaced
// (wave_sweep_kernel, K3's reverse half on K3's grid) as its baseline, and
// the sweep past kMaxSpheres spheres (wave_sweep_pool_kernel).
//
// Grid: block b takes tiles b * T .. b * T + T - 1 of the 8x4 tiles, T =
// kRunTiles x its warps (block_tiles), sorts their samples by bounces and
// deals them to its warps (wavesweep.cuh depth_order, SortedQueue); as many
// blocks as the tiles need, which the card starts as earlier ones end.
// Each block stages the scene in shared memory, sums its warps'
// (SCENE_ROWS, n) tables in warp order into its partial row, and grad.cu's
// sum_rows adds the rows in a fixed order.  Blocks of kThreads threads,
// kMainBlocks an SM (128 registers a thread), bounce_adj_fused's adds: of
// the launch bounds, adds and deals tried, the fastest on an H100
// (PERF.md).
//
// wave_run_kernel has two forms: the main path's (kMain), and sweep_runs
// on the kept sweep's deal, launch bounds and grid with bounce_adj_warp's
// adds, whose cotangent is the kept sweep's (csrc/wavegrad.cu
// wave_sweep_kernel) bit for bit.  Each has a stats instance that counts
// SM cycles by part (trace.cuh kGc*, wavesweep.cuh kWc*): the second's
// split the kept schedule's loop while its timed instance keeps its SASS.
//
// Bound: the tape's used part read once (a 64-byte record and the seen
// lights' words a bounce, a bounce count a sample) against the adjoint's
// FP32 work.

#include <cuda_runtime.h>

#include "coopgrad.cuh"
#include "launch.cuh"
#include "wavesweep.cuh"

extern "C" int tpt_grad_sum_launch(const float* partial, int rows, int m,
                                   float* d_tab, int form, void* stream);

namespace {

// Both forms' threads a block; blocks an SM of the main path's form and of
// the kept sweep's (csrc/wavegrad.cu's, K3's warp form's), their launch
// bounds: 65536 / (threads x blocks) registers a thread at most.
constexpr int kThreads = 128;
constexpr int kMainBlocks = 4;
constexpr int kTilesBlocks = 12;
// Tiles a warp of the main path's sorted blocks.
constexpr int kRunTiles = 2;
constexpr unsigned kFull = 0xffffffffu;

// The stats instances' counters: kWcSlots a thread, summed over each warp
// and added to the launch's totals.
struct SweepStats {
  static constexpr bool kOn = true;
  unsigned long long v[tpt::kWcSlots] = {};
  __host__ __device__ void add(int i, unsigned long long x) { v[i] += x; }
};

__device__ void flush_stats(const SweepStats& cs,
                            unsigned long long* __restrict__ stats, int tid) {
  for (int i = 0; i < tpt::kWcSlots; ++i) {
    unsigned long long x = cs.v[i];
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(kFull, x, off);
    if ((tid & 31) == 0 && x) atomicAdd(stats + i, x);
  }
}

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

// Floats of a warp's scratch (a multiple of 4, so that each warp's stays
// 16-byte aligned).
constexpr int kScratchWords = tpt::run_scratch_words(32);

// Items a block's share holds at most before its tiles are cut (the
// block then takes fewer tiles, down to one).
constexpr int kBlockItems = 4096;

// Tiles of a sorted block: kRunTiles x its warps, cut to kBlockItems
// items (one tile at least).
int block_tiles(const tpt::RenderParams* p) {
  const int fit = kBlockItems / (p->spp * 32);
  const int want = kRunTiles * (kThreads / 32);
  return want < fit ? want : (fit > 1 ? fit : 1);
}

// Dynamic shared memory of a sorted share of `tiles` tiles: [its items'
// bounces] [their order] [max_depth + 1 counts] [1].
size_t sorted_smem(const tpt::RenderParams* p, int tiles) {
  return 4 * (2 * static_cast<size_t>(tiles) * p->spp * 32 + p->max_depth +
              2);
}

// Dynamic shared memory of a block: [the warps' scratches] [their
// cotangent tables of SCENE_ROWS * n] [scene table] [material ids]
// [emissive ids], then for a sorted share of `tiles` tiles (0: none)
// sorted_smem's.
size_t block_smem(const tpt::RenderParams* p, int tiles) {
  const size_t n = p->n_spheres;
  return 4 * ((kThreads / 32) * (kScratchWords + tpt::SCENE_ROWS * n) +
              tpt::SCENE_ROWS * n + n + p->n_lights) +
         (tiles > 0 ? sorted_smem(p, tiles) : 0);
}

// The block's share of `deal` tiles, its items sorted by bounces and dealt
// to its warps: their bounces in s_dep, then their order, max_depth + 1
// counts and the count with a bounce (sorted_smem).  Every thread of the
// block calls it.
__device__ __forceinline__ tpt::SortedQueue sorted_share(
    const tpt::RenderParams& p, const tpt::FrameTape& ft, int deal,
    int* s_dep) {
  const int tid = threadIdx.x;
  const int tiles = ((p.width + 7) / 8) * ((p.height + 3) / 4);
  tpt::RunDeal share{static_cast<int>(blockIdx.x) * deal, 1, 0};
  share.count = tiles - share.first < deal ? tiles - share.first : deal;
  const int items = share.count * p.spp * 32;
  int* s_order = s_dep + static_cast<size_t>(deal) * p.spp * 32;
  int* s_cnt = s_order + static_cast<size_t>(deal) * p.spp * 32;
  for (int i = tid; i < items; i += kThreads)
    s_dep[i] = tpt::item_depth<32>(share, p, ft, i);
  __syncthreads();
  if (tid < 32) {
    const int valid = tpt::depth_order(tpt::DeviceWarp(tid), s_dep, items,
                                       p.max_depth, s_cnt, s_order);
    if (tid == 0) s_cnt[p.max_depth + 1] = valid;
  }
  __syncthreads();
  return tpt::SortedQueue{share, s_dep, s_order, s_cnt[p.max_depth + 1],
                          tid >> 5, kThreads / 32};
}

// The block's share of the sweep and its partial row: with kMain a share
// of `deal` tiles, its items sorted by bounces and dealt to the warps
// (SortedQueue), and bounce_adj_fused's adds; else sweep_tiles' deal
// (TileQueue) and bounce_adj_warp's.
template <bool kMain, bool kStats>
__device__ __forceinline__ void sweep_body(
    const float* __restrict__ tab, const int32_t* __restrict__ mat,
    const int32_t* __restrict__ lights, const tpt::RenderParams& p,
    const float* __restrict__ g, const tpt::FrameTape& ft, int deal,
    float* __restrict__ partial, unsigned long long* __restrict__ stats) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = p.n_spheres;
  const int m = tpt::SCENE_ROWS * n;
  float* s_ws = smem;
  float* s_acc = s_ws + kWarps * kScratchWords;
  float* s_tab = s_acc + kWarps * m;
  int32_t* s_mat = reinterpret_cast<int32_t*>(s_tab + m);
  int32_t* s_lights = s_mat + n;
  int* s_dep = s_lights + p.n_lights;
  SweepStats cs;
  long long c_all = 0, c0 = 0;
  if constexpr (kStats) c_all = clock64();
  const int tid = threadIdx.x;
  for (int i = tid; i < m; i += kThreads) s_tab[i] = tab[i];
  for (int i = tid; i < n; i += kThreads) s_mat[i] = mat[i];
  for (int i = tid; i < p.n_lights; i += kThreads) s_lights[i] = lights[i];
  if constexpr (kStats) c0 = clock64();
  for (int i = tid; i < kWarps * m; i += kThreads) s_acc[i] = 0.0f;
  if constexpr (kStats) cs.add(tpt::kGcCycZero, clock64() - c0);
  const int warp = tid >> 5;
  const tpt::DeviceWarp w(tid);
  __syncthreads();
  tpt::SceneView S;
  S.tab = s_tab;
  S.mat = s_mat;
  S.lights = s_lights;
  S.n = n;
  S.n_lights = p.n_lights;
  float* acc = s_acc + warp * m;
  float* ws = s_ws + warp * kScratchWords;
  tpt::NoGradCount none;
  auto sweep = [&](const auto& q) {
    if constexpr (kStats)
      tpt::sweep_runs<kMain>(w, S, p, g, acc, ft, ws, q, cs);
    else
      tpt::sweep_runs<kMain>(w, S, p, g, acc, ft, ws, q, none);
  };
  if constexpr (kMain) {
    sweep(sorted_share(p, ft, deal, s_dep));
  } else {
    const int tiles = ((p.width + 7) / 8) * ((p.height + 3) / 4);
    sweep(tpt::TileQueue{tpt::tiles_deal(blockIdx.x * kWarps + warp,
                                         gridDim.x * kWarps, tiles)});
  }
  if constexpr (kStats) c0 = clock64();
  __syncthreads();
  if constexpr (kStats) {
    const long long c1 = clock64();
    cs.add(tpt::kWcCycWait, c1 - c0);
    c0 = c1;
  }
  float* row = partial + static_cast<size_t>(blockIdx.x) * m;
  for (int j = tid; j < m; j += kThreads) {
    float s = 0.0f;
    for (int k = 0; k < kWarps; ++k) s += s_acc[k * m + j];
    row[j] = s;
  }
  if constexpr (kStats) {
    const long long c1 = clock64();
    cs.add(tpt::kGcCycReduce, c1 - c0);
    cs.add(tpt::kGcCycAll, c1 - c_all);
    flush_stats(cs, stats, tid);
  }
}

// The main path's sweep (kMain) and sweep_runs on the kept sweep's deal and
// launch bounds; with kStats their stats instances.
template <bool kMain, bool kStats>
__global__ void __launch_bounds__(kThreads, kMain ? kMainBlocks
                                                  : kTilesBlocks)
wave_run_kernel(const float* __restrict__ tab,
                const int32_t* __restrict__ mat,
                const int32_t* __restrict__ lights, tpt::RenderParams p,
                const float* __restrict__ g, tpt::FrameTape ft, int deal,
                float* __restrict__ partial,
                unsigned long long* __restrict__ stats) {
  sweep_body<kMain, kStats>(tab, mat, lights, p, g, ft, deal, partial,
                            stats);
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

// Past kMaxSpheres: the main path's design (sorted shares of `deal` tiles,
// bounce_adj_fused) with the scene read where it lies and a PoolTable a
// warp (gradwarp.cuh) in place of the shared table, on the main path's
// launch bounds.  Dynamic shared memory: [the warps' scratches] [the
// sorted share].
__global__ void __launch_bounds__(kThreads, kMainBlocks)
wave_run_pool_kernel(const float* __restrict__ tab,
                     const int32_t* __restrict__ mat,
                     const int32_t* __restrict__ lights, tpt::RenderParams p,
                     const float* __restrict__ g, tpt::FrameTape ft,
                     int deal, PoolArgs a) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float4 smem4[];
  float* s_ws = reinterpret_cast<float*>(smem4);
  int* s_dep = reinterpret_cast<int*>(s_ws + kWarps * kScratchWords);
  const tpt::SortedQueue q = sorted_share(p, ft, deal, s_dep);
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
  tpt::sweep_runs<true>(w, S, p, g, T, ft, s_ws + warp * kScratchWords, q,
                        none);
}

using RunKernel = void (*)(const float*, const int32_t*, const int32_t*,
                           tpt::RenderParams, const float*, tpt::FrameTape,
                           int, float*, unsigned long long*);

// The instance of wave_run_kernel for the main path's form or not, timed
// or with stats.
RunKernel run_kernel(bool main, bool stats) {
  if (main)
    return stats ? wave_run_kernel<true, true> : wave_run_kernel<true, false>;
  return stats ? wave_run_kernel<false, true> : wave_run_kernel<false, false>;
}

bool bad_params(const tpt::RenderParams* p,
                int max_spheres = tpt::kMaxSpheres) {
  return p->n_spheres < 1 || p->n_spheres > max_spheres ||
         p->n_lights < 0 || p->height < 1 || p->width < 1 || p->spp < 1 ||
         p->max_depth < 1 || p->soft_eps > 0.0f;
}

}  // namespace

extern "C" {

// Blocks of the main path's sweep (wave_run_kernel<true, ..> and
// wave_run_pool_kernel): its sorted blocks of block_tiles tiles, each
// block one partial row.  Returns 0, or cudaErrorInvalidValue.
int tpt_wave_run_scratch(const tpt::RenderParams* p, int* rows) {
  if (bad_params(p, 1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles =
      static_cast<long long>((p->width + 7) / 8) * ((p->height + 3) / 4);
  const long long per_block = block_tiles(p);
  *rows = static_cast<int>((tiles + per_block - 1) / per_block);
  return 0;
}

// The sweep over the FrameTape (tape_rec, tape_see, tape_depth) that
// tpt_render_tape_launch wrote for the same sub-image and parameters, for
// the pixel cotangent g (height, width, 3), on `stream`: `rows` blocks of
// the main path's form (main 1; rows from tpt_wave_run_scratch) or of
// sweep_runs on the kept sweep's deal (main 0; rows from tpt_grad_scratch
// for K3's warp form, where the result is the kept sweep's bit for bit),
// each writing its partial row of SCENE_ROWS * n floats to `partial`,
// then grad.cu's sum_rows into d_tab (SCENE_ROWS, n).  stats: null, or
// kWcSlots zeroed totals that the form's stats instance adds to.  Up to
// kMaxSpheres spheres, hard selects.  Returns cudaGetLastError() after
// both launches.
int tpt_wave_run_launch(const float* tab, const int32_t* mat,
                        const int32_t* lights, const tpt::RenderParams* p,
                        const float* g, int main, int rows, float* partial,
                        float* d_tab, float* tape_rec, uint32_t* tape_see,
                        int32_t* tape_depth, unsigned long long* stats,
                        void* stream) {
  if (bad_params(p) || rows < 1 || !partial || !d_tab || !tape_rec ||
      !tape_depth || (p->n_lights > 0 && !tape_see))
    return static_cast<int>(cudaErrorInvalidValue);
  const RunKernel kernel = run_kernel(main != 0, stats != nullptr);
  const int deal = main ? block_tiles(p) : 0;
  const size_t smem = block_smem(p, deal);
  cudaError_t err = tpt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<rows, kThreads, smem, s>>>(
      tab, mat, lights, *p, g, frame_tape(p, tape_rec, tape_see, tape_depth),
      deal, partial, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return tpt_grad_sum_launch(partial, rows, tpt::SCENE_ROWS * p->n_spheres,
                             d_tab, 1, stream);
}

// The main path's sweep past kMaxSpheres (any number of spheres, hard
// selects): `rows` blocks (tpt_wave_run_scratch's) adding into the
// PoolTable of (dir, blocks, next_block, block_cap, pool, next, cap) as
// csrc/grad.cu tpt_grad_pool_launch does, reading the FrameTape as
// tpt_wave_run_launch; grad.cu's sum_pool then sums the warps' slots in
// warp order.  The launcher reads *next and *next_block afterwards: past
// cap or block_cap the launch dropped adds and must run again with that
// many.  Returns cudaGetLastError().
int tpt_wave_run_pool_launch(const float* tab, const int32_t* mat,
                             const int32_t* lights, const tpt::RenderParams* p,
                             const float* g, int rows, float* tape_rec,
                             uint32_t* tape_see, int32_t* tape_depth,
                             int* dir, int* blocks, int* next_block,
                             int block_cap, float* pool, int* next, int cap,
                             void* stream) {
  if (bad_params(p, 1 << 30) || rows < 1 || !tape_rec || !tape_depth ||
      (p->n_lights > 0 && !tape_see) || !dir || !blocks || !next_block ||
      block_cap < 0 || !pool || !next || cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int deal = block_tiles(p);
  const size_t smem =
      4 * (kThreads / 32) * static_cast<size_t>(kScratchWords) +
      sorted_smem(p, deal);
  cudaError_t err = tpt::allow_smem(wave_run_pool_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const PoolArgs a{dir, blocks, next_block, block_cap, pool, next, cap};
  wave_run_pool_kernel<<<rows, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      tab, mat, lights, *p, g, frame_tape(p, tape_rec, tape_see, tape_depth),
      deal, a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
