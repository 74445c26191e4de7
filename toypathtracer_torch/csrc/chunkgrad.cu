// The reverse sweep of the scaled scene's gradient on NVIDIA Hopper
// (sm_90a): the second kernel of K3's cooperative chunked form
// (csrc/coopgrad.cuh), a port of toypathtracer_tpu/ops/pallas_grad.py::
// _grad_kernel on the chunked scene (scaled.py:712 with
// differentiable=True).
//
// The forward is csrc/scaled.cu's tape_render_kernel: the scaled render
// kernel's merged path loop writing each bounce's carry record to a
// frame-sized tape.  chunk_sweep_kernel then runs grad_tiles' reverse half
// over that tape (coopgrad.cuh sweep_tiles) with a PoolTable a warp
// (gradwarp.cuh), on the grid of the per-lane chunk_grad_kernel, so that
// csrc/grad.cu's sum_pool gives its cotangent bit for bit.  Its soft
// instance runs the estimator's chunk scans as warp walks over the
// inflated boxes (CoopGradView).  The tiles are dealt by warp index and
// nothing is added with a floating-point atomic: two launches on the same
// inputs are bit-equal.
//
// Bound: the adjoint's FP32 work (and, soft, the scans') against the
// tape's used part read once: a 64-byte record and the seen lights' words
// for each bounce the samples took, and each sample's bounce count.

#include <cuda_runtime.h>

#include "coopgrad.cuh"

namespace {

// As the per-lane chunked instance (csrc/grad.cu kWarpThreads, kGradWarps,
// kPoolBlocks): 4 warps a block, 8 blocks an SM.
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocks = 8;

// csrc/grad.cu PoolArgs: the block directory, its blocks and counter, the
// slots and their counter.
struct PoolArgs {
  int* dir;
  int* blocks;
  int* next_block;
  int block_cap;
  float* pool;
  int* next;
  int cap;
};

// The chunked scene as the sweep reads it: the pack_chunks rows and chunk
// boxes, the soft boxes (rows' order; null in the hard instance), and
// for the soft instance's walks scaled.walk_order's order and records
// with each scan's boxes in that order and their group boxes.
struct SweepArgs {
  const float* rows;
  const float* box;
  const float* sil_box;
  const float* prox_box;
  const int32_t* order;
  const tpt::Sphere4* rec;
  const float* sil_walk;
  const float* sil_gbox;
  const float* prox_walk;
  const float* prox_gbox;
  int n_groups, n_chunks, chunk;
};

template <bool kSoft>
__global__ void __launch_bounds__(kThreads, kBlocks)
chunk_sweep_kernel(const float* __restrict__ tab,
                   const int32_t* __restrict__ mat,
                   const int32_t* __restrict__ lights, SweepArgs c,
                   tpt::RenderParams p, const float* __restrict__ g,
                   tpt::FrameTape ft, PoolArgs a) {
  // kWarps scratches of sweep_tiles (grad_scratch_words(32) floats) and,
  // soft, of nee_adj_coop (scan_words(32))
  __shared__ float s_ws[kWarps * (3 + tpt::kGradBatch) * 32];
  __shared__ float s_scan[kSoft ? kWarps * tpt::kScanGroup * 7 * 32 : 1];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const tpt::DeviceWarp w(tid);
  const int gw = blockIdx.x * kWarps + warp;
  const int n_warps = gridDim.x * kWarps;
  const tpt::PoolTable T{a.dir + gw, n_warps, a.blocks, a.next_block,
                         a.block_cap, a.pool, a.next, a.cap};
  tpt::CoopGradView S;
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
  S.order = c.order;
  S.rec = c.rec;
  S.sil_walk = c.sil_walk;
  S.sil_gbox = c.sil_gbox;
  S.prox_walk = c.prox_walk;
  S.prox_gbox = c.prox_gbox;
  S.n_groups = c.n_groups;
  S.scan = s_scan + (kSoft ? warp * tpt::scan_words(32) : 0);
  float* ws = s_ws + warp * tpt::grad_scratch_words(32);
  tpt::NoGradCount none;
  if constexpr (kSoft) {
    tpt::sweep_tiles<true>(w, S, p, g, T, ft, ws, gw, n_warps, none);
  } else {
    // the hard adjoint runs no scan: the plain chunked view
    const tpt::GradChunkedView& V = S;
    tpt::sweep_tiles<false>(w, V, p, g, T, ft, ws, gw, n_warps, none);
  }
}

}  // namespace

extern "C" {

// The cooperative chunked K3's reverse sweep on `stream` (soft where
// p->soft_eps > 0): adds each warp's cotangent to the PoolTable of `a` (as
// csrc/grad.cu tpt_grad_pool_launch: dir, blocks, next_block, block_cap, pool,
// next, cap) for the pixel cotangent g (height, width, 3), reading the
// FrameTape (rec, see, depth) that tpt_scaled_render_launch (form 2) wrote for
// the same sub-image and parameters.  `rows` blocks: the grid
// tpt_grad_pool_scratch gives the chunked instance, whose sum_pool then gives
// its cotangent bit for bit.  The soft instance takes the soft boxes in the
// rows' order and, for its walks, scaled.walk_order's order and records and
// each scan's boxes in that order with their n_groups group boxes.  Returns
// cudaGetLastError() after the launch.
int tpt_chunk_sweep_launch(
    const float* tab, const int32_t* mat, const int32_t* lights,
    const float* chunk_rows, const float* box, const float* sil_box,
    const float* prox_box, const int32_t* order, const float* rec,
    const float* sil_walk, const float* sil_gbox, const float* prox_walk,
    const float* prox_gbox, int n_groups, int n_chunks, int chunk,
    const tpt::RenderParams* p, const float* g, int rows, float* tape_rec,
    uint32_t* tape_see, int32_t* tape_depth, int* dir, int* blocks,
    int* next_block, int block_cap, float* pool, int* next, int cap,
    void* stream) {
  const bool soft = p->soft_eps > 0.0f;
  if (p->n_spheres < 1 || p->n_lights < 0 || p->height < 1 || p->width < 1 ||
      rows < 1 || !chunk_rows || !box || n_chunks < 1 || chunk < 1 ||
      n_chunks * chunk != p->n_spheres || !tape_rec || !tape_depth ||
      (p->n_lights > 0 && !tape_see) || !dir || !blocks || !next_block ||
      block_cap < 0 || !pool || !next || cap < 0 ||
      (soft && (!sil_box || !prox_box || !order || !rec || !sil_walk ||
                !sil_gbox || !prox_walk || !prox_gbox || n_groups < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const SweepArgs c{chunk_rows, box, sil_box, prox_box, order,
                    reinterpret_cast<const tpt::Sphere4*>(rec), sil_walk,
                    sil_gbox, prox_walk, prox_gbox, n_groups, n_chunks,
                    chunk};
  tpt::FrameTape ft;
  ft.rec = tape_rec;
  ft.see = tape_see;
  ft.depth = tape_depth;
  ft.words = tpt::light_words(p->n_lights);
  ft.spp = p->spp;
  ft.max_depth = p->max_depth;
  ft.width = p->width;
  const PoolArgs a{dir, blocks, next_block, block_cap, pool, next, cap};
  auto kernel = soft ? chunk_sweep_kernel<true> : chunk_sweep_kernel<false>;
  kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tab, mat, lights, c, *p, g, ft, a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
