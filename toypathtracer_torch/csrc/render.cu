// Render kernel for NVIDIA Hopper (sm_90a): the port of the TPU kernel
// toypathtracer_tpu/ops/pallas_render.py::_render_kernel, in its
// instances: the render kernel K1 (render_tile_pallas, :282), the stats
// render kernel K2 (render_frame_pallas_stats, :337), which adds the
// occupancy counters, and their instruments.
//
// K1 on the main path is merged_render_kernel<0>: persistent 128-thread
// blocks whose warps take 16x2-pixel tiles from a launch-wide counter and
// run the merged path loop of csrc/merged.cuh with the flat scene's
// traversals of csrc/flat.cuh, a lane a pixel at a time.  Each block
// stages the sphere records, the packed table, the material types and the
// emissive ids in shared memory when the scene has at most kMaxSpheres
// spheres, and reads them from device memory otherwise; the camera and
// each warp's NEE scratch are always in shared memory.  Its counted
// instance (merged_render_kernel<1>) adds the loop's iterations, busy lanes
// and cycles by part (merged.cuh kSt*).  K4 (ops/cuda_grad.render_tile_lockstep) launches
// the same kernel.  Its tape instances are the differentiable wavefront's
// forward (RenderConfig.diff_wavefront; the JAX package's jnp route
// tracecore.render_pixels_fused_merged(differentiable=True)): K1's image
// and rays, bit for bit, and each bounce's carry record written to a
// frame-sized FrameTape that csrc/wavegrad.cu's sweep reads back.  On the
// main path the staged instance (merged_render_kernel<4>, the counter
// tape.cuh's StagedTapeSink: each lane's record staged in a 64-byte slot
// of shared memory, 2 KB a warp after the NEE scratches, and written as
// whole lines in 16-byte stores); beside it the instance it replaced
// (merged_render_kernel<3>, TapeSink: a store a word), kept as its
// bit-equality and timing baseline.  The other instances keep their
// parameters and code.
//
// render_kernel<0> is the per-thread kernel it replaced, kept as the
// baseline it is held bit-equal to and timed against: one thread per pixel
// over 16x8 blocks (the HLSL port's 8x8 thread groups, widened to four
// warps), the scene staged in shared memory as the HLSL's groupshared
// staging (ComputeShader.hlsl:356-375), tpt::render_pixel (trace.cuh) per
// thread, the ray count reduced per warp with shuffles, per block through
// shared memory, and added with a single atomic per block (the HLSL's
// InterlockedAdd).  render_kernel<2> is that kernel with SM-clock counters
// by part of the per-pixel code (kPc* below).
//
// Bound: FP32 ALU work (sphere tests x rays); memory traffic is the image
// write alone.
//
// K2, the stats render kernel, runs over the frame padded to the TPU's
// tile grid.  The TPU kernel counts, per tile, the trips of its persistent
// wavefront loop and the live lanes of each trip; those follow exactly from
// three trip counts per pixel (tpt::Trips: bounces, depth-cutoff samples,
// whether the last sample was one), which K2 writes per pixel as int32 and
// ops/cuda_render.tile_counters turns into the TPU's (iters, work).  Pixels
// of the padded grid outside the image are traced for their counts only:
// they write no image and count no rays.  K2 also counts the warps of the
// per-thread layout (render_kernel<0>: 16x2 pixels a warp), the GPU's form
// of the occupancy counter: per sample, that warp's bounce loop runs as
// long as its deepest lane (summed over samples: the warp's trips if it
// reconverges after each sample), and its work is the lanes' bounces
// summed; pixels outside the image count 0, as render_kernel<0>'s idle
// threads do.  So sum(work) / (32 sum(iters)) is the per-thread kernel's
// warp work efficiency.
//
// K2 on the main path is merged_render_kernel<2>: K1's merged kernel with
// the counter policy merged.cuh TripStats, which walks the padded grid and
// writes each pixel's trips.  Its lanes run a 16x2 unit's samples at
// different times, so the per-sample maximum is an atomicMax into a (unit,
// sample) scratch that the wrapper sums over samples, and the work an
// atomicAdd per pixel: exact whatever the order.  render_kernel<1> is the
// per-thread kernel it replaced (K1's per-thread kernel with the counts,
// the warp's reductions __reduce_max_sync / __reduce_add_sync at each
// sample's end), kept as its baseline.  The bound is K1's FP32 work plus
// the counters.  Triton does not serve here: the kernels share the
// per-pixel code of trace.cuh.

#include <cuda_runtime.h>

#include <type_traits>

#include "flat.cuh"
#include "launch.cuh"
#include "tape.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;
constexpr int kWarps = kBlockX * kBlockY / 32;
constexpr unsigned kFull = 0xffffffffu;

// The per-thread kernel's instances.
enum { kModeRender = 0, kModeStats = 1, kModeParts = 2 };

// render_kernel<2>'s counters, per thread: SM clock cycles in the camera
// ray setup (between one sample's end and the next one's trace, the
// pixel's seeding included), in the nearest-hit sphere loops, in whole
// bounces (the loops, shading, scatter and NEE), in NEE (its occlusion
// loops included), in the occlusion loops, and waiting at each sample's
// end for the warp's deepest lane; the whole thread; then the samples and
// bounces traced.
enum {
  kPcCamera = 0, kPcHit, kPcBounce, kPcNee, kPcOcclusion, kPcWait, kPcAll,
  kPcSamples, kPcBounces, kPcSlots
};

// Outputs of the instruments; unused by K1.
struct StatsOut {
  int32_t* trips;          // K2 (3, grid_h, grid_w): bounces, cutoffs, last
  int32_t* warps;          // K2 (2, gridDim.y * kWarps, gridDim.x): iters,
                           // work
  int32_t grid_h, grid_w;  // K2's padded tile grid
  unsigned long long* parts;  // render_kernel<2>: kPcSlots totals
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
    warp_iters += __reduce_max_sync(kFull, d);
    warp_work += __reduce_add_sync(kFull, d);
  }
};

// render_kernel<2>'s thread state: its counters, the clock at the last
// mark (the pixel's start, then each sample's end) and at the end of its
// last bounce, and the lanes of its warp that render a pixel.
struct PartClock {
  unsigned long long v[kPcSlots] = {};
  long long mark = 0, last_end = 0;
  unsigned lanes = 0;
};

// SceneView whose traversals, bounces and samples clock themselves into a
// PartClock: the per-pixel code of trace.cuh finds these overloads by
// argument-dependent lookup and calls them in place of its own, which they
// call.  __host__ __device__ only because the code that calls them is; they
// run on the card alone.
struct ClockView : tpt::SceneView {
  PartClock* pc;
};

__host__ __device__ int nearest_hit(const ClockView& S, tpt::V3 ro,
                                    tpt::V3 rd, float t_min, float t_max,
                                    float& hit_t) {
  const long long t0 = tpt::sm_clock();
  const int id = tpt::nearest_hit(static_cast<const tpt::SceneView&>(S), ro,
                                  rd, t_min, t_max, hit_t);
  S.pc->v[kPcHit] += tpt::sm_clock() - t0;
  return id;
}

__host__ __device__ bool occluded(const ClockView& S, tpt::V3 pos,
                                  tpt::V3 l, int light, float t_min,
                                  float t_l) {
  const long long t0 = tpt::sm_clock();
  const bool occ = tpt::occluded(static_cast<const tpt::SceneView&>(S), pos,
                                 l, light, t_min, t_l);
  S.pc->v[kPcOcclusion] += tpt::sm_clock() - t0;
  return occ;
}

__host__ __device__ tpt::V3 nee(const ClockView& S,
                                const tpt::RenderParams& p, tpt::V3 pos,
                                tpt::V3 normal, tpt::V3 rd, tpt::V3 alb,
                                int hit_id, bool vis, uint32_t& st,
                                uint32_t& rays, uint32_t& see) {
  const long long t0 = tpt::sm_clock();
  const tpt::V3 r = tpt::nee<ClockView>(S, p, pos, normal, rd, alb, hit_id,
                                        vis, st, rays, see);
  S.pc->v[kPcNee] += tpt::sm_clock() - t0;
  return r;
}

__host__ __device__ bool bounce(const ClockView& S, const tpt::RenderParams& p,
                                bool vis, tpt::V3& ro, tpt::V3& rd,
                                uint32_t& st, bool& do_me, uint32_t& rays,
                                tpt::V3& e, tpt::V3& c, tpt::BounceRec& rec) {
  const long long t0 = tpt::sm_clock();
  const bool go = tpt::bounce<ClockView>(S, p, vis, ro, rd, st, do_me, rays,
                                         e, c, rec);
  const long long t1 = tpt::sm_clock();
  S.pc->v[kPcBounce] += t1 - t0;
  S.pc->v[kPcBounces] += 1;
  S.pc->last_end = t1;
  return go;
}

__host__ __device__ tpt::V3 trace_sample(const ClockView& S,
                                         const tpt::RenderParams& p,
                                         tpt::V3 ro, tpt::V3 rd, uint32_t& st,
                                         uint32_t& rays, int& depth,
                                         bool& cut) {
  PartClock& pc = *S.pc;
  const long long t0 = tpt::sm_clock();
  pc.v[kPcCamera] += t0 - pc.mark;
  pc.last_end = t0;
  const tpt::V3 col =
      tpt::trace_sample<ClockView>(S, p, ro, rd, st, rays, depth, cut);
#ifdef __CUDA_ARCH__
  __syncwarp(pc.lanes);  // the sample's end: the warp's deepest lane
#endif
  const long long t1 = tpt::sm_clock();
  pc.v[kPcWait] += t1 - pc.last_end;
  pc.v[kPcSamples] += 1;
  pc.mark = t1;
  return col;
}

// Adds each thread's PartClock counters, summed over its warp, to the
// launch's totals.  Every lane of the warp calls it.
__device__ void flush_parts(const PartClock& pc,
                            unsigned long long* __restrict__ parts,
                            int tid) {
  for (int i = 0; i < kPcSlots; ++i) {
    unsigned long long x = pc.v[i];
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(kFull, x, off);
    if ((tid & 31) == 0 && x) atomicAdd(parts + i, x);
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

template <int kMode>
__global__ void __launch_bounds__(kBlockX * kBlockY)
render_kernel(const float* __restrict__ tab, const int32_t* __restrict__ mat,
              const int32_t* __restrict__ lights,
              const float* __restrict__ cam, tpt::RenderParams p,
              float* __restrict__ out, unsigned long long* __restrict__ rays,
              StatsOut so) {
  extern __shared__ float smem[];
  __shared__ unsigned long long warp_rays[kWarps];
  long long c_all = 0;
  if constexpr (kMode == kModeParts) c_all = clock64();
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
  if constexpr (kMode == kModeStats) {
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
  } else if constexpr (kMode == kModeParts) {
    PartClock pc;
    pc.lanes = __ballot_sync(kFull, in_image);
    if (in_image) {
      ClockView V;
      static_cast<tpt::SceneView&>(V) = S;
      V.pc = &pc;
      pc.mark = clock64();
      count = tpt::render_pixel(V, s_cam, p, p.x0 + lx, p.y0 + ly, c);
      const size_t o = (static_cast<size_t>(ly) * p.width + lx) * 3;
      out[o] = c[0];
      out[o + 1] = c[1];
      out[o + 2] = c[2];
    }
    add_rays<kWarps>(count, warp_rays, rays, tid);
    pc.v[kPcAll] = clock64() - c_all;
    flush_parts(pc, so.parts, tid);
    return;
  } else if (in_image) {
    count = tpt::render_pixel(S, s_cam, p, p.x0 + lx, p.y0 + ly, c);
    const size_t o = (static_cast<size_t>(ly) * p.width + lx) * 3;
    out[o] = c[0];
    out[o + 1] = c[1];
    out[o + 2] = c[2];
  }
  // Threads outside the image count nothing but still take part in the
  // full-warp shuffles below.
  add_rays<kWarps>(count, warp_rays, rays, tid);
}

// The merged kernel: 4 warps a block, and 8 blocks that must fit on an SM
// at once, which caps its registers at 64 a thread: it spills, but 32
// warps an SM hide the latency of its shared-memory and shuffle chains
// (the fastest of 3, 4, 5, 6, 8 and 12 blocks in this kernel's timings on
// an H100; PERF.md).
constexpr int kMergedThreads = 128;
constexpr int kMergedWarps = kMergedThreads / 32;
constexpr int kMergedBlocks = 8;

// Floats of the merged kernel's dynamic shared memory: [sphere records (16
// bytes each)] [packed table] [material ids] [emissive ids], the four only
// when staged, then [camera] [kMergedWarps NEE scratches].
size_t merged_floats(const tpt::RenderParams* p, bool staged) {
  const size_t n = static_cast<size_t>(p->n_spheres);
  return (staged ? (4 + tpt::SCENE_ROWS + 1) * n + p->n_lights : 0) +
         tpt::kCameraFloats +
         kMergedWarps * static_cast<size_t>(tpt::flat_nee_words(p->n_lights,
                                                                32));
}

// The merged kernel's instances: the timed K1, its counted instance
// (merged.cuh LoopStats, adding kStSlots totals to MergedOut::stats), K2's
// stats instance (merged.cuh TripStats over the MergedOut grid), and the
// differentiable wavefront's forwards, the tape instances writing a
// FrameTape: through tape.cuh's TapeSink, and staged (StagedTapeSink).
enum { kMergedTimed = 0, kMergedCounted = 1, kMergedStats = 2,
       kMergedTape = 3, kMergedStaged = 4 };

// Floats of the staged tape instance's slots (a record a lane) after the
// NEE scratches, and 4 more to align them to 16 bytes.
constexpr size_t kStageFloats =
    kMergedThreads * tpt::StagedTapeSink::kStageWords + 4;

constexpr bool writes_tape(int mode) {
  return mode == kMergedTape || mode == kMergedStaged;
}

// What an instance writes besides the image and the rays: the counted
// instance's totals; the stats instance's padded (grid_h, grid_w) tile
// grid, trips (3, grid_h, grid_w) written in full, work (wr, wc) and depth
// (wr, wc, spp), wc = ceil(grid_w / 16), zeroed by the caller.
struct MergedOut {
  unsigned long long* stats;
  int grid_h, grid_w;
  int32_t* trips;
  int32_t* work;
  int32_t* depth;
};

// The last parameter of an instance: the tape instances' FrameTape, the
// others' MergedOut (their parameters, and so their code, stay as they
// were before the tape instance).
template <int kMode>
using MergedOutOf = typename std::conditional<writes_tape(kMode),
                                              tpt::FrameTape, MergedOut>::type;

// K1 (csrc/flat.cuh, merged.cuh) and its instances (kMode).  sph: the (n,
// 4) sphere records in device memory; staged: copy them, the table, the
// material and emissive ids into shared memory first.  next_tile: one int
// zeroed by the caller.  The stats instance walks x's padded grid of the
// (p.height, p.width) image; its image and rays are K1's, bit for bit, as
// are the tape instances', which write each bounce's record to the
// FrameTape x (the staged one through its slots after the NEE scratches).
template <int kMode>
__global__ void __launch_bounds__(kMergedThreads, kMergedBlocks)
merged_render_kernel(const float* __restrict__ tab,
                     const tpt::Sphere4* __restrict__ sph,
                     const int32_t* __restrict__ mat,
                     const int32_t* __restrict__ lights,
                     const float* __restrict__ cam, tpt::RenderParams p,
                     int staged, float* __restrict__ out,
                     unsigned long long* __restrict__ rays,
                     int* __restrict__ next_tile, MergedOutOf<kMode> x) {
  extern __shared__ float4 smem4[];
  __shared__ unsigned long long warp_rays[kMergedWarps];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = p.n_spheres;
  const int tid = threadIdx.x;
  const tpt::DeviceWarp w(tid);
  unsigned long long count;
  // The loop runs on a view built inside each branch, so that a staged
  // table is read with shared-memory loads: one pointer that may address
  // either memory takes generic loads, slower in this kernel's timings on
  // an H100 (PERF.md).
  auto run = [&](tpt::FlatView& S, float* s_cam) {
    S.n = n;
    S.n_lights = p.n_lights;
    if (tid < tpt::kCameraFloats) s_cam[tid] = cam[tid];
    S.nee = s_cam + tpt::kCameraFloats +
            (tid >> 5) * tpt::flat_nee_words(p.n_lights, 32);
    __syncthreads();
    if constexpr (kMode == kMergedCounted) {
      tpt::LoopStats cs(tid);
      count = tpt::render_tiles_merged(w, S, s_cam, p, next_tile, out, cs);
      tpt::flush_loop_stats(cs.v, x.stats, tid);
    } else if constexpr (kMode == kMergedStats) {
      tpt::TripStats ts;
      ts.grid_h = x.grid_h;
      ts.grid_w = x.grid_w;
      ts.wc = (x.grid_w + 15) / 16;
      ts.spp = p.spp;
      ts.trips = x.trips;
      ts.work = x.work;
      ts.depth = x.depth;
      count = tpt::render_tiles_merged(w, S, s_cam, p, next_tile, out, ts);
    } else if constexpr (kMode == kMergedTape) {
      tpt::TapeSink sink;
      sink.tape = x;
      count = tpt::render_tiles_merged(w, S, s_cam, p, next_tile, out, sink);
    } else if constexpr (kMode == kMergedStaged) {
      // the slots after the warps' NEE scratches, aligned to 16 bytes
      const uintptr_t end = reinterpret_cast<uintptr_t>(
          s_cam + tpt::kCameraFloats +
          kMergedWarps * tpt::flat_nee_words(p.n_lights, 32));
      tpt::StagedTapeSink sink;
      sink.tape = x;
      sink.stage = reinterpret_cast<float*>((end + 15) & ~uintptr_t(15)) +
                   (tid >> 5) * 32 * tpt::StagedTapeSink::kStageWords;
      sink.lane = tid & 31;
      count = tpt::render_tiles_merged(w, S, s_cam, p, next_tile, out, sink);
    } else {
      tpt::NoCoopCount none;
      count = tpt::render_tiles_merged(w, S, s_cam, p, next_tile, out, none);
    }
  };
  tpt::FlatView S;
  if (staged) {
    tpt::Sphere4* s_sph = reinterpret_cast<tpt::Sphere4*>(smem4);
    float* s_tab = smem + 4 * n;
    int32_t* s_mat = reinterpret_cast<int32_t*>(s_tab + tpt::SCENE_ROWS * n);
    int32_t* s_lights = s_mat + n;
    for (int i = tid; i < n; i += kMergedThreads) s_sph[i] = sph[i];
    for (int i = tid; i < tpt::SCENE_ROWS * n; i += kMergedThreads)
      s_tab[i] = tab[i];
    for (int i = tid; i < n; i += kMergedThreads) s_mat[i] = mat[i];
    for (int i = tid; i < p.n_lights; i += kMergedThreads)
      s_lights[i] = lights[i];
    S.sph = s_sph;
    S.tab = s_tab;
    S.mat = s_mat;
    S.lights = s_lights;
    run(S, reinterpret_cast<float*>(s_lights + p.n_lights));
  } else {
    S.sph = sph;
    S.tab = tab;
    S.mat = mat;
    S.lights = lights;
    run(S, smem);
  }
  add_rays<kMergedWarps>(count, warp_rays, rays, tid);
}

// The merged kernel takes any number of spheres and lights; the
// per-thread kernels stage at most kMaxSpheres and kMaxLights.
bool bad_params(const tpt::RenderParams* p,
                int max_spheres = INT32_MAX, int max_lights = INT32_MAX) {
  return p->n_spheres < 1 || p->n_spheres > max_spheres ||
         p->n_lights < 0 || p->n_lights > max_lights || p->height < 1 ||
         p->width < 1;
}

size_t smem_bytes(const tpt::RenderParams* p) {
  return sizeof(float) * tpt::SCENE_ROWS * p->n_spheres +
         sizeof(int32_t) * (p->n_spheres + p->n_lights) +
         sizeof(float) * tpt::kCameraFloats;
}

// A merged instance's launch over the (h, w) pixel span of p in 16x2
// tiles: as many blocks as the tiles need, at most as many of the timed
// instance as fit on the card at once (the others deal tiles as it does);
// a tape instance, as many of its own as fit.
template <int kMode>
cudaError_t launch_merged(const float* tab, const tpt::Sphere4* sph,
                          const int32_t* mat, const int32_t* lights,
                          const float* cam, const tpt::RenderParams* p,
                          int h, int w, float* out, unsigned long long* rays,
                          int* next_tile, const MergedOutOf<kMode>& x,
                          void* stream) {
  const bool staged = p->n_spheres <= tpt::kMaxSpheres;
  const size_t smem =
      sizeof(float) * (merged_floats(p, staged) +
                       (kMode == kMergedStaged ? kStageFloats : 0));
  int capacity = 0;
  cudaError_t err;
  if constexpr (writes_tape(kMode))
    err = tpt::cached_capacity(kMergedThreads, smem, &capacity,
                               merged_render_kernel<kMode>);
  else
    err = tpt::cached_capacity(
        kMergedThreads, smem, &capacity, merged_render_kernel<kMergedTimed>,
        merged_render_kernel<kMergedCounted>,
        merged_render_kernel<kMergedStats>);
  if (err != cudaSuccess) return err;
  const int tiles = ((w + tpt::DeviceWarp::kTileW - 1) /
                     tpt::DeviceWarp::kTileW) *
                    ((h + tpt::DeviceWarp::kTileH - 1) /
                     tpt::DeviceWarp::kTileH);
  const int need = (tiles + kMergedWarps - 1) / kMergedWarps;
  merged_render_kernel<kMode><<<need < capacity ? need : capacity,
                                kMergedThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      tab, sph, mat, lights, cam, *p, staged ? 1 : 0, out, rays, next_tile,
      x);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1 on `stream`: the merged kernel over the (p->height, p->width)
// sub-image, image `out` (height, width, 3) and the ray count added to
// `rays`; sph the (n, 4) sphere records (cuda_render.pack_records);
// next_tile one int; `rays` and next_tile zeroed by the caller.  stats:
// null, or kStSlots zeroed totals that the counted instance adds to.
// Returns cudaGetLastError() (0 when the launch was accepted).
int tpt_render_launch(const float* tab, const tpt::Sphere4* sph,
                      const int32_t* mat, const int32_t* lights,
                      const float* cam, const tpt::RenderParams* p,
                      float* out, unsigned long long* rays, int* next_tile,
                      unsigned long long* stats, void* stream) {
  if (bad_params(p) || !next_tile)
    return static_cast<int>(cudaErrorInvalidValue);
  MergedOut x{};
  x.stats = stats;
  auto launch = stats ? launch_merged<kMergedCounted>
                      : launch_merged<kMergedTimed>;
  return static_cast<int>(launch(tab, sph, mat, lights, cam, p, p->height,
                                 p->width, out, rays, next_tile, x, stream));
}

// The stats render kernel K2 on the merged loop (merged_render_kernel<2>)
// over the (grid_h, grid_w) padded tile grid of the (p->height, p->width)
// image: inputs, image, `rays` and next_tile as for tpt_render_launch;
// `trips` (3, grid_h, grid_w) int32 written in full; `work` (4 *
// ceil(grid_h / 8), ceil(grid_w / 16)) and `depth` (the same, times p->spp)
// int32, zeroed by the caller (merged.cuh TripStats).
int tpt_render_stats_merged_launch(const float* tab, const tpt::Sphere4* sph,
                                   const int32_t* mat, const int32_t* lights,
                                   const float* cam,
                                   const tpt::RenderParams* p, float* out,
                                   unsigned long long* rays, int* next_tile,
                                   int grid_h, int grid_w, int32_t* trips,
                                   int32_t* work, int32_t* depth,
                                   void* stream) {
  if (bad_params(p) || !next_tile || grid_h < p->height ||
      grid_w < p->width || p->x0 != 0 || p->y0 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const MergedOut x{nullptr, grid_h, grid_w, trips, work, depth};
  return static_cast<int>(launch_merged<kMergedStats>(
      tab, sph, mat, lights, cam, p, grid_h, grid_w, out, rays, next_tile, x,
      stream));
}

// The differentiable wavefront's forward on `stream`: one of K1's tape
// instances over the (p->height, p->width) sub-image, its image, rays and
// next_tile as for tpt_render_launch (bit-equal to K1's), and each
// bounce's record written to the FrameTape (tape.cuh) of tape_rec (16
// floats a slot, 64-byte aligned), tape_see (light_words(p->n_lights)
// words a slot) and tape_depth (the bounces of each (pixel, sample)),
// height * width * spp * max_depth slots (at most 2^31 - 1); a slot a
// sample did not reach is left as it was.  form 1: the staged instance
// (merged_render_kernel<4>), 0: the one it replaced (<3>); both write the
// same tape.  Any number of spheres and lights.  Returns
// cudaGetLastError().
int tpt_render_tape_launch(const float* tab, const tpt::Sphere4* sph,
                           const int32_t* mat, const int32_t* lights,
                           const float* cam, const tpt::RenderParams* p,
                           float* out, unsigned long long* rays,
                           int* next_tile, float* tape_rec,
                           uint32_t* tape_see, int32_t* tape_depth, int form,
                           void* stream) {
  const size_t slots = static_cast<size_t>(p->height) * p->width * p->spp *
                       p->max_depth;
  if (bad_params(p) || !next_tile || !tape_rec || !tape_depth ||
      (p->n_lights > 0 && !tape_see) || (form != 0 && form != 1) ||
      slots > INT32_MAX || reinterpret_cast<uintptr_t>(tape_rec) % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  tpt::FrameTape ft;
  ft.rec = tape_rec;
  ft.see = tape_see;
  ft.depth = tape_depth;
  ft.words = tpt::light_words(p->n_lights);
  ft.spp = p->spp;
  ft.max_depth = p->max_depth;
  ft.width = p->width;
  auto launch = form ? launch_merged<kMergedStaged>
                     : launch_merged<kMergedTape>;
  return static_cast<int>(launch(tab, sph, mat, lights, cam, p, p->height,
                                 p->width, out, rays, next_tile, ft,
                                 stream));
}

// The per-thread kernel K1 replaced (render_kernel<0>), or with parts
// non-null its clocked instance (render_kernel<2>, adding kPcSlots totals
// to `parts`); otherwise as tpt_render_launch, at most kMaxSpheres spheres
// and kMaxLights lights.
int tpt_render_thread_launch(const float* tab, const int32_t* mat,
                             const int32_t* lights, const float* cam,
                             const tpt::RenderParams* p, float* out,
                             unsigned long long* rays,
                             unsigned long long* parts, void* stream) {
  if (bad_params(p, tpt::kMaxSpheres, tpt::kMaxLights))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((p->width + kBlockX - 1) / kBlockX,
                  (p->height + kBlockY - 1) / kBlockY);
  StatsOut so{};
  so.parts = parts;
  auto kernel = parts ? render_kernel<kModeParts> : render_kernel<kModeRender>;
  kernel<<<grid, block, smem_bytes(p), static_cast<cudaStream_t>(stream)>>>(
      tab, mat, lights, cam, *p, out, rays, so);
  return static_cast<int>(cudaGetLastError());
}

// The per-thread stats render kernel (render_kernel<1>, K2's baseline) over
// the (grid_h, grid_w) padded tile grid of the (p->height, p->width) image:
// `trips` is (3, grid_h, grid_w) int32 and `warps` (2, 4 * ceil(grid_h /
// 8), ceil(grid_w / 16)) int32, both written in full; `rays` as for
// tpt_render_launch; at most kMaxSpheres spheres and kMaxLights lights.
int tpt_render_stats_launch(const float* tab, const int32_t* mat,
                            const int32_t* lights, const float* cam,
                            const tpt::RenderParams* p, float* out,
                            unsigned long long* rays, int grid_h, int grid_w,
                            int32_t* trips, int32_t* warps, void* stream) {
  if (bad_params(p, tpt::kMaxSpheres, tpt::kMaxLights) || grid_h < p->height ||
      grid_w < p->width)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((grid_w + kBlockX - 1) / kBlockX,
                  (grid_h + kBlockY - 1) / kBlockY);
  render_kernel<kModeStats><<<grid, block, smem_bytes(p),
                              static_cast<cudaStream_t>(stream)>>>(
      tab, mat, lights, cam, *p, out, rays,
      StatsOut{trips, warps, grid_h, grid_w, nullptr});
  return static_cast<int>(cudaGetLastError());
}

const char* tpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
