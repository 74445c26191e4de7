// The scaled scene's kernels for NVIDIA Hopper (sm_90a): the chunk
// traversal K5, the fused shadow test K6 and the scaled render kernel, each
// in two forms.
//
// K5 replaces toypathtracer_tpu/ops/scaled_pallas.py::
// _hit_kernel, K6 replaces ::_shadow_kernel (bit k of a ray's mask = light
// k occluded), and the scaled render kernel replaces the whole of
// toypathtracer_tpu/scaled.py::_render_frame_scaled_pallas, the jnp
// wavefront that calls K5 and K6 once per bounce: a frame is one launch and
// the traversal is inlined into the path loop.  On a GPU the per-bounce
// glue between kernel calls would be the cost.
//
// The render kernel on the main path is coop_render_kernel: persistent
// 128-thread blocks whose warps take 16x2-pixel tiles and run the merged
// path loop of csrc/merged.cuh with the chunk traversal of csrc/coop.cuh,
// a lane a pixel at a time.  The TPU kernels cull chunks for a whole lane
// tile at once (scaled_pallas.py:64 skips a chunk for the tile,
// scaled.py:712-760 renders in row blocks so that the skip fires); the
// Hopper form of that packet is the warp.  scaled_render_kernel is the per-lane form it
// replaced (tpt::render_pixel<ChunkedView>: a warp whose rays enter
// different chunks runs each of those chunks' 256-sphere loops, and a lane
// whose sample ended waits for the warp's deepest lane); it stays as the
// baseline that the cooperative form is held bit-equal to and timed
// against, and is never on the main path.  Each form has a stats instance
// that also counts the traversal's work per warp (merged.cuh kSt*): the
// sphere-loop trips the warp ran against the sphere tests its lanes needed.
//
// K5 on the main path is coop_hit_kernel: persistent 128-thread blocks
// whose warps take 32 consecutive rays and run coop.cuh's hit_chunks_warp.
// The per-thread hit_chunks_kernel (a thread a ray, every chunk box in the
// rows' order) slab-tested all 391 chunk boxes of the 100k scene for a
// camera ray that crosses ~3; the cooperative form first tests the 25
// boxes of groups of 16 chunks in a spatial order (scaled.chunk_index)
// and walks, in the rows' order, only the chunks of the groups some lane
// enters, so its ids and t are the per-thread form's bit for bit; it
// reads the spheres as 16-byte records.  hit_chunks_kernel stays as the
// baseline it is held bit-equal to and timed against; both have counted
// instances.
//
// K6 on the main path is coop_shadow_kernel, for the same reason:
// persistent 128-thread blocks whose warps take 32 consecutive rays and
// decide each light's pairs with coop.cuh's walk (the group boxes, the
// ballot skip, the whole warp voting on one ray where few lanes enter a
// chunk).  shadow_chunks_kernel is the per-thread form it replaced (a
// thread a ray, every chunk box for each light, and the warp runs a
// chunk's sphere loop whenever any lane entered it), kept as the baseline
// it is held bit-equal to and timed against.  Both have counted
// instances.
//
// One thread per ray (K5's and K6's baselines; 128-thread blocks) or per
// pixel (the per-lane render kernel; 16x8 blocks; the ray count reduced as
// csrc/render.cu does, in both render kernels).  Each block stages the
// chunk AABBs (24 bytes a chunk: 9.4 KB at 100k spheres in 391 chunks),
// and the render kernels also the emissive ids and the camera, the
// cooperative kernels the group boxes too, in shared memory.  Sphere data
// is read from device memory (the 14-row table, 5.6 MB at 100k spheres,
// and the pack_chunks rows, 1.6 MB, sit in the 50 MB L2).
//
// Bound: FP32 ALU work, ~12 operations per chunk slab test and ~19-20 per
// sphere test in the chunks a ray enters, against a few MB of scene data
// and the outputs.

#include <cuda_runtime.h>

#include <type_traits>

#include "coop.cuh"
#include "coopgrad.cuh"
#include "launch.cuh"

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

constexpr unsigned kFull = 0xffffffffu;

// The per-lane form's counter: the lanes that run a traversal step
// together are the active mask there, and its lowest lane counts the step
// for them (the warp runs a chunk's sphere loop as long as its busiest
// entering lane).
struct LaneStats {
  static constexpr bool kOn = true;
  unsigned long long v[tpt::kStSlots] = {};
  int lane;
  __device__ explicit LaneStats(int tid) : lane(tid & 31) {}
  // __host__ __device__ only because the traversals that call it are;
  // it runs on the card alone.
  __host__ __device__ void call(bool shadow) {
#ifdef __CUDA_ARCH__
    const unsigned a = __activemask();
    if (lane != tpt::lowest(a)) return;
    const int k = shadow ? tpt::kStKind : 0;
    v[k + tpt::kStCalls] += 1;
    v[k + tpt::kStLanes] += tpt::popc(a);
#endif
  }
  __host__ __device__ void chunk(bool shadow, bool, int tests) {
#ifdef __CUDA_ARCH__
    const unsigned a = __activemask();
    const unsigned most = __reduce_max_sync(a, static_cast<unsigned>(tests));
    const unsigned all = __reduce_add_sync(a, static_cast<unsigned>(tests));
    if (lane != tpt::lowest(a)) return;
    const int k = shadow ? tpt::kStKind : 0;
    v[k + tpt::kStBoxes] += 1;
    v[k + tpt::kStSlabs] += tpt::popc(a);
    v[k + tpt::kStTrips] += most;
    v[k + tpt::kStNeed] += all;
#endif
  }
};

// K5's per-thread form (the baseline): one thread a ray,
// hit_chunks_ray over every chunk box.  ro, rd: (3, n) planes; out_t,
// out_id: (n,).  kStats: its counted instance, adding the traversal's
// LaneStats (kStSlots totals) to `stats`.
template <bool kStats>
__global__ void __launch_bounds__(kRayThreads)
hit_chunks_kernel(const float* __restrict__ rows, int n_chunks, int chunk,
                  const float* __restrict__ ro, const float* __restrict__ rd,
                  int n, float t_min, float t_max, float* __restrict__ out_t,
                  int32_t* __restrict__ out_id,
                  unsigned long long* __restrict__ stats) {
  extern __shared__ float s_box[];
  stage_boxes(rows, n_chunks, chunk, s_box, threadIdx.x, blockDim.x);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const tpt::ChunkedView V = rows_view(rows, s_box, n_chunks, chunk);
  auto hit = [&](auto& cnt) {
    float t;
    out_id[i] = tpt::hit_chunks_ray(
        V, tpt::v3(ro[i], ro[n + i], ro[2 * n + i]),
        tpt::v3(rd[i], rd[n + i], rd[2 * n + i]), t_min, t_max, t, cnt);
    out_t[i] = t;
  };
  if constexpr (kStats) {
    // every lane reaches the flush's full-warp shuffles
    LaneStats ls(threadIdx.x);
    if (i < n) hit(ls);
    tpt::flush_loop_stats(ls.v, stats, threadIdx.x);
  } else if (i < n) {
    tpt::NoChunkCount none;
    hit(none);
  }
}

// K5 on the main path: persistent 128-thread blocks whose warps take 32
// consecutive rays at a time from *next (zeroed by the caller) and run
// coop.cuh's hit_chunks_warp: the group boxes gbox over the walk order
// `order` (scaled.chunk_index) as the prefilter, then the kept chunks in
// the rows' order, the spheres read as 16-byte records (rec, in the rows'
// order).  Dynamic shared memory: [chunk boxes in the rows' order] [group
// boxes] [walk order] [each warp's chunk mask].  kStats: its counted
// instance (coop.cuh's counters, kStSlots totals added to `stats`).
template <bool kStats>
__global__ void __launch_bounds__(kRayThreads)
coop_hit_kernel(const float* __restrict__ rows,
                const int32_t* __restrict__ order,
                const tpt::Sphere4* __restrict__ rec,
                const float* __restrict__ gbox, int n_groups, int n_chunks,
                int chunk, const float* __restrict__ ro,
                const float* __restrict__ rd, int n, float t_min,
                float t_max, int* __restrict__ next,
                float* __restrict__ out_t, int32_t* __restrict__ out_id,
                unsigned long long* __restrict__ stats) {
  extern __shared__ float s_box[];
  float* s_gbox = s_box + 6 * n_chunks;
  int32_t* s_order = reinterpret_cast<int32_t*>(s_gbox + 6 * n_groups);
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_order + n_chunks);
  const int tid = threadIdx.x;
  stage_boxes(rows, n_chunks, chunk, s_box, tid, kRayThreads);
  for (int i = tid; i < 6 * n_groups; i += kRayThreads) s_gbox[i] = gbox[i];
  for (int i = tid; i < n_chunks; i += kRayThreads) s_order[i] = order[i];
  __syncthreads();
  tpt::CoopView V;
  static_cast<tpt::ChunkedView&>(V) = rows_view(rows, s_box, n_chunks, chunk);
  V.gbox = s_gbox;
  V.n_groups = n_groups;
  V.nee = nullptr;
  unsigned* mask = s_mask + (tid >> 5) * tpt::chunk_words(n_chunks);
  const tpt::DeviceWarp w(tid);
  if constexpr (kStats) {
    tpt::LoopStats cs(tid);
    tpt::hit_chunks_warp<tpt::kHitCoopMin>(w, V, s_order, rec, mask, ro, rd,
                                           n, t_min, t_max, next, out_t,
                                           out_id, cs);
    tpt::flush_loop_stats(cs.v, stats, tid);
  } else {
    tpt::NoCoopCount none;
    tpt::hit_chunks_warp<tpt::kHitCoopMin>(w, V, s_order, rec, mask, ro, rd,
                                           n, t_min, t_max, next, out_t,
                                           out_id, none);
  }
}

// K6's per-thread form (the baseline): one thread a ray, occluded_chunks
// per light.  ro: (3, n); dirs: (n_lights, 3, n); t_ls: (n_lights, n);
// out: (n,) bits.  kStats: its counted instance, adding the traversals'
// LaneStats (kStSlots totals) to `stats`.
template <bool kStats>
__global__ void __launch_bounds__(kRayThreads)
shadow_chunks_kernel(const float* __restrict__ rows, int n_chunks, int chunk,
                     const float* __restrict__ ro,
                     const float* __restrict__ dirs,
                     const float* __restrict__ t_ls,
                     const int32_t* __restrict__ light_ids, int n_lights,
                     int n, float t_min, int32_t* __restrict__ out,
                     unsigned long long* __restrict__ stats) {
  extern __shared__ float s_box[];
  stage_boxes(rows, n_chunks, chunk, s_box, threadIdx.x, blockDim.x);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const tpt::ChunkedView V = rows_view(rows, s_box, n_chunks, chunk);
  auto bits_of = [&](auto& cnt) {
    const tpt::V3 pos = tpt::v3(ro[i], ro[n + i], ro[2 * n + i]);
    int32_t bits = 0;
    for (int k = 0; k < n_lights; ++k) {
      const float* d = dirs + static_cast<size_t>(3 * k) * n;
      if (tpt::occluded_chunks(V, pos, tpt::v3(d[i], d[n + i], d[2 * n + i]),
                               light_ids[k], t_min,
                               t_ls[static_cast<size_t>(k) * n + i], cnt))
        bits |= 1 << k;
    }
    return bits;
  };
  if constexpr (kStats) {
    // every lane reaches the flush's full-warp shuffles
    LaneStats ls(threadIdx.x);
    if (i < n) out[i] = bits_of(ls);
    tpt::flush_loop_stats(ls.v, stats, threadIdx.x);
  } else if (i < n) {
    tpt::NoChunkCount none;
    out[i] = bits_of(none);
  }
}

// K6 on the main path: persistent 128-thread blocks whose warps take 32
// consecutive rays at a time from *next (zeroed by the caller) and decide
// them light by light with coop.cuh's walk (shadow_chunks_warp) over the
// chunks in the order `order` (scaled.chunk_index: Morton order of their
// boxes, whose group boxes gbox are tight), the spheres read as 16-byte
// records (rec, in the rows' order).  Dynamic shared memory: [chunk boxes
// in walk order] [group boxes] [walk order] [light ids].
template <bool kStats>
__global__ void __launch_bounds__(kRayThreads)
coop_shadow_kernel(const float* __restrict__ rows,
                   const int32_t* __restrict__ order,
                   const tpt::Sphere4* __restrict__ rec,
                   const float* __restrict__ gbox, int n_groups,
                   int n_chunks, int chunk, const float* __restrict__ ro,
                   const float* __restrict__ dirs,
                   const float* __restrict__ t_ls,
                   const int32_t* __restrict__ light_ids, int n_lights,
                   int n, float t_min, int* __restrict__ next,
                   int32_t* __restrict__ out,
                   unsigned long long* __restrict__ stats) {
  extern __shared__ float s_box[];
  float* s_gbox = s_box + 6 * n_chunks;
  int32_t* s_order = reinterpret_cast<int32_t*>(s_gbox + 6 * n_groups);
  int32_t* s_ids = s_order + n_chunks;
  const int tid = threadIdx.x;
  const size_t stride = 4 * chunk + 8;
  for (int i = tid; i < 6 * n_chunks; i += kRayThreads)
    s_box[i] = rows[order[i / 6] * stride + 4 * chunk + i % 6];
  for (int i = tid; i < 6 * n_groups; i += kRayThreads) s_gbox[i] = gbox[i];
  for (int i = tid; i < n_chunks; i += kRayThreads) s_order[i] = order[i];
  if (tid < n_lights) s_ids[tid] = light_ids[tid];
  __syncthreads();
  tpt::CoopView V;
  static_cast<tpt::ChunkedView&>(V) = rows_view(rows, s_box, n_chunks, chunk);
  V.gbox = s_gbox;
  V.n_groups = n_groups;
  V.nee = nullptr;
  const tpt::DeviceWarp w(tid);
  if constexpr (kStats) {
    tpt::LoopStats cs(tid);
    tpt::shadow_chunks_warp<tpt::kShadowCoopMin>(
        w, V, s_order, rec, ro, dirs, t_ls, s_ids, n_lights, n, t_min, next,
        out, cs);
    tpt::flush_loop_stats(cs.v, stats, tid);
  } else {
    tpt::NoCoopCount none;
    tpt::shadow_chunks_warp<tpt::kShadowCoopMin>(
        w, V, s_order, rec, ro, dirs, t_ls, s_ids, n_lights, n, t_min, next,
        out, none);
  }
}

// ChunkedView whose traversals count into a LaneStats: render_pixel finds
// these overloads by argument-dependent lookup.
struct CountedView : tpt::ChunkedView {
  LaneStats* cnt;
};

__host__ __device__ int nearest_hit(const CountedView& S, tpt::V3 ro,
                                    tpt::V3 rd, float t_min, float t_max,
                                    float& hit_t) {
  return tpt::hit_chunks_ray(S, ro, rd, t_min, t_max, hit_t, *S.cnt);
}

__host__ __device__ bool occluded(const CountedView& S, tpt::V3 pos,
                                  tpt::V3 l, int light, float t_min,
                                  float t_l) {
  return tpt::occluded_chunks(S, pos, l, light, t_min, t_l, *S.cnt);
}

// Sums each warp's rays and adds the block's total to `rays` with one
// atomic.  Every thread of the block calls it.
__device__ __forceinline__ void add_rays(
    unsigned long long count, unsigned long long* warp_rays,
    unsigned long long* __restrict__ rays, int tid) {
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(kFull, count, off);
  if ((tid & 31) == 0) warp_rays[tid >> 5] = count;
  __syncthreads();
  if (tid == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_rays[w];
    if (total) atomicAdd(rays, total);
  }
}

// The per-lane form (the baseline): render_pixel<ChunkedView> per thread.
// kStats adds the traversal counters (stats: kStSlots totals); the timed
// instance is the kernel as it was before the cooperative form.
template <bool kStats>
__global__ void __launch_bounds__(kBlockX * kBlockY)
scaled_render_kernel(const float* __restrict__ tab,
                     const float* __restrict__ rows,
                     const int32_t* __restrict__ mat,
                     const int32_t* __restrict__ lights,
                     const float* __restrict__ cam, tpt::RenderParams p,
                     int n_chunks, int chunk, float* __restrict__ out,
                     unsigned long long* __restrict__ rays,
                     unsigned long long* __restrict__ stats) {
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
  if constexpr (kStats) {
    LaneStats ls(tid);
    if (lx < p.width && ly < p.height) {
      CountedView S;
      static_cast<tpt::ChunkedView&>(S) = rows_view(rows, s_box, n_chunks,
                                                    chunk);
      S.tab = tab;
      S.mat = mat;
      S.lights = s_lights;
      S.n = p.n_spheres;
      S.n_lights = p.n_lights;
      S.cnt = &ls;
      float c[3];
      count = tpt::render_pixel(S, s_cam, p, p.x0 + lx, p.y0 + ly, c);
      const size_t o = (static_cast<size_t>(ly) * p.width + lx) * 3;
      out[o] = c[0];
      out[o + 1] = c[1];
      out[o + 2] = c[2];
    }
    tpt::flush_loop_stats(ls.v, stats, tid);
  } else if (lx < p.width && ly < p.height) {
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
  add_rays(count, warp_rays, rays, tid);
}

// Blocks of the cooperative kernel that must fit on an SM at once: caps
// its registers at 65536 / (128 * kCoopBlocks) a thread, 102 at 5 (the
// fastest of 4, 5 and 6 in this kernel's timings on an H100; PERF.md).
constexpr int kCoopBlocks = 5;

// The cooperative form (csrc/coop.cuh): persistent blocks whose warps take
// 16x2-pixel tiles from the launch-wide counter *next_tile (zeroed by the
// caller) through merged.cuh render_tiles_merged, counting into cnt; this
// lane's rays.  Dynamic shared memory: [NEE scratch per warp] [chunk boxes]
// [group boxes] [camera] [emissive ids].  View: tpt::CoopView, whose NEE
// takes its lights in one pass (at most kCoopNeeGroup), or
// tpt::CoopViewLights (any number, in passes).
template <class View, class Cnt>
__device__ __forceinline__ unsigned long long coop_render_body(
    const float* __restrict__ tab, const float* __restrict__ rows,
    const float* __restrict__ gbox, int n_groups,
    const int32_t* __restrict__ mat, const int32_t* __restrict__ lights,
    const float* __restrict__ cam, const tpt::RenderParams& p, int n_chunks,
    int chunk, float* __restrict__ out, int* __restrict__ next_tile,
    Cnt& cnt) {
  extern __shared__ float s_nee[];
  constexpr bool kPasses = std::is_same<View, tpt::CoopViewLights>::value;
  const int nee =
      tpt::nee_words(kPasses ? tpt::nee_group(p.n_lights) : p.n_lights, 32);
  float* s_box = s_nee + kWarps * nee;
  float* s_gbox = s_box + 6 * n_chunks;
  float* s_cam = s_gbox + 6 * n_groups;
  int32_t* s_lights = reinterpret_cast<int32_t*>(s_cam + tpt::kCameraFloats);

  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  stage_boxes(rows, n_chunks, chunk, s_box, tid, kBlockX * kBlockY);
  for (int i = tid; i < 6 * n_groups; i += kBlockX * kBlockY)
    s_gbox[i] = gbox[i];
  if (tid < tpt::kCameraFloats) s_cam[tid] = cam[tid];
  if constexpr (kPasses) {
    for (int i = tid; i < p.n_lights; i += kBlockX * kBlockY)
      s_lights[i] = lights[i];
  } else if (tid < p.n_lights) {
    s_lights[tid] = lights[tid];
  }
  __syncthreads();

  View S;
  static_cast<tpt::ChunkedView&>(S) = rows_view(rows, s_box, n_chunks, chunk);
  S.tab = tab;
  S.mat = mat;
  S.lights = s_lights;
  S.n = p.n_spheres;
  S.n_lights = p.n_lights;
  S.gbox = s_gbox;
  S.n_groups = n_groups;
  S.nee = s_nee + (tid >> 5) * nee;
  const tpt::DeviceWarp w(tid);
  return tpt::render_tiles_merged(w, S, s_cam, p, next_tile, out, cnt);
}

// The cooperative form for scenes of at most kCoopNeeGroup lights, and its
// stats instance.
template <bool kStats>
__global__ void __launch_bounds__(kBlockX * kBlockY, kCoopBlocks)
coop_render_kernel(const float* __restrict__ tab,
                   const float* __restrict__ rows,
                   const float* __restrict__ gbox, int n_groups,
                   const int32_t* __restrict__ mat,
                   const int32_t* __restrict__ lights,
                   const float* __restrict__ cam, tpt::RenderParams p,
                   int n_chunks, int chunk, float* __restrict__ out,
                   unsigned long long* __restrict__ rays,
                   int* __restrict__ next_tile,
                   unsigned long long* __restrict__ stats) {
  __shared__ unsigned long long warp_rays[kWarps];
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  unsigned long long count;
  if constexpr (kStats) {
    tpt::LoopStats cs(tid);
    count = coop_render_body<tpt::CoopView>(tab, rows, gbox, n_groups, mat,
                                            lights, cam, p, n_chunks, chunk,
                                            out, next_tile, cs);
    tpt::flush_loop_stats(cs.v, stats, tid);
  } else {
    tpt::NoCoopCount none;
    count = coop_render_body<tpt::CoopView>(tab, rows, gbox, n_groups, mat,
                                            lights, cam, p, n_chunks, chunk,
                                            out, next_tile, none);
  }
  add_rays(count, warp_rays, rays, tid);
}

// The cooperative form past kCoopNeeGroup lights: NEE in passes of
// kCoopNeeGroup lights (a separate instance, so that the one-pass
// instance keeps its registers: one kernel holding both ran the 8-light
// scaled frame 1.7% slower on an H100, PERF.md).
__global__ void __launch_bounds__(kBlockX * kBlockY, kCoopBlocks)
lights_render_kernel(const float* __restrict__ tab,
                     const float* __restrict__ rows,
                     const float* __restrict__ gbox, int n_groups,
                     const int32_t* __restrict__ mat,
                     const int32_t* __restrict__ lights,
                     const float* __restrict__ cam, tpt::RenderParams p,
                     int n_chunks, int chunk, float* __restrict__ out,
                     unsigned long long* __restrict__ rays,
                     int* __restrict__ next_tile) {
  __shared__ unsigned long long warp_rays[kWarps];
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  tpt::NoCoopCount none;
  const unsigned long long count = coop_render_body<tpt::CoopViewLights>(
      tab, rows, gbox, n_groups, mat, lights, cam, p, n_chunks, chunk, out,
      next_tile, none);
  add_rays(count, warp_rays, rays, tid);
}

// The cooperative form's tape-writing instance, the forward of the scaled
// scene's gradient (csrc/coopgrad.cuh): the same loop with a TapeSink a
// lane, which writes each bounce's carry record and each sample's bounces
// to the FrameTape ft.  Its image and rays are coop_render_kernel's (or
// lights_render_kernel's: kLights) bit for bit.
template <bool kLights>
__global__ void __launch_bounds__(kBlockX * kBlockY, kCoopBlocks)
tape_render_kernel(const float* __restrict__ tab,
                   const float* __restrict__ rows,
                   const float* __restrict__ gbox, int n_groups,
                   const int32_t* __restrict__ mat,
                   const int32_t* __restrict__ lights,
                   const float* __restrict__ cam, tpt::RenderParams p,
                   int n_chunks, int chunk, float* __restrict__ out,
                   unsigned long long* __restrict__ rays,
                   int* __restrict__ next_tile, tpt::FrameTape ft) {
  __shared__ unsigned long long warp_rays[kWarps];
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  tpt::TapeSink sink;
  sink.tape = ft;
  using View = typename std::conditional<kLights, tpt::CoopViewLights,
                                         tpt::CoopView>::type;
  const unsigned long long count = coop_render_body<View>(
      tab, rows, gbox, n_groups, mat, lights, cam, p, n_chunks, chunk, out,
      next_tile, sink);
  add_rays(count, warp_rays, rays, tid);
}

bool bad_chunks(int n_chunks, int chunk) {
  return n_chunks < 1 || n_chunks > tpt::kMaxChunks || chunk < 1;
}

}  // namespace

extern "C" {

// Group boxes the cooperative kernels take for n_chunks chunks.
int tpt_scaled_groups(int n_chunks) {
  return (n_chunks + tpt::kGroup - 1) / tpt::kGroup;
}

// K5's per-thread form (the baseline) on `stream` for n
// rays; returns cudaGetLastError() (0 when the launch was accepted).
// stats: null, or kStSlots zeroed totals that its counted instance adds to.
int tpt_hit_chunks_launch(const float* rows, int n_chunks, int chunk,
                          const float* ro, const float* rd, int n,
                          float t_min, float t_max, float* out_t,
                          int32_t* out_id, unsigned long long* stats,
                          void* stream) {
  if (bad_chunks(n_chunks, chunk) || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const size_t smem = sizeof(float) * 6 * n_chunks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kRayThreads - 1) / kRayThreads;
  auto kernel = stats ? hit_chunks_kernel<true> : hit_chunks_kernel<false>;
  const cudaError_t err = tpt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kRayThreads, smem, s>>>(rows, n_chunks, chunk, ro, rd, n,
                                           t_min, t_max, out_t, out_id,
                                           stats);
  return static_cast<int>(cudaGetLastError());
}

// K5's cooperative form (the main path's) on `stream` for n rays: t and ids
// into out_t, out_id (n,).  It takes scaled.chunk_index's order
// (n_chunks,), rec (n_chunks * chunk) sphere records and gbox
// (tpt_scaled_groups(n_chunks), 6) group boxes over that order, and next,
// one int zeroed by the caller.  stats: null, or kStSlots zeroed totals
// that its counted instance adds to.
int tpt_coop_hit_launch(const float* rows, const int32_t* order,
                        const tpt::Sphere4* rec, const float* gbox,
                        int n_chunks, int chunk, const float* ro,
                        const float* rd, int n, float t_min, float t_max,
                        int* next, float* out_t, int32_t* out_id,
                        unsigned long long* stats, void* stream) {
  if (bad_chunks(n_chunks, chunk) || n < 0 || !order || !rec || !gbox ||
      !next)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int n_groups = tpt_scaled_groups(n_chunks);
  const size_t smem =
      sizeof(float) * 6 * (n_chunks + n_groups) + sizeof(int32_t) * n_chunks +
      sizeof(unsigned) * (kRayThreads / 32) * tpt::chunk_words(n_chunks);
  int capacity = 0;
  cudaError_t err = tpt::cached_capacity(
      kRayThreads, smem, &capacity, coop_hit_kernel<false>,
      coop_hit_kernel<true>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = (n + 31) / 32;
  const int need = (warps + kRayThreads / 32 - 1) / (kRayThreads / 32);
  auto kernel = stats ? coop_hit_kernel<true> : coop_hit_kernel<false>;
  kernel<<<need < capacity ? need : capacity, kRayThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      rows, order, rec, gbox, n_groups, n_chunks, chunk, ro, rd, n, t_min,
      t_max, next, out_t, out_id, stats);
  return static_cast<int>(cudaGetLastError());
}

// K6 on `stream` for n rays and n_lights lights (bits into out (n,)).
// form 0: the per-thread kernel; 1: the cooperative kernel, which takes
// scaled.chunk_index's order (n_chunks,), rec (n_chunks * chunk) sphere
// records and gbox (tpt_scaled_groups(n_chunks), 6) group boxes over that
// order, and next, one int zeroed by the caller.  stats: null, or kStSlots
// zeroed totals that the form's counted instance adds to.
int tpt_shadow_chunks_launch(const float* rows, const int32_t* order,
                             const tpt::Sphere4* rec, const float* gbox,
                             int n_chunks, int chunk, const float* ro,
                             const float* dirs, const float* t_ls,
                             const int32_t* light_ids, int n_lights, int n,
                             float t_min, int form, int* next, int32_t* out,
                             unsigned long long* stats, void* stream) {
  if (bad_chunks(n_chunks, chunk) || n < 0 || n_lights < 0 ||
      n_lights > tpt::kMaxLights || form < 0 || form > 1 ||
      (form == 1 && (!order || !rec || !gbox || !next)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (form == 0) {
    const size_t smem = sizeof(float) * 6 * n_chunks;
    auto kernel = stats ? shadow_chunks_kernel<true>
                        : shadow_chunks_kernel<false>;
    err = tpt::allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<(n + kRayThreads - 1) / kRayThreads, kRayThreads, smem, s>>>(
        rows, n_chunks, chunk, ro, dirs, t_ls, light_ids, n_lights, n, t_min,
        out, stats);
    return static_cast<int>(cudaGetLastError());
  }
  const int n_groups = tpt_scaled_groups(n_chunks);
  const size_t smem = sizeof(float) * 6 * (n_chunks + n_groups) +
                      sizeof(int32_t) * (n_chunks + n_lights);
  int capacity = 0;
  err = tpt::cached_capacity(kRayThreads, smem, &capacity,
                             coop_shadow_kernel<false>,
                             coop_shadow_kernel<true>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = (n + 31) / 32;
  const int need = (warps + kRayThreads / 32 - 1) / (kRayThreads / 32);
  auto kernel = stats ? coop_shadow_kernel<true> : coop_shadow_kernel<false>;
  kernel<<<need < capacity ? need : capacity, kRayThreads, smem, s>>>(
      rows, order, rec, gbox, n_groups, n_chunks, chunk, ro, dirs, t_ls,
      light_ids, n_lights, n, t_min, next, out, stats);
  return static_cast<int>(cudaGetLastError());
}

// A scaled render kernel on `stream`: image `out` (height, width, 3) and
// the ray count added to `rays` (zeroed by the caller).  form 0: the
// per-lane kernel (at most kMaxLights lights); 1: the cooperative kernel
// (any number: past kCoopNeeGroup its lights instance, which has no stats
// instance), which takes gbox, the (tpt_scaled_groups(n_chunks), 6)
// group boxes, and next_tile, one int zeroed by the caller; 2: the
// cooperative kernel's tape-writing instance, which also writes the
// FrameTape (tape_rec, tape_see, tape_depth: the gradient's forward,
// csrc/coopgrad.cuh).  stats: null, or kStSlots zeroed totals that the
// form's stats instance adds to (forms 0 and 1).
int tpt_scaled_render_launch(const float* tab, const float* rows,
                             const float* gbox, const int32_t* mat,
                             const int32_t* lights, const float* cam,
                             const tpt::RenderParams* p, int n_chunks,
                             int chunk, int form, float* out,
                             unsigned long long* rays, int* next_tile,
                             unsigned long long* stats, float* tape_rec,
                             uint32_t* tape_see, int32_t* tape_depth,
                             void* stream) {
  if (bad_chunks(n_chunks, chunk) || p->n_spheres != n_chunks * chunk ||
      p->n_lights < 0 || (form == 0 && p->n_lights > tpt::kMaxLights) ||
      p->height < 1 || p->width < 1 || form < 0 || form > 2 ||
      (form >= 1 && (!gbox || !next_tile)) ||
      (form == 1 && stats && p->n_lights > tpt::kCoopNeeGroup) ||
      (form == 2 && (stats || !tape_rec || !tape_depth ||
                     (p->n_lights > 0 && !tape_see))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_groups = tpt_scaled_groups(n_chunks);
  size_t smem = sizeof(float) * (6 * n_chunks + tpt::kCameraFloats) +
                sizeof(int32_t) * p->n_lights;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (form == 0) {
    auto kernel = stats ? scaled_render_kernel<true>
                        : scaled_render_kernel<false>;
    err = tpt::allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid((p->width + kBlockX - 1) / kBlockX,
                    (p->height + kBlockY - 1) / kBlockY);
    kernel<<<grid, block, smem, s>>>(tab, rows, mat, lights, cam, *p,
                                     n_chunks, chunk, out, rays, stats);
  } else {
    smem += sizeof(float) * (6 * n_groups +
                             kWarps * tpt::nee_words(
                                          tpt::nee_group(p->n_lights), 32));
    const bool many = p->n_lights > tpt::kCoopNeeGroup;
    auto kernel = stats ? coop_render_kernel<true> : coop_render_kernel<false>;
    auto tape = many ? tape_render_kernel<true> : tape_render_kernel<false>;
    err = form == 2 ? tpt::allow_smem(tape, smem)
          : many    ? tpt::allow_smem(lights_render_kernel, smem)
                    : tpt::allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    // as many blocks as fit on the card at once, or as the tiles need
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles = ((p->width + 15) / 16) * ((p->height + 1) / 2);
    const int blocks = (tiles + kWarps - 1) / kWarps;
    const dim3 block(kBlockX, kBlockY);
    const int grid = blocks < sms * kCoopBlocks ? blocks : sms * kCoopBlocks;
    if (form == 2) {
      tpt::FrameTape ft;
      ft.rec = tape_rec;
      ft.see = tape_see;
      ft.depth = tape_depth;
      ft.words = tpt::light_words(p->n_lights);
      ft.spp = p->spp;
      ft.max_depth = p->max_depth;
      ft.width = p->width;
      tape<<<grid, block, smem, s>>>(tab, rows, gbox, n_groups, mat, lights,
                                     cam, *p, n_chunks, chunk, out, rays,
                                     next_tile, ft);
    } else if (many) {
      lights_render_kernel<<<grid, block, smem, s>>>(
          tab, rows, gbox, n_groups, mat, lights, cam, *p, n_chunks, chunk,
          out, rays, next_tile);
    } else {
      kernel<<<grid, block, smem, s>>>(tab, rows, gbox, n_groups, mat, lights,
                                       cam, *p, n_chunks, chunk, out, rays,
                                       next_tile, stats);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
