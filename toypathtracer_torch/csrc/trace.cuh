// Per-pixel path-tracing core of the render kernels (csrc/render.cu), of
// the gradient and lockstep kernels (csrc/grad.cu) and of the scaled render
// kernel (csrc/scaled.cu, through csrc/chunks.cuh's ChunkedView):
// render_pixel, and its hand-written reverse mode grad_pixel at the end of
// this file.  The merged path loops (csrc/merged.cuh: K1 on the main path
// with csrc/flat.cuh, the scaled render with csrc/coop.cuh) run the same
// per-ray arithmetic, taken from here, and are bit-equal to render_pixel.
//
// render_pixel is the per-thread form of the TPU kernel
// toypathtracer_tpu/ops/pallas_render.py::_render_kernel, whose body is
// tracecore.render_pixels_fused_merged.  The TPU kernel runs a persistent
// wavefront over (tile_h, tile_w) lane tiles with bit-packed lane state,
// because a TPU core is one wide vector unit.  Here one thread takes a
// pixel, as the reference's own compute shader does
// (Cpp/Windows/ComputeShader.hlsl): each thread walks its spp samples in
// order, and each sample runs up to max_depth bounces of hit -> classify ->
// scatter + NEE -> accumulate.
//
// What bounds it: FP32 ALU work, ~20 operations per sphere per traced ray
// and ~15 per sphere per shadow ray, against almost no memory traffic (the
// scene sits in shared memory, the image is written once).  A warp of such
// threads waits at each sample's end for its deepest lane: the merged
// loops exist for that.
//
// Everything here is __host__ __device__ and free of CUDA-only constructs,
// so the same source also builds with a host C++ compiler for the CPU tests.
// Float semantics follow the JAX package exactly: every literal is float,
// constants the JAX package builds as jnp.float32(<double expression>) are
// rounded once from double, sqrtf/sinf/cosf/expf/logf (no fast-math
// intrinsics), 1/sqrtf and never rsqrtf, and the build disables FMA
// contraction (-fmad=false) so each product and sum rounds on its own.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define TPT_HD __host__ __device__ __forceinline__
#else
#define TPT_HD inline
#endif

namespace tpt {

// Rows of the packed (SCENE_ROWS, N) scene table (ops/cuda_render.pack_scene).
enum {
  ROW_CX = 0, ROW_CY = 1, ROW_CZ = 2, ROW_SQR = 3, ROW_INVR = 4, ROW_R = 5,
  ROW_ALB = 6, ROW_EM = 9, ROW_ROUGH = 12, ROW_RI = 13, SCENE_ROWS = 14
};
enum { MAT_LAMBERT = 0, MAT_METAL = 1, MAT_DIELECTRIC = 2 };

// Largest scene the per-thread kernels stage in shared memory (60 bytes per
// sphere), and their lights (NEE's `see` bits in a uint32_t, 16 of them in
// the gradient kernels' carry records); the merged K1 stages up to
// kMaxSpheres and reads device memory beyond, and takes any light count,
// as do the gradient kernels' instances that keep `see` in LightBits.
constexpr int kMaxSpheres = 512;
constexpr int kMaxLights = 16;
constexpr int kCameraFloats = 22;

// Mirrored field for field by ops/_build.RenderParams (ctypes).
struct RenderParams {
  int32_t x0, y0;           // global pixel of the sub-image's lower left
  int32_t height, width;    // sub-image size
  uint32_t frame;           // RNG frame index, modulo 2^32
  int32_t spp, max_depth;
  int32_t light_sampling, mitsuba;
  int32_t n_spheres, n_lights;
  float inv_w, inv_h;       // float32(1/cfg.width), float32(1/cfg.height)
  float inv_spp;            // float32(1/spp)
  float t_min, t_max;
  float soft_eps;           // the soft-silhouette estimator's eps (K3; 0: off)
};

// A sphere's center and squared radius, rows ROW_CX..ROW_SQR of the packed
// table: the merged K1's records (ops/cuda_render.pack_records) and the
// cooperative K6's (scaled.chunk_index).
struct alignas(16) Sphere4 {
  float x, y, z, r2;
};

struct SceneView {
  const float* tab;         // (SCENE_ROWS, n) row-major
  const int32_t* mat;       // (n,)
  const int32_t* lights;    // (n_lights,) emissive sphere ids
  int n, n_lights;
  TPT_HD float at(int row, int i) const { return tab[row * n + i]; }
};

// float32(2 * 3.1415926), float32(3.1415926), float32(1/3): rounded once
// from double, as jnp.float32(2.0 * KPI) etc.
#define TPT_TWO_PI ((float)(2.0 * 3.1415926))
#define TPT_PI ((float)3.1415926)
#define TPT_THIRD ((float)(1.0 / 3.0))

struct V3 { float x, y, z; };

TPT_HD V3 v3(float x, float y, float z) { V3 r; r.x = x; r.y = y; r.z = z; return r; }
TPT_HD V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
TPT_HD V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
TPT_HD V3 mul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
TPT_HD V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
TPT_HD V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
TPT_HD float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
TPT_HD V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, -(a.x * b.z - a.z * b.x),
            a.x * b.y - a.y * b.x);
}
TPT_HD V3 normalize(V3 a) {
  float inv = 1.0f / sqrtf(dot(a, a));
  return scale(a, inv);
}
TPT_HD V3 reflect(V3 v, V3 n) { return sub(v, scale(n, 2.0f * dot(v, n))); }
// sqrt(max(x, 0)): real-valued for every input (tracecore.py:803-811).
TPT_HD float sqrt_pos(float x) { return sqrtf(x > 0.0f ? x : 0.0f); }
TPT_HD float max0(float x) { return x > 0.0f ? x : 0.0f; }

// ---- RNG: XorShift32 (Maths.cpp:5-18), per-pixel seeding (hlsl:380) ----

TPT_HD uint32_t xorshift32(uint32_t x) {
  x ^= x << 13;
  x ^= x >> 17;
  x ^= x << 15;
  return x;
}

TPT_HD float rand01(uint32_t& s) {
  s = xorshift32(s);
  return (float)(s & 0xFFFFFFu) * (1.0f / 16777216.0f);
}

TPT_HD uint32_t seed_pixel(uint32_t x, uint32_t y, uint32_t frame) {
  return (x * 1973u + y * 9277u + frame * 26699u) | 1u;
}

// ---- GPU samplers (ComputeShader.hlsl:18-44), fixed draw counts ----

TPT_HD void unit_disk(uint32_t& s, float& dx, float& dy) {
  float r1 = rand01(s);
  float a = r1 * TPT_TWO_PI;
  float r2 = rand01(s);
  float r = sqrtf(r2);
  dx = cosf(a) * r;
  dy = sinf(a) * r;
}

TPT_HD V3 unit_sphere(uint32_t& s) {
  float r1 = rand01(s);
  float z = r1 * 2.0f - 1.0f;
  float r2 = rand01(s);
  float t = r2 * TPT_TWO_PI;
  float r = sqrtf(max0(1.0f - z * z));
  float x = r * cosf(t);
  float y = r * sinf(t);
  float r3 = rand01(s);
  float cube = expf(logf(r3) * TPT_THIRD);  // log(0) = -inf -> 0
  return v3(x * cube, y * cube, z * cube);
}

TPT_HD V3 unit_vector(uint32_t& s) {
  float r1 = rand01(s);
  float z = r1 * 2.0f - 1.0f;
  float r2 = rand01(s);
  float a = r2 * TPT_TWO_PI;
  float r = sqrtf(1.0f - z * z);
  return v3(r * cosf(a), r * sinf(a), z);
}

// ---- geometry ----

// Nearest valid root of sphere i (Maths.cpp:97-117); false if none.
// The forward code below is templated on the scene view: SceneView (the
// whole table, brute force) or ChunkedView (csrc/chunks.cuh); its calls of
// nearest_hit and occluded find the view's overloads by argument-dependent
// lookup.
template <class View>
TPT_HD bool sphere_t(const View& S, int i, V3 ro, V3 rd, float t_min,
                     float& t) {
  float cox = S.at(ROW_CX, i) - ro.x;
  float coy = S.at(ROW_CY, i) - ro.y;
  float coz = S.at(ROW_CZ, i) - ro.z;
  float nb = cox * rd.x + coy * rd.y + coz * rd.z;
  float c = cox * cox + coy * coy + coz * coz - S.at(ROW_SQR, i);
  float discr = nb * nb - c;
  float ds = sqrt_pos(discr);
  float t0 = nb - ds;
  float t1 = nb + ds;
  t = t0 > t_min ? t0 : t1;
  return discr > 0.0f && t > t_min;
}

// Running argmin with a strict `<`: the first sphere of least t wins.
TPT_HD int nearest_hit(const SceneView& S, V3 ro, V3 rd, float t_min,
                       float t_max, float& hit_t) {
  int id = -1;
  hit_t = t_max;
  for (int i = 0; i < S.n; ++i) {
    float t;
    if (sphere_t(S, i, ro, rd, t_min, t) && t < hit_t) {
      hit_t = t;
      id = i;
    }
  }
  return id;
}

// The JAX package's interval-overlap shadow test (tracecore._occ_test), kept
// comparison for comparison: does any sphere but the light overlap the
// segment (t_min, t_l)?  Unlike an exact nearest-hit test it reports a ray
// that starts inside a sphere spanning the light as occluded.
TPT_HD bool occluded(const SceneView& S, V3 pos, V3 l, int light,
                     float t_min, float t_l) {
  for (int i = 0; i < S.n; ++i) {
    if (i == light) continue;
    float cox = S.at(ROW_CX, i) - pos.x;
    float coy = S.at(ROW_CY, i) - pos.y;
    float coz = S.at(ROW_CZ, i) - pos.z;
    float c = cox * cox + coy * coy + coz * coz - S.at(ROW_SQR, i);
    float nb = cox * l.x + coy * l.y + coz * l.z;
    float d = nb * nb - c;
    float a = nb - t_min;
    float b = nb - t_l;
    if (d > 0.0f && d > b * fabsf(b) && d > -(a * fabsf(a))) return true;
  }
  return false;
}

TPT_HD V3 sky_color(V3 rd, bool mitsuba) {
  if (mitsuba) return v3(0.15f, 0.21f, 0.3f);
  float t = 0.5f * (rd.y + 1.0f);
  float one_t = 1.0f - t;
  return v3((one_t * 1.0f + t * 0.5f) * 0.3f,
            (one_t * 1.0f + t * 0.7f) * 0.3f,
            (one_t * 1.0f + t * 1.0f) * 0.3f);
}

// Camera layout: origin, lower_left, horizontal, vertical, u, v, w (3 floats
// each), lens_radius (camera.camera_to_array).
TPT_HD void camera_ray(const float* cam, float s, float t, uint32_t& st,
                       V3& ro, V3& rd) {
  V3 origin = v3(cam[0], cam[1], cam[2]);
  V3 llc = v3(cam[3], cam[4], cam[5]);
  V3 hor = v3(cam[6], cam[7], cam[8]);
  V3 ver = v3(cam[9], cam[10], cam[11]);
  V3 u = v3(cam[12], cam[13], cam[14]);
  V3 v = v3(cam[15], cam[16], cam[17]);
  float lens = cam[21];
  float dx, dy;
  unit_disk(st, dx, dy);
  float rdx = lens * dx;
  float rdy = lens * dy;
  V3 off = add(scale(u, rdx), scale(v, rdy));
  ro = add(origin, off);
  rd = normalize(sub(sub(add(add(llc, scale(hor, s)), scale(ver, t)), origin),
                     off));
}

// NEE's cone sample toward light e from pos (Test.cpp:94-121), given its
// two draws: the frame (sw toward the light's center, su, sv), the cone's
// half-angle cosine cos_a_max from the light's radius, and the sampled
// direction l.  Both nee and its adjoint build it here.
struct Cone {
  V3 sc, dp, sw, up, w1, su, sv, l;
  float r, d2, cos_a_max, cos_a, sin_a, cphi, sphi;
};

template <class View>
TPT_HD Cone cone(const View& S, int e, V3 pos, float eps1, float eps2) {
  Cone q;
  q.sc = v3(S.at(ROW_CX, e), S.at(ROW_CY, e), S.at(ROW_CZ, e));
  q.r = S.at(ROW_R, e);
  q.sw = normalize(sub(q.sc, pos));
  q.up = fabsf(q.sw.x) > 0.01f ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
  q.w1 = cross(q.up, q.sw);
  q.su = normalize(q.w1);
  q.sv = cross(q.sw, q.su);
  q.dp = sub(pos, q.sc);
  q.d2 = dot(q.dp, q.dp);
  q.cos_a_max = sqrt_pos(1.0f - q.r * q.r / q.d2);
  q.cos_a = 1.0f - eps1 + eps1 * q.cos_a_max;
  q.sin_a = sqrt_pos(1.0f - q.cos_a * q.cos_a);
  const float phi = TPT_TWO_PI * eps2;
  q.cphi = cosf(phi);
  q.sphi = sinf(phi);
  q.l = add(add(scale(q.su, q.cphi * q.sin_a), scale(q.sv, q.sphi * q.sin_a)),
            scale(q.sw, q.cos_a));
  return q;
}

// A lane's seen lights, NEE's `see`: bit k set when light k contributed.
// A uint32_t where a launch has at most kMaxLights lights (a shift by 32 or
// more would be undefined: the launchers refuse more), or LightBits, words
// of memory that hold any number, light_words(n_lights) a record (the
// gradient kernels' instances past kMaxLights).  The overloads below give
// the two the same interface; on a uint32_t they are the operations the
// code wrote before, so those instances compile as they did.
struct LightBits {
  uint32_t* w;
};

TPT_HD int light_words(int n_lights) { return (n_lights + 31) / 32; }
TPT_HD void see_clear(uint32_t& s, int) { s = 0; }
TPT_HD void see_set(uint32_t& s, int k) { s |= 1u << k; }
// The bits a carry record packs (trace.cuh pack_rec: 16 lights).
TPT_HD uint32_t see_pack(uint32_t s) { return s << 16; }
TPT_HD void see_clear(LightBits& s, int n_lights) {
  for (int i = 0; i < light_words(n_lights); ++i) s.w[i] = 0u;
}
TPT_HD void see_set(LightBits& s, int k) { s.w[k >> 5] |= 1u << (k & 31); }
// `see >> k` for LightBits: the word of light k shifted so that its bit 0
// is light k's, so that (see >> k) & 1u reads light k's bit from either
// (the 16-light instances' code keeps that expression, and its SASS).
TPT_HD uint32_t operator>>(const LightBits& s, int k) {
  return s.w[k >> 5] >> (k & 31);
}
TPT_HD uint32_t see_pack(const LightBits&) { return 0u; }

// Lambert NEE (Test.cpp:94-133): per light in emissive-id order, unless the
// hit sphere is that light, a cone sample (2 draws), one shadow ray, and the
// contribution if the light is visible.  Adds the shadow rays to `rays` and
// sets bit k of `see` when light k contributed.  vis=false skips the shadow
// tests (no light is seen) but draws and counts the same: the gradient
// kernel's replays need the path and the RNG state, not the radiance.
template <class View, class See>
TPT_HD V3 nee(const View& S, const RenderParams& p, V3 pos, V3 normal,
              V3 rd, V3 alb, int hit_id, bool vis, uint32_t& st,
              uint32_t& rays, See& see) {
  V3 light_e = v3(0.0f, 0.0f, 0.0f);
  V3 nl = dot(normal, rd) < 0.0f ? normal : neg(normal);
  see_clear(see, S.n_lights);
  for (int k = 0; k < S.n_lights; ++k) {
    int e = S.lights[k];
    if (e == hit_id) continue;  // self-skip (ComputeShader.hlsl:204)
    float eps1 = rand01(st);
    float eps2 = rand01(st);
    ++rays;
    if (!vis) continue;
    Cone q = cone(S, e, pos, eps1, eps2);
    float t_l;
    bool seen = sphere_t(S, e, pos, q.l, p.t_min, t_l) && t_l < p.t_max &&
                !occluded(S, pos, q.l, e, p.t_min, t_l);
    if (!seen) continue;
    float omega = TPT_TWO_PI * (1.0f - q.cos_a_max);
    float fac = max0(dot(q.l, nl)) * omega / TPT_PI;
    V3 em = v3(S.at(ROW_EM, e), S.at(ROW_EM + 1, e), S.at(ROW_EM + 2, e));
    light_e = v3(light_e.x + (alb.x * em.x) * fac,
                 light_e.y + (alb.y * em.y) * fac,
                 light_e.z + (alb.z * em.z) * fac);
    see_set(see, k);
  }
  return light_e;
}

// Schlick-weighted reflect/refract, 1 draw (Test.cpp:151-186); `took_refl`
// says which branch the draw chose.
TPT_HD V3 scatter_dielectric(uint32_t& st, V3 rd, V3 normal, V3 refl,
                             float ri, bool& took_refl) {
  float rdn = dot(rd, normal);
  bool entering = rdn <= 0.0f;
  V3 outward = entering ? normal : neg(normal);
  float safe_ri = ri == 0.0f ? 1.0f : ri;
  float nint = entering ? 1.0f / safe_ri : ri;
  float cosine = entering ? -rdn : ri * rdn;
  float dt = dot(rd, outward);
  float discr = 1.0f - nint * nint * (1.0f - dt * dt);
  V3 refr = sub(scale(sub(rd, scale(outward, dt)), nint),
                scale(outward, sqrt_pos(discr)));
  float refl_prob = 1.0f;
  if (discr > 0.0f) {
    float r0 = (1.0f - ri) / (1.0f + ri);
    r0 = r0 * r0;
    float x = 1.0f - cosine;
    x = x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
    float x2 = x * x;
    refl_prob = r0 + (1.0f - r0) * (x2 * x2 * x);
  }
  float rr = rand01(st);
  took_refl = rr < refl_prob;
  return normalize(took_refl ? refl : refr);
}

// What the adjoint of a bounce needs besides the bounce's inputs.
template <class See>
struct BounceRecOf {
  int id;          // the sphere hit, -1 on a miss
  float t;         // its root
  bool scattered;  // the path goes on (false: a miss or an absorbed metal ray)
  bool gated;      // the sphere's emission counts (the do_me gate, hlsl:314)
  bool refl;       // dielectric: the draw chose the reflected ray
  See see;         // NEE: bit k set when light k contributed
};

using BounceRec = BounceRecOf<uint32_t>;

// One bounce of one sample (ComputeShader.hlsl:294-343): trace (ro, rd),
// shade the nearest hit with NEE, scatter.  Sets this depth's emission e
// and continuation attenuation c (the sample adds atten * e, then
// atten *= c), advances (ro, rd, st, do_me), and returns false where the
// path ends: a miss (e = sky) or an absorbed metal ray (e = the ungated
// emission).
template <class View, class See>
TPT_HD bool bounce(const View& S, const RenderParams& p, bool vis,
                   V3& ro, V3& rd, uint32_t& st, bool& do_me, uint32_t& rays,
                   V3& e, V3& c, BounceRecOf<See>& rec) {
  ++rays;
  float t;
  int id = nearest_hit(S, ro, rd, p.t_min, p.t_max, t);
  rec.id = id;
  rec.t = t;
  rec.scattered = false;
  rec.gated = !p.light_sampling || do_me;
  rec.refl = false;
  see_clear(rec.see, S.n_lights);
  c = v3(0.0f, 0.0f, 0.0f);
  if (id < 0) {
    e = sky_color(rd, p.mitsuba != 0);
    return false;
  }
  V3 pos = add(ro, scale(rd, t));
  V3 cen = v3(S.at(ROW_CX, id), S.at(ROW_CY, id), S.at(ROW_CZ, id));
  V3 normal = scale(sub(pos, cen), S.at(ROW_INVR, id));
  V3 alb = v3(S.at(ROW_ALB, id), S.at(ROW_ALB + 1, id), S.at(ROW_ALB + 2, id));
  V3 em = v3(S.at(ROW_EM, id), S.at(ROW_EM + 1, id), S.at(ROW_EM + 2, id));
  int mt = S.mat[id];
  V3 refl = reflect(rd, normal);
  V3 dir;
  V3 light_e = v3(0.0f, 0.0f, 0.0f);
  V3 attenuation = alb;
  if (mt == MAT_LAMBERT) {
    V3 ruv = unit_vector(st);
    dir = normalize(sub(add(add(pos, normal), ruv), pos));
    if (p.light_sampling)
      light_e = nee(S, p, pos, normal, rd, alb, id, vis, st, rays, rec.see);
  } else if (mt == MAT_METAL) {
    float rough = p.mitsuba ? 0.0f : S.at(ROW_ROUGH, id);
    V3 rius = unit_sphere(st);
    dir = normalize(add(refl, scale(rius, rough)));
    if (!(dot(dir, normal) > 0.0f)) {
      e = em;
      return false;
    }
  } else {
    dir = scatter_dielectric(st, rd, normal, refl, S.at(ROW_RI, id), rec.refl);
    attenuation = v3(1.0f, 1.0f, 1.0f);
  }
  V3 gated = rec.gated ? em : v3(0.0f, 0.0f, 0.0f);
  if (p.light_sampling) do_me = mt != MAT_LAMBERT;
  e = add(gated, light_e);
  c = attenuation;
  rec.scattered = true;
  ro = pos;
  rd = dir;
  return true;
}

// A sample's camera ray: two jitter draws, then the thin-lens ray.
TPT_HD void sample_ray(const float* cam, const RenderParams& p, int x, int y,
                       uint32_t& st, V3& ro, V3& rd) {
  float ur = rand01(st);
  float u = ((float)x + ur) * p.inv_w;
  float vr = rand01(st);
  float v = ((float)y + vr) * p.inv_h;
  camera_ray(cam, u, v, st, ro, rd);
}

// One sample traced to its end, at most max_depth bounces: returns its
// radiance, sets `depth` to the bounces it ran and `cut` to whether it was
// still alive after them (ended by the depth cutoff, not by a miss or an
// absorbed ray).  A sample that scatters at depth max_depth keeps that
// bounce's emission and NEE and adds no sky (ComputeShader.hlsl:300).
template <class View>
TPT_HD V3 trace_sample(const View& S, const RenderParams& p, V3 ro,
                       V3 rd, uint32_t& st, uint32_t& rays, int& depth,
                       bool& cut) {
  V3 col = v3(0.0f, 0.0f, 0.0f);
  V3 atten = v3(1.0f, 1.0f, 1.0f);
  bool do_me = true;  // emission not yet counted by NEE (hlsl:314-325)
  V3 e, c;
  BounceRec rec;
  depth = 0;
  cut = false;
  while (depth < p.max_depth) {
    bool go = bounce(S, p, true, ro, rd, st, do_me, rays, e, c, rec);
    col = add(col, mul(atten, e));
    ++depth;
    cut = go;
    if (!go) break;
    atten = mul(atten, c);
  }
  return col;
}

// What render_pixel reports of each sample besides the image.  The render
// kernels pass NoTrips, which compiles to nothing; the stats render kernel
// (K2, csrc/render.cu) passes a counter derived from Trips.  A counter
// whose live() is false makes render_pixel trace nothing: the thread walks
// the sample loop with depth 0, so that a warp-wide reduction in sample()
// still sees every lane at the same call.
struct NoTrips {
  TPT_HD bool live() const { return true; }
  TPT_HD void sample(int, bool) {}
};

// A pixel's trip counts, from which the TPU kernel's per-tile occupancy
// counters follow exactly (ops/cuda_render.tile_counters).
struct Trips {
  int32_t bounces = 0;      // b: bounce() calls over the samples
  int32_t cutoffs = 0;      // c: samples still alive after max_depth
  int32_t last_cutoff = 0;  // l: 1 when the last sample was one of them
  TPT_HD bool live() const { return true; }
  TPT_HD void sample(int depth, bool cut) {
    bounces += depth;
    cutoffs += cut ? 1 : 0;
    last_cutoff = cut ? 1 : 0;
  }
};

// One pixel: spp samples; writes the sample mean to out[0..2], reports
// each sample's bounces to `trips`, and returns the pixel's rays (camera,
// bounce and shadow rays).
template <class View, class Counter>
TPT_HD uint32_t render_pixel(const View& S, const float* cam,
                             const RenderParams& p, int x, int y,
                             float* out, Counter& trips) {
  uint32_t st = seed_pixel((uint32_t)x, (uint32_t)y, p.frame);
  uint32_t rays = 0;
  V3 sum = v3(0.0f, 0.0f, 0.0f);
  const bool live = trips.live();
  for (int s = 0; s < p.spp; ++s) {
    int depth = 0;
    bool cut = false;
    if (live) {
      V3 ro, rd;
      sample_ray(cam, p, x, y, st, ro, rd);
      sum = add(sum, trace_sample(S, p, ro, rd, st, rays, depth, cut));
    }
    trips.sample(depth, cut);
  }
  out[0] = sum.x * p.inv_spp;
  out[1] = sum.y * p.inv_spp;
  out[2] = sum.z * p.inv_spp;
  return rays;
}

template <class View>
TPT_HD uint32_t render_pixel(const View& S, const float* cam,
                             const RenderParams& p, int x, int y,
                             float* out) {
  NoTrips none;
  return render_pixel(S, cam, p, x, y, out, none);
}

// ---- Adjoint: the gradient kernel's per-pixel code (csrc/grad.cu) ----
//
// Reverse mode written by hand: d(pixel)/d(packed scene table), the
// function autograd differentiates through the plain version
// (render/wavefront.render_tile_grad_plain) and the TPU kernel through
// jax.vjp.  Hard selects are straight-through, as autograd sees them: the
// nearest-hit argmin, the material branch, the dielectric draw, the shadow
// test and the do_me gate pass no gradient, and a gradient reaches only
// the values the taken branch used.  `acc` is a (SCENE_ROWS, n) cotangent
// table that each adjoint adds to.

TPT_HD void acc3(float* acc, int n, int row, int i, V3 g) {
  acc[row * n + i] += g.x;
  acc[(row + 1) * n + i] += g.y;
  acc[(row + 2) * n + i] += g.z;
}

// The cotangent of a for the cotangent g of normalize(a).
TPT_HD V3 normalize_adj(V3 a, V3 g) {
  float inv = 1.0f / sqrtf(dot(a, a));
  float k = dot(a, g) * inv * inv * inv;
  return sub(scale(g, inv), scale(a, k));
}

// The adjoints of a bounce's pieces, returning what they add to the scene
// cotangent instead of adding it: bounce_adj below adds it to a table a
// thread owns, the warp form (csrc/gradwarp.cuh) through warp collectives.

// The winner's root t = nb -/+ sqrt(nb^2 - c) (sphere_t, same branch) back
// to the ray; sphere i's center rows take g_co, its radius^2 row g_sqr.
template <class View>
TPT_HD void sphere_t_adj_vals(const View& S, int i, V3 ro, V3 rd,
                              float t_min, float g_t, V3& g_ro, V3& g_rd,
                              V3& g_co, float& g_sqr) {
  V3 co = v3(S.at(ROW_CX, i) - ro.x, S.at(ROW_CY, i) - ro.y,
             S.at(ROW_CZ, i) - ro.z);
  float nb = co.x * rd.x + co.y * rd.y + co.z * rd.z;
  float c = co.x * co.x + co.y * co.y + co.z * co.z - S.at(ROW_SQR, i);
  float discr = nb * nb - c;
  float ds = sqrt_pos(discr);
  float sign = nb - ds > t_min ? -1.0f : 1.0f;
  float g_discr = discr > 0.0f ? sign * g_t * 0.5f / ds : 0.0f;
  float g_nb = g_t + 2.0f * nb * g_discr;
  float g_c = -g_discr;
  g_co = add(scale(rd, g_nb), scale(co, 2.0f * g_c));
  g_rd = add(g_rd, scale(co, g_nb));
  g_ro = sub(g_ro, g_co);
  g_sqr = -g_c;
}

// The cone sample back from the cotangents of l and of cos_a_max to pos;
// light e's radius row takes g_r (0 where the cone's half-angle is
// clamped), its center rows g_sc.
TPT_HD void cone_adj_vals(const Cone& q, float eps1, V3 g_l, float g_cam,
                          V3& g_pos, float& g_r, V3& g_sc) {
  V3 g_su = scale(g_l, q.cphi * q.sin_a);
  V3 g_sv = scale(g_l, q.sphi * q.sin_a);
  V3 g_sw = scale(g_l, q.cos_a);
  float g_sin = dot(g_l, q.su) * q.cphi + dot(g_l, q.sv) * q.sphi;
  float g_cos = dot(g_l, q.sw);
  if (1.0f - q.cos_a * q.cos_a > 0.0f) g_cos -= g_sin * q.cos_a / q.sin_a;
  g_cam += g_cos * eps1;
  g_sw = add(g_sw, cross(q.su, g_sv));
  g_su = add(g_su, cross(g_sv, q.sw));
  g_sw = add(g_sw, cross(normalize_adj(q.w1, g_su), q.up));
  g_sc = normalize_adj(neg(q.dp), g_sw);
  g_pos = sub(g_pos, g_sc);
  g_r = 0.0f;
  if (1.0f - q.r * q.r / q.d2 > 0.0f) {
    float g_x = g_cam * 0.5f / q.cos_a_max;
    g_r = g_x * (-2.0f * q.r / q.d2);
    V3 g_dp = scale(q.dp, 2.0f * (g_x * (q.r * q.r / (q.d2 * q.d2))));
    g_pos = add(g_pos, g_dp);
    g_sc = sub(g_sc, g_dp);
  }
}

// The refracted direction of scatter_dielectric back to the ray and the
// normal, for the cotangent g_dir of normalize(refr); returns the add to
// the sphere's ri row (0 for an entering ray at ri 0).
template <class View>
TPT_HD float refract_adj_vals(const View& S, int id, V3 rd, V3 normal,
                              V3 g_dir, V3& g_rd, V3& g_n) {
  float ri = S.at(ROW_RI, id);
  bool entering = dot(rd, normal) <= 0.0f;
  V3 o = entering ? normal : neg(normal);
  float safe_ri = ri == 0.0f ? 1.0f : ri;
  float nint = entering ? 1.0f / safe_ri : ri;
  float dt = dot(rd, o);
  float w = 1.0f - dt * dt;
  float discr = 1.0f - nint * nint * w;
  float sq = sqrt_pos(discr);
  V3 u = sub(rd, scale(o, dt));
  V3 g_r = normalize_adj(sub(scale(u, nint), scale(o, sq)), g_dir);
  V3 g_u = scale(g_r, nint);
  float g_nint = dot(u, g_r);
  V3 g_o = sub(scale(g_r, -sq), scale(g_u, dt));
  float g_dt = -dot(o, g_u);
  if (discr > 0.0f) {
    float g_discr = -dot(o, g_r) * 0.5f / sq;
    g_nint -= g_discr * (2.0f * nint * w);
    g_dt += g_discr * (2.0f * nint * nint * dt);
  }
  g_rd = add(g_rd, add(g_u, scale(o, g_dt)));
  g_o = add(g_o, scale(rd, g_dt));
  g_n = add(g_n, entering ? g_o : neg(g_o));
  if (!entering) return g_nint;
  if (ri != 0.0f) return -(g_nint / (safe_ri * safe_ri));
  return 0.0f;
}

TPT_HD void sphere_t_adj(const SceneView& S, int i, V3 ro, V3 rd, float t_min,
                         float g_t, V3& g_ro, V3& g_rd, float* acc) {
  V3 g_co;
  float g_sqr;
  sphere_t_adj_vals(S, i, ro, rd, t_min, g_t, g_ro, g_rd, g_co, g_sqr);
  acc3(acc, S.n, ROW_CX, i, g_co);
  acc[ROW_SQR * S.n + i] += g_sqr;
}

TPT_HD void cone_adj(const SceneView& S, int e, const Cone& q, float eps1,
                     V3 g_l, float g_cam, V3& g_pos, float* acc) {
  float g_r;
  V3 g_sc;
  cone_adj_vals(q, eps1, g_l, g_cam, g_pos, g_r, g_sc);
  if (1.0f - q.r * q.r / q.d2 > 0.0f) acc[ROW_R * S.n + e] += g_r;
  acc3(acc, S.n, ROW_CX, e, g_sc);
}

// ---- The soft-silhouette estimator's adjoint (soft_eps > 0) ----
//
// tracecore.bounce_parts(soft=True): the hit/miss select and each NEE
// light's visibility become straight-through sigmoids, sigma(d / eps), of
// a ray-sphere discriminant d = nb^2 - c.  Their forward values are the
// hard selects', so the image and the forward trace are as they were;
// the backward adds sigma'(d / eps) / eps times the cotangent of the
// weight into d, and through d into the sphere's center and radius^2 rows
// and the ray.  Three terms:
//   * a hit lane: the winner's d, the weight's cotangent
//     g_e . (e - sky) + g_c . c (e and c the bounce's, sky the ray's);
//   * a miss lane with a silhouette candidate (the sphere in front with
//     the largest d): its d, the cotangent g_e . (L - sky), L the
//     radiance at its tangent point (only L's value: its weight is 0);
//   * each NEE light whose hard visibility agrees with the sign of d_occ,
//     the largest d of the spheres whose closest approach lies in the
//     shadow segment: -sigma'(-d_occ / eps) / eps times
//     g_le . (alb * em) * fac into that occluder and, through the shadow
//     direction, the cone sample -- for occluded lights too.
// The candidate and the occluders are found again in the reverse sweep
// from the bounce's ray: a scan over the spheres for a miss, and one per
// light for a Lambert hit.

// The cotangent of d for the cotangent g of sigmoid(d / eps).
TPT_HD float soft_grad(float d, float eps, float g) {
  const float s = 1.0f / (1.0f + expf(-(d / eps)));
  return g * s * (1.0f - s) / eps;
}

// The miss side's silhouette candidate (tracecore.silhouette_query): the
// sphere with the largest d among those in front of the ray (nb > t_min),
// the first on ties, as a strict `>` chain from -1e9; -1 unless its d
// exceeds -1e8.  Sets its d and nb.
TPT_HD int silhouette_candidate(const SceneView& S, V3 ro, V3 rd,
                                float t_min, float& d_best, float& nb_best) {
  int cand = -1;
  d_best = -1e9f;
  nb_best = 0.0f;
  for (int i = 0; i < S.n; ++i) {
    float cox = S.at(ROW_CX, i) - ro.x;
    float coy = S.at(ROW_CY, i) - ro.y;
    float coz = S.at(ROW_CZ, i) - ro.z;
    float nb = cox * rd.x + coy * rd.y + coz * rd.z;
    float c = cox * cox + coy * coy + coz * coz - S.at(ROW_SQR, i);
    float d = nb * nb - c;
    if (nb > t_min && d > d_best) {
      d_best = d;
      nb_best = nb;
      cand = i;
    }
  }
  return d_best > -1e8f ? cand : -1;
}

// The soft shadow boundary's occluder (tracecore.
// _lights_occlusion_proximity): the largest d over the spheres but the
// light whose closest approach lies inside (t_min, t_l), the first on
// ties; -1 where there is none (d_occ = -1e9).
TPT_HD int shadow_occluder(const SceneView& S, V3 pos, V3 l, int light,
                           float t_min, float t_l, float& d_occ) {
  int j = -1;
  d_occ = -1e9f;
  for (int i = 0; i < S.n; ++i) {
    if (i == light) continue;
    float cox = S.at(ROW_CX, i) - pos.x;
    float coy = S.at(ROW_CY, i) - pos.y;
    float coz = S.at(ROW_CZ, i) - pos.z;
    float nb = cox * l.x + coy * l.y + coz * l.z;
    float c = cox * cox + coy * coy + coz * coz - S.at(ROW_SQR, i);
    float d = nb * nb - c;
    if (nb > t_min && nb < t_l && d > d_occ) {
      d_occ = d;
      j = i;
    }
  }
  return j;
}

// The radiance a ray would carry if it grazed sphere i at its closest
// approach nb (tracecore._tangent_radiance): Lambert -> emission + albedo
// * (unoccluded NEE expectation over every light + sky at the normal);
// metal -> albedo * sky(rd); dielectric -> sky(rd).  Its guards keep it
// finite: a normal of max(|to_c|^2, 1e-12), a light distance^2 of at
// least 1e-8.
template <class View>
TPT_HD V3 tangent_radiance(const View& S, const RenderParams& p, int i,
                           float nb, V3 ro, V3 rd) {
  const V3 pos = add(ro, scale(rd, nb));
  const V3 to_c = sub(pos, v3(S.at(ROW_CX, i), S.at(ROW_CY, i),
                              S.at(ROW_CZ, i)));
  const float n2 = dot(to_c, to_c);
  const V3 n = scale(to_c, 1.0f / sqrtf(n2 > 1e-12f ? n2 : 1e-12f));
  const V3 sky_d = sky_color(rd, p.mitsuba != 0);
  const V3 alb = v3(S.at(ROW_ALB, i), S.at(ROW_ALB + 1, i),
                    S.at(ROW_ALB + 2, i));
  const int mt = S.mat[i];
  if (mt == MAT_METAL) return mul(alb, sky_d);
  if (mt == MAT_DIELECTRIC) return sky_d;
  V3 nee = v3(0.0f, 0.0f, 0.0f);
  if (p.light_sampling) {
    for (int k = 0; k < S.n_lights; ++k) {
      const int e = S.lights[k];
      const V3 to_l = sub(v3(S.at(ROW_CX, e), S.at(ROW_CY, e),
                             S.at(ROW_CZ, e)), pos);
      float d2 = dot(to_l, to_l);
      d2 = d2 > 1e-8f ? d2 : 1e-8f;
      const float r = S.at(ROW_R, e);
      const float cos_a_max = sqrt_pos(1.0f - r * r / d2);
      const float omega = TPT_TWO_PI * (1.0f - cos_a_max);
      const V3 dir = scale(to_l, 1.0f / sqrtf(d2));
      const float fac = max0(dot(dir, n)) * omega / TPT_PI;
      nee = v3(nee.x + S.at(ROW_EM, e) * fac, nee.y + S.at(ROW_EM + 1, e) * fac,
               nee.z + S.at(ROW_EM + 2, e) * fac);
    }
  }
  const V3 sky_n = sky_color(n, p.mitsuba != 0);
  const V3 em = v3(S.at(ROW_EM, i), S.at(ROW_EM + 1, i), S.at(ROW_EM + 2, i));
  return add(em, mul(alb, add(nee, sky_n)));
}

// The discriminant d = nb^2 - c of sphere i along (ro, rd), as sphere_t
// computes it.
template <class View>
TPT_HD float discr(const View& S, int i, V3 ro, V3 rd) {
  float cox = S.at(ROW_CX, i) - ro.x;
  float coy = S.at(ROW_CY, i) - ro.y;
  float coz = S.at(ROW_CZ, i) - ro.z;
  float nb = cox * rd.x + coy * rd.y + coz * rd.z;
  float c = cox * cox + coy * coy + coz * coz - S.at(ROW_SQR, i);
  return nb * nb - c;
}

// That discriminant back from its cotangent g_d: adds to g_ro and g_rd,
// and returns sphere i's center (g_co) and radius^2 (g_sqr) cotangents.
template <class View>
TPT_HD void discr_adj_vals(const View& S, int i, V3 ro, V3 rd,
                           float g_d, V3& g_ro, V3& g_rd, V3& g_co,
                           float& g_sqr) {
  V3 co = v3(S.at(ROW_CX, i) - ro.x, S.at(ROW_CY, i) - ro.y,
             S.at(ROW_CZ, i) - ro.z);
  float nb = co.x * rd.x + co.y * rd.y + co.z * rd.z;
  float g_nb = 2.0f * nb * g_d;
  g_co = add(scale(rd, g_nb), scale(co, -2.0f * g_d));
  g_rd = add(g_rd, scale(co, g_nb));
  g_ro = sub(g_ro, g_co);
  g_sqr = g_d;
}

// NEE's soft shadow boundary for light e, whose cone sample leaves pos
// along l and was seen or not: the occluder's cotangents (center g_co,
// radius^2 g_sqr) for the cotangent g_vis of the light's visibility
// sigmoid(-d_occ / eps), with l's and pos's added to g_l and g_pos (the
// light's root t_l along l bounds the segment, valid or not).  Returns
// the occluder, or -1 where the term is 0: no sphere in the segment, or
// the interval-overlap test and the sign of d_occ disagree (the hard
// value stands).
template <class View>
TPT_HD int shadow_adj_vals(const View& S, const RenderParams& p, int e,
                           V3 pos, V3 l, bool seen, float g_vis, V3& g_l,
                           V3& g_pos, V3& g_co, float& g_sqr) {
  float t_l, d_occ;
  sphere_t(S, e, pos, l, p.t_min, t_l);
  const int j = shadow_occluder(S, pos, l, e, p.t_min, t_l, d_occ);
  if (j < 0 || seen != (d_occ < 0.0f)) return -1;
  discr_adj_vals(S, j, pos, l, -soft_grad(-d_occ, p.soft_eps, g_vis), g_pos,
                 g_l, g_co, g_sqr);
  return j;
}

// Adjoint of nee for the cotangent g_le of its light_e; st is the state
// nee started from and see the lights it saw.  kSoft adds the soft shadow
// boundary (shadow_adj_vals), for unseen lights too.
template <bool kSoft = false>
TPT_HD void nee_adj(const SceneView& S, const RenderParams& p, V3 pos,
                    V3 normal, V3 rd, V3 alb, int hit_id, uint32_t st,
                    uint32_t see, V3 g_le, V3& g_pos, V3& g_n, float* acc) {
  bool front = dot(normal, rd) < 0.0f;
  V3 nl = front ? normal : neg(normal);
  V3 g_nl = v3(0.0f, 0.0f, 0.0f);
  for (int k = 0; k < S.n_lights; ++k) {
    int e = S.lights[k];
    if (e == hit_id) continue;
    float eps1 = rand01(st);
    float eps2 = rand01(st);
    const bool seen = (see >> k) & 1u;
    if (!kSoft && !seen) continue;
    Cone q = cone(S, e, pos, eps1, eps2);
    float omega = TPT_TWO_PI * (1.0f - q.cos_a_max);
    float dl = dot(q.l, nl);
    float fac = max0(dl) * omega / TPT_PI;
    V3 em = v3(S.at(ROW_EM, e), S.at(ROW_EM + 1, e), S.at(ROW_EM + 2, e));
    if (seen) {
      // light_e += (alb * em) * fac
      acc3(acc, S.n, ROW_ALB, hit_id, mul(g_le, scale(em, fac)));
      acc3(acc, S.n, ROW_EM, e, mul(g_le, scale(alb, fac)));
    }
    if (!(dl > 0.0f)) continue;  // fac = max(dl, 0) * omega / pi = 0
    float g_fac = dot(g_le, mul(alb, em));
    V3 g_l = v3(0.0f, 0.0f, 0.0f);
    float g_cam = 0.0f;
    if (seen) {
      float g_dl = g_fac * omega / TPT_PI;
      g_cam = -TPT_TWO_PI * (g_fac * dl / TPT_PI);
      g_nl = add(g_nl, scale(q.l, g_dl));
      g_l = scale(nl, g_dl);
    }
    int j = -1;
    V3 g_co = v3(0.0f, 0.0f, 0.0f);
    float g_sqr = 0.0f;
    if constexpr (kSoft)
      j = shadow_adj_vals(S, p, e, pos, q.l, seen, fac * g_fac, g_l, g_pos,
                          g_co, g_sqr);
    if (seen || j >= 0) cone_adj(S, e, q, eps1, g_l, g_cam, g_pos, acc);
    if (j >= 0) {
      acc3(acc, S.n, ROW_CX, j, g_co);
      acc[ROW_SQR * S.n + j] += g_sqr;
    }
  }
  g_n = add(g_n, front ? g_nl : neg(g_nl));
}

TPT_HD void refract_adj(const SceneView& S, int id, V3 rd, V3 normal,
                        V3 g_dir, V3& g_rd, V3& g_n, float* acc) {
  acc[ROW_RI * S.n + id] +=
      refract_adj_vals(S, id, rd, normal, g_dir, g_rd, g_n);
}

// The silhouette term of a bounce's adjoint (kSoft): the weight's
// cotangent g_w into sphere i's discriminant along the bounce's ray, the
// ray's cotangents added to g_ro/g_rd and the sphere's to acc.
TPT_HD void silhouette_adj(const SceneView& S, const RenderParams& p, int i,
                           float d, V3 ro, V3 rd, float g_w, V3& g_ro,
                           V3& g_rd, float* acc) {
  V3 g_co;
  float g_sqr;
  discr_adj_vals(S, i, ro, rd, soft_grad(d, p.soft_eps, g_w), g_ro, g_rd,
                 g_co, g_sqr);
  acc3(acc, S.n, ROW_CX, i, g_co);
  acc[ROW_SQR * S.n + i] += g_sqr;
}

// The continuation attenuation c that bounce() set: the albedo, 1 for a
// dielectric, 0 where the path ended.
template <class View, class Rec>
TPT_HD V3 carry_c(const View& S, const Rec& r) {
  if (!r.scattered) return v3(0.0f, 0.0f, 0.0f);
  if (S.mat[r.id] == MAT_DIELECTRIC) return v3(1.0f, 1.0f, 1.0f);
  return v3(S.at(ROW_ALB, r.id), S.at(ROW_ALB + 1, r.id),
            S.at(ROW_ALB + 2, r.id));
}

// The cotangent of a hit lane's soft weight w: e = w e_hit + (1 - w) sky
// and c = w c_hit, with e and c the bounce's own.
template <class View, class Rec>
TPT_HD float hit_weight_grad(const View& S, const RenderParams& p,
                             const Rec& rec, V3 rd, V3 e, V3 g_e,
                             V3 g_c) {
  return dot(g_e, sub(e, sky_color(rd, p.mitsuba != 0))) +
         dot(g_c, carry_c(S, rec));
}

// Adjoint of one bounce.  In: the bounce's inputs (ro, rd, and st as it
// was when the bounce started), its record and emission e, the
// cotangents of its e and c, and in g_ro/g_rd those of the ray it passed
// on.  Out: g_ro/g_rd hold the cotangents of the ray it was given; the
// scene's are added to acc.  kSoft adds the soft-silhouette estimator's
// terms: the silhouette's, after the hard adjoint, and NEE's shadow
// boundary.
template <bool kSoft = false>
TPT_HD void bounce_adj(const SceneView& S, const RenderParams& p, V3 ro,
                       V3 rd, uint32_t st, const BounceRec& rec, V3 e,
                       V3 g_e, V3 g_c, V3& g_ro, V3& g_rd, float* acc) {
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  const V3 g_pos_out = g_ro;
  const V3 g_dir = g_rd;
  g_ro = zero;
  g_rd = zero;
  const int n = S.n;
  const int id = rec.id;
  if (id < 0) {  // e = sky_color(rd) = 0.3 * ((1 - t) + t * b), t = (rd.y+1)/2
    if (!p.mitsuba)
      g_rd.y = 0.5f * (g_e.x * ((0.5f - 1.0f) * 0.3f) +
                       g_e.y * ((0.7f - 1.0f) * 0.3f));
    if constexpr (kSoft) {  // e += w_m (L - sky), w_m = 0
      float d, nb;
      const int cand = silhouette_candidate(S, ro, rd, p.t_min, d, nb);
      if (cand >= 0)
        silhouette_adj(S, p, cand, d, ro, rd,
                       dot(g_e, sub(tangent_radiance(S, p, cand, nb, ro, rd),
                                    sky_color(rd, p.mitsuba != 0))),
                       g_ro, g_rd, acc);
    }
    return;
  }
  if (rec.gated || !rec.scattered) acc3(acc, n, ROW_EM, id, g_e);
  if (!rec.scattered) {  // absorbed metal: e is the emission alone
    if constexpr (kSoft)
      silhouette_adj(S, p, id, discr(S, id, ro, rd), ro, rd,
                     hit_weight_grad(S, p, rec, rd, e, g_e, g_c), g_ro, g_rd,
                     acc);
    return;
  }
  const V3 pos = add(ro, scale(rd, rec.t));
  const V3 pc = sub(pos, v3(S.at(ROW_CX, id), S.at(ROW_CY, id),
                            S.at(ROW_CZ, id)));
  const float invr = S.at(ROW_INVR, id);
  const V3 normal = scale(pc, invr);
  const int mt = S.mat[id];
  V3 g_pos = g_pos_out;
  V3 g_n = zero;
  V3 g_refl = zero;
  if (mt != MAT_DIELECTRIC) acc3(acc, n, ROW_ALB, id, g_c);  // c = albedo
  if (mt == MAT_LAMBERT) {
    V3 ruv = unit_vector(st);
    // (pos + normal + ruv) - pos: its derivative in pos is exactly 0
    g_n = normalize_adj(sub(add(add(pos, normal), ruv), pos), g_dir);
    if (p.light_sampling)
      nee_adj<kSoft>(S, p, pos, normal, rd,
                     v3(S.at(ROW_ALB, id), S.at(ROW_ALB + 1, id),
                        S.at(ROW_ALB + 2, id)),
                     id, st, rec.see, g_e, g_pos, g_n, acc);
  } else if (mt == MAT_METAL) {
    V3 rius = unit_sphere(st);
    float rough = p.mitsuba ? 0.0f : S.at(ROW_ROUGH, id);
    g_refl =
        normalize_adj(add(reflect(rd, normal), scale(rius, rough)), g_dir);
    if (!p.mitsuba) acc[ROW_ROUGH * n + id] += dot(rius, g_refl);
  } else if (rec.refl) {
    g_refl = normalize_adj(reflect(rd, normal), g_dir);
  } else {
    refract_adj(S, id, rd, normal, g_dir, g_rd, g_n, acc);
  }
  // refl = rd - normal * (2 (rd . normal))
  float dn = dot(rd, normal);
  float ng = dot(normal, g_refl);
  g_rd = add(g_rd, sub(g_refl, scale(normal, 2.0f * ng)));
  g_n = sub(g_n, add(scale(g_refl, 2.0f * dn), scale(rd, 2.0f * ng)));
  // normal = (pos - center) * inv_radius
  V3 g_pc = scale(g_n, invr);
  g_pos = add(g_pos, g_pc);
  acc3(acc, n, ROW_CX, id, neg(g_pc));
  acc[ROW_INVR * n + id] += dot(pc, g_n);
  // pos = ro + rd * t
  g_ro = add(g_ro, g_pos);
  g_rd = add(g_rd, scale(g_pos, rec.t));
  sphere_t_adj(S, id, ro, rd, p.t_min, dot(g_pos, rd), g_ro, g_rd, acc);
  if constexpr (kSoft)
    silhouette_adj(S, p, id, discr(S, id, ro, rd), ro, rd,
                   hit_weight_grad(S, p, rec, rd, e, g_e, g_c), g_ro, g_rd,
                   acc);
}

// What the gradient kernels' stats instances count (csrc/grad.cu): SM
// clock cycles, summed over threads, in each part of the kernel -- the
// forward trace, the replays (the replaying form), the adjoint sweep,
// within it the warp form's grouping of lanes by sphere (and, in its soft
// instance, the silhouette and shadow-boundary scans), zeroing the
// cotangent tables, the block reduction, and the whole thread; then the
// adjoint bounces run, the replayed bounces, the lane slots of the warp
// form's reverse steps (32 a step of a warp), the hit groups its adds
// formed and the lanes in them, and last the cycles of the warp form's
// soft scans.  The timed instances pass NoGradCount,
// which compiles to nothing.
enum {
  kGcCycFwd = 0, kGcCycReplay, kGcCycAdj, kGcCycGroup, kGcCycZero,
  kGcCycReduce, kGcCycAll, kGcAdjBounces, kGcReplayBounces, kGcAdjSlots,
  kGcHitGroups, kGcHitLanes, kGcCycSoft, kGcSlots
};

struct NoGradCount {
  static constexpr bool kOn = false;
  TPT_HD void add(int, unsigned long long) {}
};

// The SM clock on the card, 0 on the host.
TPT_HD long long sm_clock() {
#ifdef __CUDA_ARCH__
  return clock64();
#else
  return 0;
#endif
}

// One pixel of the gradient kernel: render_pixel's primal, bit for bit,
// into out[0..2] (returning its rays), and the pixel's scene cotangent for
// the pixel cotangent g[0..2] added to acc.  Each sample is traced once
// forward; then its bounces are differentiated last to first, bounce d
// replayed from the sample's camera ray and RNG state (bounces before d
// without NEE's shadow tests: the replay needs their path and attenuation,
// not their radiance).  A path of L bounces costs O(L^2) bounces; most end
// by depth 3-4.  The replaying form, kept as the baseline of
// grad_pixel_stored and of the warp form (csrc/gradwarp.cuh).  kSoft: the
// soft-silhouette estimator's cotangent (bounce_adj<true>).
template <bool kSoft = false, class Cnt>
TPT_HD uint32_t grad_pixel(const SceneView& S, const float* cam,
                           const RenderParams& p, int x, int y,
                           const float* g, float* out, float* acc, Cnt& cnt) {
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  uint32_t st = seed_pixel((uint32_t)x, (uint32_t)y, p.frame);
  uint32_t rays = 0;
  uint32_t replay_rays = 0;
  // img = (sum of sample radiances) * inv_spp
  const V3 G = v3(g[0] * p.inv_spp, g[1] * p.inv_spp, g[2] * p.inv_spp);
  V3 sum = zero;
  long long c0 = 0;
  for (int s = 0; s < p.spp; ++s) {
    if constexpr (Cnt::kOn) c0 = sm_clock();
    V3 ro0, rd0;
    sample_ray(cam, p, x, y, st, ro0, rd0);
    const uint32_t st0 = st;
    int depth;
    bool cut;
    sum = add(sum, trace_sample(S, p, ro0, rd0, st, rays, depth, cut));
    if constexpr (Cnt::kOn) {
      const long long c1 = sm_clock();
      cnt.add(kGcCycFwd, c1 - c0);
      c0 = c1;
    }
    V3 g_atten = zero;
    V3 g_ro = zero;
    V3 g_rd = zero;
    for (int d = depth - 1; d >= 0; --d) {
      V3 ro = ro0, rd = rd0, atten = v3(1.0f, 1.0f, 1.0f), e, c;
      uint32_t rs = st0;
      bool do_me = true;
      BounceRec rec;
      for (int k = 0; k < d; ++k) {
        bounce(S, p, false, ro, rd, rs, do_me, replay_rays, e, c, rec);
        atten = mul(atten, c);
      }
      const V3 ro_in = ro, rd_in = rd;
      const uint32_t st_in = rs;
      bounce(S, p, true, ro, rd, rs, do_me, replay_rays, e, c, rec);
      if constexpr (Cnt::kOn) {
        const long long c1 = sm_clock();
        cnt.add(kGcCycReplay, c1 - c0);
        cnt.add(kGcReplayBounces, d + 1);
        c0 = c1;
      }
      // col += atten * e; atten *= c -- reversed
      V3 g_e = mul(atten, G);
      V3 g_c = mul(g_atten, atten);
      g_atten = add(mul(G, e), mul(g_atten, c));
      bounce_adj<kSoft>(S, p, ro_in, rd_in, st_in, rec, e, g_e, g_c, g_ro,
                        g_rd, acc);
      if constexpr (Cnt::kOn) {
        const long long c1 = sm_clock();
        cnt.add(kGcCycAdj, c1 - c0);
        cnt.add(kGcAdjBounces, 1);
        c0 = c1;
      }
    }
    // the camera ray depends on no scene parameter: g_ro, g_rd end here
  }
  out[0] = sum.x * p.inv_spp;
  out[1] = sum.y * p.inv_spp;
  out[2] = sum.z * p.inv_spp;
  return rays;
}

template <bool kSoft = false>
TPT_HD uint32_t grad_pixel(const SceneView& S, const float* cam,
                           const RenderParams& p, int x, int y,
                           const float* g, float* out, float* acc) {
  NoGradCount none;
  return grad_pixel<kSoft>(S, cam, p, x, y, g, out, acc, none);
}

// ---- Stored carries: the adjoint sweep without replays ----
//
// What the adjoint of bounce d reads, kept by the forward trace instead of
// replayed: the bounce's ray, the RNG state it started from, its record,
// its emission e and the attenuation the sample carried into it.  Its
// continuation attenuation c is not kept: carry_c rebuilds it from the
// record and the scene.  A replay with vis=false draws and counts as the
// forward trace does, so every field equals what the replay computed,
// and the sweep below is bit-equal to grad_pixel.
struct Carry {
  V3 ro, rd;
  float t;
  uint32_t st;
  uint32_t bits;  // id + 1 (bits 0-9), scattered, gated, refl (10-12),
                  // see (16-31)
  V3 e, atten;
};

template <class See>
TPT_HD uint32_t pack_rec(const BounceRecOf<See>& r) {
  return (uint32_t)(r.id + 1) | (r.scattered ? 1u << 10 : 0u) |
         (r.gated ? 1u << 11 : 0u) | (r.refl ? 1u << 12 : 0u) |
         see_pack(r.see);
}

TPT_HD BounceRec unpack_rec(uint32_t bits, float t) {
  BounceRec r;
  r.id = (int)(bits & 1023u) - 1;
  r.t = t;
  r.scattered = (bits >> 10) & 1u;
  r.gated = (bits >> 11) & 1u;
  r.refl = (bits >> 12) & 1u;
  r.see = bits >> 16;
  return r;
}

// A tape of Carry records in an array: a sample's, for grad_pixel_stored
// (the g++ tests).  A tape names its bounce record (Rec) and binds a
// record to its slot before the bounce runs (bind: where LightBits keep
// the seen lights; nothing for a uint32_t).
struct ArrayTape {
  using Rec = BounceRec;
  Carry* c;
  TPT_HD void bind(Rec&, int) const {}
  TPT_HD void put(int d, const Carry& x, const BounceRec&) const { c[d] = x; }
  TPT_HD Carry get(int d) const { return c[d]; }
};

// trace_sample, recording bounce d's Carry (and its record, which a tape
// may keep beside the packed bits) in slot slot0 + d of `tape`.
template <class View, class Tape>
TPT_HD V3 trace_sample_tape(const View& S, const RenderParams& p, V3 ro,
                            V3 rd, uint32_t& st, uint32_t& rays, int& depth,
                            const Tape& tape, int slot0) {
  V3 col = v3(0.0f, 0.0f, 0.0f);
  V3 atten = v3(1.0f, 1.0f, 1.0f);
  bool do_me = true;
  V3 e, c;
  typename Tape::Rec rec;
  depth = 0;
  while (depth < p.max_depth) {
    Carry k;
    k.ro = ro;
    k.rd = rd;
    k.st = st;
    k.atten = atten;
    tape.bind(rec, slot0 + depth);
    bool go = bounce(S, p, true, ro, rd, st, do_me, rays, e, c, rec);
    k.t = rec.t;
    k.bits = pack_rec(rec);
    k.e = e;
    tape.put(slot0 + depth, k, rec);
    col = add(col, mul(atten, e));
    ++depth;
    if (!go) break;
    atten = mul(atten, c);
  }
  return col;
}

// grad_pixel with stored carries: the same image, rays and cotangent adds
// in the same order, each bounce traced once.  `tape` holds max_depth
// records.
template <class Tape>
TPT_HD uint32_t grad_pixel_stored(const SceneView& S, const float* cam,
                                  const RenderParams& p, int x, int y,
                                  const float* g, float* out, float* acc,
                                  Tape& tape) {
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  uint32_t st = seed_pixel((uint32_t)x, (uint32_t)y, p.frame);
  uint32_t rays = 0;
  const V3 G = v3(g[0] * p.inv_spp, g[1] * p.inv_spp, g[2] * p.inv_spp);
  V3 sum = zero;
  for (int s = 0; s < p.spp; ++s) {
    V3 ro0, rd0;
    sample_ray(cam, p, x, y, st, ro0, rd0);
    int depth;
    sum = add(sum,
              trace_sample_tape(S, p, ro0, rd0, st, rays, depth, tape, 0));
    V3 g_atten = zero;
    V3 g_ro = zero;
    V3 g_rd = zero;
    for (int d = depth - 1; d >= 0; --d) {
      const Carry k = tape.get(d);
      const BounceRec rec = unpack_rec(k.bits, k.t);
      V3 g_e = mul(k.atten, G);
      V3 g_c = mul(g_atten, k.atten);
      g_atten = add(mul(G, k.e), mul(g_atten, carry_c(S, rec)));
      bounce_adj(S, p, k.ro, k.rd, k.st, rec, k.e, g_e, g_c, g_ro, g_rd,
                 acc);
    }
  }
  out[0] = sum.x * p.inv_spp;
  out[1] = sum.y * p.inv_spp;
  out[2] = sum.z * p.inv_spp;
  return rays;
}

}  // namespace tpt
