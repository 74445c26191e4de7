// Per-pixel path-tracing core of the render kernel (csrc/render.cu).
//
// Replaces the TPU kernel toypathtracer_tpu/ops/pallas_render.py::
// _render_kernel, whose body is tracecore.render_pixels_fused_merged.  The
// TPU kernel runs a persistent wavefront over (tile_h, tile_w) lane tiles
// with bit-packed lane state, because a TPU core is one wide vector unit.
// A GPU runs one thread per pixel, so this is the reference's own compute
// shader design (Cpp/Windows/ComputeShader.hlsl): each thread walks its spp
// samples in order, and each sample runs up to max_depth bounces of
// hit -> classify -> scatter + NEE -> accumulate.
//
// What bounds it: FP32 ALU work, ~20 operations per sphere per traced ray
// and ~15 per sphere per shadow ray, against almost no memory traffic (the
// scene sits in shared memory, the image is written once).  This first
// kernel is the simple correct one; warp divergence between short and long
// paths is what a later, faster version has to attack.
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

// Largest scene the kernel stages in shared memory (60 bytes per sphere).
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
TPT_HD bool sphere_t(const SceneView& S, int i, V3 ro, V3 rd, float t_min,
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

// Lambert NEE (Test.cpp:94-133): per light in emissive-id order, unless the
// hit sphere is that light, a cone sample (2 draws), one shadow ray, and the
// contribution if the light is visible.  Adds the shadow rays to `rays`.
TPT_HD V3 nee(const SceneView& S, const RenderParams& p, V3 pos, V3 normal,
              V3 rd, V3 alb, int hit_id, uint32_t& st, uint32_t& rays) {
  V3 light_e = v3(0.0f, 0.0f, 0.0f);
  V3 nl = dot(normal, rd) < 0.0f ? normal : neg(normal);
  for (int k = 0; k < S.n_lights; ++k) {
    int e = S.lights[k];
    if (e == hit_id) continue;  // self-skip (ComputeShader.hlsl:204)
    V3 sc = v3(S.at(ROW_CX, e), S.at(ROW_CY, e), S.at(ROW_CZ, e));
    float r = S.at(ROW_R, e);
    V3 sw = normalize(sub(sc, pos));
    V3 up = fabsf(sw.x) > 0.01f ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
    V3 su = normalize(cross(up, sw));
    V3 sv = cross(sw, su);
    V3 dp = sub(pos, sc);
    float d2 = dot(dp, dp);
    float cos_a_max = sqrt_pos(1.0f - r * r / d2);
    float eps1 = rand01(st);
    float eps2 = rand01(st);
    float cos_a = 1.0f - eps1 + eps1 * cos_a_max;
    float sin_a = sqrt_pos(1.0f - cos_a * cos_a);
    float phi = TPT_TWO_PI * eps2;
    V3 l = add(add(scale(su, cosf(phi) * sin_a), scale(sv, sinf(phi) * sin_a)),
               scale(sw, cos_a));
    ++rays;
    float t_l;
    bool see = sphere_t(S, e, pos, l, p.t_min, t_l) && t_l < p.t_max &&
               !occluded(S, pos, l, e, p.t_min, t_l);
    float omega = TPT_TWO_PI * (1.0f - cos_a_max);
    float fac = max0(dot(l, nl)) * omega / TPT_PI;
    if (see) {
      V3 em = v3(S.at(ROW_EM, e), S.at(ROW_EM + 1, e), S.at(ROW_EM + 2, e));
      light_e = v3(light_e.x + (alb.x * em.x) * fac,
                   light_e.y + (alb.y * em.y) * fac,
                   light_e.z + (alb.z * em.z) * fac);
    }
  }
  return light_e;
}

// Schlick-weighted reflect/refract, 1 draw (Test.cpp:151-186).
TPT_HD V3 scatter_dielectric(uint32_t& st, V3 rd, V3 normal, V3 refl,
                             float ri) {
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
  return normalize(rr < refl_prob ? refl : refr);
}

// One pixel: spp samples, each traced up to max_depth bounces; writes the
// sample mean to out[0..2] and returns the pixel's rays (camera, bounce and
// shadow rays).  A sample that scatters at depth max_depth keeps that
// bounce's emission and NEE and adds no sky (ComputeShader.hlsl:300).
TPT_HD uint32_t render_pixel(const SceneView& S, const float* cam,
                             const RenderParams& p, int x, int y,
                             float* out) {
  uint32_t st = seed_pixel((uint32_t)x, (uint32_t)y, p.frame);
  uint32_t rays = 0;
  float fx = (float)x;
  float fy = (float)y;
  V3 sum = v3(0.0f, 0.0f, 0.0f);
  for (int s = 0; s < p.spp; ++s) {
    float ur = rand01(st);
    float u = (fx + ur) * p.inv_w;
    float vr = rand01(st);
    float v = (fy + vr) * p.inv_h;
    V3 ro, rd;
    camera_ray(cam, u, v, st, ro, rd);
    V3 col = v3(0.0f, 0.0f, 0.0f);
    V3 atten = v3(1.0f, 1.0f, 1.0f);
    bool do_me = true;  // emission not yet counted by NEE (hlsl:314-325)
    for (int depth = 0; depth < p.max_depth; ++depth) {
      ++rays;
      float t;
      int id = nearest_hit(S, ro, rd, p.t_min, p.t_max, t);
      if (id < 0) {
        col = add(col, mul(atten, sky_color(rd, p.mitsuba != 0)));
        break;
      }
      V3 pos = add(ro, scale(rd, t));
      V3 cen = v3(S.at(ROW_CX, id), S.at(ROW_CY, id), S.at(ROW_CZ, id));
      V3 normal = scale(sub(pos, cen), S.at(ROW_INVR, id));
      V3 alb = v3(S.at(ROW_ALB, id), S.at(ROW_ALB + 1, id),
                  S.at(ROW_ALB + 2, id));
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
          light_e = nee(S, p, pos, normal, rd, alb, id, st, rays);
      } else if (mt == MAT_METAL) {
        float rough = p.mitsuba ? 0.0f : S.at(ROW_ROUGH, id);
        V3 rius = unit_sphere(st);
        dir = normalize(add(refl, scale(rius, rough)));
        if (!(dot(dir, normal) > 0.0f)) {  // absorbed: ungated emission
          col = add(col, mul(atten, em));
          break;
        }
      } else {
        dir = scatter_dielectric(st, rd, normal, refl, S.at(ROW_RI, id));
        attenuation = v3(1.0f, 1.0f, 1.0f);
      }
      V3 gated = em;
      if (p.light_sampling) {
        if (!do_me) gated = v3(0.0f, 0.0f, 0.0f);
        do_me = mt != MAT_LAMBERT;
      }
      col = add(col, mul(atten, add(gated, light_e)));
      atten = mul(atten, attenuation);
      ro = pos;
      rd = dir;
    }
    sum = add(sum, col);
  }
  out[0] = sum.x * p.inv_spp;
  out[1] = sum.y * p.inv_spp;
  out[2] = sum.z * p.inv_spp;
  return rays;
}

}  // namespace tpt
