// K5's arithmetic: the path replay of one PathRecord row, forward and
// adjoint, as __host__ __device__ functions.
//
// csrc/replay_path.cu includes this header for the card; the CPU tests
// compile it with g++ through csrc/replay_path_host.cpp, so that a run
// without a card reaches the same arithmetic.  Each function computes what
// its torch counterpart in the port computes for one row, with the same
// float operations in the same order (no fused multiply-adds: nvcc builds
// with --fmad=false and g++ with -ffp-contract=off), so the rows agree with
// the plain replay bit for bit except where a transcendental function
// (sin, cos, atan2, acos, pow) rounds differently:
//
//   rng, rand01            core/rng.py tea32 / pcg_hash, wavefront._rand
//   camera_ray             persistent.ray_positions + render/sensor.sample_ray
//   make_si                intersect/bvh_torch._make_si(return_row=True)
//   eval_texture           render/texture.eval_texture
//   ggx_*, smith_*         render/microfacet.py
//   fresnel_*              render/fresnel.py (F_dr comes from the wrapper,
//                          per material, computed by fresnel_diffuse_reflectance)
//   eval_kind, bsdf_eval,  render/bsdf/dispatch.py _eval_pdf_kinds, eval_pdf,
//   bsdf_sample            sample (all ten BSDFKind values; a MASK nests one
//                          level, as _gather_rows resolves it)
//   emitter / env code     render/emitter.py
//   shade_vertex           integrators/persistent._shade + the replay's commit
//
// The adjoint of a row.  L = sum_k f_k * a_k, where f_k is the throughput
// before vertex k (f_0 = 1, f_{k+1} = f_k * w_k * r_k), a_k the radiance the
// vertex adds per unit throughput (emission * MIS, the environment, the
// unoccluded NEE sample), w_k the BSDF sample weight and r_k the detached
// roulette scale.  With the suffix S_k = a_k + w_k r_k S_{k+1}, the adjoint
// of a_k is g * f_k and that of w_k is g * f_k * r_k * S_{k+1} (g = dL).  No
// step divides by a weight, so a zero albedo channel gets its derivative.
// Each value and weight of a BSDF is affine in its albedo channel by
// channel, so its derivative with respect to the albedo is a per-channel
// coefficient computed beside it; a MASK's opacity (read from its own
// base_color row) enters through op and its luminance, and gets the full
// 3x3 Jacobian.  The MIS weights, the roulette probability and every pdf
// carry no gradient (they are detached in the torch code too).
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define RP_FN __host__ __device__ __forceinline__
#else
#define RP_FN static inline
#endif

namespace rp {

// ---------------------------------------------------------------------------
// The scene and the record, as the wrapper passes them (a plain C layout that
// the Python side mirrors with ctypes.Structure; replay_cuda.py)
// ---------------------------------------------------------------------------

// offsets into ReplayArgs::consts
enum {
  kToWorld = 0,      // camera.to_world (4, 4) row-major
  kTanHalf = 16,     // camera.tan_half_fov (2,)
  kEnvRadiance = 18, // emitters.env_radiance (3,)
  kEnvSelectP = 21,  // emitters.env_select_p
  kFaceTotal = 22,   // emitters.face_dist.total
  kEnvTotal = 23,    // emitters.env_dist.total
  kConsts = 24,
};

struct ReplayArgs {
  // the record, (n_rows, depth) row-major
  const int32_t* prim;
  const float* rec_u;
  const float* rec_v;
  const uint8_t* occl;
  const int64_t* idx;        // (n_rows,) camera-ray index of each row, or null: idx0 + row
  int64_t n_rows;
  int64_t idx0;
  int64_t ray_end;           // rows whose ray index is >= ray_end are inactive; < 0: none
  int32_t depth;             // the record's depth D
  int32_t n_steps;           // depth steps to replay, <= D
  uint32_t seed;
  int32_t spp;
  int32_t max_depth;
  int32_t rr_depth;
  int32_t width;
  int32_t height;
  const float* consts;       // kConsts floats
  // geometry
  const float* face_packed;  // (faces, 32)
  // materials
  const int32_t* mat_kind;
  const float* base_color;   // (n_mats, 3)
  const float* mat_params;   // (n_mats, 8)
  const int32_t* mat_tex;
  const int32_t* mat_flags;
  const uint8_t* mat_twosided;
  const int32_t* mat_nested;
  const float* mat_fdr;      // (n_mats,) F_dr(1 / max(params[0], 1e-3))
  int32_t n_mats;
  // textures: data (n_tex, tex_h, tex_w, 3), size (n_tex, 2) = (h, w)
  const float* tex_data;
  const int32_t* tex_size;
  int32_t tex_h;
  int32_t tex_w;
  // emitters
  const float* radiance;     // (n_emitters, 3)
  int32_t n_emitters;
  int32_t n_em_faces;
  const float* em_packed;    // (n_em_faces, 16)
  const float* face_cdf;     // (n_em_faces,)
  const float* env_map;      // (env_h, env_w, 3)
  const float* env_weights;  // (env_h, env_w)
  const float* env_row_cdf;  // (env_h,)
  const float* env_col_cdf;  // (env_h, env_w)
  int32_t env_h;
  int32_t env_w;
  int32_t has_env_map;       // env_map is not 1x1: textured environment with NEE
  int32_t shared_tables;     // the adjoint kernel sums the tables in shared memory
  // outputs and scratch
  float* L;                  // (n_rows, 3)
  const float* dL;           // (n_rows, 3)
  float* d_base_color;       // (n_mats, 3)
  float* d_radiance;         // (n_emitters, 3)
  float* scratch;            // (depth, 6, n_rows): the adjoint's per-vertex a_k and w_k r_k
};

// ---------------------------------------------------------------------------
// Scalars and vectors (torch's semantics: clamp propagates NaN)
// ---------------------------------------------------------------------------

constexpr float kPi = 3.14159265358979323846f;
constexpr float kInvPi = (float)(1.0 / 3.14159265358979323846);
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
constexpr float kQuarterPi = (float)(0.25 * 3.14159265358979323846);
constexpr float kHalfPi = (float)(0.5 * 3.14159265358979323846);
constexpr float kHalfInvPi = (float)(0.5 / 3.14159265358979323846);
constexpr float kTwoPiSq = (float)(2.0 * 3.14159265358979323846 * 3.14159265358979323846);
constexpr float kInf = INFINITY;
constexpr float kOneMinus1e7 = (float)(1.0 - 1e-7);
constexpr float kOneMinus1e6 = (float)(1.0 - 1e-6);
constexpr float kOneMinus1e4 = (float)(1.0 - 1e-4);
constexpr float kLumR = 0.212671f, kLumG = 0.715160f, kLumB = 0.072169f;

enum Kind {
  DIFFUSE = 0, CONDUCTOR = 1, ROUGH_CONDUCTOR = 2, DIELECTRIC = 3, ROUGH_DIELECTRIC = 4,
  PLASTIC = 5, ROUGH_PLASTIC = 6, MASK = 7, KNULL = 8, PRINCIPLED = 9,
};
enum Flags {
  DiffuseReflection = 1, GlossyReflection = 4, GlossyTransmission = 8, DeltaReflection = 16,
  DeltaTransmission = 32, NullFlag = 64, Smooth = 15, Delta = 48,
};

RP_FN float cmin(float x, float lo) { return x < lo ? lo : x; }   // clamp(x, min=lo)
RP_FN float cmax(float x, float hi) { return x > hi ? hi : x; }   // clamp(x, max=hi)
RP_FN float clampf(float x, float lo, float hi) { return cmax(cmin(x, lo), hi); }
// d/dx of jnp.clip(x, lo, hi) (= minimum(maximum(x, lo), hi)): 1 inside,
// half on a bound, 0 outside
RP_FN float clip_grad(float x, float lo, float hi) {
  return (x > lo && x < hi) ? 1.0f : ((x == lo || x == hi) ? 0.5f : 0.0f);
}
RP_FN float safe_div(float a, float b, float fill = 0.0f) { return b != 0.0f ? a / b : fill; }
RP_FN float safe_rcp(float x) { return safe_div(1.0f, x); }
RP_FN float safe_sqrt(float x) { return sqrtf(cmin(x, 0.0f)); }
RP_FN float rsqrt_safe(float x) { return x > 0.0f ? 1.0f / sqrtf(x) : 0.0f; }
RP_FN float sign_not_zero(float x) { return x >= 0.0f ? 1.0f : -1.0f; }
RP_FN float sgn(float x) { return (float)((0.0f < x) - (x < 0.0f)); }   // torch.sign
RP_FN bool finite(float x) { return x - x == 0.0f; }
// amax over three: NaN-propagating
RP_FN float max3(float a, float b, float c) {
  float m = (a != a || a > b) ? a : b;
  return (m != m || m > c) ? m : c;
}
// float -> int32 toward zero, saturating, NaN -> 0 (one result on host and card)
RP_FN int32_t f2i(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.0f) return 2147483647;
  if (x <= -2147483648.0f) return (int32_t)(-2147483647 - 1);
  return (int32_t)x;
}
RP_FN int32_t floormod(int32_t a, int32_t b) {   // torch.remainder on ints
  int32_t r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
// x / s for a tensor x and a Python number s, as PyTorch rounds it: on the
// card it multiplies by the reciprocal, on the CPU it divides
RP_FN float div_scalar(float x, float s) {
#if defined(__CUDA_ARCH__)
  return x * (1.0f / s);
#else
  return x / s;
#endif
}
RP_FN int32_t bits_of(float f) {
#if defined(__CUDA_ARCH__)
  return __float_as_int(f);
#else
  int32_t i;
  memcpy(&i, &f, 4);
  return i;
#endif
}

struct V3 {
  float x, y, z;
};
RP_FN V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
RP_FN V3 vload(const float* p) { return v3(p[0], p[1], p[2]); }
RP_FN V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
RP_FN V3 operator-(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
RP_FN V3 operator-(V3 a) { return v3(-a.x, -a.y, -a.z); }
RP_FN V3 operator*(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
RP_FN V3 operator*(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
RP_FN float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
RP_FN V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
RP_FN V3 normalize(V3 a) { return a * rsqrt_safe(dot(a, a)); }
RP_FN V3 with_z(V3 a, float z) { return v3(a.x, a.y, z); }
RP_FN float comp(V3 a, int c) { return c == 0 ? a.x : (c == 1 ? a.y : a.z); }
RP_FN float luminance(V3 c) { return c.x * kLumR + c.y * kLumG + c.z * kLumB; }

// ---------------------------------------------------------------------------
// Counter-based draws (core/rng.py, wavefront._rand)
// ---------------------------------------------------------------------------

RP_FN uint32_t pcg_hash(uint32_t x) {
  uint32_t state = x * 747796405u + 2891336453u;
  uint32_t word = ((state >> ((state >> 28u) + 4u)) ^ state) * 277803737u;
  return (word >> 22u) ^ word;
}

RP_FN float rand01(uint32_t seed, uint32_t key, uint32_t dim) {
  uint32_t v0 = seed, v1 = dim, s = 0;
  for (int i = 0; i < 4; ++i) {
    s += 0x9E3779B9u;
    v0 += ((v1 << 4) + 0xA341316Cu) ^ (v1 + s) ^ ((v1 >> 5) + 0xC8013EA4u);
    v1 += ((v0 << 4) + 0xAD90777Du) ^ (v0 + s) ^ ((v0 >> 5) + 0x7E95761Eu);
  }
  uint32_t bits = pcg_hash(pcg_hash(key ^ v0) + v1);
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// ---------------------------------------------------------------------------
// Warps, microfacets, Fresnel
// ---------------------------------------------------------------------------

RP_FN V3 square_to_cosine_hemisphere(float u0, float u1) {
  float x = 2.0f * u0 - 1.0f;
  float y = 2.0f * u1 - 1.0f;
  bool is_zero = (x == 0.0f) && (y == 0.0f);
  bool quad_x = fabsf(x) > fabsf(y);
  float r = quad_x ? x : y;
  float rr = quad_x ? y : x;
  float ph = kQuarterPi * safe_div(rr, r);
  ph = quad_x ? ph : kHalfPi - ph;
  ph = is_zero ? 0.0f : ph;
  float dx = r * cosf(ph), dy = r * sinf(ph);
  float z = safe_sqrt(1.0f - dx * dx - dy * dy);
  return v3(dx, dy, z);
}
RP_FN float cosine_hemisphere_pdf(V3 v) { return cmin(v.z, 0.0f) * kInvPi; }

RP_FN float ggx_d(V3 mh, float alpha) {
  float c2 = mh.z * mh.z;
  float t = c2 * (alpha * alpha - 1.0f) + 1.0f;
  float d = safe_div(alpha * alpha, kPi * t * t);
  return mh.z > 0.0f ? d : 0.0f;
}
RP_FN float ggx_lambda(V3 v, float alpha) {
  float cos2 = v.z * v.z;
  float sin2 = cmin(1.0f - cos2, 0.0f);
  float t2 = safe_div(sin2, cos2, kInf);
  t2 = finite(t2) ? t2 : 0.0f;
  return 0.5f * (-1.0f + sqrtf(1.0f + alpha * alpha * t2));
}
RP_FN float smith_g1(V3 v, V3 mh, float alpha) {
  float g = 1.0f / (1.0f + ggx_lambda(v, alpha));
  return dot(v, mh) * v.z > 0.0f ? g : 0.0f;
}
RP_FN float smith_g(V3 wi, V3 wo, V3 mh, float alpha) {
  return smith_g1(wi, mh, alpha) * smith_g1(wo, mh, alpha);
}
RP_FN float pdf_ggx(V3 mh, float alpha) { return ggx_d(mh, alpha) * cmin(mh.z, 0.0f); }
RP_FN V3 square_to_ggx(float u0, float u1, float alpha) {
  float c2 = (1.0f - u0) / (u0 * (alpha * alpha - 1.0f) + 1.0f);
  float cos_t = sqrtf(clampf(c2, 0.0f, 1.0f));
  float sin_t = safe_sqrt(1.0f - c2);
  float ph = kTwoPi * u1;
  return v3(sin_t * cosf(ph), sin_t * sinf(ph), cos_t);
}

struct Fresnel {
  float F, cos_t, eta_it, eta_ti;
};
RP_FN Fresnel fresnel_dielectric(float cos_i, float eta) {
  Fresnel r;
  bool outside = cos_i >= 0.0f;
  r.eta_it = outside ? eta : 1.0f / eta;
  r.eta_ti = 1.0f / r.eta_it;
  float cti = fabsf(cos_i);
  float sin2_t = (1.0f - cti * cti) * (r.eta_ti * r.eta_ti);
  bool tir = sin2_t >= 1.0f;
  float cos_t = safe_sqrt(1.0f - sin2_t);
  float a_s = safe_div(cti - r.eta_it * cos_t, cti + r.eta_it * cos_t);
  float a_p = safe_div(r.eta_it * cti - cos_t, r.eta_it * cti + cos_t);
  float F = 0.5f * (a_s * a_s + a_p * a_p);
  r.F = tir ? 1.0f : F;
  r.cos_t = tir ? 0.0f : -sgn(cos_i) * cos_t;
  return r;
}
RP_FN float fresnel_conductor1(float c, float eta, float k) {
  float c2 = c * c;
  float s2 = 1.0f - c2;
  float e2 = eta * eta;
  float k2 = k * k;
  float t0 = e2 - k2 - s2;
  float a2b2 = safe_sqrt(t0 * t0 + 4.0f * e2 * k2);
  float t1 = a2b2 + c2;
  float a = safe_sqrt(0.5f * (a2b2 + t0));
  float t2 = 2.0f * a * c;
  float rs = safe_div(t1 - t2, t1 + t2);
  float t3 = c2 * a2b2 + s2 * s2;
  float t4 = t2 * s2;
  float rp = rs * safe_div(t3 - t4, t3 + t4);
  return 0.5f * (rp + rs);
}
RP_FN V3 fresnel_conductor(float cos_i, const float* p) {
  float c = clampf(fabsf(cos_i), 0.0f, 1.0f);
  return v3(fresnel_conductor1(c, p[0], p[3]), fresnel_conductor1(c, p[1], p[4]),
            fresnel_conductor1(c, p[2], p[5]));
}
RP_FN V3 reflect(V3 wi) { return v3(-wi.x, -wi.y, wi.z); }
RP_FN V3 reflect_about(V3 wi, V3 m) { return m * (2.0f * dot(wi, m)) - wi; }

// ---------------------------------------------------------------------------
// Textures (bilinear, repeat wrap; v = 0 is the image's last row)
// ---------------------------------------------------------------------------

RP_FN V3 eval_texture(const ReplayArgs& a, int32_t tex_id, float uvx, float uvy) {
  if (tex_id < 0) return v3(1.0f, 1.0f, 1.0f);
  int32_t th = a.tex_size[2 * tex_id], tw = a.tex_size[2 * tex_id + 1];
  float h = (float)th, w = (float)tw;
  float u = uvx - floorf(uvx);
  float v = uvy - floorf(uvy);
  float x = u * w - 0.5f;
  float y = (1.0f - v) * h - 0.5f;
  float x0 = floorf(x), y0 = floorf(y);
  float fx = x - x0, fy = y - y0;
  int32_t xs[2] = {floormod(f2i(x0), tw), floormod(f2i(x0 + 1.0f), tw)};
  int32_t ys[2] = {floormod(f2i(y0), th), floormod(f2i(y0 + 1.0f), th)};
  const float* base = a.tex_data + (int64_t)tex_id * a.tex_h * a.tex_w * 3;
  V3 c00 = vload(base + ((int64_t)ys[0] * a.tex_w + xs[0]) * 3);
  V3 c10 = vload(base + ((int64_t)ys[0] * a.tex_w + xs[1]) * 3);
  V3 c01 = vload(base + ((int64_t)ys[1] * a.tex_w + xs[0]) * 3);
  V3 c11 = vload(base + ((int64_t)ys[1] * a.tex_w + xs[1]) * 3);
  V3 top = c00 * (1.0f - fx) + c10 * fx;
  V3 bot = c01 * (1.0f - fx) + c11 * fx;
  return top * (1.0f - fy) + bot * fy;
}

// ---------------------------------------------------------------------------
// The material row of a hit (_gather_rows, one MASK nesting level)
// ---------------------------------------------------------------------------

struct Mat {
  int32_t mid, eff, kind, flags;
  bool is_mask, twosided;
  V3 base, tex, albedo;      // albedo = base * tex (tex = 1 without a texture)
  const float* params;
  float fdr;
  V3 op_raw, op;             // the mask's opacity before and after clamp(0, 1)
  bool op_from_base;         // op_raw is the mask row's base_color (no opacity texture)
};

RP_FN Mat gather_mat(const ReplayArgs& a, int32_t mat_id, float uvx, float uvy) {
  Mat m;
  m.mid = mat_id < 0 ? 0 : mat_id;
  int32_t kind_mid = a.mat_kind[m.mid];
  m.is_mask = kind_mid == MASK;
  int32_t nested = a.mat_nested[m.mid];
  m.eff = m.is_mask ? (nested < 0 ? 0 : nested) : m.mid;
  m.kind = a.mat_kind[m.eff];
  m.flags = a.mat_flags[m.mid];
  m.twosided = a.mat_twosided[m.mid] || a.mat_twosided[m.eff];
  m.base = vload(a.base_color + 3 * m.eff);
  int32_t tex_id = a.mat_tex[m.eff];
  m.tex = eval_texture(a, tex_id, uvx, uvy);
  m.albedo = tex_id >= 0 ? m.base * m.tex : m.base;
  if (tex_id < 0) m.tex = v3(1.0f, 1.0f, 1.0f);
  m.params = a.mat_params + 8 * m.eff;
  m.fdr = a.mat_fdr[m.eff];
  m.op_from_base = false;
  m.op_raw = m.op = v3(1.0f, 1.0f, 1.0f);
  if (m.is_mask) {
    int32_t op_tex = a.mat_tex[m.mid];
    m.op_from_base = op_tex < 0;
    m.op_raw = m.op_from_base ? vload(a.base_color + 3 * m.mid) : eval_texture(a, op_tex, uvx, uvy);
    m.op = v3(clampf(m.op_raw.x, 0.0f, 1.0f), clampf(m.op_raw.y, 0.0f, 1.0f),
              clampf(m.op_raw.z, 0.0f, 1.0f));
  }
  return m;
}

RP_FN bool transmissive(int32_t kind) {
  return kind == DIELECTRIC || kind == ROUGH_DIELECTRIC || kind == KNULL;
}

// ---------------------------------------------------------------------------
// BSDF evaluation (_eval_pdf_kinds): f (N,3) * |cos|, pdf, and dA = df/dalbedo
// ---------------------------------------------------------------------------

struct Eval {
  V3 f, dA;
  float pdf;
};

RP_FN Eval rough_dielectric_eval(V3 alb, V3 wi, V3 wo, float eta, float alpha) {
  float cos_i = wi.z, cos_o = wo.z;
  bool is_reflect = cos_i * cos_o > 0.0f;
  float eta_it = cos_i >= 0.0f ? eta : 1.0f / eta;
  V3 h = is_reflect ? normalize(wi + wo) : normalize(wi + wo * eta_it);
  h = h * sign_not_zero(h.z);
  float D = ggx_d(h, alpha);
  float G = smith_g(wi, wo, h, alpha);
  float F = fresnel_dielectric(dot(wi, h), eta).F;
  float f_r = safe_div(D * G * F, 4.0f * fabsf(cos_i));
  float dwh_dwo_r = safe_div(1.0f, 4.0f * fabsf(dot(wo, h)));
  float ih = dot(wi, h), oh = dot(wo, h);
  float denom = ih + eta_it * oh;
  float jac = safe_div(eta_it * eta_it * fabsf(oh), denom * denom);
  float f_t = safe_div(fabsf(ih * oh) * (1.0f - F) * D * G, fabsf(cos_i) * denom * denom) *
              eta_it * eta_it;
  f_t = f_t / (eta_it * eta_it);
  float f_val = is_reflect ? f_r : f_t;
  float pdf = pdf_ggx(h, alpha) * (is_reflect ? F * dwh_dwo_r : (1.0f - F) * jac);
  bool valid = D > 0.0f;
  float s = valid ? f_val : 0.0f;
  Eval e;
  e.f = alb * s;
  e.dA = v3(s, s, s);
  e.pdf = valid ? pdf : 0.0f;
  return e;
}

// one kind's (f, pdf) at (wi, wo) in the (flipped) local frame
RP_FN Eval eval_kind(const Mat& m, int32_t kind, V3 wi, V3 wo) {
  Eval e;
  e.f = e.dA = v3(0.0f, 0.0f, 0.0f);
  e.pdf = 0.0f;
  float cos_i = wi.z, cos_o = wo.z;
  bool rs = (cos_i > 0.0f) && (cos_o > 0.0f);
  float alpha = cmin(m.params[6], 1e-3f);
  float eta = cmin(m.params[0], 1e-3f);
  V3 alb = m.albedo;
  if (kind == DIFFUSE) {
    float s = kInvPi * cmin(cos_o, 0.0f);
    if (rs) {
      e.f = alb * s;
      e.dA = v3(s, s, s);
      e.pdf = cosine_hemisphere_pdf(wo);
    }
    return e;
  }
  if (kind == ROUGH_DIELECTRIC) return rough_dielectric_eval(alb, wi, wo, eta, alpha);
  bool ggx = kind == ROUGH_CONDUCTOR || kind == ROUGH_PLASTIC || kind == PRINCIPLED;
  bool pl = kind == PLASTIC || kind == ROUGH_PLASTIC;
  if (!ggx && !pl) return e;   // delta lobes and null: no smooth part
  V3 h = v3(0.0f, 0.0f, 1.0f);
  float D = 0.0f, G = 0.0f, pdf_ggx_wo = 0.0f;
  if (ggx) {
    h = normalize(wi + wo);
    h = h * sign_not_zero(h.z);
    D = ggx_d(h, alpha);
    G = smith_g(wi, wo, h, alpha);
    pdf_ggx_wo = safe_div(pdf_ggx(h, alpha), 4.0f * fabsf(dot(wo, h)));
  }
  if (kind == ROUGH_CONDUCTOR) {
    V3 F_c = fresnel_conductor(dot(wi, h), m.params);
    float spec = safe_div(D * G, 4.0f * fabsf(cos_i));
    if (rs) {
      e.f = (alb * F_c) * spec;
      e.dA = F_c * spec;
      e.pdf = pdf_ggx_wo;
    }
    return e;
  }
  if (kind == PRINCIPLED) {
    float metallic = m.params[0], spec_amt = m.params[1];
    float k0 = 0.08f * spec_amt * (1.0f - metallic);
    V3 f0 = v3(k0, k0, k0) + alb * metallic;
    float x5 = powf(clampf(1.0f - fabsf(dot(wi, h)), 0.0f, 1.0f), 5.0f);
    V3 F_s = f0 + (v3(1.0f, 1.0f, 1.0f) - f0) * x5;
    float spec_pr = safe_div(D * G, 4.0f * fabsf(cos_i));
    float dcoef = (1.0f - metallic) * kInvPi * cmin(cos_o, 0.0f);
    float p_spec = clampf(0.25f + 0.5f * metallic, 0.25f, 0.9f);
    if (rs) {
      e.f = alb * dcoef + F_s * spec_pr;
      float d = dcoef + metallic * (1.0f - x5) * spec_pr;
      e.dA = v3(d, d, d);
      e.pdf = p_spec * pdf_ggx_wo + (1.0f - p_spec) * cosine_hemisphere_pdf(wo);
    }
    return e;
  }
  // plastic / rough plastic
  float F_i = fresnel_dielectric(cos_i, eta).F;
  float F_o = fresnel_dielectric(cos_o, eta).F;
  float inv_eta2 = 1.0f / (eta * eta);
  float dcoef = safe_div((1.0f - F_i) * (1.0f - F_o) * kInvPi * inv_eta2 * cmin(cos_o, 0.0f),
                         1.0f - m.fdr);
  V3 diff_pl = alb * dcoef;
  if (kind == PLASTIC) {
    if (rs) {
      e.f = diff_pl;
      e.dA = v3(dcoef, dcoef, dcoef);
      e.pdf = (1.0f - F_i) * cosine_hemisphere_pdf(wo);
    }
    return e;
  }
  float F_h = fresnel_dielectric(dot(wi, h), eta).F;
  float spec_rp = safe_div(D * G * F_h, 4.0f * fabsf(cos_i));
  float prob = clampf(F_i, 0.25f, 0.75f);
  if (rs) {
    e.f = v3(spec_rp, spec_rp, spec_rp) + diff_pl;
    e.dA = v3(dcoef, dcoef, dcoef);
    e.pdf = prob * pdf_ggx_wo + (1.0f - prob) * cosine_hemisphere_pdf(wo);
  }
  return e;
}

// eval_pdf: the flip, the kind, the mask's opacity, the validity gate.
// f_inner is the kind's value before the opacity (df/dop = f_inner on a
// mask); dA includes the opacity factor and the gate.
struct EvalOut {
  V3 f, f_inner, dA;
  float pdf;
};
RP_FN EvalOut bsdf_eval(const Mat& m, V3 wi, V3 wo, bool valid) {
  bool flip = m.twosided && (wi.z < 0.0f) && !transmissive(m.kind);
  float s = flip ? -1.0f : 1.0f;
  Eval e = eval_kind(m, m.kind, with_z(wi, wi.z * s), with_z(wo, wo.z * s));
  EvalOut o;
  o.f_inner = e.f;
  o.f = e.f;
  o.dA = e.dA;
  o.pdf = e.pdf;
  if (m.is_mask) {
    o.f = e.f * m.op;
    o.dA = e.dA * m.op;
    o.pdf = e.pdf * luminance(m.op);
  }
  if (!valid) {
    o.f = o.f_inner = o.dA = v3(0.0f, 0.0f, 0.0f);
    o.pdf = 0.0f;
  }
  return o;
}

// ---------------------------------------------------------------------------
// BSDF sampling (dispatch.sample); the weight's derivatives with respect to
// the albedo (per channel) and to the mask's opacity (3x3, [c][j] = dW_c/dop_j)
// ---------------------------------------------------------------------------

struct Sample {
  V3 wo;       // in the unflipped local frame
  float pdf, eta;
  int32_t stype;
  V3 w;        // weight, after the validity gate and clamp(min=0)
  V3 dA;       // dW_c / dalbedo_c
  V3 dop[3];   // dW_c / dop_j, row c
};

RP_FN Sample bsdf_sample(const Mat& m, V3 wi_in, float u1, float u2x, float u2y, bool active) {
  bool flip = m.twosided && (wi_in.z < 0.0f) && !transmissive(m.kind);
  float flip_sign = flip ? -1.0f : 1.0f;
  V3 wi = with_z(wi_in, wi_in.z * flip_sign);
  float cos_i = wi.z;
  int32_t kind = m.kind;
  float eta_rel = cmin(m.params[0], 1e-3f);
  float alpha = cmin(m.params[6], 1e-3f);
  V3 alb = m.albedo;
  V3 one = v3(1.0f, 1.0f, 1.0f), zero = v3(0.0f, 0.0f, 0.0f);

  // the mask's pass-through lobe
  float op_l = 1.0f, lum_op = 1.0f;
  bool mask_pass = false;
  if (m.is_mask) {
    lum_op = luminance(m.op);
    op_l = clampf(lum_op, 1e-4f, kOneMinus1e4);
    mask_pass = u1 >= op_l;
    u1 = clampf(safe_div(u1, op_l), 0.0f, kOneMinus1e6);
  }

  V3 wo_diff = square_to_cosine_hemisphere(u2x, u2y);
  float pdf_diff = cosine_hemisphere_pdf(wo_diff);
  V3 wo = wo_diff, w = alb, dA = one;
  float pdf = pdf_diff, eta_out = 1.0f;
  bool refl_d = false, refl_rd = false, spec_pl = false;

  bool ggx = kind == ROUGH_CONDUCTOR || kind == ROUGH_PLASTIC || kind == PRINCIPLED ||
             kind == ROUGH_DIELECTRIC;
  V3 h = v3(0.0f, 0.0f, 1.0f), wo_rc = h;
  float pdf_h = 0.0f;
  if (ggx) {
    h = square_to_ggx(u2x, u2y, alpha);
    pdf_h = ggx_d(h, alpha) * h.z;
    wo_rc = reflect_about(wi, h);
  }
  if (kind == CONDUCTOR) {
    wo = reflect(wi);
    V3 F_c = fresnel_conductor(cos_i, m.params);
    w = alb * F_c;
    dA = F_c;
    pdf = 1.0f;
  } else if (kind == ROUGH_CONDUCTOR) {
    wo = wo_rc;
    pdf = safe_div(pdf_h, 4.0f * fabsf(dot(wo_rc, h)));
    float G = smith_g(wi, wo_rc, h, alpha);
    V3 F = fresnel_conductor(dot(wi, h), m.params);
    float s = safe_div(G * dot(wi, h), cos_i * h.z);
    bool ok = wo_rc.z * cos_i > 0.0f;
    w = ok ? (alb * F) * s : zero;
    dA = ok ? F * s : zero;
  } else if (kind == DIELECTRIC) {
    Fresnel fr = fresnel_dielectric(cos_i, eta_rel);
    refl_d = u1 < fr.F;
    wo = refl_d ? reflect(wi) : v3(-fr.eta_ti * wi.x, -fr.eta_ti * wi.y, fr.cos_t);
    float s = refl_d ? 1.0f : fr.eta_ti * fr.eta_ti;
    w = alb * s;
    dA = v3(s, s, s);
    pdf = refl_d ? fr.F : 1.0f - fr.F;
    eta_out = refl_d ? 1.0f : fr.eta_it;
  } else if (kind == ROUGH_DIELECTRIC) {
    float ih = dot(wi, h);
    Fresnel fr = fresnel_dielectric(ih, eta_rel);
    refl_rd = u1 < fr.F;
    V3 wo_r = reflect_about(wi, h);
    float c_abs = fabsf(fr.cos_t);
    V3 wo_t = normalize((h * (fr.eta_ti * fabsf(ih) - c_abs)) * sign_not_zero(ih) -
                        wi * fr.eta_ti);
    wo = refl_rd ? wo_r : wo_t;
    Eval e = rough_dielectric_eval(alb, wi, wo, eta_rel, alpha);
    w = v3(safe_div(e.f.x, e.pdf), safe_div(e.f.y, e.pdf), safe_div(e.f.z, e.pdf));
    dA = e.pdf != 0.0f ? e.dA * (1.0f / e.pdf) : zero;
    pdf = e.pdf;
    eta_out = refl_rd ? 1.0f : fr.eta_it;
  } else if (kind == PLASTIC) {
    float F_i = fresnel_dielectric(cos_i, eta_rel).F;
    spec_pl = u1 < F_i;
    wo = spec_pl ? reflect(wi) : wo_diff;
    float inv_eta2 = 1.0f / (eta_rel * eta_rel);
    float F_o = fresnel_dielectric(wo.z, eta_rel).F;
    float s = safe_div((1.0f - F_o) * inv_eta2, 1.0f - m.fdr);
    w = spec_pl ? one : alb * s;
    dA = spec_pl ? zero : v3(s, s, s);
    pdf = spec_pl ? F_i : (1.0f - F_i) * pdf_diff;
  } else if (kind == ROUGH_PLASTIC || kind == PRINCIPLED) {
    bool spec;
    if (kind == ROUGH_PLASTIC) {
      float F_i = fresnel_dielectric(cos_i, eta_rel).F;
      spec = u1 < clampf(F_i, 0.25f, 0.75f);
    } else {
      spec = u1 < clampf(0.25f + 0.5f * m.params[0], 0.25f, 0.9f);
    }
    wo = spec ? wo_rc : wo_diff;
    Eval e = eval_kind(m, kind, wi, wo);
    w = v3(safe_div(e.f.x, e.pdf), safe_div(e.f.y, e.pdf), safe_div(e.f.z, e.pdf));
    dA = e.pdf != 0.0f ? e.dA * (1.0f / e.pdf) : zero;
    pdf = e.pdf;
  } else if (kind == KNULL) {
    wo = -wi;
    w = one;
    dA = zero;
    pdf = 1.0f;
  }
  bool delta = kind == CONDUCTOR || kind == DIELECTRIC || (kind == PLASTIC && spec_pl) ||
               kind == KNULL;
  int32_t stype = delta ? ((kind == DIELECTRIC && !refl_d) ? DeltaTransmission
                                                           : (kind == KNULL ? NullFlag : DeltaReflection))
                        : (kind == DIFFUSE ? DiffuseReflection
                                           : ((kind == ROUGH_DIELECTRIC && !refl_rd) ? GlossyTransmission
                                                                                     : GlossyReflection));
  Sample o;
  for (int c = 0; c < 3; ++c) o.dop[c] = zero;
  if (m.is_mask) {
    // d op_l / d op_j through the clip of the luminance
    V3 dl = v3(kLumR, kLumG, kLumB) * clip_grad(lum_op, 1e-4f, kOneMinus1e4);
    if (mask_pass) {
      float q = 1.0f - op_l;
      V3 wp = v3(safe_div(1.0f - m.op.x, q), safe_div(1.0f - m.op.y, q),
                 safe_div(1.0f - m.op.z, q));
      for (int c = 0; c < 3; ++c) {
        float oc = comp(m.op, c);
        V3 row = dl * ((1.0f - oc) / (q * q));
        if (c == 0) row.x -= 1.0f / q;
        if (c == 1) row.y -= 1.0f / q;
        if (c == 2) row.z -= 1.0f / q;
        o.dop[c] = row;
      }
      w = wp;
      dA = zero;
    } else {
      V3 r = v3(safe_div(m.op.x, op_l), safe_div(m.op.y, op_l), safe_div(m.op.z, op_l));
      for (int c = 0; c < 3; ++c) {
        float wc = comp(w, c), oc = comp(m.op, c);
        V3 row = dl * (-wc * oc / (op_l * op_l));
        if (c == 0) row.x += wc / op_l;
        if (c == 1) row.y += wc / op_l;
        if (c == 2) row.z += wc / op_l;
        o.dop[c] = row;
      }
      w = w * r;
      dA = dA * r;
    }
    wo = mask_pass ? -wi : wo;
    pdf = mask_pass ? 1.0f - op_l : pdf * op_l;
    stype = mask_pass ? NullFlag : stype;
    eta_out = mask_pass ? 1.0f : eta_out;
  }
  bool tr = transmissive(kind);
  bool front_ok = (cos_i > 0.0f) || tr || mask_pass;
  bool same_side = wo.z * cos_i > 0.0f;
  bool hemi_ok = tr ? (kind == ROUGH_DIELECTRIC ? (refl_rd ? same_side : wo.z * cos_i < 0.0f) : true)
                    : same_side;
  hemi_ok = hemi_ok || mask_pass;
  bool valid = active && front_ok && hemi_ok && (pdf > 0.0f);
  // where(valid, w, 0) then maximum(w, 0): the gradient passes where w > 0,
  // half of it where w == 0
  for (int c = 0; c < 3; ++c) {
    float wc = valid ? comp(w, c) : 0.0f;
    float pass = !valid ? 0.0f : (wc > 0.0f ? 1.0f : (wc == 0.0f ? 0.5f : 0.0f));
    o.dop[c] = o.dop[c] * pass;
    float dc = comp(dA, c) * pass;
    wc = cmin(wc, 0.0f);
    if (c == 0) { o.w.x = wc; o.dA.x = dc; }
    if (c == 1) { o.w.y = wc; o.dA.y = dc; }
    if (c == 2) { o.w.z = wc; o.dA.z = dc; }
  }
  o.wo = with_z(wo, wo.z * flip_sign);
  o.pdf = valid ? pdf : 0.0f;
  o.eta = eta_out;
  o.stype = valid ? stype : 0;
  return o;
}

// ---------------------------------------------------------------------------
// Emitters (render/emitter.py)
// ---------------------------------------------------------------------------

RP_FN int32_t upper_bound(const float* cdf, int32_t n, float x) {   // searchsorted(right=True)
  int32_t lo = 0, hi = n;
  while (lo < hi) {
    int32_t mid = (lo + hi) >> 1;
    if (cdf[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}
RP_FN int32_t clampi(int32_t x, int32_t lo, int32_t hi) { return x < lo ? lo : (x > hi ? hi : x); }

RP_FN V3 env_bilinear(const ReplayArgs& a, float u, float v) {
  int32_t he = a.env_h, we = a.env_w;
  float x = u * (float)we - 0.5f;
  float y = v * (float)he - 0.5f;
  float x0 = floorf(x), y0 = floorf(y);
  float fx = x - x0, fy = y - y0;
  int32_t xi0 = floormod(f2i(x0), we), xi1 = floormod(f2i(x0) + 1, we);
  int32_t yi0 = clampi(f2i(y0), 0, he - 1), yi1 = clampi(f2i(y0) + 1, 0, he - 1);
  V3 c00 = vload(a.env_map + ((int64_t)yi0 * we + xi0) * 3);
  V3 c01 = vload(a.env_map + ((int64_t)yi0 * we + xi1) * 3);
  V3 c10 = vload(a.env_map + ((int64_t)yi1 * we + xi0) * 3);
  V3 c11 = vload(a.env_map + ((int64_t)yi1 * we + xi1) * 3);
  V3 top = c00 * (1.0f - fx) + c01 * fx;
  V3 bot = c10 * (1.0f - fx) + c11 * fx;
  return top * (1.0f - fy) + bot * fy;
}

struct EnvUV {
  float u, v, theta;
};
RP_FN EnvUV dir_to_uv(V3 d) {
  EnvUV r;
  r.theta = acosf(clampf(d.y, -1.0f, 1.0f));
  float phi = atan2f(d.x, -d.z);
  r.u = phi * kHalfInvPi + 0.5f;
  r.v = r.theta * kInvPi;
  return r;
}

RP_FN V3 eval_environment(const ReplayArgs& a, V3 d) {
  V3 env = vload(a.consts + kEnvRadiance);
  if (!a.has_env_map) return env * vload(a.env_map);
  EnvUV t = dir_to_uv(d);
  return env_bilinear(a, t.u, t.v) * env;
}

RP_FN float pdf_environment_direction(const ReplayArgs& a, V3 d) {
  if (!a.has_env_map) return 0.0f;
  int32_t he = a.env_h, we = a.env_w;
  EnvUV t = dir_to_uv(d);
  int32_t x = clampi(f2i(t.u * (float)we), 0, we - 1);
  int32_t y = clampi(f2i(t.v * (float)he), 0, he - 1);
  float pmf = a.env_weights[(int64_t)y * we + x] / a.consts[kEnvTotal];
  return safe_div(pmf * (float)(he * we), kTwoPiSq * sinf(t.theta)) * a.consts[kEnvSelectP];
}

RP_FN float mis_weight(float pa, float pb) {
  float a2 = pa * pa;
  float w = safe_div(a2, a2 + pb * pb);
  return finite(w) ? w : 0.0f;
}

// ---------------------------------------------------------------------------
// The surface interaction of a recorded hit (_make_si with return_row)
// ---------------------------------------------------------------------------

struct SI {
  bool valid;
  V3 p, n, s, t, sh_n, wi;
  float uvx, uvy;
  int32_t mat_id, emitter_id;
  float em_pmf, em_area;
};

RP_FN SI make_si(const ReplayArgs& a, V3 d, int32_t face, float u, float v) {
  SI si;
  si.valid = face >= 0;
  if (!si.valid) {
    si.p = v3(0.0f, 0.0f, 0.0f);
    si.n = si.sh_n = si.wi = v3(0.0f, 0.0f, 1.0f);
    si.s = v3(1.0f, 0.0f, 0.0f);
    si.t = v3(0.0f, 1.0f, 0.0f);
    si.uvx = si.uvy = 0.0f;
    si.mat_id = si.emitter_id = -1;
    si.em_pmf = si.em_area = 0.0f;
    return si;
  }
  const float* row = a.face_packed + (int64_t)face * 32;
  V3 v0 = vload(row), e1 = vload(row + 3), e2 = vload(row + 6);
  si.p = (v0 + e1 * u) + e2 * v;
  V3 ng = normalize(cross(e1, e2));
  bool flat = row[24] > 0.5f;
  float w0 = 1.0f - u - v;
  V3 ns = normalize((vload(row + 9) * w0 + vload(row + 12) * u) + vload(row + 15) * v);
  ns = flat ? ng : ns;
  ns = dot(ns, ng) < 0.0f ? -ns : ns;
  si.uvx = (row[18] * w0 + row[20] * u) + row[22] * v;
  si.uvy = (row[19] * w0 + row[21] * u) + row[23] * v;
  // coordinate_system(ns)
  float sign = sign_not_zero(ns.z);
  float ca = -(1.0f / (sign + ns.z));
  float b = ns.x * ns.y * ca;
  si.s = v3(1.0f + sign * ns.x * ns.x * ca, sign * b, -sign * ns.x);
  si.t = v3(b, sign + ns.y * ns.y * ca, -ns.y);
  si.n = ng;
  si.sh_n = ns;
  V3 md = -d;
  si.wi = v3(dot(md, si.s), dot(md, si.t), dot(md, ns));
  si.mat_id = bits_of(row[25]);
  si.emitter_id = bits_of(row[26]);
  si.em_pmf = row[27];
  si.em_area = row[28];
  return si;
}
RP_FN V3 to_local(const SI& si, V3 v) { return v3(dot(v, si.s), dot(v, si.t), dot(v, si.sh_n)); }
RP_FN V3 to_world(const SI& si, V3 v) { return (si.s * v.x + si.t * v.y) + si.sh_n * v.z; }

// NEE: sample_emitter_direction(test_visibility=False)
struct EmSample {
  V3 d, weight;
  float pdf, rcp_pdf;
  int32_t em_id;   // the area emitter whose radiance `weight` reads, or -1
};

RP_FN EmSample sample_emitter_direction(const ReplayArgs& a, const SI& si, float ux, float uy,
                                        bool active) {
  float u0 = ux;
  bool sel_env = false;
  float p_env = a.consts[kEnvSelectP];
  if (a.has_env_map) {
    sel_env = ux < p_env;
    u0 = sel_env ? safe_div(ux, p_env) : safe_div(ux - p_env, 1.0f - p_env);
    u0 = clampf(u0, 0.0f, kOneMinus1e7);
  }
  float total = a.consts[kFaceTotal];
  int32_t slot = clampi(upper_bound(a.face_cdf, a.n_em_faces, u0 * total), 0, a.n_em_faces - 1);
  const float* row = a.em_packed + (int64_t)slot * 16;
  float lo = row[11], hi = row[12];
  float u_re = clampf(safe_div(u0 * total - lo, hi - lo), 0.0f, kOneMinus1e7);
  V3 v0 = vload(row), e1 = vload(row + 3), e2 = vload(row + 6);
  float tq = safe_sqrt(u_re);
  float b0 = 1.0f - tq, b1 = tq * uy;
  V3 p = (v0 + e1 * b0) + e2 * b1;
  V3 ng = normalize(cross(e1, e2));
  V3 d_un = p - si.p;
  float dist2 = dot(d_un, d_un);
  float dist = sqrtf(dist2);
  V3 d = d_un * safe_rcp(dist);
  float cos_l = dot(ng, -d);
  float pdf_sa = safe_div(row[10] * dist2, cos_l * row[9]);
  bool valid = active && (cos_l > 0.0f) && (dist2 > 0.0f) && (pdf_sa > 0.0f);
  int32_t em_id = bits_of(row[13]);
  V3 rad = vload(a.radiance + 3 * em_id);
  if (a.has_env_map) {
    // _sample_env_direction(u0, uy): DiscreteDistribution2D.sample_reuse
    int32_t he = a.env_h, we = a.env_w;
    float ty = uy * a.consts[kEnvTotal];
    int32_t y = clampi(upper_bound(a.env_row_cdf, he, ty), 0, he - 1);
    float row_lo = y > 0 ? a.env_row_cdf[y - 1] : 0.0f;
    float row_hi = a.env_row_cdf[y];
    float uyr = clampf(safe_div(ty - row_lo, row_hi - row_lo), 0.0f, kOneMinus1e7);
    const float* crow = a.env_col_cdf + (int64_t)y * we;
    float tx = u0 * crow[we - 1];
    int32_t x = clampi(upper_bound(crow, we, tx), 0, we - 1);
    float col_lo = x > 0 ? crow[x - 1] : 0.0f;
    float col_hi = crow[x];
    float uxr = clampf(safe_div(tx - col_lo, col_hi - col_lo), 0.0f, kOneMinus1e7);
    float pmf = a.env_weights[(int64_t)y * we + x] / a.consts[kEnvTotal];
    float eu = div_scalar((float)x + uxr, (float)we);
    float ev = div_scalar((float)y + uyr, (float)he);
    float theta = ev * kPi;
    float phi = (eu - 0.5f) * kTwoPi;
    float st = sinf(theta), ct = cosf(theta);
    V3 d_env = v3(st * sinf(phi), ct, -st * cosf(phi));
    float pdf_env = safe_div(pmf * (float)(he * we), kTwoPiSq * sinf(theta));
    V3 rad_env = env_bilinear(a, eu, ev) * vload(a.consts + kEnvRadiance);
    bool valid_env = active && (pdf_env > 0.0f);
    pdf_sa = sel_env ? pdf_env * p_env : pdf_sa * (1.0f - p_env);
    valid = sel_env ? valid_env : valid;
    d = sel_env ? d_env : d;
    rad = sel_env ? rad_env : rad;
  }
  EmSample o;
  o.d = d;
  o.rcp_pdf = safe_rcp(pdf_sa);
  o.weight = valid ? rad * o.rcp_pdf : v3(0.0f, 0.0f, 0.0f);
  o.pdf = valid ? pdf_sa : 0.0f;
  o.em_id = (valid && !sel_env) ? em_id : -1;
  return o;
}

// ---------------------------------------------------------------------------
// One vertex of a row: persistent._shade on the recorded hit, then the
// replay's commit
// ---------------------------------------------------------------------------

struct RowState {
  V3 L, f, prev_p, d;
  float eta, prev_pdf;
  bool prev_delta, act;
  int32_t depth;
  uint32_t key;
};

// what the adjoint needs of a vertex (the forward kernel discards it)
struct Vertex {
  V3 a;             // radiance added per unit throughput
  V3 w;             // the BSDF weight; f_{k+1} = f_k * w * rr
  float rr;         // the roulette scale (1 before rr_depth)
  bool adv;         // the path goes on
  int32_t e_hit;    // emitter of the hit, -1 none; its coefficient e_mis
  float e_mis;
  bool nee;         // the unoccluded NEE term was added
  int32_t e_nee;    // its area emitter, -1 none
  V3 nee_val;       // the BSDF's value at the NEE direction
  V3 nee_w;         // emitter weight (radiance / pdf)
  float nee_rcp, nee_mis;
  Mat mat;
  EvalOut ev;
  Sample bs;
};

RP_FN RowState row_start(const ReplayArgs& a, int64_t r) {
  RowState st;
  int64_t id = a.idx ? a.idx[r] : a.idx0 + r;
  st.act = a.ray_end < 0 || id < a.ray_end;
  st.key = (uint32_t)(id & 0xFFFFFFFFll);
  int64_t pix = id / a.spp;
  float px = (float)(pix % a.width), py = (float)(pix / a.width);
  float posx = px + rand01(a.seed, st.key, 0u);
  float posy = py + rand01(a.seed, st.key, 1u);
  float sx = div_scalar(posx, (float)a.width), sy = div_scalar(posy, (float)a.height);
  const float* M = a.consts + kToWorld;
  float x = (1.0f - 2.0f * sx) * a.consts[kTanHalf];
  float y = (1.0f - 2.0f * sy) * a.consts[kTanHalf + 1];
  float z = 1.0f;
  V3 dw = v3((M[0] * x + M[1] * y) + M[2] * z, (M[4] * x + M[5] * y) + M[6] * z,
             (M[8] * x + M[9] * y) + M[10] * z);
  st.d = normalize(dw);
  st.prev_p = v3(M[3], M[7], M[11]);
  st.L = v3(0.0f, 0.0f, 0.0f);
  st.f = v3(1.0f, 1.0f, 1.0f);
  st.eta = 1.0f;
  st.prev_pdf = 1.0f;
  st.prev_delta = true;
  st.depth = 1;
  return st;
}

// vertex k of a live row: updates st as the replay does, fills vx
RP_FN void shade_vertex(const ReplayArgs& a, RowState& st, int64_t r, int k, Vertex& vx) {
  int64_t at = r * a.depth + k;
  int32_t face = a.prim[at];
  bool occl = a.occl[at] != 0;
  SI si = make_si(a, st.d, face, a.rec_u[at], a.rec_v[at]);
  bool hit = si.valid;
  V3 zero = v3(0.0f, 0.0f, 0.0f);
  vx.a = zero;
  vx.w = zero;
  vx.rr = 1.0f;
  vx.adv = false;
  vx.e_hit = -1;
  vx.e_mis = 0.0f;
  vx.nee = false;
  vx.e_nee = -1;
  vx.ev.f = vx.ev.f_inner = vx.ev.dA = zero;
  vx.ev.pdf = 0.0f;

  // emission at the hit (ray-first MIS)
  bool gate = st.prev_pdf > 0.0f;
  if (gate && hit) {
    float em_pdf = 0.0f;
    if (si.emitter_id >= 0 && si.em_pmf > 0.0f && !st.prev_delta) {
      V3 d_un = si.p - st.prev_p;
      float dist2 = dot(d_un, d_un);
      V3 dd = d_un * rsqrt_safe(dist2);
      float cos_l = dot(si.n, -dd);
      float pdf = safe_div(si.em_pmf * dist2, cos_l * si.em_area);
      if (a.has_env_map) pdf = pdf * (1.0f - a.consts[kEnvSelectP]);
      em_pdf = cos_l > 0.0f ? pdf : 0.0f;
    }
    float mis = st.prev_delta ? 1.0f : mis_weight(st.prev_pdf, em_pdf);
    bool lit = si.emitter_id >= 0 && si.wi.z > 0.0f;
    V3 Le = lit ? vload(a.radiance + 3 * si.emitter_id) : zero;
    st.L = st.L + (st.f * Le) * mis;
    vx.a = Le * mis;
    if (lit) {
      vx.e_hit = si.emitter_id;
      vx.e_mis = mis;
    }
  }
  if (!hit) {
    // escape: the environment (MIS against its NEE)
    if (gate) {
      float env_pdf = st.prev_delta ? 0.0f : pdf_environment_direction(a, st.d);
      float mis = st.prev_delta ? 1.0f : mis_weight(st.prev_pdf, env_pdf);
      V3 env = eval_environment(a, st.d);
      st.L = st.L + (st.f * env) * mis;
      vx.a = env * mis;
    }
    st.act = false;
    return;
  }
  bool cont = st.depth < a.max_depth;
  if (!cont) {
    st.prev_p = si.p;
    st.prev_pdf = 0.0f;
    st.prev_delta = false;
    st.act = false;
    return;
  }

  // NEE at the surface
  uint32_t base = 2u + 6u * (uint32_t)(st.depth - 1);
  Mat mat = gather_mat(a, si.mat_id, si.uvx, si.uvy);
  bool active_em = (mat.flags & Smooth) != 0;
  float ue0 = rand01(a.seed, st.key, base), ue1 = rand01(a.seed, st.key, base + 1u);
  EmSample ds = sample_emitter_direction(a, si, ue0, ue1, active_em);
  active_em = active_em && ds.pdf != 0.0f;
  V3 wo = to_local(si, ds.d);
  float u1 = rand01(a.seed, st.key, base + 2u);
  float u2x = rand01(a.seed, st.key, base + 3u), u2y = rand01(a.seed, st.key, base + 4u);
  bool has_mat = si.mat_id >= 0;
  Sample bs = bsdf_sample(mat, si.wi, u1, u2x, u2y, has_mat);
  if (active_em && !occl) {
    EvalOut ev = bsdf_eval(mat, si.wi, wo, has_mat);
    float mis_em = mis_weight(ds.pdf, ev.pdf);
    V3 t = (st.f * ev.f) * ds.weight;
    st.L = st.L + t * mis_em;
    vx.a = vx.a + (ev.f * ds.weight) * mis_em;
    vx.nee = true;
    vx.e_nee = ds.em_id;
    vx.nee_val = ev.f;
    vx.nee_w = ds.weight;
    vx.nee_rcp = ds.rcp_pdf;
    vx.nee_mis = mis_em;
    vx.ev = ev;
  }

  // BSDF bounce + Russian roulette
  V3 f2 = st.f * bs.w;
  float eta2 = st.eta * bs.eta;
  float fmax = max3(f2.x, f2.y, f2.z);
  float rr_prob = cmax(fmax * eta2 * eta2, 0.95f);
  bool rr_active = st.depth >= a.rr_depth;
  bool rr_continue = rand01(a.seed, st.key, base + 5u) < rr_prob;
  float rr = rr_active ? safe_rcp(rr_prob) : 1.0f;
  if (rr_active) f2 = f2 * rr;
  bool cont2 = (fmax != 0.0f) && (!rr_active || rr_continue);
  vx.w = bs.w;
  vx.rr = rr;
  vx.adv = cont2;
  vx.mat = mat;
  vx.bs = bs;

  st.prev_p = si.p;
  st.prev_pdf = bs.pdf;
  st.prev_delta = (bs.stype & Delta) != 0;
  if (cont2) {
    st.f = f2;
    st.eta = eta2;
    st.d = to_world(si, bs.wo);
    st.depth += 1;
  }
  st.act = cont2;
}

// the per-row radiance
RP_FN V3 replay_row(const ReplayArgs& a, int64_t r) {
  RowState st = row_start(a, r);
  for (int k = 0; k < a.n_steps && st.act; ++k) {
    Vertex vx;
    shade_vertex(a, st, r, k, vx);
  }
  return st.L;
}

// the per-row adjoint: adds g * dL/d(table) into the tables through
// acc.bc(row, channel, value) and acc.rad(row, channel, value)
template <class Acc>
RP_FN void replay_row_adjoint(const ReplayArgs& a, int64_t r, V3 g, Acc& acc) {
  const int64_t n = a.n_rows;
  float* sc = a.scratch;
  // pass 1: a_k and w_k * rr_k of each vertex
  RowState st = row_start(a, r);
  int K = 0;
  for (; K < a.n_steps && st.act; ++K) {
    Vertex vx;
    shade_vertex(a, st, r, K, vx);
    V3 q = vx.adv ? vx.w * vx.rr : v3(0.0f, 0.0f, 0.0f);
    float* s = sc + (int64_t)K * 6 * n + r;
    s[0] = vx.a.x; s[n] = vx.a.y; s[2 * n] = vx.a.z;
    s[3 * n] = q.x; s[4 * n] = q.y; s[5 * n] = q.z;
  }
  // pass 2: the suffixes; slot k keeps S_{k+1}
  V3 S = v3(0.0f, 0.0f, 0.0f);
  for (int k = K - 1; k >= 0; --k) {
    float* s = sc + (int64_t)k * 6 * n + r;
    V3 next = S;
    S = v3(s[0], s[n], s[2 * n]) + v3(s[3 * n], s[4 * n], s[5 * n]) * S;
    s[0] = next.x; s[n] = next.y; s[2 * n] = next.z;
  }
  // pass 3: the vertices again, each with its throughput and S_{k+1}
  st = row_start(a, r);
  for (int k = 0; k < K; ++k) {
    V3 f = st.f;
    Vertex vx;
    shade_vertex(a, st, r, k, vx);
    V3 ga = g * f;
    if (vx.e_hit >= 0) {
      acc.rad(vx.e_hit, 0, ga.x * vx.e_mis);
      acc.rad(vx.e_hit, 1, ga.y * vx.e_mis);
      acc.rad(vx.e_hit, 2, ga.z * vx.e_mis);
    }
    V3 gb = v3(0.0f, 0.0f, 0.0f);
    if (vx.nee) {
      if (vx.e_nee >= 0) {
        float s = vx.nee_rcp * vx.nee_mis;
        acc.rad(vx.e_nee, 0, ga.x * vx.nee_val.x * s);
        acc.rad(vx.e_nee, 1, ga.y * vx.nee_val.y * s);
        acc.rad(vx.e_nee, 2, ga.z * vx.nee_val.z * s);
      }
      gb = ga * vx.nee_w * vx.nee_mis;
    }
    V3 gw = v3(0.0f, 0.0f, 0.0f);
    if (vx.adv) {
      const float* s = sc + (int64_t)k * 6 * n + r;
      gw = ga * vx.rr * v3(s[0], s[n], s[2 * n]);
    }
    if (!vx.nee && !vx.adv) continue;
    const Mat& m = vx.mat;
    V3 gbase = (gb * vx.ev.dA + gw * vx.bs.dA) * m.tex;
    acc.bc(m.eff, 0, gbase.x);
    acc.bc(m.eff, 1, gbase.y);
    acc.bc(m.eff, 2, gbase.z);
    if (m.is_mask && m.op_from_base) {
      V3 gop = gb * vx.ev.f_inner;
      gop = gop + vx.bs.dop[0] * gw.x + vx.bs.dop[1] * gw.y + vx.bs.dop[2] * gw.z;
      for (int j = 0; j < 3; ++j) {
        float s = clip_grad(comp(m.op_raw, j), 0.0f, 1.0f);
        if (s != 0.0f) acc.bc(m.mid, j, comp(gop, j) * s);
      }
    }
  }
}

}  // namespace rp
