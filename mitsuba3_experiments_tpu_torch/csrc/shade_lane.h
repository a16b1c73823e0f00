// K6's arithmetic: the shading of one lane of the wavefront
// (integrators/persistent._shade), as __host__ __device__ functions built
// from K5's (replay_path.h).
//
// csrc/shade_wavefront.cu includes this header for the card; the CPU tests
// compile it with g++ through csrc/shade_lane_host.cpp.  `shade_lane`
// computes, for one lane, every field that `_shade` returns, with the same
// float operations in the same order (no fused multiply-adds: nvcc builds
// with --fmad=false and g++ with -ffp-contract=off), so that the two agree
// bit for bit except where a transcendental function (sin, cos, atan2, acos,
// pow) rounds differently.  What it adds to K5's functions: the NEE term
// before the shadow test (K5's shade_vertex reads the record's occlusion
// bit instead), the next bounce's ray (SurfaceInteraction.spawn_ray) and
// the shadow ray (SurfaceInteraction.spawn_ray_to, core/records.py) with
// its target.  replay_path.h stays as K5 compiles it.
#pragma once

#include "replay_path.h"

namespace rp {

// ShadeArgs::scene.consts holds K5's kConsts floats, then these
enum {
  kFar = kConsts,   // 2 * emitter._scene_radius: how far an environment NEE target lies
  kShadeConsts,
};

constexpr float kRayEps = 1e-4f;                      // core/math.RAY_EPS
constexpr float kShadowReach = (float)(1.0 - 1e-3);   // spawn_ray_to's maxt factor

// One bounce of the wavefront: the scene (K5's structure with the record's
// pointers null; seed, max_depth and rr_depth set), the live lanes' state as
// trace_rays holds it ((n,) or (n, 3) row-major) and _shade's fields out.
struct ShadeArgs {
  ReplayArgs scene;
  int64_t n;
  const float* d;
  const float* t;
  const int32_t* face;
  const float* u;
  const float* v;
  const float* L;
  const float* f;
  const float* eta;
  const int32_t* depth;
  const float* prev_p;
  const float* prev_pdf;
  const uint8_t* prev_delta;
  const int64_t* idx;
  float* L_out;
  float* f_out;
  float* eta_out;
  float* p;
  float* pdf;
  uint8_t* delta;
  float* nee_L;
  float* next_o;
  float* next_d;
  uint8_t* cont;
  float* shadow_o;
  float* shadow_d;
  float* shadow_maxt;
  uint8_t* active_em;
};

// a lane's state before the shading
struct Lane {
  V3 d, L, f, prev_p;
  float t, u, v, eta, prev_pdf;
  int32_t face, depth;
  bool prev_delta;
  uint32_t key;   // the camera-ray index's low 32 bits, as wavefront._rand keys a draw
};

// _shade's fields of a lane
struct Shaded {
  V3 L, f, p, nee_L, next_o, next_d, shadow_o, shadow_d;
  float eta, pdf, shadow_maxt;
  bool delta, cont, active_em;
};

// The shadow ray's target of an NEE sample drawn with (ux, uy), as
// emitter.sample_emitter_direction gives it in DirectionSample.p: the point
// on the area light (its face pick and barycentrics again, in the same
// operations: K5's EmSample does not keep the point), or, where the
// environment was picked, the point `far` along the sampled direction d.
RP_FN V3 nee_target(const ReplayArgs& a, const SI& si, float ux, float uy, V3 d) {
  float u0 = ux;
  if (a.has_env_map) {
    float p_env = a.consts[kEnvSelectP];
    if (ux < p_env) return si.p + d * a.consts[kFar];
    u0 = clampf(safe_div(ux - p_env, 1.0f - p_env), 0.0f, kOneMinus1e7);
  }
  float total = a.consts[kFaceTotal];
  int32_t slot = clampi(upper_bound(a.face_cdf, a.n_em_faces, u0 * total), 0, a.n_em_faces - 1);
  const float* row = a.em_packed + (int64_t)slot * 16;
  float u_re = clampf(safe_div(u0 * total - row[11], row[12] - row[11]), 0.0f, kOneMinus1e7);
  float tq = safe_sqrt(u_re);
  return (vload(row) + vload(row + 3) * (1.0f - tq)) + vload(row + 6) * (tq * uy);
}

// a ray's origin off the surface, on the side of direction d (spawn_ray)
RP_FN V3 spawn_origin(const SI& si, V3 d) {
  float sign = sign_not_zero(dot(si.n, d));
  return si.p + si.n * (sign * kRayEps);
}

// _shade on one lane whose closest hit has just been found (doneA true)
RP_FN Shaded shade_lane(const ReplayArgs& a, const Lane& in) {
  V3 zero = v3(0.0f, 0.0f, 0.0f);
  Shaded o;
  o.L = in.L;
  o.f = o.p = o.nee_L = o.next_o = o.next_d = o.shadow_o = o.shadow_d = zero;
  o.eta = o.pdf = o.shadow_maxt = 0.0f;
  o.delta = o.cont = o.active_em = false;
  // si.valid is isfinite(t) where the face is a hit
  SI si = make_si(a, in.d, (in.face >= 0 && finite(in.t)) ? in.face : -1, in.u, in.v);

  // emission at the hit (ray-first MIS), the environment on an escape
  bool gate = in.prev_pdf > 0.0f;
  if (gate && si.valid) {
    float em_pdf = 0.0f;
    if (si.emitter_id >= 0 && si.em_pmf > 0.0f && !in.prev_delta) {
      V3 d_un = si.p - in.prev_p;
      float dist2 = dot(d_un, d_un);
      V3 dd = d_un * rsqrt_safe(dist2);
      float cos_l = dot(si.n, -dd);
      float pdf = safe_div(si.em_pmf * dist2, cos_l * si.em_area);
      if (a.has_env_map) pdf = pdf * (1.0f - a.consts[kEnvSelectP]);
      em_pdf = cos_l > 0.0f ? pdf : 0.0f;
    }
    float mis = in.prev_delta ? 1.0f : mis_weight(in.prev_pdf, em_pdf);
    bool lit = si.emitter_id >= 0 && si.wi.z > 0.0f;
    V3 Le = lit ? vload(a.radiance + 3 * si.emitter_id) : zero;
    o.L = o.L + (in.f * Le) * mis;
  }
  if (!si.valid) {
    if (gate) {
      float env_pdf = in.prev_delta ? 0.0f : pdf_environment_direction(a, in.d);
      float mis = in.prev_delta ? 1.0f : mis_weight(in.prev_pdf, env_pdf);
      o.L = o.L + (in.f * eval_environment(a, in.d)) * mis;
    }
    return o;
  }
  if (in.depth >= a.max_depth) return o;

  // NEE at the surface: the sample and its term before the shadow test
  uint32_t base = 2u + 6u * (uint32_t)(in.depth - 1);
  Mat mat = gather_mat(a, si.mat_id, si.uvx, si.uvy);
  bool active_em = (mat.flags & Smooth) != 0;
  float ue0 = rand01(a.seed, in.key, base), ue1 = rand01(a.seed, in.key, base + 1u);
  EmSample ds = sample_emitter_direction(a, si, ue0, ue1, active_em);
  active_em = active_em && ds.pdf != 0.0f;
  float u1 = rand01(a.seed, in.key, base + 2u);
  float u2x = rand01(a.seed, in.key, base + 3u), u2y = rand01(a.seed, in.key, base + 4u);
  bool has_mat = si.mat_id >= 0;
  if (active_em) {
    EvalOut ev = bsdf_eval(mat, si.wi, to_local(si, ds.d), has_mat);
    o.nee_L = ((in.f * ev.f) * ds.weight) * mis_weight(ds.pdf, ev.pdf);
  }
  o.active_em = active_em;

  // the BSDF bounce and Russian roulette (its probability detached)
  Sample bs = bsdf_sample(mat, si.wi, u1, u2x, u2y, has_mat);
  V3 f2 = in.f * bs.w;
  float eta2 = in.eta * bs.eta;
  float fmax = max3(f2.x, f2.y, f2.z);
  float rr_prob = cmax(fmax * eta2 * eta2, 0.95f);
  bool rr_active = in.depth >= a.rr_depth;
  bool rr_continue = rand01(a.seed, in.key, base + 5u) < rr_prob;
  if (rr_active) f2 = f2 * safe_rcp(rr_prob);
  o.cont = (fmax != 0.0f) && (!rr_active || rr_continue);
  o.f = f2;
  o.eta = eta2;
  o.p = si.p;
  o.pdf = bs.pdf;
  o.delta = (bs.stype & Delta) != 0;
  o.next_d = to_world(si, bs.wo);
  o.next_o = spawn_origin(si, o.next_d);

  // the shadow ray towards the NEE target (spawn_ray_to)
  V3 sd = nee_target(a, si, ue0, ue1, ds.d) - si.p;
  float dist = sqrtf(dot(sd, sd));
  o.shadow_d = sd * safe_rcp(dist);
  o.shadow_o = spawn_origin(si, o.shadow_d);
  o.shadow_maxt = dist * kShadowReach - kRayEps;
  return o;
}

// lane state reads: the read-only data path on the card
template <class T>
RP_FN T ld(const T* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}
RP_FN V3 ld3(const float* p, int64_t i) {
  return v3(ld(p + 3 * i), ld(p + 3 * i + 1), ld(p + 3 * i + 2));
}
RP_FN void st3(float* p, int64_t i, V3 x) {
  p[3 * i] = x.x;
  p[3 * i + 1] = x.y;
  p[3 * i + 2] = x.z;
}

// lane i of a bounce: its state in, _shade's fields out
RP_FN void shade_row(const ShadeArgs& s, int64_t i) {
  Lane in;
  in.d = ld3(s.d, i);
  in.L = ld3(s.L, i);
  in.f = ld3(s.f, i);
  in.prev_p = ld3(s.prev_p, i);
  in.t = ld(s.t + i);
  in.u = ld(s.u + i);
  in.v = ld(s.v + i);
  in.eta = ld(s.eta + i);
  in.prev_pdf = ld(s.prev_pdf + i);
  in.face = ld(s.face + i);
  in.depth = ld(s.depth + i);
  in.prev_delta = ld(s.prev_delta + i) != 0;
  in.key = (uint32_t)(ld(s.idx + i) & 0xFFFFFFFFll);
  Shaded o = shade_lane(s.scene, in);
  st3(s.L_out, i, o.L);
  st3(s.f_out, i, o.f);
  st3(s.p, i, o.p);
  st3(s.nee_L, i, o.nee_L);
  st3(s.next_o, i, o.next_o);
  st3(s.next_d, i, o.next_d);
  st3(s.shadow_o, i, o.shadow_o);
  st3(s.shadow_d, i, o.shadow_d);
  s.eta_out[i] = o.eta;
  s.pdf[i] = o.pdf;
  s.shadow_maxt[i] = o.shadow_maxt;
  s.delta[i] = o.delta;
  s.cont[i] = o.cont;
  s.active_em[i] = o.active_em;
}

}  // namespace rp
