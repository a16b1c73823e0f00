// 8-wide BVH traversal, one ray per thread (closest hit and any hit).
//
// Replaces the TPU kernel `traverse_pallas` (mitsuba3_experiments_tpu/
// intersect/bvh_pallas.py) and the XLA lockstep loop it stood in for,
// `bvh_jax._traverse` (mitsuba3_experiments_tpu/intersect/bvh_jax.py).  The
// TPU kernel kept the whole tree in VMEM and fetched rows by one-hot MXU
// matmuls with float-valued ids, which capped it at ~200k triangles; none of
// that is carried over.  Here each thread walks the tree on its own, reading
// the 352-byte rows of BVH.unified (node rows, then leaf rows) straight from
// device memory with float4 loads, and keeps an int stack in local memory.
//
// What bounds it on an H100: the latency of the dependent row fetches.  Each
// step's row address comes from the previous row, and at 2M triangles the
// table is ~150 MB, beyond the 50 MB L2, so most fetches go to HBM.  This is
// the simple, correct form: no ray sorting, no persistent threads, no
// wide-node compression.  Making it fast is later work.
//
// Semantics follow bvh_jax._traverse exactly.  The build disables FMA
// contraction (nvcc --fmad=false), so the only fused operations are the
// fmaf calls of dot3/cross3, which the plain torch version reproduces; the
// kernel then gives the plain version's bits:
//   * inv_d = 1/d, +inf where d == 0; min/max propagate NaN like torch's;
//   * a child is hit when t_near <= t_far * 1.00000024, t_far > 0,
//     t_near < t_best and the slot is not empty;
//   * the nearest hit child is descended (lowest slot on equal t_near); the
//     other hits are pushed far to near, the lower slot popped first on
//     equal t.  Any-hit queries push in slot order, as _traverse does;
//   * a leaf tests its slots 0..7 in order (face < 0 = padding), a hit
//     replacing the best only when t < t_best strictly, |det| > 1e-10;
//   * any hit stops after the first leaf with a hit;
//   * t = inf where face < 0;
//   * a ray whose pushes would pass the layout's stack depth stops with
//     face = -2 (never on a table from collapse_to_wide, which guarantees
//     the depth), and the wrapper raises.
//
// Plain C interface; the Python wrapper (intersect/bvh_cuda.py) checks the
// arguments, allocates the outputs and launches on torch's current stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWidth = 8;
constexpr int kLeafCap = 8;
constexpr int kRow = 88;        // unified row width in floats (352 bytes)
constexpr int kRow4 = kRow / 4;
constexpr int kNodeBase = 8;    // child bounds start after the 8 codes
constexpr int kFaceOff = 80;    // leaf face ids
constexpr int kMaxStack = 96;
constexpr int kDone = -1;
constexpr int kOverflow = -2;  // face code of a ray whose stack overflowed
constexpr int kThreads = 128;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub3(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }

// The fused multiply-adds of the triangle test, written out: XLA's CPU
// backend contracts the JAX reference's dot and cross products exactly so,
// and the plain torch version (intersect/triangle.py) emulates them.
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x));
}

__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {fmaf(a.y, b.z, -(a.z * b.y)), fmaf(a.z, b.x, -(a.x * b.z)),
          fmaf(a.x, b.y, -(a.y * b.x))};
}

// torch.minimum / torch.maximum: NaN if either operand is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float rcp_or_inf(float x) {
  return x != 0.0f ? 1.0f / x : __int_as_float(0x7f800000);
}

__global__ void __launch_bounds__(kThreads)
bvh8_traverse_kernel(const float* __restrict__ unified, int n_nodes,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ maxt,
                     const uint8_t* __restrict__ active, int n, int any_hit,
                     int stack_cap, float* __restrict__ t_out,
                     int* __restrict__ face_out, float* __restrict__ u_out,
                     float* __restrict__ v_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float kInf = __int_as_float(0x7f800000);

  const V3 ro = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
  const V3 rd = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  const V3 inv = {rcp_or_inf(rd.x), rcp_or_inf(rd.y), rcp_or_inf(rd.z)};
  const bool act = active[i] != 0;

  float t_best = act ? maxt[i] : 0.0f;
  int face_best = -1;
  float u_best = 0.0f, v_best = 0.0f;

  int stack[kMaxStack];
  int sp = 0;
  int cur = act ? 0 : kDone;
  const float4* tab = reinterpret_cast<const float4*>(unified);

  while (cur != kDone) {
    if (cur >= 0) {
      // ---------------- internal row: 8 slab tests ----------------
      const float4* r = tab + static_cast<size_t>(cur) * kRow4;
      float nb[kNodeBase + 6 * kWidth];
#pragma unroll
      for (int q = 0; q < (kNodeBase + 6 * kWidth) / 4; ++q) {
        const float4 f = __ldg(r + q);
        nb[4 * q] = f.x;
        nb[4 * q + 1] = f.y;
        nb[4 * q + 2] = f.z;
        nb[4 * q + 3] = f.w;
      }
      float tn[kWidth];
      bool hit[kWidth];
      int nearest = -1;
      float t_min = kInf;
#pragma unroll
      for (int k = 0; k < kWidth; ++k) {
        const float* b = nb + kNodeBase + 6 * k;
        const float t0x = (b[0] - ro.x) * inv.x, t1x = (b[3] - ro.x) * inv.x;
        const float t0y = (b[1] - ro.y) * inv.y, t1y = (b[4] - ro.y) * inv.y;
        const float t0z = (b[2] - ro.z) * inv.z, t1z = (b[5] - ro.z) * inv.z;
        const float t_near =
            nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)), nan_min(t0z, t1z));
        const float t_far =
            nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)), nan_max(t0z, t1z));
        const bool h = (t_near <= t_far * 1.00000024f) && (t_far > 0.0f) &&
                       (t_near < t_best) && (__float_as_int(nb[k]) != kDone);
        tn[k] = t_near;
        hit[k] = h;
        if (h && t_near < t_min) {  // strict: the lowest slot wins ties
          t_min = t_near;
          nearest = k;
        }
      }
      if (nearest >= 0) {
        unsigned push = 0;
#pragma unroll
        for (int k = 0; k < kWidth; ++k) push |= (hit[k] && k != nearest) ? (1u << k) : 0u;
        const int n_push = __popc(push);
        if (sp + n_push > stack_cap) {
          // collapse_to_wide guarantees the capacity, so only a corrupt
          // table gets here: the ray reports it and the wrapper raises
          face_best = kOverflow;
          break;
        }
        // push the other hits; slot k lands at sp + rank[k], so the
        // nearest (closest hit) or the highest slot (any hit) is on top
#pragma unroll
        for (int k = 0; k < kWidth; ++k) {
          int rank = 0;
#pragma unroll
          for (int j = 0; j < kWidth; ++j) {
            const bool before = any_hit ? (j < k)
                                        : (tn[j] > tn[k] || (tn[j] == tn[k] && j > k));
            rank += ((push >> j & 1u) && before) ? 1 : 0;
          }
          if (push >> k & 1u) stack[sp + rank] = __float_as_int(nb[k]);
        }
        sp += n_push;
        cur = __float_as_int(nb[nearest]);
      } else {
        cur = sp > 0 ? stack[--sp] : kDone;
      }
    } else {
      // ---------------- leaf row: 8 triangle tests ----------------
      const float4* r = tab + static_cast<size_t>(n_nodes + (-cur - 2)) * kRow4;
      float tv[9 * kLeafCap];
#pragma unroll
      for (int q = 0; q < 9 * kLeafCap / 4; ++q) {
        const float4 f = __ldg(r + q);
        tv[4 * q] = f.x;
        tv[4 * q + 1] = f.y;
        tv[4 * q + 2] = f.z;
        tv[4 * q + 3] = f.w;
      }
      const int4 fa = __ldg(reinterpret_cast<const int4*>(r + kFaceOff / 4));
      const int4 fb = __ldg(reinterpret_cast<const int4*>(r + kFaceOff / 4 + 1));
      const int fid[kLeafCap] = {fa.x, fa.y, fa.z, fa.w, fb.x, fb.y, fb.z, fb.w};
#pragma unroll
      for (int k = 0; k < kLeafCap; ++k) {
        const float* g = tv + 9 * k;
        const V3 v0 = {g[0], g[1], g[2]};
        const V3 e1 = sub3({g[3], g[4], g[5]}, v0);
        const V3 e2 = sub3({g[6], g[7], g[8]}, v0);
        const V3 pvec = cross3(rd, e2);
        const float det = dot3(e1, pvec);
        const float inv_det = det != 0.0f ? 1.0f / det : 0.0f;
        const V3 tvec = sub3(ro, v0);
        const float u = dot3(tvec, pvec) * inv_det;
        const V3 qvec = cross3(tvec, e1);
        const float v = dot3(rd, qvec) * inv_det;
        const float t = dot3(e2, qvec) * inv_det;
        const bool h = (fabsf(det) > 1e-10f) && (u >= 0.0f) && (v >= 0.0f) &&
                       (u + v <= 1.0f) && (t > 0.0f) && (t < t_best);
        if (h && fid[k] >= 0) {
          t_best = t;
          face_best = fid[k];
          u_best = u;
          v_best = v;
        }
      }
      if (any_hit && face_best >= 0) {
        cur = kDone;
      } else {
        cur = sp > 0 ? stack[--sp] : kDone;
      }
    }
  }

  t_out[i] = face_best >= 0 ? t_best : kInf;
  face_out[i] = face_best;
  u_out[i] = u_best;
  v_out[i] = v_best;
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 on success).
int m3t_bvh8_traverse(const float* unified, int n_nodes, const float* o,
                      const float* d, const float* maxt, const uint8_t* active,
                      int n, int any_hit, int stack_cap, float* t_out,
                      int* face_out, float* u_out, float* v_out, void* stream) {
  if (n <= 0) return 0;
  if (stack_cap < 1 || stack_cap > kMaxStack) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kThreads);
  const dim3 grid((n + kThreads - 1) / kThreads);
  bvh8_traverse_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      unified, n_nodes, o, d, maxt, active, n, any_hit, stack_cap, t_out, face_out,
      u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}

int m3t_bvh8_max_stack() { return kMaxStack; }

}  // extern "C"
