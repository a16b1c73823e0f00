// 8-wide BVH traversal in persistent warps (closest hit and any hit).
//
// Replaces the TPU kernel `traverse_pallas` (mitsuba3_experiments_tpu/
// intersect/bvh_pallas.py) and the XLA lockstep loop it stood in for,
// `bvh_jax._traverse` (mitsuba3_experiments_tpu/intersect/bvh_jax.py).  The
// TPU kernel kept the whole tree in VMEM and fetched rows by one-hot MXU
// matmuls with float-valued ids, which capped it at ~200k triangles; none of
// that is carried over.  Here each lane walks one ray through the tree at a
// time, reading the 352-byte rows of BVH.unified (node rows, then leaf
// rows) straight from device memory with 16-byte loads, with an int stack
// in local memory.
//
// What bounds it on an H100 (measured on the 2M-triangle stand-in with
// cuobjdump -sass and builds that count warp steps and the distinct rows
// each step reads; PERF.md has the numbers): the instructions it executes
// and the L1/L2 traffic of its row fetches, not their latency, which the
// rays in flight hide.  So:
//   * few instructions a step (~440 per node step, ~600 per leaf step, the
//     IEEE division kept because the bits need it): PTX min.NaN / max.NaN,
//     one instruction each; the pushes ordered by selecting, among the hit
//     children only, the farthest first (ties: the higher slot), which is
//     the rank rule's order; child codes re-read from the row (an L1 hit)
//     at a dynamic index, so no row array lives in local memory;
//   * full warps: persistent warps, the grid holding only the blocks that
//     fit on the card at once; once kRefillBatch lanes of a warp have ended
//     their rays they take the next ones from the warp's pool, which takes
//     kGrab rays at a time from a global counter (one atomicAdd per refill
//     of the pool).  Refilling lanes in groups keeps neighbouring pixels in
//     step, so the lanes of a node step share row fetches (refilling each
//     lane alone read more distinct rows a step and ran slower);
//   * a node step every round and leaf steps batched: a lane on a leaf row
//     waits until kLeafBatch lanes of its warp hold one, or no lane is on a
//     node row.  No step is speculative, so each ray visits its rows in the
//     same order.  This kept more lanes busy over a render pass than
//     while-while (Aila & Laine, 2009), which ran the pass slower;
//   * __launch_bounds__ for 24 resident warps per SM: 80 registers and no
//     spills (at 32 warps a thread must fit in 64 registers, spills, and
//     ran no faster);
//   * no copy of the first node rows in shared memory: they stay hot in L1,
//     and a copy per block would take the on-chip memory L1 keeps deeper
//     rows in.
// The ray counter needs no memset: the last warp to finish sets it and the
// warps' finish count back to 0, and launches on one stream run in order
// (the wrapper keeps one counter per device and stream).
//
// Semantics follow bvh_jax._traverse exactly.  The build disables FMA
// contraction (nvcc --fmad=false), so the only fused operations are the
// fmaf calls of dot3/cross3, which the plain torch version reproduces; the
// kernel then gives the plain version's bits:
//   * inv_d = 1/d, +inf where d == 0; min/max propagate NaN like torch's (a
//     NaN bound only ever makes a child miss, so its payload is moot);
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
constexpr int kFaceOff = 80;    // leaf face ids
constexpr int kMaxStack = 96;
constexpr int kDone = -1;
constexpr int kOverflow = -2;  // face code of a ray whose stack overflowed
constexpr int kThreads = 128;
constexpr int kMinBlocks = 6;  // 24 resident warps per SM: <= 80 registers
constexpr int kGrab = 32;        // rays a warp takes from the counter at once
constexpr int kRefillBatch = 8;  // idle lanes that make a refill
constexpr int kLeafBatch = 12;   // lanes on leaf rows that make a leaf step
constexpr unsigned kFull = 0xffffffffu;

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
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float rcp_or_inf(float x) {
  return x != 0.0f ? 1.0f / x : __int_as_float(0x7f800000);
}

// One lane's ray: its index (-1: none), the row it is on (>= 0 a node row,
// <= -2 leaf row -cur-2, kDone: ended), its stack depth and best hit.
struct Lane {
  int ray, cur, sp, face;
  V3 o, d, inv;
  float t, u, v;
};

// The table, the query and the outputs of one launch.
struct Query {
  const float4* rows;  // BVH.unified as 16-byte words
  const int* codes;    // BVH.unified as ints
  int n_nodes;
  const float* o;
  const float* d;
  const float* maxt;
  const uint8_t* active;
  int n, any_hit, stack_cap;
  float* t_out;
  int* face_out;
  float* u_out;
  float* v_out;
  unsigned long long* work;  // [0] rays handed out, [1] warps finished
};

// Warp-collective: writes the result of every lane whose ray has ended and,
// once kRefillBatch lanes are idle, gives each idle lane the next ray.  The
// warp holds rays [pool, pool_end) and takes kGrab more from the counter
// when it runs short.
__device__ __forceinline__ void retire_and_refill(Lane& L, long long& pool, long long& pool_end,
                                                  const Query& q, int lane) {
  if (L.cur == kDone && L.ray >= 0) {
    q.t_out[L.ray] = L.face >= 0 ? L.t : __int_as_float(0x7f800000);
    q.face_out[L.ray] = L.face;
    q.u_out[L.ray] = L.u;
    q.v_out[L.ray] = L.v;
    L.ray = -1;
  }
  const unsigned idle = __ballot_sync(kFull, L.cur == kDone);
  if (__popc(idle) < kRefillBatch || pool >= q.n) return;
  const long long want = __popc(idle);
  const long long avail = pool_end - pool;
  long long fresh = 0;
  if (want > avail) {
    unsigned long long b = 0;
    if (lane == 0) b = atomicAdd(q.work, static_cast<unsigned long long>(kGrab));
    fresh = static_cast<long long>(__shfl_sync(kFull, b, 0));
  }
  if (L.cur == kDone) {
    const long long rank = __popc(idle & ((1u << lane) - 1u));
    const long long idx = rank < avail ? pool + rank : fresh + (rank - avail);
    if (idx < q.n) {
      const int i = static_cast<int>(idx);
      L.ray = i;
      L.o = {__ldg(q.o + 3 * i), __ldg(q.o + 3 * i + 1), __ldg(q.o + 3 * i + 2)};
      L.d = {__ldg(q.d + 3 * i), __ldg(q.d + 3 * i + 1), __ldg(q.d + 3 * i + 2)};
      L.inv = {rcp_or_inf(L.d.x), rcp_or_inf(L.d.y), rcp_or_inf(L.d.z)};
      const bool act = __ldg(q.active + i) != 0;
      L.t = act ? __ldg(q.maxt + i) : 0.0f;
      L.face = -1;
      L.u = 0.0f;
      L.v = 0.0f;
      L.sp = 0;
      L.cur = act ? 0 : kDone;
    }
  }
  if (want > avail) {
    pool = fresh + (want - avail);
    pool_end = fresh + kGrab;
  } else {
    pool += want;
  }
}

// One node row: 8 slab tests, descend into the nearest hit child and push
// the others, or pop.
__device__ __forceinline__ void node_step(Lane& L, int* stack, const Query& q) {
  const float kInf = __int_as_float(0x7f800000);
  const float4* r = q.rows + static_cast<size_t>(L.cur) * kRow4;
  const int* c = q.codes + static_cast<size_t>(L.cur) * kRow;
  const int4 ca = __ldg(reinterpret_cast<const int4*>(r));
  const int4 cb = __ldg(reinterpret_cast<const int4*>(r + 1));
  const int code8[kWidth] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
  float tn[kWidth];
  unsigned hits = 0;
  int nearest = -1;
  float t_min = kInf;
#pragma unroll
  for (int m = 0; m < kWidth / 2; ++m) {
    // children 2m, 2m+1: the 12 floats from row float 8 + 12m
    const float4 fa = __ldg(r + 2 + 3 * m);
    const float4 fb = __ldg(r + 3 + 3 * m);
    const float4 fc = __ldg(r + 4 + 3 * m);
    const float bb[12] = {fa.x, fa.y, fa.z, fa.w, fb.x, fb.y, fb.z, fb.w, fc.x, fc.y, fc.z, fc.w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 2 * m + h;
      const float* b = bb + 6 * h;
      const float t0x = (b[0] - L.o.x) * L.inv.x, t1x = (b[3] - L.o.x) * L.inv.x;
      const float t0y = (b[1] - L.o.y) * L.inv.y, t1y = (b[4] - L.o.y) * L.inv.y;
      const float t0z = (b[2] - L.o.z) * L.inv.z, t1z = (b[5] - L.o.z) * L.inv.z;
      const float t_near =
          max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)), min_nan(t0z, t1z));
      const float t_far =
          min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)), max_nan(t0z, t1z));
      const bool hit = (t_near <= t_far * 1.00000024f) && (t_far > 0.0f) && (t_near < L.t) &&
                       (code8[k] != kDone);
      tn[k] = t_near;
      hits |= hit ? (1u << k) : 0u;
      if (hit && t_near < t_min) {  // strict: the lowest slot wins ties
        t_min = t_near;
        nearest = k;
      }
    }
  }
  if (nearest < 0) {
    L.cur = L.sp > 0 ? stack[--L.sp] : kDone;
    return;
  }
  unsigned push = hits & ~(1u << nearest);
  if (L.sp + __popc(push) > q.stack_cap) {
    // collapse_to_wide guarantees the capacity, so only a corrupt table
    // gets here: the ray reports it and the wrapper raises
    L.face = kOverflow;
    L.cur = kDone;
    return;
  }
  if (q.any_hit) {
    // slot order: the highest slot on top
#pragma unroll
    for (int k = 0; k < kWidth; ++k) {
      if (push >> k & 1u) stack[L.sp++] = __ldg(c + k);
    }
  } else {
    // the farthest first, the higher slot first on equal t: the nearest
    // ends on top, the lower slot above on equal t
    while (push != 0) {
      int pick = -1;
      float far = 0.0f;
#pragma unroll
      for (int k = 0; k < kWidth; ++k) {
        if ((push >> k & 1u) && (pick < 0 || tn[k] >= far)) {
          far = tn[k];
          pick = k;
        }
      }
      stack[L.sp++] = __ldg(c + pick);
      push &= ~(1u << pick);
    }
  }
  L.cur = __ldg(c + nearest);
}

// One leaf row: 8 triangle tests in slot order, then pop (or stop: any hit).
__device__ __forceinline__ void leaf_step(Lane& L, const int* stack, const Query& q) {
  const size_t leaf = static_cast<size_t>(q.n_nodes) + static_cast<size_t>(-L.cur - 2);
  const float4* r = q.rows + leaf * kRow4;
  const int* fid = q.codes + leaf * kRow + kFaceOff;
#pragma unroll
  for (int g = 0; g < kLeafCap / 4; ++g) {
    // triangles 4g..4g+3: the 36 floats from row float 36g
    float tv[36];
#pragma unroll
    for (int w = 0; w < 9; ++w) {
      const float4 f = __ldg(r + 9 * g + w);
      tv[4 * w] = f.x;
      tv[4 * w + 1] = f.y;
      tv[4 * w + 2] = f.z;
      tv[4 * w + 3] = f.w;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* gv = tv + 9 * k;
      const V3 v0 = {gv[0], gv[1], gv[2]};
      const V3 e1 = sub3({gv[3], gv[4], gv[5]}, v0);
      const V3 e2 = sub3({gv[6], gv[7], gv[8]}, v0);
      const V3 pvec = cross3(L.d, e2);
      const float det = dot3(e1, pvec);
      const float inv_det = det != 0.0f ? 1.0f / det : 0.0f;
      const V3 tvec = sub3(L.o, v0);
      const float u = dot3(tvec, pvec) * inv_det;
      const V3 qvec = cross3(tvec, e1);
      const float v = dot3(L.d, qvec) * inv_det;
      const float t = dot3(e2, qvec) * inv_det;
      const bool hit = (fabsf(det) > 1e-10f) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
                       (t > 0.0f) && (t < L.t);
      if (hit) {
        const int f = __ldg(fid + 4 * g + k);
        if (f >= 0) {
          L.t = t;
          L.face = f;
          L.u = u;
          L.v = v;
        }
      }
    }
  }
  if (q.any_hit && L.face >= 0) {
    L.cur = kDone;
  } else {
    L.cur = L.sp > 0 ? stack[--L.sp] : kDone;
  }
}

// Every counter of `work` is 0 when a launch starts, and the launch's last
// warp leaves it so.
__global__ void __launch_bounds__(kThreads, kMinBlocks) bvh8_traverse_kernel(const Query q) {
  const int lane = threadIdx.x & 31;
  Lane L;
  L.ray = -1;
  L.cur = kDone;
  int stack[kMaxStack];
  long long pool = 0, pool_end = 0;

  // -------------------------------- traversal loop --------------------------------
  while (true) {
    retire_and_refill(L, pool, pool_end, q, lane);
    if (__ballot_sync(kFull, L.ray >= 0) == 0) break;
    if (L.cur >= 0) node_step(L, stack, q);
    // a lane on a leaf row waits until kLeafBatch lanes are, or until no
    // lane is on a node row
    const int on_leaf = __popc(__ballot_sync(kFull, L.cur <= -2));
    if (on_leaf >= kLeafBatch || (on_leaf > 0 && __ballot_sync(kFull, L.cur >= 0) == 0)) {
      if (L.cur <= -2) leaf_step(L, stack, q);
    }
  }
  // ----------------------------- end of traversal loop -----------------------------

  // the last warp to finish leaves the counters at 0 for the next launch
  __threadfence();
  if (lane == 0) {
    const unsigned long long warps = static_cast<unsigned long long>(gridDim.x) * (kThreads / 32);
    if (atomicAdd(q.work + 1, 1ull) == warps - 1) {
      atomicExch(q.work, 0ull);
      atomicExch(q.work + 1, 0ull);
    }
  }
}

// blocks of the kernel resident on the whole card, per device (0: not yet
// asked); fixed for a device, so asked once
constexpr int kMaxDevices = 64;
long long g_resident[kMaxDevices] = {};

}  // namespace

extern "C" {

// `work`: two zeroed 64-bit counters, left zeroed again by every launch;
// one pair per stream.  Returns the CUDA error of the launch (0 on success).
int m3t_bvh8_traverse(const float* unified, int n_nodes, const float* o,
                      const float* d, const float* maxt, const uint8_t* active,
                      int n, int any_hit, int stack_cap, float* t_out,
                      int* face_out, float* u_out, float* v_out, void* work,
                      void* stream) {
  if (n <= 0) return 0;
  if (stack_cap < 1 || stack_cap > kMaxStack) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bvh8_traverse_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_resident[dev] = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  }
  const long long needed = (static_cast<long long>(n) + kThreads - 1) / kThreads;
  const long long resident = g_resident[dev];
  const dim3 grid(static_cast<unsigned>(needed < resident ? needed : resident));
  const Query q = {reinterpret_cast<const float4*>(unified), reinterpret_cast<const int*>(unified),
                   n_nodes, o, d, maxt, active, n, any_hit, stack_cap, t_out, face_out, u_out,
                   v_out, static_cast<unsigned long long*>(work)};
  bvh8_traverse_kernel<<<grid, dim3(kThreads), 0, static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

int m3t_bvh8_max_stack() { return kMaxStack; }

}  // extern "C"
