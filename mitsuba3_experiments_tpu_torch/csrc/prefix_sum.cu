// Blocked inclusive prefix sum (scan) of a 1-D float32 or int32 array.
//
// Replaces the TPU kernel prefix_sum_pallas
// (mitsuba3_experiments_tpu/ops/prefix_sum.py:26).  That kernel walks
// 2048-element blocks in grid order and carries the running total in SMEM
// from one block to the next.  CUDA blocks run in parallel and in no
// order, so nothing can be carried between them; this is reduce-then-scan:
//
//   1. tile_totals: one block per 2048-element tile writes the tile's sum;
//   2. scan_totals: one block turns the totals into exclusive offsets, in
//      place (each thread owns a contiguous run of tiles);
//   3. tile_scan:   one block per tile scans its tile and adds its offset.
//
// Each block holds 256 threads of 8 consecutive elements (two 16-byte
// loads when the arrays are 16-byte aligned and the thread's 8 are all in
// range): a sequential scan in registers, a warp scan of the thread totals
// with shuffles, and a scan of the 8 warp totals in shared memory.  The
// kernel is bound by device memory: the input is read twice and the output
// written once.
// int32 runs in uint32, so adds wrap as torch.cumsum(dtype=int32) does and
// the result is exact whatever the order of the adds.
//
// Built with nvcc into a shared library with a plain C interface
// (ops/prefix_sum_cuda.py loads it with ctypes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;   // 2048, the TPU kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kTotalsThreads = 1024;

// Inclusive scan of `v` over the block's threads (blockDim.x threads, a
// multiple of 32, at most 1024); returns the exclusive prefix of this
// thread and writes the block's total to *total.
template <typename T>
__device__ T block_exclusive(T v, T* warp_sums, T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  T inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T up = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += up;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < n_warps ? warp_sums[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      T up = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += up;
    }
    if (lane < n_warps) warp_sums[lane] = w;   // inclusive over warps
  }
  __syncthreads();
  const T warp_off = warp > 0 ? warp_sums[warp - 1] : T(0);
  if (total != nullptr && threadIdx.x == blockDim.x - 1) *total = warp_sums[n_warps - 1];
  return warp_off + (inc - v);
}

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<uint32_t> { using type = uint4; };

// v[0..8) = x[base .. base+8), zero past n
template <typename T>
__device__ inline void load8(const T* __restrict__ x, long long base, long long n, bool vec,
                             T (&v)[kItems]) {
  if (vec && base + kItems <= n) {
    using V = typename Vec4<T>::type;
    const V a = reinterpret_cast<const V*>(x + base)[0];
    const V b = reinterpret_cast<const V*>(x + base)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) v[i] = base + i < n ? x[base + i] : T(0);
}

template <typename T>
__global__ void tile_totals(const T* __restrict__ x, T* __restrict__ totals, long long n,
                            bool vec) {
  __shared__ T warp_sums[kWarps];
  const long long base = (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  T v[kItems];
  load8<T>(x, base, n, vec, v);
  T s = T(0);
#pragma unroll
  for (int i = 0; i < kItems; ++i) s += v[i];
  T tot;
  block_exclusive<T>(s, warp_sums, &tot);
  if (threadIdx.x == blockDim.x - 1) totals[blockIdx.x] = tot;
}

template <typename T>
__global__ void scan_totals(T* __restrict__ totals, long long n_tiles) {
  __shared__ T warp_sums[32];
  const long long per = (n_tiles + blockDim.x - 1) / blockDim.x;
  const long long lo = (long long)threadIdx.x * per;
  const long long hi = lo + per < n_tiles ? lo + per : n_tiles;
  T s = T(0);
  for (long long i = lo; i < hi; ++i) s += totals[i];
  T run = block_exclusive<T>(s, warp_sums, nullptr);
  for (long long i = lo; i < hi; ++i) {
    const T v = totals[i];
    totals[i] = run;
    run += v;
  }
}

template <typename T>
__global__ void tile_scan(const T* __restrict__ x, T* __restrict__ out,
                          const T* __restrict__ offsets, long long n, bool vec) {
  __shared__ T warp_sums[kWarps];
  const long long base = (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  T v[kItems];
  load8<T>(x, base, n, vec, v);
  T s = T(0);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    s += v[i];
    v[i] = s;   // inclusive within the thread
  }
  const T pre = block_exclusive<T>(s, warp_sums, nullptr) + offsets[blockIdx.x];
#pragma unroll
  for (int i = 0; i < kItems; ++i) v[i] += pre;
  if (vec && base + kItems <= n) {
    using V = typename Vec4<T>::type;
    V* o = reinterpret_cast<V*>(out + base);
    o[0] = V{v[0], v[1], v[2], v[3]};
    o[1] = V{v[4], v[5], v[6], v[7]};
    return;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (base + i < n) out[base + i] = v[i];
  }
}

template <typename T>
int launch(const void* x, void* out, void* totals, long long n, cudaStream_t stream) {
  const long long n_tiles = (n + kTile - 1) / kTile;
  const T* xp = static_cast<const T*>(x);
  T* tp = static_cast<T*>(totals);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  tile_totals<T><<<(unsigned)n_tiles, kThreads, 0, stream>>>(xp, tp, n, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_totals<T><<<1, kTotalsThreads, 0, stream>>>(tp, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_scan<T><<<(unsigned)n_tiles, kThreads, 0, stream>>>(xp, static_cast<T*>(out), tp, n, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int m3t_prefix_sum_tile() { return kTile; }

// x, out: n elements; totals: ceil(n / 2048) elements of scratch.
// dtype 0 = float32, 1 = int32.  Returns a cudaError_t code (0 = launched),
// or -1 for arguments the kernel does not take.
extern "C" int m3t_prefix_sum(const void* x, void* out, void* totals, long long n, int dtype,
                              void* stream) {
  if (n <= 0 || (n + kTile - 1) / kTile > 0x7fffffffLL) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, out, totals, n, s);
  if (dtype == 1) return launch<uint32_t>(x, out, totals, n, s);
  return -1;
}
