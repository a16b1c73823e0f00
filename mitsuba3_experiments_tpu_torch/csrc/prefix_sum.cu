// Single-pass inclusive prefix sum (scan) of a 1-D float32 or int32 array.
//
// Replaces the TPU kernel prefix_sum_pallas
// (mitsuba3_experiments_tpu/ops/prefix_sum.py:26).  That kernel walks
// 2048-element blocks in grid order and carries the running total in SMEM
// from one block to the next.  CUDA blocks run in parallel and in no order,
// so the carry becomes a decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016), in
// one launch:
//
//   1. a block takes its tile from an atomic ticket, not from blockIdx, so
//      every tile before it belongs to a block that is already running and
//      the look-back below cannot deadlock;
//   2. each of the block's 16 warps loads 1024 consecutive elements, eight
//      coalesced 16-byte loads a lane, and scans them in registers and with
//      shuffles; the 16 warp totals are scanned by one warp (the tile of
//      16384 measured fastest of 4096, 8192 and 16384 on the H100);
//   3. the block publishes its tile's aggregate, one 64-bit status word
//      (flag and value together) stored with release semantics;
//   4. warp 0 reads the status words of the 32 tiles before it (acquire),
//      waits until all are published, and adds their values back to the
//      nearest one that holds an inclusive prefix, 32 tiles at a time;
//   5. the block publishes its inclusive prefix and writes its tile.
//
// Each element is read once and written once, so the kernel is bound by
// device memory at 2 n 4 bytes.  Nothing is zeroed between calls: a status
// word carries the call's epoch beside its flag, so a word left by an
// earlier call reads as "not yet published", and the ticket counter only
// grows; the caller passes the count it held before this call (the wrapper,
// ops/prefix_sum_cuda.py, keeps both per device and stream).
//
// int32 runs in uint32, so adds wrap as torch.cumsum(dtype=int32) does and
// the result is exact whatever the order of the adds.  float32 adds the
// aggregates of the tiles before it in an order that depends on which of
// them had published an inclusive prefix when the look-back read them, so
// the last bits of a float32 result may differ from run to run.
//
// Built with nvcc into a shared library with a plain C interface
// (ops/prefix_sum_cuda.py loads it with ctypes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 8;                       // 16-byte loads per lane
constexpr int kWarpItems = 32 * 4 * kVecs;     // 1024
constexpr int kTile = kWarps * kWarpItems;     // 16384
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<uint32_t> { using type = uint4; };

__device__ __forceinline__ uint32_t to_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t to_bits(uint32_t v) { return v; }
template <typename T> __device__ __forceinline__ T from_bits(uint32_t b);
template <> __device__ __forceinline__ float from_bits<float>(uint32_t b) { return __uint_as_float(b); }
template <> __device__ __forceinline__ uint32_t from_bits<uint32_t>(uint32_t b) { return b; }

// status word: high 32 bits (epoch << 1) | inclusive, low 32 bits the value
__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long status_word(unsigned epoch, bool inclusive,
                                                          uint32_t bits) {
  return (static_cast<unsigned long long>((epoch << 1) | (inclusive ? 1u : 0u)) << 32) | bits;
}

template <typename T>
__device__ __forceinline__ T warp_inclusive(T v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T up = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += up;
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Warp 0: the sum of every tile before `tile`, read back from their status
// words until one holds an inclusive prefix.
template <typename T>
__device__ T look_back(const unsigned long long* status, long long tile, unsigned epoch, int lane) {
  T prefix = T(0);
  for (long long last = tile - 1;; last -= 32) {
    const long long idx = last - lane;
    unsigned long long w = 0;
    bool ready;
    do {
      if (idx >= 0) w = ld_acquire(status + idx);
      ready = idx < 0 || static_cast<unsigned>(w >> 33) == epoch;
    } while (!__all_sync(kFull, ready));
    const bool inclusive = idx < 0 || ((w >> 32) & 1u);
    const unsigned incl = __ballot_sync(kFull, inclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;   // nearest inclusive tile
    T v = (idx >= 0 && lane <= stop) ? from_bits<T>(static_cast<uint32_t>(w)) : T(0);
    prefix += warp_sum<T>(v);
    if (incl) return prefix;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ x, T* __restrict__ out, unsigned long long* status,
            unsigned long long* ticket, unsigned long long ticket_base, unsigned epoch,
            long long n, bool vec) {
  using V = typename Vec4<T>::type;
  __shared__ long long s_tile;
  __shared__ T s_warp[kWarps];
  __shared__ T s_prefix;
  if (threadIdx.x == 0) s_tile = static_cast<long long>(atomicAdd(ticket, 1ull) - ticket_base);
  __syncthreads();
  const long long tile = s_tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long wbase = tile * kTile + static_cast<long long>(warp) * kWarpItems;

  // lane holds chunks r*32 + lane of the warp's 256 four-element chunks
  T v[kVecs][4];
  if (vec && wbase + kWarpItems <= n) {
    const V* src = reinterpret_cast<const V*>(x + wbase);
#pragma unroll
    for (int r = 0; r < kVecs; ++r) {
      const V a = __ldg(src + r * 32 + lane);
      v[r][0] = a.x; v[r][1] = a.y; v[r][2] = a.z; v[r][3] = a.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kVecs; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long e = wbase + 4 * (r * 32 + lane) + j;
        v[r][j] = e < n ? x[e] : T(0);
      }
    }
  }

  // exclusive prefix of each chunk within the warp, row by row
  T excl[kVecs];
  T carry = T(0);
#pragma unroll
  for (int r = 0; r < kVecs; ++r) {
    const T s = (v[r][0] + v[r][1]) + (v[r][2] + v[r][3]);
    const T inc = warp_inclusive<T>(s, lane);
    const T up = __shfl_up_sync(kFull, inc, 1);
    excl[r] = carry + (lane > 0 ? up : T(0));
    carry += __shfl_sync(kFull, inc, 31);
  }
  if (lane == 0) s_warp[warp] = carry;
  __syncthreads();

  if (warp == 0) {
    const T wt = lane < kWarps ? s_warp[lane] : T(0);
    const T winc = warp_inclusive<T>(wt, lane);
    const T wup = __shfl_up_sync(kFull, winc, 1);
    const T aggregate = __shfl_sync(kFull, winc, kWarps - 1);
    // the first tile's aggregate is its inclusive prefix
    if (lane == 0) st_release(status + tile, status_word(epoch, tile == 0, to_bits(aggregate)));
    T prefix = T(0);
    if (tile > 0) {
      prefix = look_back<T>(status, tile, epoch, lane);
      if (lane == 0) st_release(status + tile, status_word(epoch, true, to_bits(prefix + aggregate)));
    }
    __syncwarp();
    if (lane < kWarps) s_warp[lane] = lane > 0 ? wup : T(0);   // exclusive over the warps
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  const T pre = s_prefix + s_warp[warp];

#pragma unroll
  for (int r = 0; r < kVecs; ++r) {
    T run = pre + excl[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      run += v[r][j];
      v[r][j] = run;
    }
  }
  if (vec && wbase + kWarpItems <= n) {
    V* dst = reinterpret_cast<V*>(out + wbase);
#pragma unroll
    for (int r = 0; r < kVecs; ++r) dst[r * 32 + lane] = V{v[r][0], v[r][1], v[r][2], v[r][3]};
  } else {
#pragma unroll
    for (int r = 0; r < kVecs; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long e = wbase + 4 * (r * 32 + lane) + j;
        if (e < n) out[e] = v[r][j];
      }
    }
  }
}

template <typename T>
int launch(const void* x, void* out, unsigned long long* status, unsigned long long* ticket,
           unsigned long long ticket_base, unsigned epoch, long long n, cudaStream_t stream) {
  const long long n_tiles = (n + kTile - 1) / kTile;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  scan_kernel<T><<<static_cast<unsigned>(n_tiles), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), status, ticket, ticket_base, epoch, n, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int m3t_prefix_sum_tile() { return kTile; }

// x, out: n elements; status: ceil(n / tile) status words; ticket: the
// stream's ticket counter, which holds ticket_base when this call starts;
// epoch: 1 .. 2^31 - 1, not used by the status words' last writer.
// dtype 0 = float32, 1 = int32.  Returns a cudaError_t code (0 = launched),
// or -1 for arguments the kernel does not take.
extern "C" int m3t_prefix_sum(const void* x, void* out, void* status, void* ticket,
                              unsigned long long ticket_base, unsigned epoch, long long n,
                              int dtype, void* stream) {
  if (n <= 0 || (n + kTile - 1) / kTile > 0x7fffffffLL) return -1;
  if (epoch == 0 || epoch >= 0x80000000u) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* st = static_cast<unsigned long long*>(status);
  auto* tk = static_cast<unsigned long long*>(ticket);
  if (dtype == 0) return launch<float>(x, out, st, tk, ticket_base, epoch, n, s);
  if (dtype == 1) return launch<uint32_t>(x, out, st, tk, ticket_base, epoch, n, s);
  return -1;
}
