// Dependent row-gather chain: the access pattern that floors BVH traversal.
//
// Replaces the TPU kernel pallas_dep (scripts/pallas_gather_probe.py:79),
// which keeps each lane's index in SMEM and fetches one table row per lane
// and step with a DMA and a semaphore.  Per chain (a "lane" of the probe),
//
//     for t in 0 .. iters:  row = table[idx];  acc += row[1];  idx = int(row[0])
//
// returning the final idx and acc (the accumulator of the probe's XLA chain,
// xla_dep, added in the same order as the plain loop).  Each step loads the
// WHOLE 352-byte row (88 float32), as a traversal step loads a BVH8 row.
// The xor of every word fetched goes to a third output, `fold`, which the
// wrapper discards: it keeps the loads of columns 2..87 live through ptxas,
// which may drop loads whose values nothing reads.  A chain whose index
// leaves [0, rows) stops reading and returns idx -1.
//
// What bounds it on an H100 (3.35 TB/s): the bytes of the distinct rows
// the chains reach (each read once), and the latency of the chain (each
// step waits for the row before).  The one-thread-per-chain form before
// this one issued 22 16-byte loads per step, each warp instruction touching
// 32 rows in 32 different lines, and ran at about one line access per SM
// and clock: L1's rate of distinct-line accesses, not device memory, set
// its time.  So here a row is one coalesced warp access:
//
//   * a group of G threads shares a chain and fetches its row together,
//     each thread 88 / 4 / G 16-byte pieces (G = 22: one piece, one group
//     per warp; G = 11: two pieces, two groups per warp), so one load
//     instruction covers 11 sectors in 3-4 lines of one row;
//   * the group's first thread holds words 0..3; it broadcasts the next
//     index and row[1] to the group by __shfl_sync, and every thread of the
//     group adds row[1] to its copy of acc, in the plain loop's order;
//   * each group interleaves C chains (all C rows' loads issued, then all
//     C chains advanced), so a warp keeps C rows in flight per group.
//
// `block` is the number of chains a block takes (grid = ceil(n / block)):
// a block of min(ceil(block / chains per warp), 8) warps walks them in
// batches of (32 / G) * C chains per warp.  block = 1 gives one chain per
// block on one warp.  Of G in {11, 22} and C in {1, 2, 4, 8}, G = 11 and
// C = 4 (kGroup, kChains) were the fastest on an H100 (PERF.md): 2.4x
// the one-thread-per-chain form at 1,843,200 chains x 64 steps, 1.9x at
// 65,536.
//
// Built with nvcc into a shared library with a plain C interface
// (ops/gather_probe_cuda.py loads it with ctypes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowFloats = 88;
constexpr int kRowVec4 = kRowFloats / 4;   // 22 pieces of 16 bytes
constexpr int kGroup = 11;                 // threads per chain
constexpr int kChains = 4;                 // chains per group, interleaved
constexpr int kGroupsPerWarp = 32 / kGroup;
constexpr int kPieces = (kRowVec4 + kGroup - 1) / kGroup;   // 16-byte loads per thread and row
constexpr int kChainsPerWarp = kGroupsPerWarp * kChains;
constexpr int kMaxWarps = 8;
static_assert(kGroup >= 1 && kGroup <= 32 && kChains >= 1, "group and chains");

__device__ __forceinline__ float4 ld_nc_v4(const float4* p) {
  float4 r;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
               : "l"(p));
  return r;
}

__global__ void __launch_bounds__(32 * kMaxWarps)
gather_chain_kernel(const float4* __restrict__ table, long long rows,
                    const int* __restrict__ idx0, int n, int iters, int block,
                    int* __restrict__ out_idx, float* __restrict__ out_acc,
                    unsigned* __restrict__ fold) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / kGroup, rank = lane - grp * kGroup;
  const bool in_group = grp < kGroupsPerWarp;
  const int leader = in_group ? grp * kGroup : lane;   // holds words 0..3 of the row
  const int nwarps = blockDim.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * block;
  const int in_block = static_cast<int>(n - base < block ? n - base : block);

  for (int b0 = warp * kChainsPerWarp; b0 < in_block; b0 += nwarps * kChainsPerWarp) {
    int idx[kChains];
    float acc[kChains];
    bool live[kChains];
    unsigned bits = 0u;
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      const int i = b0 + grp * kChains + c;
      live[c] = in_group && i < in_block;
      idx[c] = live[c] ? idx0[base + i] : 0;
      acc[c] = 0.0f;
    }
    // every lane of the warp runs every step, so the shuffles see all 32
    for (int t = 0; t < iters; ++t) {
      float4 r[kChains][kPieces];
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        if (live[c] && (idx[c] < 0 || idx[c] >= rows)) {
          idx[c] = -1;
          live[c] = false;
        }
        const float4* row = table + static_cast<long long>(idx[c]) * kRowVec4;
#pragma unroll
        for (int k = 0; k < kPieces; ++k) {
          const int piece = rank + k * kGroup;
          r[c][k] = live[c] && piece < kRowVec4 ? ld_nc_v4(row + piece)
                                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
#pragma unroll
        for (int k = 0; k < kPieces; ++k)
          bits ^= __float_as_uint(r[c][k].x) ^ __float_as_uint(r[c][k].y) ^
                  __float_as_uint(r[c][k].z) ^ __float_as_uint(r[c][k].w);
        const float next = __shfl_sync(0xffffffffu, r[c][0].x, leader);
        const float add = __shfl_sync(0xffffffffu, r[c][0].y, leader);
        if (live[c]) {
          acc[c] += add;
          idx[c] = static_cast<int>(next);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      const int i = b0 + grp * kChains + c;
      if (in_group && rank == 0 && i < in_block) {
        out_idx[base + i] = idx[c];
        out_acc[base + i] = acc[c];
      }
    }
    // the warp's xor of every word it fetched, on its batch's first chain
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) bits ^= __shfl_xor_sync(0xffffffffu, bits, d);
    if (lane == 0) fold[base + b0] = bits;
  }
}

}  // namespace

extern "C" int m3t_gather_chain_row_floats() { return kRowFloats; }

// table: rows x 88 float32, 16-byte aligned; idx0, out_idx: n int32;
// out_acc: n float32; fold: n uint32 of scratch.  block: chains per block.
// Returns a cudaError_t code (0 = launched), or -1 for arguments the
// kernel does not take.
extern "C" int m3t_gather_chain(const void* table, long long rows, const void* idx0, int n,
                                int iters, int block, void* out_idx, void* out_acc, void* fold,
                                void* stream) {
  if (rows <= 0 || n <= 0 || iters < 0 || block < 1 || block > 1024) return -1;
  const int grid = (n + block - 1) / block;
  const int want = (block + kChainsPerWarp - 1) / kChainsPerWarp;
  const int warps = want < kMaxWarps ? want : kMaxWarps;
  gather_chain_kernel<<<grid, 32 * warps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), rows, static_cast<const int*>(idx0), n, iters, block,
      static_cast<int*>(out_idx), static_cast<float*>(out_acc), static_cast<unsigned*>(fold));
  return static_cast<int>(cudaGetLastError());
}
