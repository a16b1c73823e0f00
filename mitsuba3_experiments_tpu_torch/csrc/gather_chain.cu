// Dependent row-gather chain: the access pattern that floors BVH traversal.
//
// Replaces the TPU kernel pallas_dep (scripts/pallas_gather_probe.py:79),
// which keeps each lane's index in SMEM and fetches one table row per lane
// and step with a DMA and a semaphore.  On Hopper there is nothing to
// carry over from that: one thread walks one lane's chain with its index in
// a register,
//
//     for t in 0 .. iters:  row = table[idx];  acc += row[1];  idx = int(row[0])
//
// and returns the final idx and acc (the accumulator of the probe's XLA
// chain, xla_dep, added in the same order as the plain loop).  Each step
// loads the WHOLE 352-byte row (88 float32), as a traversal step loads a
// BVH8 row, with 22 16-byte ld.global.nc.v4.f32 in inline PTX.  The xor of
// every word fetched goes to a third output, `fold`, which the wrapper
// discards: it keeps the loads of columns 2..87 live through ptxas, which
// may drop loads whose values nothing reads.
//
// What bounds it on an H100 (3.35 TB/s):
//   * bytes: n * iters * 352 B over the memory rate, 0.44 ms at 65,536
//     lanes x 64 steps; the table (151.8 MB at 431,104 rows) is three times
//     the 50 MB L2, so most rows come from device memory;
//   * latency: each step waits for the previous step's row, so a lane takes
//     iters device-memory round trips however few lanes there are.  The
//     kernel hides it only by the number of lanes in flight (a block of
//     `block` threads; the grid covers n lanes).
// A lane whose index leaves [0, rows) stops reading and returns idx -1.
//
// Built with nvcc into a shared library with a plain C interface
// (ops/gather_probe_cuda.py loads it with ctypes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowFloats = 88;
constexpr int kRowVec4 = kRowFloats / 4;   // 22 loads of 16 bytes

__device__ __forceinline__ float4 ld_nc_v4(const float4* p) {
  float4 r;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
               : "l"(p));
  return r;
}

__global__ void gather_chain_kernel(const float4* __restrict__ table, long long rows,
                                    const int* __restrict__ idx0, int n, int iters,
                                    int* __restrict__ out_idx, float* __restrict__ out_acc,
                                    unsigned* __restrict__ fold) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  int idx = idx0[lane];
  float acc = 0.0f;
  unsigned bits = 0u;
  for (int t = 0; t < iters; ++t) {
    if (idx < 0 || idx >= rows) {
      idx = -1;
      break;
    }
    const float4* row = table + static_cast<long long>(idx) * kRowVec4;
    float4 r[kRowVec4];
#pragma unroll
    for (int k = 0; k < kRowVec4; ++k) r[k] = ld_nc_v4(row + k);
#pragma unroll
    for (int k = 0; k < kRowVec4; ++k)
      bits ^= __float_as_uint(r[k].x) ^ __float_as_uint(r[k].y) ^ __float_as_uint(r[k].z) ^
              __float_as_uint(r[k].w);
    acc += r[0].y;
    idx = static_cast<int>(r[0].x);
  }
  out_idx[lane] = idx;
  out_acc[lane] = acc;
  fold[lane] = bits;
}

}  // namespace

extern "C" int m3t_gather_chain_row_floats() { return kRowFloats; }

// table: rows x 88 float32, 16-byte aligned; idx0, out_idx: n int32;
// out_acc: n float32; fold: n uint32 of scratch.  Returns a cudaError_t
// code (0 = launched), or -1 for arguments the kernel does not take.
extern "C" int m3t_gather_chain(const void* table, long long rows, const void* idx0, int n,
                                int iters, int block, void* out_idx, void* out_acc, void* fold,
                                void* stream) {
  if (rows <= 0 || n <= 0 || iters < 0 || block < 1 || block > 1024) return -1;
  const int grid = (n + block - 1) / block;
  gather_chain_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), rows, static_cast<const int*>(idx0), n, iters,
      static_cast<int*>(out_idx), static_cast<float*>(out_acc), static_cast<unsigned*>(fold));
  return static_cast<int>(cudaGetLastError());
}
