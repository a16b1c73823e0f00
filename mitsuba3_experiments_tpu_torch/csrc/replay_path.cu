// K5: the path replay of a PathRecord chunk, forward and adjoint.
//
// Replaces the XLA program of the JAX package's replay: the lax.scan over
// depth of `replay_radiance` (mitsuba3_experiments_tpu/integrators/
// replay.py:792, its body `bounce` at :827), differentiated by jax.grad in
// `_replay_grad_jit` (:952).  The port ran that scan as a Python loop of
// eager torch operators with autograd through them: ~85k operators for one
// 131,072-row chunk at depth 8, with the card busy a fifth of the time.
// Here the loop is two launches:
//
//   replay_forward_kernel   one thread per record row walks the row's path
//                           to its own end and writes L (N, 3);
//   replay_adjoint_kernel   one thread per row takes dL (N, 3), walks the
//                           path again storing each vertex's added radiance
//                           and weight (`scratch`, (D, 6, N)), forms the
//                           suffix sums backwards, walks it a third time and
//                           adds its derivatives into d base_color (M, 3)
//                           and d radiance (E, 3).
//
// The arithmetic is csrc/replay_path.h, which the CPU tests also build with
// g++; this file holds only the kernels and their C interface.
//
// What bounds it on this card: the record is rows x D x 13 bytes, read once
// by each kernel (13.6 MB a depth-8 chunk of 131,072 rows), and the shading
// is ~560 float32 operations a shaded vertex in the forward and ~1,200 in
// the adjoint, so the least time of a depth-8 chunk is its operations at
// the float32 rate and of a depth-65 chunk its bytes; both are far below
// what a chunk cost in launches from the host as a loop of torch operators.
// The kernel is bound by its own latency: each thread runs a long serial
// chain of dependent loads (the face row, the material row, the emitter
// row, texture texels) and transcendental functions, in divergent warps
// (the ten BSDF kinds, paths that end at different depths).  The
// design does not chase that yet: one thread per row, 128 threads per
// block, and the sorted replay's chunks of rows with similar path lengths
// keep warps together at depth 65.  The adjoint's tables are tiny (20 x 3
// and 2 x 3 floats on the stand-in), so each block sums them in shared
// memory and adds each nonzero entry to device memory once; a table too
// large for shared memory takes global atomics in the same kernel.
//
// Built with --fmad=false: no contraction into fused multiply-adds, so the
// float operations round as the plain torch version's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "replay_path.h"

namespace {

constexpr int kThreads = 128;
// the most dynamic shared memory a block may use on sm_90 (227 KB)
constexpr int kMaxShared = 232448;

struct DeviceAcc {
  float* bc_tab;
  float* rad_tab;
  __host__ __device__ void bc(int32_t row, int c, float v) {
#if defined(__CUDA_ARCH__)
    if (v != 0.0f) atomicAdd(bc_tab + 3 * row + c, v);
#endif
  }
  __host__ __device__ void rad(int32_t row, int c, float v) {
#if defined(__CUDA_ARCH__)
    if (v != 0.0f) atomicAdd(rad_tab + 3 * row + c, v);
#endif
  }
};

__global__ void __launch_bounds__(kThreads) replay_forward_kernel(rp::ReplayArgs a) {
  int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n_rows) return;
  rp::V3 L = rp::replay_row(a, r);
  a.L[3 * r] = L.x;
  a.L[3 * r + 1] = L.y;
  a.L[3 * r + 2] = L.z;
}

__global__ void __launch_bounds__(kThreads) replay_adjoint_kernel(rp::ReplayArgs a) {
  extern __shared__ float tables[];
  const int n_tab = 3 * (a.n_mats + a.n_emitters);
  DeviceAcc acc;
  if (a.shared_tables) {
    for (int i = threadIdx.x; i < n_tab; i += blockDim.x) tables[i] = 0.0f;
    __syncthreads();
    acc.bc_tab = tables;
    acc.rad_tab = tables + 3 * a.n_mats;
  } else {
    acc.bc_tab = a.d_base_color;
    acc.rad_tab = a.d_radiance;
  }
  int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r < a.n_rows) {
    rp::V3 g = rp::v3(a.dL[3 * r], a.dL[3 * r + 1], a.dL[3 * r + 2]);
    if (g.x != 0.0f || g.y != 0.0f || g.z != 0.0f) rp::replay_row_adjoint(a, r, g, acc);
  }
  if (a.shared_tables) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_tab; i += blockDim.x) {
      float v = tables[i];
      if (v != 0.0f) {
        float* dst = i < 3 * a.n_mats ? a.d_base_color + i : a.d_radiance + (i - 3 * a.n_mats);
        atomicAdd(dst, v);
      }
    }
  }
}

int grid_of(int64_t n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

int m3t_replay_args_size() { return (int)sizeof(rp::ReplayArgs); }

int m3t_replay_max_shared() { return kMaxShared; }

int m3t_replay_forward(const rp::ReplayArgs* args, void* stream) {
  if (args->n_rows == 0) return 0;
  replay_forward_kernel<<<grid_of(args->n_rows), kThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

// d_base_color and d_radiance are added to (the caller zeroes them)
int m3t_replay_adjoint(const rp::ReplayArgs* args, void* stream) {
  if (args->n_rows == 0) return 0;
  int smem = 0;
  if (args->shared_tables) {
    smem = 3 * (args->n_mats + args->n_emitters) * (int)sizeof(float);
    if (smem > kMaxShared) return (int)cudaErrorInvalidValue;
    cudaError_t rc = cudaFuncSetAttribute(
        replay_adjoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  replay_adjoint_kernel<<<grid_of(args->n_rows), kThreads, smem, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

}  // extern "C"
