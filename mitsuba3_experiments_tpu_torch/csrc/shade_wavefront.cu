// K6: the shading of one bounce of the record's and the forward's
// wavefront (persistent.trace_rays), one launch a bounce.
//
// It replaces no Pallas kernel.  In the JAX package this shading is
// `persistent._shade` inside `_engine_step`
// (mitsuba3_experiments_tpu/integrators/persistent.py), which XLA fuses
// into the engine's compiled step.  The port ran it as eager torch
// operators: emission, NEE, ten BSDF kinds and roulette as hundreds of
// full-width kernels a bounce, each reading and writing (n, 3) float32
// temporaries for up to 2,097,152 lanes, launched one by one from the host,
// with six copies from the host a bounce.  Here it is one thread a lane:
//
//   shade_wavefront_kernel   reads the lane's state (13 arrays, 85 bytes),
//                            its face row, its material, texture and
//                            emitter rows, shades it as _shade does and
//                            writes _shade's 14 fields (111 bytes).
//
// The arithmetic is csrc/shade_lane.h over K5's device functions
// (csrc/replay_path.h), which the CPU tests also build with g++; this file
// holds only the kernel and its C interface.
//
// What bounds it on this card: the lane state, 196 bytes a lane in and out,
// and the face rows of the faces hit (29 floats each); a shaded lane's few
// hundred float32 operations (its kind's BSDF sample and, where NEE is
// active, its evaluation) weigh less.  On the main path's first bounce
// (2,097,152 lanes) that is 0.12 ms by bytes against 0.014 ms by
// operations; the kernel takes ~0.3 ms of device time on an H100 SXM
// (700 W): each thread's serial chain of dependent loads (the face row,
// then the material, texture and emitter rows) and transcendental
// functions, in warps that diverge over the ten BSDF kinds.  What the
// design does: the lane state is read and written as the structure of
// arrays trace_rays already holds (neighbouring threads on neighbouring
// addresses), the inputs through the read-only path; the table rows are
// read by K5's device functions with plain loads, which L1 caches (the
// tables are small and every lane reads them), so that K5 compiles them
// unchanged; 128 threads a block, as K5's forward, and no spill.
//
// Built with --fmad=false: no contraction into fused multiply-adds, so the
// float operations round as the plain torch version's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "shade_lane.h"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) shade_wavefront_kernel(rp::ShadeArgs s) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < s.n) rp::shade_row(s, i);
}

}  // namespace

extern "C" {

int m3t_shade_args_size() { return (int)sizeof(rp::ShadeArgs); }

int m3t_shade_wavefront(const rp::ShadeArgs* args, void* stream) {
  if (args->n == 0) return 0;
  int blocks = (int)((args->n + kThreads - 1) / kThreads);
  shade_wavefront_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

}  // extern "C"
