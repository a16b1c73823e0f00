"""mitsuba3_experiments_tpu_torch — the PyTorch + CUDA port of the path tracer.

The forward path-MIS render and the neural-radiosity training and render of
``mitsuba3_experiments_tpu`` rebuilt on PyTorch tensors, with the ray
queries, the field's MLP and the scans served by hand-written CUDA kernels
on the GPU.  Module names follow the JAX package, so each counterpart is
easy to find:

  core/        math, warps, counter-based RNG, records, distributions, SH
  scene/       dict scene compiler, shapes, numpy SAH + 8-wide BVH build
  intersect/   8-wide BVH traversal: plain torch lockstep + CUDA kernel
  render/      sensor, film, BSDFs, emitters, textures
  integrators/ path tracer (NEE + MIS + Russian roulette), render driver,
               integrator registry
  ops/         reductions, scans (plain + CUDA kernel), compaction, dispatch
  models/      MLP, hash-grid encoding, fused MLP (CUDA kernel), neural
               radiosity
  csrc/        CUDA C++ kernel sources, built at first use (cuda_build.py)

Scene and wavefront tensors are float32 or int32 (int64 only inside the
uint32 emulation of the RNG and the hash grid; bf16 only as the MLP's
rounding) and live on the device of the scene they belong to.
"""

__version__ = "0.1.0"
