"""mitsuba3_experiments_tpu_torch — the PyTorch + CUDA port of the path tracer.

The forward path-MIS render of ``mitsuba3_experiments_tpu`` rebuilt on
PyTorch tensors, with the ray queries served by a hand-written CUDA kernel on
the GPU.  Module names follow the JAX package, so each counterpart is easy to
find:

  core/        math, warps, counter-based RNG, records, distributions
  scene/       dict scene compiler, shapes, numpy SAH + 8-wide BVH build
  intersect/   8-wide BVH traversal: plain torch lockstep + CUDA kernel
  render/      sensor, film, BSDFs, emitters, textures
  integrators/ path tracer (NEE + MIS + Russian roulette) and render driver
  csrc/        CUDA C++ kernel sources, built at first use

Every tensor is float32 or int32 (int64 only inside the RNG's uint32
emulation) and lives on the device of the scene it belongs to.
"""

__version__ = "0.1.0"
