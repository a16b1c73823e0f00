"""mitsuba3_experiments_tpu_torch — the PyTorch + CUDA port of the path tracer.

The path-MIS render and its gradients, neural radiosity, neural radiance
caching and the integrator zoo of ``mitsuba3_experiments_tpu`` rebuilt on PyTorch
tensors, with the ray queries, the field's MLP and the scans served by
hand-written CUDA kernels on the GPU.  Module names follow the JAX package, so each counterpart is
easy to find:

  core/        math, warps, counter-based RNG, records and their whole-record
               operations (struct), distributions, SH, spectra
  scene/       dict scene compiler, shapes, OBJ/XML I/O, the C++ host
               library's SAH/SBVH builds (native.py) + 8-wide BVH tables
  intersect/   8-wide BVH traversal: plain torch lockstep + CUDA kernel
  render/      sensor, film, BSDFs, emitters, textures
  integrators/ path tracer (NEE + MIS + Russian roulette; forward and
               differentiable), production wavefront, record+replay
               gradients, neural radiance caching, the zoo (simple,
               particle tracer, spectral, BDPT, SPPM, ReSTIR GI), render
               driver, integrator registry
  utils/       image I/O
  ops/         reductions, scans (plain + CUDA kernel), compaction, dispatch,
               hash grid
  models/      MLP, hash-grid encoding, fused MLP (CUDA kernel), neural
               radiosity
  csrc/        CUDA C++ kernel sources, built at first use (cuda_build.py)

Scene and wavefront tensors are float32 or int32 (int64 only inside the
uint32 emulation of the RNG and the hash grid; bf16 only as the MLP's
rounding) and live on the device of the scene they belong to.
"""

__version__ = "0.1.0"

import torch


def default_device() -> torch.device:
    """The device every entry point uses when its caller names none: the
    card.  A CPU run is asked for with ``device="cpu"``; nothing falls back
    to the CPU when there is no card."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device, ``default_device()`` for None."""
    return default_device() if device is None else torch.device(device)
