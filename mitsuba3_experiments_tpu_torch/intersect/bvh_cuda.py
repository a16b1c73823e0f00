"""Wrapper of the CUDA BVH8 traversal kernel (csrc/bvh_traverse.cu).

Counterpart of ``mitsuba3_experiments_tpu.intersect.bvh_pallas``.  The kernel
replaces the TPU kernel ``traverse_pallas`` and the XLA loop
``bvh_jax._traverse``: one thread walks one ray through BVH.unified, reading
rows with float4 loads, with an int stack in local memory.  It is bound by
the latency of the dependent row fetches (the table is ~150 MB at 2M
triangles, beyond the H100's 50 MB L2).  This is the simple, correct form;
making it fast is later work.

The kernel is compiled from the repository's .cu with nvcc into a shared
library with a plain C interface, loaded with ctypes, at the first CUDA call
(never at import): into build/torch_kernels/ at the repository root, rebuilt
whenever the source or the flags change.  Flags: sm_90a, -O3 and
--fmad=false — no FMA contraction, so the kernel's float operations round
exactly like the plain torch version's.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import torch

# kernel launches made (a plain int, read by tests and the smoke test)
launches = 0

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.normpath(os.path.join(_HERE, "..", "csrc", "bvh_traverse.cu"))
BUILD_DIR = os.path.normpath(os.path.join(_HERE, "..", "..", "build", "torch_kernels"))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
ROW_FLOATS = 88
MAX_STACK = 96
# face code of a ray whose traversal stack would have overflowed; the table
# is then not one that collapse_to_wide built for this layout
OVERFLOW = -2

_lib = None


def check_overflow(face, depth: int) -> None:
    """Raises if any ray of a traversal (kernel or plain) overflowed its
    stack of `depth` entries; waits for the device."""
    if bool((face == OVERFLOW).any()):
        raise RuntimeError(
            f"bvh8 traversal stack overflow (depth {depth}): the table was not "
            "built for this layout"
        )


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): nvcc is needed to build")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> str:
    """Where the build of the current source and flags lives."""
    with open(SOURCE, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"bvh_traverse_{key}.so")


def build() -> str:
    """Compile the kernel unless this source's build exists; returns the
    library path.  nvcc's output (ptxas registers, spills) goes to
    `<library>.log`."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True, text=True, check=False,
    )
    with open(so + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        fn = lib.m3t_bvh8_traverse
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ci, vp, vp, vp, vp, ci, ci, ci, vp, vp, vp, vp, vp]
        fn.restype = ci
        lib.m3t_bvh8_max_stack.argtypes = []
        lib.m3t_bvh8_max_stack.restype = ci
        if lib.m3t_bvh8_max_stack() != MAX_STACK:
            raise RuntimeError("kernel library and wrapper disagree on the stack size")
        _lib = lib
    return _lib


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if x.numel() and x.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def traverse_cuda(unified, n_nodes: int, o, d, maxt, active, any_hit: bool = False,
                  layout=None):
    """Kernel launch: (t, face, u, v) for N rays, face == -1 and t == inf on
    a miss.  unified (R, 88) f32; o, d (N, 3) f32; maxt (N,) f32; active
    (N,) bool; all contiguous CUDA tensors on one device.  Raises if any
    ray's stack overflowed (a check that waits for the kernel)."""
    global launches
    from ..scene.bvh8 import DEFAULT_LAYOUT

    lay = layout if layout is not None else DEFAULT_LAYOUT
    if lay.width != 8 or lay.leaf_cap != 8:
        raise ValueError(
            f"the kernel takes the 8-wide layout with leaf_cap 8, got "
            f"width {lay.width} leaf_cap {lay.leaf_cap}"
        )
    if not 1 <= lay.stack <= MAX_STACK:
        raise ValueError(f"stack depth {lay.stack} outside the kernel's 1..{MAX_STACK}")
    device = o.device
    if device.type != "cuda":
        raise ValueError(f"traverse_cuda needs CUDA tensors, got {device}")
    n = o.shape[0]
    _check("unified", unified, torch.float32, (unified.shape[0], ROW_FLOATS), device)
    if not 0 < n_nodes <= unified.shape[0]:
        raise ValueError(f"n_nodes {n_nodes} outside 1..{unified.shape[0]}")
    _check("o", o, torch.float32, (n, 3), device)
    _check("d", d, torch.float32, (n, 3), device)
    _check("maxt", maxt, torch.float32, (n,), device)
    _check("active", active, torch.bool, (n,), device)
    if n >= 2**31:
        raise ValueError("too many rays for one launch")

    t = torch.empty((n,), dtype=torch.float32, device=device)
    face = torch.empty((n,), dtype=torch.int32, device=device)
    u = torch.empty((n,), dtype=torch.float32, device=device)
    v = torch.empty((n,), dtype=torch.float32, device=device)
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.m3t_bvh8_traverse(
            unified.data_ptr(), int(n_nodes), o.data_ptr(), d.data_ptr(),
            maxt.data_ptr(), active.data_ptr(), int(n), int(bool(any_hit)),
            int(lay.stack), t.data_ptr(), face.data_ptr(), u.data_ptr(),
            v.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"bvh8 traversal kernel launch failed: CUDA error {rc}")
    if n:
        launches += 1
        check_overflow(face, lay.stack)
    return t, face, u, v
