"""Wrapper of the CUDA BVH8 traversal kernel (csrc/bvh_traverse.cu).

Counterpart of ``mitsuba3_experiments_tpu.intersect.bvh_pallas``.  The kernel
replaces the TPU kernel ``traverse_pallas`` and the XLA loop
``bvh_jax._traverse``: each lane walks one ray at a time through
BVH.unified, reading rows with 16-byte loads, with an int stack in local
memory.  It is bound by the instructions it executes and the L1/L2 traffic
of its row fetches, not by their latency, so it runs in persistent warps
that refill their idle lanes with new rays in groups, takes a node step
every round and batches the leaf steps, uses one-instruction
NaN-propagating min/max and sorts the pushes over the hit children only
(PERF.md gives the measurements).  Each lane still makes the
same row visits and float operations as the plain version, whose bits it
gives.

The warps take rays from a counter on the device, one per (device, stream),
that every launch leaves at 0 for the next one: no memset, and a call
allocates only its outputs.

The kernel is built by cuda_build.CudaLibrary at the first CUDA call (never
at import).  Its own flag is --fmad=false — no FMA contraction, so the
kernel's float operations round exactly like the plain torch version's.
"""
from __future__ import annotations

import ctypes

import torch

from ..cuda_build import CudaLibrary, check_tensor, stream_of, stream_scratch

# kernel launches made (a plain int, read by tests and the smoke test)
launches = 0

ROW_FLOATS = 88
MAX_STACK = 96
# face code of a ray whose traversal stack would have overflowed; the table
# is then not one that collapse_to_wide built for this layout
OVERFLOW = -2


def check_overflow(face, depth: int) -> None:
    """Raises if any ray of a traversal (kernel or plain) overflowed its
    stack of `depth` entries; waits for the device."""
    if bool((face == OVERFLOW).any()):
        raise RuntimeError(
            f"bvh8 traversal stack overflow (depth {depth}): the table was not "
            "built for this layout"
        )


def _bind(lib):
    fn = lib.m3t_bvh8_traverse
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ci, vp, vp, vp, vp, ci, ci, ci, vp, vp, vp, vp, vp, vp]
    fn.restype = ci
    lib.m3t_bvh8_max_stack.argtypes = []
    lib.m3t_bvh8_max_stack.restype = ci
    if lib.m3t_bvh8_max_stack() != MAX_STACK:
        raise RuntimeError("kernel library and wrapper disagree on the stack size")


LIBRARY = CudaLibrary("bvh_traverse", ("--fmad=false",), _bind)


def _work_counters(device):
    """The ray counter and finished-warp count of a launch: two int64 zeros
    that every launch leaves at zero."""
    return torch.zeros((2,), dtype=torch.int64, device=device)


def _layout(layout):
    from ..scene.bvh8 import DEFAULT_LAYOUT

    lay = layout if layout is not None else DEFAULT_LAYOUT
    if lay.width != 8 or lay.leaf_cap != 8:
        raise ValueError(
            f"the kernel takes the 8-wide layout with leaf_cap 8, got "
            f"width {lay.width} leaf_cap {lay.leaf_cap}"
        )
    if not 1 <= lay.stack <= MAX_STACK:
        raise ValueError(f"stack depth {lay.stack} outside the kernel's 1..{MAX_STACK}")
    return lay


def _launch(unified, n_nodes: int, o, d, maxt, active, any_hit: bool = False, layout=None):
    """Checks the arguments, launches the kernel, counts the launch and
    returns (t, face, u, v) without waiting for the kernel; a ray whose
    stack overflowed has face OVERFLOW."""
    global launches
    lay = _layout(layout)
    device = o.device
    if device.type != "cuda":
        raise ValueError(f"traverse_cuda needs CUDA tensors, got {device}")
    n = o.shape[0]
    check_tensor("unified", unified, torch.float32, (unified.shape[0], ROW_FLOATS), device, 16)
    if not 0 < n_nodes <= unified.shape[0]:
        raise ValueError(f"n_nodes {n_nodes} outside 1..{unified.shape[0]}")
    check_tensor("o", o, torch.float32, (n, 3), device, 16)
    check_tensor("d", d, torch.float32, (n, 3), device, 16)
    check_tensor("maxt", maxt, torch.float32, (n,), device, 16)
    check_tensor("active", active, torch.bool, (n,), device, 16)
    if n >= 2**31:
        raise ValueError("too many rays for one launch")

    t = torch.empty((n,), dtype=torch.float32, device=device)
    face = torch.empty((n,), dtype=torch.int32, device=device)
    u = torch.empty((n,), dtype=torch.float32, device=device)
    v = torch.empty((n,), dtype=torch.float32, device=device)
    lib = LIBRARY.load()
    with torch.cuda.device(device):
        stream = stream_of(device)
        work = stream_scratch("bvh8_traverse", device, stream, _work_counters)
        rc = lib.m3t_bvh8_traverse(
            unified.data_ptr(), int(n_nodes), o.data_ptr(), d.data_ptr(),
            maxt.data_ptr(), active.data_ptr(), int(n), int(bool(any_hit)),
            int(lay.stack), t.data_ptr(), face.data_ptr(), u.data_ptr(),
            v.data_ptr(), work.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"bvh8 traversal kernel launch failed: CUDA error {rc}")
    if n:
        launches += 1
    return t, face, u, v


def traverse_cuda(unified, n_nodes: int, o, d, maxt, active, any_hit: bool = False,
                  layout=None):
    """Kernel launch: (t, face, u, v) for N rays, face == -1 and t == inf on
    a miss.  unified (R, 88) f32; o, d (N, 3) f32; maxt (N,) f32; active
    (N,) bool; all contiguous CUDA tensors on one device.  Raises if any
    ray's stack overflowed (a check that waits for the kernel)."""
    t, face, u, v = _launch(unified, n_nodes, o, d, maxt, active, any_hit, layout)
    if face.numel():
        check_overflow(face, _layout(layout).stack)
    return t, face, u, v
