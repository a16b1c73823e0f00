"""Wrapper of K6, the wavefront's shading kernel (csrc/shade_wavefront.cu).

`persistent.trace_rays` shades each bounce of the record and the forward
with one launch of K6 on the card, in place of the eager torch operators of
`persistent._shade` (its plain version, which the CPU and the plain replay
keep).  K6 replaces no Pallas kernel: in the JAX package the same shading is
`persistent._shade` inside `_engine_step`, fused by XLA.

  * `pack_scene`: once a `trace_rays` call, a ``ShadeArgs`` structure
    (csrc/shade_lane.h) whose scene part is K5's ``ReplayArgs`` filled by
    `replay_cuda.pack_scene` (the record's pointers left null), with the
    environment's shadow-ray distance appended to its constants.  It makes
    the one copy from the host of the call (the F_dr quadrature nodes);
  * `shade`: one launch over the live lanes' state as trace_rays holds it,
    returning `_shade`'s fields, in buffers made here with ``torch.empty``,
    under `_shade`'s names.  No sync; the launch's error code is checked.

The kernel is built by cuda_build.CudaLibrary at its first CUDA call (never
at import), with --fmad=false so that its float operations round as the
plain version's.  What it reads and raises on: what K5 reads (pack_scene).
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from ..cuda_build import CudaLibrary, check_tensor, stream_of
from ..render.emitter import _scene_radius
from ..utils.profile import count, spanned
from . import replay_cuda

# kernel launches made (a plain int, read by tests and the smoke test)
launches = 0

F32, I32 = torch.float32, torch.int32
# (name, dtype, columns) of a lane's state in, in csrc/shade_lane.h's order
LANE_IN = (("d", F32, 3), ("t", F32, 1), ("face", I32, 1), ("u", F32, 1), ("v", F32, 1),
           ("L", F32, 3), ("f", F32, 3), ("eta", F32, 1), ("depth", I32, 1),
           ("prev_p", F32, 3), ("prev_pdf", F32, 1), ("prev_delta", torch.bool, 1),
           ("idx", torch.int64, 1))
# _shade's fields out, in the same order
LANE_OUT = (("L", F32, 3), ("f", F32, 3), ("eta", F32, 1), ("p", F32, 3), ("pdf", F32, 1),
            ("delta", torch.bool, 1), ("nee_L", F32, 3), ("next_o", F32, 3),
            ("next_d", F32, 3), ("cont", torch.bool, 1), ("shadow_o", F32, 3),
            ("shadow_d", F32, 3), ("shadow_maxt", F32, 1), ("active_em", torch.bool, 1))


class ShadeArgs(ctypes.Structure):
    """csrc/shade_lane.h's rp::ShadeArgs, field for field."""

    _fields_ = ([("scene", replay_cuda.ReplayArgs), ("n", ctypes.c_int64)]
                + [(f"in_{name}", ctypes.c_void_p) for name, _, _ in LANE_IN]
                + [(f"out_{name}", ctypes.c_void_p) for name, _, _ in LANE_OUT])


def check_args_size(lib) -> None:
    """Raises unless the library's ShadeArgs has the wrapper's size."""
    lib.m3t_shade_args_size.argtypes = []
    lib.m3t_shade_args_size.restype = ctypes.c_int
    if lib.m3t_shade_args_size() != ctypes.sizeof(ShadeArgs):
        raise RuntimeError("the shading library and its wrapper disagree on ShadeArgs")


def _bind(lib):
    check_args_size(lib)
    lib.m3t_shade_wavefront.argtypes = [ctypes.POINTER(ShadeArgs), ctypes.c_void_p]
    lib.m3t_shade_wavefront.restype = ctypes.c_int


LIBRARY = CudaLibrary("shade_wavefront", ("--fmad=false",), _bind)


@spanned("m3t.shade.pack")
def pack_scene(scene, seed, *, max_depth: int, rr_depth: int) -> replay_cuda.Packed:
    """K6's arguments of one trace_rays call: the scene's tables on its own
    device, the seed and the depths; the lanes come with each `shade`."""
    s = ShadeArgs()
    keep: list = []
    far = 2.0 * _scene_radius(scene)   # where emitter.sample_emitter_direction puts an env target
    replay_cuda.pack_scene(s.scene, keep, scene, scene.device, extra_consts=(far.reshape(1),))
    s.scene.seed = int(seed) & 0xFFFFFFFF
    s.scene.max_depth, s.scene.rr_depth = int(max_depth), int(rr_depth)
    return replay_cuda.Packed(s, keep)


def bind_lanes(packed: replay_cuda.Packed, lanes) -> dict:
    """Points the packed arguments at the lanes' state (LANE_IN's tensors,
    in order, each contiguous) and at new output buffers; returns the
    outputs by name."""
    s = packed.args
    dev = packed.keep[0].device
    n = lanes[1].shape[0]
    s.n = n
    for (name, dtype, cols), x in zip(LANE_IN, lanes, strict=True):
        check_tensor(name, x, dtype, (n, 3) if cols == 3 else (n,), dev, align=x.element_size())
        setattr(s, f"in_{name}", x.data_ptr())
    out = {}
    for name, dtype, cols in LANE_OUT:
        out[name] = torch.empty((n, 3) if cols == 3 else (n,), dtype=dtype, device=dev)
        setattr(s, f"out_{name}", out[name].data_ptr())
    return out


@spanned("m3t.shade")
def shade(packed: replay_cuda.Packed, *lanes) -> SimpleNamespace:
    """`_shade`'s fields of one bounce in one K6 launch: `lanes` are the
    live lanes' d, t, face, u, v, L, f, eta, depth, prev_p, prev_pdf,
    prev_delta and idx (LANE_IN), each lane a finished closest hit (the
    plain version's doneA true).  CUDA tensors only."""
    global launches
    dev = packed.keep[0].device
    if dev.type != "cuda":
        raise ValueError(f"K6 needs CUDA tensors, got {dev}")
    out = bind_lanes(packed, lanes)
    n = packed.args.n
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.m3t_shade_wavefront(ctypes.byref(packed.args), stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"K6 launch failed: CUDA error {rc}")
    count("m3t.shade.kernel_lanes", n)
    if n:
        launches += 1
    return SimpleNamespace(**out)
