"""K5's and K6's arithmetic on the CPU: csrc/replay_path.h and
csrc/shade_lane.h built with g++ through csrc/replay_path_host.cpp and
csrc/shade_lane_host.cpp, for the tests.

The headers hold the per-row replay (forward and adjoint) and the per-lane
shading that the kernels run on the card; these libraries run the same
functions in a loop over the rows or lanes on the host, fed the same
structures (replay_cuda.pack_args, shade_cuda.pack_scene) from CPU tensors.
Each is built at first use into build/host/ at the repository root (the
file name carries a hash of the sources and flags; a temporary name is
renamed into place).  No float contraction (-ffp-contract=off), as nvcc's
--fmad=false.  The port's CPU path does not use them."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from mitsuba3_experiments_tpu_torch.integrators import replay_cuda, shade_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "mitsuba3_experiments_tpu_torch", "csrc")
HEADERS = (os.path.join(CSRC, "replay_path.h"), os.path.join(CSRC, "shade_lane.h"))
FLAGS = ("-O2", "-std=c++17", "-ffp-contract=off", "-fPIC", "-shared")
BUILD_DIR = os.path.join(REPO, "build", "host")

_lock = threading.Lock()
_libs: dict = {}


def _build(stem: str) -> ctypes.CDLL:
    """csrc/<stem>.cpp and the headers built with g++ and loaded."""
    source = os.path.join(CSRC, f"{stem}.cpp")
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in (source, *HEADERS):
        with open(src, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"g++ not found: it builds csrc/{stem}.cpp")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, *FLAGS, "-o", tmp, source], capture_output=True,
                              text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {stem}.cpp:\n{proc.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(so)


def library() -> ctypes.CDLL:
    """K5's host build."""
    with _lock:
        if "replay" not in _libs:
            lib = _build("replay_path_host")
            replay_cuda.check_args_size(lib)
            args_p = ctypes.POINTER(replay_cuda.ReplayArgs)
            dbl_p = ctypes.POINTER(ctypes.c_double)
            lib.m3t_replay_forward_host.argtypes = [args_p]
            lib.m3t_replay_forward_host.restype = ctypes.c_int
            lib.m3t_replay_adjoint_host.argtypes = [args_p, dbl_p, dbl_p]
            lib.m3t_replay_adjoint_host.restype = ctypes.c_int
            _libs["replay"] = lib
        return _libs["replay"]


def shade_library() -> ctypes.CDLL:
    """K6's host build."""
    with _lock:
        if "shade" not in _libs:
            lib = _build("shade_lane_host")
            shade_cuda.check_args_size(lib)
            lib.m3t_shade_wavefront_host.argtypes = [ctypes.POINTER(shade_cuda.ShadeArgs)]
            lib.m3t_shade_wavefront_host.restype = ctypes.c_int
            _libs["shade"] = lib
        return _libs["shade"]


def shade(scene, seed, lanes, *, max_depth: int, rr_depth: int) -> dict:
    """The header's `_shade` fields of one bounce (shade_cuda.LANE_OUT, by
    name) on CPU tensors: `lanes` as shade_cuda.shade takes them."""
    packed = shade_cuda.pack_scene(scene, seed, max_depth=max_depth, rr_depth=rr_depth)
    out = shade_cuda.bind_lanes(packed, lanes)
    assert shade_library().m3t_shade_wavefront_host(ctypes.byref(packed.args)) == 0
    return out


def forward(scene, rec, seed, idx0, **kw):
    """The header's per-row L (N, 3) float32 on CPU tensors (pack_args's
    arguments)."""
    return forward_packed(replay_cuda.pack_args(scene, rec, seed, idx0, **kw))


def forward_packed(packed):
    """replay_cuda.replay_forward on the host: L (N, 3) float32 of a packed
    chunk on CPU tensors."""
    a = packed.args
    L = torch.empty((a.n_rows, 3), dtype=torch.float32)
    a.L = L.data_ptr()
    assert library().m3t_replay_forward_host(ctypes.byref(a)) == 0
    return L


def _adjoint64(packed, dL):
    a = packed.args
    dL = dL.detach().to(torch.float32).contiguous()
    scratch = torch.empty((a.depth, 6, a.n_rows), dtype=torch.float32)
    d_bc = torch.zeros((a.n_mats, 3), dtype=torch.float64)
    d_rad = torch.zeros((a.n_emitters, 3), dtype=torch.float64)
    a.dL, a.scratch = dL.data_ptr(), scratch.data_ptr()
    dbl_p = ctypes.POINTER(ctypes.c_double)
    rc = library().m3t_replay_adjoint_host(ctypes.byref(a),
                                           ctypes.cast(d_bc.data_ptr(), dbl_p),
                                           ctypes.cast(d_rad.data_ptr(), dbl_p))
    assert rc == 0
    return d_bc, d_rad


def adjoint(scene, rec, seed, idx0, dL, **kw):
    """The header's gradients of sum(L * dL) with respect to base_color
    (M, 3) and radiance (E, 3), every row's terms summed in float64."""
    return _adjoint64(replay_cuda.pack_args(scene, rec, seed, idx0, **kw), dL)


def adjoint_packed(packed, dL, shared=None, out=None, scratch=None):
    """replay_cuda.replay_adjoint on the host: the float64 sums rounded to
    float32 and added into `out` as the kernel adds (new zeroed buffers
    without it); `shared` and `scratch` are the kernel's and go unused."""
    d_bc, d_rad = _adjoint64(packed, dL)
    if out is None:
        out = (torch.zeros(d_bc.shape), torch.zeros(d_rad.shape))
    out[0].add_(d_bc.float())
    out[1].add_(d_rad.float())
    return out
