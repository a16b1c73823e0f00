"""K5's arithmetic on the CPU: csrc/replay_path.h built with g++ through
csrc/replay_path_host.cpp, for the tests.

The header holds the per-row forward and adjoint that the kernels run on
the card; this library runs the same functions in a loop over the rows on
the host, fed the same ReplayArgs structure (replay_cuda.pack_args) from CPU
tensors.  It is built at first use into build/host/ at the repository root
(the file name carries a hash of the sources and flags; a temporary name is
renamed into place).  No float contraction (-ffp-contract=off), as nvcc's
--fmad=false.  The port's CPU path does not use it."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from mitsuba3_experiments_tpu_torch.integrators import replay_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "mitsuba3_experiments_tpu_torch", "csrc")
SOURCES = (os.path.join(CSRC, "replay_path_host.cpp"), os.path.join(CSRC, "replay_path.h"))
FLAGS = ("-O2", "-std=c++17", "-ffp-contract=off", "-fPIC", "-shared")
BUILD_DIR = os.path.join(REPO, "build", "host")

_lock = threading.Lock()
_lib = None


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(FLAGS).encode())
        for src in SOURCES:
            with open(src, "rb") as f:
                h.update(f.read())
        so = os.path.join(BUILD_DIR, f"replay_path_host_{h.hexdigest()[:16]}.so")
        if not os.path.exists(so):
            cxx = shutil.which("g++")
            if cxx is None:
                raise RuntimeError("g++ not found: it builds csrc/replay_path_host.cpp")
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run([cxx, *FLAGS, "-o", tmp, SOURCES[0]], capture_output=True,
                                  text=True, check=False)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on replay_path_host.cpp:\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        replay_cuda.check_args_size(lib)
        args_p = ctypes.POINTER(replay_cuda.ReplayArgs)
        dbl_p = ctypes.POINTER(ctypes.c_double)
        lib.m3t_replay_forward_host.argtypes = [args_p]
        lib.m3t_replay_forward_host.restype = ctypes.c_int
        lib.m3t_replay_adjoint_host.argtypes = [args_p, dbl_p, dbl_p]
        lib.m3t_replay_adjoint_host.restype = ctypes.c_int
        _lib = lib
        return lib


def forward(scene, rec, seed, idx0, **kw):
    """The header's per-row L (N, 3) float32 on CPU tensors (pack_args's
    arguments)."""
    packed = replay_cuda.pack_args(scene, rec, seed, idx0, **kw)
    a = packed.args
    L = torch.empty((a.n_rows, 3), dtype=torch.float32)
    a.L = L.data_ptr()
    assert library().m3t_replay_forward_host(ctypes.byref(a)) == 0
    return L


def adjoint(scene, rec, seed, idx0, dL, **kw):
    """The header's gradients of sum(L * dL) with respect to base_color
    (M, 3) and radiance (E, 3), every row's terms summed in float64."""
    packed = replay_cuda.pack_args(scene, rec, seed, idx0, **kw)
    a = packed.args
    dL = dL.to(torch.float32).contiguous()
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
