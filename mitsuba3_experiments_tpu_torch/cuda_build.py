"""Build and load of the port's CUDA kernels: nvcc into a shared library
with a plain C interface, loaded with ctypes.

Every kernel source under csrc/ is compiled at its first CUDA use (never at
import: a machine without a card has no nvcc) into build/torch_kernels/ at
the repository root.  The library's file name carries a hash of the source
and the flags, so an edit rebuilds it; nvcc's output (ptxas registers,
spills, shared memory) goes to `<library>.log`.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.normpath(os.path.join(_HERE, "..", "build", "torch_kernels"))
# sm_90a: Hopper with its architecture-specific instructions
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
SHARED_FLAGS = ("-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): nvcc is needed to build")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


class CudaLibrary:
    """One csrc/ source, its nvcc flags, and the ctypes binding of its C
    functions.  `bind(lib)` declares argtypes/restype (and may check the
    library against the wrapper); it runs once, at the first `load`."""

    def __init__(self, name: str, extra_flags: tuple, bind):
        self.name = name
        self.source = os.path.join(CSRC, f"{name}.cu")
        self.flags = ARCH_FLAGS + tuple(extra_flags) + SHARED_FLAGS
        self._bind = bind
        self.handle = None

    def path(self) -> str:
        """Where the build of the current source and flags lives."""
        with open(self.source, "rb") as f:
            key = hashlib.sha256(f.read() + " ".join(self.flags).encode()).hexdigest()[:16]
        return os.path.join(BUILD_DIR, f"{self.name}_{key}.so")

    def build(self) -> str:
        """Compile unless this source's build exists; returns the path."""
        so = self.path()
        if os.path.exists(so):
            return so
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [_nvcc(), *self.flags, "-o", tmp, self.source],
            capture_output=True, text=True, check=False,
        )
        with open(so + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {self.source} ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)
        return so

    def load(self) -> ctypes.CDLL:
        if self.handle is None:
            lib = ctypes.CDLL(self.build())
            self._bind(lib)
            self.handle = lib
        return self.handle


def stream_of(device) -> int:
    """PyTorch's current CUDA stream on `device`, as a pointer-sized int."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


# device state that kernels keep from call to call, by (name, device index,
# stream)
_scratch: dict = {}


def stream_scratch(name: str, device, stream: int, make):
    """The state `name` keeps on `device` for `stream` (as `stream_of` gives
    it), made by `make(device)` at its first use.  Launches on one stream
    run in order, so a kernel may leave such state for the next launch to
    find."""
    key = (name, device.index, stream)
    state = _scratch.get(key)
    if state is None:
        state = _scratch[key] = make(device)
    return state


def check_tensor(name, x, dtype, shape, device, align: int = 4):
    """Raises unless x is a contiguous `dtype` tensor of `shape` on
    `device` whose data is `align`-byte aligned."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if x.numel() and x.data_ptr() % align:
        raise ValueError(f"{name} is not {align}-byte aligned")
