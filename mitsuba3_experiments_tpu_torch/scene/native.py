"""The port's host library: the OBJ loader and the object-split and
spatial-split (SBVH) BVH builders in C++, bound with ctypes.

The sources are the repository's `native/objloader.cpp`, `bvh_builder.cpp`
and `sbvh_builder.cpp`, compiled unchanged with g++ and the flags of
`native/Makefile` into `build/host/` at the repository root at first use
(never at import).  The library's file name carries a hash of the sources,
the flags and the host CPU (``-march=native`` code runs only on a CPU like
the one that built it), so an edit or another machine rebuilds it.  The
build goes to a temporary name that is renamed into place, so processes
that load a scene at the same time do not race.  A missing compiler or a
failed build raises: nothing falls back to the numpy builder.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.normpath(os.path.join(_HERE, "..", ".."))
SOURCES = tuple(os.path.join(_REPO, "native", f)
                for f in ("objloader.cpp", "bvh_builder.cpp", "sbvh_builder.cpp"))
BUILD_DIR = os.path.join(_REPO, "build", "host")
# native/Makefile's CXXFLAGS
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-march=native")
# the spatial-split build's cap on leaf references, per face (the JAX
# package's default)
SBVH_BUDGET = 2.0

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)


def _cpu_identity() -> bytes:
    """The host CPU's model and feature flags (what -march=native reads)."""
    ident = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            seen = set()
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features", "CPU part") and key not in seen:
                    seen.add(key)
                    ident.append(line.strip())
    except OSError:
        ident.append(platform.processor())
    return "\n".join(ident).encode()


def _bind(lib):
    """The six entry points, with the JAX package's ctypes signatures."""
    lib.m3t_load_obj.restype = ctypes.c_int
    lib.m3t_load_obj.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p), _i64p, _i64p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.m3t_copy_mesh.restype = None
    lib.m3t_copy_mesh.argtypes = [ctypes.c_void_p, _f32p, _f32p, _f32p, _i32p]
    lib.m3t_free_mesh.restype = None
    lib.m3t_free_mesh.argtypes = [ctypes.c_void_p]
    lib.m3t_build_sbvh.restype = ctypes.c_int
    lib.m3t_build_sbvh.argtypes = [
        _f32p, ctypes.c_int64, _i32p, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.POINTER(ctypes.c_void_p), _i64p, _i64p,
    ]
    lib.m3t_build_bvh.restype = ctypes.c_int
    lib.m3t_build_bvh.argtypes = [
        _f32p, ctypes.c_int64, _i32p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), _i64p,
    ]
    for name in ("m3t_copy_sbvh", "m3t_copy_bvh"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, _f32p, _f32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i32p]
    for name in ("m3t_free_sbvh", "m3t_free_bvh"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p]


class HostLibrary:
    """The compiled host library: `build()` makes it if this machine's
    build of the current sources is missing, `load()` binds it once."""

    def __init__(self):
        self.handle = None
        self._lock = threading.Lock()

    def path(self) -> str:
        h = hashlib.sha256()
        for src in SOURCES:
            with open(src, "rb") as f:
                h.update(f.read())
        h.update(" ".join(FLAGS).encode() + _cpu_identity())
        return os.path.join(BUILD_DIR, f"libm3t_{h.hexdigest()[:16]}.so")

    def build(self) -> str:
        so = self.path()
        if os.path.exists(so):
            return so
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: it builds the host library from native/*.cpp")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.run([cxx, *FLAGS, "-o", tmp, *SOURCES], capture_output=True,
                              text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on native/*.cpp ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
        return so

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self.handle is None:
                lib = ctypes.CDLL(self.build())
                _bind(lib)
                self.handle = lib
        return self.handle


LIBRARY = HostLibrary()


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _copy_tree(lib, copy, free, handle, n_nodes: int, n_refs: int):
    lo = np.empty((n_nodes, 3), np.float32)
    hi = np.empty((n_nodes, 3), np.float32)
    left, right, first, count = (np.empty(n_nodes, np.int32) for _ in range(4))
    order = np.empty(n_refs, np.int32)
    max_leaf = ctypes.c_int32()
    copy(handle, _ptr(lo, ctypes.c_float), _ptr(hi, ctypes.c_float),
         *(_ptr(a, ctypes.c_int32) for a in (left, right, first, count, order)),
         ctypes.byref(max_leaf))
    free(handle)
    return lo, hi, left, right, first, count, order, int(max_leaf.value)


def build_bvh_native(vertices, faces, leaf_size: int):
    """Object-split binned SAH (native/bvh_builder.cpp): (lo, hi, left,
    right, first, count, prim_order, max_leaf) numpy arrays."""
    lib = LIBRARY.load()
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    handle, n_nodes = ctypes.c_void_p(), ctypes.c_int64()
    rc = lib.m3t_build_bvh(_ptr(v, ctypes.c_float), v.shape[0], _ptr(f, ctypes.c_int32),
                           f.shape[0], leaf_size, ctypes.byref(handle), ctypes.byref(n_nodes))
    if rc != 0:
        raise RuntimeError(f"m3t_build_bvh returned {rc}")
    return _copy_tree(lib, lib.m3t_copy_bvh, lib.m3t_free_bvh, handle, n_nodes.value,
                      f.shape[0])


def build_sbvh_native(vertices, faces, leaf_size: int, alpha: float):
    """Spatial-split binned SAH (native/sbvh_builder.cpp), as
    `build_bvh_native`; prim_order holds references: a triangle that
    straddles a spatial split is in both children (with clipped boxes), so
    it may be longer than the face count and repeat face ids."""
    lib = LIBRARY.load()
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    handle, n_nodes, n_refs = ctypes.c_void_p(), ctypes.c_int64(), ctypes.c_int64()
    rc = lib.m3t_build_sbvh(_ptr(v, ctypes.c_float), v.shape[0], _ptr(f, ctypes.c_int32),
                            f.shape[0], leaf_size, alpha, SBVH_BUDGET, ctypes.byref(handle),
                            ctypes.byref(n_nodes), ctypes.byref(n_refs))
    if rc != 0:
        raise RuntimeError(f"m3t_build_sbvh returned {rc}")
    return _copy_tree(lib, lib.m3t_copy_sbvh, lib.m3t_free_sbvh, handle, n_nodes.value,
                      n_refs.value)


def load_obj_native(path: str):
    """(v, n, uv, f) of an OBJ file (native/objloader.cpp); n and uv are
    None where the file has no vn / vt records."""
    lib = LIBRARY.load()
    handle, nv, nf = ctypes.c_void_p(), ctypes.c_int64(), ctypes.c_int64()
    has_n, has_uv = ctypes.c_int(), ctypes.c_int()
    rc = lib.m3t_load_obj(os.fsencode(path), ctypes.byref(handle), ctypes.byref(nv),
                          ctypes.byref(nf), ctypes.byref(has_n), ctypes.byref(has_uv))
    if rc != 0:
        raise FileNotFoundError(f"cannot open {path}")
    v = np.empty((nv.value, 3), np.float32)
    n = np.empty((nv.value, 3), np.float32)
    uv = np.empty((nv.value, 2), np.float32)
    f = np.empty((nf.value, 3), np.int32)
    lib.m3t_copy_mesh(handle, _ptr(v, ctypes.c_float), _ptr(n, ctypes.c_float),
                      _ptr(uv, ctypes.c_float), _ptr(f, ctypes.c_int32))
    lib.m3t_free_mesh(handle)
    return v, (n if has_n.value else None), (uv if has_uv.value else None), f
