"""Wrapper of K5, the path replay kernels (csrc/replay_path.cu).

Counterpart of the XLA program the JAX package compiles for the replay:
``replay_radiance``'s ``lax.scan`` over depth, differentiated by
``jax.grad`` in ``_replay_grad_jit`` (``mitsuba3_experiments_tpu/
integrators/replay.py:792`` / ``:952``).  Two launches replace the port's
Python loop of eager operators:

  * `replay_forward`: L (N, 3), the per-row radiance of a PathRecord chunk;
  * `replay_adjoint`: from dL (N, 3), the gradients with respect to
    ``materials.base_color`` (M, 3) and ``emitters.radiance`` (E, 3).

`replay.ReplayRadiance` is the autograd.Function around them.  The arguments
travel as one ``ReplayArgs`` structure (csrc/replay_path.h) of pointers,
sizes and scalars; `pack_args` fills it from a scene and a record on any
device, so the CPU tests can hand the same structure to the header's host
build.  The replay's step-level loop (`replay._CardReplay`) fills the
scene's part once a call (`pack_step`) and points it at each chunk's rows
(`bind_rows`); its adjoint launches add into the caller's two gradient
buffers through one scratch (`replay_adjoint`'s `out` and `scratch`).
The kernels are built by cuda_build.CudaLibrary at their first CUDA call
(never at import), with --fmad=false so that their float operations round
as the plain torch version's.

What K5 reads and raises on: every BSDFKind (``scene/types.py``), area
emitters, the constant environment and the textured environment map, the
packed tables of ``scene/types.py`` (face rows of 32 floats, emitter-face
rows of 16, material params of 8, RGB textures).  A scene outside that
raises here, before any launch.
"""
from __future__ import annotations

import ctypes

import torch

from ..cuda_build import CudaLibrary, check_tensor, stream_of
from ..render import fresnel as fr
from ..render.emitter import _has_env_map
from ..scene.types import BSDFKind
from ..utils.profile import count, spanned

# kernel launches made (plain ints, read by tests and the smoke test)
forward_launches = 0
adjoint_launches = 0

# float32 entries of ReplayArgs.consts (csrc/replay_path.h, kConsts)
N_CONSTS = 24

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64


class ReplayArgs(ctypes.Structure):
    """csrc/replay_path.h's rp::ReplayArgs, field for field."""

    _fields_ = [
        ("prim", _P), ("rec_u", _P), ("rec_v", _P), ("occl", _P), ("idx", _P),
        ("n_rows", _I64), ("idx0", _I64), ("ray_end", _I64),
        ("depth", _I32), ("n_steps", _I32), ("seed", ctypes.c_uint32), ("spp", _I32),
        ("max_depth", _I32), ("rr_depth", _I32), ("width", _I32), ("height", _I32),
        ("consts", _P),
        ("face_packed", _P),
        ("mat_kind", _P), ("base_color", _P), ("mat_params", _P), ("mat_tex", _P),
        ("mat_flags", _P), ("mat_twosided", _P), ("mat_nested", _P), ("mat_fdr", _P),
        ("n_mats", _I32),
        ("tex_data", _P), ("tex_size", _P), ("tex_h", _I32), ("tex_w", _I32),
        ("radiance", _P), ("n_emitters", _I32), ("n_em_faces", _I32),
        ("em_packed", _P), ("face_cdf", _P),
        ("env_map", _P), ("env_weights", _P), ("env_row_cdf", _P), ("env_col_cdf", _P),
        ("env_h", _I32), ("env_w", _I32), ("has_env_map", _I32), ("shared_tables", _I32),
        ("L", _P), ("dL", _P), ("d_base_color", _P), ("d_radiance", _P), ("scratch", _P),
    ]


def check_args_size(lib) -> None:
    """Raises unless the library's ReplayArgs has the wrapper's size."""
    lib.m3t_replay_args_size.argtypes = []
    lib.m3t_replay_args_size.restype = ctypes.c_int
    if lib.m3t_replay_args_size() != ctypes.sizeof(ReplayArgs):
        raise RuntimeError("the replay library and its wrapper disagree on ReplayArgs")


def _bind(lib):
    check_args_size(lib)
    for name in ("m3t_replay_forward", "m3t_replay_adjoint"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ReplayArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.m3t_replay_max_shared.argtypes = []
    lib.m3t_replay_max_shared.restype = ctypes.c_int


LIBRARY = CudaLibrary("replay_path", ("--fmad=false",), _bind)


class Packed:
    """A filled ReplayArgs and the tensors its pointers point into (kept
    alive with it): `keep` the scene's, `rows` the record chunk's."""

    def __init__(self, args: ReplayArgs, keep: list):
        self.args = args
        self.keep = keep
        self.rows: list = []
        self.out = ()


def _ptr(keep, name, x, dtype, shape, device):
    check_tensor(name, x, dtype, shape, device, align=x.element_size())
    keep.append(x)
    return x.data_ptr()


@spanned("m3t.k5.pack")
def pack_args(scene, rec, seed, idx0, *, spp: int, max_depth: int, rr_depth: int,
              ray_end=None, idx=None, n_steps: int | None = None) -> Packed:
    """ReplayArgs of a record chunk: row r is camera ray idx0 + r, or idx[r]
    (int64) when given; rows at or past `ray_end` are inactive; `n_steps`
    depth steps at most.  Every tensor must be on the record's device; a
    scene or layout K5 does not read raises."""
    packed = _scene_args(scene, rec.prim.device, seed, spp=spp, max_depth=max_depth,
                         rr_depth=rr_depth)
    bind_rows(packed, rec, idx0, ray_end=ray_end, idx=idx, n_steps=n_steps)
    return packed


@spanned("m3t.k5.pack")
def pack_step(scene, dev, seed, *, spp: int, max_depth: int, rr_depth: int) -> Packed:
    """ReplayArgs of one replay call's scene on `dev`, without a record:
    `bind_rows` points it at each chunk's rows in turn."""
    return _scene_args(scene, dev, seed, spp=spp, max_depth=max_depth, rr_depth=rr_depth)


def _scene_args(scene, dev, seed, *, spp: int, max_depth: int, rr_depth: int) -> Packed:
    keep: list = []
    a = ReplayArgs()
    a.seed = int(seed) & 0xFFFFFFFF
    a.spp, a.max_depth, a.rr_depth = int(spp), int(max_depth), int(rr_depth)
    pack_scene(a, keep, scene, dev)
    return Packed(a, keep)


def bind_rows(packed: Packed, rec, idx0, *, ray_end=None, idx=None,
              n_steps: int | None = None) -> None:
    """Points `packed` at a record chunk (pack_args's arguments), in place
    of the chunk it pointed at; the record's tensors must be on the scene's
    device.  Reads no device value."""
    a = packed.args
    dev = packed.keep[0].device
    n, D = rec.prim.shape
    rows: list = []
    a.prim = _ptr(rows, "prim", rec.prim.contiguous(), torch.int32, (n, D), dev)
    a.rec_u = _ptr(rows, "u", rec.u.contiguous(), torch.float32, (n, D), dev)
    a.rec_v = _ptr(rows, "v", rec.v.contiguous(), torch.float32, (n, D), dev)
    a.occl = _ptr(rows, "occl", rec.occl.contiguous(), torch.bool, (n, D), dev)
    a.idx = None if idx is None else _ptr(rows, "idx", idx.to(torch.int64).contiguous(),
                                          torch.int64, (n,), dev)
    a.n_rows, a.idx0 = n, int(idx0)
    a.ray_end = -1 if ray_end is None else int(ray_end)
    a.depth = D
    a.n_steps = D if n_steps is None else max(0, min(int(n_steps), D))
    packed.rows = rows


def pack_scene(a: ReplayArgs, keep: list, scene, dev, extra_consts=()) -> None:
    """Fills the scene's fields of `a` (the camera and emitter constants,
    then `extra_consts`, 1-element tensors, in `consts`; the geometry,
    material, texture and emitter tables; each material's F_dr) from the
    tensors of `scene` on `dev`, kept alive in `keep`.  A scene or layout
    that K5's device functions do not read raises."""
    mats, em, tex, g = scene.materials, scene.emitters, scene.textures, scene.geometry
    unknown = sorted(set(mats.kinds_present) - set(range(BSDFKind.COUNT)))
    if unknown:
        raise ValueError(f"K5 has no BSDF kind {unknown}")
    a.width, a.height = scene.camera.resolution

    consts = torch.cat([
        scene.camera.to_world.detach().reshape(16), scene.camera.tan_half_fov.reshape(2),
        em.env_radiance.reshape(3), em.env_select_p.reshape(1), em.face_dist.total.reshape(1),
        em.env_dist.total.reshape(1), *extra_consts,
    ]).to(torch.float32).contiguous()
    a.consts = _ptr(keep, "consts", consts, torch.float32, (N_CONSTS + len(extra_consts),), dev)

    F = g.face_packed.shape[0]
    a.face_packed = _ptr(keep, "geometry.face_packed", g.face_packed, torch.float32, (F, 32),
                         dev)
    M = mats.kind.shape[0]
    a.n_mats = M
    a.mat_kind = _ptr(keep, "materials.kind", mats.kind, torch.int32, (M,), dev)
    a.base_color = _ptr(keep, "materials.base_color", mats.base_color.detach().contiguous(),
                        torch.float32, (M, 3), dev)
    params = mats.params.detach().contiguous()
    a.mat_params = _ptr(keep, "materials.params", params, torch.float32, (M, 8), dev)
    a.mat_tex = _ptr(keep, "materials.tex_id", mats.tex_id, torch.int32, (M,), dev)
    a.mat_flags = _ptr(keep, "materials.flags", mats.flags, torch.int32, (M,), dev)
    a.mat_twosided = _ptr(keep, "materials.twosided", mats.twosided, torch.bool, (M,), dev)
    a.mat_nested = _ptr(keep, "materials.nested_id", mats.nested_id, torch.int32, (M,), dev)
    # F_dr of each material's eta, as _eval_pdf_kinds and sample compute it per lane
    fdr = fr.fresnel_diffuse_reflectance(1.0 / torch.clamp(params[:, 0], min=1e-3))
    a.mat_fdr = _ptr(keep, "fdr", fdr.contiguous(), torch.float32, (M,), dev)

    data = tex.data.detach().contiguous()
    if data.dim() != 4 or data.shape[3] != 3:
        raise ValueError(f"K5 reads RGB textures (T, H, W, 3), got {tuple(data.shape)}")
    T = data.shape[0]
    a.tex_data = _ptr(keep, "textures.data", data, torch.float32, tuple(data.shape), dev)
    a.tex_size = _ptr(keep, "textures.size", tex.size, torch.int32, (T, 2), dev)
    a.tex_h, a.tex_w = data.shape[1], data.shape[2]

    E = em.radiance.shape[0]
    a.radiance = _ptr(keep, "emitters.radiance", em.radiance.detach().contiguous(), torch.float32,
                      (E, 3), dev)
    a.n_emitters = E
    EF = em.em_face_packed.shape[0]
    a.n_em_faces = EF
    a.em_packed = _ptr(keep, "emitters.em_face_packed", em.em_face_packed, torch.float32,
                       (EF, 16), dev)
    a.face_cdf = _ptr(keep, "emitters.face_dist.cdf", em.face_dist.cdf, torch.float32, (EF,),
                      dev)
    he, we = em.env_map.shape[:2]
    a.env_h, a.env_w, a.has_env_map = he, we, int(_has_env_map(em))
    a.env_map = _ptr(keep, "emitters.env_map", em.env_map, torch.float32, (he, we, 3), dev)
    ed = em.env_dist
    a.env_weights = _ptr(keep, "env_dist.weights", ed.weights, torch.float32, (he, we), dev)
    a.env_row_cdf = _ptr(keep, "env_dist.row_cdf", ed.row_cdf, torch.float32, (he,), dev)
    a.env_col_cdf = _ptr(keep, "env_dist.col_cdf", ed.col_cdf, torch.float32, (he, we), dev)


def _check_cuda(packed: Packed):
    dev = torch.device("cuda") if not packed.keep else packed.keep[0].device
    if dev.type != "cuda":
        raise ValueError(f"K5 needs CUDA tensors, got {dev}")
    return dev


@spanned("m3t.k5.forward")
def replay_forward(packed: Packed):
    """Forward kernel launch: L (N, 3) float32 of the packed chunk."""
    global forward_launches
    dev = _check_cuda(packed)
    a = packed.args
    L = torch.empty((a.n_rows, 3), dtype=torch.float32, device=dev)
    a.L = L.data_ptr()
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.m3t_replay_forward(ctypes.byref(a), stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"K5 forward launch failed: CUDA error {rc}")
    if a.n_rows:
        forward_launches += 1
    count("m3t.k5.rows", int(a.n_rows))
    return L


def shared_fits(n_mats: int, n_emitters: int) -> bool:
    """Whether the adjoint sums the tables in a block's shared memory."""
    return 3 * (n_mats + n_emitters) * 4 <= LIBRARY.load().m3t_replay_max_shared()


@spanned("m3t.k5.adjoint")
def replay_adjoint(packed: Packed, dL, shared: bool | None = None, out=None, scratch=None):
    """Adjoint kernel launch: (d base_color (M, 3), d radiance (E, 3)) of
    sum(L * dL) over the packed chunk.  `shared` (default: whether the
    tables fit in shared memory) picks the kernel's table accumulation.
    `out`, a pair of float32 buffers of those shapes, takes the gradients
    added to what it holds (the kernel adds; new zeroed buffers without
    it); `scratch`, (depth, 6, rows) float32, the kernel's per-vertex
    scratch (a new one without it)."""
    global adjoint_launches
    dev = _check_cuda(packed)
    a = packed.args
    dL = dL.detach().to(torch.float32).contiguous()
    check_tensor("dL", dL, torch.float32, (a.n_rows, 3), dev)
    a.dL = dL.data_ptr()
    if out is None:
        out = (torch.zeros((a.n_mats, 3), dtype=torch.float32, device=dev),
               torch.zeros((a.n_emitters, 3), dtype=torch.float32, device=dev))
    d_bc, d_rad = out
    check_tensor("d_base_color", d_bc, torch.float32, (a.n_mats, 3), dev)
    check_tensor("d_radiance", d_rad, torch.float32, (a.n_emitters, 3), dev)
    if scratch is None:
        scratch = torch.empty((a.depth, 6, a.n_rows), dtype=torch.float32, device=dev)
    check_tensor("scratch", scratch, torch.float32, (a.depth, 6, a.n_rows), dev)
    packed.out = (dL, d_bc, d_rad, scratch)   # this launch's own buffers
    a.d_base_color, a.d_radiance, a.scratch = d_bc.data_ptr(), d_rad.data_ptr(), \
        scratch.data_ptr()
    a.shared_tables = int(shared_fits(a.n_mats, a.n_emitters) if shared is None else shared)
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.m3t_replay_adjoint(ctypes.byref(a), stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"K5 adjoint launch failed: CUDA error {rc}")
    if a.n_rows:
        adjoint_launches += 1
    return d_bc, d_rad
