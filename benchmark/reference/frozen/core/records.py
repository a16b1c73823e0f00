# Frozen copy of mitsuba3_experiments_tpu_torch/core/records.py at commit aa7dcd9, part of the
# benchmark's plain reference; imported from benchmark/reference only, never from the port.
"""Interaction records: frozen dataclasses of tensors.

Counterpart of ``mitsuba3_experiments_tpu.core.records``.  Every field
has the leading wavefront shape (N,); vectors are (N, 3).  ``twhere`` and
``trepeat`` live in ``core/struct.py`` and are imported here too.
"""
from __future__ import annotations

import dataclasses

import torch

from . import math as m
from .struct import trepeat, twhere  # noqa: F401


class BSDFFlags:
    Empty = 0
    DiffuseReflection = 1 << 0
    DiffuseTransmission = 1 << 1
    GlossyReflection = 1 << 2
    GlossyTransmission = 1 << 3
    DeltaReflection = 1 << 4
    DeltaTransmission = 1 << 5
    Null = 1 << 6
    BackSide = 1 << 7
    FrontSide = 1 << 8

    Diffuse = DiffuseReflection | DiffuseTransmission
    Glossy = GlossyReflection | GlossyTransmission
    Smooth = Diffuse | Glossy
    Delta = DeltaReflection | DeltaTransmission
    Reflection = DiffuseReflection | GlossyReflection | DeltaReflection
    Transmission = DiffuseTransmission | GlossyTransmission | DeltaTransmission
    All = Smooth | Delta | Null


def has_flag(flags, bit):
    return (flags & bit) != 0


@dataclasses.dataclass(frozen=True)
class Ray:
    """o + t*d for t in (0, maxt)."""

    o: torch.Tensor       # (N, 3)
    d: torch.Tensor       # (N, 3), unit
    maxt: torch.Tensor    # (N,)

    @staticmethod
    def make(o, d, maxt=None):
        if maxt is None:
            maxt = torch.full(o.shape[:-1], m.INF, dtype=m.Float, device=o.device)
        return Ray(o=o, d=d, maxt=maxt)


@dataclasses.dataclass(frozen=True)
class SurfaceInteraction:
    """Hit record. Invalid lanes have t = inf and prim_idx = -1.

    wi is the incident direction in the shading frame; sh_* span the shading
    frame; n is the geometric normal.
    """

    t: torch.Tensor         # (N,)
    p: torch.Tensor         # (N, 3)
    n: torch.Tensor         # (N, 3) geometric normal
    sh_n: torch.Tensor      # (N, 3) shading normal
    sh_s: torch.Tensor      # (N, 3) shading tangent
    sh_t: torch.Tensor      # (N, 3) shading bitangent
    uv: torch.Tensor        # (N, 2)
    wi: torch.Tensor        # (N, 3) local incident dir (towards camera)
    prim_idx: torch.Tensor  # (N,) int32 triangle index, -1 invalid
    mat_id: torch.Tensor    # (N,) int32 material row, -1 invalid
    emitter_id: torch.Tensor  # (N,) int32 emitter row, -1 none

    @staticmethod
    def invalid(n: int, device=None):
        """n missed lanes (the record before a path's first hit)."""
        z3 = torch.zeros((n, 3), dtype=m.Float, device=device)

        def axis(k):
            v = z3.clone()
            v[:, k] = 1.0
            return v

        def ids():
            return torch.full((n,), -1, dtype=torch.int32, device=device)

        return SurfaceInteraction(
            t=torch.full((n,), m.INF, dtype=m.Float, device=device), p=z3, n=axis(2),
            sh_n=axis(2), sh_s=axis(0), sh_t=axis(1),
            uv=torch.zeros((n, 2), dtype=m.Float, device=device), wi=axis(2),
            prim_idx=ids(), mat_id=ids(), emitter_id=ids(),
        )

    @property
    def valid(self):
        return torch.isfinite(self.t)

    def to_local(self, v_world):
        return m.to_local(self.sh_s, self.sh_t, self.sh_n, v_world)

    def to_world(self, v_local):
        return m.to_world(self.sh_s, self.sh_t, self.sh_n, v_local)

    @property
    def wi_world(self):
        return self.to_world(self.wi)

    def spawn_ray(self, d_world):
        """Offset the origin along the geometric normal (si.spawn_ray)."""
        sign = m.sign_not_zero(m.dot(self.n, d_world))
        o = self.p + self.n * (sign * m.RAY_EPS).unsqueeze(-1)
        return Ray.make(o, d_world)

    def spawn_ray_to(self, p_target):
        d = p_target - self.p
        dist = m.norm(d)
        d = d * m.safe_rcp(dist).unsqueeze(-1)
        sign = m.sign_not_zero(m.dot(self.n, d))
        o = self.p + self.n * (sign * m.RAY_EPS).unsqueeze(-1)
        maxt = dist * (1.0 - 1e-3) - m.RAY_EPS
        return Ray(o=o, d=d, maxt=maxt)


@dataclasses.dataclass(frozen=True)
class DirectionSample:
    """Emitter direction sample: position p/n on the emitter, direction d
    from the reference point, solid-angle pdf."""

    p: torch.Tensor          # (N, 3)
    n: torch.Tensor          # (N, 3)
    d: torch.Tensor          # (N, 3) unit, ref -> emitter
    dist: torch.Tensor       # (N,)
    pdf: torch.Tensor        # (N,) solid-angle density (incl. pick prob)
    delta: torch.Tensor      # (N,) bool
    emitter_id: torch.Tensor  # (N,) int32


@dataclasses.dataclass(frozen=True)
class BSDFSample:
    """wo in the local frame, pdf, relative IOR eta, sampled lobe flags."""

    wo: torch.Tensor            # (N, 3) local
    pdf: torch.Tensor           # (N,)
    eta: torch.Tensor           # (N,)
    sampled_type: torch.Tensor  # (N,) int32 BSDFFlags of the sampled lobe


@dataclasses.dataclass(frozen=True)
class PositionSample:
    """A sampled point on a surface with its area density."""

    p: torch.Tensor         # (N, 3)
    n: torch.Tensor         # (N, 3)
    uv: torch.Tensor        # (N, 2)
    pdf: torch.Tensor       # (N,) area density
    prim_idx: torch.Tensor  # (N,) int32
