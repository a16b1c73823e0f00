"""Counter-based RNG: u = hash(seed, lane, dim).

Counterpart of ``mitsuba3_experiments_tpu.core.rng``; every sample is a pure
function of (seed, lane index, dimension counter), so an estimate can be
compared with the JAX package's ray by ray, and lanes may be reordered or
compacted freely.

torch's uint32 has thin operator support (worst on CUDA), so the uint32
arithmetic runs in int64 and is masked back to 32 bits with ``& 0xFFFFFFFF``:
products of two 32-bit values stay below 2**63, and the low 32 bits of a sum,
product, xor or left shift only depend on the low 32 bits of the operands.
The functions take int64 tensors or Python ints alike; the bits equal JAX's.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device

MASK32 = 0xFFFFFFFF


def tea32(v0, v1, rounds: int = 4):
    """TEA block mix of two uint32 streams -> (uint32, uint32)."""
    v0 = v0 & MASK32
    v1 = v1 & MASK32
    s = 0
    for _ in range(rounds):
        s = (s + 0x9E3779B9) & MASK32
        v0 = (v0 + (((v1 << 4) + 0xA341316C) ^ (v1 + s) ^ ((v1 >> 5) + 0xC8013EA4))) & MASK32
        v1 = (v1 + (((v0 << 4) + 0xAD90777D) ^ (v0 + s) ^ ((v0 >> 5) + 0x7E95761E))) & MASK32
    return v0, v1


def pcg_hash(x):
    """PCG output permutation of a uint32 (O'Neill 2014 / Jarzynski-Olano)."""
    x = x & MASK32
    state = (x * 747796405 + 2891336453) & MASK32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def uint_to_float01(bits):
    """uint32 (held in int64) -> float32 in [0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Stateless independent sampler over a wavefront of lanes.

    Fields
      seed: Python int, uint32 render seed
      lane: (N,) int64 tensor of global lane indices (uint32 values)
      dim:  Python int dimension counter, advanced by every draw

    `next_1d` / `next_2d` return (new_sampler, sample).  `dim` is one counter
    for the whole wavefront, as in the JAX package, so a lane's samples do
    not depend on which other lanes are still alive.
    """

    seed: int
    lane: torch.Tensor
    dim: int = 0

    @staticmethod
    def create(seed, n: int | None = None, lane=None, device=None):
        if lane is None:
            lane = torch.arange(n, dtype=torch.int64, device=resolve_device(device))
        return Sampler(seed=int(seed) & MASK32, lane=lane.to(torch.int64) & MASK32, dim=0)

    def _draw_bits(self, offset: int):
        k0, k1 = tea32(self.seed, self.dim + offset)
        return pcg_hash(pcg_hash(self.lane ^ k0) + k1)

    def next_1d(self):
        bits = self._draw_bits(0)
        return dataclasses.replace(self, dim=(self.dim + 1) & MASK32), uint_to_float01(bits)

    def next_2d(self):
        b0 = self._draw_bits(0)
        b1 = self._draw_bits(1)
        s = dataclasses.replace(self, dim=(self.dim + 2) & MASK32)
        return s, torch.stack([uint_to_float01(b0), uint_to_float01(b1)], dim=-1)

    def fork(self, salt: int):
        """Decorrelated sampler for a side-channel (e.g. RR decisions)."""
        k0, _ = tea32(self.seed, (salt & MASK32) ^ 0xDEADBEEF)
        return dataclasses.replace(self, seed=k0)


def seed_from_int(seed: int) -> int:
    """A render seed from any Python int: its low 32 bits, as JAX's uint32."""
    return int(seed) & MASK32
