# Frozen copy, at commit aa7dcd9, of chip_smoke.py's K5 work count: the K5_OPS_* operation
# counts, K5_FACE_BYTES, K5_ENTRY_BYTES and k5_work.  Never imported from the port.
"""The float32 operations and bytes that K5's two functions (the replay's
forward and adjoint kernels) need on one replay chunk, counted from the
chunk's record, vertex by vertex.  The yardstick of `k5_roofline`."""
from __future__ import annotations

import numpy as np
import torch

# K5's float32 operations, read off csrc/replay_path.h as it computes them
# (an add, multiply, divide, compare, min/max, sqrt or transcendental counts
# 1; a negation, an absolute value, a select and integer arithmetic 0, so a
# counter-based draw counts 1 for its scale).  A hit vertex: the surface
# interaction 105 and the emission gate 2, on an emitter's face 42 more for
# its MIS and radiance.  A hit short of max_depth also shades: the area
# NEE sample 75 and a compare a step of its binary search, six draws, two
# frame changes, roulette and the next direction 55, the BSDF sample (its
# kind's count below, and 22 of flip and gates), a textured albedo 48, a
# mask's opacity lobe 28; where the light is not occluded and the material
# smooth, the BSDF's evaluation at the NEE direction (its kind's count, and
# 22 of flip, MIS and the sum; a mask 9 more).  The adjoint's derivative
# terms (the suffix sums, the weight's and the value's albedo scales, the
# table sums): 50 a shaded vertex, 85 more on a mask, 6 an emitter hit.
# Kinds: diffuse, conductor, rough conductor, dielectric, rough dielectric,
# plastic, rough plastic, mask (its nested kind's), null, principled.
K5_OPS_SAMPLE = (23, 108, 223, 39, 290, 100, 340, 0, 0, 237)
K5_OPS_EVAL = (11, 4, 222, 4, 184, 87, 231, 0, 4, 158)
K5_OPS_HIT, K5_OPS_EMITTER_HIT, K5_OPS_SHADE = 107, 42, 130
K5_OPS_TEXTURE, K5_OPS_MASK, K5_OPS_MASK_EVAL = 48, 28, 9
K5_OPS_SAMPLE_COMMON, K5_OPS_EVAL_COMMON = 22, 22
K5_OPS_DERIV, K5_OPS_DERIV_MASK, K5_OPS_DERIV_EMITTER = 50, 85, 6
K5_FACE_BYTES = 29 * 4    # the face row's floats that _make_si reads
K5_ENTRY_BYTES = 13       # a record entry: prim, u, v (4 bytes each) and occl (1)


def k5_work(scene, sl, kw):
    """The float32 operations and bytes that K5's two functions need on a
    chunk, counted from its record: the forward walks each row's path once
    for L; the adjoint walks it once more and adds the derivative terms.
    Each vertex is charged its own material's kind (the nested one under a
    mask), texture, emitter and NEE, as K5_OPS_* count them.  Each function
    reads the record entries of the hit vertices, the face rows they hit
    (distinct faces), the rows' ray indices when sorted and L or dL; the
    adjoint writes the two tables.  The escapes (at most one a row), the
    material, texture and emitter tables are left out, which only lowers
    the bound.  Returns (hit vertices, distinct faces, operations, bytes)."""
    rows, D = sl.prim.shape
    steps = kw.get("n_steps") or D
    ids = kw["idx"] if kw.get("idx") is not None else \
        torch.arange(rows, device=sl.prim.device) + kw["idx0"]
    prim = sl.prim[:, :steps]
    hit = (prim >= 0) & (ids < kw["ray_end"])[:, None]
    col = torch.nonzero(hit)[:, 1]
    faces = prim[hit].long()
    frow = scene.geometry.face_packed[faces]
    mat = frow[:, 25].contiguous().view(torch.int32).long().clamp(min=0)
    emitter = frow[:, 26].contiguous().view(torch.int32) >= 0
    mats = scene.materials
    is_mask = mats.kind[mat] == 7
    eff = torch.where(is_mask, mats.nested_id[mat].long().clamp(min=0), mat)
    kind = mats.kind[eff].long()
    shaded = col + 1 < kw["max_depth"]
    nee = shaded & ((mats.flags[mat] & 15) != 0) & ~sl.occl[:, :steps][hit]
    textured = (mats.tex_id[eff] >= 0).long() + (is_mask & (mats.tex_id[mat] >= 0)).long()
    ops_of = lambda t: torch.tensor(t, dtype=torch.int64, device=kind.device)[kind]  # noqa: E731
    search = int(np.ceil(np.log2(scene.emitters.em_face_packed.shape[0] + 1)))
    walk = K5_OPS_HIT + emitter * K5_OPS_EMITTER_HIT + shaded * (
        K5_OPS_SHADE + search + K5_OPS_SAMPLE_COMMON + ops_of(K5_OPS_SAMPLE)
        + textured * K5_OPS_TEXTURE + is_mask * K5_OPS_MASK) + nee * (
        K5_OPS_EVAL_COMMON + ops_of(K5_OPS_EVAL) + is_mask * K5_OPS_MASK_EVAL)
    deriv = shaded * (K5_OPS_DERIV + is_mask * K5_OPS_DERIV_MASK) + emitter * K5_OPS_DERIV_EMITTER
    ops = int((2 * walk + deriv).sum())
    hits, distinct = int(faces.numel()), int(torch.unique(faces).numel())
    per_kernel = hits * K5_ENTRY_BYTES + distinct * K5_FACE_BYTES + rows * 12 \
        + (rows * 8 if kw.get("idx") is not None else 0)
    tables = (mats.base_color.shape[0] + scene.emitters.radiance.shape[0]) * 12
    return hits, distinct, ops, 2 * per_kernel + tables
