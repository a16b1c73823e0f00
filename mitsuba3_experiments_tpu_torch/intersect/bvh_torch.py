"""8-wide BVH traversal: scene.ray_intersect / ray_test.

Counterpart of ``mitsuba3_experiments_tpu.intersect.bvh_jax``.  `traverse`
dispatches on the device of the rays:

  * a CPU tensor goes to `traverse_plain`, the line-for-line torch version
    of the JAX package's lockstep ``_traverse``: all rays step together in a
    Python loop, one unified-table row fetch per step, the stack held as a
    shift register (top = column 0);
  * a CUDA tensor goes to the hand-written kernel (intersect/bvh_cuda.py),
    or the call raises.  Nothing falls back from one to the other.

`traverse_plain` runs on any device; the GPU smoke test calls it directly
on CUDA tensors to hold the kernel against it.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.records import Ray, SurfaceInteraction
from ..scene.bvh8 import DEFAULT_LAYOUT
from ..scene.types import Scene
from ..utils.profile import count, span
from . import bvh_cuda
from .triangle import cross_fma, dot_fma, intersect_tri

DONE = -1  # shared with the "empty child" code

# plain traversals run; the table rows they fetched for live rays, and how
# many of those were leaf rows; the distinct rows the last traversal
# fetched (plain ints, read by the smoke test, which turns them into K1's
# least time on the card; kept on the device as one fetch count per row and
# read once, when the traversal ends)
calls = 0
rows = 0
leaf_rows = 0
last_distinct_rows = 0


def _tri_test9(o, d, g9, t_best):
    """Moller-Trumbore against a packed (N, 9) [v0|v1|v2] row, with the
    fused dot/cross products of triangle.py."""
    v0 = g9[:, 0:3]
    e1 = g9[:, 3:6] - v0
    e2 = g9[:, 6:9] - v0
    pvec = cross_fma(d, e2)
    det = dot_fma(e1, pvec)
    inv_det = m.safe_div(1.0, det)
    tvec = o - v0
    u = dot_fma(tvec, pvec) * inv_det
    qvec = cross_fma(tvec, e1)
    v = dot_fma(d, qvec) * inv_det
    t = dot_fma(e2, qvec) * inv_det
    hit = (
        (torch.abs(det) > 1e-10)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > 0.0) & (t < t_best)
    )
    return t, u, v, hit


def traverse_plain(unified, n_nodes: int, o, d, maxt, active,
                   any_hit: bool = False, layout=None):
    """Returns (t, face, u, v) with face == -1 and t == inf for misses."""
    global calls, rows, leaf_rows, last_distinct_rows
    calls += 1
    lay = layout if layout is not None else DEFAULT_LAYOUT
    WIDTH, LEAF_CAP, STACK_DEPTH = lay.width, lay.leaf_cap, lay.stack
    NODE_BASE, FACE_OFF, LEAF_ROW = lay.node_base, lay.face_off, lay.leaf_row
    n = o.shape[0]
    dev = o.device
    i32 = torch.int32
    inv_d = m.safe_div(1.0, d, fill=m.INF)

    t_best = torch.where(active, maxt, 0.0)
    face_best = torch.full((n,), -1, dtype=i32, device=dev)
    u_best = torch.zeros((n,), dtype=m.Float, device=dev)
    v_best = torch.zeros((n,), dtype=m.Float, device=dev)

    # code: >=0 internal row; -1 DONE; <=-2 leaf row (-code-2)
    cur = torch.where(active, 0, DONE).to(i32)
    stack = torch.zeros((n, STACK_DEPTH), dtype=i32, device=dev)
    sp = torch.zeros((n,), dtype=i32, device=dev)
    ki = torch.arange(WIDTH, dtype=i32, device=dev)
    done_col = torch.full((n, 1), DONE, dtype=i32, device=dev)
    fetches = torch.zeros((unified.shape[0],), dtype=torch.int64, device=dev)

    while bool((cur != DONE).any()):
        live = cur != DONE
        is_int = cur >= 0
        is_leaf = cur <= -2

        # ----------- one unified row fetch; internal view: slabs ----------
        row_idx = torch.where(is_int, cur, n_nodes + torch.where(is_leaf, -cur - 2, 0))
        fetches.index_add_(0, row_idx.long(), live.to(torch.int64))
        row = unified[row_idx.long()]                       # (N, 88)
        codes = row[:, 0:WIDTH].contiguous().view(i32)
        bb = row[:, NODE_BASE: NODE_BASE + 6 * WIDTH].reshape(n, WIDTH, 6)
        t0 = (bb[:, :, 0:3] - o[:, None, :]) * inv_d[:, None, :]
        t1 = (bb[:, :, 3:6] - o[:, None, :]) * inv_d[:, None, :]
        tmin = torch.minimum(t0, t1)
        tmax = torch.maximum(t0, t1)
        t_near = torch.amax(tmin, dim=-1)                   # (N, 8)
        t_far = torch.amin(tmax, dim=-1)
        hit = (
            (t_near <= t_far * 1.00000024) & (t_far > 0.0)
            & (t_near < t_best[:, None]) & (codes != DONE)
            & is_int[:, None]
        )

        t_sort = torch.where(hit, t_near, m.INF)
        k_near = torch.argmin(t_sort, dim=-1)               # first minimum
        any_child = hit.any(dim=-1)
        onehot_near = ki[None, :] == k_near[:, None]
        near_code = torch.where(onehot_near, codes, 0).sum(dim=-1).to(i32)

        # push the remaining hit children far-to-near (top = nearest), the
        # order being a rank from an 8x8 pairwise compare
        push_mask = hit & ~onehot_near                      # (N, 8)
        n_push = push_mask.sum(dim=-1).to(i32)
        if any_hit:
            # occlusion query: push order is irrelevant — slot order
            pm = push_mask.to(i32)
            rank_far = torch.cumsum(pm, dim=-1).to(i32) - pm
        else:
            tp = torch.where(push_mask, t_near, -m.INF)
            farther = (
                (tp[:, None, :] > tp[:, :, None])
                | ((tp[:, None, :] == tp[:, :, None])
                   & (ki[None, None, :] > ki[None, :, None]))
            ) & push_mask[:, None, :]
            rank_far = farther.sum(dim=-1).to(i32)

        # --------------- leaf view of the same fetched row ----------------
        frow = row[:, FACE_OFF:LEAF_ROW].contiguous().view(i32)
        for k in range(LEAF_CAP):
            t, u, v, h = _tri_test9(o, d, row[:, 9 * k: 9 * k + 9], t_best)
            ok = is_leaf & h & (frow[:, k] >= 0)
            t_best = torch.where(ok, t, t_best)
            face_best = torch.where(ok, frow[:, k], face_best)
            u_best = torch.where(ok, u, u_best)
            v_best = torch.where(ok, v, v_best)

        if any_hit:
            early_done = is_leaf & (face_best >= 0)
        else:
            early_done = torch.zeros_like(is_leaf)

        # ------------------------- pop / descend --------------------------
        descend = is_int & any_child
        want_pop = live & ~early_done & ~descend
        can_pop = want_pop & (sp > 0)
        popped = torch.where(sp > 0, stack[:, 0], DONE)
        nxt = torch.where(descend, near_code, torch.where(want_pop, popped, DONE))
        nxt = torch.where(live & ~early_done, nxt, DONE).to(i32)
        # a push past the stack depth ends the ray with face OVERFLOW, as
        # in the kernel (collapse_to_wide's tables never do)
        over = descend & (sp + n_push > STACK_DEPTH)
        face_best = torch.where(over, bvh_cuda.OVERFLOW, face_best)
        nxt = torch.where(over, DONE, nxt)
        sp_new = torch.where(descend, sp + n_push, torch.where(can_pop, sp - 1, sp))
        sp_new = torch.where(nxt == DONE, 0, sp_new).to(i32)

        # shift-register update: right by n_push on descend, left on pop
        shift = torch.where(descend, n_push, 0) - can_pop.to(i32)
        res = torch.where(
            (shift == -1)[:, None], torch.cat([stack[:, 1:], done_col], dim=1), stack
        )
        for s in range(1, WIDTH):
            shifted = torch.cat(
                [torch.zeros((n, s), dtype=i32, device=dev), stack[:, : STACK_DEPTH - s]],
                dim=1,
            )
            res = torch.where((shift == s)[:, None], shifted, res)
        # insert pushed codes at columns 0..n_push-1, nearest at column 0
        head = res[:, :WIDTH]
        for k in range(WIDTH):
            colk = (n_push - 1 - rank_far[:, k])[:, None]
            mk = (push_mask[:, k] & descend)[:, None]
            head = torch.where((ki[None, :] == colk) & mk, codes[:, k: k + 1], head)
        stack = torch.cat([head, res[:, WIDTH:]], dim=1)
        cur, sp = nxt, sp_new

    n_rows, n_leaf, last_distinct_rows = torch.stack(
        [fetches.sum(), fetches[n_nodes:].sum(), (fetches > 0).sum()]).tolist()
    rows += n_rows
    leaf_rows += n_leaf
    bvh_cuda.check_overflow(face_best, STACK_DEPTH)
    t_out = torch.where(face_best >= 0, t_best, m.INF)
    return t_out, face_best, u_best, v_best


def traverse(unified, n_nodes: int, o, d, maxt, active, any_hit: bool = False,
             layout=None):
    """(t, face, u, v) for the rays: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    if o.device.type == "cuda":
        return bvh_cuda.traverse_cuda(
            unified, n_nodes, o, d, maxt, active, any_hit=any_hit, layout=layout
        )
    if o.device.type == "cpu":
        return traverse_plain(unified, n_nodes, o, d, maxt, active, any_hit, layout)
    raise ValueError(f"no traversal for device {o.device}")


# Scenes at or below this many triangle slots skip the BVH: a dense
# all-triangles test is cheaper for tiny scenes.
BRUTE_FORCE_MAX_SLOTS = 64


def _layout(scene):
    return scene.bvh.layout or DEFAULT_LAYOUT


def _n_tri_slots(scene):
    return scene.bvh.leaf_tris.shape[0] * _layout(scene).leaf_cap


def _query(scene, ray, active, any_hit):
    """One traversal (K1 launch on the card) over the rays, in the span
    `m3t.k1`, its rays counted by `m3t.k1.rays`."""
    b = scene.bvh
    count("m3t.k1.rays", ray.o.shape[0])
    with span("m3t.k1"):
        return traverse(
            b.unified, b.nodes.shape[0], ray.o.contiguous(), ray.d.contiguous(),
            ray.maxt.contiguous(), active.contiguous(), any_hit, layout=b.layout,
        )


def ray_intersect(scene: Scene, ray: Ray, active=None) -> SurfaceInteraction:
    """Closest-hit query returning a full SurfaceInteraction."""
    if active is None:
        active = torch.ones(ray.o.shape[:1], dtype=torch.bool, device=ray.o.device)
    if _n_tri_slots(scene) <= BRUTE_FORCE_MAX_SLOTS:
        return ray_intersect_brute(scene, ray, active)
    t, face, u, v = _query(scene, ray, active, False)
    return _make_si(scene, ray, t, face, u, v)


def ray_test(scene: Scene, ray: Ray, active=None):
    """Any-hit (shadow) query: True where the segment (0, maxt) is occluded."""
    if active is None:
        active = torch.ones(ray.o.shape[:1], dtype=torch.bool, device=ray.o.device)
    if _n_tri_slots(scene) <= BRUTE_FORCE_MAX_SLOTS:
        return ray_intersect_brute(scene, ray, active).prim_idx >= 0
    _, face, _, _ = _query(scene, ray, active, True)
    return face >= 0


def ray_intersect_brute(scene: Scene, ray: Ray, active=None) -> SurfaceInteraction:
    """Oracle path: test every packed triangle slot."""
    if active is None:
        active = torch.ones(ray.o.shape[:1], dtype=torch.bool, device=ray.o.device)
    b = scene.bvh
    cap = _layout(scene).leaf_cap
    L = b.leaf_tris.shape[0]
    tris = b.leaf_tris[:, : 9 * cap].reshape(L * cap, 3, 3)
    faces_flat = b.leaf_face.reshape(-1)
    maxt = torch.where(active, ray.maxt, 0.0)
    t, u, v, hit = intersect_tri(ray.o, ray.d, tris, maxt)
    t = torch.where((faces_flat >= 0)[None, :], t, m.INF)
    k = torch.argmin(t, dim=-1)
    tb = torch.gather(t, 1, k[:, None])[:, 0]
    face = torch.where(torch.isfinite(tb), faces_flat[k], -1)
    ub = torch.gather(u, 1, k[:, None])[:, 0]
    vb = torch.gather(v, 1, k[:, None])[:, 0]
    return _make_si(scene, ray, torch.where(face >= 0, tb, m.INF), face, ub, vb)


def _const3(v, like):
    # a copy from the host that waits for the device on the card
    with span("m3t.wait"):
        return torch.tensor(v, dtype=m.Float, device=like.device)


def _make_si(scene: Scene, ray: Ray, t, face, u, v, return_row: bool = False):
    """Assemble the SurfaceInteraction from a hit (global face id): one row
    fetch from Geometry.face_packed.

    A lane without a hit fetches row `lane % F` (its fields are discarded),
    as in the JAX package, so that misses do not all read one row.
    `return_row=True` also returns the fetched (N, 32) row, whose columns
    27 (emitter pmf) and 28 (area) feed pdf_emitter_direction_packed."""
    g = scene.geometry
    valid = face >= 0
    spread = torch.arange(face.shape[0], device=face.device) % g.face_packed.shape[0]
    row = g.face_packed[torch.where(valid, face.long(), spread)]     # (N, 32)
    v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    p = v0 + e1 * u[:, None] + v[:, None] * e2
    ng = m.normalize(m.cross(e1, e2))

    flat = row[:, 24] > 0.5
    n0, n1, n2 = row[:, 9:12], row[:, 12:15], row[:, 15:18]
    ns = m.normalize(n0 * (1.0 - u - v)[:, None] + n1 * u[:, None] + n2 * v[:, None])
    ns = torch.where(flat[:, None], ng, ns)
    # keep the shading normal in the hemisphere of the geometric one
    ns = torch.where(m.dot(ns, ng)[:, None] < 0.0, -ns, ns)

    uv0, uv1, uv2 = row[:, 18:20], row[:, 20:22], row[:, 22:24]
    uv = uv0 * (1.0 - u - v)[:, None] + uv1 * u[:, None] + uv2 * v[:, None]

    sh_s, sh_t = m.coordinate_system(ns)
    wi = m.to_local(sh_s, sh_t, ns, -ray.d)

    mat_id = row[:, 25].contiguous().view(torch.int32)
    emitter_id = row[:, 26].contiguous().view(torch.int32)

    inval = (~valid)[:, None]
    z, x, y = _const3((0.0, 0.0, 1.0), t), _const3((1.0, 0.0, 0.0), t), _const3((0.0, 1.0, 0.0), t)
    si = SurfaceInteraction(
        t=torch.where(valid, t, m.INF),
        p=torch.where(inval, 0.0, p),
        n=torch.where(inval, z, ng),
        sh_n=torch.where(inval, z, ns),
        sh_s=torch.where(inval, x, sh_s),
        sh_t=torch.where(inval, y, sh_t),
        uv=torch.where(inval, 0.0, uv),
        wi=torch.where(inval, z, wi),
        prim_idx=torch.where(valid, face, -1).to(torch.int32),
        mat_id=torch.where(valid, mat_id, -1).to(torch.int32),
        emitter_id=torch.where(valid, emitter_id, -1).to(torch.int32),
    )
    return (si, row) if return_row else si
