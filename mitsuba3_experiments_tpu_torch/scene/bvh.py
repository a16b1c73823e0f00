"""BVH construction: binned SAH, object-split or spatial-split (SBVH).

As in ``mitsuba3_experiments_tpu.scene.bvh``: the binary tree comes from the
C++ builders (scene/native.py, compiled from native/*.cpp) — the
spatial-split build when the layout asks for it (the default), else the
object-split build — and is collapsed into the 8-wide packed rows of
scene/bvh8.py.  A spatial split may put one triangle into several leaves,
so the leaf tables hold references: a face id may repeat.

`_build_bvh_numpy` is the JAX package's vectorized numpy binned SAH (16
bins, surface-area heuristic with leaf cost, per BFS level), kept as the
plain reference of the object-split builder.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .types import BVH

N_BINS = 16
MAX_DEPTH = 40


def _aabb_area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def build_bvh(
    vertices: np.ndarray, faces: np.ndarray, leaf_size: int | None = None,
    layout=None, device=None,
) -> BVH:
    """Build the packed 8-wide BVH (types.BVH) with its tables on `device`
    (None: the card).

    Pipeline: binary binned SAH in C++ (spatial splits with
    layout.sbvh_alpha when layout.sbvh, else object splits) -> 8-wide
    collapse + row packing (scene/bvh8.py).  `layout` (bvh8.BVHLayout)
    selects width/leaf_cap/collapse/SBVH; None = bvh8.DEFAULT_LAYOUT.
    leaf_size defaults to (and must not exceed) layout.leaf_cap.
    """
    from .bvh8 import DEFAULT_LAYOUT, collapse_to_wide
    from .native import build_bvh_native, build_sbvh_native

    lay = layout if layout is not None else DEFAULT_LAYOUT
    if leaf_size is None:
        leaf_size = lay.leaf_cap
    if leaf_size > lay.leaf_cap:
        raise ValueError(f"leaf_size {leaf_size} > leaf_cap {lay.leaf_cap}")

    if lay.sbvh:
        tree = build_sbvh_native(vertices, faces, leaf_size, alpha=lay.sbvh_alpha)
    else:
        tree = build_bvh_native(vertices, faces, leaf_size)
    lo, hi, left, right, first, count, order, _ = tree
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int64)
    tv_flat = v[f[order]].reshape(len(order), 9).astype(np.float32)
    nodes, leaf_tris, leaf_face = collapse_to_wide(
        lo, hi, left, right, first, count, order, tv_flat,
        order.astype(np.int32), layout=lay,
    )
    # unified row width = max of node/leaf rows; both pad at the END so the
    # decode offsets hold
    uw = max(nodes.shape[1], leaf_tris.shape[1])
    nodes_pad = np.zeros((nodes.shape[0], uw), np.float32)
    nodes_pad[:, : nodes.shape[1]] = nodes
    leafs_pad = np.zeros((leaf_tris.shape[0], uw), np.float32)
    leafs_pad[:, : leaf_tris.shape[1]] = leaf_tris
    unified = np.concatenate([nodes_pad, leafs_pad], axis=0)
    device = resolve_device(device)
    return BVH(
        nodes=torch.as_tensor(nodes, device=device),
        leaf_tris=torch.as_tensor(leaf_tris, device=device),
        leaf_face=torch.as_tensor(leaf_face, device=device),
        unified=torch.as_tensor(unified, device=device),
        layout=lay,
    )


def _build_bvh_numpy(vertices: np.ndarray, faces: np.ndarray,
                     leaf_size: int = 8):
    """Returns raw binary arrays (lo, hi, left, right, first, count, order)."""
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int64)
    F = f.shape[0]
    tri = v[f]
    prim_lo = tri.min(axis=1).astype(np.float64)
    prim_hi = tri.max(axis=1).astype(np.float64)
    cent = 0.5 * (prim_lo + prim_hi)

    # prim order array; nodes own contiguous ranges [start, end)
    order = np.arange(F, dtype=np.int64)

    # node storage (grown in chunks)
    cap = max(4 * F // leaf_size, 16)
    n_lo = np.zeros((cap, 3), np.float64)
    n_hi = np.zeros((cap, 3), np.float64)
    n_left = np.full(cap, -1, np.int64)
    n_right = np.full(cap, -1, np.int64)
    n_first = np.zeros(cap, np.int64)
    n_count = np.zeros(cap, np.int64)
    n_nodes = 1
    n_first[0], n_count[0] = 0, F

    def grow(need):
        nonlocal cap, n_lo, n_hi, n_left, n_right, n_first, n_count
        if need <= cap:
            return
        cap = max(need, 2 * cap)
        n_lo = np.resize(n_lo, (cap, 3))
        n_hi = np.resize(n_hi, (cap, 3))
        n_left = np.resize(n_left, cap)
        n_right = np.resize(n_right, cap)
        n_first = np.resize(n_first, cap)
        n_count = np.resize(n_count, cap)

    active = np.array([0], np.int64)  # node ids to process this level
    for depth in range(MAX_DEPTH):
        if len(active) == 0:
            break
        K = len(active)
        starts = n_first[active]
        counts = n_count[active]
        # per-prim local node id (0..K-1) for prims in active nodes;
        # gather indices built vectorized: arange within each range
        P = int(counts.sum())
        seg_node = np.repeat(np.arange(K), counts)
        excl = np.concatenate([[0], np.cumsum(counts)[:-1]])
        seg_pos = (
            np.arange(P, dtype=np.int64) - excl[seg_node] + starts[seg_node]
        )
        seg_prims = order[seg_pos]

        c = cent[seg_prims]                      # (P, 3)
        plo = prim_lo[seg_prims]
        phi = prim_hi[seg_prims]

        # node geometric + centroid bounds via segment min/max
        def seg_min(x):
            out = np.full((K, x.shape[1]), np.inf)
            np.minimum.at(out, seg_node, x)
            return out

        def seg_max(x):
            out = np.full((K, x.shape[1]), -np.inf)
            np.maximum.at(out, seg_node, x)
            return out

        g_lo = seg_min(plo)
        g_hi = seg_max(phi)
        c_lo = seg_min(c)
        c_hi = seg_max(c)
        n_lo[active] = g_lo
        n_hi[active] = g_hi

        ext = np.maximum(c_hi - c_lo, 1e-12)
        # bin index per prim per axis
        rel = np.clip((c - c_lo[seg_node]) / ext[seg_node], 0.0, 1.0 - 1e-7)
        bins = (rel * N_BINS).astype(np.int64)    # (P, 3)

        # per (node, axis, bin): count + bounds
        key = (seg_node[:, None] * 3 + np.arange(3)[None, :]) * N_BINS + bins
        key_flat = key.reshape(-1)                # (P*3,)
        cnt = np.bincount(key_flat, minlength=K * 3 * N_BINS).reshape(K, 3, N_BINS)
        b_lo = np.full((K * 3 * N_BINS, 3), np.inf)
        b_hi = np.full((K * 3 * N_BINS, 3), -np.inf)
        plo3 = np.repeat(plo, 3, axis=0)
        phi3 = np.repeat(phi, 3, axis=0)
        np.minimum.at(b_lo, key_flat, plo3)
        np.maximum.at(b_hi, key_flat, phi3)
        b_lo = b_lo.reshape(K, 3, N_BINS, 3)
        b_hi = b_hi.reshape(K, 3, N_BINS, 3)

        # SAH sweep: prefix (left) and suffix (right) accumulations over bins
        l_lo = np.minimum.accumulate(b_lo, axis=2)
        l_hi = np.maximum.accumulate(b_hi, axis=2)
        r_lo = np.minimum.accumulate(b_lo[:, :, ::-1], axis=2)[:, :, ::-1]
        r_hi = np.maximum.accumulate(b_hi[:, :, ::-1], axis=2)[:, :, ::-1]
        l_cnt = np.cumsum(cnt, axis=2)
        r_cnt = counts[:, None, None] - l_cnt

        # split after bin b (b in 0..N_BINS-2)
        al = _aabb_area(l_lo[:, :, :-1], l_hi[:, :, :-1])
        ar = _aabb_area(r_lo[:, :, 1:], r_hi[:, :, 1:])
        nl = l_cnt[:, :, :-1]
        nr = r_cnt[:, :, :-1]
        cost = al * nl + ar * nr
        cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
        flat_best = np.argmin(cost.reshape(K, -1), axis=1)
        best_axis = flat_best // (N_BINS - 1)
        best_bin = flat_best % (N_BINS - 1)
        best_cost = cost.reshape(K, -1)[np.arange(K), flat_best]

        # leaf only when small enough (degenerate SAH falls back to a
        # median split below so leaves never exceed leaf_size)
        make_leaf = counts <= leaf_size
        degenerate = ~np.isfinite(best_cost) & ~make_leaf
        if depth == MAX_DEPTH - 1:
            make_leaf[:] = True

        # mark leaves
        leaf_ids = active[make_leaf]
        n_left[leaf_ids] = -1
        n_count[leaf_ids] = counts[make_leaf]   # already set, keep

        split_mask = ~make_leaf
        if not split_mask.any():
            active = np.array([], np.int64)
            continue

        # partition prims of split nodes: stable sort by (node, goes_right)
        node_is_split = split_mask[seg_node]
        axis_of = best_axis[seg_node]
        bin_of_axis = bins[np.arange(P), axis_of]
        goes_right = bin_of_axis > best_bin[seg_node]
        # degenerate nodes: median split by position within the node
        local_pos = np.arange(P, dtype=np.int64) - excl[seg_node]
        deg_of = degenerate[seg_node]
        goes_right = np.where(
            deg_of, local_pos >= (counts[seg_node] // 2), goes_right
        )

        # new child node ids
        split_ids = active[split_mask]
        n_split = len(split_ids)
        grow(n_nodes + 2 * n_split)
        child_base = n_nodes + 2 * np.arange(n_split)
        left_ids = child_base
        right_ids = child_base + 1
        n_left[split_ids] = left_ids
        n_right[split_ids] = right_ids
        n_count[split_ids] = 0
        n_nodes += 2 * n_split

        # reorder prims within each split node's range
        local_split_idx = np.full(K, -1, np.int64)
        local_split_idx[split_mask] = np.arange(n_split)
        sort_key = seg_node * 2 + goes_right
        perm = np.argsort(sort_key[node_is_split], kind="stable")
        seg_sel = np.nonzero(node_is_split)[0]
        reordered = seg_prims[seg_sel[perm]]

        # write back into `order` and set child ranges (vectorized)
        right_counts = np.bincount(
            seg_node[node_is_split][goes_right[node_is_split]], minlength=K
        )[split_mask]
        split_starts = starts[split_mask]
        split_counts = counts[split_mask]
        sp_node = np.repeat(np.arange(n_split), split_counts)
        sp_excl = np.concatenate([[0], np.cumsum(split_counts)[:-1]])
        tgt = (
            np.arange(len(reordered), dtype=np.int64)
            - sp_excl[sp_node]
            + split_starts[sp_node]
        )
        order[tgt] = reordered

        lc = split_counts - right_counts
        n_first[left_ids] = split_starts
        n_count[left_ids] = lc
        n_first[right_ids] = split_starts + lc
        n_count[right_ids] = right_counts
        new_active = np.empty(2 * n_split, np.int64)
        new_active[0::2] = left_ids
        new_active[1::2] = right_ids
        active = new_active

    # fill bounds for any child nodes created at the last level
    # (they were assigned ranges but never visited): compute directly
    pending = np.nonzero(
        (n_lo[:n_nodes] == 0).all(axis=1) & (n_hi[:n_nodes] == 0).all(axis=1)
    )[0]
    for nid in pending:
        if nid == 0 and F > 0:
            continue
        s, ccount = n_first[nid], max(n_count[nid], 0)
        if ccount > 0 and n_left[nid] == -1:
            pl = prim_lo[order[s : s + ccount]]
            ph = prim_hi[order[s : s + ccount]]
            n_lo[nid] = pl.min(axis=0)
            n_hi[nid] = ph.max(axis=0)

    return (
        n_lo[:n_nodes].astype(np.float32),
        n_hi[:n_nodes].astype(np.float32),
        n_left[:n_nodes].astype(np.int32),
        n_right[:n_nodes].astype(np.int32),
        n_first[:n_nodes].astype(np.int32),
        n_count[:n_nodes].astype(np.int32),
        order.astype(np.int32),
    )
