"""8-wide BVH: collapse of the binary SAH tree into packed-row tables.

Host numpy, the same code as ``mitsuba3_experiments_tpu.scene.bvh8`` so both
packages traverse identical tables.  Layout of the rows:

  nodes    (NN8, 56) f32 — [0:8]  child codes (bit-cast int32:
                                   >=0 internal node row; -1 empty;
                                   <=-2 leaf row = -code-2)
                           [8:56] 8 x (lo.xyz | hi.xyz) child bounds
  leafs (L, ROW) f32    —  [0:9*LEAF_CAP] packed triangle vertices;
                           [..:FACE_OFF] pad; [FACE_OFF:ROW] global face
                           ids (bit-cast i32, -1 padding — padded slots
                           hold degenerate all-zero triangles that never
                           hit).  LEAF_CAP=8 gives the 88-float row
                           [0:72 | 72:80 pad | 80:88].

One internal step reads one row and tests 8 child boxes; one leaf step reads
one row and tests LEAF_CAP triangles.
"""
from __future__ import annotations

import dataclasses

import numpy as np

EMPTY = -1


@dataclasses.dataclass(frozen=True)
class BVHLayout:
    """All BVH build/layout knobs as one hashable value.

      width      node fan-out (8).
      leaf_cap   triangles per packed leaf row (8).
      collapse   binary->wide expansion order: "first" (default) or "area"
                 (SA-greedy; deeper tree, stack need 96).
      sbvh       spatial-split build (native/sbvh_builder.cpp): a triangle
                 that straddles a split is referenced from both sides, so
                 leaves may repeat a face; False: object splits only
                 (native/bvh_builder.cpp).
      sbvh_alpha child-overlap threshold for spatial splits.
      stack_depth traversal stack capacity; None = auto (80 for the
                 default 8-wide "first" tree, 96 for "area", else
                 8*(width-1)).  collapse_to_wide raises at build time if
                 the exact worst-case need exceeds it.
    """

    width: int = 8
    leaf_cap: int = 8
    collapse: str = "first"
    sbvh: bool = True
    sbvh_alpha: float = 1e-4
    stack_depth: int | None = None

    # ---- derived row offsets (the packed layouts documented up top) ----
    @property
    def vert_floats(self) -> int:
        return 9 * self.leaf_cap

    @property
    def face_off(self) -> int:
        # face ids live past the vertex block, 8-aligned with >=1 float of pad
        return (self.vert_floats // 8 + 1) * 8

    @property
    def leaf_row(self) -> int:
        return self.face_off + self.leaf_cap

    @property
    def node_base(self) -> int:
        # node row: width child codes (8-aligned block) then width x 6 bounds
        return ((self.width + 7) // 8) * 8

    @property
    def node_row(self) -> int:
        return ((self.node_base + 6 * self.width + 7) // 8) * 8

    @property
    def stack(self) -> int:
        if self.stack_depth is not None:
            return self.stack_depth
        if self.width == 8:
            return 96 if self.collapse == "area" else 80
        return 8 * (self.width - 1)


DEFAULT_LAYOUT = BVHLayout()


def collapse_to_wide(lo, hi, left, right, first, count, prim_order,
                     tri_verts_flat, faces_global,
                     layout: BVHLayout | None = None):
    """Binary SAH arrays -> packed wide tables (host, numpy + python loop).

    tri_verts_flat: (F, 9) f32 triangle vertices in prim_order slot order.
    faces_global:   (F,) i32 global face id per slot.
    """
    lay = layout if layout is not None else DEFAULT_LAYOUT
    WIDTH, LEAF_CAP = lay.width, lay.leaf_cap
    NODE_BASE, NODE_ROW = lay.node_base, lay.node_row
    FACE_OFF, LEAF_ROW = lay.face_off, lay.leaf_row
    STACK_DEPTH = lay.stack
    n_bin = left.shape[0]
    if lay.collapse == "area":
        dx = np.maximum(hi[:, 0] - lo[:, 0], 0.0)
        dy = np.maximum(hi[:, 1] - lo[:, 1], 0.0)
        dz = np.maximum(hi[:, 2] - lo[:, 2], 0.0)
        area = 2.0 * (dx * dy + dy * dz + dz * dx)
    else:
        area = None

    wide_children: list[list[int]] = []   # entries: +node / ~leaf refs
    leaf_rows: list[tuple[int, int]] = []  # (first, count) per leaf row

    # map binary node -> wide code, built iteratively
    # collapse: take a binary internal node, expand the child set until
    # WIDTH subtrees (preferring to expand internal children), children that
    # are binary leaves become leaf rows.
    def make_leaf(b):
        leaf_rows.append((int(first[b]), int(count[b])))
        return -(len(leaf_rows) - 1) - 2

    wide_of_binary = {}
    order = [0]
    codes = {}
    # BFS allocate wide rows for binary internal nodes reachable as subtree
    # roots after collapse
    queue = [0]
    while queue:
        b = queue.pop()
        if b in wide_of_binary:
            continue
        if left[b] == -1:
            continue  # handled by parent as leaf
        wid = len(wide_children)
        wide_of_binary[b] = wid
        wide_children.append([])

        # gather up to WIDTH subtree roots under b
        roots = [left[b], right[b]]
        while len(roots) < WIDTH:
            pick = -1
            if area is not None:
                # SA-greedy: expand the internal root with the largest
                # surface area (see COLLAPSE above)
                best_a = -1.0
                for i, r in enumerate(roots):
                    if left[r] != -1 and area[r] > best_a:
                        best_a = area[r]
                        pick = i
            else:
                for i, r in enumerate(roots):
                    if left[r] != -1:
                        pick = i
                        break
            if pick < 0:
                break
            r = roots.pop(pick)
            roots.extend([left[r], right[r]])
        wide_children[wid] = roots
        for r in roots:
            if left[r] != -1:
                queue.append(r)

    # second pass: encode child codes + bounds
    nn8 = len(wide_children)
    nodes = np.zeros((max(nn8, 1), NODE_ROW), np.float32)
    codes_arr = np.full((max(nn8, 1), WIDTH), EMPTY, np.int32)
    B = NODE_BASE
    for wid, roots in enumerate(wide_children):
        for k, r in enumerate(roots):
            if left[r] == -1:
                code = make_leaf(r)
            else:
                code = wide_of_binary[r]
            codes_arr[wid, k] = code
            nodes[wid, B + 6 * k : B + 6 * k + 3] = lo[r]
            nodes[wid, B + 6 * k + 3 : B + 6 * k + 6] = hi[r]
        for k in range(len(roots), WIDTH):
            # empty slot: inverted bounds (slab test always misses)
            nodes[wid, B + 6 * k : B + 6 * k + 3] = 3e38
            nodes[wid, B + 6 * k + 3 : B + 6 * k + 6] = -3e38
    nodes[:, 0:WIDTH] = codes_arr.view(np.float32)

    # leaf table (single fused row: verts + bitcast face ids)
    L = max(len(leaf_rows), 1)
    leaf_tris = np.zeros((L, LEAF_ROW), np.float32)
    leaf_face = np.full((L, LEAF_CAP), -1, np.int32)
    for li, (f0, c) in enumerate(leaf_rows):
        if c > LEAF_CAP:  # builders guarantee <= cap via median fallback
            raise ValueError(f"leaf overflow: {c} > {LEAF_CAP}")
        leaf_tris[li, : 9 * c] = tri_verts_flat[f0 : f0 + c].reshape(-1)
        leaf_face[li, :c] = faces_global[f0 : f0 + c]
    leaf_tris[:, FACE_OFF:LEAF_ROW] = leaf_face.view(np.float32)

    # degenerate whole-scene-is-one-leaf case: synthesize a root node
    if nn8 == 0:
        code = make_leaf(0) if not leaf_rows else -2
        codes_arr = np.full((1, WIDTH), EMPTY, np.int32)
        codes_arr[0, 0] = -2
        nodes = np.zeros((1, NODE_ROW), np.float32)
        nodes[0, 0:WIDTH] = codes_arr.view(np.float32)
        B = NODE_BASE
        nodes[0, B : B + 3] = lo[0]
        nodes[0, B + 3 : B + 6] = hi[0]
        for k in range(1, WIDTH):
            nodes[0, B + 6 * k : B + 6 * k + 3] = 3e38
            nodes[0, B + 6 * k + 3 : B + 6 * k + 6] = -3e38
        L = max(len(leaf_rows), 1)
        leaf_tris = np.zeros((L, LEAF_ROW), np.float32)
        leaf_face = np.full((L, LEAF_CAP), -1, np.int32)
        for li, (f0, c) in enumerate(leaf_rows):
            c = min(c, LEAF_CAP)
            leaf_tris[li, : 9 * c] = tri_verts_flat[f0 : f0 + c].reshape(-1)
            leaf_face[li, :c] = faces_global[f0 : f0 + c]
        leaf_tris[:, FACE_OFF:LEAF_ROW] = leaf_face.view(np.float32)

    # build-time stack guarantee: EXACT worst-case need — visiting a node
    # with c hit children pushes c-1 entries before descending, so the need
    # is max over root-to-leaf paths of sum(children-1).  Children wids are
    # allocated strictly after their parent's, so a reverse-wid sweep is
    # bottom-up.
    if nn8 > 0:
        need = np.zeros(nn8, np.int64)
        for wid in range(nn8 - 1, -1, -1):
            cs = codes_arr[wid]
            n_ch = int(np.sum(cs != EMPTY))
            child_need = 0
            for code in cs:
                if code >= 0:
                    child_need = max(child_need, int(need[code]))
            need[wid] = (n_ch - 1) + child_need
        if int(need[0]) > STACK_DEPTH:
            raise ValueError(
                f"wide-BVH worst-case stack need {int(need[0])} > "
                f"STACK_DEPTH={STACK_DEPTH}; raise the layout's stack_depth"
            )

    return nodes, leaf_tris, leaf_face
