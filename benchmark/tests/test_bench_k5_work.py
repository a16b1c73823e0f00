"""The frozen K5 work count against a count by hand on a tiny record."""
import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from benchmark.work import k5_work as kw  # noqa: E402


def _scene():
    """Face 0: material 0 (diffuse, textured, smooth); face 1: material 1
    (conductor, untextured, a delta lobe only), on emitter 0."""
    fp = np.zeros((2, 32), np.float32)
    fp[:, 25] = np.array([0, 1], np.int32).view(np.float32)
    fp[:, 26] = np.array([-1, 0], np.int32).view(np.float32)
    mats = SimpleNamespace(kind=torch.tensor([0, 1], dtype=torch.int32),
                           nested_id=torch.tensor([-1, -1], dtype=torch.int32),
                           flags=torch.tensor([1, 16], dtype=torch.int32),
                           tex_id=torch.tensor([0, -1], dtype=torch.int32),
                           base_color=torch.zeros(2, 3))
    em = SimpleNamespace(em_face_packed=torch.zeros(1, 16), radiance=torch.zeros(1, 3))
    return SimpleNamespace(geometry=SimpleNamespace(face_packed=torch.from_numpy(fp)),
                           materials=mats, emitters=em)


def test_k5_work_by_hand():
    rec = SimpleNamespace(prim=torch.tensor([[0, 1, -1], [1, -1, -1]], dtype=torch.int32),
                          occl=torch.zeros(2, 3, dtype=torch.bool))
    hits, distinct, ops, nbytes = kw.k5_work(
        _scene(), rec, {"idx": None, "idx0": 0, "ray_end": 2, "n_steps": None, "max_depth": 3})
    search = 1                                          # ceil(log2(1 + 1))
    # face 0 at depth 1: shaded, textured diffuse, NEE (smooth, unoccluded)
    v0 = (kw.K5_OPS_HIT + kw.K5_OPS_SHADE + search + kw.K5_OPS_SAMPLE_COMMON
          + kw.K5_OPS_SAMPLE[0] + kw.K5_OPS_TEXTURE + kw.K5_OPS_EVAL_COMMON + kw.K5_OPS_EVAL[0])
    # face 1 (twice): shaded conductor on an emitter, no NEE (no smooth lobe)
    v1 = (kw.K5_OPS_HIT + kw.K5_OPS_EMITTER_HIT + kw.K5_OPS_SHADE + search
          + kw.K5_OPS_SAMPLE_COMMON + kw.K5_OPS_SAMPLE[1])
    deriv = 3 * kw.K5_OPS_DERIV + 2 * kw.K5_OPS_DERIV_EMITTER
    assert (v0, v1) == (364, 410)
    assert ops == 2 * (v0 + 2 * v1) + deriv == 2530
    assert (hits, distinct) == (3, 2)
    per_kernel = 3 * kw.K5_ENTRY_BYTES + 2 * kw.K5_FACE_BYTES + 2 * 12
    assert nbytes == 2 * per_kernel + 3 * 12 == 626


def test_k5_work_sorted_chunk_counts_its_steps_and_indices():
    rec = SimpleNamespace(prim=torch.tensor([[0, 1, -1], [1, -1, -1]], dtype=torch.int32),
                          occl=torch.zeros(2, 3, dtype=torch.bool))
    idx = torch.tensor([5, 9])
    hits, _, ops, nbytes = kw.k5_work(
        _scene(), rec, {"idx": idx, "idx0": 0, "ray_end": 6, "n_steps": 1, "max_depth": 3})
    # only the first step, and row 1 (ray 9) is past ray_end
    assert hits == 1
    assert ops == 2 * 364 + kw.K5_OPS_DERIV
    assert nbytes == 2 * (kw.K5_ENTRY_BYTES + kw.K5_FACE_BYTES + 2 * 12 + 2 * 8) + 3 * 12
