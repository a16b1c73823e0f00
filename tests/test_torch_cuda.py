"""The CUDA traversal kernel against its plain torch version, on the card.

Marked `cuda`: it needs an NVIDIA card and nvcc, decides so when it runs,
and skips elsewhere.  Run it on the card with
    python -m pytest tests/test_torch_cuda.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu_torch.core.records import Ray
from mitsuba3_experiments_tpu_torch.intersect import bvh_cuda, bvh_torch
from mitsuba3_experiments_tpu_torch.scene import load_dict, standin_dict
from mitsuba3_experiments_tpu_torch.scene.bvh8 import DEFAULT_LAYOUT
from mitsuba3_experiments_tpu_torch.scene.flagship import _BLOB_HI, _BLOB_LO

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return load_dict(standin_dict(res=(64, 36), tri_budget=50_000), device="cuda")[0]


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform([-3.5, 0.1, -3.5], [4.5, 2.9, 4.5], (n, 3)).astype(np.float32)
    d = rng.uniform(_BLOB_LO, _BLOB_HI, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = np.where(rng.random(n) < 0.5, np.inf, rng.uniform(0.1, 3.0, n)).astype(np.float32)
    active = rng.random(n) < 0.95
    return [torch.as_tensor(x, device="cuda") for x in (o, d, maxt, active)]


@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_matches_plain(scene, any_hit):
    b = scene.bvh
    args = (b.unified, b.nodes.shape[0], *_rays(20_000, 1))
    launches = bvh_cuda.launches
    tk, fk, uk, vk = bvh_cuda.traverse_cuda(*args, any_hit=any_hit, layout=b.layout)
    torch.cuda.synchronize()
    assert bvh_cuda.launches == launches + 1
    tp, fp, up, vp = bvh_torch.traverse_plain(*args, any_hit, b.layout)
    if any_hit:
        assert torch.equal(fk >= 0, fp >= 0)
    else:
        assert torch.equal(fk, fp)
        for a, c in ((tk, tp), (uk, up), (vk, vp)):
            torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-7)


def test_dispatch_uses_kernel_on_cuda(scene):
    o, d, maxt, active = _rays(1000, 2)
    calls, launches = bvh_torch.calls, bvh_cuda.launches
    si = bvh_torch.ray_intersect(scene, Ray(o=o, d=d, maxt=maxt), active)
    torch.cuda.synchronize()
    assert bvh_cuda.launches == launches + 1 and bvh_torch.calls == calls
    assert si.t.device.type == "cuda"


def test_wrapper_rejects_what_it_does_not_take(scene):
    b = scene.bvh
    o, d, maxt, active = _rays(64, 3)
    with pytest.raises(TypeError):
        bvh_cuda.traverse_cuda(b.unified, b.nodes.shape[0], o.double(), d, maxt, active)
    with pytest.raises(ValueError):
        bvh_cuda.traverse_cuda(b.unified, b.nodes.shape[0], o[:, :2], d, maxt, active)
    with pytest.raises(ValueError):
        bvh_cuda.traverse_cuda(b.unified, b.nodes.shape[0], o.t().contiguous().t(), d, maxt, active)
    misaligned = b.unified.view(-1)[1: 1 + 88 * 100].view(100, 88)   # 4-byte offset
    with pytest.raises(ValueError):
        bvh_cuda.traverse_cuda(misaligned, 50, o, d, maxt, active)


@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_raises_on_stack_overflow(scene, any_hit):
    """A layout whose stack is shallower than the table needs: the kernel
    marks the rays and the wrapper raises, as the plain version does."""
    b = scene.bvh
    shallow = dataclasses.replace(b.layout or DEFAULT_LAYOUT, stack_depth=8)
    args = (b.unified, b.nodes.shape[0], *_rays(4096, 4))
    with pytest.raises(RuntimeError, match="stack overflow"):
        bvh_cuda.traverse_cuda(*args, any_hit=any_hit, layout=shallow)
    with pytest.raises(RuntimeError, match="stack overflow"):
        bvh_torch.traverse_plain(*args, any_hit, shallow)
