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


# ------------------------ K2 (fused MLP) and K3 (scan) ------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _mlp(sizes, seed, device):
    from mitsuba3_experiments_tpu_torch.models import init_mlp

    params = init_mlp(torch.Generator().manual_seed(seed), sizes, device=device)
    for layer in params:   # non-zero biases, so the bias path is checked too
        layer["b"] = 0.1 * torch.randn(layer["b"].shape, generator=torch.Generator().manual_seed(seed)).to(device)
    return params


@pytest.mark.parametrize("sizes,tile", [((32, 64, 64, 64, 3), 512), ((32, 64, 64, 64, 3), 128),
                                        ((48, 128, 128, 5), 256), ((7, 3), 64)])
@pytest.mark.parametrize("n", [1, 1000, 70_001])
def test_fused_mlp_kernel_matches_plain(card, sizes, tile, n):
    """K2 against apply_mlp on the same card tensors: allclose at rtol
    2e-2 / atol 2e-2 (a hidden activation may round to the neighbouring
    bf16 value when the float32 sums are added in another order), and
    equal to 1e-5 on at least 90% of the rows."""
    from mitsuba3_experiments_tpu_torch.models import apply_mlp, fused_mlp, fused_mlp_cuda

    params = _mlp(list(sizes), 1, card)
    x = torch.randn((n, sizes[0]), generator=torch.Generator().manual_seed(2)).to(card)
    launches = fused_mlp_cuda.launches
    got = fused_mlp.fused_mlp_forward(fused_mlp.mlp_params_flat(params), x, sizes, "leaky_relu", tile)
    torch.cuda.synchronize()
    assert fused_mlp_cuda.launches == launches + 1
    ref = apply_mlp(params, x)
    assert got.shape == ref.shape == (n, sizes[-1]) and got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2)
    close = torch.isclose(got, ref, rtol=1e-5, atol=1e-5).all(dim=1).float().mean()
    assert float(close) >= 0.9


def test_fused_apply_mlp_grad_on_card(card):
    """fused_apply_mlp's gradient on the card (recomputed through apply_mlp)
    equals the plain path's autograd."""
    from mitsuba3_experiments_tpu_torch.models import apply_mlp, fused_mlp, fused_mlp_cuda

    sizes = [32, 64, 64, 64, 3]
    base = _mlp(sizes, 3, card)
    x0 = torch.randn((5000, 32), generator=torch.Generator().manual_seed(4)).to(card)

    def run(fn):
        params = [{k: t.clone().requires_grad_(True) for k, t in l.items()} for l in base]
        x = x0.clone().requires_grad_(True)
        torch.sin(fn(params, x)).sum().backward()
        return [p.grad for l in params for p in l.values()] + [x.grad]

    launches = fused_mlp_cuda.launches
    got = run(lambda p, x: fused_mlp.fused_apply_mlp(p, x, "leaky_relu", 512))
    assert fused_mlp_cuda.launches == launches + 1
    ref = run(lambda p, x: apply_mlp(p, x))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=2e-2, atol=1e-3 * float(b.abs().max()))


def test_field_eval_fused_launches_kernel(card):
    from mitsuba3_experiments_tpu_torch.models import FieldConfig, field_eval, fused_mlp_cuda, init_field, mlp

    cfg = FieldConfig(fused=True)
    field = init_field(torch.Generator().manual_seed(5), cfg, device=card)
    p = torch.rand((4096, 3), device=card)
    wi = torch.nn.functional.normalize(torch.randn((4096, 3), device=card), dim=-1)
    calls, launches = mlp.calls, fused_mlp_cuda.launches
    out = field_eval(field, cfg, p, wi)
    torch.cuda.synchronize()
    assert fused_mlp_cuda.launches == launches + 1 and mlp.calls == calls
    ref = field_eval(field, FieldConfig(fused=False), p, wi)
    torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("n", [1, 255, 2047, 2048, 2049, 4096, 1_000_003])
def test_prefix_sum_kernel_matches_plain(card, dtype, n):
    """K3 against torch.cumsum: int32 equal (wrapping), float32 within rtol
    1e-4 / atol 1e-4 of a float64 cumsum."""
    from mitsuba3_experiments_tpu_torch import ops
    from mitsuba3_experiments_tpu_torch.ops import prefix_sum_cuda

    g = torch.Generator().manual_seed(n)
    if dtype == torch.int32:
        x = torch.randint(-2**30, 2**30, (n,), generator=g, dtype=torch.int32).to(card)
    else:
        x = torch.rand((n,), generator=g).to(card)
    launches, calls = prefix_sum_cuda.launches, prefix_sum_cuda.plain_calls
    got = ops.prefix_sum_blocked(x)
    torch.cuda.synchronize()
    assert prefix_sum_cuda.launches == launches + 1 and prefix_sum_cuda.plain_calls == calls
    if dtype == torch.int32:
        assert torch.equal(got, torch.cumsum(x, 0, dtype=torch.int32))
    else:
        ref = torch.cumsum(x.double(), 0)
        torch.testing.assert_close(got.double(), ref, rtol=1e-4, atol=1e-4)


def test_kernel_wrappers_reject_what_they_do_not_take(card):
    from mitsuba3_experiments_tpu_torch import ops
    from mitsuba3_experiments_tpu_torch.models import fused_mlp_cuda
    from mitsuba3_experiments_tpu_torch.ops import prefix_sum_cuda

    with pytest.raises(TypeError):
        ops.prefix_sum_blocked(torch.zeros(8, dtype=torch.float64, device=card))
    with pytest.raises(ValueError):
        prefix_sum_cuda.scan_cuda(torch.zeros(8))
    params = _mlp([16, 64, 3], 6, card)
    flat = tuple(t for l in params for t in (l["w"], l["b"]))
    x = torch.zeros((10, 16), device=card)
    with pytest.raises(ValueError):
        fused_mlp_cuda.fused_mlp_cuda(flat, x.cpu(), (16, 64, 3))
    with pytest.raises(ValueError):
        fused_mlp_cuda.fused_mlp_cuda(flat, x, (16, 64, 3), tile=100)
    with pytest.raises(ValueError):
        fused_mlp_cuda.fused_mlp_cuda(flat, x, (16, 64, 3), hidden_act="gelu")
    with pytest.raises(ValueError):
        fused_mlp_cuda.fused_mlp_cuda(flat, x[:, :8], (16, 64, 3))
    wide = _mlp([16, 256, 3], 7, card)
    with pytest.raises(ValueError):
        fused_mlp_cuda.fused_mlp_cuda(tuple(t for l in wide for t in (l["w"], l["b"])), x,
                                      (16, 256, 3))
