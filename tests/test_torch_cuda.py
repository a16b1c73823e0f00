"""The CUDA kernels against their plain torch versions, and the paths that
run them, on the card.

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


def _equal_bits(kernel_out, plain_out):
    """(t, face, u, v) of the kernel and the plain version equal bit for bit."""
    for a, c in zip(kernel_out, plain_out):
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))


def _both(scene, rays, any_hit):
    b = scene.bvh
    args = (b.unified, b.nodes.shape[0], *rays)
    got = bvh_cuda.traverse_cuda(*args, any_hit=any_hit, layout=b.layout)
    torch.cuda.synchronize()
    return got, bvh_torch.traverse_plain(*args, any_hit, b.layout)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n", [1, 31, 33, 4097])
def test_kernel_sizes_around_a_warp(scene, n, any_hit):
    """Fewer rays than a warp, one past a warp, one past a block multiple:
    the persistent warps hand out every ray once and idle the rest."""
    _equal_bits(*_both(scene, _rays(n, 10 + n), any_hit))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("pattern", ["none", "alternate", "first_half", "every_33rd"])
def test_kernel_active_masks(scene, pattern, any_hit):
    """Inactive lanes give face -1, t inf, u = v = 0, whatever their rays."""
    o, d, maxt, _ = _rays(5000, 20)
    i = torch.arange(5000, device="cuda")
    active = {"none": i < 0, "alternate": i % 2 == 0, "first_half": i < 2500,
              "every_33rd": i % 33 == 0}[pattern]
    got, ref = _both(scene, (o, d, maxt, active), any_hit)
    _equal_bits(got, ref)
    assert bool((got[1][~active] == -1).all()) and bool(torch.isinf(got[0][~active]).all())


def _slab_plane_rays(scene, n, seed):
    """Axis-parallel rays whose origins lie on child-box planes of the
    table's node rows: (plane - o) * inf = 0 * inf = NaN in the slab test."""
    b = scene.bvh
    rng = np.random.default_rng(seed)
    nodes = b.unified[: b.nodes.shape[0]].cpu().numpy()
    codes = nodes[:, :8].copy().view(np.int32)
    rows, slots = np.nonzero(codes != -1)
    pick = rng.integers(0, rows.shape[0], n)
    box = nodes[rows[pick], :][np.arange(n)[:, None], 8 + 6 * slots[pick][:, None] + np.arange(6)]
    lo, hi = box[:, :3], box[:, 3:]
    o = lo + rng.random((n, 3), dtype=np.float32) * (hi - lo)
    axis = rng.integers(0, 3, n)
    on_hi = rng.random(n) < 0.5
    o[np.arange(n), axis] = np.where(on_hi, hi[np.arange(n), axis], lo[np.arange(n), axis])
    corner = rng.random(n) < 0.25          # a quarter on a corner: three planes
    o[corner] = np.where(on_hi[corner, None], hi[corner], lo[corner])
    d = np.zeros((n, 3), np.float32)
    d[np.arange(n), rng.integers(0, 3, n)] = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    maxt = np.full(n, np.inf, np.float32)
    active = np.ones(n, bool)
    return [torch.as_tensor(np.ascontiguousarray(x), device="cuda") for x in (o, d, maxt, active)]


@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_axis_parallel_rays_on_slab_planes(scene, any_hit):
    """The NaN path of the slab test (min.NaN / max.NaN): equal to plain."""
    got, ref = _both(scene, _slab_plane_rays(scene, 6000, 30), any_hit)
    _equal_bits(got, ref)
    assert int((ref[1] >= 0).sum()) > 0


@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_back_to_back_launches(scene, any_hit):
    """Launches of different sizes on one stream with no wait between them:
    each starts from a ray counter the one before left at 0."""
    b = scene.bvh
    sizes = (5000, 37, 100_000, 1, 4097)
    rays = [_rays(n, 40 + n) for n in sizes]
    outs = [bvh_cuda._launch(b.unified, b.nodes.shape[0], *r, any_hit=any_hit, layout=b.layout)
            for r in rays]
    torch.cuda.synchronize()
    for r, got in zip(rays, outs):
        _equal_bits(got, bvh_torch.traverse_plain(b.unified, b.nodes.shape[0], *r, any_hit,
                                                  b.layout))


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


def _fused_vs_plain(sizes, n, tile, card, seed=1):
    """K2 on seeded inputs against apply_mlp, with the same tolerances as
    test_fused_mlp_kernel_matches_plain."""
    from mitsuba3_experiments_tpu_torch.models import apply_mlp, fused_mlp_cuda
    from mitsuba3_experiments_tpu_torch.models.fused_mlp import mlp_params_flat

    params = _mlp(list(sizes), seed, card)
    x = torch.randn((n, sizes[0]), generator=torch.Generator().manual_seed(seed + 1)).to(card)
    got = fused_mlp_cuda.fused_mlp_cuda(mlp_params_flat(params), x, sizes, "leaky_relu", tile)
    torch.cuda.synchronize()
    ref = apply_mlp(params, x)
    assert got.shape == ref.shape == (n, sizes[-1])
    torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2)
    assert float(torch.isclose(got, ref, rtol=1e-5, atol=1e-5).all(dim=1).float().mean()) >= 0.9


@pytest.mark.parametrize("sizes", [(24, 32, 32, 3), (7, 20, 24, 3), (20, 24, 20, 5), (33, 24, 1)])
@pytest.mark.parametrize("n", [1, 15, 17, 4099])
def test_fused_mlp_kernel_padded_widths(card, sizes, n):
    """Widths padded with zero weights on both sides of a layer (k to 16,
    hidden n to 16, the output to 8), around a 16-row group."""
    _fused_vs_plain(sizes, n, 64, card)


@pytest.mark.parametrize("tile", [64, 512])
@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_fused_mlp_kernel_persistent_grid_edges(card, tile, offset):
    """n at one tile per resident block, and one row either side: the last
    block's second step holds one row, or a block has one row short."""
    from mitsuba3_experiments_tpu_torch.models import fused_mlp_cuda

    sizes = (32, 64, 64, 64, 3)
    blocks = fused_mlp_cuda.grid_blocks(sizes, 1 << 30, tile, card)
    n = tile * blocks + offset
    assert fused_mlp_cuda.grid_blocks(sizes, n, tile, card) == blocks
    _fused_vs_plain(sizes, n, tile, card)


def test_fused_mlp_kernel_on_two_streams(card):
    """Two calls back to back on two streams, no wait between them."""
    from mitsuba3_experiments_tpu_torch.models import apply_mlp, fused_mlp_cuda
    from mitsuba3_experiments_tpu_torch.models.fused_mlp import mlp_params_flat

    sizes = (32, 64, 64, 64, 3)
    pa, pb = _mlp(list(sizes), 11, card), _mlp(list(sizes), 12, card)
    xa = torch.randn((300_001, 32), generator=torch.Generator().manual_seed(13)).to(card)
    xb = torch.randn((70_003, 32), generator=torch.Generator().manual_seed(14)).to(card)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    a = fused_mlp_cuda.fused_mlp_cuda(mlp_params_flat(pa), xa, sizes)
    with torch.cuda.stream(side):
        b = fused_mlp_cuda.fused_mlp_cuda(mlp_params_flat(pb), xb, sizes)
    torch.cuda.synchronize()
    for got, p, x in ((a, pa, xa), (b, pb, xb)):
        ref = apply_mlp(p, x)
        torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2)
        assert float(torch.isclose(got, ref, rtol=1e-5, atol=1e-5).all(dim=1).float().mean()) >= 0.9


def _weight_bytes(sizes):
    """Shared memory K2 stages for `sizes`: bf16 weights and float32 biases,
    the input padded to 32, 64 or 128 columns, every hidden layer to one
    such width (at least the input's), the output to a multiple of 8."""
    cls = lambda v: 32 if v <= 32 else 64 if v <= 64 else 128
    kin = cls(sizes[0])
    kh = max(cls(max(sizes[1:-1], default=0)), kin)
    n_layers = len(sizes) - 1
    total = 0
    for i in range(n_layers):
        k = kin if i == 0 else kh
        np_ = -(-sizes[-1] // 8) * 8 if i == n_layers - 1 else kh
        total += k * np_ * 2 + np_ * 4
    return total


def test_fused_mlp_kernel_at_the_shared_memory_limit(card):
    """The widest MLP of 128-wide layers whose weights fit the card's
    shared memory runs and matches plain; one output column more (a
    further n8 tile) does not fit, and the wrapper raises the check's
    reason."""
    from mitsuba3_experiments_tpu_torch.models import fused_mlp_cuda
    from mitsuba3_experiments_tpu_torch.models.fused_mlp import mlp_params_flat

    limit = torch.cuda.get_device_properties(card).shared_memory_per_block_optin
    hidden = 1
    while _weight_bytes((128,) * (hidden + 2) + (8,)) <= limit:
        hidden += 1
    body = (128,) * (hidden + 1)          # `hidden` layers of 128 -> 128, then the head from 128
    out = max(o for o in range(8, 129, 8) if _weight_bytes(body + (o,)) <= limit)
    fits, over = body + (out,), body + (out + 1,)
    assert _weight_bytes(fits) <= limit < _weight_bytes(over) and len(fits) - 1 <= 8
    _fused_vs_plain(fits, 1000, 128, card)
    params = _mlp(list(over), 2, card)
    x = torch.zeros((10, 128), device=card)
    with pytest.raises(ValueError, match="shared memory"):
        fused_mlp_cuda.fused_mlp_cuda(mlp_params_flat(params), x, over)


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
@pytest.mark.parametrize("n", [1, 255, 2047, 2048, 2049, 4095, 4096, 4097, 8191, 8192, 8193,
                               16_383, 16_384, 16_385, 1_000_003])
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


def _scan_inputs(n, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(-2**30, 2**30, (n,), generator=g, dtype=torch.int32)
    return torch.rand((n,), generator=g)


def _check_scan(got, x):
    if x.dtype == torch.int32:
        assert torch.equal(got, torch.cumsum(x, 0, dtype=torch.int32))
    else:
        torch.testing.assert_close(got.double(), torch.cumsum(x.double(), 0), rtol=1e-4, atol=0.0)


def test_prefix_sum_back_to_back_calls(card):
    """Calls of different sizes and dtypes on one stream with no wait
    between them: each call's tickets and status words stay its own."""
    from mitsuba3_experiments_tpu_torch.ops import prefix_sum_cuda

    plan = [(1_000_003, torch.float32), (5, torch.int32), (70_000, torch.int32),
            (4096, torch.float32), (2_500_000, torch.int32), (1, torch.float32),
            (12_289, torch.float32)]
    xs = [_scan_inputs(n, dt, i).to(card) for i, (n, dt) in enumerate(plan)]
    torch.cuda.synchronize()
    outs = [prefix_sum_cuda.scan_cuda(x) for x in xs]
    torch.cuda.synchronize()
    for got, x in zip(outs, xs):
        _check_scan(got, x)


def test_prefix_sum_on_a_second_stream(card):
    """A call on another stream, interleaved with calls on the default one,
    uses that stream's own status words and ticket."""
    from mitsuba3_experiments_tpu_torch.ops import prefix_sum_cuda

    a = _scan_inputs(3_000_001, torch.int32, 1).to(card)
    b = _scan_inputs(900_000, torch.float32, 2).to(card)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    first = prefix_sum_cuda.scan_cuda(a)
    with torch.cuda.stream(side):
        on_side = prefix_sum_cuda.scan_cuda(b)
    second = prefix_sum_cuda.scan_cuda(b)
    torch.cuda.synchronize()
    _check_scan(first, a)
    _check_scan(on_side, b)
    _check_scan(second, b)


def test_prefix_sum_epoch_wrap(card, monkeypatch):
    """When the epochs run out the status words are zeroed once and the
    epochs start again at 1; the results stay right across the wrap."""
    from mitsuba3_experiments_tpu_torch.cuda_build import stream_scratch
    from mitsuba3_experiments_tpu_torch.ops import prefix_sum_cuda

    x = _scan_inputs(300_000, torch.int32, 3).to(card)
    prefix_sum_cuda.scan_cuda(x)
    state = stream_scratch("prefix_sum", x.device, torch.cuda.current_stream().cuda_stream,
                           prefix_sum_cuda._StreamState)
    monkeypatch.setattr(prefix_sum_cuda, "_EPOCH_END", state.epoch + 2)
    for n in (300_000, 200_000, 300_000, 50_000):
        _check_scan(prefix_sum_cuda.scan_cuda(x[:n]), x[:n])
    assert state.epoch < 4


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


# ----------------------- K4 (dependent gather chain) -----------------------

@pytest.mark.parametrize("rows,lanes,iters", [(4096, 1, 5), (431_104, 1000, 16),
                                              (431_104, 65_536, 64)])
def test_gather_chain_kernel_matches_plain(card, rows, lanes, iters):
    """K4 against the plain chain on the same card tensors: final indices
    equal, accumulators equal bit for bit (the same float32 adds in the
    same order)."""
    from mitsuba3_experiments_tpu_torch.ops import gather_probe, gather_probe_cuda

    table = torch.as_tensor(gather_probe.build_table(3, rows=rows), device=card)
    idx0 = torch.as_tensor(np.random.default_rng(4).integers(0, rows, lanes).astype(np.int32),
                           device=card)
    launches, calls = gather_probe_cuda.launches, gather_probe.plain_calls
    idx, acc = gather_probe.dep_chain(table, idx0, iters, block=128)
    torch.cuda.synchronize()
    assert gather_probe_cuda.launches == launches + 1 and gather_probe.plain_calls == calls
    ref_idx, ref_acc = gather_probe.dep_chain_plain(table, idx0, iters)
    assert torch.equal(idx, ref_idx) and torch.equal(acc, ref_acc)


@pytest.mark.parametrize("lanes,block,iters", [(7, 256, 9), (1001, 256, 9), (4097, 3, 5),
                                               (132, 1, 17), (2049, 1024, 4), (500, 64, 0)])
def test_gather_chain_kernel_groups_and_blocks(card, lanes, block, iters):
    """Chains not a multiple of a warp's chains or of the block, one chain
    per block, the largest block and no steps at all: bit-equal to the
    plain chain on every lane."""
    from mitsuba3_experiments_tpu_torch.ops import gather_probe, gather_probe_cuda

    table = torch.as_tensor(gather_probe.build_table(8, rows=50_000), device=card)
    idx0 = torch.as_tensor(np.random.default_rng(lanes).integers(0, 50_000, lanes).astype(np.int32),
                           device=card)
    idx, acc = gather_probe_cuda.dep_chain_cuda(table, idx0, iters, block=block)
    torch.cuda.synchronize()
    ref_idx, ref_acc = gather_probe.dep_chain_plain(table, idx0, iters)
    assert torch.equal(idx, ref_idx)
    assert torch.equal(acc.view(torch.int32), ref_acc.view(torch.int32))


def test_gather_chain_kernel_stops_at_a_bad_index(card):
    from mitsuba3_experiments_tpu_torch.ops import gather_probe, gather_probe_cuda

    table = torch.as_tensor(gather_probe.build_table(3, rows=1000), device=card)
    table[7, 0] = 5000.0
    idx0 = torch.tensor([7, 8], dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="left the table"):
        gather_probe_cuda.dep_chain_cuda(table, idx0, 3)
    idx, _ = gather_probe_cuda.dep_chain_cuda(table, idx0, 3, check=False)
    assert int(idx[0]) == -1


# ------------------- record + replay, card against CPU ---------------------

def _replay_scene(device):
    from mitsuba3_experiments_tpu_torch.core import math as tm
    from mitsuba3_experiments_tpu_torch.scene import mesh as meshlib

    sph = meshlib.sphere(radius=1.0, n_theta=20, n_phi=40)
    quad = meshlib.rectangle(subdiv=4)
    light = meshlib.rectangle(subdiv=1)
    fv = (quad.vertices * 4.0) @ np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
    lv = light.vertices @ np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32) + np.array(
        [0, 4, 0], np.float32)
    return load_dict({
        "type": "scene",
        "sensor": {"type": "perspective", "fov": 45.0,
                   "to_world": tm.look_at([0, 2, 6], [0, 0.5, 0], [0, 1, 0]),
                   "film": {"width": 32, "height": 24}},
        "sphere": {"type": "mesh", "vertices": sph.vertices + np.array([0, 1, 0], np.float32),
                   "faces": sph.faces, "bsdf": {"type": "roughconductor", "alpha": 0.2}},
        "floor": {"type": "mesh", "vertices": fv, "faces": quad.faces,
                  "bsdf": {"type": "diffuse", "reflectance": [0.5, 0.4, 0.3]}},
        "light": {"type": "mesh", "vertices": lv, "faces": light.faces,
                  "bsdf": {"type": "diffuse", "reflectance": [0.0, 0.0, 0.0]},
                  "emitter": {"type": "area", "radiance": [8.0, 8.0, 8.0]}},
    }, device=device)[0]


@pytest.mark.parametrize("mode", ["full", "sorted"])
def test_record_replay_card_matches_cpu(card, mode):
    """The record on the card (K1 traversals) equals the CPU's (plain
    traversal) in prim and occlusion; the replayed gradients agree within
    rtol 1e-3 / atol 1e-4 max|g| (index_add order on the card)."""
    from mitsuba3_experiments_tpu_torch.integrators import (
        PathIntegrator, record_full_pipelined, render, replay_grads)
    from mitsuba3_experiments_tpu_torch.scene import params

    spp, depth = 2, 4
    out = {}
    for dev in (card, torch.device("cpu")):
        scene = _replay_scene(dev)
        n = 32 * 24 * spp
        pad = n + 128
        target = render(scene, PathIntegrator(max_depth=depth), seed=9, spp=spp, rfilter="box")
        rec, film = record_full_pipelined(scene, 3, n, spp=spp, max_depth=depth, rr_depth=4,
                                          pad_to=pad, return_film=True)
        p = {k: params.traverse(scene)[k] for k in ("materials.base_color", "emitters.radiance")}
        g = replay_grads(scene, p, params.update, target, 3, rec, n, chunk=pad // 4, spp=spp,
                         max_depth=depth, rr_depth=4, mode=mode, film=film)
        out[dev.type] = (rec, {k: v.cpu().numpy() for k, v in g.items()})
    (rc, gc), (rh, gh) = out["cuda"], out["cpu"]
    assert torch.equal(rc.prim.cpu(), rh.prim) and torch.equal(rc.occl.cpu(), rh.occl)
    for k in gh:
        assert np.abs(gh[k]).max() > 0 and np.isfinite(gc[k]).all()
        np.testing.assert_allclose(gc[k], gh[k], rtol=1e-3, atol=1e-4 * np.abs(gh[k]).max())


# ---------- the spatial-split tree, the differentiable render, NRC ----------

def test_kernel_matches_plain_on_the_spatial_split_standin(scene):
    """The stand-in's default tree repeats the faces that straddle spatial
    splits; K1 equals the plain traversal on it."""
    b = scene.bvh
    assert b.layout.sbvh and int((b.leaf_face >= 0).sum()) > scene.n_faces
    args = (b.unified, b.nodes.shape[0], *_rays(65_536, 11))
    for any_hit in (False, True):
        tk, fk, uk, vk = bvh_cuda.traverse_cuda(*args, any_hit=any_hit, layout=b.layout)
        tp, fp, up, vp = bvh_torch.traverse_plain(*args, any_hit, b.layout)
        if any_hit:
            assert torch.equal(fk >= 0, fp >= 0)
            continue
        assert torch.equal(fk, fp)
        for a, c in ((tk, tp), (uk, up), (vk, vp)):
            torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-7)


def test_differentiable_render_card_matches_cpu(card):
    """AD through PathIntegrator(differentiable=True) on the card (K1, run
    again in the backward) equals the CPU's within rtol 1e-3 / atol 1e-4
    max|g|."""
    from mitsuba3_experiments_tpu_torch.integrators import PathIntegrator, render
    from mitsuba3_experiments_tpu_torch.scene import params

    keys = ("materials.base_color", "emitters.radiance")
    out = {}
    for dev in (card, torch.device("cpu")):
        scene = _replay_scene(dev)
        with torch.no_grad():
            target = render(scene, PathIntegrator(max_depth=4), seed=9, spp=2)
        p = {k: params.traverse(scene)[k].detach().clone().requires_grad_(True) for k in keys}
        launches = bvh_cuda.launches
        img = render(params.update(scene, p), PathIntegrator(max_depth=4, differentiable=True),
                     seed=5, spp=2)
        forward = bvh_cuda.launches - launches
        ((img - target) ** 2).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert forward > 0 and bvh_cuda.launches - launches == 2 * forward - 1
        out[dev.type] = {k: p[k].grad.cpu().numpy() for k in keys}
    for k in keys:
        gc, gh = out["cuda"][k], out["cpu"][k]
        assert np.abs(gh).max() > 0 and np.isfinite(gc).all()
        np.testing.assert_allclose(gc, gh, rtol=1e-3, atol=1e-4 * np.abs(gh).max())


def test_nrc_fused_launches_kernel(card):
    """NRCTrainer and NRCIntegrator with FieldConfig(fused=True) run their
    cache lookups on K2; the fused render agrees with the plain one within
    K2's bf16 rounding."""
    from mitsuba3_experiments_tpu_torch.integrators import NRCIntegrator, NRCTrainer, render
    from mitsuba3_experiments_tpu_torch.models import (
        FieldConfig, HashGridConfig, fused_mlp_cuda, mlp)

    scene = _replay_scene(card)
    cfg = FieldConfig(grid=HashGridConfig(n_levels=4, log2_table_size=12, base_resolution=4,
                                          finest_resolution=64), width=32, depth=3, fused=True,
                      fused_tile=128)
    trainer = NRCTrainer(field_cfg=cfg, batch_size=1024, spread_c=1e-6, max_depth=3,
                         train_depth=8, train_spread_mult=1e5)
    launches = fused_mlp_cuda.launches
    field, losses = trainer.train(scene, n_iters=5)
    assert fused_mlp_cuda.launches == launches + 2 * 5 and np.isfinite(losses).all()
    integ = NRCIntegrator(max_depth=3, spread_c=1e-6, cache=(field, trainer))
    launches, calls = fused_mlp_cuda.launches, mlp.calls
    img = render(scene, integ, spp=2)
    torch.cuda.synchronize()
    assert fused_mlp_cuda.launches == launches + 1 and mlp.calls == calls
    plain = dataclasses.replace(trainer, field_cfg=dataclasses.replace(cfg, fused=False))
    ref = render(scene, dataclasses.replace(integ, cache=(field, plain)), spp=2)
    torch.testing.assert_close(img, ref, rtol=2e-2, atol=2e-3)


# ------------------------------ the integrator zoo ------------------------------

def _zoo_scene(device):
    """The Cornell box + a 4k-triangle sphere at 32x32 (the BVH path)."""
    from mitsuba3_experiments_tpu_torch.scene import cornell_box
    from mitsuba3_experiments_tpu_torch.scene import mesh as meshlib

    d = cornell_box(res=32, spp=2)
    sph = meshlib.sphere(center=(0.3, -0.5, 0.2), radius=0.3, n_theta=32, n_phi=64)
    d["sphere"] = {"type": "mesh", "vertices": sph.vertices, "faces": sph.faces,
                   "normals": sph.normals, "bsdf": {"type": "dielectric"}}
    return load_dict(d, device=device)[0]


def _zoo_run(name, scene):
    from mitsuba3_experiments_tpu_torch import integrators as I

    def frames(integ, step):
        st = integ.init_state(scene)
        for i in range(2):
            img, st = step(integ, st, i)
        return img, st

    if name == "simple":
        return I.render(scene, I.SimpleIntegrator(max_depth=4), spp=2), None
    if name == "render_wavefront":
        return I.render_wavefront(scene, spp=2, max_depth=4, rfilter="tent"), None
    if name == "ptracer":
        return I.ParticleTracer(max_depth=4).render(scene, spp=2), None
    if name == "render_spectral":
        return I.render_spectral(scene, I.SpectralIntegrator(max_depth=4), spp=2), None
    if name.startswith("bdpt"):
        return I.render(scene, I.BDPTIntegrator(max_depth=4, mis=name == "bdpt"), spp=2), None
    if name == "sppm":
        img, st = frames(I.SPPM(max_depth=4, photon_count=1 << 14, initial_radius=0.1),
                         lambda integ, st, i: integ.render_frame(scene, st, i))
        return img, (st.radius2, st.tau)
    img, st = frames(I.RestirGI(max_depth=3),
                     lambda integ, st, i: integ.render_frame_chunked(scene, st, i, chunk=256))
    return img, (st.spatial.W, st.search_radius)


@pytest.mark.parametrize("name", ["simple", "render_wavefront", "ptracer", "render_spectral",
                                  "bdpt", "bdpt_reference", "sppm", "restirgi"])
def test_zoo_card_matches_cpu(card, name):
    """Each integrator of the zoo on the card (K1, counted by
    bvh_cuda.launches, and no plain traversal) equals the CPU's render
    within rtol 1e-3 / atol 1e-4 on at least 0.99 of the pixels, means
    within 1e-3 relative; SPPM's and ReSTIR's state too."""
    launches, plain = bvh_cuda.launches, bvh_torch.calls
    got, got_state = _zoo_run(name, _zoo_scene(card))
    torch.cuda.synchronize()
    assert bvh_cuda.launches > launches and bvh_torch.calls == plain
    ref, ref_state = _zoo_run(name, _zoo_scene(torch.device("cpu")))
    got = got.cpu()
    assert torch.isfinite(got).all() and float(ref.mean()) > 0
    assert abs(float(got.mean()) / float(ref.mean()) - 1.0) < 1e-3
    close = torch.isclose(got, ref, rtol=1e-3, atol=1e-4).all(dim=-1).float().mean()
    assert float(close) >= 0.99
    for a, b in zip(got_state or (), ref_state or ()):
        assert float(torch.isclose(a.cpu(), b, rtol=1e-3, atol=1e-4).float().mean()) >= 0.99


# ------------------------ the MCMC and learned-sampling slice ------------------------

@pytest.mark.parametrize("mode", ["path", "simple"])
def test_pssmlt_step_card_matches_cpu(card, mode):
    """Three PSSMLT rounds (two bootstrap, one sampling) on the card (K1,
    no plain traversal) and on the CPU from the same state: at least 0.99
    of the chains in the same state, the accumulators' means and b_sum
    within 1e-3 relative."""
    from mitsuba3_experiments_tpu_torch.integrators import Pssmlt

    integ = Pssmlt(max_depth=4, mode=mode, bootstrap_count=2)
    runs = []
    for dev in (card, torch.device("cpu")):
        scene = _zoo_scene(dev)
        n = 32 * 32
        st = integ.init_state(n, device=dev)
        acc = torch.zeros((n, 3), device=dev)
        launches, plain = bvh_cuda.launches, bvh_torch.calls
        for i in range(3):
            st, acc = integ.step(scene, st, acc, 5, i, i < 2)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert bvh_cuda.launches > launches and bvh_torch.calls == plain
        runs.append((st, acc.cpu()))
    (sg, ag), (sc, ac) = runs
    same = torch.isclose(sg.pos.cpu(), sc.pos, rtol=1e-4, atol=1e-5).all(-1)
    same &= torch.isclose(sg.L.cpu(), sc.L, rtol=1e-3, atol=1e-4).all(-1)
    assert float(same.float().mean()) >= 0.99
    assert abs(float(ag.mean()) / float(ac.mean()) - 1.0) < 1e-3
    assert abs(float(sg.b_sum) / float(sc.b_sum) - 1.0) < 1e-3


@pytest.mark.parametrize("coupling", ["affine", "rqs"])
def test_flow_log_eval_card_matches_cpu(card, coupling):
    """flow_log_eval on the card against the CPU on the same parameters and
    points, at the bf16 tolerance of the CPU tests: every value within 2e-2,
    at least 0.9 of the rows within 1e-5."""
    from mitsuba3_experiments_tpu_torch.models import normflow as nf

    cfg = nf.FlowConfig(coupling=coupling, n_couplings=4, hidden=32)
    params = nf.init_flow(torch.Generator().manual_seed(2), cfg, device="cpu")
    for layer in (l for net in params for l in net):
        layer["w"].mul_(10.0)
        layer["b"].normal_(0.0, 0.15, generator=torch.Generator().manual_seed(3))
    x = torch.rand((4096, 2), generator=torch.Generator().manual_seed(4)) * 1.4 - 0.2
    with torch.no_grad():
        ref = nf.flow_log_eval(params, cfg, x)
        card_params = [[{k: v.to(card) for k, v in l.items()} for l in net] for net in params]
        got = nf.flow_log_eval(card_params, cfg, x.to(card)).cpu()
    torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2)
    assert float(torch.isclose(got, ref, rtol=1e-5, atol=1e-5).float().mean()) >= 0.9


def test_sharded_entry_points_in_a_one_rank_nccl_group(card, tmp_path):
    """parallel/ on CUDA tensors in a one-rank NCCL group: render_sharded
    (padded chunks) and render_persistent_sharded equal the single-device
    renders per pixel, sharded_replay_grad equals replay_render_grad, each
    launching K1 and never the plain traversal."""
    from datetime import timedelta

    import torch.distributed as dist

    from mitsuba3_experiments_tpu_torch.integrators import (
        PathIntegrator, render, render_persistent, replay_render_grad)
    from mitsuba3_experiments_tpu_torch.parallel import (
        make_mesh, render_persistent_sharded, render_sharded, sharded_replay_grad)
    from mitsuba3_experiments_tpu_torch.scene import cornell_box, params

    box = load_dict(cornell_box(res=32, spp=1), device=card)[0]
    integ = PathIntegrator(max_depth=3, rr_depth=2)
    diff = {k: params.traverse(box)[k] for k in ("materials.base_color", "emitters.radiance")}
    target = torch.rand((32, 32, 3), generator=torch.Generator().manual_seed(1)).to(card)
    n = 32 * 32 * 2
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    try:
        mesh = make_mesh(1)
        launches, calls = bvh_cuda.launches, bvh_torch.calls
        img = render_sharded(box, integ, mesh, spp=2, seed=7, chunk=700)
        pers = render_persistent_sharded(box, mesh, seed=3, spp=2, max_depth=3, rr_depth=2)
        loss, g, _ = sharded_replay_grad(box, diff, target, 4, mesh, n_lanes=512, spp=2,
                                         max_depth=3, rr_depth=2, ray_end=n, chunk=256)
        assert bvh_cuda.launches > launches and bvh_torch.calls == calls
    finally:
        dist.destroy_process_group()
    torch.testing.assert_close(img, render(box, integ, spp=2, seed=7), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(pers, render_persistent(box, seed=3, spp=2, max_depth=3,
                                                       rr_depth=2), rtol=1e-4, atol=1e-5)
    ref = replay_render_grad(box, diff, params.update, target, 4, 0, n, spp=2, max_depth=3,
                             rr_depth=2)
    assert torch.isfinite(loss)
    for k, v in ref.items():
        torch.testing.assert_close(g[k], v, rtol=2e-3, atol=2e-4 * float(v.abs().max()))


def test_two_gloo_ranks_on_one_card(card, tmp_path):
    """Two rank processes on cuda:0 in a gloo group (NCCL takes one rank a
    card; tests/torch_parallel_ranks.py's render suite): every image equal
    to the single-device render on the card, per pixel."""
    import torch_parallel_ranks as ranks

    from mitsuba3_experiments_tpu_torch.integrators import (
        PathIntegrator, render, render_persistent)

    res = ranks.collect(ranks.start("render", 2, str(tmp_path), device="cuda:0"), str(tmp_path))
    box = load_dict(ranks.box_dict(32), device=card)[0]
    fov = load_dict(ranks.box_dict(32, fov=15.0), device=card)[0]
    integ = PathIntegrator(max_depth=ranks.DEPTH, rr_depth=ranks.RR)
    refs = {"box": render(box, integ, spp=4, seed=5), "fov": render(fov, integ, spp=2, seed=7),
            "persistent": render_persistent(box, seed=3, spp=2, max_depth=ranks.DEPTH,
                                            rr_depth=ranks.RR)}
    refs["fov_chunk"] = refs["fov"]
    for r in res:
        for k, ref in refs.items():
            np.testing.assert_allclose(r[k], ref.cpu().numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


# ---- K5: the path replay kernels -------------------------------------------

def _replay_chunk(scene, depth, spp=2, seed=3):
    from mitsuba3_experiments_tpu_torch.integrators import record_full

    w, h = scene.camera.resolution
    n = w * h * spp
    rec = record_full(scene, seed, n, spp=spp, max_depth=depth, rr_depth=4, pad_to=n + 100)
    kw = dict(spp=spp, max_depth=depth, rr_depth=4, ray_end=n)
    dL = torch.as_tensor(np.random.default_rng(depth).normal(size=(n + 100, 3)),
                         dtype=torch.float32, device="cuda")
    return rec, kw, dL


def _plain_grads(scene, rec, seed, kw, dL):
    from mitsuba3_experiments_tpu_torch.integrators import replay
    from mitsuba3_experiments_tpu_torch.scene import params

    p = {k: params.traverse(scene)[k].detach().clone().requires_grad_(True)
         for k in ("materials.base_color", "emitters.radiance")}
    L = replay.replay_radiance_plain(params.update(scene, p), rec, seed, 0, **kw)[0]
    return L.detach(), torch.autograd.grad((L * dL).sum(), list(p.values()))


def _assert_grads(got, ref):
    for g, r in zip(got, ref):
        scale = float(r.abs().max())
        assert scale > 0 and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-4 * scale)


@pytest.mark.parametrize("depth", [8, 65])
def test_replay_kernel_matches_plain(scene, depth):
    from mitsuba3_experiments_tpu_torch.integrators import replay, replay_cuda
    from mitsuba3_experiments_tpu_torch.scene import params

    rec, kw, dL = _replay_chunk(scene, depth)
    L_p, g_p = _plain_grads(scene, rec, 3, kw, dL)
    p = {k: params.traverse(scene)[k].detach().clone().requires_grad_(True)
         for k in ("materials.base_color", "emitters.radiance")}
    fwd, adj, plain = replay_cuda.forward_launches, replay_cuda.adjoint_launches, \
        replay.plain_calls
    L = replay.replay_radiance(params.update(scene, p), rec, 3, 0, **kw)[0]
    g = torch.autograd.grad((L * dL).sum(), list(p.values()))
    torch.cuda.synchronize()
    assert replay_cuda.forward_launches == fwd + 1 and replay_cuda.adjoint_launches == adj + 1
    assert replay.plain_calls == plain
    close = torch.isclose(L, L_p, rtol=1e-4, atol=1e-5).all(dim=1).float().mean()
    assert float(close) >= 0.9999, float(close)
    _assert_grads(g, g_p)


@pytest.mark.parametrize("shared", [True, False])
def test_replay_adjoint_table_accumulation(scene, shared):
    from mitsuba3_experiments_tpu_torch.integrators import replay_cuda

    rec, kw, dL = _replay_chunk(scene, 8)
    _, g_p = _plain_grads(scene, rec, 3, kw, dL)
    packed = replay_cuda.pack_args(scene, rec, 3, 0, **kw)
    got = replay_cuda.replay_adjoint(packed, dL, shared=shared)
    torch.cuda.synchronize()
    _assert_grads(got, g_p)
    assert packed.args.shared_tables == int(shared)
    # a table of 20,000 materials does not fit a block's 227 KB: global atomics
    assert replay_cuda.shared_fits(20, 2) and not replay_cuda.shared_fits(20_000, 0)


def _replay_step_case(scene):
    """(target, record, film, n, padded rows, the two K5 keys' tensors) of
    a depth-8 record of the stand-in, in chunks of 1024."""
    from mitsuba3_experiments_tpu_torch.integrators import (
        PathIntegrator, record_full_pipelined, render)
    from mitsuba3_experiments_tpu_torch.scene import params

    w, h = scene.camera.resolution
    n = w * h * 2
    pad = -(-n // 1024) * 1024
    with torch.no_grad():
        target = render(scene, PathIntegrator(max_depth=4), seed=9, spp=2, rfilter="box")
    rec, film = record_full_pipelined(scene, 3, n, spp=2, max_depth=8, rr_depth=4, pad_to=pad,
                                      return_film=True)
    diff = {k: params.traverse(scene)[k] for k in ("materials.base_color", "emitters.radiance")}
    return target, rec, film, n, pad, diff


@pytest.mark.parametrize("mode", ["full", "sorted", "trunc"])
def test_replay_grads_on_card_run_k5(scene, mode):
    """The step-level replay launches one K5 forward and one adjoint a
    chunk, and its gradients equal the plain CPU replay of the same record
    (copied to the CPU) within 1e-4 of the largest entry."""
    from mitsuba3_experiments_tpu_torch.integrators import PathRecord, replay, replay_cuda, \
        replay_grads
    from mitsuba3_experiments_tpu_torch.scene import params, scene_from_numpy, scene_to_numpy

    target, rec, film, n, pad, diff = _replay_step_case(scene)
    kw = dict(chunk=1024, spp=2, max_depth=8, rr_depth=4, mode=mode)
    fwd, adj, plain = replay_cuda.forward_launches, replay_cuda.adjoint_launches, \
        replay.plain_calls
    g = replay_grads(scene, diff, params.update, target, 3, rec, n, film=film, **kw)
    torch.cuda.synchronize()
    chunks = pad // 1024
    assert replay_cuda.forward_launches == fwd + chunks
    assert replay_cuda.adjoint_launches == adj + chunks
    assert replay.plain_calls == plain
    host = scene_from_numpy(scene_to_numpy(scene), device="cpu")
    rec_h = PathRecord(*(getattr(rec, f).cpu() for f in ("prim", "u", "v", "occl")))
    ref = replay_grads(host, {k: v.cpu() for k, v in diff.items()}, params.update, target.cpu(),
                       3, rec_h, n, film=film.cpu(), **kw)
    for k, v in g.items():
        r = ref[k]
        assert bool(torch.isfinite(v).all()) and float(r.abs().max()) > 0, k
        torch.testing.assert_close(v.cpu(), r, rtol=0, atol=1e-4 * float(r.abs().max()),
                                   msg=lambda m, k=k: f"{mode} {k}: {m}")


@pytest.mark.parametrize("mode", ["full", "sorted"])
def test_replay_grads_on_card_wait_once_a_call(scene, mode):
    """A full-mode replay_grads call waits for the device once (K5's scene
    packing: the F_dr nodes), a sorted one twice (and its depth classes'
    `.tolist()`), each inside an `m3t.wait` span; one `m3t.k5.pack` a call."""
    from mitsuba3_experiments_tpu_torch.integrators import replay_grads
    from mitsuba3_experiments_tpu_torch.scene import params

    target, rec, film, n, pad, diff = _replay_step_case(scene)

    def call():
        return replay_grads(scene, diff, params.update, target, 3, rec, n, chunk=1024, spp=2,
                            max_depth=8, rr_depth=4, mode=mode, film=film)

    call()                                     # builds, first allocations
    spans, syncs = _waits_and_syncs(call)
    waits = 1 if mode == "full" else 2
    assert spans["m3t.wait"] == len(syncs) == waits, (spans, syncs)
    assert all("m3t.wait" in s[1] for s in syncs), syncs
    assert spans["m3t.k5.pack"] == 1 and spans["m3t.replay.chunk"] == pad // 1024, spans


def test_replay_on_card_raises_for_other_keys(scene):
    from mitsuba3_experiments_tpu_torch.integrators import replay
    from mitsuba3_experiments_tpu_torch.scene import params

    rec, kw, _ = _replay_chunk(scene, 4)
    for key in ("materials.params", "textures.data", "camera.to_world"):
        p = {key: params.traverse(scene)[key].detach().clone().requires_grad_(True)}
        with pytest.raises(ValueError, match=key):
            replay.replay_radiance(params.update(scene, p), rec, 3, 0, **kw)


SPAN_NAMES = {"m3t.record.batch", "m3t.bounce", "m3t.k1", "m3t.shade", "m3t.shade.pack",
              "m3t.compact", "m3t.wait", "m3t.splat", "m3t.replay.chunk", "m3t.k5.pack",
              "m3t.k5.forward", "m3t.k5.adjoint", "m3t.replay.loss"}


def _waits_and_syncs(fn):
    """fn() run under the profiler (CPU activity: the port's spans are on)
    and `torch.cuda.set_sync_debug_mode("warn")`: ({span name: count},
    [(the last frames of the stack, the `m3t.*` spans open on the warning's
    thread)]) for every sync but those of `set_sync_debug_mode` itself."""
    import contextlib
    import threading
    import traceback
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from mitsuba3_experiments_tpu_torch.utils import profile as prof_mod

    opened = threading.local()                 # the spans open on each thread
    record_function = prof_mod.record_function

    @contextlib.contextmanager
    def tracked(name):
        stack = opened.__dict__.setdefault("stack", [])
        stack.append(name)
        try:
            with record_function(name):
                yield
        finally:
            stack.pop()

    syncs = []

    def seen(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            stack = traceback.extract_stack()[:-1]
            if not any(f.name == "set_sync_debug_mode" for f in stack):
                syncs.append(([f"{f.filename.split('/')[-1]}:{f.lineno} {f.name}"
                               for f in stack[-4:]], tuple(getattr(opened, "stack", ()))))

    torch.cuda.synchronize()
    with warnings.catch_warnings(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(prof_mod, "record_function", tracked)
        warnings.simplefilter("always")
        warnings.showwarning = seen
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("m3t."):
            spans[e.name()] = spans.get(e.name(), 0) + 1
    return spans, syncs


@pytest.mark.parametrize("mode", ["full", "sorted", "render"])
def test_every_host_wait_lies_in_a_wait_span(scene, mode):
    """One small record + replay step (full or sorted replay, as the
    benchmark's d8 and d65 cells run them) or one render step: every
    device->host wait that torch reports is reported inside an open
    `m3t.wait` span (on autograd's own thread for K5's backward), one for
    one.  The shading (K6) waits for nothing; its scene's packing once a
    step, for the F_dr nodes."""
    from mitsuba3_experiments_tpu_torch.integrators import (
        record_full_pipelined, render_pipelined, replay_grads)
    from mitsuba3_experiments_tpu_torch.scene import params

    w, h = scene.camera.resolution
    n = w * h * 2
    pad = -(-n // 1024) * 1024
    target = torch.full((h, w, 3), 0.25, device="cuda")
    diff = {k: params.traverse(scene)[k] for k in ("materials.base_color", "emitters.radiance")}

    def step():
        if mode == "render":
            return render_pipelined(scene, seed=3, spp=2, max_depth=8, rfilter="tent")
        rec, film = record_full_pipelined(scene, 3, n, spp=2, max_depth=8, rr_depth=4,
                                          pad_to=pad, return_film=True)
        return replay_grads(scene, diff, params.update, target, 3, rec, n, chunk=1024, spp=2,
                            max_depth=8, rr_depth=4, mode=mode, film=film)

    step()                                     # builds, first allocations
    spans, syncs = _waits_and_syncs(step)
    names = SPAN_NAMES - ({"m3t.replay.chunk", "m3t.k5.pack", "m3t.k5.forward",
                           "m3t.k5.adjoint", "m3t.replay.loss"} if mode == "render" else set())
    uncovered = [s for s in syncs if "m3t.wait" not in s[1]]
    report = (f"{len(syncs)} syncs, {spans.get('m3t.wait', 0)} m3t.wait spans; "
              f"outside a wait span: {uncovered}")
    print(f"[{mode}] {report}; spans {spans}")
    assert set(spans) >= names, sorted(names - set(spans))
    assert len(syncs) == spans["m3t.wait"] > 0 and not uncovered, report
    assert not [s for s in syncs if "m3t.shade" in s[1]], report
    assert spans["m3t.shade.pack"] == 1
    assert sum("m3t.shade.pack" in s[1] for s in syncs) == 1, report


# ---- K6: the wavefront's shading kernel --------------------------------------

# where trace_rays reads each field of _shade: every lane, or the lanes that go
# on (`cont`) or shoot a shadow ray (`active_em`)
SHADE_READ_ON = {"L": None, "cont": None, "active_em": None,
                 "f": "cont", "eta": "cont", "p": "cont", "pdf": "cont", "delta": "cont",
                 "next_o": "cont", "next_d": "cont", "nee_L": "active_em",
                 "shadow_o": "active_em", "shadow_d": "active_em", "shadow_maxt": "active_em"}


def _first_bounce(scene, mixed, spp=2, seed=3):
    """(camera origins, the lanes of shade_cuda.LANE_IN) of the frame's
    first bounce: every camera ray and its K1 closest hit; `mixed` draws
    each lane's depth in 1..8, its throughput, previous pdf and delta
    instead, so that roulette, the depth cut and the MIS branches show."""
    from mitsuba3_experiments_tpu_torch.integrators import persistent
    from mitsuba3_experiments_tpu_torch.intersect.bvh_torch import _query
    from mitsuba3_experiments_tpu_torch.render import sensor as sensorlib

    w, h = scene.camera.resolution
    n = w * h * spp
    dev = torch.device("cuda")
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    ray = sensorlib.sample_ray(scene.camera, persistent.ray_positions(scene.camera, seed, idx,
                                                                      spp))
    o, d = ray.o.contiguous(), ray.d.contiguous()
    t, face, u, v = _query(scene, Ray.make(o, d), torch.ones(n, dtype=torch.bool, device=dev),
                           False)
    rng = np.random.default_rng(11)
    if mixed:
        as_t = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt, device=dev)  # noqa: E731
        f = as_t(rng.uniform(0.0, 1.0, (n, 3)))
        eta, prev_pdf = as_t(rng.uniform(0.7, 1.5, n)), as_t(rng.uniform(0.0, 2.0, n))
        depth = as_t(rng.integers(1, 9, n), torch.int32)
        prev_delta = as_t(rng.random(n) < 0.3, torch.bool)
        prev_p = o + as_t(rng.normal(0.0, 0.5, (n, 3)))
    else:
        f = torch.ones((n, 3), device=dev)
        eta, prev_pdf = torch.ones(n, device=dev), torch.ones(n, device=dev)
        depth = torch.ones(n, dtype=torch.int32, device=dev)
        prev_delta, prev_p = torch.ones(n, dtype=torch.bool, device=dev), o
    L = torch.zeros((n, 3), device=dev)
    return o, (d, t, face, u, v, L, f, eta, depth, prev_p, prev_pdf, prev_delta, idx)


@pytest.mark.parametrize("mixed", [False, True])
def test_shade_kernel_matches_plain_on_the_standin(scene, mixed):
    """K6 against the plain `_shade` on the same card tensors, on the lanes
    where trace_rays reads each field: the discrete fields equal on every
    lane, the floats within rtol 1e-4 / atol 1e-6 (a transcendental's last
    place, carried through the GGX density) and bit for bit on at least
    0.9 of the lanes (the share is printed)."""
    from mitsuba3_experiments_tpu_torch.integrators import persistent, shade_cuda

    o, lanes = _first_bounce(scene, mixed)
    d, t, face, u, v, L, f, eta, depth, prev_p, prev_pdf, prev_delta, idx = lanes
    every = torch.ones(d.shape[0], dtype=torch.bool, device="cuda")
    launches = shade_cuda.launches
    packed = shade_cuda.pack_scene(scene, 3, max_depth=8, rr_depth=4)
    got = shade_cuda.shade(packed, *lanes)
    ref = persistent._shade(scene, 3, every, o, *lanes, max_depth=8, rr_depth=4)
    torch.cuda.synchronize()
    assert shade_cuda.launches == launches + 1
    shares = {}
    for field, on in SHADE_READ_ON.items():
        a, b = getattr(got, field), getattr(ref, field)
        if on is not None:
            a, b = a[getattr(ref, on)], b[getattr(ref, on)]
        if b.dtype == torch.bool:
            assert torch.equal(a, b), field
            continue
        same = a.view(torch.int32) == b.view(torch.int32)
        same = same.all(1) if same.dim() > 1 else same
        shares[field] = float(same.float().mean()) if same.numel() else 1.0
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6, msg=field)
    print(f"[K6 {'mixed' if mixed else 'first bounce'}] {d.shape[0]} lanes, "
          f"{int(ref.cont.sum())} cont, {int(ref.active_em.sum())} active_em; bit-equal shares "
          + ", ".join(f"{k} {v:.6f}" for k, v in shares.items()))
    assert min(shares.values()) >= 0.9, shares
    assert int(ref.cont.sum()) > 0 and int(ref.active_em.sum()) > 0


def test_render_and_record_with_k6_match_the_plain_path(scene, monkeypatch):
    """render_persistent and record_full_pipelined shade each bounce with one
    K6 launch and never the plain `_shade`; against the same calls with the
    plain `_shade` forced, the records agree as F5/F6 read them (prim and
    occl equal, u and v within 1e-6) on at least 0.999 of the rows and the
    per-ray radiance within rtol 1e-4 / atol 1e-5 on at least 0.999 of the
    rays (a direction's last place may move a hit)."""
    from mitsuba3_experiments_tpu_torch.integrators import (
        persistent, record_full_pipelined, render_persistent, shade_cuda)
    from mitsuba3_experiments_tpu_torch.intersect import bvh_torch

    w, h = scene.camera.resolution
    n = w * h * 2
    seen = {"bounces": 0, "plain": 0}
    query, shade = bvh_torch._query, persistent._shade

    def counted_query(scene, ray, active, any_hit):
        seen["bounces"] += not any_hit
        return query(scene, ray, active, any_hit)

    def counted_shade(*a, **k):
        seen["plain"] += 1
        return shade(*a, **k)

    def run():
        img = render_persistent(scene, seed=3, spp=2, max_depth=8, rr_depth=4, rfilter="tent")
        rec, film = record_full_pipelined(scene, 5, n, spp=2, max_depth=8, rr_depth=4,
                                          return_film=True)
        rayL = persistent.trace_rays(scene, 5, 0, n, n, spp=2, max_depth=8, rr_depth=4)
        torch.cuda.synchronize()
        return img, rec, film, rayL

    with monkeypatch.context() as mp:
        mp.setattr(persistent, "_query", counted_query)
        mp.setattr(persistent, "_shade", counted_shade)
        launches = shade_cuda.launches
        k6 = run()
        bounces = seen["bounces"]
        assert seen["plain"] == 0 and bounces > 8
        assert shade_cuda.launches - launches == bounces
        mp.setattr(shade_cuda, "pack_scene", lambda *a, **k: None)   # the plain path forced
        plain = run()
        assert shade_cuda.launches - launches == bounces and seen["plain"] > 0
    (img, rec, film, rayL), (img_p, rec_p, film_p, rayL_p) = k6, plain
    rows = (rec.prim == rec_p.prim).all(1) & (rec.occl == rec_p.occl).all(1) & \
        torch.isclose(rec.u, rec_p.u, rtol=0, atol=1e-6).all(1) & \
        torch.isclose(rec.v, rec_p.v, rtol=0, atol=1e-6).all(1)
    close = torch.isclose(rayL, rayL_p, rtol=1e-4, atol=1e-5).all(1)
    same = all(torch.equal(getattr(rec, k), getattr(rec_p, k)) for k in ("prim", "u", "v", "occl"))
    print(f"[K6 paths] record rows equal {float(rows.float().mean()):.6f} "
          f"({int((~rows).sum())} of {rows.numel()} differ), rays within rtol 1e-4 "
          f"{float(close.float().mean()):.6f}, record bit-equal {same}, rays bit-equal "
          f"{torch.equal(rayL, rayL_p)}, image max abs diff {float((img - img_p).abs().max()):.3e}, film max abs diff "
          f"{float((film - film_p).abs().max()):.3e}")
    assert float(rows.float().mean()) >= 0.999 and float(close.float().mean()) >= 0.999
    for a, b in ((img, img_p), (film, film_p)):
        assert bool(torch.isfinite(a).all()) and float(a.mean()) > 0
        assert abs(float(a.mean()) - float(b.mean())) <= 1e-3 * float(b.mean())
