"""The port's ops/ against the JAX package's, on the CPU.

Integer results are equal.  Float sums are held at rtol 1e-5 / atol 1e-6
unless stated (the two packages add in other orders); the blocked scan's
float32 path is held to the JAX Pallas kernel (interpret mode) at rtol
1e-4 / atol 1e-4, the bound tests/test_ops.py holds that kernel to."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu import ops as jops
from mitsuba3_experiments_tpu.ops import dispatch as jdispatch
from mitsuba3_experiments_tpu_torch import ops
from mitsuba3_experiments_tpu_torch.ops import dispatch, prefix_sum_cuda


def _data(dtype, n, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-1000, 1000, n).astype(np.int32)
    return rng.normal(size=n).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("exclusive", [False, True])
def test_prefix_sum(dtype, exclusive):
    x = _data(dtype, 1000, 1)
    ref = np.asarray(jops.prefix_sum(jnp.asarray(x), exclusive=exclusive))
    got = ops.prefix_sum(torch.as_tensor(x), exclusive=exclusive)
    assert got.dtype == torch.as_tensor(x).dtype
    if dtype == "int32":
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("n", [1, 1023, 5000])
def test_prefix_sum_blocked_matches_pallas_interpret(dtype, n):
    """K3's plain version (the CPU path of prefix_sum_blocked) against the
    TPU kernel in interpret mode."""
    x = _data(dtype, n, 2)
    ref = np.asarray(jops.prefix_sum_pallas(jnp.asarray(x), block=1024, interpret=True))
    calls = prefix_sum_cuda.plain_calls
    got = ops.prefix_sum_blocked(torch.as_tensor(x))
    assert prefix_sum_cuda.plain_calls == calls + 1
    assert got.dtype == torch.as_tensor(x).dtype and got.shape == (n,)
    if dtype == "int32":
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_scan_stream_state_grows_and_wraps(monkeypatch):
    """The look-back's per-stream state (held on the CPU here): the status
    words grow to a power of two when a call needs more and keep their size
    otherwise; each call gets the next epoch; when the epochs run out the
    words are zeroed once and the epochs restart at 1."""
    st = prefix_sum_cuda._StreamState(torch.device("cpu"))
    st.next_call(5)
    assert st.status.numel() == 8 and st.epoch == 1
    st.status.fill_(7)
    st.next_call(3)
    assert st.status.numel() == 8 and st.epoch == 2 and int(st.status[0]) == 7
    st.next_call(9)
    assert st.status.numel() == 16 and st.epoch == 3 and int(st.status.abs().sum()) == 0
    st.status.fill_(7)
    monkeypatch.setattr(prefix_sum_cuda, "_EPOCH_END", 5)
    st.next_call(1)
    assert st.epoch == 4 and int(st.status[0]) == 7
    st.next_call(1)
    assert st.epoch == 1 and int(st.status.abs().sum()) == 0
    assert int(st.ticket[0]) == 0 and st.ticket_base == 0


def test_prefix_sum_blocked_int32_wraps():
    x = np.full(4096, 2**30, np.int32)
    got = ops.prefix_sum_blocked(torch.as_tensor(x)).numpy()
    ref = (np.cumsum(x.astype(np.int64)) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(got, ref)


def test_prefix_sum_blocked_rejects_what_it_does_not_take():
    with pytest.raises(ValueError):
        ops.prefix_sum_blocked(torch.zeros(8, dtype=torch.float64))
    with pytest.raises(ValueError):
        ops.prefix_sum_blocked(torch.zeros((2, 4), dtype=torch.float32))
    with pytest.raises(ValueError):
        ops.prefix_sum_blocked(torch.zeros(8, dtype=torch.float32, device="meta"))


@pytest.mark.parametrize("op", ["add", "min", "max", "mul"])
def test_scatter_reduce(op):
    rng = np.random.default_rng(3)
    v = rng.uniform(0.5, 1.5, (200, 3)).astype(np.float32)
    idx = rng.integers(0, 17, 200).astype(np.int32)
    tgt = rng.uniform(0.5, 1.5, (17, 3)).astype(np.float32)
    ref = np.asarray(jops.scatter_reduce(op, jnp.asarray(tgt), jnp.asarray(v), jnp.asarray(idx)))
    got = ops.scatter_reduce(op, torch.as_tensor(tgt), torch.as_tensor(v), torch.as_tensor(idx))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("combine", ["max", "add", "tree"])
def test_scatter_reduce_with(combine):
    rng = np.random.default_rng(4)
    n, k = 300, 23
    idx = rng.integers(0, k, n).astype(np.int32)
    v = rng.normal(size=(n, 2)).astype(np.float32)
    w = rng.normal(size=n).astype(np.float32)
    tgt = np.zeros((k, 2), np.float32)
    tw = np.zeros(k, np.float32)
    if combine == "tree":
        # keep the (w, v) pair with the larger w.  The JAX function does not
        # take trees (its scan indexes the tuple's leaves as arrays), so the
        # reference is a numpy loop
        def ft(a, b):
            keep = a[0] > b[0]
            return (torch.where(keep, a[0], b[0]), torch.where(keep[..., None], a[1], b[1]))

        got = ops.scatter_reduce_with(ft, (torch.as_tensor(tw), torch.as_tensor(tgt)),
                                      (torch.as_tensor(w), torch.as_tensor(v)),
                                      torch.as_tensor(idx))
        ref_w, ref_v = tw.copy(), tgt.copy()
        for k in np.unique(idx):
            best = np.flatnonzero(idx == k)[np.argmax(w[idx == k])]
            ref_w[k], ref_v[k] = w[best], v[best]
        np.testing.assert_array_equal(got[0].numpy(), ref_w)
        np.testing.assert_array_equal(got[1].numpy(), ref_v)
        return
    fj = jnp.maximum if combine == "max" else (lambda a, b: a + b)
    ft = torch.maximum if combine == "max" else (lambda a, b: a + b)
    ref = np.asarray(jops.scatter_reduce_with(fj, jnp.asarray(tgt), jnp.asarray(v),
                                              jnp.asarray(idx)))
    got = ops.scatter_reduce_with(ft, torch.as_tensor(tgt), torch.as_tensor(v),
                                  torch.as_tensor(idx)).numpy()
    if combine == "max":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_segment_sum_and_block_sum():
    rng = np.random.default_rng(5)
    v = rng.normal(size=(120, 3)).astype(np.float32)
    seg = rng.integers(0, 9, 120).astype(np.int32)
    ref = np.asarray(jops.segment_sum(jnp.asarray(v), jnp.asarray(seg), 9))
    got = ops.segment_sum(torch.as_tensor(v), torch.as_tensor(seg), 9)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    ref = np.asarray(jops.block_sum(jnp.asarray(v), 8))
    got = ops.block_sum(torch.as_tensor(v), 8)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        ops.block_sum(torch.as_tensor(v), 7)


def test_compaction():
    rng = np.random.default_rng(6)
    mask = rng.random(257) < 0.4
    key = rng.integers(0, 5, 257).astype(np.int32)
    ji, jc = jops.compress_indices(jnp.asarray(mask))
    ti, tc = ops.compress_indices(torch.as_tensor(mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(tc) == int(jc) and ti.dtype == torch.int32
    jp = jops.partition_by_key(jnp.asarray(key))
    tp = ops.partition_by_key(torch.as_tensor(key))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ops.invert_permutation(tp).numpy(),
                                  np.asarray(jops.invert_permutation(jp)))


def test_concat():
    rng = np.random.default_rng(7)
    arrs = [rng.normal(size=(n, 2)).astype(np.float32) for n in (3, 0, 5)]
    ref = np.asarray(jops.concat_scatter([jnp.asarray(a) for a in arrs]))
    for fn in (ops.concat_gather, ops.concat_scatter):
        np.testing.assert_array_equal(fn([torch.as_tensor(a) for a in arrs]).numpy(), ref)


@pytest.mark.parametrize("mode", ["masked", "sorted"])
def test_dispatch(mode):
    rng = np.random.default_rng(8)
    tid = rng.integers(0, 3, 100).astype(np.int32)
    x = rng.normal(size=(100, 2)).astype(np.float32)
    jtab = [lambda a: a * 2.0, lambda a: a + 1.0, lambda a: jnp.sin(a)]
    ttab = [lambda a: a * 2.0, lambda a: a + 1.0, lambda a: torch.sin(a)]
    jfn = getattr(jdispatch, f"dispatch_{mode}")
    tfn = getattr(dispatch, f"dispatch_{mode}")
    ref = np.asarray(jfn(jtab, jnp.asarray(tid), jnp.asarray(x)))
    got = tfn(ttab, torch.as_tensor(tid), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    jperm, jinv = jdispatch.reorder_threads(jnp.asarray(tid), jnp.asarray(x))
    tperm, tinv = dispatch.reorder_threads(torch.as_tensor(tid), torch.as_tensor(x))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
