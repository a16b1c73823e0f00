"""bench_torch.py's timed fwd+bwd at depth 16 against the JAX package, on
the CPU.

On standin_dict(res=(32, 18), spp=2, tri_budget=2_000), compiled by each
package's load_dict, the bench's `fwd_bwd` (seed 1) with a chunk of 640 rows
(1,152 camera rays padded to 1,280), so that "auto" replays sorted, fed the
recorder's film, gives the gradients of bench.py's record_full_pipelined +
replay_grads (box, mode "auto") within rtol 1e-3 / atol 1e-4 max|g|,
tests/test_torch_replay_grads.py's tolerance.  Both take as target the
bench's seed-1 forward image, which test_torch_bench_forward.py holds equal
to the JAX package's.
"""
import torch

from torch_bench_pair import assert_grads_close, cfg, jax_fwd_bwd, load_bench, standin_pair

torch.set_num_threads(2)

DEPTH, CHUNK = 16, 640


def test_bench_fwd_bwd_matches_jax_depth16(monkeypatch):
    js, ts = standin_pair()
    bench = load_bench()
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls.append((name, kw.get("return_film", False), kw.get("film") is not None))
            return fn(*args, **kw)
        monkeypatch.setattr(bench, name, wrapped)

    spy("record_full_pipelined", bench.record_full_pipelined)
    spy("replay_grads", bench.replay_grads)
    target = bench.forward(ts, cfg(DEPTH), 1)
    got, record_s = bench.fwd_bwd(ts, cfg(DEPTH), target, 1, chunk=CHUNK)
    sorted_mode = DEPTH >= 16
    assert calls == [("record_full_pipelined", sorted_mode, False),
                     ("replay_grads", False, sorted_mode)], calls
    assert record_s > 0
    assert_grads_close(got, jax_fwd_bwd(js, DEPTH, target.numpy(), 1, CHUNK))
