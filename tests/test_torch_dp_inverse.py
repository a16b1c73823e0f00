"""The four-card cell's step (the benchmark's loop file `inverse_dp`, over
`parallel.sharded_replay_grad`) on the CPU, against the benchmark's plain
reference.

Worlds of 4 and 3 gloo ranks (tests/torch_parallel_ranks.py, the suites
`dp_inverse_faults` and `dp_inverse`) run the loop's step twice on the
Cornell box at 16x16, spp 2, depth 3, in replay chunks of 96 rows; after
each step the loop's `gather` brings the records to rank 0.  For each step:

  * the all-reduced gradients equal the reference's whole-frame
    `replay_grads` of the gathered record within `grad_gap`'s limit;
  * the gathered record equals a one-process record of the same step row
    for row;
  * every rank's parameters are bit-equal, and `rank_param_gap` reads 0;
  * the check's numbers lie within the cell's limits.

Each rank's counters of a profiled step say that it traced only its own
slice and that the step made one all-reduce of the film and one a gradient
key.  The world of 3 splits the 512 rays unevenly (171 a rank, so one
pixel's samples lie on two ranks) and gives the world of 4's gradients.
Two planted faults come out not correct: a rank that zeroes its own
gradients before their all-reduce, and a gather that leaves one rank's
rows out.

A world of 2 replays a frame with a sample that lands in a pixel of the
next replay chunk (`strays`): the gradient equals the reference's in its
whole-frame form, and the reference's chunk-by-chunk form ("full", each
chunk's own squared error) is off by far more than rounding, which is why
the cell's check takes the whole-frame form.  Imports neither jax
nor the JAX package.
"""
import json
import os

import numpy as np
import pytest

import torch_parallel_ranks as ranks

LIMITS = os.path.join(ranks.ROOT, "benchmark", "limits", "d8-fwd-bwd-4chip.json")
STEPS = (0, 1)
KEYS = ("materials.base_color", "log_radiance")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """world size -> every rank's results; both worlds start at once."""
    started = {}
    for w, suite in ((4, "dp_inverse_faults"), (3, "dp_inverse"), (2, "strays")):
        out = str(tmp_path_factory.mktemp(f"dp_inverse_world{w}"))
        started[w] = (ranks.start(suite, w, out), out)
    got = {}

    def results(w):
        if w not in got:
            got[w] = ranks.collect(*started[w])
        return got[w]

    yield results
    for procs, _ in started.values():
        ranks.stop(procs)


@pytest.fixture(scope="module")
def limits():
    with open(LIMITS) as f:
        return json.load(f)


def _gap(got, ref) -> float:
    """grad_gap's arithmetic: max |got - ref| / max |ref|."""
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("world", [4, 3])
@pytest.mark.parametrize("step", STEPS)
def test_gradients_equal_the_reference_of_the_gathered_record(worlds, limits, world, step):
    r0 = worlds(world)[0]
    for k in KEYS:
        assert np.abs(r0[f"ref{step}:{k}"]).max() > 0
        assert _gap(r0[f"grads{step}:{k}"], r0[f"ref{step}:{k}"]) <= limits["grad_gap"], k


@pytest.mark.parametrize("world", [4, 3])
@pytest.mark.parametrize("step", STEPS)
def test_the_gathered_record_equals_one_process_record(worlds, world, step):
    r0 = worlds(world)[0]
    assert (r0[f"rec{step}:prim"] >= 0).any()
    for f in ("prim", "u", "v", "occl"):
        np.testing.assert_array_equal(r0[f"rec{step}:{f}"], r0[f"one{step}:{f}"], err_msg=f)


@pytest.mark.parametrize("world", [4, 3])
@pytest.mark.parametrize("step", STEPS)
def test_every_rank_takes_the_same_step(worlds, limits, world, step):
    res = worlds(world)
    assert len(res) == world
    for r in res[1:]:
        np.testing.assert_array_equal(r[f"params{step}"], res[0][f"params{step}"])
    checks = {k.split(":", 1)[1]: float(v) for k, v in res[0].items()
              if k.startswith(f"check{step}:")}
    assert set(checks) == set(limits)
    assert checks["rank_param_gap"] == 0.0
    assert all(v <= limits[k] for k, v in checks.items()), checks


@pytest.mark.parametrize("world", [4, 3])
def test_each_rank_traces_its_slice_and_reduces_once_a_tensor(worlds, world):
    res = worlds(world)
    n = ranks.GRAD_RES * ranks.GRAD_RES * ranks.GRAD_SPP
    per = -(-n // world)
    rays = [int(r["count:m3t.dp.rays"]) for r in res]
    assert rays == [min(per, n - k * per) for k in range(world)]
    film = ranks.GRAD_RES * ranks.GRAD_RES * 4 * 4                # (H, W, 4) float32
    grads = res[0]["params1"].nbytes                 # the gradients: a float32 a parameter
    for r in res:
        assert int(r["count:m3t.dp.allreduce_calls"]) == 1 + len(KEYS)
        assert int(r["count:m3t.dp.allreduce_bytes"]) == film + grads


@pytest.mark.parametrize("step", STEPS)
def test_an_uneven_split_gives_the_same_gradients(worlds, step):
    four, three = worlds(4)[0], worlds(3)[0]
    for k in KEYS:
        assert _gap(three[f"grads{step}:{k}"], four[f"grads{step}:{k}"]) <= 1e-5, k


@pytest.mark.parametrize("fault,numbers", [
    ("zero_grads", ("grad_gap",)),                  # a rank's gradients left out
    ("drop_rows", ("record_off", "grad_gap")),      # a rank's rows left out of the gather
])
def test_planted_faults_are_not_correct(worlds, limits, fault, numbers):
    r0 = worlds(4)[0]
    for n in numbers:
        assert float(r0[f"{fault}:{n}"]) > limits[n], n


def test_a_sample_across_a_chunk_edge_keeps_the_whole_frame_gradient(worlds):
    from types import SimpleNamespace

    import torch

    from benchmark import reference as ref_mod
    from mitsuba3_experiments_tpu_torch.integrators.persistent import ray_positions

    res = worlds(2)
    w, spp, chunk = ranks.STRAY_W, ranks.STRAY_SPP, ranks.STRAY_CHUNK
    n = w * 2 * spp
    idx = torch.arange(n)
    pos = ray_positions(SimpleNamespace(resolution=(w, 2)), ranks.STRAY_SEED, idx, spp)
    land = torch.floor(pos[:, 1]).long() * w + torch.floor(pos[:, 0]).long()
    across = (idx // chunk != land * spp // chunk) & (land < n // spp)
    assert across.nonzero().flatten().tolist() == [895]      # the frame has one such sample

    whole = {}
    for f in ("prim", "u", "v", "occl"):
        parts = [r[f"rec:{f}"][:int(r["n_valid"])] for r in res]
        assert [int(r["start"]) for r in res] == [0, len(parts[0])]
        whole[f] = torch.as_tensor(np.concatenate(parts))
    ref = ref_mod.RefScene.build(ranks.stray_dict(), torch.device("cpu"))
    g = {m: ref_mod.replay_grads(ref, ranks.params_of(ref.scene),
                                 torch.as_tensor(ranks.stray_target()), ranks.STRAY_SEED,
                                 ref_mod.as_record(**whole), n, chunk=chunk, spp=spp,
                                 max_depth=ranks.DEPTH, rr_depth=ranks.RR, mode=m)
         for m in ("full", "sorted")}
    for r in res[1:]:
        for k in ranks.DIFF_KEYS:
            np.testing.assert_array_equal(r[f"grads:{k}"], res[0][f"grads:{k}"])
    got = {k: torch.as_tensor(res[0][f"grads:{k}"]) for k in ranks.DIFF_KEYS}
    assert ref_mod.grad_gap(got, g["sorted"]) <= 1e-5
    assert ref_mod.grad_gap(got, g["full"]) > 1e-4          # the one sample, not rounding
