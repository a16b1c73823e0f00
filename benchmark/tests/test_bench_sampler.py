"""The sampler seeds that a traffic mix gives its steps: drawn from `--seed`
by default, the invert driver's own (n + 1 for the n-th step) under
"sampler": "driver"."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from benchmark import harness, loops  # noqa: E402

CONFIG = {"resolution": [4, 2], "spp": 1, "max_depth": 2, "rr_depth": 1}
STEPS = ("warm", 0, 1, 2, "trace0")


def _loop(seed, **traffic):
    return loops.Loop(None, None, CONFIG, {"loop": "inverse", **traffic}, seed, None)


def test_driver_sampler_is_the_invert_drivers_for_every_seed():
    for seed in (7, 2**31 + 5, 4_600_000_001):
        lp = _loop(seed, sampler="driver", target_seed=0)
        assert [lp.step_seed(i) for i in STEPS] == [1, 2, 3, 4, 5]


def test_seeded_sampler_draws_each_step_from_the_seed():
    a, b = _loop(7), _loop(8)
    sa, sb = [a.step_seed(i) for i in STEPS], [b.step_seed(i) for i in STEPS]
    assert sa == [harness.sub_seed(7, f"step{i}") for i in STEPS]
    assert len(set(sa)) == len(STEPS) and not set(sa) & set(sb)
