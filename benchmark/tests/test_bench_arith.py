"""The harness's arithmetic on synthetic numbers: rates, the percentile,
the spread, interval unions, and the readers on a synthetic profiler trace."""
import os
import sys
from types import SimpleNamespace

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from benchmark import harness  # noqa: E402

BENCH = harness.HERE


def test_rate_percentile_union():
    assert harness.rate(3_686_400, 10, 12.5) == pytest.approx(2_949_120.0)
    times = [float(i) for i in range(1, 41)]          # 40 steps
    assert harness.nearest_rank(times, 0.9) == 36.0   # ceil(0.9 * 40) = 36th
    assert harness.nearest_rank([5.0], 0.9) == 5.0
    assert harness.nearest_rank([3.0, 1.0, 2.0], 0.5) == 2.0
    assert harness.union_s([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert harness.union_s([]) == 0.0


def _trace():
    """Two traced steps of 100 us each (0-100, 200-300); device work: K1
    10-30, eager 40-60 and 50-70 (overlapping), K5 220-240, a memcpy
    250-260, and eager work 120-180 between the steps (left out)."""
    ann = lambda n, ts, dur: {"ph": "X", "cat": "user_annotation", "name": n, "ts": ts, "dur": dur}  # noqa: E731
    ker = lambda n, ts, dur, cat="kernel": {"ph": "X", "cat": cat, "name": n, "ts": ts, "dur": dur}  # noqa: E731
    events = [ann(harness.STEP_SPAN, 0, 100), ann(harness.STEP_SPAN, 200, 100),
              ann("record", 0, 80), ann("replay", 200, 100),
              ker("bvh8_traverse_kernel", 10, 20), ker("elementwise", 40, 20),
              ker("elementwise", 50, 20), ker("replay_forward_kernel", 220, 20),
              ker("Memcpy DtoD", 250, 10, "gpu_memcpy"), ker("elementwise", 120, 60)]
    return harness.Trace(events, 2)


def test_trace_busy_idle_and_kernels():
    tr = _trace()
    assert tr.window_s == pytest.approx(200e-6)
    assert tr.busy_s() == pytest.approx((20 + 30 + 20 + 10) * 1e-6)
    assert tr.kernel_s(lambda n: "bvh8" in n) == pytest.approx(20e-6)
    assert tr.top_ops(2) == [["elementwise", pytest.approx(40e-6)],
                             ["bvh8_traverse_kernel", pytest.approx(20e-6)]]
    gaps = tr.idle_gaps()
    # gaps: 0-10 record, 30-40 record, 70-100 (record until 80), 200-220,
    # 240-250, 260-300 replay
    assert [g[0] for g in gaps[:2]] == ["replay", "record"]
    assert gaps[0][1] == pytest.approx(40e-6) and gaps[1][1] == pytest.approx(30e-6)
    assert len(gaps) == 6


def _ctx(metric, trace, **kw):
    return {"trace": trace, "loop": SimpleNamespace(metric=metric), "spans": {},
            "collected": {}, "scene_load_s": 1.5, **kw}


def test_readers_on_a_synthetic_trace():
    tr = _trace()
    rd = lambda n: harness.load_reader(BENCH, n)  # noqa: E731
    fb = _ctx("fwd_bwd_rays_per_s", tr, spans={"record": [0.5, 0.7], "replay": [0.1]})
    assert rd("k1_device_ms.fwd_bwd").read(fb) == pytest.approx(20e-3 / 2)
    assert rd("k1_device_ms.render").read(fb) is None          # another loop's metric
    assert rd("eager_device_ms.fwd_bwd").read(fb) == pytest.approx(40e-3 / 2)  # summed, not united
    assert rd("device_idle_share.fwd_bwd").read(fb) == pytest.approx(100 * (1 - 80 / 200))
    assert rd("record_ms").read(fb) == pytest.approx(600.0)
    assert rd("replay_ms").read(fb) == pytest.approx(100.0)
    assert rd("scene_load_s").read(fb) == 1.5
    assert rd("k5_roofline").read(fb) is None                  # no bound collected
    fb["collected"]["k5_bound_s"] = 5e-6
    assert rd("k5_roofline").read(fb) == pytest.approx(100 * 5 / 20)
    r = _ctx("fwd_rays_per_s", tr)
    assert rd("k1_device_ms.render").read(r) == pytest.approx(10e-3)
    assert rd("record_ms").read(r) is None
    assert rd("device_idle_share.render").read(_ctx("fwd_rays_per_s", None)) is None


def test_window_rate_reader():
    rd = harness.load_reader(BENCH, "fwd_bwd_rays_per_s.d65")
    loop = SimpleNamespace(metric="fwd_bwd_rays_per_s", n_rays=3_686_400)
    ctx = {"loop": loop, "n_steps": 10, "window_s": 12.5}
    assert rd.read(ctx) == pytest.approx(2_949_120.0)
    assert rd.read({**ctx, "n_steps": 0}) is None
    assert rd.read({**ctx, "loop": SimpleNamespace(metric="fwd_rays_per_s", n_rays=1)}) is None


def test_result_line_puts_checks_last():
    import json

    line = harness.result_line(True, 3, 0, {"setup_s": {"value": 1.0, "unit": "s"}},
                               {"platform": "gpu"}, {"grad_gap": (1e-6, 1e-3)},
                               {"device_ops": [], "idle_gaps": []})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert out["checks"] == {"grad_gap": {"value": 1e-6, "limit": 1e-3}}


def test_sub_seeds_take_large_seeds():
    s = harness.sub_seed(2**31 + 12345, "step0")
    assert 0 <= s < 2**32
    assert s == harness.sub_seed(2**31 + 12345, "step0")
    assert s != harness.sub_seed(2**31 + 12345, "step1")
    assert harness.sub_seed(3 * 2**40, "x") != harness.sub_seed(3 * 2**40 + 1, "x")
