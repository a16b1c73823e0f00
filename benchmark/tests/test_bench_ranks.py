"""A loop from a file of its own, and a cell that runs over several ranks.

A mix that names `loop_kinds/<name>.py` is found by `run.py` and
`calibrate.py` and runs as a one-card cell, with no process and no process
group.  A cell of two chips runs two gloo ranks on the CPU through the same
launcher as on the cards: both take the same steps, the result line counts
two devices, the rate is over the whole frame and the peak is the fullest
rank's.  A rank that raises in set-up or in the window, or that hangs in a
collective, ends the run with no result.  The loop is `probe_loop.py`: one
all-reduce of one tensor a step."""
import json
import os
import re
import shutil
import sys
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import bench_tiny  # noqa: E402

from benchmark import calibrate, harness, loops, multicard, run  # noqa: E402

pytest.importorskip("mitsuba3_experiments_tpu_torch")

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 2**31 + 1009
HOLD_MB = 256
READER = '''"""probe_ranks: the ranks whose readings ctx["by_rank"] holds."""


def read(ctx):
    assert len({b["n_steps"] for b in ctx["by_rank"]}) == 1
    return float(len(ctx["by_rank"]))
'''


def _root(tmp_path, cells: dict) -> str:
    """The tiny root with the probe loop as `loop_kinds/probe.py` and a cell
    for each {name: (chips, mix parameters)}."""
    root = bench_tiny.make_root(tmp_path)
    bench = os.path.join(root, "benchmark")
    os.makedirs(os.path.join(bench, "loop_kinds"))
    shutil.copy(os.path.join(HERE, "probe_loop.py"), os.path.join(bench, "loop_kinds", "probe.py"))
    with open(os.path.join(bench, "layer_metrics", "probe_ranks.py"), "w") as f:
        f.write(READER)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for name, (chips, mix) in cells.items():
        with open(os.path.join(bench, "traffic", name + ".json"), "w") as f:
            json.dump({"loop": "probe", **mix}, f)
        with open(os.path.join(bench, "limits", name + ".json"), "w") as f:
            json.dump({"sum_off": 0.0}, f)
        spec["workloads"].append({"name": name, "config": "tiny", "traffic": name,
                                  "chips": chips, "why": "test"})
        for m in spec["end_to_end"]:
            if "tiny-render" in m.get("workloads", []):
                m["workloads"].append(name)
    spec["per_layer"].append({"name": "probe_ranks", "unit": "1", "better": "higher",
                              "source": "program_counter", "layer": "harness",
                              "moves": "fwd_rays_per_s", "workloads": list(cells)})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


def _no_ranks(monkeypatch):
    """Any process, process group or harness message fails the test."""
    import torch.distributed as dist

    def refuse(*a, **k):
        raise AssertionError("a one-card cell started a process, a group or a message")

    monkeypatch.setattr(multicard, "launch", refuse)
    monkeypatch.setattr(dist, "init_process_group", refuse)
    for name in ("barrier", "window_over", "gather"):
        monkeypatch.setattr(multicard.Ranks, name, refuse)


@pytest.mark.parametrize("trace", [False, True])
def test_a_loop_file_runs_as_a_one_card_cell(tmp_path, monkeypatch, trace):
    import torch.distributed as dist

    root = _root(tmp_path, {"probe-1": (1, {"sleep_s": 0.01})})
    _no_ranks(monkeypatch)
    line, checks = run.run_cell("probe-1", SEED, 0.3, trace, device="cpu", root=root,
                                cache=str(tmp_path / "cache"), log=lambda s: None)
    out = json.loads(line)
    assert not dist.is_initialized()
    assert out["correct"] is True and out["device"]["count"] == 1
    assert "ranks" not in out and "busy_s_ranks" not in out["device"]
    assert out["checks"] == {"sum_off": {"value": 0.0, "limit": 0.0}}
    if trace:
        assert out["metrics"]["probe_ranks"]["value"] == 1.0
    else:
        assert set(out["metrics"]) == {"fwd_rays_per_s", "step_p90_ms", "peak_mem_gb", "setup_s"}


def test_calibrate_finds_a_loop_file(tmp_path, monkeypatch):
    root = _root(tmp_path, {"probe-1": (1, {})})
    _no_ranks(monkeypatch)
    out = calibrate.calibrate("probe-1", [5, SEED], 1, device="cpu", root=root,
                              cache=str(tmp_path / "cache"), log=lambda s: None)
    assert out["program"] == {"sum_off": [0.0, 0.0]}
    assert out["control"] == {"sum_off": [0.0]}


def test_calibrate_runs_the_ranks_through_the_launcher(tmp_path):
    root = _root(tmp_path, {"probe-2": (2, {"sleep_s": 0.01})})
    lines = []
    rc = calibrate.calibrate_ranks("probe-2", 2, 1, SEED, 2, device="cpu", root=root,
                                   cache=str(tmp_path / "cache"), log=lines.append)
    assert rc == 0, lines
    seeds = [json.loads(s) for s in lines if s.startswith('{"seed"')]
    assert [s["program"] for s in seeds] == [{"sum_off": 0.0}] * 2
    assert json.loads(lines[-1]) == {"workload": "probe-2", "readings": {
        "sum_off": {"program_max": 0.0, "control_min": 0.0}}}


def test_an_unknown_loop_is_refused_and_a_builtin_one_takes_one_card(tmp_path):
    root = _root(tmp_path, {})
    bench = os.path.join(root, "benchmark")
    with pytest.raises(KeyError) as e:
        harness.load_loop(bench, "no-such-loop")
    assert "loops.LOOPS" in str(e.value) and os.path.join("loop_kinds", "no-such-loop.py") in str(
        e.value)
    assert harness.load_loop(bench, "probe")          # the file is found
    make = harness.load_loop(bench, "render")
    with pytest.raises(ValueError, match="needs a loop file"):
        make(None, None, None, None, 0, None, ranks=multicard.Ranks(0, 2, "cpu"))


def _window(lines):
    """(steps, seconds) of rank 0's window line."""
    m = [re.match(r"# window: (\d+) steps in ([0-9.]+) s", s) for s in lines]
    m = [x for x in m if x]
    assert len(m) == 1, lines
    return int(m[0].group(1)), float(m[0].group(2))


@pytest.mark.parametrize("trace", [False, True])
def test_two_ranks_take_the_same_steps(tmp_path, trace):
    root = _root(tmp_path, {"probe-2": (2, {"hold_mb": HOLD_MB, "sleep_s": 0.02})})
    lines = []
    got = run.run_ranks("probe-2", SEED, 1.0, trace, 2, device="cpu", root=root,
                        cache=str(tmp_path / "cache"), log=lines.append)
    assert got is not None, lines
    out = json.loads(got[0])
    assert got[1] == ["check sum_off: 0.0 (limit 0.0)"]
    assert out["correct"] is True and list(out)[-1] == "checks"
    assert out["device"]["count"] == 2
    steps = out["ranks"]["steps"]
    assert steps == [out["attempted"]] * 2
    assert f"# rank 1: ranks' steps: {steps[0]} {steps[1]}" not in lines   # rank 0 logs them
    assert any(s.startswith(f"# ranks' steps: {steps[0]} {steps[1]}") for s in lines)
    peaks = out["ranks"]["memory_peak_bytes"]
    assert out["device"]["memory_peak_bytes"] == max(peaks)
    assert peaks[1] - peaks[0] > HOLD_MB * 2**20 // 2      # rank 1 holds HOLD_MB more
    if trace:
        assert len(out["device"]["busy_s_ranks"]) == 2
        assert out["device"]["busy_s"] == sum(out["device"]["busy_s_ranks"]) / 2
        assert out["metrics"] == {"probe_ranks": {"value": 2.0, "unit": "1"}}
    else:
        n, window_s = _window(lines)
        assert n == out["attempted"] and window_s >= 1.0
        frame = 32 * 18 * 4                              # the whole frame, both ranks
        assert out["metrics"]["fwd_rays_per_s"]["value"] == pytest.approx(
            frame * n / window_s, rel=1e-3)
        assert out["metrics"]["peak_mem_gb"]["value"] == max(peaks) / 1e9


@pytest.mark.parametrize("fail_at", ["setup", 2])
def test_a_failing_rank_ends_the_run(tmp_path, fail_at):
    root = _root(tmp_path, {"probe-fail": (2, {"fail_rank": 1, "fail_at": fail_at,
                                               "sleep_s": 0.02})})
    lines = []
    t0 = time.monotonic()
    got = run.run_ranks("probe-fail", SEED, 30.0, False, 2, device="cpu", root=root,
                        cache=str(tmp_path / "cache"), log=lines.append)
    assert got is None
    assert time.monotonic() - t0 < 60
    assert any(s.startswith("# the run ends: ") and "rank 1 exited with 1" in s
               for s in lines), lines


def test_a_hung_collective_ends_by_its_timeout(tmp_path):
    import torch

    root = _root(tmp_path, {"probe-hang": (2, {"fail_rank": 1, "hang_at": 2, "sleep_s": 0.02})})
    cell = harness.load_cell("probe-hang", root)
    cache = str(tmp_path / "cache")
    # the table cache first, so that no rank waits on a build in set-up
    loops.load_scene(loops.Port(), cell["bench_dir"], cell["config"], torch.device("cpu"), cache)
    lines = []
    t0 = time.monotonic()
    got = run.run_ranks("probe-hang", SEED, 30.0, False, 2, device="cpu", root=root, cache=cache,
                        log=lines.append, timeout_s=15.0)
    took = time.monotonic() - t0
    assert got is None
    assert 15.0 <= took < 75.0
    assert any(s.startswith("# the run ends: rank 0 exited with 1") for s in lines), lines
