"""bench_torch.py, the port's benchmark, on the CPU: its configurations,
its command line, and the padding of its replay.

  * The configurations equal bench.py's (`_ladder()[0]`, its small lockstep
    rung, `_d65_rung()`) in res, spp, depth, tris, chunk and mode, with and
    without the BENCH_* overrides; bench.py imports jax only inside its
    worker, so its configuration functions load here.  One departure:
    bench_torch applies the overrides to the small rung too (bench.py's
    small rung is a fallback kept warm in the TPU compile cache).
  * `python3 bench_torch.py --device cpu` runs the small rung and, on the
    synthetic bedroom skeleton (tests/torch_bedroom_skeleton.py), the
    production rung at tiny sizes: exit 0, one JSON line last, labelled
    "cpu", the history under the given --out and never in
    bench_history.json.  Without a card and without --device cpu it exits
    non-zero and prints no JSON line.
  * The record's padding (rows past W*H*spp, up to a multiple of the replay
    chunk) adds nothing: `fwd_bwd` with a chunk that pads the last chunk
    gives the gradients of a chunk that does not pad, within rtol 1e-5 /
    atol 1e-6 max|g| (float32 sums in another order), in the full and the
    sorted mode.

The bench's forward and fwd+bwd are held against the JAX package in
test_torch_bench_forward.py, test_torch_bench_depth4.py,
test_torch_bench_depth16.py and test_torch_bench_lockstep.py, one file
each so that each stays near a minute (the JAX side's compiles of the
stand-in's every-BSDF programs take most of it).
"""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_bedroom_skeleton as skeleton
from mitsuba3_experiments_tpu_torch.scene import load_dict, standin_dict

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("res", "spp", "depth", "tris", "chunk", "mode")
TPU_KEYS = ("sched", "steps", "rec_steps", "rpl", "fwd_lanes", "n_lanes")
BENCH_ENV = ("BENCH_SMALL", "BENCH_SKIP_D65", "BENCH_RES", "BENCH_SPP", "BENCH_DEPTH",
             "BENCH_TRIS", "BENCH_CHUNK", "BENCH_REPLAY", "BENCH_SCHED", "BENCH_SCENE")
OVERRIDES = {"BENCH_RES": "640x360", "BENCH_SPP": "2", "BENCH_DEPTH": "5",
             "BENCH_TRIS": "50000", "BENCH_CHUNK": "512"}
TINY = {"BENCH_RES": "16x9", "BENCH_SPP": "2", "BENCH_DEPTH": "2", "BENCH_TRIS": "2000",
        "BENCH_CHUNK": "72"}


def load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def benches():
    return load("bench_torch"), load("bench")


def _cut(cfg):
    return None if cfg is None else {k: cfg.get(k) for k in KEYS}


@pytest.mark.parametrize("case", ["default", "overrides", "small", "skip_d65", "small_overrides"])
def test_configurations_equal_bench_py(benches, case, monkeypatch):
    port, ref = benches
    for k in BENCH_ENV:
        monkeypatch.delenv(k, raising=False)
    env = {"default": {}, "overrides": OVERRIDES, "small": {"BENCH_SMALL": "1"},
           "skip_d65": {"BENCH_SKIP_D65": "1"},
           "small_overrides": {"BENCH_SMALL": "1", **OVERRIDES}}[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rung, want = port._rung(), _cut(ref._ladder()[0])
    if case == "small_overrides":   # bench.py ignores the overrides on its small rung
        want.update(port._overrides())
        assert want["res"] == "640x360" and want["tris"] == 50_000
    assert _cut(rung) == want
    assert not set(rung) & set(TPU_KEYS), rung
    assert _cut(port._d65_rung()) == _cut(ref._d65_rung())
    if case == "default":
        assert (want["res"], want["spp"], want["depth"], want["tris"]) == ("1280x720", 4, 8,
                                                                         2_000_000)
        assert _cut(port._d65_rung())["depth"] == 65 and _cut(port._d65_rung())["spp"] == 4


def _env(extra):
    env = {k: v for k, v in os.environ.items() if k not in BENCH_ENV}
    env.update(extra, OMP_NUM_THREADS="2")
    return env


def _history_state():
    path = os.path.join(REPO, "bench_history.json")
    return os.stat(path).st_mtime_ns if os.path.exists(path) else None


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both CPU runs, started together: the small rung on the stand-in and
    the production rung on the skeleton (no companion)."""
    before = _history_state()
    xml = skeleton.write_skeleton(str(tmp_path_factory.mktemp("bedroom")), n_obj=10)
    runs = {}
    for name, args, env in (
            ("small", [], {"BENCH_SMALL": "1", **TINY}),
            ("production", ["--scene", "flagship", "--xml", xml],
             {"BENCH_SKIP_D65": "1", **TINY})):
        out = tmp_path_factory.mktemp(name)
        cmd = [sys.executable, os.path.join(REPO, "bench_torch.py"), "--device", "cpu",
               "--out", str(out), "--cache-dir", str(out / "cache"), *args]
        runs[name] = (subprocess.Popen(cmd, cwd=REPO, env=_env(env), stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True), out)
    done = {}
    for name, (proc, out) in runs.items():
        stdout, stderr = proc.communicate(timeout=300)
        done[name] = (proc.returncode, stdout, stderr, out)
    return done, before


@pytest.mark.parametrize("name", ["small", "production"])
def test_cli_runs_on_the_cpu(cli_runs, name):
    done, before = cli_runs
    rc, stdout, stderr, out = done[name]
    assert rc == 0, stdout + stderr
    lines = stdout.strip().splitlines()
    res = json.loads(lines[-1])
    assert all(line.startswith("#") for line in lines[:-1]), lines
    assert res["unit"] == "rays/s" and np.isfinite(res["value"]) and res["value"] > 0, res
    assert res["vs_baseline"] == 1.0
    assert res["extra"]["device"] == "cpu" and res["extra"]["fwd_rays_per_s"] > 0, res
    assert "fwd_bwd_d65_rays_per_s" not in res["extra"]
    assert not any(k.startswith("pct_of_ceiling") for k in res["extra"]), res
    scene = "standin" if name == "small" else "flagship"
    assert res["metric"].endswith(f"16x9 depth=2, 2000 tris, {scene} scene)"), res["metric"]
    assert sum("K1 launches 0, plain traversals" in line for line in lines) == 2, lines
    with open(out / "bench_history_torch.json") as f:
        hist = json.load(f)
    assert hist == {f"16x9-spp2-d2-t2000-{scene}": {"cpu": {
        "fwd": pytest.approx(res["extra"]["fwd_rays_per_s"], rel=1e-3),
        "fwd_bwd": pytest.approx(res["value"], rel=1e-3)}}}
    assert _history_state() == before   # bench_history.json is the JAX bench's
    if name == "production":
        assert any("mode auto, 1 chunks of 131072" in line for line in lines), lines
        assert os.listdir(out / "cache"), "the flagship's tables were not cached"


FAILING = {
    # no card and no --device cpu: nothing is measured on the CPU unasked
    "no_card": ([], {"CUDA_VISIBLE_DEVICES": ""}, "no CUDA device"),
    # a rung whose worker fails (an absent scene XML) ends the run
    "failing_rung": (["--device", "cpu", "--scene", "flagship", "--xml", "no/such/scene.xml"],
                     {}, "failed with exit code"),
    "bad_replay_mode": (["--device", "cpu"], {"BENCH_REPLAY": "fused"}, "BENCH_REPLAY"),
}


@pytest.mark.parametrize("case", list(FAILING))
def test_cli_fails_without_a_json_line(case, tmp_path):
    args, env, message = FAILING[case]
    out = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py"), *args,
                          "--out", str(tmp_path)], cwd=REPO,
                         env=_env({"BENCH_SMALL": "1", **TINY, **env}),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines()), out.stdout
    assert message in out.stderr, out.stderr
    assert not os.listdir(tmp_path), "a failed run wrote its history"


@pytest.fixture(scope="module")
def tiny_scene():
    return load_dict(standin_dict(res=(16, 9), spp=2, tri_budget=2_000), device="cpu")[0]


@pytest.mark.parametrize("mode", ["full", "sorted"])
def test_padded_rows_add_nothing(benches, tiny_scene, mode):
    port, _ = benches
    cfg = dict(res="16x9", spp=2, depth=4, replay=mode)
    target = port.forward(tiny_scene, cfg, 1)
    n_rays = 16 * 9 * 2
    padded, _ = port.fwd_bwd(tiny_scene, cfg, target, 1, chunk=128)   # 3 chunks, 96 rows padding
    exact, _ = port.fwd_bwd(tiny_scene, cfg, target, 1, chunk=n_rays)
    assert n_rays % 128
    for k in port.DIFF_KEYS:
        a, b = padded[k].numpy(), exact[k].numpy()
        assert np.abs(b).max() > 0 and np.isfinite(a).all(), k
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6 * np.abs(b).max(), err_msg=k)
