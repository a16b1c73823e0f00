"""The port's example drivers (examples/torch_*.py of the parallel slice,
scripts/torch_nerad_fused_bench.py) run on the CPU at their smallest sizes.

Every case's process starts at once, one thread each, when the first case
runs; each case then waits for its own (at most 120 s) and checks that it
exited 0 and wrote its files, and that its JSON parses.
examples/torch_dryrun_multichip.py runs under torchrun in a gloo world of 2.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCHRUN = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
            "2"]

# name -> (command before --device/--out, files it writes)
CASES = {
    "render_path": (["examples/torch_render_path.py", "8", "2"],
                    ["torch_path_mis.exr", "torch_path_mis.png", "torch_path_simple.png",
                     "torch_render_path.json"]),
    "invert_radiance": (["examples/torch_invert_radiance.py", "2", "8", "1"],
                        ["torch_invert_final.png", "torch_invert_radiance.json"]),
    "train_nerad": (["examples/torch_train_nerad.py", "2", "6", "--res", "8", "--ref-spp", "2"],
                    ["torch_nerad_1.png", "torch_nerad_2.png", "torch_nerad_ref.png",
                     "torch_train_nerad.json"]),
    "bdpt_sppm_eval": (["examples/torch_bdpt_sppm_eval.py", "4", "1", "1", "--photons", "256"],
                       ["torch_bdpt_sppm_ref.png", "torch_bdpt_sppm_path.png",
                        "torch_bdpt_sppm_bdpt.png", "torch_bdpt_sppm_sppm.png",
                        "torch_bdpt_occluded_bdpt.png", "torch_bdpt_sppm_metrics.json"]),
    "restir_eval": (["examples/torch_restir_eval.py", "spatial", "2", "8", "32", "--ref-spp",
                     "2"],
                    ["restir_spatial_0.png", "restir_spatial_1.png",
                     "restir_spatial_metrics.json"]),
    "nerad_fused_bench": (["scripts/torch_nerad_fused_bench.py", "2", "256", "4", "--res", "8"],
                          ["torch_nerad_fused_bench.json"]),
    "dryrun_multichip": ([*TORCHRUN, "examples/torch_dryrun_multichip.py"],
                         ["torch_dryrun_multichip.json"]),
}
WAIT_S = 120


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    started = {}
    for name, (cmd, _) in CASES.items():
        out = tmp_path_factory.mktemp(name)
        argv = cmd if cmd[0] == sys.executable else [sys.executable, *cmd]
        with open(out / "log.txt", "w") as log:
            started[name] = (subprocess.Popen([*argv, "--device", "cpu", "--out", str(out)],
                                              cwd=REPO, env=env, stdout=log,
                                              stderr=subprocess.STDOUT), out)
    yield started
    for proc, _ in started.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("name", list(CASES))
def test_example_runs_on_the_cpu(runs, name):
    proc, out = runs[name]
    try:
        rc = proc.wait(timeout=WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    log = (out / "log.txt").read_text()
    assert rc == 0, f"{name}: exit {rc}\n{log[-3000:]}"
    for f in CASES[name][1]:
        assert (out / f).is_file(), f"{name} did not write {f}\n{log[-3000:]}"
        if f.endswith(".json"):
            json.loads((out / f).read_text())
