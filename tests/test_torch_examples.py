"""The port's example drivers (examples/torch_*.py of the parallel slice,
scripts/torch_nerad_fused_bench.py, and the reference-workload drivers
scripts/torch_{flagship_fullspec,flagship_invert,nerad_fullrecipe,
scaling_bench}.py) run on the CPU at their smallest sizes.

Every case's process starts at once, one thread each, when the first case
runs; each case then waits for its own (at most 120 s) and checks that it
exited 0 and wrote its files, and that its JSON parses.
examples/torch_dryrun_multichip.py runs under torchrun in a gloo world of 2;
scripts/torch_scaling_bench.py starts its own gloo worlds of 1 and 2 ranks
on the synthetic bedroom skeleton of tests/torch_bedroom_skeleton.py
(`{xml}`), its flagship cache in the case's own directory (`{out}`).
"""
import json
import os
import subprocess
import sys

import pytest

import torch_bedroom_skeleton as skeleton

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
    "flagship_fullspec": (["scripts/torch_flagship_fullspec.py", "2", "4", "--res", "16", "9",
                           "--tri-budget", "5000"],
                          ["torch_flagship_spp2_d4.exr", "torch_flagship_spp2_d4.png",
                           "torch_flagship_spp2_d4.json"]),
    "flagship_invert": (["scripts/torch_flagship_invert.py", "2", "4", "--res", "16", "9",
                         "--tri-budget", "5000", "--chunk", "256"],
                        ["torch_flagship_invert.json", "torch_flagship_invert_start.png",
                         "torch_flagship_invert_final.png"]),
    "nerad_fullrecipe": (["scripts/torch_nerad_fullrecipe.py", "12", "6", "2", "--res", "8"],
                         ["torch_nerad_fullrecipe.json", "torch_nerad_fullrecipe_final.png",
                          "torch_nerad_fullrecipe_ref.png"]),
    "scaling_bench": (["scripts/torch_scaling_bench.py", "32", "2000", "--worlds", "1,2",
                       "--scene", "flagship", "--xml", "{xml}", "--cache-dir", "{out}/cache"],
                      ["torch_scaling_bench.json", "torch_scaling_scene.npz",
                       "world1/rank0.json", "world2/rank1.json"]),
}
WAIT_S = 120
ARTIFACTS = "artifacts/ before the runs"


def _tree(root):
    """{path: (size, mtime)} of every file under root."""
    return {os.path.join(d, f): (os.stat(os.path.join(d, f)).st_size,
                                 os.stat(os.path.join(d, f)).st_mtime_ns)
            for d, _, files in os.walk(root) for f in files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    xml = skeleton.write_skeleton(str(tmp_path_factory.mktemp("bedroom")), n_obj=10)
    started = {ARTIFACTS: _tree(os.path.join(REPO, "artifacts"))}
    for name, (cmd, _) in CASES.items():
        out = tmp_path_factory.mktemp(name)
        cmd = [a.format(xml=xml, out=out) for a in cmd]
        argv = cmd if cmd[0] == sys.executable else [sys.executable, *cmd]
        with open(out / "log.txt", "w") as log:
            started[name] = (subprocess.Popen([*argv, "--device", "cpu", "--out", str(out)],
                                              cwd=REPO, env=env, stdout=log,
                                              stderr=subprocess.STDOUT), out)
    yield started
    for name in CASES:
        proc = started[name][0]
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


def test_drivers_write_only_under_out(runs):
    """The drivers leave artifacts/ (the JAX package's outputs) as it was:
    no file added, removed or rewritten."""
    for name in CASES:
        try:
            runs[name][0].wait(timeout=WAIT_S)
        except subprocess.TimeoutExpired:
            pass
    assert _tree(os.path.join(REPO, "artifacts")) == runs[ARTIFACTS]
