"""The harness on the card at the tiny size, and its refusal without one.
The card-only test is marked `cuda` and skips, with its reason, inside a
fixture where there is no card."""
import json
import os
import subprocess
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import bench_tiny  # noqa: E402

from benchmark import harness, run  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the port's kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tiny_cells_on_the_card(tmp_path, card):
    root = bench_tiny.make_root(tmp_path)
    for cell in ("tiny-fwd-bwd", "tiny-render"):
        line, _ = run.run_cell(cell, 2**31 + 5, 0.5, True, device="cuda", root=root,
                               cache=str(tmp_path / "cache"), log=lambda s: None)
        out = json.loads(line)
        assert out["correct"] is True, out["checks"]
        assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
                        "d8-fwd-bwd", "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
