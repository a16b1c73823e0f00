"""The control fails the committed limits and the program does not, at the
tiny size on the CPU: the reference with its tables, rays and hits rounded
to bfloat16, put in the program's place (benchmark/calibrate.py, which reads
the same numbers at the cells' own sizes on the card)."""
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import bench_tiny  # noqa: E402

from benchmark import calibrate, harness  # noqa: E402

pytest.importorskip("mitsuba3_experiments_tpu_torch")


def _limits(cell):
    with open(os.path.join(harness.HERE, "limits", cell + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("tiny,cell", [("tiny-fwd-bwd", "d8-fwd-bwd"),
                                       ("tiny-render", "d8-render")])
def test_control_fails_and_program_passes(tmp_path, tiny, cell):
    lim = _limits(cell)
    root = bench_tiny.make_root(tmp_path, limits={tiny: lim, ("tiny-render" if tiny ==
                                                  "tiny-fwd-bwd" else "tiny-fwd-bwd"): lim})
    out = calibrate.calibrate(tiny, [11, 2**31 + 3, 3 * 10**9], 3, device="cpu", root=root,
                              cache=str(tmp_path / "cache"), log=lambda s: None)
    for k, v in out["program"].items():
        assert max(v) <= lim[k], (k, v)
    # the control fails at least one number on every seed
    for j in range(3):
        assert any(out["control"][k][j] > lim[k] for k in lim), out["control"]
