"""A configuration, a traffic mix and a per-layer metric added as new files
only are found by the names BENCHMARK.json gives them."""
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import bench_tiny  # noqa: E402

from benchmark import harness, run  # noqa: E402

pytest.importorskip("mitsuba3_experiments_tpu_torch")

READER = '''"""plain_traversals_per_step: the port's plain traversals a step."""


def read(ctx):
    return ctx["counters"]["plain_traversals"] / ctx["n_steps"]
'''


def _add_files(root):
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "tiny.json")) as f:
        conf = json.load(f)
    conf.update(name="tiny-d3", max_depth=3)
    with open(os.path.join(bench, "configs", "tiny-d3.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(bench, "traffic", "render_box.json"), "w") as f:
        json.dump({"loop": "render", "rfilter": "box", "check": {"pixels": 64}}, f)
    with open(os.path.join(bench, "layer_metrics", "plain_traversals_per_step.py"), "w") as f:
        f.write(READER)
    with open(os.path.join(bench, "limits", "tiny-d3-box.json"), "w") as f:
        json.dump({"image_off": 0.02}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny-d3", "source": "test", "why": "test", "reduced": [],
                            "file": "benchmark/configs/tiny-d3.json"})
    spec["workloads"].append({"name": "tiny-d3-box", "config": "tiny-d3",
                              "traffic": "render_box", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "plain_traversals_per_step", "unit": "1", "better": "lower",
                              "source": "program_counter", "layer": "intersect.bvh_torch",
                              "moves": "fwd_rays_per_s", "workloads": ["tiny-d3-box"]})
    for m in spec["end_to_end"]:
        if m.get("workloads") == ["tiny-render"]:
            m["workloads"].append("tiny-d3-box")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)


def test_new_files_are_found_by_name(tmp_path):
    root = bench_tiny.make_root(tmp_path)
    _add_files(root)
    cell = harness.load_cell("tiny-d3-box", root)
    assert cell["config"]["max_depth"] == 3
    assert cell["traffic"]["rfilter"] == "box"
    assert [m["name"] for m in cell["per_layer"]] == ["plain_traversals_per_step"]
    line, checks = run.run_cell("tiny-d3-box", 5, 0.1, True, device="cpu", root=root,
                                cache=str(tmp_path / "cache"), log=lambda s: None)
    out = json.loads(line)
    assert out["correct"] is True
    assert out["metrics"]["plain_traversals_per_step"]["value"] > 0
    assert list(out["checks"]) == ["image_off"]
    assert checks == [f"check image_off: {out['checks']['image_off']['value']!r} (limit 0.02)"]


def test_an_unknown_cell_is_refused(tmp_path):
    root = bench_tiny.make_root(tmp_path)
    with pytest.raises(KeyError):
        harness.load_cell("no-such-cell", root)
