"""A benchmark root at a size the CPU runs in seconds: the stand-in at 32x18
with ~3,000 triangles, its two cells ("tiny-fwd-bwd", "tiny-render") and the
benchmark's own traffic mixes, readers and scene generators."""
import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_config(depth: int = 4) -> dict:
    with open(os.path.join(BENCH, "configs", "standin-d8.json")) as f:
        c = json.load(f)
    c.update(name="tiny", resolution=[32, 18], max_depth=depth, replay_chunk=288, trace_steps=1)
    c["scene"]["args"].update(res=[32, 18], tri_budget=3000)
    return c


def make_root(tmp, depth: int = 4, limits=None) -> str:
    """A root under `tmp` holding BENCHMARK.json and benchmark/ with the
    tiny configuration; returns its path."""
    root = os.path.join(str(tmp), "root")
    bench = os.path.join(root, "benchmark")
    for d in ("traffic", "layer_metrics", "scenes"):
        shutil.copytree(os.path.join(BENCH, d), os.path.join(bench, d))
    os.makedirs(os.path.join(bench, "configs"))
    os.makedirs(os.path.join(bench, "limits"))
    with open(os.path.join(bench, "configs", "tiny.json"), "w") as f:
        json.dump(tiny_config(depth), f)
    with open(os.path.join(BENCH, "..", "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"] = [{"name": "tiny", "source": "the stand-in at 32x18", "why": "tests",
                        "file": "benchmark/configs/tiny.json", "reduced": []}]
    spec["workloads"] = [
        {"name": "tiny-fwd-bwd", "config": "tiny", "traffic": "inverse", "chips": 1, "why": "t"},
        {"name": "tiny-render", "config": "tiny", "traffic": "render", "chips": 1, "why": "t"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            w = m["workloads"]
            m["workloads"] = (["tiny-render"] if w == ["d8-render"] else ["tiny-fwd-bwd"]
                              if "d8-render" not in w else ["tiny-fwd-bwd", "tiny-render"])
    lim = limits or {"tiny-fwd-bwd": {"target_off": 0.02, "record_off": 0.001, "grad_gap": 1e-3},
                     "tiny-render": {"image_off": 0.02}}
    for cell, v in lim.items():
        with open(os.path.join(bench, "limits", cell + ".json"), "w") as f:
            json.dump(v, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root
