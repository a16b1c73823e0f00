"""What the benchmark imports: no module under benchmark/ imports JAX or the
JAX package, and nothing under benchmark/reference/ imports the port.  Top-
level names are compared whole (the port's name begins with the JAX
package's)."""
import ast
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from benchmark import harness  # noqa: E402

BENCH = harness.HERE


def _imports(path):
    """(top-level names of absolute imports, deepest relative level)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names, level = set(), 0
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                level = max(level, node.level)
            else:
                names.add(node.module.split(".", 1)[0])
    return names, level


def _files(top):
    for dp, dn, fn in os.walk(top):
        dn[:] = [d for d in dn if d not in ("cache", "__pycache__")]
        for f in fn:
            if f.endswith(".py"):
                yield os.path.join(dp, f)


def test_no_jax_anywhere_in_the_benchmark():
    bad = {}
    for path in _files(BENCH):
        hit = _imports(path)[0] & set(harness.FORBIDDEN)
        if hit:
            bad[os.path.relpath(path, BENCH)] = sorted(hit)
    assert not bad


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(BENCH, "reference")
    for path in _files(ref):
        names, level = _imports(path)
        assert "mitsuba3_experiments_tpu_torch" not in names, path
        assert "benchmark" not in names, path
        # relative imports stay inside benchmark/reference
        depth = len(os.path.relpath(os.path.dirname(path), ref).split(os.sep))
        depth = 0 if os.path.dirname(path) == ref else depth
        assert level <= depth + 1, (path, level)


def test_forbidden_modules_compare_whole_names():
    mods = ["mitsuba3_experiments_tpu_torch", "mitsuba3_experiments_tpu_torch.scene", "jaxtyping",
            "torch", "flaxen"]
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(mods + ["jax.numpy", "mitsuba3_experiments_tpu.scene"]) == [
        "jax.numpy", "mitsuba3_experiments_tpu.scene"]
