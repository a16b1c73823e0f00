"""The port imports without JAX, and without nvcc or triton.

Each check runs in a fresh interpreter, so nothing the test process has
already imported (the JAX package, for the other test files) can hide a
dependency."""
import ast
import os
import pkgutil
import subprocess
import sys

import mitsuba3_experiments_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        names.append(info.name)
    return names


def _run(code, env=None):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )


def test_every_module_imports_without_jax():
    mods = _modules()
    assert len(mods) >= 25, mods
    for new in ("integrators.persistent", "integrators.pipelined", "integrators.replay",
                "integrators.wavefront", "scene.params", "ops.gather_probe",
                "ops.gather_probe_cuda", "integrators.nrc", "scene.native", "scene.obj",
                "scene.xml", "scene.serialize", "utils.image", "core.struct", "core.spectrum",
                "ops.hashgrid", "integrators.simple", "integrators.ptracer",
                "integrators.spectral", "integrators.bdpt", "integrators.sppm",
                "integrators.restir", "integrators.pssmlt", "integrators.metropolis",
                "models.normflow", "models.reparam", "utils.checkpoint", "utils.profile",
                "validation", "validation.oracle", "parallel", "parallel.mesh",
                "integrators.replay_cuda"):
        assert f"{port.__name__}.{new}" in mods, new
    code = (
        "import importlib, sys\n"
        f"for name in {mods!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m.startswith('mitsuba3_experiments_tpu.') or m == 'mitsuba3_experiments_tpu')\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_modules(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_examples_import_no_jax():
    """The port's example scripts (examples/torch_*.py), its scripts
    (scripts/torch_*.py: the reference-workload drivers among them) and the
    skeleton writer tests/torch_bedroom_skeleton.py import neither jax nor
    the JAX package, directly or through examples/_common.py; each script
    answers --help in a fresh interpreter with no jax loaded."""
    ex_dir = os.path.join(REPO, "examples")
    scripts = sorted(f for f in os.listdir(ex_dir) if f.startswith("torch_") and f.endswith(".py"))
    for new in ("torch_run_pssmlt.py", "torch_metropolis_eval.py", "torch_train_normflow.py",
                "torch_train_reparam.py", "torch_dryrun_multichip.py", "torch_render_path.py",
                "torch_invert_radiance.py", "torch_train_nerad.py", "torch_bdpt_sppm_eval.py",
                "torch_restir_eval.py"):
        assert new in scripts, new
    paths = [os.path.join(ex_dir, n) for n in scripts]
    drivers = ("torch_nerad_fused_bench.py", "torch_flagship_fullspec.py",
               "torch_flagship_invert.py", "torch_nerad_fullrecipe.py", "torch_scaling_bench.py")
    paths += [os.path.join(REPO, "scripts", n) for n in drivers]
    for path in paths + [os.path.join(REPO, "tests", "torch_bedroom_skeleton.py")]:
        mods = _imported_modules(path)
        bad = sorted(n for n in mods if n.split(".")[0] in ("jax", "jaxlib", "_common",
                                                            "mitsuba3_experiments_tpu"))
        assert not bad, (path, bad)
    code = (
        "import runpy, sys\n"
        f"for path in {paths!r}:\n"
        "    sys.argv = [path, '--help']\n"
        "    try:\n"
        "        runpy.run_path(path, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code in (0, None), (path, e.code)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.split('.')[0] == 'mitsuba3_experiments_tpu')\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = _run(code)
    assert out.returncode == 0 and out.stdout.count("usage:") == len(paths), (
        out.stdout + out.stderr)


def test_kernel_wrapper_imports_without_nvcc_or_triton():
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.path.dirname(sys.executable)   # no nvcc on it
    code = (
        "import shutil, sys\n"
        "from mitsuba3_experiments_tpu_torch.intersect import bvh_cuda, bvh_torch\n"
        "from mitsuba3_experiments_tpu_torch.models import fused_mlp_cuda, nerad\n"
        "from mitsuba3_experiments_tpu_torch.ops import gather_probe, gather_probe_cuda, prefix_sum_cuda\n"
        "from mitsuba3_experiments_tpu_torch.integrators import pipelined, replay\n"
        "assert shutil.which('nvcc') is None\n"
        "for w in (bvh_cuda, fused_mlp_cuda, prefix_sum_cuda, gather_probe_cuda):\n"
        "    assert w.LIBRARY.handle is None and w.launches == 0, w\n"
        "from mitsuba3_experiments_tpu_torch.scene import native, obj, xml\n"
        "assert native.LIBRARY.handle is None   # the host library builds at first use\n"
        "assert 'triton' not in sys.modules\n"
        "assert 'torch.utils.cpp_extension' not in sys.modules\n"
        "print('ok')\n"
    )
    out = _run(code, env=env)
    assert out.returncode == 0 and "ok" in out.stdout, out.stdout + out.stderr


def test_bench_imports_no_jax():
    """bench_torch.py (the port's counterpart of bench.py) imports neither
    jax nor the JAX package: its module, and a --help run of it in a fresh
    interpreter, which imports the port."""
    path = os.path.join(REPO, "bench_torch.py")
    mods = _imported_modules(path)
    assert "mitsuba3_experiments_tpu_torch.integrators" in mods, mods
    bad = sorted(n for n in mods if n.split(".")[0] in ("jax", "jaxlib",
                                                        "mitsuba3_experiments_tpu"))
    assert not bad, bad
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{path!r}, '--help']\n"
        "try:\n"
        f"    runpy.run_path({path!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code in (0, None), e.code\n"
        "assert 'mitsuba3_experiments_tpu_torch.integrators' in sys.modules\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m.split('.')[0] == 'mitsuba3_experiments_tpu')\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = _run(code)
    assert out.returncode == 0 and "usage:" in out.stdout, out.stdout + out.stderr
