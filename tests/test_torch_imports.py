"""The port imports without JAX, and without nvcc or triton.

Each check runs in a fresh interpreter, so nothing the test process has
already imported (the JAX package, for the other test files) can hide a
dependency."""
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


def test_kernel_wrapper_imports_without_nvcc_or_triton():
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.path.dirname(sys.executable)   # no nvcc on it
    code = (
        "import shutil, sys\n"
        "from mitsuba3_experiments_tpu_torch.intersect import bvh_cuda, bvh_torch\n"
        "from mitsuba3_experiments_tpu_torch.models import fused_mlp_cuda, nerad\n"
        "from mitsuba3_experiments_tpu_torch.ops import prefix_sum_cuda\n"
        "assert shutil.which('nvcc') is None\n"
        "for w in (bvh_cuda, fused_mlp_cuda, prefix_sum_cuda):\n"
        "    assert w.LIBRARY.handle is None and w.launches == 0, w\n"
        "assert 'triton' not in sys.modules\n"
        "assert 'torch.utils.cpp_extension' not in sys.modules\n"
        "print('ok')\n"
    )
    out = _run(code, env=env)
    assert out.returncode == 0 and "ok" in out.stdout, out.stdout + out.stderr
