"""The port's utilities: checkpoints (a flow's parameters, its Adam state
and step, resumed bit for bit), profiling on the CPU, and the independent
numpy oracle, held against the JAX package's oracle and against the port's
path tracer at the bounds of tests/test_oracle.py."""
import json

import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu.scene import load_dict as jax_load_dict
from mitsuba3_experiments_tpu.utils import image as jax_image
from mitsuba3_experiments_tpu.validation import render_oracle as jax_render_oracle
from mitsuba3_experiments_tpu.validation import scene_to_numpy as jax_oracle_data
from mitsuba3_experiments_tpu_torch import utils
from mitsuba3_experiments_tpu_torch.integrators import PathIntegrator, render
from mitsuba3_experiments_tpu_torch.models import normflow as nf
from mitsuba3_experiments_tpu_torch.scene import cornell_box, scene_from_numpy, scene_to_numpy
from mitsuba3_experiments_tpu_torch.validation import block_means, render_oracle
from mitsuba3_experiments_tpu_torch.validation import scene_to_numpy as oracle_data

torch.set_num_threads(2)


def _batches(n):
    rng = np.random.default_rng(6)
    return [torch.from_numpy(rng.random((256, 2)).astype(np.float32)) for _ in range(n)]


def test_checkpoint_resume_equals_uninterrupted_training(tmp_path):
    cfg = nf.FlowConfig(coupling="rqs", n_couplings=2, hidden=16, n_bins=8)
    batches = _batches(6)

    def fresh(seed=0):
        return nf.init_flow(torch.Generator().manual_seed(seed), cfg, device="cpu")

    ref = fresh()
    _, step = nf.make_train_step(ref, cfg, lr=5e-3, n_iters=6)
    ref_losses = [float(step(b)) for b in batches]

    params = fresh()
    opt, step = nf.make_train_step(params, cfg, lr=5e-3, n_iters=6)
    losses = [float(step(b)) for b in batches[:3]]
    path = tmp_path / "ckpt" / "flow.pt"
    utils.save_checkpoint(str(path), {"params": params, "opt": opt.state_dict(), "step": 3})

    template_params = fresh(seed=1)
    template_opt, _ = nf.make_train_step(template_params, cfg, lr=5e-3)
    state = utils.load_checkpoint(str(path), {"params": template_params,
                                              "opt": template_opt.state_dict(), "step": 0})
    assert state["step"] == 3 and not (tmp_path / "ckpt" / "flow.pt.tmp").exists()
    for a, b in zip(nf.flow_tensors(state["params"]), nf.flow_tensors(params)):
        assert torch.equal(a, b) and a.device == b.device
    resumed = state["params"]
    _, step = nf.make_train_step(resumed, cfg, lr=5e-3, n_iters=6, opt_state=state["opt"],
                                 start=state["step"])
    losses += [float(step(b)) for b in batches[3:]]
    assert losses == ref_losses
    for a, b in zip(nf.flow_tensors(resumed), nf.flow_tensors(ref)):
        assert torch.equal(a, b)


def test_profile_helpers_run_on_cpu(tmp_path):
    x = torch.rand((256, 256))

    def work(a):
        with utils.profile_range("smoke_range"):
            return (a @ a).relu().sum()

    hist = utils.kernel_history(work, x)
    assert hist["kernels"] == 0 and hist["device_ms"] == 0.0 and hist["top"] == []
    assert hist["host_ops"] >= 3 and hist["peak_bytes"] is None
    secs, out = utils.benchmark(work, x, warmup=1, iters=3)
    assert secs > 0 and torch.equal(out, work(x))
    trace_path = tmp_path / "t" / "trace.json"
    with utils.profile.trace(str(trace_path)):
        work(x)
    names = {e.get("name") for e in json.load(open(trace_path))["traceEvents"]}
    assert "smoke_range" in names


def test_image_errors_equal_jax():
    """mse and relative_mse on seeded images (one with values near 0, where
    the relative MSE's 0.01 floor matters) against the JAX package's."""
    rng = np.random.default_rng(12)
    a = rng.uniform(0.0, 2.0, (24, 16, 3)).astype(np.float32)
    b = (a + rng.normal(0.0, 0.1, a.shape)).astype(np.float32)
    b[:4] *= 1e-3
    for ours, theirs in ((utils.mse, jax_image.mse), (utils.relative_mse, jax_image.relative_mse)):
        got, ref = ours(b, a), theirs(b, a)
        assert ref > 0
        np.testing.assert_allclose(got, ref, rtol=1e-7)
        np.testing.assert_allclose(ours(torch.from_numpy(b), a), ref, rtol=1e-7)


def test_oracle_equals_jax_oracle():
    js = jax_load_dict(cornell_box(res=16, spp=4))[0]
    ts = scene_from_numpy(scene_to_numpy(js), device="cpu")
    ref_data, data = jax_oracle_data(js), oracle_data(ts)
    assert ref_data.keys() == data.keys() and data["resolution"] == ref_data["resolution"]
    for k in ("tri", "albedo", "emit", "to_world", "tan_half_fov"):
        assert np.array_equal(data[k], np.asarray(ref_data[k])), k
    got = render_oracle(data, spp=4, max_depth=3, seed=2, chunk=512)
    ref = jax_render_oracle(ref_data, spp=4, max_depth=3, seed=2, chunk=512)
    assert got.shape == (16, 16, 3) and got.max() > 0
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("max_depth,spp,seeds", [(4, 64, (11, 13)), (2, 96, (5, 7))])
def test_path_matches_oracle(max_depth, spp, seeds):
    """tests/test_oracle.py's two checks on the port's path tracer, at their
    sizes and seeds: the image means within 2%; at depth 4 also the 8x8
    block means, within 3% on average and 12% at most."""
    scene = jax_load_dict(cornell_box(res=32, spp=16))[0]
    scene = scene_from_numpy(scene_to_numpy(scene), device="cpu")
    img_o = render_oracle(oracle_data(scene), spp=spp, max_depth=max_depth, seed=seeds[0])
    img_f = render(scene, PathIntegrator(max_depth=max_depth, rr_depth=99), spp=spp,
                   seed=seeds[1]).numpy()
    mo, mf = img_o.mean(), img_f.mean()
    assert abs(mo / mf - 1.0) < 0.02, (mo, mf)
    if max_depth == 4:
        bo, bf = block_means(img_o), block_means(img_f)
        rel = np.abs(bo - bf) / np.maximum(bf, 1e-2)
        print(f"mean ratio {mo / mf:.4f}, block means: mean {rel.mean():.4f}, max {rel.max():.4f}")
        assert rel.mean() < 0.03, rel.mean()
        assert rel.max() < 0.12, rel.max()


def test_oracle_imports_no_torch():
    import mitsuba3_experiments_tpu_torch.validation.oracle as oracle

    src = open(oracle.__file__).read()
    assert "import torch" not in src and "from torch" not in src
    assert "torch" not in vars(oracle)
