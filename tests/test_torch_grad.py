"""The port's differentiable lockstep render against the JAX package, on the
CPU.

`PathIntegrator(differentiable=True)` through `render` on the 16x16 Cornell
box (spp 4, depth 3): the gradients of the image mean with respect to
`emitters.radiance` and `materials.base_color` equal JAX's `jax.grad`
through its scan integrator within rtol 1e-3 / atol 1e-4 max|g| (the two
packages sum the same terms in another order).  The port's own checks of
the estimator (central finite differences, linearity in the radiance) are
those of tests/test_render.py, at its tolerances; the port's replay
gradient equals the port's AD render at tests/test_replay.py's tolerance
(rtol 5e-3 / atol 5e-4 max|g|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu.integrators import PathIntegrator as JPath
from mitsuba3_experiments_tpu.integrators import render as jax_render
from mitsuba3_experiments_tpu.scene import cornell_box as jax_cornell_box
from mitsuba3_experiments_tpu.scene import load_dict as jax_load_dict
from mitsuba3_experiments_tpu.scene import update as jax_update
from mitsuba3_experiments_tpu_torch.integrators import (
    PathIntegrator,
    make_integrator,
    render,
    replay_render_grad,
)
from mitsuba3_experiments_tpu_torch.intersect import bvh_torch
from mitsuba3_experiments_tpu_torch.scene import params, scene_from_numpy, scene_to_numpy
from test_torch_replay import bvh  # noqa: F401

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cornell():
    js = jax_load_dict(jax_cornell_box(res=16))[0]
    return js, scene_from_numpy(scene_to_numpy(js), device="cpu")


def _port_grad(scene, key, integ, loss, **kw):
    """d loss(render(scene with `key` as a leaf)) / d key."""
    p = params.traverse(scene)[key].detach().clone().requires_grad_(True)
    out = loss(render(params.update(scene, {key: p}), integ, **kw))
    out.backward()
    return p.grad.numpy(), float(out.detach())


@pytest.mark.parametrize("key", ["emitters.radiance", "materials.base_color"])
def test_differentiable_render_matches_jax_grad(cornell, key):
    js, ts = cornell

    def jloss(p):
        img = jax_render(jax_update(js, {key: p}), JPath(max_depth=3, differentiable=True), spp=4)
        return jnp.mean(img)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(scene_to_numpy(ts)[key])))
    got, _ = _port_grad(ts, key, PathIntegrator(max_depth=3, differentiable=True),
                        lambda img: img.mean(), spp=4)
    assert np.abs(ref).max() > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max())
    if key == "emitters.radiance":
        assert got.sum() > 0   # brighter lights, brighter image
    else:
        assert np.abs(got[0]).max() > 0   # the white walls' albedo


def test_port_pixel_gradients_match_port_finite_differences(cornell):
    """With Russian roulette off and detached sampling, a reflectance
    perturbation leaves the sampled paths as they are, so AD of the
    estimator equals central differences of it (tests/test_render.py)."""
    _, ts = cornell
    integ = PathIntegrator(max_depth=3, rr_depth=99, differentiable=True)
    key = "materials.base_color"
    g_ad, _ = _port_grad(ts, key, integ, lambda img: img.mean(), spp=8, seed=5)

    bc0 = params.traverse(ts)[key]

    def image_mean(bc):
        with torch.no_grad():
            return float(render(params.update(ts, {key: bc}), integ, spp=8, seed=5).mean())

    eps = 1e-3
    for row, ch in [(0, 0), (1, 1), (2, 0)]:   # white, green, red walls
        e = torch.zeros_like(bc0)
        e[row, ch] = eps
        fd = (image_mean(bc0 + e) - image_mean(bc0 - e)) / (2 * eps)
        np.testing.assert_allclose(g_ad[row, ch], fd, rtol=5e-2, atol=1e-4)


def test_port_emitter_gradient_is_linear(cornell):
    """Radiance enters linearly: grad . radiance equals the image mean."""
    _, ts = cornell
    integ = PathIntegrator(max_depth=3, rr_depth=99, differentiable=True)
    g, f0 = _port_grad(ts, "emitters.radiance", integ, lambda img: img.mean(), spp=4, seed=3)
    r0 = params.traverse(ts)["emitters.radiance"].numpy()
    np.testing.assert_allclose((g * r0).sum(), f0, rtol=1e-3)


def test_port_replay_grad_matches_port_ad(bvh):
    """replay_render_grad == AD through the differentiable render on the
    32x24 sphere / floor / light scene (a BVH, not brute force), spp 2,
    depth 4 (tests/test_replay.py:93-128)."""
    _, ts = bvh
    w, h = ts.camera.resolution
    spp, depth = 2, 4
    keys = ("materials.base_color", "emitters.radiance")
    with torch.no_grad():
        target = render(ts, PathIntegrator(max_depth=depth), seed=9, spp=spp, rfilter="box")
    p = {k: params.traverse(ts)[k].detach().clone().requires_grad_(True) for k in keys}
    calls = bvh_torch.calls
    img = render(params.update(ts, p), PathIntegrator(max_depth=depth, differentiable=True),
                 seed=5, spp=spp, rfilter="box")
    loss = ((img - target) ** 2).sum()
    forward_calls = bvh_torch.calls - calls
    loss.backward()
    # the backward runs each checkpointed bounce's ray queries again (all
    # but the camera rays' one)
    assert bvh_torch.calls - calls == 2 * forward_calls - 1
    g_rep = replay_render_grad(ts, {k: params.traverse(ts)[k] for k in keys}, params.update,
                               target, 5, 0, w * h * spp, spp=spp, max_depth=depth, rr_depth=4,
                               rfilter="box")
    for k in keys:
        a, b = p[k].grad.numpy(), g_rep[k].numpy()
        assert np.abs(b).max() > 0, k
        np.testing.assert_allclose(b, a, rtol=5e-3, atol=5e-4 * max(1e-9, np.abs(a).max()),
                                   err_msg=k)


@pytest.mark.parametrize("name", ["path", "mypath"])
def test_make_integrator_path_names(name):
    integ = make_integrator({"type": name, "max_depth": 5, "differentiable": True,
                             "not_a_field": 1})
    assert integ == PathIntegrator(max_depth=5, differentiable=True)


def test_forward_render_unchanged_and_records_no_graph(cornell):
    """differentiable=False keeps the forward loop: no graph, and the image
    of the differentiable form on the same seed."""
    _, ts = cornell
    key = "materials.base_color"
    p = params.traverse(ts)[key].detach().clone().requires_grad_(True)
    s = params.update(ts, {key: p})
    fwd = render(s, PathIntegrator(max_depth=3), spp=4)
    assert not fwd.requires_grad
    ad = render(s, PathIntegrator(max_depth=3, differentiable=True), spp=4)
    assert ad.requires_grad
    np.testing.assert_allclose(ad.detach().numpy(), fwd.numpy(), rtol=1e-6, atol=1e-7)
