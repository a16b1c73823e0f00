"""The port's sharded renders (parallel/) against the JAX package, on the
CPU.

Worlds of 4 and 3 gloo ranks (tests/torch_parallel_ranks.py, one process a
rank, a file rendezvous, one thread each) run the render suite once each,
while this process renders the references with the JAX package.  Scenes:
cornell_box(res=32) and the same box with fov 15, whose corner pixel
(0, 0) looks at the lit back wall; PathIntegrator depth 3, rr_depth 2.

  * render_sharded of the box (4 ranks: 4,096 lanes divide) against JAX's
    single-device `render` and JAX's `render_sharded` on the 8-device CPU
    mesh of tests/conftest.py;
  * render_sharded of the fov-15 box, unchunked and with a chunk of 48
    lanes (its last launch padded), in both worlds (3 ranks: an uneven
    split) against JAX's `render` on every pixel.  JAX's own sharded render
    points padded lanes at lane 0 and splats them into pixel (0, 0); the
    port gates them;
  * render_persistent_sharded against JAX's `render_persistent`.

Images within rtol 1e-4 / atol 1e-5; every rank returns the same image.
"""
import numpy as np
import pytest

from mitsuba3_experiments_tpu.integrators import PathIntegrator as JPathIntegrator
from mitsuba3_experiments_tpu.integrators import render as jax_render
from mitsuba3_experiments_tpu.integrators.persistent import render_persistent as jax_persistent
from mitsuba3_experiments_tpu.parallel import make_mesh as jax_make_mesh
from mitsuba3_experiments_tpu.parallel import render_sharded as jax_render_sharded
from mitsuba3_experiments_tpu.scene import load_dict as jax_load_dict
from mitsuba3_experiments_tpu_torch.parallel import make_mesh

import torch_parallel_ranks as ranks

TOL = dict(rtol=1e-4, atol=1e-5)
WORLDS = (4, 3)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """world size -> every rank's results; both worlds start at once."""
    started = {}
    for w in WORLDS:
        out = str(tmp_path_factory.mktemp(f"render_world{w}"))
        started[w] = (ranks.start("render", w, out), out)
    got = {}

    def results(w):
        if w not in got:
            got[w] = ranks.collect(*started[w])
        return got[w]

    yield results
    for procs, _ in started.values():
        ranks.stop(procs)


@pytest.fixture(scope="module")
def jax_refs():
    box = jax_load_dict(ranks.box_dict(32))[0]
    fov = jax_load_dict(ranks.box_dict(32, fov=15.0))[0]
    integ = JPathIntegrator(max_depth=ranks.DEPTH, rr_depth=ranks.RR)
    return {
        "box": np.asarray(jax_render(box, integ, spp=4, seed=5)),
        "box_sharded": np.asarray(jax_render_sharded(box, integ, jax_make_mesh(), spp=4,
                                                     seed=5)),
        "fov": np.asarray(jax_render(fov, integ, spp=2, seed=7)),
        "persistent": np.asarray(jax_persistent(box, seed=3, spp=2, max_depth=ranks.DEPTH,
                                                rr_depth=ranks.RR, n_lanes=512, steps=8,
                                                rounds_per_launch=4)),
    }


def test_make_mesh_raises_without_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()


def test_render_sharded_box_equals_jax_render_and_render_sharded(worlds, jax_refs):
    img = worlds(4)[0]["box"]
    assert np.isfinite(img).all() and img.mean() > 0
    np.testing.assert_allclose(img, jax_refs["box"], **TOL)
    np.testing.assert_allclose(img, jax_refs["box_sharded"], **TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", ["fov", "fov_chunk"])
def test_padded_and_uneven_render_equal_jax_render_every_pixel(worlds, jax_refs, world, key):
    ref = jax_refs["fov"]
    assert ref[0, 0].min() > 0.01, "the corner pixel must be lit to show the padding"
    np.testing.assert_allclose(worlds(world)[0][key], ref, **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_persistent_sharded_equals_jax_render_persistent(worlds, jax_refs, world):
    np.testing.assert_allclose(worlds(world)[0]["persistent"], jax_refs["persistent"], **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_images(worlds, world):
    res = worlds(world)
    for other in res[1:]:
        for k, v in res[0].items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)
