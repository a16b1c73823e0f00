"""The port's photon mapping and ReSTIR GI against the JAX package: SPPM's
per-pixel state after one and two frames, RestirGI's images and
reservoirs over two frames, the banded frame against the whole one, and
the reservoir statistics of tests/test_restir.py (SPPM's hash grid:
tests/test_torch_hashgrid.py).

Images and float state: at least 99.9% of the pixels within rtol 1e-4 /
atol 1e-5, means within a relative 1e-4, the pixels outside printed.
Scene: the Cornell box with a 2,304-triangle sphere at 24x16 (its ray
queries take the BVH)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu.integrators.restir import RestirGI as JRestir
from mitsuba3_experiments_tpu.integrators.sppm import SPPM as JSPPM
from mitsuba3_experiments_tpu.scene import load_dict as jax_load_dict
from mitsuba3_experiments_tpu_torch.core.rng import Sampler
from mitsuba3_experiments_tpu_torch.integrators import SPPM, RestirGI
from mitsuba3_experiments_tpu_torch.integrators.restir import (
    RestirReservoir,
    RestirSample,
    reservoir_update,
)
from mitsuba3_experiments_tpu_torch.scene import (
    cornell_box,
    mesh as meshlib,
    scene_from_numpy,
    scene_to_numpy,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def box():
    d = cornell_box(res=24, spp=1)
    d["sensor"]["film"] = {"width": 24, "height": 16}
    sph = meshlib.sphere(center=(0.3, -0.5, 0.2), radius=0.3, n_theta=24, n_phi=48)
    d["sphere"] = {"type": "mesh", "vertices": sph.vertices, "faces": sph.faces,
                   "normals": sph.normals, "bsdf": {"type": "ref", "id": "white"}}
    js = jax_load_dict(d)[0]
    return js, scene_from_numpy(scene_to_numpy(js), device="cpu")


def _match(name, got, ref):
    a, b = got.numpy(), np.asarray(ref)
    assert a.shape == b.shape and np.isfinite(a).all()
    close = np.isclose(a, b, rtol=1e-4, atol=1e-5) | (a == b)
    close = close.reshape(close.shape[0], -1).all(-1) if close.ndim > 1 else close
    rel = abs(a.mean() - b.mean()) / max(abs(b.mean()), 1e-12)
    print(f"[{name}] {int((~close).sum())} of {close.size} outside rtol 1e-4 / atol 1e-5; "
          f"means {a.mean():.7f} / {b.mean():.7f} (rel {rel:.2e})")
    assert close.mean() >= 0.999 and rel <= 1e-4


# ----------------------------------- SPPM -----------------------------------

def test_sppm_state_matches_jax_over_two_frames(box):
    js, ts = box
    kw = dict(max_depth=3, photon_count=1 << 12, initial_radius=0.1)
    ji, ti = JSPPM(**kw), SPPM(**kw)
    jst, tst = ji.init_state(js), ti.init_state(ts)
    jframe = jax.jit(lambda st, seed: ji.render_frame(js, st, seed))
    for frame in range(2):
        jimg, jst = jframe(jst, jnp.uint32(frame + 3))
        timg, tst = ti.render_frame(ts, tst, frame + 3)
        for f in ("radius2", "n_photons", "tau", "direct"):
            _match(f"sppm frame {frame} {f}", getattr(tst, f), getattr(jst, f))
        _match(f"sppm frame {frame} image", timg.reshape(-1, 3), jimg.reshape(-1, 3))
        assert int(tst.frames) == frame + 1
    assert float(tst.radius2.min()) < 0.1**2 and float(tst.n_photons.max()) > 0


# ---------------------------------- ReSTIR ----------------------------------

@pytest.fixture(scope="module")
def restir_frames(box):
    """Two frames of the port's render_frame and JAX's, at the defaults
    apart from the inner path depth."""
    js, ts = box
    ji, ti = JRestir(max_depth=2), RestirGI(max_depth=2)
    jst, tst = ji.init_state(js), ti.init_state(ts)
    out = []
    for frame in range(2):
        jimg, jst = ji.render_frame(js, jst, jnp.uint32(frame))
        timg, tst = ti.render_frame(ts, tst, frame)
        out.append((timg, tst, jimg, jst))
    return out


def test_restir_two_frames_match_jax(restir_frames):
    for frame, (timg, tst, jimg, jst) in enumerate(restir_frames):
        _match(f"restir frame {frame} image", timg.reshape(-1, 3), jimg.reshape(-1, 3))
        for name in ("temporal", "spatial"):
            t, j = getattr(tst, name), getattr(jst, name)
            _match(f"restir frame {frame} {name} W", t.W, j.W)
            _match(f"restir frame {frame} {name} w", t.w, j.w)
            _match(f"restir frame {frame} {name} L_o", t.z.L_o, j.z.L_o)
            np.testing.assert_array_equal(t.M.numpy(), np.asarray(j.M).astype(np.int32))
        np.testing.assert_array_equal(tst.search_radius.numpy(), np.asarray(jst.search_radius))
        assert int(tst.frame) == frame + 1 and tst.spatial.M.dtype == torch.int32
    assert float(restir_frames[-1][0].mean()) > 0


def test_restir_banded_frame_equals_whole_frame(box, restir_frames):
    """Bands of 256 pixels (the last one padded) give the whole frame's
    images and state, frame after frame."""
    _, ts = box
    ti = RestirGI(max_depth=2)
    st = ti.init_state(ts)
    for frame, (timg, tst, _, _) in enumerate(restir_frames):
        img, st = ti.render_frame_chunked(ts, st, frame, chunk=256)
        torch.testing.assert_close(img, timg, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(st.search_radius, tst.search_radius, rtol=0, atol=0)
        torch.testing.assert_close(st.spatial.W, tst.spatial.W, rtol=1e-6, atol=1e-7)
        assert torch.equal(st.temporal.M, tst.temporal.M)


def test_reservoir_update_statistics():
    """The streaming reservoir picks in proportion to the weights."""
    n = 1 << 14
    res = RestirReservoir.zeros(n)
    sampler = Sampler.create(0, n, device="cpu")
    for i, wgt in enumerate([1.0, 2.0, 3.0]):
        s = dataclasses.replace(RestirSample.zeros(n), x_v=torch.full((n, 3), float(i)))
        res, sampler = reservoir_update(res, sampler, s, torch.full((n,), wgt),
                                        torch.ones(n, dtype=torch.bool))
    frac = np.bincount(res.z.x_v[:, 0].numpy().astype(int), minlength=3) / n
    np.testing.assert_allclose(frac, [1 / 6, 2 / 6, 3 / 6], atol=0.02)
    assert int(res.M[0]) == 3 and res.M.dtype == torch.int32
    np.testing.assert_allclose(res.w.numpy(), 6.0)
