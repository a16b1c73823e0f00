"""The port's MCMC slice against the JAX package: PSSMLT's counter-based
mutation draws, its mutations, its path evaluation from a primary sample
vector and one chain round from the same state, and the standalone
Metropolis sampler.

Both packages take the same numpy inputs.  The mutation grid is compared
bit for bit.  Path values and chain states are compared lane by lane: at
least 99.9% of the lanes within rtol 1e-4 / atol 1e-5 (a lane outside can
only be a roulette or accept decision that flipped at a float boundary;
each test prints how many there are).  A chain amplifies such flips, so
rounds are compared one at a time from the same state, never as a long
run's image."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from mitsuba3_experiments_tpu.core import math as jmath
from mitsuba3_experiments_tpu.integrators import metropolis as jmetro
from mitsuba3_experiments_tpu.integrators import pssmlt as jpssmlt
from mitsuba3_experiments_tpu.render import sensor as jsensor
from mitsuba3_experiments_tpu.scene import load_dict as jax_load_dict
from mitsuba3_experiments_tpu_torch.core import math as m
from mitsuba3_experiments_tpu_torch.integrators import Pssmlt, make_integrator, metropolis
from mitsuba3_experiments_tpu_torch.integrators import pssmlt
from mitsuba3_experiments_tpu_torch.render import sensor
from mitsuba3_experiments_tpu_torch.scene import (
    cornell_box,
    load_dict,
    mesh as meshlib,
    scene_from_numpy,
    scene_to_numpy,
)

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
FIELDS = ("pos", "u_bsdf", "u_em", "u_rr", "L", "b_sum")


def cornell_sphere(res):
    """The Cornell box with a 2,304-triangle sphere: enough triangle slots
    that ray queries take the BVH (K1 on the card), not the brute force."""
    d = cornell_box(res=res[0], spp=1)
    d["sensor"]["film"] = {"width": res[0], "height": res[1]}
    sph = meshlib.sphere(center=(0.3, -0.5, 0.2), radius=0.3, n_theta=24, n_phi=48)
    d["sphere"] = {"type": "mesh", "vertices": sph.vertices, "faces": sph.faces,
                   "normals": sph.normals, "bsdf": {"type": "ref", "id": "white"}}
    return d


def pair(d):
    js = jax_load_dict(d)[0]
    return js, scene_from_numpy(scene_to_numpy(js), device="cpu")


@pytest.fixture(scope="module")
def cornell():
    return pair(cornell_sphere((16, 16)))


def share_close(got, ref, lanes_axis=0):
    """Share of lanes (along `lanes_axis`) whose every value is allclose."""
    a, b = np.moveaxis(np.asarray(got), lanes_axis, 0), np.moveaxis(np.asarray(ref), lanes_axis, 0)
    c = np.isclose(a, b, rtol=RTOL, atol=ATOL) | (a == b)
    return c.reshape(c.shape[0], -1).all(axis=1)


# ---- erfinv -----------------------------------------------------------------

def test_erfinv_within_two_ulp_and_jax_within_its_own_error():
    """The port's erfinv (torch.erfinv) is within 2 ulp of the float64
    value over [-0.999999, 0.999999].  JAX's float32 erfinv is not: it is
    off by up to 64 ulp near +-0.9998, so the port is held against JAX
    within JAX's own error (plus the port's 2 ulp) at every point."""
    x = np.linspace(-0.999999, 0.999999, 400_001).astype(np.float32)
    x[:3] = [0.0, -0.999999, 0.999999]
    ref = scipy.special.erfinv(x.astype(np.float64))
    got = m.erfinv(torch.from_numpy(x)).numpy().astype(np.float64)
    jax_val = np.asarray(jmath.erfinv(jnp.asarray(x))).astype(np.float64)
    ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
    port_err = np.abs(got - ref)
    assert (port_err <= 2 * ulp).all(), (port_err / ulp).max()
    jax_err = np.abs(jax_val - ref)
    print(f"erfinv: port within {(port_err / ulp).max():.3f} ulp, JAX within "
          f"{(jax_err / ulp).max():.3f} ulp ({jax_err.max():.3e} absolute)")
    assert (np.abs(got - jax_val) <= jax_err + 2 * ulp).all()


# ---- PSSMLT pieces ----------------------------------------------------------

@pytest.mark.parametrize("seed,it,tag,shape", [
    (0, 0, 0, (7,)),
    (1, 39, 5, (256,)),
    (123456789, 1_431_655_765, 2, (3, 5, 3)),
    (0xFFFFFFFF, 77, 4, (2, 9)),
    (42, 0xFFFFFFFF, 1, (64, 2)),
])
def test_uniform_grid_bits_equal_jax(seed, it, tag, shape):
    ref = np.asarray(jpssmlt._uniform_grid(jnp.uint32(seed), jnp.uint32(it), tag, shape))
    got = pssmlt._uniform_grid(seed, it, tag, shape).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("sigma", [Pssmlt.sigma_pos, Pssmlt.sigma_u])
def test_mutate_matches_jax(sigma):
    """At PSSMLT's two step sizes; JAX's erfinv error (up to 1.5e-5, see
    above) enters scaled by sqrt(2) * sigma, below 7e-7."""
    rng = np.random.default_rng(5)
    old = rng.random((2000, 3)).astype(np.float32)
    u = rng.random((2000, 3)).astype(np.float32)
    # wrapped negatives: old at 0 with a small negative step; a step that
    # lands a float32 hair below 0 rounds to 1.0 after the wrap (as in JAX);
    # steps past 1; the clamped tails of the inverse CDF
    old[:6, 0] = [0.0, 0.0, 0.0, 1.0 - 2 ** -24, 0.999, 0.5]
    u[:6, 0] = [0.3, 0.5 - 2 ** -24, 1e-7, 0.9, 0.99999, 0.0]
    large = rng.random((2000, 1)) < 0.3
    large[:6] = False
    ref = np.asarray(jpssmlt._mutate(jnp.asarray(old), jnp.asarray(u), jnp.asarray(large),
                                     sigma))
    got = pssmlt._mutate(torch.from_numpy(old), torch.from_numpy(u), torch.from_numpy(large),
                         sigma).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    assert ((got >= 0.0) & (got <= 1.0)).all()
    assert np.array_equal(got[large[:, 0]], u[large[:, 0]])
    assert got[1, 0] == ref[1, 0] == 1.0   # -tiny % 1.0 rounds to 1.0 in float32


def _primary_samples(n, depth, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 2)).astype(np.float32), rng.random((depth, n, 3)).astype(np.float32),
            rng.random((depth, n, 2)).astype(np.float32), rng.random((depth, n)).astype(np.float32))


def sample_case(js, ts, which, mode):
    """Pssmlt.sample of both packages on the same primary sample arrays (2
    chains per pixel, depth 5)."""
    w, h = ts.camera.resolution
    depth = 5
    pos, u_bsdf, u_em, u_rr = _primary_samples(w * h * 2, depth, 3)
    res = np.asarray([w, h], np.float32)
    jray = jsensor.sample_ray(js.camera, jnp.asarray(pos * res))
    ref = np.asarray(jpssmlt.Pssmlt(max_depth=depth, mode=mode).sample(
        js, jray, jnp.asarray(u_bsdf), jnp.asarray(u_em), jnp.asarray(u_rr)))
    tray = sensor.sample_ray(ts.camera, torch.from_numpy(pos * res))
    got = Pssmlt(max_depth=depth, mode=mode).sample(
        ts, tray, torch.from_numpy(u_bsdf), torch.from_numpy(u_em), torch.from_numpy(u_rr)).numpy()
    close = share_close(got, ref)
    print(f"{which} {mode}: {int((~close).sum())} of {close.size} lanes outside rtol {RTOL} / "
          f"atol {ATOL}; mean {got.mean():.6f} against {ref.mean():.6f}")
    assert np.isfinite(got).all() and got.max() > 0
    assert close.mean() >= 0.999


@pytest.mark.parametrize("mode", ["path", "simple"])
def test_sample_matches_jax(cornell, mode):
    sample_case(*cornell, "cornell", mode)


def _jax_state(st):
    return {k: np.array(getattr(st, k)) for k in FIELDS}


def _port_state(tree):
    return pssmlt.PssmltState(**{k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


@pytest.fixture(scope="module")
def chains(cornell):
    """JAX's state after 2 bootstrap rounds and after 1 sampling round more
    (256 chains, one per pixel of the 16x16 box)."""
    js, _ = cornell
    integ = jpssmlt.Pssmlt(max_depth=4, bootstrap_count=2)
    n = 256
    st, acc = integ.init_state(n), jnp.zeros((n, 3), jnp.float32)
    states = []
    for i in range(3):
        st, acc = integ.step(js, st, acc, jnp.uint32(9), jnp.uint32(i), jnp.asarray(i < 2))
        states.append((_jax_state(st), np.array(acc)))
    return states


@pytest.mark.parametrize("bootstrap", [True, False])
def test_step_matches_jax(cornell, chains, bootstrap):
    js, ts = cornell
    jinteg = jpssmlt.Pssmlt(max_depth=4, bootstrap_count=2)
    tinteg = Pssmlt(max_depth=4, bootstrap_count=2)
    # a bootstrap round from the first bootstrap state; a sampling round
    # from the state after the last
    tree, acc = chains[0] if bootstrap else chains[2]
    it = 1 if bootstrap else 3
    jst, jacc = jinteg.step(js, jpssmlt.PssmltState(**{k: jnp.asarray(v) for k, v in tree.items()}),
                            jnp.asarray(acc), jnp.uint32(9), jnp.uint32(it),
                            jnp.asarray(bootstrap))
    ref = _jax_state(jst)
    tst, tacc = tinteg.step(ts, _port_state(tree), torch.from_numpy(acc.copy()), 9, it, bootstrap)
    got = {k: getattr(tst, k).numpy() for k in FIELDS}

    # the accept decision: a chain moved (or took its new value) in one
    # package and not in the other
    moved_ref = (ref["pos"] != tree["pos"]).any(-1) | (ref["u_rr"] != tree["u_rr"]).any(0)
    moved_got = (got["pos"] != tree["pos"]).any(-1) | (got["u_rr"] != tree["u_rr"]).any(0)
    agree = moved_ref == moved_got
    print(f"bootstrap={bootstrap}: accept decisions differ on {int((~agree).sum())} of "
          f"{agree.size} chains; {int(moved_ref.sum())} moved")
    assert agree.mean() >= 0.999
    for k, axis in (("pos", 0), ("u_bsdf", 1), ("u_em", 1), ("u_rr", 1), ("L", 0)):
        close = share_close(got[k], ref[k], lanes_axis=axis)
        assert close[agree].all(), (k, int((~close[agree]).sum()))
    np.testing.assert_allclose(got["b_sum"], ref["b_sum"], rtol=1e-5)
    close = share_close(tacc.numpy(), np.asarray(jacc))
    print(f"accumulator: {int((~close).sum())} of {close.size} pixels outside the tolerance")
    assert close.mean() >= 0.999
    if bootstrap:
        assert np.array_equal(tacc.numpy(), acc) and float(got["b_sum"]) > float(tree["b_sum"])
    else:
        assert not np.array_equal(tacc.numpy(), acc)


@pytest.mark.parametrize("mode", ["path", "simple"])
def test_render_runs(mode):
    """The JAX package's test_pssmlt_step_runs on its own scene, the bare
    Cornell box: 60 rounds take 2 s of a CPU on the brute-force path and 42 s on
    the box with a sphere, whose BVH path the tests above cover.  b, the
    bootstrap rounds' mean luminance, from two bootstrap rounds."""
    ts = load_dict(cornell_box(res=16, spp=1), device="cpu")[0]
    img = Pssmlt(max_depth=3, mode=mode).render(ts, seed=0, n_iterations=60)
    assert img.shape == (16, 16, 3)
    assert torch.isfinite(img).all() and float(img.max()) > 0
    integ = Pssmlt(max_depth=3, mode=mode, bootstrap_count=2)
    state, accum = integ.run_chains(ts, seed=0, n_iterations=2)
    b = float(integ.normalization(state))
    assert b > 0 and b == pytest.approx(float(state.b_sum) / (2 * 256), rel=1e-6)
    assert not accum.any()   # bootstrap rounds splat nothing


def test_registered_as_pssmlt():
    integ = make_integrator({"type": "pssmlt", "max_depth": 5, "mode": "simple", "spp": 4})
    assert integ == Pssmlt(max_depth=5, mode="simple")


# ---- the standalone Metropolis sampler -------------------------------------

def test_metropolis_advance_matches_jax():
    n, d = 4096, 3
    ref = jmetro.seed_metropolis(7, n, d)
    got = metropolis.seed_metropolis(7, n, d, device="cpu")
    np.testing.assert_array_equal(got.proposed.numpy(), np.asarray(ref.proposed))
    rng = np.random.default_rng(2)
    for _ in range(3):
        f = rng.random(n).astype(np.float32) * (rng.random(n) < 0.9)
        ref = jmetro.advance(ref, jnp.asarray(f))
        got = metropolis.advance(got, torch.from_numpy(f))
        for k in ("samples", "proposed", "f"):
            a, b = getattr(got, k).numpy(), np.asarray(getattr(ref, k))
            close = np.isclose(a, b, rtol=0, atol=1e-6).reshape(n, -1).all(-1)
            assert close.mean() >= 0.999, (k, int((~close).sum()))
        # later proposals start from the same state again, so that one
        # flipped decision is not carried on
        got = metropolis.MetropolisState(
            samples=torch.from_numpy(np.array(ref.samples)),
            proposed=torch.from_numpy(np.array(ref.proposed)),
            f=torch.from_numpy(np.array(ref.f)), sampler=got.sampler)
    assert got.proposed.shape == (n, d)
    assert bool(((got.proposed >= 0) & (got.proposed < 1)).all())


def test_metropolis_kl_convergence():
    kls, hist, target = metropolis.run_chain_1d(n_chains=8192, n_iters=300, seed=1, device="cpu")
    # the assertions of the JAX package's test of the same name
    assert kls[-1] < 0.05, kls
    assert kls[-1] <= kls[0] + 1e-3
    centers = (np.arange(64) + 0.5) / 64
    assert hist[(centers > 0.51) & (centers < 0.59)].sum() < 0.01
    t = metropolis.analytic_target(centers)
    t /= t.sum()
    assert abs((hist * centers).sum() - (t * centers).sum()) < 0.02
    np.testing.assert_allclose(target, t)
