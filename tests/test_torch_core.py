"""Port core (mitsuba3_experiments_tpu_torch.core) against the JAX package:
the counter-based RNG bit for bit, warps / math / discrete distributions
allclose (rtol 1e-5, atol 1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu.core import distributions as jdist
from mitsuba3_experiments_tpu.core import math as jm
from mitsuba3_experiments_tpu.core import rng as jrng
from mitsuba3_experiments_tpu.core import warp as jwarp
from mitsuba3_experiments_tpu_torch.core import distributions as tdist
from mitsuba3_experiments_tpu_torch.core import math as tm
from mitsuba3_experiments_tpu_torch.core import rng as trng
from mitsuba3_experiments_tpu_torch.core import warp as twarp

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
N_TRIPLES = 1_000_000


def _u32(rng, n, hi=2**32):
    return rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)


def _i64(a):
    return torch.as_tensor(a.astype(np.int64))


@pytest.fixture(scope="module")
def triples():
    rng = np.random.default_rng(11)
    return _u32(rng, N_TRIPLES), _u32(rng, N_TRIPLES), _u32(rng, N_TRIPLES, 4096)


def test_tea32_pcg_float01_bit_equal(triples):
    seed, lane, dim = triples
    j0, j1 = jrng.tea32(jnp.asarray(seed), jnp.asarray(dim))
    t0, t1 = trng.tea32(_i64(seed), _i64(dim))
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0).astype(np.int64))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))

    jp = np.asarray(jrng.pcg_hash(jnp.asarray(lane)))
    tp = trng.pcg_hash(_i64(lane))
    np.testing.assert_array_equal(tp.numpy(), jp.astype(np.int64))

    jf = np.asarray(jrng.uint_to_float01(jnp.asarray(jp)))
    tf = trng.uint_to_float01(tp).numpy()
    assert tf.dtype == np.float32
    np.testing.assert_array_equal(tf.view(np.uint32), jf.view(np.uint32))


def test_sampler_bit_equal_on_triples(triples):
    seed, lane, dim = triples
    js = jrng.Sampler(seed=jnp.asarray(seed), lane=jnp.asarray(lane), dim=jnp.asarray(dim))
    ts = trng.Sampler(seed=_i64(seed), lane=_i64(lane), dim=_i64(dim))
    js, ja = js.next_1d()
    ts, ta = ts.next_1d()
    js, jb = js.next_2d()
    ts, tb = ts.next_2d()
    np.testing.assert_array_equal(ta.numpy().view(np.uint32), np.asarray(ja).view(np.uint32))
    np.testing.assert_array_equal(tb.numpy().view(np.uint32), np.asarray(jb).view(np.uint32))
    np.testing.assert_array_equal(ts.dim.numpy(), np.asarray(js.dim).astype(np.int64))


def test_sampler_render_usage_bit_equal():
    """Scalar seed and dim, as render_pass uses the sampler."""
    lane = np.arange(5000, dtype=np.uint32) + np.uint32(2**32 - 2500)  # wraps
    js = jrng.Sampler.create(jrng.seed_from_int(123), lane=jnp.asarray(lane))
    ts = trng.Sampler.create(123, lane=_i64(lane))
    for _ in range(4):
        js, ja = js.next_2d()
        ts, ta = ts.next_2d()
        js, jb = js.next_1d()
        ts, tb = ts.next_1d()
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    jf, tf = js.fork(7), ts.fork(7)
    assert int(jf.seed) == tf.seed


def test_twhere_matches_jax_record_select():
    from mitsuba3_experiments_tpu.core.records import SurfaceInteraction as JSI
    from mitsuba3_experiments_tpu.core.struct import twhere as jtwhere
    from mitsuba3_experiments_tpu_torch.core.records import SurfaceInteraction, twhere

    rng = np.random.default_rng(6)
    n = 257
    shapes = {"t": (n,), "p": (n, 3), "n": (n, 3), "sh_n": (n, 3), "sh_s": (n, 3),
              "sh_t": (n, 3), "uv": (n, 2), "wi": (n, 3)}
    ints = ("prim_idx", "mat_id", "emitter_id")
    a, b = ({k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
            | {k: rng.integers(-1, 50, n).astype(np.int32) for k in ints} for _ in range(2))
    mask = rng.random(n) < 0.5
    ref = jtwhere(jnp.asarray(mask), JSI(**{k: jnp.asarray(v) for k, v in a.items()}),
                  JSI(**{k: jnp.asarray(v) for k, v in b.items()}))
    got = twhere(torch.as_tensor(mask),
                 SurfaceInteraction(**{k: torch.as_tensor(v) for k, v in a.items()}),
                 SurfaceInteraction(**{k: torch.as_tensor(v) for k, v in b.items()}))
    for k in a:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k)))


def _both(rng, shape, lo=0.0, hi=1.0):
    a = rng.uniform(lo, hi, shape).astype(np.float32)
    return jnp.asarray(a), torch.as_tensor(a)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


WARPS_2D = [
    "square_to_uniform_sphere", "square_to_uniform_hemisphere",
    "square_to_uniform_disk_concentric", "square_to_cosine_hemisphere",
    "square_to_std_normal", "square_to_uniform_triangle",
]


@pytest.mark.parametrize("name", WARPS_2D)
def test_warps_2d(name):
    rng = np.random.default_rng(3)
    uj, ut = _both(rng, (4096, 2))
    _close(getattr(twarp, name)(ut), getattr(jwarp, name)(uj))


def test_warp_pdfs_tent_ggx():
    rng = np.random.default_rng(4)
    uj, ut = _both(rng, (4096, 2))
    vj, vt = _both(rng, (4096, 3), -1.0, 1.0)
    pj, pt = _both(rng, (4096, 2), -2.0, 2.0)
    aj, at = _both(rng, (4096,), 0.01, 1.0)
    _close(twarp.square_to_cosine_hemisphere_pdf(vt), jwarp.square_to_cosine_hemisphere_pdf(vj))
    _close(twarp.square_to_uniform_hemisphere_pdf(vt), jwarp.square_to_uniform_hemisphere_pdf(vj))
    _close(twarp.square_to_uniform_sphere_pdf(vt), jwarp.square_to_uniform_sphere_pdf(vj))
    _close(twarp.square_to_std_normal_pdf(pt), jwarp.square_to_std_normal_pdf(pj))
    _close(twarp.interval_to_tent(ut[:, 0]), jwarp.interval_to_tent(uj[:, 0]))
    _close(twarp.square_to_ggx(ut, at), jwarp.square_to_ggx(uj, aj))


def test_math_frames_and_helpers():
    rng = np.random.default_rng(5)
    aj, at = _both(rng, (4096, 3), -1.0, 1.0)
    bj, bt = _both(rng, (4096, 3), -1.0, 1.0)
    _close(tm.dot(at, bt), jm.dot(aj, bj))
    _close(tm.cross(at, bt), jm.cross(aj, bj))
    _close(tm.normalize(at), jm.normalize(aj))
    nj, nt = jm.normalize(aj), tm.normalize(at)
    for x, y in zip(tm.coordinate_system(nt), jm.coordinate_system(nj)):
        _close(x, y)
    sj, tj = jm.coordinate_system(nj)
    st, tt = tm.coordinate_system(nt)
    _close(tm.to_local(st, tt, nt, bt), jm.to_local(sj, tj, nj, bj))
    _close(tm.to_world(st, tt, nt, bt), jm.to_world(sj, tj, nj, bj))
    _close(tm.reflect_about(bt, nt), jm.reflect_about(bj, nj))
    _close(tm.refract(bt, at[:, 0], at[:, 1]), jm.refract(bj, aj[:, 0], aj[:, 1]))
    _close(tm.tan2_theta(nt), jm.tan2_theta(nj))
    _close(tm.safe_div(at[:, 0], torch.where(bt[:, 1] > 0, bt[:, 1], 0.0)),
           jm.safe_div(aj[:, 0], jnp.where(bj[:, 1] > 0, bj[:, 1], 0.0)))
    _close(tm.luminance(at), jm.luminance(aj))
    m4 = jm.matmul4(jm.translate([0.1, 0.2, 0.3]), jm.rotate([1, 2, 3], 33.0))
    _close(tm.transform_vector(torch.as_tensor(m4), bt), jm.transform_vector(jnp.asarray(m4), bj))
    _close(tm.transform_point(torch.as_tensor(m4), bt), jm.transform_point(jnp.asarray(m4), bj))
    np.testing.assert_array_equal(
        tm.look_at([1, 2, 3], [0, 0, 0], [0, 1, 0]), jm.look_at([1, 2, 3], [0, 0, 0], [0, 1, 0])
    )


@pytest.mark.parametrize("k", [7, 1000])
def test_discrete_distribution(k):
    rng = np.random.default_rng(6)
    w = (rng.random(k) * rng.random(k)).astype(np.float32) + np.float32(1e-3)
    jd = jdist.DiscreteDistribution.create(jnp.asarray(w))
    # the CDF is a sum taken in another order than jnp.cumsum's
    np.testing.assert_allclose(
        tdist.DiscreteDistribution.create(w, device="cpu").cdf.numpy(), np.asarray(jd.cdf), rtol=1e-6
    )
    # sampling, on the same tables
    td = tdist.DiscreteDistribution(
        pmf=torch.as_tensor(np.array(jd.pmf)), cdf=torch.as_tensor(np.array(jd.cdf)),
        total=torch.as_tensor(np.array(jd.total)),
    )
    uj, ut = _both(rng, (8192,))
    np.testing.assert_array_equal(td.sample(ut).numpy(), np.asarray(jd.sample(uj)))
    ij, uj2 = jd.sample_reuse(uj)
    it, ut2 = td.sample_reuse(ut)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    _close(ut2, uj2)
    _close(td.prob(it.long()), jd.prob(ij))


def test_discrete_distribution_2d():
    rng = np.random.default_rng(7)
    img = rng.random((8, 16)).astype(np.float32) + np.float32(0.01)
    jd = jdist.DiscreteDistribution2D.create(jnp.asarray(img))
    td = tdist.DiscreteDistribution2D.create(img, device="cpu")
    np.testing.assert_allclose(td.col_cdf.numpy(), np.asarray(jd.col_cdf), rtol=1e-6)
    np.testing.assert_allclose(td.row_cdf.numpy(), np.asarray(jd.row_cdf), rtol=1e-6)
    td = tdist.DiscreteDistribution2D(
        **{k: torch.as_tensor(np.array(getattr(jd, k)))
           for k in ("weights", "row_cdf", "col_cdf", "total")}
    )
    uj, ut = _both(rng, (4096, 2))
    jo = jd.sample_reuse(uj)
    to = td.sample_reuse(ut)
    for a, b in zip(to[:2], jo[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(to[2:], jo[2:]):
        _close(a, b)
