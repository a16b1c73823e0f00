"""The port's spectral mode against the JAX package: core/spectrum.py's
constants and functions, the colorimetric identities of
tests/test_spectral.py, and SpectralIntegrator / render_spectral images.

Functions: allclose at rtol 1e-5 / atol 1e-6 on seeded inputs (the
constants equal).  Images: at least 99.9% of the pixels within rtol 1e-4 /
atol 1e-5 and means within a relative 1e-4, the pixels outside printed (a
Russian-roulette decision that flipped at a float boundary)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba3_experiments_tpu.core import spectrum as jsp
from mitsuba3_experiments_tpu.integrators.spectral import SpectralIntegrator as JSpectral
from mitsuba3_experiments_tpu.integrators.spectral import render_spectral as jax_render_spectral
from mitsuba3_experiments_tpu.scene import load_dict as jax_load_dict
from mitsuba3_experiments_tpu_torch.core import spectrum as sp
from mitsuba3_experiments_tpu_torch.integrators import SpectralIntegrator, render_spectral
from mitsuba3_experiments_tpu_torch.scene import scene_from_numpy, scene_to_numpy, standin_dict

torch.set_num_threads(2)


def _close(t, j, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def test_spectrum_constants_match_jax():
    """The float64 constants round to JAX's float32 ones."""
    assert sp.CMF_Y_INTEGRAL == jsp.CMF_Y_INTEGRAL
    assert sp.XYZ_TO_SRGB.dtype == np.float64 and sp.EQUAL_ENERGY_WHITE_SRGB.dtype == np.float64
    np.testing.assert_array_equal(sp.XYZ_TO_SRGB.astype(np.float32), jsp.XYZ_TO_SRGB)
    np.testing.assert_array_equal(sp.EQUAL_ENERGY_WHITE_SRGB.astype(np.float32),
                                  jsp.EQUAL_ENERGY_WHITE_SRGB)
    assert (sp.LAMBDA_MIN, sp.LAMBDA_MAX) == (jsp.LAMBDA_MIN, jsp.LAMBDA_MAX)


@pytest.mark.parametrize("k", [1, 4])
def test_spectrum_functions_match_jax(k):
    rng = np.random.default_rng(17 + k)
    u = rng.random(4096, dtype=np.float32)
    lam, pdf = sp.sample_wavelengths(torch.as_tensor(u), k)
    jlam, jpdf = jsp.sample_wavelengths(jnp.asarray(u), k)
    _close(lam, jlam)
    _close(pdf, jpdf)
    _close(sp.cie_xyz_fit(lam), jsp.cie_xyz_fit(jlam))
    rgb = rng.uniform(0.0, 2.0, (4096, 3)).astype(np.float32)
    _close(sp.upsample_rgb(torch.as_tensor(rgb), lam), jsp.upsample_rgb(jnp.asarray(rgb), jlam))
    _close(sp.upsample_rgb(torch.tensor([0.2, 0.5, 0.9]), lam),
           jsp.upsample_rgb(jnp.asarray([0.2, 0.5, 0.9]), jlam))
    _close(sp.spectrum_to_xyz_weight(lam, pdf, k), jsp.spectrum_to_xyz_weight(jlam, jpdf, k))
    xyz = rng.uniform(0.0, 3.0, (64, 48, 3)).astype(np.float32)
    for wb in (True, False):
        _close(sp.xyz_to_srgb(torch.as_tensor(xyz), wb), jsp.xyz_to_srgb(jnp.asarray(xyz), wb))


def test_spectrum_rgb_mode_helpers():
    """The Mitsuba-API aliases of the RGB mode."""
    assert torch.equal(sp.spectrum(0.5, device="cpu"), torch.full((3,), 0.5))
    assert sp.spectrum([1.0, 2.0, 3.0], n=4, device="cpu").shape == (4, 3)
    x = torch.rand(5, 3)
    assert sp.unpolarized_spectrum(x) is x and sp.to_world_mueller(x, None, None) is x
    assert sp.spectrum_list_to_srgb(x) is x
    _close(sp.luminance(x), jsp.luminance(jnp.asarray(x.numpy())))
    assert not (sp.is_spectral or sp.is_monochromatic or sp.is_polarized)


def test_wavelength_sampling_and_upsampling_identities():
    """tests/test_spectral.py's identities, on the port."""
    u = torch.linspace(0.0, 0.999, 64)
    lam, pdf = sp.sample_wavelengths(u, 4)
    assert lam.shape == (64, 4)
    assert bool(((lam >= sp.LAMBDA_MIN) & (lam < sp.LAMBDA_MAX + 1)).all())
    np.testing.assert_allclose(pdf.numpy(), 1.0 / (sp.LAMBDA_MAX - sp.LAMBDA_MIN))
    # gray upsamples to the exact constant (partition of unity)
    np.testing.assert_allclose(sp.upsample_rgb(torch.full((1, 3), 0.37), lam[:1]).numpy(), 0.37,
                               rtol=1e-5)
    # ybar is nonnegative and the equal-energy spectrum has Y = 1
    Y = sp.spectrum_to_xyz_weight(lam, pdf, 4)[..., 1].sum(dim=1).numpy()
    assert Y.min() > 0 and abs(Y.mean() - 1.0) < 0.02


def test_equal_energy_white_maps_to_gray():
    u = torch.linspace(0.0, 0.999, 4096)
    lam, pdf = sp.sample_wavelengths(u, 4)
    xyz = sp.spectrum_to_xyz_weight(lam, pdf, 4).sum(dim=1).mean(dim=0)
    np.testing.assert_allclose(sp.xyz_to_srgb(xyz[None, None, :])[0, 0].numpy(), 1.0, rtol=0.02)


@pytest.fixture(scope="module")
def standin():
    js = jax_load_dict(standin_dict(res=(24, 16), spp=1, tri_budget=20_000))[0]
    return js, scene_from_numpy(scene_to_numpy(js), device="cpu")


def test_render_spectral_image_matches_jax(standin):
    """render_spectral on the stand-in, whose every BSDF kind's RGB sample
    weight upsamples to a spectrum, against JAX's, in launches of 500
    rays (a partial last one)."""
    js, ts = standin
    img = render_spectral(ts, SpectralIntegrator(max_depth=4), seed=5, spp=2, chunk=500)
    ref = np.asarray(jax_render_spectral(js, JSpectral(max_depth=4), seed=5, spp=2, chunk=500))
    a = img.numpy()
    close = (np.isclose(a, ref, rtol=1e-4, atol=1e-5) | (a == ref)).all(-1)
    rel = abs(a.mean() - ref.mean()) / ref.mean()
    print(f"[render_spectral] {int((~close).sum())} of {close.size} pixels outside rtol 1e-4 / "
          f"atol 1e-5; means {a.mean():.7f} / {ref.mean():.7f} (rel {rel:.2e})")
    assert np.isfinite(a).all() and a.min() >= 0.0 and ref.mean() > 0
    assert close.mean() >= 0.999 and rel <= 1e-4
