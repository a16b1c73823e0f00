"""PSSMLT's path evaluation against the JAX package on the 24x16 stand-in,
every BSDF kind: a file of its own, so that each file of the MCMC tests
stays within 60 s (the JAX side's compiles of the stand-in's programs take
most of the time).  The comparison is test_torch_mcmc.py's."""
import pytest

from mitsuba3_experiments_tpu_torch.scene import standin_dict
from test_torch_mcmc import pair, sample_case


@pytest.fixture(scope="module")
def standin():
    return pair(standin_dict(res=(24, 16), spp=1, tri_budget=20_000))


@pytest.mark.parametrize("mode", ["path", "simple"])
def test_sample_matches_jax_on_standin(standin, mode):
    sample_case(*standin, "standin", mode)
