"""The port's replay against the JAX package on the scene that holds every BSDF
kind (test_torch_replay_kernel.every_kind: all ten kinds, textured
albedos, a mask over a nested BSDF and a mask with a textured opacity, zero
albedo channels, two area lights and a textured envmap): `replay_grads`
full and sorted give JAX's gradients within rtol 1e-3 / atol 1e-4 max|g|
on one record (the constant environment: test_torch_replay_kernel_env.py).
On CPU tensors the replay is the plain version, so this holds the port's
replay — and with it the arithmetic K5 is held to — against the
reference.  A file of its own: JAX compiles this scene's replay slowly."""
import pytest

from test_torch_replay_kernel import every_kind, grads_match_jax


@pytest.mark.parametrize("mode", ["full", "sorted"])
def test_replay_function_matches_jax_on_every_kind_with_envmap(mode):
    grads_match_jax(every_kind("envmap"), [mode])
