"""The port's replay against the JAX package on the every-kind scene with a
constant environment (the emitter types the compiler builds: area lights,
and the constant environment here, the textured envmap in
test_torch_replay_kernel_kinds.py): `replay_grads` full gives JAX's
gradients within rtol 1e-3 / atol 1e-4 max|g| on one record.  A file of
its own: JAX compiles this scene's replay slowly."""
from test_torch_replay_kernel import every_kind, grads_match_jax


def test_replay_function_matches_jax_on_every_kind_with_constant_env():
    grads_match_jax(every_kind("constant"), ["full"])
