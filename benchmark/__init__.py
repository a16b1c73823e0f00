"""The benchmark of mitsuba3_experiments_tpu_torch (the PyTorch + CUDA port):
`run.py` runs one cell of `BENCHMARK.json` once.  It imports the port only as
the system under test, and neither `jax` nor the JAX package."""
