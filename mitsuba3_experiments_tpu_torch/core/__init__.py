from . import distributions, math, records, rng, warp  # noqa: F401
