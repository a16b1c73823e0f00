from . import bsdf, emitter, film, fresnel, microfacet, sensor, texture  # noqa: F401
