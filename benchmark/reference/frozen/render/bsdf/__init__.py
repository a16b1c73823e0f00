# Frozen copy of mitsuba3_experiments_tpu_torch/render/bsdf/__init__.py at commit aa7dcd9, part of the
# benchmark's plain reference; imported from benchmark/reference only, never from the port.
from .dispatch import (  # noqa: F401
    base_color,
    bsdf_flags,
    eval_pdf,
    eval_pdf_sample,
    sample,
)
