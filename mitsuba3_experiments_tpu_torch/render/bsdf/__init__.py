from .dispatch import (  # noqa: F401
    base_color,
    bsdf_flags,
    eval_pdf,
    eval_pdf_sample,
    sample,
)
