from .dispatch import (  # noqa: F401
    bsdf_flags,
    eval_pdf,
    eval_pdf_sample,
    sample,
)
