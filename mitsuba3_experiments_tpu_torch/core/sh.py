"""Real spherical harmonics, bands 0..3: the direction encoding of the
neural-radiosity field.

Counterpart of ``mitsuba3_experiments_tpu.core.sh``, with the same
constants and the same polynomial expressions, term for term.
"""
from __future__ import annotations

import torch


def sh_eval(d, order: int):
    """d: (..., 3) unit directions; order: max band L (inclusive).

    Returns (..., (L+1)^2) SH basis values, bands 0..L.
    """
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    out = [torch.full(x.shape, 0.28209479177387814, dtype=d.dtype, device=d.device)]  # l=0
    if order >= 1:
        c1 = 0.4886025119029199
        out += [-c1 * y, c1 * z, -c1 * x]
    if order >= 2:
        out += [
            1.0925484305920792 * x * y,
            -1.0925484305920792 * y * z,
            0.31539156525252005 * (3.0 * z * z - 1.0),
            -1.0925484305920792 * x * z,
            0.5462742152960396 * (x * x - y * y),
        ]
    if order >= 3:
        out += [
            -0.5900435899266435 * y * (3.0 * x * x - y * y),
            2.890611442640554 * x * y * z,
            -0.4570457994644658 * y * (5.0 * z * z - 1.0),
            0.3731763325901154 * z * (5.0 * z * z - 3.0),
            -0.4570457994644658 * x * (5.0 * z * z - 1.0),
            1.445305721320277 * z * (x * x - y * y),
            -0.5900435899266435 * x * (x * x - 3.0 * y * y),
        ]
    if order >= 4:
        raise NotImplementedError("sh_eval supports bands up to 3")
    return torch.stack(out, dim=-1)
