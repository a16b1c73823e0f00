"""Array concatenation helpers (counterpart of
``mitsuba3_experiments_tpu.ops.concat``): both entry points concatenate
along axis 0; the scatter form writes each piece into a preallocated
buffer."""
from __future__ import annotations

import torch


def concat_gather(arrays):
    return torch.cat(list(arrays), dim=0)


def concat_scatter(arrays):
    n = sum(a.shape[0] for a in arrays)
    out = torch.empty((n,) + tuple(arrays[0].shape[1:]), dtype=arrays[0].dtype,
                      device=arrays[0].device)
    off = 0
    for a in arrays:
        out[off: off + a.shape[0]] = a
        off += a.shape[0]
    return out
