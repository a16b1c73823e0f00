"""Checkpoint / resume of training state: nested dicts and lists of tensors
(parameters, an optimizer's `state_dict()`, the step), in one format,
``torch.save`` read back by ``torch.load(weights_only=True)``.

Counterpart of ``mitsuba3_experiments_tpu.utils.checkpoint``."""
from __future__ import annotations

import os

import torch


def _to_cpu(state):
    if isinstance(state, torch.Tensor):
        return state.detach().cpu()
    if isinstance(state, dict):
        return {k: _to_cpu(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_to_cpu(v) for v in state)
    return state


def _place(loaded, template):
    """Each tensor of `loaded` on the device of its counterpart in
    `template`; a part without one stays on the CPU."""
    if isinstance(loaded, torch.Tensor):
        return loaded.to(template.device) if isinstance(template, torch.Tensor) else loaded
    if isinstance(loaded, dict):
        tmpl = template if isinstance(template, dict) else {}
        return {k: _place(v, tmpl.get(k)) for k, v in loaded.items()}
    if isinstance(loaded, (list, tuple)):
        tmpl = template if isinstance(template, (list, tuple)) else ()
        return type(loaded)(_place(v, tmpl[i] if i < len(tmpl) else None)
                            for i, v in enumerate(loaded))
    return loaded


def save_checkpoint(path: str, state) -> None:
    """Write `state` (tensors detached and copied to the host) to `path`,
    through a temporary file renamed into place."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, template):
    """Read a checkpoint written by `save_checkpoint`; `template` (a state of
    the same structure) gives each tensor its device."""
    return _place(torch.load(os.path.abspath(path), map_location="cpu", weights_only=True),
                  template)
