# Frozen copy of mitsuba3_experiments_tpu_torch/__init__.py at commit aa7dcd9 (resolve_device), part of
# the benchmark's plain reference; imported from benchmark/reference only, never from the port.
"""The port's plain code, frozen: the shading, sampling, film and scene
compile of the CPU path, which the benchmark's reference runs on the card
against the port's outputs.  Subpackages mirror the port's layout so that
the copies keep their relative imports."""
import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device, the card for None."""
    return torch.device("cuda") if device is None else torch.device(device)
