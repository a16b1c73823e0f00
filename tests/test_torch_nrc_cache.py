"""The port's counterpart of tests/test_misc.py's
test_nrc_with_cache_recovers_energy, on the port alone (the 24x24 Cornell
box references of test_torch_nrc.py)."""
import numpy as np
import torch

from mitsuba3_experiments_tpu_torch.integrators import NRCIntegrator, render
from mitsuba3_experiments_tpu_torch.models import NeradTrainer
from test_torch_nrc import _field_cfg, cornell24  # noqa: F401

torch.set_num_threads(2)


def test_port_nrc_nerad_cache_closes_the_gap(cornell24):
    """A neural-radiosity field as the cache closes some of the
    truncation gap (test_nrc_with_cache_recovers_energy)."""
    scene, ref, trunc = cornell24
    trainer = NeradTrainer(field_cfg=_field_cfg(), batch_size=1 << 10, m_rhs=8, lr=2e-3)
    init, step = trainer.make_train_step(scene)
    field, opt = init(torch.Generator().manual_seed(0))
    for i in range(200):
        step(field, opt, i)
    cached = render(scene, NRCIntegrator(max_depth=3, spread_c=1e-6, cache=(field, trainer)),
                    spp=32, seed=2).numpy()
    assert abs(ref.mean() - cached.mean()) < abs(ref.mean() - trunc.mean())
