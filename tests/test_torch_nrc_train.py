"""The port's counterpart of tests/test_misc.py's
test_nrc_online_trainer_learns_cache, on the port alone (the 24x24 Cornell
box references of test_torch_nrc.py)."""
import numpy as np
import torch

from mitsuba3_experiments_tpu_torch.integrators import NRCIntegrator, NRCTrainer, render
from test_torch_nrc import TRAINER, _field_cfg, cornell24  # noqa: F401

torch.set_num_threads(2)


def test_port_nrc_trainer_learns_cache(cornell24):
    """NRCTrainer trains the cache online: the loss falls and the cache
    closes some of the truncation gap (test_nrc_online_trainer_learns_cache)."""
    scene, ref, trunc = cornell24
    trainer = NRCTrainer(field_cfg=_field_cfg(), **dict(TRAINER, batch_size=1 << 10))
    field, losses = trainer.train(scene, n_iters=250, seed=0)
    head, tail = np.mean(losses[:50]), np.mean(losses[-50:])
    assert np.isfinite(losses).all()
    assert tail < 0.7 * head, (head, tail)
    cached = render(scene, NRCIntegrator(max_depth=3, spread_c=1e-6, cache=(field, trainer)),
                    spp=32, seed=2).numpy()
    assert abs(ref.mean() - cached.mean()) < abs(ref.mean() - trunc.mean())
