"""Ray-parallel rendering and gradients over a ``torch.distributed`` mesh."""
from .mesh import (  # noqa: F401
    make_mesh,
    render_persistent_sharded,
    render_sharded,
    sharded_grad_step,
    sharded_replay_grad,
)
