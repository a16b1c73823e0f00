"""Neural components (counterpart of ``mitsuba3_experiments_tpu.models``):
MLPs, the hash-grid encoding, the fused MLP, neural radiosity, normalizing
flows (`normflow`) and reparameterized sampling (`reparam`)."""
from . import normflow, reparam  # noqa: F401
from .hashgrid_enc import (  # noqa: F401
    HashGridConfig,
    hashgrid_encode,
    init_hashgrid,
)
from .mlp import apply_mlp, identity_init_mlp, init_mlp  # noqa: F401
from .nerad import (  # noqa: F401
    Field,
    FieldConfig,
    NeradIntegrator,
    NeradTrainer,
    field_eval,
    init_field,
)
