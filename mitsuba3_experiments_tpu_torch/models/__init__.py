"""Neural components (counterpart of ``mitsuba3_experiments_tpu.models``;
``normflow`` and ``reparam`` are not ported yet)."""
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
