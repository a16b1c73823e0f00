"""Data-parallel primitives (counterpart of ``mitsuba3_experiments_tpu.ops``;
SPPM's hash grid is ``ops/hashgrid.py``)."""
from .prefix_sum import prefix_sum, prefix_sum_blocked  # noqa: F401
from .reductions import (  # noqa: F401
    block_sum,
    scatter_reduce,
    scatter_reduce_with,
    segment_sum,
)
from .compaction import (  # noqa: F401
    compress_indices,
    invert_permutation,
    partition_by_key,
)
from .concat import concat_gather, concat_scatter  # noqa: F401
