"""Multi-device execution: ray-axis sharding over ``torch.distributed``
(counterpart of ``pyrayt_tpu.parallel``).

Rays never interact during a trace, so the ray batch is the data-parallel
axis of this domain: each rank (one process per device) traces its block
of rays with the scene replicated, and the only communication is the
combine of results and the sum of scalar metrics and parameter gradients.
Wide scenes may instead split their trees over the ranks
(``build_wide_sharded_trace_fn``).
"""

from pyrayt_tpu_torch.parallel.distributed import initialize_distributed, is_distributed
from pyrayt_tpu_torch.parallel.mesh import (
    RAY_AXES,
    default_mesh,
    pad_rayset,
    rayset_sharding,
    shard_rayset,
)
from pyrayt_tpu_torch.parallel.surfaces import (
    build_surface_sharded_nearest_hit,
    build_wide_sharded_trace_fn,
    pad_leaf_tables,
)
from pyrayt_tpu_torch.parallel.trace import (
    build_sharded_trace_fn,
    build_train_step,
    sharded_trace,
)

__all__ = [
    "RAY_AXES",
    "default_mesh",
    "initialize_distributed",
    "is_distributed",
    "pad_rayset",
    "rayset_sharding",
    "shard_rayset",
    "build_sharded_trace_fn",
    "build_surface_sharded_nearest_hit",
    "build_train_step",
    "build_wide_sharded_trace_fn",
    "pad_leaf_tables",
    "sharded_trace",
]
