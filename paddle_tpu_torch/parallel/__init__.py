"""Training and parallelism of the port (counterpart of
paddle_tpu/parallel): the Trainer and DataParallel, the collectives over
mesh axes, and context parallelism (ring and Ulysses attention); the
mesh itself lives in core/mesh.py. Sharding plans, pipelines, the
sharded embedding and the compressed-gradient trainers are a later
slice (ROADMAP.md)."""

from .api import DataParallel, Trainer
from .collective import (all_to_all, allgather, allreduce, axis_index,
                         broadcast, ppermute, reduce_scatter)
from .context_parallel import (context_parallel_attention, ring_attention,
                               sharded_flash_attention, ulysses_attention)

__all__ = [
    "DataParallel", "Trainer",
    "allgather", "allreduce", "all_to_all", "axis_index", "broadcast",
    "ppermute", "reduce_scatter",
    "context_parallel_attention", "ring_attention",
    "sharded_flash_attention", "ulysses_attention",
]
