"""Training and parallelism of the port (counterpart of
paddle_tpu/parallel): the Trainer and DataParallel, the collectives over
mesh axes, context parallelism (ring and Ulysses attention), and the
sharding rules and plans (dp, fsdp, tp, ep); the mesh itself lives in
core/mesh.py. Pipelines, the sharded embedding and the
compressed-gradient trainers are a later slice (ROADMAP.md)."""

from .api import DataParallel, Trainer
from .collective import (all_to_all, allgather, allreduce, axis_index,
                         broadcast, ppermute, reduce_scatter)
from .context_parallel import (context_parallel_attention, ring_attention,
                               sharded_flash_attention, ulysses_attention)
from .plan import (Plan, compile_step, device_bytes, guard_no_resharding,
                   host_init, max_device_bytes)
from .sharding import (OptStateRules, constraint, infer_param_spec,
                       shard_params, transformer_tp_rules, zero_dp_rules)

__all__ = [
    "DataParallel", "Trainer",
    "Plan", "compile_step", "device_bytes", "guard_no_resharding",
    "host_init", "max_device_bytes",
    "allgather", "allreduce", "all_to_all", "axis_index", "broadcast",
    "ppermute", "reduce_scatter",
    "context_parallel_attention", "ring_attention",
    "sharded_flash_attention", "ulysses_attention",
    "OptStateRules", "constraint", "infer_param_spec", "shard_params",
    "transformer_tp_rules", "zero_dp_rules",
]
