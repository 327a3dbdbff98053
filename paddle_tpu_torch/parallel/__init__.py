"""Training and parallelism of the port (counterpart of
paddle_tpu/parallel): the Trainer and DataParallel, the collectives over
mesh axes, context parallelism (ring and Ulysses attention), and the
sharding rules and plans (dp, fsdp, tp, ep), pipelines over pp and the
composed dp x tp x pp steps, the sharded embedding tables, DGC and
geo-SGD; the mesh itself lives in core/mesh.py."""

from .api import DataParallel, Trainer
from .collective import (all_to_all, allgather, allreduce, axis_index,
                         broadcast, ppermute, reduce_scatter)
from .context_parallel import (context_parallel_attention, ring_attention,
                               sharded_flash_attention, ulysses_attention)
from .dgc import (DGCMomentum, dgc_allreduce, quantized_allreduce,
                  top_k_sparsify)
from .geo_sgd import GeoSGDTrainer
from .hybrid import (build_bert_hybrid_step, build_gpt_hybrid_step,
                     build_hybrid_transformer_step)
from .pipeline import (GPipe, bubble_fraction, gpipe_ticks,
                       interleaved_ticks, pipeline_apply,
                       ring_order_layers, stage_param_sharding)
from .plan import (Plan, compile_step, device_bytes, guard_no_resharding,
                   host_init, max_device_bytes)
from .sharded_embedding import (ShardedEmbedding, embedding_ep_rules,
                                sharded_embedding_lookup)
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
    "GPipe", "pipeline_apply", "stage_param_sharding",
    "bubble_fraction", "gpipe_ticks", "interleaved_ticks",
    "ring_order_layers",
    "ShardedEmbedding", "embedding_ep_rules", "sharded_embedding_lookup",
    "DGCMomentum", "dgc_allreduce", "quantized_allreduce", "top_k_sparsify",
    "build_hybrid_transformer_step", "build_bert_hybrid_step",
    "build_gpt_hybrid_step",
    "GeoSGDTrainer",
]
