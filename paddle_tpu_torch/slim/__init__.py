"""Model compression (counterpart of paddle_tpu/slim) — the contrib/slim
capability set (reference: python/paddle/fluid/contrib/slim/):
distillation (distill.py), pruning with sensitivity analysis and
structural shrink (prune.py), and the epoch-driven
Compressor/Strategy/Config loop (core.py). Quantization lives in
``paddle_tpu_torch.quant``."""

from .core import (Compressor, Context, DistillationStrategy,
                   SensitivePruneStrategy, Strategy, UniformPruneStrategy,
                   build_strategies)
from .distill import (Distiller, fsp_loss, l2_feature_loss,
                      soft_label_loss)
from .prune import (Pruner, channel_keep_indices, compute_sensitivities,
                    greedy_ratios_for_target, magnitude_mask, shrink_params,
                    structured_channel_mask, uniform_ratio_search)

__all__ = [
    "Compressor", "Context", "Strategy", "UniformPruneStrategy",
    "SensitivePruneStrategy", "DistillationStrategy", "build_strategies",
    "Distiller", "soft_label_loss", "fsp_loss", "l2_feature_loss",
    "Pruner", "magnitude_mask", "structured_channel_mask",
    "compute_sensitivities", "greedy_ratios_for_target",
    "uniform_ratio_search", "channel_keep_indices", "shrink_params",
]
