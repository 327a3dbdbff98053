"""Automatic mixed precision (counterpart of paddle_tpu/amp.py): the op
lists, ``amp_guard``, the loss-scaling optimizer wrapper, ``decorate``
and ``cast_params``.

Casting happens at the layer boundaries through the dtype policy
(``core/dtypes.py``): float32 master parameters and optimizer state,
bfloat16 or float16 products in the Linears. ``mixed_bf16`` needs no
loss scaling; ``mixed_fp16`` pairs with :func:`decorate`'s
:class:`MixedPrecisionOptimizer`, which scales the loss and skips the
steps whose gradients are not finite."""

from __future__ import annotations

from typing import Optional, Set

import torch

from .clip import tree_leaves, tree_map
from .core.dtypes import policy_scope, set_policy
from .core.enforce import enforce
from .optimizer.loss_scaler import DynamicLossScaler
from .optimizer.optimizers import Optimizer

# ops safe in half precision (the matmul-heavy ones), and ops that stay
# float32 (reductions prone to overflow); advisory, as in the JAX
# package: no graph is rewritten, layers may consult should_run_fp32
WHITE_LIST: Set[str] = {
    "conv2d", "conv3d", "matmul", "mul", "fc", "depthwise_conv2d",
    "conv2d_transpose", "attention",
}
BLACK_LIST: Set[str] = {
    "exp", "log", "square", "softmax", "log_softmax", "mean", "sum",
    "cross_entropy", "softmax_with_cross_entropy", "cos_sim", "layer_norm",
    "batch_norm", "group_norm", "l2_normalize", "reduce_sum", "reduce_mean",
}


class AutoMixedPrecisionLists:
    """White and black op-name lists with custom overrides."""

    def __init__(self, custom_white_list: Optional[Set[str]] = None,
                 custom_black_list: Optional[Set[str]] = None):
        self.white_list = set(WHITE_LIST)
        self.black_list = set(BLACK_LIST)
        if custom_white_list:
            for op in custom_white_list:
                enforce(op not in (custom_black_list or ()),
                        "op %s in both custom white and black lists", op)
                self.black_list.discard(op)
                self.white_list.add(op)
        if custom_black_list:
            for op in custom_black_list:
                self.white_list.discard(op)
                self.black_list.add(op)

    def should_run_fp32(self, op_name: str) -> bool:
        return op_name in self.black_list


def amp_guard(policy="mixed_bf16"):
    """Context manager: the mixed-precision ``policy`` for the block."""
    return policy_scope(policy)


class MixedPrecisionOptimizer(Optimizer):
    """An optimizer with loss scaling and non-finite-step skipping.

    Usage in a manual loop:
        state = opt.init(params)
        opt.scale_loss(raw_loss, state).backward()
        params, state = opt.apply(params, scaled_grads, state)
    ``apply`` casts the grads to float32, unscales them, and applies the
    inner update only when every grad is finite; then it moves the
    loss-scale state on.

    The inner optimizer updates in place, so a skipped step must not run
    it at all: ``apply`` reads the finite flag on the host (one read a
    step, as ``torch.amp.GradScaler.step`` does) and calls the inner
    ``apply`` only when it is set. The parameters and the inner state,
    its step count too, stay bit-unchanged on a skipped step."""

    def __init__(self, inner: Optimizer, init_loss_scaling: float = 2.0 ** 15,
                 use_dynamic_loss_scaling: bool = True,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5):
        self.inner = inner
        self.use_dynamic = use_dynamic_loss_scaling
        self.scaler = DynamicLossScaler(
            init_scale=init_loss_scaling,
            incr_every_n_steps=incr_every_n_steps,
            decr_every_n_nan_or_inf=decr_every_n_nan_or_inf,
            incr_ratio=incr_ratio, decr_ratio=decr_ratio)

    def init(self, params):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        return {"inner": self.inner.init(params),
                "scaler": self.scaler.init(device)}

    def scale_loss(self, loss, state):
        return loss * state["scaler"]["scale"].to(loss.dtype)

    def current_scale(self, state):
        return state["scaler"]["scale"]

    def current_lr(self, state):
        return self.inner.current_lr(state["inner"])

    def apply(self, params, grads, state):
        grads = tree_map(lambda g: g.float(), grads)  # master-grad precision
        unscaled, scaler_state, is_finite = self.scaler.unscale_and_update(
            grads, state["scaler"])
        if not self.use_dynamic:
            # static scaling: the scale stays, only the skip logic runs
            scaler_state["scale"] = state["scaler"]["scale"]
        if bool(is_finite):
            self.inner.apply(params, unscaled, state["inner"])
        state["scaler"] = scaler_state
        return params, state


def decorate(optimizer: Optimizer,
             amp_lists: Optional[AutoMixedPrecisionLists] = None,
             init_loss_scaling: float = 2.0 ** 15,
             use_dynamic_loss_scaling: bool = True,
             policy: str = "mixed_fp16",
             **scaler_kw) -> MixedPrecisionOptimizer:
    """``optimizer`` with mixed-precision training: sets the global
    policy to ``policy`` and wraps the optimizer in a
    :class:`MixedPrecisionOptimizer` (the bfloat16 policies never need
    the scaler but get the same wrapper, so loops are policy-agnostic).
    ``amp_lists`` is advisory, kept for the reference's signature."""
    set_policy(policy)
    return MixedPrecisionOptimizer(
        optimizer, init_loss_scaling=init_loss_scaling,
        use_dynamic_loss_scaling=use_dynamic_loss_scaling, **scaler_kw)


def cast_params(params, dtype=torch.bfloat16):
    """A new tree with the floating leaves of ``params`` cast to
    ``dtype`` (for export or half-precision inference); no gradient
    flows back to ``params``."""
    with torch.no_grad():
        return tree_map(lambda p: p.to(dtype) if p.is_floating_point()
                        else p, params)
