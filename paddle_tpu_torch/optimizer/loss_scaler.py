"""Dynamic loss scaling for float16 mixed precision (counterpart of
paddle_tpu/optimizer/loss_scaler.py). bfloat16 has float32's exponent
range and needs no scaling; this is for recipes that train in float16."""

from __future__ import annotations

import functools
from typing import Any, Tuple

import torch

from ..clip import tree_leaves, tree_map


class DynamicLossScaler:
    """Functional dynamic loss scaler.

    state = {"scale" (float32), "good_steps", "bad_steps" (int32)}, 0-dim
    tensors on the parameters' device; usage inside a train step:
        scaled_loss = scale_loss(loss, state)
        scaled_loss.backward()                  # scaled grads
        grads, state, is_finite = unscale_and_update(grads, state)
        # skip the optimizer apply when not is_finite

    The scale grows by ``incr_ratio`` after ``incr_every_n_steps`` finite
    steps in a row, shrinks by ``decr_ratio`` after
    ``decr_every_n_nan_or_inf`` non-finite ones, and stays in [1, 2^24].
    Nothing here reads back to the host."""

    def __init__(self, init_scale: float = 2.0 ** 15,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 1,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5):
        self.init_scale = init_scale
        self.incr_every_n_steps = incr_every_n_steps
        self.decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self.incr_ratio = incr_ratio
        self.decr_ratio = decr_ratio

    def init(self, device=None):
        def zero():
            return torch.zeros((), dtype=torch.int32, device=device)

        return {"scale": torch.tensor(self.init_scale, dtype=torch.float32,
                                      device=device),
                "good_steps": zero(), "bad_steps": zero()}

    def scale_loss(self, loss, state):
        return loss * state["scale"].to(loss.dtype)

    def unscale_and_update(self, grads: Any, state) -> Tuple[Any, dict, Any]:
        """(grads * (1 / scale), the next state, a 0-dim bool tensor: all
        unscaled grads finite)."""
        scale = state["scale"]
        inv = 1.0 / scale
        unscaled = tree_map(lambda g: g * inv.to(g.dtype), grads)
        is_finite = functools.reduce(
            torch.logical_and,
            [torch.isfinite(g).all() for g in tree_leaves(unscaled)],
            torch.ones((), dtype=torch.bool, device=scale.device))
        good = torch.where(is_finite, state["good_steps"] + 1, 0)
        bad = torch.where(is_finite, 0, state["bad_steps"] + 1)
        grow = good >= self.incr_every_n_steps
        shrink = bad >= self.decr_every_n_nan_or_inf
        new_scale = torch.where(
            is_finite,
            torch.where(grow, scale * self.incr_ratio, scale),
            torch.where(shrink, scale * self.decr_ratio, scale))
        new_state = {"scale": torch.clamp(new_scale, 1.0, 2.0 ** 24),
                     "good_steps": torch.where(grow, 0, good),
                     "bad_steps": torch.where(shrink, 0, bad)}
        return unscaled, new_state, is_finite
