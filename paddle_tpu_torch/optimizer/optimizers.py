"""Optimizers (counterpart of paddle_tpu/optimizer/optimizers.py): the
Optimizer base with SGD, Adam and AdamW, with the JAX package's update
formulas.

The JAX package returns new parameters and a new state from ``apply``.
Here ``apply`` updates the parameters and the state IN PLACE under
``torch.no_grad()`` and returns the same objects, so the call shape
stays ``params, state = opt.apply(params, grads, state)``. Parameters
and grads are trees of tensors (a dict, list or tuple); the per-leaf
state follows the leaf order of ``params``."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..clip import tree_leaves
from ..core.enforce import enforce
from .lr_scheduler import make_schedule


class Optimizer:
    """Base — apply = schedule, then ``grad_clip`` on the raw grads, then
    the ``regularization`` term, then the per-leaf rule (the reference
    order of optimizer.py apply_gradients)."""

    def __init__(self, learning_rate=0.01, grad_clip=None,
                 regularization=None):
        self.schedule = make_schedule(learning_rate)
        self.grad_clip = grad_clip
        self.regularization = regularization

    # --- per-leaf rule (override these two) --------------------------------

    def init_leaf(self, p) -> Dict[str, Any]:
        return {}

    def update_leaf(self, p, g, s: Dict[str, Any], lr, step):
        """Update ``p`` and ``s`` in place; ``lr`` a 0-dim float32 CPU
        tensor, ``step`` the int count of earlier updates."""
        raise NotImplementedError

    # --- tree lifting -------------------------------------------------------

    def init(self, params) -> Dict[str, Any]:
        return {"step": 0,
                "leaf": [self.init_leaf(p) for p in tree_leaves(params)]}

    def apply(self, params, grads, state: Dict[str, Any]) -> Tuple[Any, Any]:
        """One update of ``params`` from ``grads``, in place."""
        step = state["step"]
        lr = self.schedule(step)
        if self.grad_clip is not None:
            grads = self.grad_clip(grads)
        if self.regularization is not None:
            grads = self.regularization.apply_to_grads(params, grads)
        leaves_p, leaves_g = tree_leaves(params), tree_leaves(grads)
        enforce(len(state["leaf"]) == len(leaves_p) == len(leaves_g),
                "optimizer state has %s leaves, params %s, grads %s — "
                "init() with the same structure", len(state["leaf"]),
                len(leaves_p), len(leaves_g))
        with torch.no_grad():
            for p, g, s in zip(leaves_p, leaves_g, state["leaf"]):
                self.update_leaf(p, g, s, lr, step)
        state["step"] = step + 1
        return params, state

    def current_lr(self, state) -> torch.Tensor:
        return self.schedule(state["step"])


class SGD(Optimizer):
    """reference: optimizers/sgd_op.cc."""

    def update_leaf(self, p, g, s, lr, step):
        p.sub_(lr.to(p.dtype) * g.to(p.dtype))


class Adam(Optimizer):
    """reference: optimizers/adam_op.cc. The bias corrections use t =
    step + 1 in float32, and epsilon is added outside sqrt(vhat).
    ``lazy_mode`` (update only the rows a sparse gradient touches) has
    no effect on dense gradients, the only kind the port's optimizers
    take, as in the JAX package's dense path."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 lazy_mode: bool = False, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_mode = lazy_mode

    def init_leaf(self, p):
        return {"m": torch.zeros_like(p), "v": torch.zeros_like(p)}

    def update_leaf(self, p, g, s, lr, step):
        g = g.to(p.dtype)
        t = torch.tensor(step + 1, dtype=torch.float32)
        m, v = s["m"], s["v"]
        m.mul_(self.beta1).add_((1 - self.beta1) * g)
        v.mul_(self.beta2).add_((1 - self.beta2) * torch.square(g))
        bc1 = 1 - torch.pow(torch.tensor(self.beta1, dtype=torch.float32), t)
        bc2 = 1 - torch.pow(torch.tensor(self.beta2, dtype=torch.float32), t)
        mhat = m / bc1.to(p.dtype)
        vhat = v / bc2.to(p.dtype)
        p.sub_(lr.to(p.dtype) * mhat / (torch.sqrt(vhat) + self.epsilon))


class AdamW(Adam):
    """Adam with decoupled weight decay of the pre-update parameter."""

    def __init__(self, learning_rate=0.001, weight_decay: float = 0.01,
                 **kw):
        super().__init__(learning_rate, **kw)
        self.weight_decay = weight_decay

    def update_leaf(self, p, g, s, lr, step):
        decay = lr.to(p.dtype) * self.weight_decay * p
        super().update_leaf(p, g, s, lr, step)
        p.sub_(decay)
