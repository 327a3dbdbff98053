"""Optimizers (counterpart of paddle_tpu/optimizer/optimizers.py): the
Optimizer base and its fourteen rules (SGD, Momentum, LarsMomentum,
Adam, AdamW, Adamax, Adagrad, DecayedAdagrad, Adadelta, RMSProp, Ftrl,
Lamb, ProximalGD, ProximalAdagrad) and ExponentialMovingAverage, with
the JAX package's update formulas and state keys.

The JAX package returns new parameters and a new state from ``apply``.
Here ``apply`` updates the parameters and the state IN PLACE under
``torch.no_grad()`` and returns the same objects, so the call shape
stays ``params, state = opt.apply(params, grads, state)``. Parameters
and grads are trees of tensors (a dict, list or tuple); the per-leaf
state follows the leaf order of ``params``, which is the JAX package's
(clip.py ``tree_leaves``: a dict in sorted-key order), so a state moves
between the packages leaf for leaf.

Sharded leaves (parallel/sharding.py). A sharding plan's placed
parameter is the rank's shard: its moments are born as shards of the
same spec, the update is the rule's on the shard, and the norms that
LarsMomentum and Lamb take are summed over the ranks that hold the
other shards. Where the moments alone are placed (``OptStateRules``,
ZeRO-1: the parameter replicated), each rank updates its slice of the
parameter with its moments, and the slices are all-gathered over the
moments' axes; the step counter stays replicated. Both live here, where
``update_leaf`` is called, not in each rule."""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Tuple

import torch

from ..clip import sq_sum, tree_leaves, tree_map
from ..core.enforce import UnimplementedError, enforce
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
        leaves = []
        for p in tree_leaves(params):
            s = self.init_leaf(p)
            if getattr(p, "_pt_sharding", None) is not None:
                from ..parallel.sharding import mark

                for t in s.values():
                    if torch.is_tensor(t) and t.shape == p.shape:
                        mark(t, p._pt_sharding, p._pt_global_shape)
            leaves.append(s)
        return {"step": 0, "leaf": leaves}

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
                zero = _zero_sharding(p, s)
                if zero is None:
                    with _leaf(getattr(p, "_pt_sharding", None)):
                        self.update_leaf(p, g, s, lr, step)
                    continue
                # ZeRO-1: this rank's slice (a view of p), then every
                # rank's slices gathered into the whole parameter
                idx = zero.index(p.shape)
                mine = p[idx]
                with _leaf(zero):
                    self.update_leaf(mine, g[idx], s, lr, step)
                p.copy_(_gather(mine.clone(), zero))
        state["step"] = step + 1
        return params, state

    # --- high-level UX ------------------------------------------------------

    def minimize_fn(self, loss_fn: Callable) -> Callable:
        """``step_fn(params, state, *args, **kwargs) -> (loss, params,
        state)`` (Optimizer.minimize analog): the gradient of
        ``loss_fn(params, *args, **kwargs)`` with respect to each tensor
        of the dict ``params``, then ``apply``, which updates them and
        ``state`` in place; the loss comes back detached."""

        def step_fn(params, state, *args, **kwargs):
            # leaves that alias the caller's tensors, for the gradient
            leaves = {k: v.detach().requires_grad_()
                      for k, v in params.items()}
            loss = loss_fn(leaves, *args, **kwargs)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
            grads = {k: (g if g is not None else torch.zeros_like(v))
                     for (k, v), g in zip(params.items(), grads)}
            self.apply(params, grads, state)
            return loss.detach(), params, state

        return step_fn

    def current_lr(self, state) -> torch.Tensor:
        return self.schedule(state["step"])

    # --- static-graph (fluid) entry points ---------------------------------

    def apply_gradients(self, params_grads):
        """The JAX package records update ops into a static ``Program``
        here; the port has no Program yet."""
        raise UnimplementedError(
            "Optimizer.apply_gradients records into a static Program "
            "(static/), which is not ported yet: ROADMAP queue 1 item 12")

    def apply_optimize(self, loss, startup_program=None, params_grads=None):
        return self.apply_gradients(params_grads)


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


_leaf_sharding = None


@contextlib.contextmanager
def _leaf(sharding):
    """The sharding of the leaf being updated (None: whole), which
    :func:`_norm` sums over."""
    global _leaf_sharding
    prev, _leaf_sharding = _leaf_sharding, sharding
    try:
        yield
    finally:
        _leaf_sharding = prev


def _norm(x) -> torch.Tensor:
    """The L2 norm of the leaf of which ``x`` is this rank's part."""
    return torch.sqrt(sq_sum(x, _leaf_sharding))


def _zero_sharding(p, s):
    """The sharding of ``p``'s placed moments where ``p`` itself is whole
    (ZeRO-1), else None."""
    if getattr(p, "_pt_sharding", None) is not None:
        return None
    for t in s.values():
        sh = getattr(t, "_pt_sharding", None)
        if sh is not None:
            return sh
    return None


def _gather(x, sharding):
    """The whole tensor of the shards ``x`` (this rank's) under
    ``sharding``: all-gathered dim by dim."""
    from ..parallel.collective import allgather

    for dim, part in enumerate(sharding.spec):
        if part is not None:
            x = allgather(x, part, dim=dim, mesh=sharding.mesh)
    return x


class SGD(Optimizer):
    """reference: optimizers/sgd_op.cc."""

    def update_leaf(self, p, g, s, lr, step):
        p.sub_(lr.to(p.dtype) * g.to(p.dtype))


class Momentum(Optimizer):
    """reference: optimizers/momentum_op.cc (with use_nesterov)."""

    def __init__(self, learning_rate=0.01, momentum: float = 0.9,
                 use_nesterov: bool = False, **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def init_leaf(self, p):
        return {"velocity": torch.zeros_like(p)}

    def update_leaf(self, p, g, s, lr, step):
        g, lr = g.to(p.dtype), lr.to(p.dtype)
        v = s["velocity"].mul_(self.momentum).add_(g)
        if self.use_nesterov:
            p.sub_((g + self.momentum * v) * lr)
        else:
            p.sub_(lr * v)


class LarsMomentum(Optimizer):
    """reference: optimizers/lars_momentum_op.cc — layer-adaptive lr."""

    def __init__(self, learning_rate=0.01, momentum: float = 0.9,
                 lars_coeff: float = 1e-3, lars_weight_decay: float = 5e-4,
                 **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = momentum
        self.lars_coeff = lars_coeff
        self.lars_weight_decay = lars_weight_decay

    def init_leaf(self, p):
        return {"velocity": torch.zeros_like(p)}

    def update_leaf(self, p, g, s, lr, step):
        g, lr = g.to(p.dtype), lr.to(p.device, p.dtype)
        p_norm, g_norm = _norm(p), _norm(g)
        local_lr = lr * self.lars_coeff * p_norm / (
            g_norm + self.lars_weight_decay * p_norm + 1e-12)
        local_lr = torch.where(p_norm > 0, local_lr, lr)
        v = s["velocity"].mul_(self.momentum).add_(
            local_lr * (g + self.lars_weight_decay * p))
        p.sub_(v)


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


class Adamax(Optimizer):
    """reference: optimizers/adamax_op.cc."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_leaf(self, p):
        return {"m": torch.zeros_like(p), "inf": torch.zeros_like(p)}

    def update_leaf(self, p, g, s, lr, step):
        g = g.to(p.dtype)
        t = _f32(step + 1)
        m = s["m"].mul_(self.beta1).add_((1 - self.beta1) * g)
        inf = s["inf"]
        torch.maximum(inf.mul_(self.beta2), torch.abs(g), out=inf)
        lr_t = (lr / (1 - torch.pow(_f32(self.beta1), t))).to(p.dtype)
        p.sub_(lr_t * m / (inf + self.epsilon))


class Adagrad(Optimizer):
    """reference: optimizers/adagrad_op.cc."""

    def __init__(self, learning_rate=0.01, epsilon: float = 1e-6,
                 initial_accumulator_value: float = 0.0, **kw):
        super().__init__(learning_rate, **kw)
        self.epsilon = epsilon
        self.init_acc = initial_accumulator_value

    def init_leaf(self, p):
        return {"moment": torch.full_like(p, self.init_acc)}

    def update_leaf(self, p, g, s, lr, step):
        g = g.to(p.dtype)
        moment = s["moment"].add_(torch.square(g))
        p.sub_(lr.to(p.dtype) * g / (torch.sqrt(moment) + self.epsilon))


class DecayedAdagrad(Optimizer):
    """reference: optimizers/decayed_adagrad_op.cc."""

    def __init__(self, learning_rate=0.01, decay: float = 0.95,
                 epsilon: float = 1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.decay, self.epsilon = decay, epsilon

    def init_leaf(self, p):
        return {"moment": torch.zeros_like(p)}

    def update_leaf(self, p, g, s, lr, step):
        g = g.to(p.dtype)
        moment = s["moment"].mul_(self.decay).add_(
            (1 - self.decay) * torch.square(g))
        p.sub_(lr.to(p.dtype) * g / (torch.sqrt(moment) + self.epsilon))


class Adadelta(Optimizer):
    """reference: optimizers/adadelta_op.cc."""

    def __init__(self, learning_rate=1.0, rho: float = 0.95,
                 epsilon: float = 1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.rho, self.epsilon = rho, epsilon

    def init_leaf(self, p):
        return {"avg_sq_grad": torch.zeros_like(p),
                "avg_sq_update": torch.zeros_like(p)}

    def update_leaf(self, p, g, s, lr, step):
        g = g.to(p.dtype)
        asg = s["avg_sq_grad"].mul_(self.rho).add_(
            (1 - self.rho) * torch.square(g))
        asu = s["avg_sq_update"]
        update = g * torch.sqrt(asu + self.epsilon) / torch.sqrt(
            asg + self.epsilon)
        asu.mul_(self.rho).add_((1 - self.rho) * torch.square(update))
        p.sub_(lr.to(p.dtype) * update)


class RMSProp(Optimizer):
    """reference: optimizers/rmsprop_op.cc (with the centered variant)."""

    def __init__(self, learning_rate=0.01, rho: float = 0.95,
                 epsilon: float = 1e-6, momentum: float = 0.0,
                 centered: bool = False, **kw):
        super().__init__(learning_rate, **kw)
        self.rho, self.epsilon = rho, epsilon
        self.momentum, self.centered = momentum, centered

    def init_leaf(self, p):
        s = {"mean_square": torch.zeros_like(p),
             "moment": torch.zeros_like(p)}
        if self.centered:
            s["mean_grad"] = torch.zeros_like(p)
        return s

    def update_leaf(self, p, g, s, lr, step):
        g = g.to(p.dtype)
        ms = s["mean_square"].mul_(self.rho).add_(
            (1 - self.rho) * torch.square(g))
        if self.centered:
            mg = s["mean_grad"].mul_(self.rho).add_((1 - self.rho) * g)
            denom = torch.sqrt(ms - torch.square(mg) + self.epsilon)
        else:
            denom = torch.sqrt(ms + self.epsilon)
        mom = s["moment"].mul_(self.momentum).add_(
            lr.to(p.dtype) * g / denom)
        p.sub_(mom)


class Ftrl(Optimizer):
    """reference: optimizers/ftrl_op.cc."""

    def __init__(self, learning_rate=0.01, l1: float = 0.0, l2: float = 0.0,
                 lr_power: float = -0.5, **kw):
        super().__init__(learning_rate, **kw)
        self.l1, self.l2, self.lr_power = l1, l2, lr_power

    def init_leaf(self, p):
        return {"squared": torch.zeros_like(p), "linear": torch.zeros_like(p)}

    def _pow(self, x):
        return torch.sqrt(x) if self.lr_power == -0.5 else x ** -self.lr_power

    def update_leaf(self, p, g, s, lr, step):
        g, lr = g.to(p.dtype), lr.to(p.dtype)
        sq = s["squared"]
        new_sq = sq + torch.square(g)
        sigma = (self._pow(new_sq) - self._pow(sq)) / lr
        linear = s["linear"].add_(g).sub_(sigma * p)
        denom = self._pow(new_sq) / lr + 2 * self.l2
        pre = (torch.sign(linear) * self.l1 - linear) / denom
        p.copy_(torch.where(torch.abs(linear) > self.l1, pre,
                            torch.zeros_like(p)))
        sq.copy_(new_sq)


class Lamb(Optimizer):
    """LAMB: Adam's step scaled per tensor by |w| / |update|."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-6,
                 weight_decay: float = 0.01, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon, self.weight_decay = epsilon, weight_decay

    def init_leaf(self, p):
        return {"m": torch.zeros_like(p), "v": torch.zeros_like(p)}

    def update_leaf(self, p, g, s, lr, step):
        g = g.to(p.dtype)
        t = _f32(step + 1)
        m = s["m"].mul_(self.beta1).add_((1 - self.beta1) * g)
        v = s["v"].mul_(self.beta2).add_((1 - self.beta2) * torch.square(g))
        mhat = m / (1 - torch.pow(_f32(self.beta1), t)).to(p.dtype)
        vhat = v / (1 - torch.pow(_f32(self.beta2), t)).to(p.dtype)
        update = (mhat / (torch.sqrt(vhat) + self.epsilon)
                  + self.weight_decay * p)
        w_norm, u_norm = _norm(p), _norm(update)
        ratio = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            1.0)
        p.sub_(lr.to(p.dtype) * ratio * update)


def _prox(p, prox, lr, l1, l2):
    """p <- the L1/L2 proximal projection of ``prox`` at step ``lr``."""
    if l1 > 0:
        prox = torch.sign(prox) * torch.clamp(torch.abs(prox) - lr * l1,
                                              min=0.0)
    p.copy_(prox / (1.0 + lr * l2))


class ProximalGD(Optimizer):
    """reference: optimizers/proximal_gd_op.cc — SGD with the L1/L2
    proximal projection: w = prox(w - lr*g)."""

    def __init__(self, learning_rate, l1: float = 0.0, l2: float = 0.0,
                 **kw):
        super().__init__(learning_rate, **kw)
        self.l1, self.l2 = l1, l2

    def update_leaf(self, p, g, s, lr, step):
        _prox(p, p - lr * g, lr, self.l1, self.l2)


class ProximalAdagrad(Optimizer):
    """reference: optimizers/proximal_adagrad_op.cc — an Adagrad step with
    the same projection at the adaptive lr."""

    def __init__(self, learning_rate, l1: float = 0.0, l2: float = 0.0,
                 epsilon: float = 1e-10, **kw):
        super().__init__(learning_rate, **kw)
        self.l1, self.l2, self.epsilon = l1, l2, epsilon

    def init_leaf(self, p):
        return {"moment": torch.zeros_like(p)}

    def update_leaf(self, p, g, s, lr, step):
        moment = s["moment"].add_(g * g)
        alr = lr / (torch.sqrt(moment) + self.epsilon)
        _prox(p, p - alr * g, alr, self.l1, self.l2)


class ExponentialMovingAverage:
    """Parameter EMA (reference: operators/average_accumulates_op.cc):
    shadow = decay * shadow + (1 - decay) * param, with bias correction.
    ``update`` moves the shadow tree in place and returns the state; the
    count is a Python int in memory (a 0-dim int32 on disk, as the JAX
    package's)."""

    def __init__(self, decay: float = 0.999):
        self.decay = decay

    def init(self, params):
        with torch.no_grad():
            return {"shadow": tree_map(torch.zeros_like, params),
                    "count": 0}

    def update(self, params, state):
        with torch.no_grad():
            for s, p in zip(tree_leaves(state["shadow"]),
                            tree_leaves(params)):
                s.mul_(self.decay).add_((1.0 - self.decay) * p)
        state["count"] = int(state["count"]) + 1
        return state

    def average(self, state):
        """The bias-corrected EMA parameters (new tensors)."""
        corr = 1.0 - torch.pow(_f32(self.decay), _f32(int(state["count"])))
        corr = torch.clamp(corr, min=1e-12)
        with torch.no_grad():
            return tree_map(lambda s: s / corr.to(s.dtype), state["shadow"])
