"""The compression loop — Context / Strategy / Compressor / Config
(counterpart of paddle_tpu/slim/core.py).

Capability lineage (reference: python/paddle/fluid/contrib/slim/core/):
``compressor.py:207 Compressor`` runs an epoch loop firing strategy
callbacks (on_compression_begin, on_epoch_begin/end, on_compression_end),
checkpoints its Context between epochs (``:330/_load_checkpoint``,
``:381/_save_checkpoint``) and stops early on metric convergence
(``Context.eval_converged:144``); ``config.py`` builds strategies from a
config file; ``strategy.py:51`` scopes each strategy to
[start_epoch, end_epoch).

The Context carries the functional training state (a params dict, the
optimizer state of the port's functional API, masks); strategies rewrite
the loss or the mask set. The step takes the gradient of every entry of
the params dict (a zero one where the loss does not reach), applies the
optimizer, then re-applies the masks to the updated params (never to the
optimizer state). It runs on copies of the caller's tensors: nothing the
caller passed in changes, and no ``.grad`` is left on it. The teacher of
a distillation runs under ``torch.no_grad()``: its params get no
gradient and no optimizer state.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..core.enforce import enforce
from .distill import Distiller
from .prune import (Pruner, compute_sensitivities, greedy_ratios_for_target,
                    uniform_ratio_search)


def _restored(tree, device):
    """A restored tree on ``device``, its 0-dim integer tensors back to
    Python ints (the port's optimizer counts steps in ints)."""
    if isinstance(tree, dict):
        return {k: _restored(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_restored(v, device) for v in tree)
    if torch.is_tensor(tree):
        if tree.ndim == 0 and not tree.is_floating_point():
            return int(tree)
        return tree.to(device)
    return tree


def _device_of(params) -> torch.device:
    for v in (params or {}).values():
        if torch.is_tensor(v):
            return v.device
    return torch.device("cpu")


class Context:
    """Mutable compression state threaded through strategy callbacks."""

    def __init__(self, params, opt_state=None, eval_fn=None):
        self.epoch_id = 0
        self.params = params
        self.opt_state = opt_state
        self.eval_fn = eval_fn
        self.masks: Dict[str, torch.Tensor] = {}
        self.loss_wrapper: Optional[Callable] = None
        self.eval_history: List[float] = []
        self.extra: Dict[str, Any] = {}

    def eval_converged(self, delta: float = 0.001, window: int = 5) -> bool:
        """reference: compressor.py:144 — recent metric range < delta."""
        if len(self.eval_history) < window:
            return False
        recent = self.eval_history[-window:]
        return max(recent) - min(recent) < delta

    # -- persistence (reference: Context.to_file/from_file) -----------------

    def to_file(self, path: str) -> None:
        """The JAX package's layout: a checkpoint of params, opt_state and
        masks, and ``context.json`` with the epoch and eval history; a
        Context saved by either package restores in the other."""
        from .. import checkpoint
        from ..parallel.api import _ints_to_int32
        from ..utils.atomic import atomic_write_text

        # the optimizer's step count as the JAX package holds it
        checkpoint.save_state(path, {
            "params": self.params,
            "opt_state": _ints_to_int32(self.opt_state),
            "masks": self.masks,
        })
        atomic_write_text(
            os.path.join(path, "context.json"),
            json.dumps({"epoch_id": self.epoch_id,
                        "eval_history": self.eval_history}))

    def from_file(self, path: str) -> None:
        """Restore onto the device the Context's params are on (the CPU
        when it has none)."""
        from .. import checkpoint

        device = _device_of(self.params)
        state = _restored(checkpoint.restore_state(path), device)
        self.params = state["params"]
        self.opt_state = state["opt_state"]
        self.masks = state.get("masks") or {}
        with open(os.path.join(path, "context.json")) as f:
            meta = json.load(f)
        self.epoch_id = meta["epoch_id"]
        self.eval_history = list(meta["eval_history"])


class Strategy:
    """reference: core/strategy.py:51 — epoch-scoped callbacks."""

    def __init__(self, start_epoch: int = 0, end_epoch: int = 10 ** 9):
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch

    def active(self, epoch: int) -> bool:
        return self.start_epoch <= epoch < self.end_epoch

    def on_compression_begin(self, context: Context):  # noqa: B027
        pass

    def on_epoch_begin(self, context: Context):  # noqa: B027
        pass

    def on_epoch_end(self, context: Context):  # noqa: B027
        pass

    def on_compression_end(self, context: Context):  # noqa: B027
        pass


class UniformPruneStrategy(Strategy):
    """One ratio for every matched param, bisected to hit
    ``target_ratio`` global sparsity (reference:
    prune_strategy.py:531 UniformPruneStrategy)."""

    def __init__(self, target_ratio: float, structured: bool = False,
                 axis: int = 0, match=None, **kw):
        super().__init__(**kw)
        self.target_ratio = target_ratio
        self.pruner_proto = Pruner(target_ratio, structured=structured,
                                   axis=axis, match=match)

    def on_epoch_begin(self, context: Context):
        if context.epoch_id != self.start_epoch:
            return
        ratio = uniform_ratio_search(context.params, self.pruner_proto,
                                     self.target_ratio)
        pruner = Pruner(ratio, structured=self.pruner_proto.structured,
                        axis=self.pruner_proto.axis,
                        match=self.pruner_proto.match)
        context.masks = pruner.make_masks(context.params)
        context.params = Pruner.apply(context.params, context.masks)


class SensitivePruneStrategy(Strategy):
    """Per-param ratios from sensitivity analysis (reference:
    prune_strategy.py:635 SensitivePruneStrategy): prune each candidate
    at several ratios, measure the eval-metric drop, then greedily hit
    ``target_ratio`` where metric loss is cheapest; sensitivities persist
    to ``sensitivities_file``."""

    def __init__(self, target_ratio: float,
                 ratios: Sequence[float] = (0.1, 0.3, 0.5, 0.7),
                 sensitivities_file: Optional[str] = None,
                 max_metric_loss: Optional[float] = None,
                 structured: bool = False, axis: int = 0, match=None, **kw):
        super().__init__(**kw)
        self.target_ratio = target_ratio
        self.ratios = tuple(ratios)
        self.sensitivities_file = sensitivities_file
        self.max_metric_loss = max_metric_loss
        self.pruner_proto = Pruner(target_ratio, structured=structured,
                                   axis=axis, match=match)

    def on_epoch_begin(self, context: Context):
        if context.epoch_id != self.start_epoch:
            return
        enforce(context.eval_fn is not None,
                "SensitivePruneStrategy needs the Compressor's eval_fn")
        sens = compute_sensitivities(
            context.params, context.eval_fn, self.pruner_proto,
            self.ratios, self.sensitivities_file)
        per_param = greedy_ratios_for_target(
            sens, context.params, self.target_ratio,
            self.max_metric_loss)
        pruner = Pruner(per_param,
                        structured=self.pruner_proto.structured,
                        axis=self.pruner_proto.axis,
                        match=lambda n: n in per_param)
        context.masks = pruner.make_masks(context.params)
        context.params = Pruner.apply(context.params, context.masks)
        context.extra["prune_ratios"] = per_param


class DistillationStrategy(Strategy):
    """Swap the task loss for the distilled loss while active
    (reference: distillation/distillation_strategy.py merges the teacher
    program in on_compression_begin; here the teacher is a params dict +
    apply_fn and the swap is a loss_wrapper on the Context). The teacher
    runs under ``torch.no_grad()``."""

    def __init__(self, teacher_apply: Callable, teacher_params,
                 distiller: Optional[Distiller] = None, **kw):
        super().__init__(**kw)
        self.teacher_apply = teacher_apply
        self.teacher_params = teacher_params
        self.distiller = distiller or Distiller()

        # ONE wrapper object for the whole run: the Compressor's step
        # cache is keyed by identity. The closure reads through self, so
        # reassigning strategy attributes before run() still takes effect
        def wrap(loss_fn, _self=self):
            def distilled(params, *batch):
                d = _self.distiller
                student_logits = loss_fn(params, *batch, logits_only=True)
                with torch.no_grad():
                    teacher_logits = _self.teacher_apply(
                        _self.teacher_params, *batch)
                label = batch[-1] if d.hard_weight else None
                return d.loss(student_logits, teacher_logits, label)

            return distilled

        self._wrap = wrap

    def on_epoch_begin(self, context: Context):
        if context.loss_wrapper is not self._wrap:
            context.loss_wrapper = self._wrap

    def on_epoch_end(self, context: Context):
        if context.epoch_id + 1 >= self.end_epoch:
            context.loss_wrapper = None


class Compressor:
    """Epoch-driven compression loop (reference: compressor.py:207).

    - ``params``: a dict of tensors by name; the Compressor trains copies.
    - ``loss_fn(params, *batch, logits_only=False)`` — the task loss;
      with ``logits_only=True`` it must return the student logits (the
      hook distillation uses).
    - ``train_reader()`` / ``eval_fn(params)`` — batches and the scalar
      quality metric (higher is better).
    - ``optimizer``: the port's functional API (``init``, ``apply``).
    - Masks in the Context are applied to the params after every update,
      so sparsity persists through training.
    - ``checkpoint_dir`` saves the Context each epoch and resumes
      automatically (reference: _save_checkpoint/_load_checkpoint).
    """

    def __init__(self, params, optimizer, loss_fn, train_reader,
                 eval_fn=None, epochs: int = 1, strategies=(),
                 checkpoint_dir: Optional[str] = None,
                 converge_delta: Optional[float] = None):
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.train_reader = train_reader
        self.epochs = epochs
        self.strategies = list(strategies)
        self.checkpoint_dir = checkpoint_dir
        self.converge_delta = converge_delta
        # the optimizer updates in place: train on copies
        params = {k: v.detach().clone() for k, v in params.items()}
        self.context = Context(params, optimizer.init(params), eval_fn)
        self._step_cache = (None, None)

    def _step_fn(self):
        ctx = self.context
        # strategies swap masks/loss_wrapper by REASSIGNING them at epoch
        # boundaries; while identities are unchanged the cached step
        # stays valid
        key = (id(ctx.masks), id(ctx.loss_wrapper))
        if self._step_cache[0] == key:
            return self._step_cache[1]
        loss_fn = self.loss_fn
        if ctx.loss_wrapper is not None:
            loss_fn = ctx.loss_wrapper(self.loss_fn)
        masks = dict(ctx.masks)
        # the gradient of every entry (zero where the loss does not
        # reach), then opt.apply, in place
        update = self.optimizer.minimize_fn(loss_fn)

        def step(params, opt_state, *batch):
            loss, new_p, new_s = update(params, opt_state, *batch)
            # the JAX package's jitted step returns the dict rebuilt in
            # sorted-key order (pytree flattening); later dict-order ties
            # (sensitivities, greedy ratios, mask order) follow it
            new_p = {k: new_p[k] for k in sorted(new_p)}
            if masks:
                with torch.no_grad():
                    for n, m in masks.items():
                        if n in new_p:
                            new_p[n].mul_(m)
            return loss, new_p, new_s

        self._step_cache = (key, step)
        return step

    def run(self):
        ctx = self.context
        if self.checkpoint_dir and os.path.exists(
                os.path.join(self.checkpoint_dir, "context.json")):
            ctx.from_file(self.checkpoint_dir)
        for s in self.strategies:
            s.on_compression_begin(ctx)
        while ctx.epoch_id < self.epochs:
            active = [s for s in self.strategies
                      if s.active(ctx.epoch_id)]
            for s in active:
                s.on_epoch_begin(ctx)
            step = self._step_fn()  # masks/loss may have changed
            for batch in self.train_reader():
                _, ctx.params, ctx.opt_state = step(
                    ctx.params, ctx.opt_state, *batch)
            for s in active:
                s.on_epoch_end(ctx)
            if ctx.eval_fn is not None:
                ctx.eval_history.append(float(ctx.eval_fn(ctx.params)))
            ctx.epoch_id += 1
            if self.checkpoint_dir:
                ctx.to_file(self.checkpoint_dir)
            if (self.converge_delta is not None
                    and ctx.eval_converged(self.converge_delta)):
                break
        for s in self.strategies:
            s.on_compression_end(ctx)
        return ctx


_STRATEGY_KINDS = {
    "uniform_prune": UniformPruneStrategy,
    "sensitive_prune": SensitivePruneStrategy,
    "distillation": DistillationStrategy,
}


def build_strategies(config) -> List[Strategy]:
    """Config factory (reference: core/config.py ConfigFactory — yaml
    there, a dict or JSON file path here): ``{"strategies": [{"kind":
    "uniform_prune", "target_ratio": 0.5, "start_epoch": 1}, ...]}``."""
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    enforce("strategies" in config,
            "compression config needs a 'strategies' list (got keys %s) — "
            "e.g. {'strategies': [{'kind': 'uniform_prune', "
            "'target_ratio': 0.5}]}", sorted(config))
    out = []
    for spec in config["strategies"]:
        spec = dict(spec)
        kind = spec.pop("kind")
        enforce(kind in _STRATEGY_KINDS,
                "unknown strategy kind %r (have: %s)", kind,
                sorted(_STRATEGY_KINDS))
        out.append(_STRATEGY_KINDS[kind](**spec))
    return out
