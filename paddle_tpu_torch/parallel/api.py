"""The training driver (counterpart of paddle_tpu/parallel/api.py
``Trainer``), single device.

The JAX Trainer owns functional (params, buffers, opt_state) and a
jitted step. Here the model's own parameters are the state: a step runs
the loss builder, ``backward()``, and the optimizer's in-place update.
PyTorch runs eagerly, so there is nothing to compile; ``train_steps`` is
a Python loop.

The trainer keeps the JAX Trainer's key (threefry key data, uint32[2]):
a fresh trainer takes the next key of the global stream that ``seed``
sets (core/random.py), as the JAX Trainer does, and splits it once a
step as the JAX Trainer does; the step's generator is seeded from the
split-off key, so the key in a checkpoint fixes every later dropout
mask. ``state()`` has the
JAX Trainer's keys and on-disk dtypes, and ``restore_checkpoint`` copies
a checkpoint of either package into the live parameters and optimizer
state in place.

``amp=`` names a mixed-precision policy (core/dtypes.py) that the loss
builder runs under; ``backward()`` runs after the scope has closed, as
the JAX Trainer's gradient is taken outside its trace-time scope (the
model's remat recompute re-enters the policy itself). With a
``MixedPrecisionOptimizer`` (amp.decorate) the backward runs on the
scaled loss and the step returns the unscaled one. ``grad_accum_steps``
= k > 1 adds each micro-step's grads to an accumulator and applies the
optimizer to accumulator / k on the k-th."""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..amp import MixedPrecisionOptimizer
from ..core.config import BuildStrategy
from ..core.dtypes import POLICIES, policy_scope
from ..core.enforce import UnimplementedError, enforce
from ..core.random import (make_generator, next_key, rng_scope,
                           seed_generator, split_key)
from ..nn.layer import detach_buffers
from ..optimizer.optimizers import Optimizer

_MULTI_DEVICE = "is not ported yet: ROADMAP queue 1 item 11 (distributed)"


class Trainer:
    """Training driver.

    ``loss_builder(model, batch, generator) -> (loss, metrics)``: the
    PyTorch form of the JAX package's ``(params, buffers, rng, batch)``.
    ``generator`` is the trainer's ``torch.Generator`` (on the
    parameters' device, seeded each step from the trainer's key) in a
    training step and None in ``eval_step``; a training step also makes
    it the current generator (core/random.py ``rng_scope``), from which
    dropout draws.

    The trainable state is the model's parameters that require grad:
    all of them unless the caller froze some with
    ``requires_grad_(False)`` (LoRA fine-tuning freezes every parameter
    but the adapters, ``nn.lora_parameters``). A frozen parameter gets
    no gradient and no optimizer state, and is checkpointed with the
    buffers.

    ``build_strategy`` (core/config.py ``BuildStrategy``, default
    ``BuildStrategy()``) is kept as ``self.strategy``. On one device
    each field does what it does in the JAX Trainer on one device:
    ``donate_inputs`` lets the JAX step update its state in place, which
    the port's in-place updates always do, so it changes nothing here;
    the reduce, gradient-scale and fusion fields concern the all-reduce
    across devices, and ``remat_policy`` the JAX Trainer does not read.
    The multi-device arguments raise :class:`UnimplementedError` naming
    their ROADMAP item."""

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer,
                 loss_builder: Callable, mesh=None, build_strategy=None,
                 param_spec=None, opt_state_rules=None,
                 amp: Optional[str] = None, grad_accum_steps: int = 1,
                 plan=None, grad_compression: Optional[str] = None):
        for name, value in (("mesh", mesh), ("plan", plan),
                            ("param_spec", param_spec),
                            ("opt_state_rules", opt_state_rules),
                            ("grad_compression", grad_compression)):
            if value is not None:
                raise UnimplementedError(f"Trainer {name}= {_MULTI_DEVICE}")
        if isinstance(amp, str):
            enforce(amp in POLICIES, "unknown amp policy %s (one of %s)",
                    amp, sorted(POLICIES))
        enforce(grad_accum_steps >= 1, "grad_accum_steps must be >= 1")
        self.model = model
        self.optimizer = optimizer
        self.loss_builder = loss_builder
        self.strategy = build_strategy or BuildStrategy()
        self.amp_policy = amp
        self.grad_accum_steps = grad_accum_steps
        self.params: Dict[str, torch.nn.Parameter] = {
            name: p for name, p in model.named_parameters()
            if p.requires_grad}
        self.opt_state = optimizer.init(self.params)
        self.device = next(iter(self.params.values())).device
        self._generator = make_generator(0, self.device)
        self._key = next_key()
        if grad_accum_steps > 1:
            self._accum = {name: torch.zeros_like(p)
                           for name, p in self.params.items()}
            self._accum_count = 0

    def _scope(self):
        return (policy_scope(self.amp_policy) if self.amp_policy
                else contextlib.nullcontext())

    def train_step(self, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One micro-step: loss, backward, and the optimizer's update (on
        every k-th micro-step when accumulating). Returns the (unscaled)
        loss, detached, on the device (reading it syncs), and the
        metrics."""
        self._key, sub = split_key(self._key)
        return self._step(batch, sub)

    def _step(self, batch, sub) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One micro-step whose generator is seeded from the key ``sub``."""
        self.model.train()
        for p in self.params.values():
            p.grad = None
        seed_generator(self._generator, sub)
        with self._scope(), rng_scope(self._generator):
            loss, metrics = self.loss_builder(self.model, batch,
                                              self._generator)
        if isinstance(self.optimizer, MixedPrecisionOptimizer):
            self.optimizer.scale_loss(loss, self.opt_state).backward()
        else:
            loss.backward()
        detach_buffers(self.model)
        grads = {name: (p.grad if p.grad is not None
                        else torch.zeros_like(p))
                 for name, p in self.params.items()}
        k = self.grad_accum_steps
        if k == 1:
            self.optimizer.apply(self.params, grads, self.opt_state)
        else:
            with torch.no_grad():
                for name, g in grads.items():
                    self._accum[name].add_(g)
            self._accum_count += 1
            if self._accum_count >= k:
                mean = {name: a / k for name, a in self._accum.items()}
                self.optimizer.apply(self.params, mean, self.opt_state)
                for a in self._accum.values():
                    a.zero_()
                self._accum_count = 0
        return loss.detach(), _detach(metrics)

    def train_steps(self, batch, n: int):
        """``n`` updates on the same batch; returns the last step's
        (loss, metrics). Plain steps only: gradient accumulation goes
        through ``train_step``. The key evolves as the JAX Trainer's
        fused scan moves it: split once per call, the sub-key split ``n``
        ways, step i's generator seeded from the i-th, so a checkpoint
        saved after ``train_steps`` carries the JAX package's key."""
        enforce(self.grad_accum_steps == 1,
                "train_steps composes with plain steps only (use "
                "train_step for gradient merge)")
        enforce(n >= 1, "train_steps needs n >= 1, got %s", n)
        self._key, sub = split_key(self._key)
        for step_key in split_key(sub, n):
            out = self._step(batch, step_key)
        return out

    def eval_step(self, batch):
        """(loss, metrics) in eval mode, without gradients, under the
        trainer's policy."""
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad(), self._scope():
                return self.loss_builder(self.model, batch, None)
        finally:
            self.model.train(was_training)

    def sync_model(self) -> torch.nn.Module:
        """The model: its parameters are the trainer's state already."""
        return self.model

    # --- checkpoint/resume ---------------------------------------------------

    def _buffers(self) -> Dict[str, torch.Tensor]:
        """The model's persistent buffers and frozen parameters, by
        name."""
        params = set(self.params)
        return {n: t for n, t in self.model.state_dict(keep_vars=True).items()
                if n not in params}

    def state(self) -> Dict[str, Any]:
        """The whole resumable state with the JAX Trainer's keys:
        ``params``, ``buffers``, ``opt_state``, ``rng`` (the key data)
        and, when accumulating, ``grad_accum`` (``accum``, ``count``).
        The live tensors, except the step counts, which are Python ints
        in memory and 0-dim int32 tensors here, as the JAX package holds
        them."""
        st = {"params": self.params, "buffers": self._buffers(),
              "opt_state": _ints_to_int32(self.opt_state),
              "rng": self._key.copy()}
        if self.grad_accum_steps > 1:
            st["grad_accum"] = {
                "accum": self._accum,
                "count": torch.tensor(self._accum_count, dtype=torch.int32)}
        return st

    def save_checkpoint(self, manager_or_dir, step: Optional[int] = None):
        """Save ``state()`` into a CheckpointManager (``step`` needed) or
        a directory."""
        from ..checkpoint import CheckpointManager, save_state

        if isinstance(manager_or_dir, CheckpointManager):
            enforce(step is not None,
                    "save_checkpoint(manager) needs a step number")
            manager_or_dir.save(step, self.state())
        else:
            save_state(manager_or_dir, self.state())

    def restore_checkpoint(self, manager_or_dir,
                           step: Optional[int] = None) -> None:
        """Restore a checkpoint (of either package) in place: every
        leaf's shape and dtype is checked against ``state()``, and the
        tree against the live one, before anything is copied; then the
        values are copied into the existing parameters, buffers and
        optimizer tensors on the trainer's device, so the model and the
        optimizer keep their storage. A manager restores ``step``, or
        with None its newest committed step that verifies."""
        from ..checkpoint import CheckpointManager, _flatten, restore_state

        target = self.state()
        if isinstance(manager_or_dir, CheckpointManager):
            st = manager_or_dir.restore(step, target=target)
        else:
            st = restore_state(manager_or_dir, target=target)
        live = {"params": self.params, "buffers": target["buffers"],
                "opt_state": self.opt_state}
        if self.grad_accum_steps > 1 and "grad_accum" in st:
            live["grad_accum"] = {"accum": self._accum}
        saved = {k: st.get(k) for k in live}
        if "grad_accum" in live:
            saved["grad_accum"] = {"accum": st["grad_accum"]["accum"]}
        values = dict(_flatten(saved))
        slots = dict(_leaf_slots(live))
        enforce(values.keys() == slots.keys(),
                "checkpoint state does not match the trainer's: only in "
                "the checkpoint %s, only in the trainer %s",
                sorted(values.keys() - slots.keys()),
                sorted(slots.keys() - values.keys()))
        with torch.no_grad():
            for path, (box, key) in slots.items():
                if torch.is_tensor(box[key]):
                    box[key].copy_(values[path])
                else:
                    box[key] = int(values[path])
        if "grad_accum" in live:
            self._accum_count = int(st["grad_accum"]["count"])
        self._key = np.asarray(st["rng"], dtype=np.uint32).reshape(
            self._key.shape).copy()

    @classmethod
    def supervised(cls, model: torch.nn.Module, optimizer: Optimizer,
                   loss_fn: Callable, metrics_fn: Optional[Callable] = None,
                   mesh=None, aux_loss_weight: float = 0.0,
                   router_z_loss_weight: float = 0.0, **kw) -> "Trainer":
        """For (x, label) batches: ``dict(x=..., label=...)`` or a tuple
        ``(x, label)``; loss = ``loss_fn(model(x), label)``.
        ``aux_loss_weight`` and ``router_z_loss_weight`` add those
        multiples of the sum of every buffer named ``*aux_loss`` and
        ``*router_z_loss`` (the MoE terms a SwitchFFN records in its
        forward, nn/moe.py) to the training loss; ``eval_step`` reports
        the task loss alone, as in the JAX Trainer."""

        def loss_builder(model, batch, generator):
            if isinstance(batch, dict):
                x, label = batch["x"], batch["label"]
            else:
                x, label = batch
            out = model(x)
            loss = loss_fn(out, label)
            metrics = metrics_fn(out, label) if metrics_fn else {}
            if generator is not None:
                buffers = dict(model.named_buffers())
                for weight, suffix in ((aux_loss_weight, "aux_loss"),
                                       (router_z_loss_weight,
                                        "router_z_loss")):
                    if weight:
                        loss = loss + weight * sum(
                            v for k, v in buffers.items()
                            if k.endswith(suffix))
            return loss, metrics

        return cls(model, optimizer, loss_builder, mesh=mesh, **kw)


def _ints_to_int32(tree):
    """``tree`` with its Python int leaves as 0-dim int32 tensors."""
    if isinstance(tree, dict):
        return {k: _ints_to_int32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_ints_to_int32(v) for v in tree)
    if isinstance(tree, int) and not isinstance(tree, bool):
        return torch.tensor(tree, dtype=torch.int32)
    return tree


def _leaf_slots(tree, path=()):
    """[(path, (container, key))] of a live tree's leaves, by the
    checkpoint's '/'-joined paths, so each can be written in place."""
    out = []
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        p = path + (str(k),)
        if isinstance(v, (dict, list, tuple)):
            out += _leaf_slots(v, p)
        elif v is not None:
            out.append(("/".join(p), (tree, k)))
    return out


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach() if torch.is_tensor(tree) else tree
