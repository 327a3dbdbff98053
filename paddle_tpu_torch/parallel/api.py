"""The training driver (counterpart of paddle_tpu/parallel/api.py
``Trainer`` and ``DataParallel``).

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
optimizer to accumulator / k on the k-th.

``mesh=`` (core/mesh.py) trains data- and sequence-parallel, one process
per rank: the parameters are replicated (every rank builds them from the
same key of the global stream, so nothing is broadcast), each step takes
the rank's batch (``data_sharding()``: the batch split over ``dp``, the
full sequence), and the gradients are averaged over the mesh's data
axes (``Mesh.data_axes``: ``dp`` and ``sp``) before the update. The JAX
Trainer without a plan takes the gradient of the loss of the global
batch (GSPMD), so a rank's loss must be that global loss, or an equal
share of it: the models' losses divide the sum of their token losses by
the count of valid tokens, each summed over the data axes
(parallel/context_parallel.py ``token_mean``), ``supervised`` gathers
the outputs and labels over the batch axes before its ``loss_fn``,
BatchNorm takes the global batch's statistics and a Switch-MoE FFN
routes the global batch's tokens (nn/layers.py, nn/moe.py). Such a
loss's gradient on a rank is the data axes' size times the rank's share
(its collectives differentiate as JAX transposes them), and the mean of
the ranks' gradients is the global gradient; never a mean of the ranks'
own means, which differs wherever ranks count different numbers of
tokens. The step returns the global loss. Each step's key has the rank's
data-axis coordinates folded in (``core.random.fold_in``, as JAX's
``_shard_rng``), so dp and sp ranks draw different dropout masks; ``tp``
and ``ep`` ranks, which hold the same rows, draw the same ones.

``plan=`` (parallel/plan.py) places the state sharded by construction:
each parameter and moment, and each buffer a rule names, is cut to the
rank's shard under its resolved spec, the layers gather at use or
compute on their shard (parallel/sharding.py), and a leaf's gradient is
summed over the data axes its spec does not split (the gather's
backward summed it over those it does) and divided by their size.
``param_spec=`` places named parameters on ``mesh`` the same way;
``opt_state_rules=`` places the moments alone (ZeRO-1,
optimizer/optimizers.py). A pure data-parallel plan runs the JAX
package's ``shard_map`` regime: each rank's loss and batch statistics
are its rows' (``core.mesh.local_batch``), and the
loss, the gradients, the metrics and the buffers are averaged over the
batch axes.

``grad_compression=`` ("int8" or "int8_sr"; the plan's value when None)
compresses the gradient all-reduce at the one reduce boundary every step
variant shares (``train_step``, the ``grad_accum_steps`` micro-steps and
``train_steps``), as the JAX Trainer's ``_reduce_grads``: a pure
data-parallel plan over one batch axis reduces through the int8 ring
(quant/collectives.py ``quantized_pmean_tree``), a reduce over more than
one axis falls back to the plain mean, and fsdp/tp plans round-trip the
reduced gradients through the int8 wire format (``compress_grads``).
``"int8_sr"`` rounds stochastically from the step's key folded with
0x51C8. With it off no code of quant/collectives.py runs. Under a pure
data-parallel plan the per-step payload bytes are computed once and
added to ``pt_collective_bytes_total`` per dispatched step (telemetry
on).

A mesh with a ``pp`` axis of more than one rank trains as the JAX
Trainer does on such a mesh without a pipeline: the batch is cut over
``dp`` only, the pp ranks hold replicas, compute the same step and
reduce nothing over ``pp`` (pipelines: parallel/pipeline.py and
hybrid.py)."""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..amp import MixedPrecisionOptimizer
from ..core.config import BuildStrategy
from ..core.dtypes import POLICIES, policy_scope
from ..core.enforce import InvalidArgumentError, enforce
from ..core.mesh import (Mesh, PartitionSpec, get_mesh, mesh_scope,
                         reduce_axes, sharding)
from ..core.random import (fold_in, make_generator, next_key, rng_scope,
                           seed_generator, split_key)
from ..core.sharding_types import NamedSharding
from ..nn.layer import detach_buffers
from ..optimizer.optimizers import Optimizer
from . import sharding as S
from .collective import sum_over
from .plan import Plan, plan_step, pmean_axes


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
    ``mesh``: train over its ``dp`` and ``sp`` ranks (see the module
    docstring); ``plan``, ``param_spec`` and ``opt_state_rules`` place
    the state sharded (a plan subsumes the other two and owns its
    mesh). An argument of another type raises
    :class:`InvalidArgumentError`. ``grad_compression`` (None, "int8" or
    "int8_sr") beats the plan's and needs a plan over more than one
    device (the module docstring)."""

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer,
                 loss_builder: Callable, mesh=None, build_strategy=None,
                 param_spec=None, opt_state_rules=None,
                 amp: Optional[str] = None, grad_accum_steps: int = 1,
                 plan=None, grad_compression: Optional[str] = None):
        from ..quant.collectives import check_mode

        if plan is not None:
            if not isinstance(plan, Plan):
                raise InvalidArgumentError(
                    f"Trainer plan= takes a Plan (parallel.plan), got "
                    f"{type(plan).__name__}")
            enforce(param_spec is None and opt_state_rules is None,
                    "plan subsumes param_spec/opt_state_rules — express "
                    "the specs as Plan rules instead")
            enforce(mesh is None or mesh is plan.mesh,
                    "pass either mesh or plan, not both (the plan owns "
                    "its mesh)")
            mesh = plan.mesh
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise InvalidArgumentError(
                    f"Trainer mesh= takes a mesh (core.mesh.build_mesh), got "
                    f"{type(mesh).__name__}")
        if param_spec is not None and not isinstance(param_spec, dict):
            raise InvalidArgumentError(
                f"Trainer param_spec= takes a {{name: PartitionSpec}} dict, "
                f"got {type(param_spec).__name__}")
        if opt_state_rules is not None and not isinstance(
                opt_state_rules, S.OptStateRules):
            raise InvalidArgumentError(
                f"Trainer opt_state_rules= takes OptStateRules "
                f"(parallel.sharding.zero_dp_rules), got "
                f"{type(opt_state_rules).__name__}")
        self.mesh = mesh
        self.plan = plan
        # the trainer's value beats the plan's (the JAX Trainer's rule)
        self.grad_compression = check_mode(
            grad_compression if grad_compression is not None
            else (plan.grad_compression if plan is not None else None))
        if self.grad_compression is not None:
            enforce(plan is not None and plan.num_devices > 1,
                    "grad_compression compresses the gradient "
                    "allreduce — it needs a multi-device plan")
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
        if plan is not None:
            # sharded by construction: every parameter (the frozen ones
            # too) cut to the rank's shard on the mesh's device, and the
            # buffers a rule names (the others replicate)
            plan.place(dict(model.named_parameters()))
            plan.place(dict(model.named_buffers()), buffers=True)
        elif param_spec:
            for name, spec in param_spec.items():
                S.place(self.params[name], NamedSharding(mesh, spec))
        self.opt_state = optimizer.init(self.params)
        if opt_state_rules is not None:
            opt_state_rules.place(self.opt_state, mesh or get_mesh())
        self.device = next(iter(self.params.values())).device
        self._generator = make_generator(0, self.device)
        self._key = next_key()
        self._pmean_axes = pmean_axes(plan)
        # the static per-step payload of the pure data-parallel reduce,
        # for the byte counters (shapes never change after placement)
        self._comm_bytes = (0, 0)
        if self._pmean_axes:
            from ..quant.collectives import tree_payload_bytes

            self._comm_bytes = tree_payload_bytes(
                self.params, self.mesh.axis_size(self._pmean_axes),
                compression=self.grad_compression)
        if grad_accum_steps > 1:
            self._accum = {name: torch.zeros_like(p)
                           for name, p in self.params.items()}
            self._accum_count = 0
        self._jit_step = plan_step(plan, self._step_body)
        self._jit_eval = plan_step(plan, self._eval_body)

    def _scope(self):
        stack = contextlib.ExitStack()
        if self.amp_policy:
            stack.enter_context(policy_scope(self.amp_policy))
        if self.mesh is not None:
            stack.enter_context(mesh_scope(self.mesh))
        return stack

    def _data_axes(self):
        """The mesh's data axes (dp and sp; the plan's batch axes): the
        axes whose ranks hold different rows."""
        return () if self.mesh is None else self.mesh.data_axes

    def _mean_over_mesh(self, tensors):
        """The mean of each tensor over the data axes; the tensors
        themselves where there are none."""
        axes = self._data_axes()
        if not axes:
            return tensors
        n = self.mesh.axis_size(axes)
        return [t / n for t in sum_over(tensors, lambda i: axes,
                                        self.mesh)]

    def _reduce_grads(self, grads, sub):
        """The reduce boundary: the global batch's gradient of every leaf,
        summed over the data axes its spec does not split (a gathered
        leaf's backward summed it over those it does), over their size;
        each placed leaf's gradient carries its sharding. With
        ``grad_compression``: a pure data-parallel plan over one axis
        takes the int8 ring mean, other plans the wire format's round
        trip after the reduce (the module docstring). ``sub``: the step's
        key (the stochastic rounding's)."""
        comp = self.grad_compression
        sr = comp == "int8_sr"
        if comp is not None and len(self._pmean_axes) == 1:
            from ..quant.collectives import quantized_pmean_tree

            ax = self._pmean_axes[0]
            # the JAX step folds the shard's key (_shard_rng) first
            key = fold_in(self._step_key(sub), 0x51C8) if sr else None
            return quantized_pmean_tree(grads, ax, self.mesh.axis_size(ax),
                                        key=key, mesh=self.mesh)
        axes = self._data_axes()
        if axes:
            n = self.mesh.axis_size(axes)
            names = list(grads)
            split = [set(S.sharding_of(self.params[k]).axes())
                     if S.sharding_of(self.params[k]) is not None else set()
                     for k in names]
            summed = sum_over([grads[k] for k in names],
                              lambda i: tuple(a for a in axes
                                              if a not in split[i]),
                              self.mesh)
            grads = {k: g / n for k, g in zip(names, summed)}
        for name, g in grads.items():
            p = self.params[name]
            sh = S.sharding_of(p)
            if sh is not None:
                g._pt_sharding = sh          # the clips' norms (clip.py)
                g._pt_global_shape = p._pt_global_shape
        if comp is not None and not self._pmean_axes:
            from ..quant.collectives import compress_grads

            # one key on every rank: each round-trips the whole leaf
            key = fold_in(sub, 0x51C8) if sr else None
            grads = compress_grads(grads, key=key)
        return grads

    def _step_key(self, sub):
        """The step's key with this rank's data-axis coordinates folded
        in (``jax.random.fold_in``, as the JAX Trainer's ``_shard_rng``
        folds each reduced axis's index): one-rank runs keep the key."""
        for ax in self._data_axes():
            sub = fold_in(sub, self.mesh.axis_index(ax))
        return sub

    def state_shardings(self) -> Optional[Dict[str, Any]]:
        """The shardings of the live state (plan trainers only): each
        leaf's ``NamedSharding`` on the plan's mesh (a whole leaf's is
        the replicated one); the step counters and the key replicate."""
        if self.plan is None:
            return None
        rep = self.plan.replicated()

        def tree(t):
            if isinstance(t, dict):
                return {k: tree(v) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return type(t)(tree(v) for v in t)
            return S.sharding_of(t) or rep

        sh = {"params": tree(self.params), "buffers": tree(self._buffers()),
              "opt_state": tree(self.opt_state), "rng": rep}
        if self.grad_accum_steps > 1:
            sh["grad_accum"] = {"accum": tree(self._accum), "count": rep}
        return sh

    def data_sharding(self):
        """The sharding of a host batch: the plan's batch sharding, else
        the leading dim split over dp (``NamedSharding.local`` cuts the
        rank's rows)."""
        if self.plan is not None:
            return self.plan.batch_sharding()
        return sharding(PartitionSpec("dp"), self.mesh or get_mesh())

    def train_step(self, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One micro-step: loss, backward, and the optimizer's update (on
        every k-th micro-step when accumulating). Returns the (unscaled)
        loss, detached, on the device (reading it syncs), and the
        metrics."""
        self._key, sub = split_key(self._key)
        out = self._step(batch, sub)
        self._count_bytes(1)
        return out

    def _count_bytes(self, steps: int) -> None:
        """Add ``steps`` steps' payload bytes to the collective counters
        (a pure data-parallel plan with telemetry on)."""
        from .. import telemetry

        if self._pmean_axes and telemetry.enabled():
            from ..quant.collectives import record_payload_bytes

            record_payload_bytes(self._comm_bytes[0] * steps,
                                 self._comm_bytes[1] * steps)

    def _step(self, batch, sub) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One micro-step whose generator is seeded from the key ``sub``
        (through the step ``plan_step`` selected)."""
        return self._jit_step(batch, sub)

    def _loss_and_grads(self, batch, key):
        """The rank's loss, metrics and gradients of one forward and
        backward in training mode, the generator seeded from ``key``
        (reduced over nothing: :meth:`_step_body` reduces them;
        parallel/geo_sgd.py steps each replica on them alone)."""
        self.model.train()
        for p in self.params.values():
            p.grad = None
        seed_generator(self._generator, key)
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
        return loss, metrics, grads

    def _step_body(self, batch, sub) -> Tuple[torch.Tensor, Dict[str, Any]]:
        loss, metrics, grads = self._loss_and_grads(batch,
                                                    self._step_key(sub))
        if self.mesh is not None:
            grads = self._reduce_grads(grads, sub)
            loss = self._mean_over_mesh([loss.detach()])[0]
            if self._pmean_axes:
                metrics = self._pmean_tree(metrics)
                self._pmean_buffers()
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

    def _pmean_tree(self, tree):
        """A pure data-parallel plan's metrics: each float tensor's mean
        over the batch axes (JAX's ``pmean`` of the shard_map body's)."""
        if isinstance(tree, dict):
            return {k: self._pmean_tree(v) for k, v in tree.items()}
        if torch.is_tensor(tree) and tree.is_floating_point():
            return self._mean_over_mesh([tree.detach()])[0]
        return tree

    def _pmean_buffers(self):
        """A pure data-parallel plan's buffers: each float buffer set to
        its mean over the batch axes (JAX pmeans the new buffers, so
        every rank applies the same)."""
        bufs = [b for b in self.model.buffers() if b.is_floating_point()]
        with torch.no_grad():
            for b, m in zip(bufs, self._mean_over_mesh(bufs)):
                b.copy_(m)

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
        self._count_bytes(n)
        return out

    def eval_step(self, batch):
        """(loss, metrics) in eval mode, without gradients, under the
        trainer's policy."""
        return self._jit_eval(batch)

    def _eval_body(self, batch):
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad(), self._scope():
                loss, metrics = self.loss_builder(self.model, batch, None)
            if self.mesh is not None:
                loss = self._mean_over_mesh([loss])[0]
                if self._pmean_axes:
                    metrics = self._pmean_tree(metrics)
            return loss, metrics
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
        a directory. A placed state (a plan's shards) is written per host:
        every rank of the plan's process group calls this, and each
        writes the shard regions it owns (checkpoint.py)."""
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
        with None its newest committed step that verifies.

        Each placed leaf (a plan's shard) is restored as this rank's
        shard under the leaf's current sharding, read from whatever the
        checkpoint holds: a whole leaf (the single-process format of
        either package) or the shard regions of any other plan, so a
        state saved under one plan shape restores under another."""
        from ..checkpoint import CheckpointManager, _flatten, restore_state

        target = self.state()
        shardings = _shardings_of(target)
        if isinstance(manager_or_dir, CheckpointManager):
            st = manager_or_dir.restore(step, shardings=shardings,
                                        target=target)
        else:
            st = restore_state(manager_or_dir, shardings=shardings,
                               target=target)
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
        the task loss alone, as in the JAX Trainer.

        Under a mesh whose batch axes hold more than one rank (``dp``,
        and ``fsdp`` under a plan), every tensor of the model's output and
        of the label (each with the batch leading) is all-gathered over
        them before ``loss_fn`` and ``metrics_fn``, which therefore see
        the global batch, as the JAX Trainer's do (the module docstring);
        the MoE terms are the global batch's routing's (nn/moe.py). Under
        a pure data-parallel plan (the shard_map regime) each rank's are
        its own rows', averaged by the Trainer."""

        def loss_builder(model, batch, generator):
            if isinstance(batch, dict):
                x, label = batch["x"], batch["label"]
            else:
                x, label = batch
            out = model(x)
            axes = tuple(a for a in reduce_axes() if a != "sp")
            if axes:
                out, label = _over_dp(out, axes), _over_dp(label, axes)
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


class DataParallel:
    """A supervised Trainer over a data-parallel mesh of every rank
    (``core.mesh.auto_mesh(devices)``; reference: dygraph/parallel.py
    DataParallel). Each rank trains on its rows of the batch."""

    def __new__(cls, model: torch.nn.Module, optimizer: Optimizer,
                loss_fn: Callable, metrics_fn=None, devices=None):
        from ..core.mesh import auto_mesh

        return Trainer.supervised(model, optimizer, loss_fn, metrics_fn,
                                  mesh=auto_mesh(devices))


def _over_dp(tree, axes):
    """``tree`` with each tensor of at least one dim all-gathered over
    the current mesh's batch ``axes`` along its leading dim (the global
    batch; the backward keeps the rank's rows of the summed
    cotangent)."""
    from .collective import allgather

    if isinstance(tree, dict):
        return {k: _over_dp(v, axes) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_over_dp(v, axes) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dim() >= 1:
        return allgather(tree, axes)
    return tree


def _ints_to_int32(tree):
    """``tree`` with its Python int leaves as 0-dim int32 tensors."""
    if isinstance(tree, dict):
        return {k: _ints_to_int32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_ints_to_int32(v) for v in tree)
    if isinstance(tree, int) and not isinstance(tree, bool):
        return torch.tensor(tree, dtype=torch.int32)
    return tree


def _shardings_of(tree):
    """``tree`` with each placed leaf replaced by its sharding and every
    other leaf by None (restored whole)."""
    if isinstance(tree, dict):
        return {k: _shardings_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shardings_of(v) for v in tree)
    return S.sharding_of(tree) if torch.is_tensor(tree) else None


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
