"""Declarative sharding plans over dp, fsdp, tp and ep (counterpart of
paddle_tpu/parallel/plan.py).

A :class:`Plan` declares how state and data map onto a named mesh:

- ``dp``: data parallel, the batch split, the parameters replicated;
- ``fsdp``: the batch split and the large parameters and their moments
  sharded (ZeRO-3): the default tier shards each large leaf's largest
  divisible dim over ``fsdp``;
- ``tp``: tensor parallel, parameter dims split by explicit or pattern
  rules (``parallel.sharding.transformer_tp_rules``);
- ``ep`` (opt-in: the mesh carries it only when ``ep > 1``): the
  ``tables=`` leaves' rows split over it; batch leaves never split over
  ``ep``, its ranks hold the same rows.

Spec resolution per name: explicit map > table > pattern rules > the
largest-axis-over-fsdp default > replicated; a spec a dim does not
divide by falls to the next tier.

The JAX package compiles one partitioned program (``pjit``) for an
explicit plan and a ``shard_map`` body for pure data parallelism. The
port runs one process per rank (core/mesh.py): :meth:`Plan.place` cuts
each leaf to the rank's shard, the layers gather at use or compute on
their shard (parallel/sharding.py), and :func:`compile_step` keeps the
JAX selection and its labels, which name the regime: under "pjit" (and
"jit") a rank's loss is the global batch's, under "shard_map" each
rank's is its own rows' (``core.mesh.local_batch``) and the caller
averages over ``pmean_axes``."""

from __future__ import annotations

import contextlib
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.enforce import enforce
from ..core.mesh import Mesh, _ranks, _world, local_batch
from ..core.sharding_types import NamedSharding, PartitionSpec as P
from . import sharding as S

PLAN_AXES = ("dp", "fsdp", "tp")
# the opt-in table axis (in the plan's mesh only when ep > 1)
TABLE_AXIS = "ep"

Rule = Tuple[str, P]


class Plan:
    """Declarative sharding plan over a ``(dp, fsdp, tp[, ep])`` mesh.

    - ``rules``: ordered ``(regex, PartitionSpec)`` pattern rules (the
      first match wins).
    - ``params``: an explicit {name: spec} map; beats every rule.
    - default: with ``fsdp > 1``, a leaf of at least ``min_shard_size``
      elements shards its largest fsdp-divisible dim over ``"fsdp"``.
    - ``batch_axes``: the axes a batch's leading dim splits over
      (default ``("dp", "fsdp")``).
    - ``tables``: regexes naming embedding tables whose rows split over
      ``ep`` (``P("ep", None)``) when ``ep > 1``.

    ``devices``: the global ranks of the mesh (default the process
    group's first ``num_devices``); ``mesh``: a port :class:`Mesh` with
    the plan's axes instead; ``device``: the ranks' torch device (the
    mesh's default otherwise). ``grad_compression`` (None, "int8" or
    "int8_sr"): the plan's default for the Trainer's int8 gradient
    all-reduce (quant/collectives.py), which ``Trainer(grad_compression=)``
    overrides."""

    def __init__(self, dp: int = 1, fsdp: int = 1, tp: int = 1, *,
                 ep: int = 1, rules: Sequence[Rule] = (),
                 params: Optional[Dict[str, P]] = None,
                 tables: Sequence[str] = (), min_shard_size: int = 1024,
                 batch_axes: Sequence[str] = ("dp", "fsdp"),
                 devices: Optional[Sequence[int]] = None,
                 mesh: Optional[Mesh] = None,
                 grad_compression: Optional[str] = None, device=None):
        for name, s in (("dp", dp), ("fsdp", fsdp), ("tp", tp),
                        (TABLE_AXIS, ep)):
            enforce(s >= 1, "plan axis %s must be >= 1, got %s", name, s)
        from ..quant.collectives import check_mode

        self.dp, self.fsdp, self.tp = int(dp), int(fsdp), int(tp)
        self.ep = int(ep)
        self.tables = [re.compile(pat) for pat in tables]
        self.grad_compression = check_mode(grad_compression)
        self.rules = [(re.compile(pat), spec) for pat, spec in rules]
        self.params = dict(params or {})
        self.min_shard_size = int(min_shard_size)
        for ax in batch_axes:
            enforce(ax in PLAN_AXES, "unknown batch axis %r (plan axes "
                    "are %s)", ax, PLAN_AXES)
        self.batch_axes = tuple(batch_axes)
        self._device = device
        if mesh is not None:
            enforce(all(a in mesh.shape for a in PLAN_AXES),
                    "plan mesh must carry axes %s, got %s", PLAN_AXES,
                    tuple(mesh.axis_names))
            enforce(tuple(mesh.shape[a] for a in PLAN_AXES)
                    == (self.dp, self.fsdp, self.tp),
                    "mesh shape %s != plan (dp=%s, fsdp=%s, tp=%s)",
                    dict(mesh.shape), self.dp, self.fsdp, self.tp)
            enforce(int(mesh.shape.get(TABLE_AXIS, 1)) == self.ep,
                    "mesh %s axis size %s != plan ep=%s", TABLE_AXIS,
                    int(mesh.shape.get(TABLE_AXIS, 1)), self.ep)
            mesh.batch_axes = self.batch_axes
            self._mesh: Optional[Mesh] = mesh
        else:
            self._mesh = None
            self._devices = devices

    # -- mesh ----------------------------------------------------------------

    @property
    def mesh(self) -> Mesh:
        """The plan's mesh, built at first use over its ranks: fsdp and
        tp (and ep) innermost, dp outermost, as the JAX plan lays its
        devices. An ep=1 plan's mesh has the three axes only."""
        if self._mesh is None:
            n = self.num_devices
            devices = self._devices
            if devices is None:
                devices = list(range(n))
            devices = _ranks(devices)
            enforce(len(devices) == n,
                    "plan needs %s devices (dp=%s x fsdp=%s x tp=%s "
                    "x ep=%s), got %s", n, self.dp, self.fsdp, self.tp,
                    self.ep, len(devices))
            if self.ep > 1:
                shape = (self.dp, self.fsdp, self.tp, self.ep)
                names = PLAN_AXES + (TABLE_AXIS,)
            else:
                shape, names = (self.dp, self.fsdp, self.tp), PLAN_AXES
            self._mesh = Mesh(np.asarray(devices).reshape(shape), names,
                              device=self._device)
            self._mesh.batch_axes = self.batch_axes
        return self._mesh

    @property
    def num_devices(self) -> int:
        return self.dp * self.fsdp * self.tp * self.ep

    @property
    def explicit(self) -> bool:
        """True when the plan carries real shardings (fsdp, tp or ep
        axes, or any per-parameter rule): the JAX package compiles its
        steps through ``pjit``. A pure-DP plan takes ``shard_map``."""
        return (self.fsdp > 1 or self.tp > 1 or self.ep > 1
                or bool(self.rules) or bool(self.params))

    # -- spec resolution -----------------------------------------------------

    def is_table(self, name: str) -> bool:
        """True when ``name`` matches a registered ``tables=`` pattern."""
        return any(pat.search(name) for pat in self.tables)

    def table_spec(self) -> P:
        """The row-sharded layout of registered tables under ep."""
        return P(TABLE_AXIS, None)

    def spec_for(self, name: str, value=None, *, default: bool = True
                 ) -> P:
        """Resolve one parameter or buffer name: explicit > table >
        pattern > default. ``value`` (anything with ``.shape``; a placed
        shard counts by its whole shape) gates divisibility and the
        default tier; without it, explicit and pattern specs are taken
        as given and the default replicates. ``default=False`` skips the
        default tier (a buffer's resolution, :meth:`place`)."""
        if name in self.params:
            spec = self.params[name]
            if S._divisible(value, spec, self.mesh):
                return spec
        if self.ep > 1 and self.is_table(name):
            spec = self.table_spec()
            if S._divisible(value, spec, self.mesh):
                return spec
        for pat, spec in self.rules:
            if pat.search(name):
                if S._divisible(value, spec, self.mesh):
                    return spec
                # the first match wins even when it does not divide:
                # the leaf falls to the default tier
                break
        return self._default_spec(value) if default else P()

    def requested_spec(self, name: str) -> Optional[P]:
        """The spec asked for (explicit map, table, first matching rule)
        before any divisibility gate; None when only the default tier
        applies."""
        if name in self.params:
            return self.params[name]
        if self.ep > 1 and self.is_table(name):
            return self.table_spec()
        for pat, spec in self.rules:
            if pat.search(name):
                return spec
        return None

    def _default_spec(self, value) -> P:
        """Shard the biggest fsdp-divisible dim (ZeRO-3); small or odd
        leaves replicate."""
        shape = S._global_shape(value)
        if (self.fsdp <= 1 or shape is None or not len(shape)
                or int(np.prod(shape)) < self.min_shard_size):
            return P()
        order = sorted(range(len(shape)), key=lambda d: -int(shape[d]))
        for dim in order:
            if shape[dim] and shape[dim] % self.fsdp == 0:
                spec: List[Any] = [None] * len(shape)
                spec[dim] = "fsdp"
                return P(*spec)
        return P()

    # -- derived shardings ---------------------------------------------------

    def sharding_for(self, name: str, value=None) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec_for(name, value))

    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())

    def batch_sharding(self) -> NamedSharding:
        """Batch leaves: the leading dim split over the batch axes of
        more than one rank (so a dp=1 fsdp=N plan still splits)."""
        axes = tuple(a for a in self.batch_axes
                     if int(self.mesh.shape[a]) > 1)
        return NamedSharding(self.mesh, P(axes) if axes else P())

    # -- placement -----------------------------------------------------------

    def place(self, named: Dict[str, Any], *, buffers: bool = False
              ) -> Dict[str, Any]:
        """Cut each tensor of a {name: tensor} dict to this rank's shard
        under its resolved spec, in place, on the mesh's device
        (parallel/sharding.py ``place``; build the model under
        :func:`host_init` and no card holds more than its shards).
        ``buffers=True`` skips the default tier: a buffer replicates
        unless the explicit map, a table or a rule names it (the JAX
        package's "buffers resolve through the same rules, default
        replicated"), since a layer may read a buffer whole, a
        positional table by row. Returns the dict."""
        for name, leaf in named.items():
            spec = self.spec_for(name, leaf, default=not buffers)
            S.place(leaf, NamedSharding(self.mesh, spec),
                    device=self.mesh.device)
        return named

    # -- reporting -----------------------------------------------------------

    def describe(self, params: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
        """The plan's summary (the JAX keys; its ``audit`` of the layout,
        analysis/shardcheck, is not ported)."""
        out: Dict[str, Any] = {
            "axes": {"dp": self.dp, "fsdp": self.fsdp, "tp": self.tp,
                     "ep": self.ep},
            "devices": self.num_devices,
            "batch_axes": list(self.batch_axes),
            "mode": "pjit" if self.explicit else "shard_map",
            "rules": len(self.rules),
            "explicit_params": len(self.params),
            "tables": len(self.tables),
            "grad_compression": self.grad_compression,
        }
        if params is not None:
            specs = {n: self.spec_for(n, v) for n, v in params.items()}
            sharded = {n: str(s) for n, s in specs.items() if s != P()}
            out["sharded_params"] = len(sharded)
            out["replicated_params"] = len(params) - len(sharded)
            out["param_specs"] = sharded
        return out

    def __repr__(self):
        return (f"Plan(dp={self.dp}, fsdp={self.fsdp}, tp={self.tp}, "
                f"ep={self.ep}, rules={len(self.rules)}, "
                f"tables={len(self.tables)}, explicit={self.explicit})")


@contextlib.contextmanager
def host_init():
    """Build a model's parameters in host memory: inside, a layer built
    with no ``device=`` lands on the CPU (core/places.py), so
    :meth:`Plan.place` then moves only each rank's shards to the card::

        with host_init():
            model = GPTForCausalLM(cfg)
        trainer = Trainer.supervised(model, opt, loss, plan=plan)
    """
    from ..core import places

    prev = places._default_device
    places._default_device = torch.device("cpu")
    try:
        yield
    finally:
        places._default_device = prev


# ---------------------------------------------------------------------------
# per-rank byte accounting
# ---------------------------------------------------------------------------


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensor_leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def device_bytes(tree) -> Dict[int, int]:
    """{this rank: the bytes its tensors of ``tree`` hold}: a placed
    leaf counts its shard, a whole one every byte. The JAX package reads
    every device's shards of its global arrays; a rank here sees its
    own (:func:`max_device_bytes` reduces over the mesh)."""
    total = sum(t.numel() * t.element_size() for t in _tensor_leaves(tree))
    return {_world()[0]: int(total)}


def max_device_bytes(tree, mesh: Optional[Mesh] = None) -> int:
    """The largest rank's bytes of ``tree`` over ``mesh`` (default the
    current mesh; every rank of it must call): the max over its ranks
    of :func:`device_bytes`. 0 for an empty tree."""
    from ..core.mesh import get_mesh
    from .collective import allreduce

    mesh = mesh or get_mesh()
    mine = sum(device_bytes(tree).values())
    out = allreduce(torch.tensor([float(mine)], dtype=torch.float64),
                    tuple(mesh.axis_names), "max", mesh=mesh)
    return int(out.item())


# ---------------------------------------------------------------------------
# the resharding guard
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def guard_no_resharding():
    """Raise when the body reshards: a ``constraint`` that had to gather
    or cut (parallel/sharding.py ``RESHARDS``), or a placed leaf (a
    parameter, buffer or moment cut by ``sharding.place``) that left its
    layout, its local shape, its sharding or its device changed. A
    steady planned step, whose leaves stay in their placed layout,
    makes none. The JAX package's guard catches every device-to-device
    transfer; a rank here sees its own leaves, so the guard compares
    them before and after the body. Counted in
    ``pt_resharding_copies_total`` when telemetry is on."""
    from ..core.enforce import EnforceError

    before = S.RESHARDS["copies"]
    layouts = [(t, S.layout_of(t)) for t in list(S.PLACED.values())]
    yield
    copies = S.RESHARDS["copies"] - before
    moved = sum(S.layout_of(t) != was for t, was in layouts)
    if copies or moved:
        from .. import telemetry

        if telemetry.enabled():
            telemetry.registry().counter(
                "pt_resharding_copies_total",
                "resharding copies caught by guard_no_resharding").inc(
                    copies + moved)
        raise EnforceError(f"{copies} resharding copies and {moved} "
                           f"placed leaves out of their layout inside "
                           f"guard_no_resharding (a leaf left its placed "
                           f"layout)")


# ---------------------------------------------------------------------------
# step selection
# ---------------------------------------------------------------------------


def compile_step(plan: Optional[Plan], fn: Callable, *,
                 in_shardings=None, out_shardings=None,
                 donate_argnums: Sequence[int] = (),
                 batch_argnum: int = -1,
                 static_argnums: Sequence[int] = ()):
    """``fn`` for the plan, labelled with its regime as the JAX package
    selects it (``compiled_via``, :func:`plan_step`): "pjit" also where
    shardings are given; it needs both ``in_shardings`` and
    ``out_shardings``, as in the JAX package (the port reads nothing
    else of them: each rank's leaves are placed already).

    PyTorch runs eagerly, so nothing is compiled and ``donate_argnums``
    changes nothing (the port's updates are in place)."""
    step = plan_step(plan, fn, sharded=in_shardings is not None)
    if step.compiled_via == "pjit":
        enforce(in_shardings is not None and out_shardings is not None,
                "explicit plans compile via pjit and need both "
                "in_shardings and out_shardings (derive them from the "
                "placed state)")
    elif step.compiled_via == "shard_map":
        enforce(not static_argnums,
                "static_argnums is not supported on the shard_map "
                "fallback (the static positions would be fed to "
                "shard_map as array operands): close over the static "
                "values instead")
    return step


def plan_step(plan: Optional[Plan], fn: Callable, *,
              sharded: bool = False):
    """``fn`` labelled with its regime (``compiled_via``):

    - "jit": no plan, or a one-device plan;
    - "pjit": an explicit plan (fsdp, tp or ep axes, or rules), or
      ``sharded``; a rank's loss is the global batch's;
    - "shard_map": a pure data-parallel plan; ``fn`` runs inside
      ``core.mesh.local_batch``, on the rank's rows, and must average
      what it returns over :func:`pmean_axes` itself."""
    if plan is None or plan.num_devices == 1:
        via = "jit"
    elif plan.explicit or sharded:
        via = "pjit"
    else:
        via = "shard_map"

    if via == "shard_map":
        def step(*args, **kw):
            with local_batch():
                return fn(*args, **kw)
    else:
        def step(*args, **kw):
            return fn(*args, **kw)

    step.compiled_via = via
    step.__wrapped__ = fn
    return step


def pmean_axes(plan: Optional[Plan]) -> Tuple[str, ...]:
    """The axes a pure data-parallel plan's step averages its gradients
    and loss over (empty for explicit or absent plans, whose ranks take
    the global batch's loss)."""
    if plan is None or plan.explicit or plan.num_devices == 1:
        return ()
    return tuple(a for a in plan.batch_axes
                 if int(plan.mesh.shape[a]) > 1)
