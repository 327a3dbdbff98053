"""Device meshes (counterpart of paddle_tpu/core/mesh.py): the canonical
axis names, the mesh builders and the current mesh.

The design rule of the port's distributed code. The JAX package is
single-controller: it holds global arrays and runs ``shard_map`` bodies
inside them. The port is multi-controller: one process per mesh device,
on ``torch.distributed``.

- A mesh lays the ranks out with the JAX axis names and order (``dp, pp,
  tp, sp, ep``): rank ``devices[i]`` sits where the JAX mesh puts device
  ``i`` for the same sizes, including the multi-host and hybrid
  reshapes. An axis name, or a tuple of names, resolves to the process
  group of the ranks that share every other coordinate (created when
  the mesh is built, by every rank, in one order; a group of one rank is
  no group: its collectives are identities). ``device_mesh`` is the same
  layout as a ``torch.distributed.device_mesh.DeviceMesh`` for DTensor.
- Shards. A port function that the JAX package runs over ``shard_map``
  with spec ``P(...)`` takes and returns the rank's shard under that
  spec (``NamedSharding.local`` cuts it from a global tensor).
- Tests scatter the same seeded global arrays by that spec and gather
  the results, to hold them against the JAX function on the global
  arrays.
- A model takes what the JAX Trainer's ``data_sharding`` gives a rank:
  the batch split over ``dp``, with the full sequence.

With no process group, :func:`get_mesh` is a one-rank mesh whose
collectives are identities: nothing here calls ``init_process_group``
(``parallel/collective.py`` ``init_world`` does, when the caller asks),
so every single-device path runs as it does without a mesh. Each rank's
device is the caller's choice (``device=``), else ``cuda:{local rank %
device_count}`` where there is a card (the local rank from
``LOCAL_RANK``, else the global rank), else the CPU; on one card every
rank shares ``cuda:0``."""

from __future__ import annotations

import contextlib
import itertools
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import DistributeConfig
from .enforce import InvalidArgumentError, enforce
from .sharding_types import AXIS_NAMES, NamedSharding, PartitionSpec, _axes

P = PartitionSpec

Axis = Union[str, Sequence[str]]

_current_mesh: Optional["Mesh"] = None


def _world():
    """(rank, world size) of the default process group, (0, 1) without
    one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _default_device(rank: int) -> torch.device:
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank))
        return torch.device("cuda", local % torch.cuda.device_count())
    return torch.device("cpu")


class Mesh:
    """Ranks laid out over named axes (``jax.sharding.Mesh``).
    ``devices``: the array of global ranks, one dim per name of
    ``axis_names`` (default :data:`AXIS_NAMES`, ``build_mesh``'s (dp, pp,
    tp, sp, ep); a plan's mesh is (dp, fsdp, tp[, ep]), parallel/plan.py);
    ``shape`` the {axis: size} dict; ``rank`` this process's global rank,
    ``coordinate`` its {axis: index}; ``device`` its torch device.
    ``batch_axes``: the axes the global batch's rows split over (``dp``
    and ``fsdp`` where the mesh has them; a plan sets its own), and
    :attr:`data_axes` those and ``sp``, where ranks hold different
    tokens. Built by :func:`build_mesh` and friends; when a process
    group with more than one rank is up, the constructor creates the
    axis groups, so every rank must build the same meshes in the same
    order."""

    def __init__(self, devices, axis_names: Sequence[str] = AXIS_NAMES, *,
                 device=None):
        devices = np.asarray(devices, dtype=np.int64)
        axis_names = tuple(axis_names)
        enforce(len(set(axis_names)) == len(axis_names),
                "mesh axis names repeat: %s", axis_names)
        enforce(devices.ndim == len(axis_names),
                "a mesh over axes %s needs a %s-dim device array, got %s",
                axis_names, len(axis_names), devices.shape)
        rank, world = _world()
        ranks = sorted(devices.ravel().tolist())
        # a mesh spans the process group's ranks, or this rank alone;
        # without a process group a mesh over more ranks is a layout
        # only (its axes of more than one rank have no group)
        enforce(ranks == [rank] or (ranks == list(range(world))
                                    if world > 1 else rank in ranks),
                "the mesh's ranks %s are not the %s ranks of the process "
                "group", ranks, world)
        self.devices = devices
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, devices.shape))
        self.size = int(devices.size)
        self.rank = rank
        where = np.argwhere(devices == rank)[0]
        self.coordinate: Dict[str, int] = {
            a: int(i) for a, i in zip(axis_names, where)}
        self.batch_axes: Tuple[str, ...] = tuple(
            a for a in ("dp", "fsdp") if a in self.shape)
        self.device = (torch.device(device) if device is not None
                       else _default_device(rank))
        self._groups = {}
        self._device_mesh = None
        if world > 1 and self.size > 1:
            self._make_groups()

    def __repr__(self):
        sizes = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"Mesh({sizes}; rank {self.rank} on {self.device})"

    # --- axes --------------------------------------------------------------

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """The batch axes, then ``sp``, that have more than one rank: the
        axes over which ranks hold different tokens of the global batch
        (a model's loss and batch statistics reduce over them; ``tp`` and
        ``ep`` ranks hold the same rows)."""
        axes = self.batch_axes + (("sp",) if "sp" in self.shape else ())
        return tuple(a for a in axes if self.shape[a] > 1)

    def size_of(self, name: str) -> int:
        """The size of axis ``name``; 1 where the mesh has no such axis."""
        return int(self.shape.get(name, 1))

    def axis_size(self, axis: Axis) -> int:
        """The product of the sizes of ``axis`` (a name or names)."""
        out = 1
        for a in _axes(axis):
            enforce(a in self.shape, "unknown mesh axis %r (the mesh has "
                    "%s)", a, list(self.axis_names))
            out *= self.shape[a]
        return out

    def axis_index(self, axis: Axis) -> int:
        """This rank's index along ``axis``; over names, the first one
        outermost (``lax.axis_index`` of a tuple)."""
        idx = 0
        for a in _axes(axis):
            idx = idx * self.axis_size(a) + self.coordinate[a]
        return idx

    def members(self, axis: Axis):
        """The global ranks that share this rank's other coordinates, in
        the order of their index along ``axis``."""
        names = _axes(axis)
        self.axis_size(names)
        sub = self.devices[tuple(
            slice(None) if a in names else self.coordinate[a]
            for a in self.axis_names)]
        # the remaining dims are the named axes in mesh order; put them in
        # the caller's order, the first name outermost
        kept = [a for a in self.axis_names if a in names]
        sub = np.transpose(sub, [kept.index(a) for a in names])
        return [int(r) for r in sub.ravel()]

    def group(self, axis: Axis):
        """The process group of ``axis``: None where the axis has one
        rank. Raises where it has more and no group was made (no process
        group was up when the mesh was built)."""
        n = self.axis_size(axis)
        if n == 1:
            return None
        key = frozenset(a for a in _axes(axis) if self.shape[a] > 1)
        g = self._groups.get(key)
        if g is None:
            raise InvalidArgumentError(
                f"mesh axis {axis!r} spans {n} ranks but the mesh has no "
                f"process group for it: build the mesh after "
                f"init_process_group (parallel.collective.init_world)")
        return g

    def _make_groups(self):
        import torch.distributed as dist

        names_all = list(self.axis_names)
        big = [a for a in names_all if self.shape[a] > 1]
        for r in range(1, len(big) + 1):
            for names in itertools.combinations(big, r):
                if len(names) == len(big):
                    self._groups[frozenset(names)] = dist.group.WORLD
                    continue
                rest = [a for a in names_all if a not in names]
                moved = np.moveaxis(
                    self.devices, [names_all.index(a) for a in rest],
                    range(len(rest)))
                subs = moved.reshape(-1, self.axis_size(names))
                mine, _ = dist.new_subgroups_by_enumeration(
                    [sorted(int(x) for x in row) for row in subs])
                self._groups[frozenset(names)] = mine

    @property
    def device_mesh(self):
        """The layout as a ``torch.distributed.device_mesh.DeviceMesh``
        with the mesh's axis names (built at first use, by every rank
        together; needs the process group)."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            self._device_mesh = DeviceMesh(
                self.device.type, torch.as_tensor(self.devices),
                mesh_dim_names=self.axis_names)
        return self._device_mesh


def build_mesh(dp: int = 1, tp: int = 1, pp: int = 1, sp: int = 1,
               ep: int = 1, *, devices: Optional[Sequence[int]] = None,
               device=None) -> Mesh:
    """A mesh over ``devices`` (global ranks; default all of the process
    group's, or the one rank without one), laid out (dp, pp, tp, sp, ep)
    as the JAX mesh lays devices: the innermost axes get neighbouring
    ranks. Size-1 axes stay, so every axis can be named. Raises when the
    sizes' product differs from the number of ranks."""
    sizes = {"dp": dp, "pp": pp, "tp": tp, "sp": sp, "ep": ep}
    for name, s in sizes.items():
        enforce(s >= 1, "axis %s must be >= 1, got %s", name, s)
    devices = _ranks(devices)
    total = dp * tp * pp * sp * ep
    enforce(total == len(devices), "mesh size %s != device count %s", total,
            len(devices))
    return Mesh(np.asarray(devices).reshape(dp, pp, tp, sp, ep),
                device=device)


def _ranks(devices) -> list:
    if devices is None:
        return list(range(_world()[1]))
    return [int(d) for d in devices]


def build_multihost_mesh(world_size: int, *, dcn_axis: str = "dp",
                         dp: int = 1, tp: int = 1, pp: int = 1, sp: int = 1,
                         ep: int = 1,
                         devices: Optional[Sequence[int]] = None,
                         device=None) -> Mesh:
    """A mesh whose ``dcn_axis`` spans the hosts: ``world_size`` hosts,
    ranks numbered host-major. The axis splits (hosts, size / hosts) with
    the host outermost, the others stay inside a host; ``dcn_axis="dp"``
    is :func:`build_mesh`'s layout."""
    sizes = {"dp": dp, "pp": pp, "tp": tp, "sp": sp, "ep": ep}
    enforce(dcn_axis in sizes, "unknown mesh axis %r", dcn_axis)
    enforce(world_size >= 1 and sizes[dcn_axis] % world_size == 0,
            "%s axis size %s must divide by world size %s to span hosts",
            dcn_axis, sizes[dcn_axis], world_size)
    devices = _ranks(devices)
    total = dp * pp * tp * sp * ep
    enforce(total == len(devices), "mesh size %s != device count %s", total,
            len(devices))
    k = AXIS_NAMES.index(dcn_axis)
    local_shape = [sizes[a] for a in AXIS_NAMES]
    local_shape[k] //= world_size
    arr = np.asarray(devices).reshape([world_size] + local_shape)
    arr = np.moveaxis(arr, 0, k)
    return Mesh(arr.reshape([sizes[a] for a in AXIS_NAMES]), device=device)


def build_hybrid_mesh(dcn_dp: int = 1, *, dp: int = 1, tp: int = 1,
                      pp: int = 1, sp: int = 1, ep: int = 1,
                      devices: Optional[Sequence[int]] = None,
                      device=None) -> Mesh:
    """A multi-slice mesh: an outer data-parallel factor ``dcn_dp`` over
    the slices (hosts) times the inner axes of each slice; the dp axis is
    ``dcn_dp * dp``, the slices outermost."""
    devices = _ranks(devices)
    inner = dp * tp * pp * sp * ep
    enforce(dcn_dp * inner == len(devices), "hybrid mesh %s x %s != %s "
            "devices", dcn_dp, inner, len(devices))
    arr = np.asarray(devices).reshape(dcn_dp, dp, pp, tp, sp, ep)
    return Mesh(arr.reshape(dcn_dp * dp, pp, tp, sp, ep), device=device)


def from_config(cfg: DistributeConfig, devices=None) -> Mesh:
    return build_mesh(dp=cfg.dp, tp=cfg.tp, pp=cfg.pp, sp=cfg.sp, ep=cfg.ep,
                      devices=devices)


def auto_mesh(devices: Optional[Sequence[int]] = None) -> Mesh:
    """A pure data-parallel mesh over every rank."""
    devices = _ranks(devices)
    return build_mesh(dp=len(devices), devices=devices)


def get_mesh() -> Mesh:
    """The current mesh; at first use without one, the one-rank mesh of
    this process (its collectives are identities)."""
    global _current_mesh
    if _current_mesh is None:
        _current_mesh = Mesh(np.full((1,) * len(AXIS_NAMES), _world()[0]))
    return _current_mesh


_local_batch = False


@contextlib.contextmanager
def local_batch():
    """Inside, :func:`reduce_axes` is empty: each rank's losses and batch
    statistics are its own rows', as in the body of the JAX package's
    ``shard_map`` (a pure data-parallel plan's step, parallel/plan.py
    ``compile_step``), whose caller then averages over the mesh."""
    global _local_batch
    prev, _local_batch = _local_batch, True
    try:
        yield
    finally:
        _local_batch = prev


def reduce_axes(mesh: Optional["Mesh"] = None) -> Tuple[str, ...]:
    """The axes over which a model's losses, batch statistics and MoE
    routing take the global batch: the current mesh's
    :attr:`Mesh.data_axes`, or none inside :func:`local_batch`."""
    if _local_batch:
        return ()
    return (mesh or get_mesh()).data_axes


def set_mesh(mesh: Mesh) -> Mesh:
    global _current_mesh
    _current_mesh = mesh
    return mesh


@contextlib.contextmanager
def mesh_scope(mesh: Mesh):
    global _current_mesh
    prev = _current_mesh
    _current_mesh = mesh
    try:
        yield mesh
    finally:
        _current_mesh = prev


def axis_size(name: str, mesh: Optional[Mesh] = None) -> int:
    mesh = mesh or get_mesh()
    return int(mesh.shape.get(name, 1))


def sharding(spec: PartitionSpec, mesh: Optional[Mesh] = None) -> NamedSharding:
    return NamedSharding(mesh or get_mesh(), spec)


def replicated(mesh: Optional[Mesh] = None) -> NamedSharding:
    return sharding(PartitionSpec(), mesh)


def data_sharding(mesh: Optional[Mesh] = None,
                  batch_axes=("dp",)) -> NamedSharding:
    """A host batch's sharding: the leading dim split over ``batch_axes``."""
    return sharding(PartitionSpec(batch_axes), mesh)
