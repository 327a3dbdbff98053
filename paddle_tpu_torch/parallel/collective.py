"""Collectives over mesh axes (counterpart of
paddle_tpu/parallel/collective.py).

The JAX package's collectives are ``lax`` primitives inside ``shard_map``
bodies; here each rank calls them on its shard, and they run over the
process group of the named axis (``core/mesh.py``), or are identities
where the axis has one rank. ``axis`` is a name or a tuple of names (the
first outermost, as ``lax`` orders them).

Backends. NCCL where each rank has its own card; gloo otherwise (the
CPU, and ranks sharing one card: NCCL refuses two ranks on one device).
:func:`init_world` picks the backend so. Under NCCL a CUDA tensor goes
to the collective as it is. Gloo's transport reads host memory, so under
gloo a CUDA tensor passes through a pinned host copy and back, and the
staging moves transport only: every gloo collective here is a gather, an
all-to-all, a broadcast or a point-to-point exchange, and a reduction
sums what arrived on the tensor's own device, in rank order (so replicas
stay bit-equal). ``STAGING`` counts the bytes staged (host copies and
back) and the copies.

Gradients: each collective is differentiable where the JAX package
differentiates through it, with JAX's transpose inside the package's
``shard_map`` (``check_vma=False``): ``allreduce`` sum and mean transpose
to themselves (each rank's cotangent is reduced, not passed through),
``allgather`` to ``reduce_scatter`` and back, ``all_to_all`` to the
reverse all-to-all, ``ppermute`` to the inverse permutation, and
``broadcast`` (a masked sum) to the sum of the cotangents at ``src``.
``allreduce`` max and min raise in the backward, as JAX has no
differentiation rule for them.

Tensor parallelism needs the other transposes: the ranks of a ``tp``
group hold the same rows, so a cotangent that reaches them is one
cotangent, not one a rank. Megatron's conjugate pair: :func:`copy_to_tp`
(identity forward, the sum over ``tp`` backward) opens a column-parallel
product, :func:`reduce_from_tp` (the sum forward, identity backward)
closes a row-parallel one; :func:`gather_at_use` all-gathers a sharded
parameter and gives each rank its shard's gradient: reduce-scattered
over the batch axes among its spec's axes, cut over the others."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ..core.enforce import UnimplementedError, enforce
from ..core.mesh import Mesh, get_mesh

Axis = Union[str, Sequence[str]]


class _Staging:
    """Bytes and copies moved between a card and the host for gloo."""

    def __init__(self):
        self.bytes = 0
        self.copies = 0

    def reset(self):
        self.bytes = self.copies = 0


STAGING = _Staging()


def init_world(rank: int, world_size: int, init_method: str,
               backend: Optional[str] = None,
               timeout_s: Optional[float] = None):
    """``torch.distributed.init_process_group`` with the backend this
    module expects: NCCL when every rank has a card of its own (the
    machine holds at least ``world_size`` cards), gloo otherwise.
    ``timeout_s``: how long a collective (and the rendezvous) may wait
    before it raises (torch's default when None). Returns the backend's
    name."""
    import datetime

    import torch.distributed as dist

    if backend is None:
        backend = ("nccl" if torch.cuda.is_available()
                   and torch.cuda.device_count() >= world_size else "gloo")
    kw = ({} if timeout_s is None
          else {"timeout": datetime.timedelta(seconds=timeout_s)})
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    return backend


# --- transport ---------------------------------------------------------------

class _Ctx:
    """One collective's group on the current mesh: its ranks in axis
    order and whether tensors stage through the host."""

    def __init__(self, axis: Axis, mesh: Optional[Mesh]):
        import torch.distributed as dist

        self.mesh = mesh or get_mesh()
        self.n = self.mesh.axis_size(axis)
        self.index = self.mesh.axis_index(axis)
        self.group = self.mesh.group(axis)
        if self.group is None:
            return
        self.members = self.mesh.members(axis)
        # the group's rank order (torch sorts the ranks) against the axis
        # order: grank[i] is the group rank of axis index i
        self.grank = [dist.get_group_rank(self.group, r)
                      for r in self.members]
        self.gloo = dist.get_backend(self.group) == "gloo"

    def host(self, x):
        """``x`` where the backend reads it (bool as uint8): a pinned host
        copy of a CUDA tensor under gloo."""
        x = _wire(x.contiguous())
        if not (self.gloo and x.is_cuda):
            return x
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
        STAGING.bytes += x.numel() * x.element_size()
        STAGING.copies += 1
        return h

    def back(self, h, like):
        """``h`` on ``like``'s device, in its dtype (the reverse of
        :meth:`host`)."""
        if h.device != like.device:
            STAGING.bytes += h.numel() * h.element_size()
            STAGING.copies += 1
            h = h.to(like.device, non_blocking=True)
        return h.view(torch.bool) if like.dtype == torch.bool else h

    def empty_host(self, shape, like):
        dtype = _wire(like).dtype
        if self.gloo and like.is_cuda:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=like.device)

    def gather(self, x):
        """[x of axis index i] for every i, on x's device."""
        import torch.distributed as dist

        h = self.host(x)
        out = [self.empty_host(h.shape, x) for _ in range(self.n)]
        dist.all_gather(out, h, group=self.group)
        return [self.back(out[g], x) for g in self.grank]

    def exchange(self, chunks):
        """All-to-all: ``chunks[i]`` (equal shapes) goes to axis index i;
        returns what axis index i sent here, in axis order."""
        import torch.distributed as dist

        like = chunks[0]
        stacked = torch.stack([chunks[i] for i in self._by_grank()])
        h = self.host(stacked)
        out = self.empty_host(h.shape, like)
        dist.all_to_all_single(out, h, group=self.group)
        out = self.back(out, like)
        return [out[g] for g in self.grank]

    def _by_grank(self):
        """Axis indices in group-rank order."""
        order = [0] * self.n
        for i, g in enumerate(self.grank):
            order[g] = i
        return order

    def reduce(self, x, op):
        """The axis-wide sum / max / min of ``x``. NCCL reduces in place;
        under gloo each index reduces one chunk of the flattened tensor
        (an all-to-all, then the sum here in index order) and the chunks
        are all-gathered, so every index ends with the same bits."""
        import torch.distributed as dist

        if not self.gloo:
            y = x.contiguous().clone()
            dist.all_reduce(y, op=op, group=self.group)
            return y
        flat = x.reshape(-1)
        pad = -flat.numel() % self.n
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        mine = _combine(self.exchange(list(flat.view(self.n, -1))), op)
        out = torch.cat(self.gather(mine))
        return out[:x.numel()].view(x.shape)


def _wire(x):
    """Bool tensors travel as uint8 (same bytes)."""
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def _combine(parts, op):
    import torch.distributed as dist

    out = parts[0].clone()
    for p in parts[1:]:
        if op == dist.ReduceOp.SUM:
            out = out + p
        elif op == dist.ReduceOp.MAX:
            out = torch.maximum(out, p)
        else:
            out = torch.minimum(out, p)
    return out


def _sum(ctx, x):
    import torch.distributed as dist

    return ctx.reduce(x, dist.ReduceOp.SUM)


def _all_gather(ctx, x, dim, tiled):
    parts = ctx.gather(x)
    return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)


def _reduce_scatter(ctx, x, dim):
    import torch.distributed as dist

    enforce(x.shape[dim] % ctx.n == 0, "reduce_scatter: dim %s of size %s "
            "does not split over %s ranks", dim, x.shape[dim], ctx.n)
    chunks = list(x.chunk(ctx.n, dim))
    if not ctx.gloo:
        out = torch.empty_like(chunks[0].contiguous())
        stacked = torch.cat([chunks[i].contiguous().reshape(-1)
                             for i in ctx._by_grank()])
        dist.reduce_scatter_tensor(out.view(-1), stacked, group=ctx.group)
        return out
    got = ctx.exchange([c.contiguous() for c in chunks])
    return _combine(got, dist.ReduceOp.SUM)


def _all_to_all(ctx, x, split, concat):
    enforce(x.shape[split] % ctx.n == 0, "all_to_all: dim %s of size %s "
            "does not split over %s ranks", split, x.shape[split], ctx.n)
    got = ctx.exchange([c.contiguous() for c in x.chunk(ctx.n, split)])
    return torch.cat(got, concat)


def _ppermute(ctx, xs, perm):
    """Send each of ``xs`` to the axis index ``perm`` maps this one to;
    receive from the index that maps here (zeros where none does)."""
    import torch.distributed as dist

    dst = [d for s, d in perm if s == ctx.index]
    src = [s for s, d in perm if d == ctx.index]
    outs = [None] * len(xs)
    ops, recv = [], []
    for tag, x in enumerate(xs):
        if dst and dst[0] == ctx.index:
            outs[tag] = x.clone()
            continue
        if dst:
            ops.append(dist.P2POp(dist.isend, ctx.host(x),
                                  ctx.members[dst[0]], ctx.group, tag))
        if src:
            buf = ctx.empty_host(x.shape, x)
            ops.append(dist.P2POp(dist.irecv, buf, ctx.members[src[0]],
                                  ctx.group, tag))
            recv.append((tag, buf))
        else:
            outs[tag] = torch.zeros_like(x)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for tag, buf in recv:
        outs[tag] = ctx.back(buf, xs[tag])
    return outs


def _check_perm(perm, n):
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    enforce(len(set(srcs)) == len(srcs) and len(set(dsts)) == len(dsts)
            and all(0 <= i < n for i in srcs + dsts),
            "ppermute needs a permutation of axis indices in [0, %s), got "
            "%s", n, perm)
    return tuple(perm)


# --- differentiable forms ----------------------------------------------------

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, op):
        ctx.c, ctx.op = c, op
        if op == "max" or op == "min":
            import torch.distributed as dist

            return c.reduce(x, dist.ReduceOp.MAX if op == "max"
                            else dist.ReduceOp.MIN)
        y = _sum(c, x)
        return y / c.n if op == "mean" else y

    @staticmethod
    def backward(ctx, g):
        if ctx.op in ("max", "min"):
            raise UnimplementedError(
                f"allreduce op={ctx.op!r} has no gradient (JAX has no "
                f"differentiation rule for p{ctx.op})")
        y = _sum(ctx.c, g)
        return (y / ctx.c.n if ctx.op == "mean" else y), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, dim, tiled):
        ctx.c, ctx.dim, ctx.tiled = c, dim, tiled
        return _all_gather(c, x, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        if ctx.tiled:
            return _reduce_scatter(ctx.c, g, ctx.dim), None, None, None
        part = _reduce_scatter(ctx.c, g, ctx.dim)
        return part.squeeze(ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, dim):
        ctx.c, ctx.dim = c, dim
        return _reduce_scatter(c, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(ctx.c, g, ctx.dim, True), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, split, concat):
        ctx.c, ctx.split, ctx.concat = c, split, concat
        return _all_to_all(c, x, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(ctx.c, g, ctx.concat, ctx.split), None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c, perm, *xs):
        ctx.c, ctx.perm = c, perm
        return tuple(_ppermute(c, xs, perm))

    @staticmethod
    def backward(ctx, *gs):
        inv = tuple((d, s) for s, d in ctx.perm)
        return (None, None) + tuple(_ppermute(ctx.c, gs, inv))


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, src):
        import torch.distributed as dist

        ctx.c, ctx.src = c, src
        h = c.host(x)
        if c.index != src:
            h = h.clone()
        dist.broadcast(h, c.members[src], group=c.group)
        return c.back(h, x) if c.index != src else x.clone()

    @staticmethod
    def backward(ctx, g):
        total = _sum(ctx.c, g)
        return (total if ctx.c.index == ctx.src
                else torch.zeros_like(total)), None, None


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(ctx.c, g), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c):
        return _sum(c, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherAtUse(torch.autograd.Function):
    """All-gather along ``dim`` over the group ``c``; backward: the sum
    over ``reduce`` (the batch axes among the group's, or None for all
    of them), then this rank's chunk."""

    @staticmethod
    def forward(ctx, x, c, dim, reduce):
        ctx.c, ctx.dim, ctx.reduce, ctx.n = c, dim, reduce, x.shape[dim]
        return _all_gather(c, x, dim, True)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce is None:
            return _reduce_scatter(ctx.c, g.contiguous(), ctx.dim), \
                None, None, None
        if ctx.reduce:
            g = _sum(_Ctx(ctx.reduce, ctx.c.mesh), g)
        return (g.narrow(ctx.dim, ctx.c.index * ctx.n, ctx.n), None, None,
                None)


# --- the collectives ---------------------------------------------------------

def allreduce(x, axis: Axis = "dp", op: str = "sum", *, mesh=None):
    """The sum, mean, max or min of ``x`` over ``axis`` (``lax.psum`` and
    friends)."""
    enforce(op in ("sum", "mean", "max", "min"), "unknown allreduce op %s",
            op)
    c = _Ctx(axis, mesh)
    if c.group is None:
        return x
    return _AllReduce.apply(x, c, op)


def allgather(x, axis: Axis = "dp", tiled: bool = True, *, dim: int = 0,
              mesh=None):
    """Every index's ``x`` along ``axis``: concatenated along ``dim``
    (``tiled``) or stacked in a new dim ``dim`` (``lax.all_gather``)."""
    c = _Ctx(axis, mesh)
    if c.group is None:
        return x if tiled else x.unsqueeze(dim)
    return _AllGather.apply(x, c, dim, tiled)


def reduce_scatter(x, axis: Axis = "dp", scatter_dimension: int = 0, *,
                   mesh=None):
    """The sum over ``axis`` of ``x``, of which index i keeps chunk i of
    ``scatter_dimension`` (``lax.psum_scatter``, tiled)."""
    c = _Ctx(axis, mesh)
    if c.group is None:
        return x
    return _ReduceScatter.apply(x, c, scatter_dimension)


def all_to_all(x, axis: Axis, split_axis: int, concat_axis: int, *,
               mesh=None):
    """Chunk i of ``split_axis`` goes to index i; the chunks received are
    concatenated along ``concat_axis`` in index order (``lax.all_to_all``,
    tiled)."""
    c = _Ctx(axis, mesh)
    if c.group is None:
        return x
    return _AllToAll.apply(x, c, split_axis, concat_axis)


def ppermute(x, axis: Axis, perm, *, mesh=None):
    """``x`` from the index that ``perm`` ((src, dst) pairs of axis
    indices) sends here; zeros on an index no pair reaches
    (``lax.ppermute``). ``x`` may be a tuple of tensors, exchanged in one
    batch (a tuple comes back)."""
    many = isinstance(x, (tuple, list))
    xs = tuple(x) if many else (x,)
    c = _Ctx(axis, mesh)
    perm = _check_perm(perm, c.n)
    if c.group is None:
        out = tuple(t if perm else torch.zeros_like(t) for t in xs)
    else:
        out = _PPermute.apply(c, perm, *xs)
    return tuple(out) if many else out[0]


def broadcast(x, axis: Axis = "dp", src: int = 0, *, mesh=None):
    """Index ``src``'s ``x`` on every index of ``axis``."""
    c = _Ctx(axis, mesh)
    enforce(0 <= src < c.n, "broadcast src %s outside the axis (%s ranks)",
            src, c.n)
    if c.group is None:
        return x
    return _Broadcast.apply(x, c, src)


def axis_index(axis: Axis = "dp", *, mesh=None) -> int:
    """This rank's index along ``axis`` (``lax.axis_index``)."""
    return (mesh or get_mesh()).axis_index(axis)


def copy_to_tp(x, axis: Axis = "tp", *, mesh=None):
    """``x`` as it is; its gradient summed over ``axis`` (Megatron's
    copy to the tensor-parallel region: each rank's column shard gives
    part of the cotangent of a replicated input)."""
    c = _Ctx(axis, mesh)
    if c.group is None:
        return x
    return _CopyToTP.apply(x, c)


def reduce_from_tp(x, axis: Axis = "tp", *, mesh=None):
    """The sum of ``x`` over ``axis``; its gradient passed through as it
    is (Megatron's reduce from the tensor-parallel region: the ranks'
    row-parallel partial products make one output, whose cotangent every
    rank holds whole)."""
    c = _Ctx(axis, mesh)
    if c.group is None:
        return x
    return _ReduceFromTP.apply(x, c)


def sum_over(tensors, axes_of, mesh=None):
    """Each of ``tensors`` summed over its axes (``axes_of(i)``, empty for
    none) with one ``allreduce`` per (axes, dtype): the tensors of a
    group flattened into one buffer. Returns a new list."""
    out = list(tensors)
    groups = {}
    for i, t in enumerate(tensors):
        axes = axes_of(i)
        if axes:
            groups.setdefault((axes, t.dtype), []).append(i)
    for (axes, _), idx in groups.items():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        flat = allreduce(flat, axes, mesh=mesh)
        for i, part in zip(idx, flat.split(
                [tensors[i].numel() for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def gather_at_use(x, sharding):
    """The whole tensor of which ``x`` is this rank's shard under
    ``sharding`` (a ``NamedSharding``): all-gathered dim by dim. The
    backward gives this rank its shard's gradient: summed over the
    spec's axes that are data axes of the mesh (``Mesh.data_axes``:
    ranks there computed on different rows) and cut, without a sum,
    over the others (``tp``, ``ep``: ranks there computed the same
    rows, so each holds the whole cotangent)."""
    mesh = sharding.mesh
    data = set(mesh.data_axes)
    for dim, part in enumerate(sharding.spec):
        if part is None:
            continue
        c = _Ctx(part, mesh)
        if c.group is None:
            continue
        names = (part,) if isinstance(part, str) else tuple(part)
        batch = tuple(a for a in names if a in data
                      and mesh.shape[a] > 1)
        big = tuple(a for a in names if mesh.shape[a] > 1)
        reduce = None if batch == big else batch
        x = _GatherAtUse.apply(x, c, dim, reduce)
    return x
