"""Pipeline parallelism: a stage-partitioned microbatch pipeline over
``pp`` (counterpart of paddle_tpu/parallel/pipeline.py).

The repeated block's parameters are stacked along a leading layer axis;
a pp rank applies its chunk of layers to the activation it holds, then
the activations move one stage on by ``collective.ppermute``. Two
schedules, as in the JAX package:

- ``"gpipe"``: rank d holds one contiguous chunk of L/n layers; n + m - 1
  ticks stream m microbatches through n stages (bubble (n-1)/(n+m-1));
- ``"interleaved"``: rank d holds v round-robin chunks of L/(n v) layers
  (chunks d, n + d, 2n + d, ...), and microbatches go round the ring v
  times, injected in bursts of n (bubble (n-1)/(m v + n - 1) for n | m).

Multi-controller, one process per rank (core/mesh.py): the forward is
the JAX package's ``shard_map`` body run by every pp rank in lockstep,
and the backward is autograd through the collectives' own backward (the
reverse rotation of ``ppermute``), with no hand-written 1F1B engine. Two
transposes differ from a plain copy of the JAX body, because each pp
rank holds the pipeline's output and computes the same objective from it
(the JAX output is replicated over ``pp``):

- the output: the last stage's banked microbatches are broadcast to the
  pp ranks, and the backward takes the last stage's own cotangent (the
  others get zeros): summing the ranks' equal cotangents, as the
  broadcast's JAX transpose does for a program that holds ONE loss,
  would give every stage n times its gradient;
- the input: only stage 0 reads ``x``, and the JAX transpose of the
  replicated operand sums its cotangent over ``pp``, so ``x`` passes
  through ``collective.copy_to_tp`` over ``pp`` (identity forward, the
  sum backward): every pp rank gets stage 0's gradient and the
  replicated leaves before the pipeline stay equal across ``pp``.

One order of collectives: each rank runs the ring's ``ppermute`` on
every tick but the last (whose result nothing reads), fill and drain
ticks included. A rank's graph links every tick to the one before it
(the injection picks between the microbatch and the ring's state with
both in the graph, as ``jnp.where``; a tick where the rank's stage has
no microbatch passes zeros on with a zero gradient and computes
nothing, where the JAX body computes a clipped dummy), and the output's
broadcast takes the outputs of the banking ticks on every rank, so
autograd runs every ring hop's backward on every rank, in reverse tick
order. Take the gradient with ``backward()``: ``autograd.grad`` over a
subset of leaves prunes the hops of a rank's fill ticks, which its
neighbours still run. Inside a stage, the layers' tp and dp collectives run on the
ranks of that stage, which follow one schedule.

``stacked_params`` are the whole (L, ...) stack (the rank takes its
chunks; their backward all-gathers the gradient over ``pp``, so every
rank gets the whole stack's) or this rank's shard of a stack placed by
:func:`stage_param_sharding` (dim 0 over ``pp``; a placed leaf's other
dims may be split over ``tp``, and each layer's slice carries that
sharding, so the layers compute on their shard). Every block maps
activations of one shape to the same shape, the layer count divides by
n v, and the microbatches share one shape; ``x`` is this rank's rows
(the batch split over ``dp``, replicated over ``pp``)."""

from __future__ import annotations

from typing import Callable

import torch

from ..clip import tree_leaves, tree_map as _tmap
from ..core.enforce import enforce
from ..core.mesh import get_mesh
from ..core.sharding_types import NamedSharding, PartitionSpec as P


def _stack_to_stages(stacked_params, n_stages: int):
    """(L, ...) leaves -> (n_stages, L // n_stages, ...)."""
    return _tmap(lambda a: a.reshape(n_stages, a.shape[0] // n_stages,
                                     *a.shape[1:]), stacked_params)


def _interleave_to_stages(stacked_params, n: int, v: int):
    """LOGICAL-order (L, ...) leaves -> (n, v, L / (n v), ...): device d
    slot j holds chunk j n + d, the round-robin layout the interleaved
    schedule walks."""
    def reshape(a):
        k = a.shape[0] // (n * v)
        return a.reshape(v, n, k, *a.shape[1:]).transpose(0, 1)

    return _tmap(reshape, stacked_params)


def _ring_to_stages(stacked_params, n: int, v: int):
    """RING-order (L, ...) leaves -> (n, v, k, ...) by a reshape (ring
    order stores device d's chunks d, n + d, ... contiguously)."""
    return _tmap(lambda a: a.reshape(n, v, a.shape[0] // (n * v),
                                     *a.shape[1:]), stacked_params)


def ring_order_layers(stacked_params, n: int, v: int, *,
                      inverse: bool = False):
    """Permute a stacked (L, ...) tree between LOGICAL layer order and
    the interleaved schedule's RING order (each device's round-robin
    chunks contiguous), so a ``pp``-placed stack holds each rank's
    chunks; ``inverse=True`` maps ring order back to logical."""
    def perm(a):
        k = a.shape[0] // (n * v)
        lead = (n, v) if inverse else (v, n)
        return a.reshape(*lead, k, *a.shape[1:]).transpose(0, 1).reshape(
            a.shape)

    return _tmap(perm, stacked_params)


def gpipe_ticks(n: int, m: int) -> int:
    """GPipe schedule length in ticks (one tick = one L/n-layer stage)."""
    return n + m - 1


def interleaved_ticks(n: int, m: int, v: int) -> int:
    """Interleaved schedule length in ticks (one tick = one L/(n v)-layer
    chunk, 1/v of a GPipe tick); burst b of n microbatches starts at
    tick b v n."""
    bursts = -(-m // n)
    o_last = (m - 1) - (bursts - 1) * n
    return (bursts - 1) * v * n + o_last + (v - 1) * n + n


def bubble_fraction(n: int, m: int, schedule: str = "gpipe",
                    virtual_stages: int = 1) -> float:
    """Idle fraction of each device's timeline under the schedule."""
    enforce(schedule in ("gpipe", "interleaved"),
            "schedule must be 'gpipe' or 'interleaved', got %r", schedule)
    if schedule == "interleaved":
        t = interleaved_ticks(n, m, virtual_stages)
        return 1.0 - (m * virtual_stages) / t
    enforce(virtual_stages == 1,
            "gpipe schedule has no virtual stages (got %s)", virtual_stages)
    return 1.0 - m / gpipe_ticks(n, m)


def _aux_block_step(block_fn):
    """One aux-carrying block: ``(h, a), p -> (h', a + aux)`` with the aux
    summed in float32: the ONE definition the schedules and the
    sequential folds share."""
    def one_block(carry, p):
        h, a = carry
        h, al = block_fn(p, h)
        return h, a + al.float()

    return one_block


def _layer(params, i):
    """Layer ``i`` of a stacked tree: each leaf's row ``i``, carrying the
    leaf's sharding past the layer dim (a tp-split weight's layer is a tp
    shard, which the layers compute on)."""
    def row(a):
        r = a[i]
        sh = getattr(a, "_pt_layer_sharding", None)
        if sh is not None:
            r._pt_sharding = sh
            r._pt_global_shape = a._pt_layer_shape
        return r

    return _tmap(row, params)


def _fold(block_fn, params, h, layers, *, aux=None, remat=False):
    """Apply ``layers`` (indices into the stacked ``params``) in order;
    with ``aux`` the blocks return (h, aux) and the aux is summed. Each
    layer under ``nn.layer.remat_call`` when ``remat``."""
    from ..nn.layer import remat_call

    step = _aux_block_step(block_fn) if aux is not None else None
    for i in layers:
        p = _layer(params, i)
        if aux is None:
            h = (remat_call(lambda h_, p_=p: block_fn(p_, h_), h) if remat
                 else block_fn(p, h))
        else:
            h, aux = (remat_call(lambda h_, a_, p_=p: step((h_, a_), p_),
                                 h, aux) if remat else step((h, aux), p))
    return h if aux is None else (h, aux)


def microbatched_aux_fold(block_fn, stacked_params, x, *,
                          num_microbatches, aux_size, remat=True):
    """Sequential per-MICROBATCH fold of an aux-carrying block stack:
    ``(out (B, ...), aux_mean (aux_size,))``, the aux summed over the
    layers per microbatch and averaged over the microbatches: the
    definition every pipelined schedule computes (MoE routing is
    microbatch-local), used by the one-stage pipeline and the hybrid
    builders' sequential step."""
    m = num_microbatches
    L = tree_leaves(stacked_params)[0].shape[0]
    outs, auxes = [], []
    for mb in x.chunk(m, 0):
        a0 = torch.zeros(aux_size, dtype=torch.float32, device=x.device)
        h, a = _fold(block_fn, stacked_params, mb, range(L), aux=a0,
                     remat=remat)
        outs.append(h)
        auxes.append(a)
    return torch.cat(outs), torch.stack(auxes).mean(0)


# --- the ring's autograd pieces ----------------------------------------------

class _Pick(torch.autograd.Function):
    """``a`` if ``take_a`` else ``b``, both in the graph (``jnp.where``
    with a scalar condition): the unpicked side gets a zero cotangent."""

    @staticmethod
    def forward(ctx, take_a, a, b):
        other = b if take_a else a
        ctx.take_a = take_a
        ctx.other = (other.shape, other.dtype, other.device)
        return (a if take_a else b).clone()

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.other
        z = torch.zeros(shape, dtype=dtype, device=device)
        return None, (g if ctx.take_a else z), (z if ctx.take_a else g)


class _Idle(torch.autograd.Function):
    """A tick without a microbatch: zeros, linked to the ring's state with
    a zero gradient."""

    @staticmethod
    def forward(ctx, *xs):
        out = tuple(torch.zeros_like(x) for x in xs)
        return out if len(out) > 1 else out[0]

    @staticmethod
    def backward(ctx, *gs):
        return tuple(torch.zeros_like(g) for g in gs)


class _FromLast(torch.autograd.Function):
    """The last stage's tensors on every rank of the pp group ``c``
    (``src`` its index); the backward keeps the cotangent on ``src``
    only (the module docstring)."""

    @staticmethod
    def forward(ctx, c, src, *xs):
        import torch.distributed as dist

        ctx.mine = c.index == src
        out = []
        for x in xs:
            # a receiver's own (unbanked) tensor is only the graph's link
            h = c.host(x) if ctx.mine else c.empty_host(x.shape, x)
            dist.broadcast(h, c.members[src], group=c.group)
            out.append(x.clone() if ctx.mine else c.back(h, x))
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + tuple(
            g if ctx.mine else torch.zeros_like(g) for g in gs)


class _Cut(torch.autograd.Function):
    """This rank's ``rows`` of a whole stack (a replicated operand that
    the JAX body slices by ``P(pp)``); the backward all-gathers the pp
    ranks' row cotangents into the whole stack's gradient, on every
    rank (``rows_of``: each axis index's rows)."""

    @staticmethod
    def forward(ctx, whole, c, rows_of):
        ctx.c, ctx.rows_of, ctx.shape = c, rows_of, whole.shape
        return whole[rows_of[c.index]]

    @staticmethod
    def backward(ctx, g):
        from .collective import _all_gather

        parts = _all_gather(ctx.c, g.contiguous(), 0, False)
        full = g.new_zeros(ctx.shape)
        for rows, part in zip(ctx.rows_of, parts):
            full[rows] = part
        return full, None, None


def _stage_rows(L: int, n: int, v: int, d: int, schedule: str,
                ring: bool):
    """The layer rows rank ``d`` applies, in its local order (chunk j at
    rows [j k, (j + 1) k))."""
    if schedule == "gpipe" or v == 1:
        per = L // n
        return list(range(d * per, (d + 1) * per))
    k = L // (n * v)
    if ring:
        return list(range(d * v * k, (d + 1) * v * k))
    return [(j * n + d) * k + i for j in range(v) for i in range(k)]


def _local_stack(leaf, c, axis, n, v, schedule, ring):
    """This rank's layers of one stacked leaf, its chunks in local order,
    each layer's sharding past the layer dim attached for :func:`_layer`
    (``_pt_layer_sharding``, ``_pt_layer_shape``)."""
    from .collective import gather_at_use

    sh = getattr(leaf, "_pt_sharding", None)
    placed = sh is not None and len(sh.spec) and sh.spec[0] == axis
    whole_shape = tuple(getattr(leaf, "_pt_global_shape", leaf.shape))
    L = whole_shape[0]
    mine = placed and (schedule == "gpipe" or v == 1 or ring)
    if mine:
        local = leaf
    else:
        if placed:
            # a logical-order stack placed over pp under the interleaved
            # schedule: the rank's rows are another rank's shard (the JAX
            # package's reshard of a logical stack, every step)
            leaf = gather_at_use(leaf, NamedSharding(sh.mesh, P(axis)))
        rows_of = [_stage_rows(L, n, v, d, schedule, ring)
                   for d in range(n)]
        local = (leaf[rows_of[c.index]] if c.group is None
                 else _Cut.apply(leaf, c, rows_of))
    if sh is not None and any(p is not None for p in sh.spec[1:]):
        local._pt_layer_sharding = NamedSharding(sh.mesh, P(*sh.spec[1:]))
        local._pt_layer_shape = whole_shape[1:]
    return local


def _check(stacked_params, x, n, m, schedule, v, ring):
    enforce(schedule in ("gpipe", "interleaved"),
            "schedule must be 'gpipe' or 'interleaved', got %r", schedule)
    enforce(v >= 1, "virtual_stages must be >= 1, got %s", v)
    if schedule == "gpipe":
        enforce(v == 1, "gpipe schedule has no virtual stages; use "
                "schedule='interleaved' with virtual_stages=%s", v)
    leaves = tree_leaves(stacked_params)
    enforce(leaves, "stacked_params must be a non-empty pytree")
    Ls = [tuple(getattr(a, "_pt_global_shape", a.shape))[0] for a in leaves]
    L = Ls[0]
    enforce(all(l == L for l in Ls),
            "all stacked_params leaves must share leading layer dim %s", L)
    enforce(L % (n * v) == 0,
            "layer count %s must divide pp size x virtual stages (%s x %s)",
            L, n, v)
    B = x.shape[0]
    enforce(B % m == 0, "num_microbatches %s must divide batch size %s",
            m, B)
    enforce(not ring or (schedule == "interleaved" and v > 1),
            "layers_in_ring_order only applies to the interleaved "
            "schedule with virtual_stages > 1")
    return L


def _schedule(n, m, v, schedule, d):
    """[(tick, (active, fresh, chunk, microbatch, bank))] of rank ``d``:
    whether it has a microbatch at the tick, whether it injects it from
    ``x``, the local chunk it applies, the microbatch, and whether the
    last stage banks the result (the JAX tick arithmetic)."""
    out = []
    if schedule == "gpipe" or v == 1:
        for t in range(n + m - 1):
            mb = t - d
            active = 0 <= mb < m
            out.append((t, (active, d == 0, 0, mb,
                            active and d == n - 1)))
        return out
    for t in range(interleaved_ticks(n, m, v)):
        s = max(t - d, 0)
        r = s % (v * n)
        j = r // n
        mb = (s // (v * n)) * n + r % n
        active = t >= d and mb < m
        out.append((t, (active, d == 0 and j == 0, j, mb,
                        active and d == n - 1 and j == v - 1)))
    return out


def _bank_ticks(n, m, v, schedule):
    """{microbatch: the tick the last stage banks it at}."""
    return {mb: t for t, (_, _, _, mb, bank) in
            _schedule(n, m, v, schedule, n - 1) if bank}


def pipeline_apply(block_fn: Callable, stacked_params, x, *,
                   num_microbatches: int, axis: str = "pp", mesh=None,
                   remat: bool = True, schedule: str = "gpipe",
                   virtual_stages: int = 1,
                   layers_in_ring_order: bool = False,
                   aux_size: int = 0):
    """Run this rank's ``x`` (B, ...) through ``L`` stacked layers as an
    n-stage pipeline over ``axis``; returns the pipelined equivalent of
    folding ``block_fn`` over all L layers, on every pp rank.

    - ``block_fn(params_l, h) -> h`` applies ONE layer (uniform shape);
      ``params_l`` holds each stacked leaf's row l.
    - ``stacked_params``: the whole (L, ...) stack or this rank's shard
      of a placed one (the module docstring).
    - ``schedule``: ``"gpipe"`` or ``"interleaved"`` with
      ``virtual_stages`` v (L % (n v) == 0); ``layers_in_ring_order``:
      the stack is in :func:`ring_order_layers`'s order (a placed stack
      then holds each rank's chunks, no reshard per step).
    - ``remat``: each stage's chunk application recomputed in the
      backward (``nn.layer.remat_call``).
    - ``aux_size`` > 0: ``block_fn(params_l, h) -> (h, aux)`` with
      ``aux`` a float32 (aux_size,) vector a layer; each microbatch's
      aux rides the ring with its activation, summed over the layers,
      and the return is ``(out, aux_mean)``, the mean over the
      microbatches of their sums (each microbatch routes on its own).

    With one pp rank the pipeline is the sequential fold (per
    microbatch when ``aux_size`` > 0)."""
    from ..nn.layer import remat_call
    from .collective import _Ctx, copy_to_tp, ppermute

    mesh = mesh or get_mesh()
    n = mesh.size_of(axis)
    m = int(num_microbatches)
    v = int(virtual_stages)
    ring = bool(layers_in_ring_order)
    L = _check(stacked_params, x, n, m, schedule, v, ring)
    c = _Ctx(axis, mesh)
    idx = mesh.axis_index(axis) if axis in mesh.shape else 0
    local = _tmap(lambda a: _local_stack(a, c, axis, n, v, schedule, ring),
                  stacked_params)
    has_aux = aux_size > 0
    if n == 1:
        if has_aux:
            h, aux = microbatched_aux_fold(
                block_fn, local, x, num_microbatches=m, aux_size=aux_size,
                remat=remat)
            return h.to(x.dtype), aux
        return _fold(block_fn, local, x, range(L), remat=remat).to(x.dtype)

    k = L // (n * v) if (schedule == "interleaved" and v > 1) else L // n

    def stage(j, h, *a):
        return _fold(block_fn, local, h, range(j * k, (j + 1) * k),
                     aux=a[0] if a else None)

    x = copy_to_tp(x, axis, mesh=mesh)
    x_mb = x.chunk(m, 0)
    grad = torch.is_grad_enabled()
    state = [x_mb[0].new_zeros(x_mb[0].shape)]
    if has_aux:
        state.append(torch.zeros(aux_size, dtype=torch.float32,
                                 device=x.device))
    if grad:
        # every tick's output requires grad on every rank, so every
        # rank's ring hops enter the graph
        state = [s.requires_grad_() for s in state]
    perm = ([(i, i + 1) for i in range(n - 1)]
            if schedule == "gpipe" or v == 1
            else [(i, (i + 1) % n) for i in range(n)])
    ticks = _schedule(n, m, v, schedule, idx)
    banked = {t: mb for mb, t in _bank_ticks(n, m, v, schedule).items()}
    outs = {}
    for t, (active, fresh, j, mb, _) in ticks:
        if active:
            inp = [_Pick.apply(fresh, x_mb[mb], state[0])]
            if has_aux:
                inp.append(_Pick.apply(fresh, torch.zeros_like(state[1]),
                                       state[1]))
            out = (remat_call(stage, j, *inp) if remat and grad
                   else stage(j, *inp))
            out = list(out) if has_aux else [out]
        else:
            out = _Idle.apply(*state)
            out = list(out) if has_aux else [out]
        if t in banked:
            outs[banked[t]] = out
        if t < len(ticks) - 1:
            state = list(ppermute(tuple(out), axis, perm, mesh=mesh))
    bank = [torch.stack([outs[i][s] for i in range(m)])
            for s in range(len(state))]
    bank = _FromLast.apply(c, n - 1, *bank)
    h = bank[0].reshape(x.shape).to(x.dtype)
    return (h, bank[1].mean(0)) if has_aux else h


def stage_param_sharding(stacked_params, n_stages: int, axis: str = "pp",
                         mesh=None):
    """The ``NamedSharding`` of each stacked (L, ...) leaf that gives pp
    rank d its own chunk and nothing else (dim 0 split over ``axis``;
    place with ``parallel.sharding.place``). The JAX package returns the
    shardings of the (n, L/n, ...) staged view; a rank's shard is the
    same rows."""
    mesh = mesh or get_mesh()
    enforce(mesh.size_of(axis) == n_stages,
            "stage_param_sharding: %s stages on a mesh whose %r axis has "
            "%s ranks", n_stages, axis, mesh.size_of(axis))
    return _tmap(lambda a: NamedSharding(
        mesh, P(axis, *([None] * (a.dim() - 1)))), stacked_params)


class GPipe:
    """Pipeline a uniform stack of blocks: ``blocks`` are structurally
    identical Layers whose parameters are stacked along a new leading
    axis (``nn.layer.stacked_parameters``) and fed to
    :func:`pipeline_apply`."""

    def __init__(self, blocks, *, num_microbatches: int, axis: str = "pp",
                 mesh=None, remat: bool = True, schedule: str = "gpipe",
                 virtual_stages: int = 1):
        enforce(len(blocks) > 0, "GPipe needs at least one block")
        self.blocks = list(blocks)
        self.num_microbatches = num_microbatches
        self.axis = axis
        self.mesh = mesh
        self.remat = remat
        self.schedule = schedule
        self.virtual_stages = virtual_stages
        self._template = self.blocks[0]

        def _block_fn(p, h, _t=self._template):
            out, _ = _t.functional_call(p, h)
            return out

        self._block_fn = _block_fn

    def stacked_params(self):
        from ..nn.layer import stacked_parameters

        return stacked_parameters(self.blocks)

    def __call__(self, x, stacked_params=None):
        params = (self.stacked_params() if stacked_params is None
                  else stacked_params)
        return pipeline_apply(self._block_fn, params, x,
                              num_microbatches=self.num_microbatches,
                              axis=self.axis, mesh=self.mesh,
                              remat=self.remat, schedule=self.schedule,
                              virtual_stages=self.virtual_stages)
