"""The ranks' halves of tests/test_torch_sharded_embedding.py and
tests/test_torch_embedding_plane.py (not collected: no ``test_``
prefix): each job runs on every rank of a tests/torch_world.py world of
4 gloo ranks, takes its share of the seeded global arrays it is given
and returns what the parent holds against the JAX package. Like
torch_world.py, it imports neither JAX nor the JAX package."""

from __future__ import annotations

import numpy as np
import torch

import torch_world as W

TABLES = r"(embedding|linear_embed)\.weight$"


def _placed(whole, m, grad=False):
    """The rank's rows of the global table ``whole`` over ep, marked as a
    plan's placed shard."""
    from paddle_tpu_torch.core.sharding_types import NamedSharding
    from paddle_tpu_torch.core.sharding_types import PartitionSpec as P
    from paddle_tpu_torch.parallel import sharding as S

    t = W.local(whole, m, ("ep", None)).requires_grad_(grad)
    return S.mark(t, NamedSharding(m, P("ep", None)), whole.shape)


def _rows(x, m):
    """The rank's rows of ``x`` over dp (all of them at dp=1)."""
    return W.local(x, m, ("dp",) if m.shape["dp"] > 1 else ())


def job_lookup(sizes, table, ids, cot, padding_idx=None):
    """sharded_embedding_lookup of the rank's ids on its rows of
    ``table``, and the gradient of sum(out * cot) with respect to its
    rows (the parent sums the dp ranks' and puts the ep rows in
    order)."""
    from paddle_tpu_torch.parallel import sharded_embedding_lookup

    m = W.mesh(**sizes)
    t = _placed(table, m, grad=True)
    with torch.enable_grad():
        out = sharded_embedding_lookup(_rows(ids, m).long(), t, mesh=m,
                                       padding_idx=padding_idx)
        (out * _rows(cot, m)).sum().backward()
    return dict(out=W.host(out), grad=W.host(t.grad),
                coordinate=dict(m.coordinate))


def job_layer(sizes, seed, ids):
    """A ShardedEmbedding(64, 8) placed by its weight_sharding: its
    forward on the rank's ids, its whole weight, its local shape and the
    spec."""
    from paddle_tpu_torch.core.random import seed as set_seed
    from paddle_tpu_torch.parallel import ShardedEmbedding
    from paddle_tpu_torch.parallel import sharding as S

    m = W.mesh(**sizes)
    set_seed(seed)
    emb = ShardedEmbedding(64, 8, mesh=m, device="cpu")
    whole = W.host(emb.weight)
    S.place(emb.weight, emb.weight_sharding())
    with torch.no_grad():
        out = emb(_rows(ids, m).long())
    return dict(out=W.host(out), whole=whole,
                local=tuple(emb.weight.shape),
                spec=tuple(emb.weight_sharding().spec))


def _deepfm(cfg, state):
    from paddle_tpu_torch.models import deepfm as TD
    from paddle_tpu_torch.utils.convert import load_numpy_state

    model = TD.DeepFM(TD.DeepFMConfig(**cfg), device="cpu")
    load_numpy_state(model, state)
    return model


def _labels(ids):
    return (ids[:, 0] % 2).float()


def job_deepfm_plan(cfg, state, ids, dense, steps, lr):
    """DeepFM (``cfg``) trained ``steps`` Adam(lr) steps through
    Trainer(plan=Plan(dp=2, ep=2, tables=...)) on the rank's rows: the
    losses, the whole parameters after each step (rank 0), step 1's
    gradients of the tables (the rank's rows) and the tables' local
    shape."""
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.models import deepfm as TD
    from paddle_tpu_torch.parallel import Plan, Trainer

    model = _deepfm(cfg, state)
    plan = Plan(dp=2, ep=2, tables=[TABLES], device="cpu")

    def builder(m, batch, gen):
        logits = m(batch["ids"], batch["dense"])
        return TD.loss_fn(logits, _labels(batch["ids"])), {}

    tr = Trainer(model, TO.Adam(lr), builder, plan=plan)
    sh = tr.data_sharding()
    batch = {"ids": sh.local(torch.from_numpy(np.array(ids))).long(),
             "dense": sh.local(torch.from_numpy(np.array(dense)))}
    out, grads = [], None
    for _ in range(steps):
        loss, _ = tr.train_step(batch)
        if grads is None:
            # the table leaves' gradients of step 1 (the rank's rows,
            # reduced over dp as the optimizer saw them)
            grads = {n: W.host(p.grad) for n, p in model.named_parameters()
                     if n.endswith("weight") and "embed" in n}
        whole = W._whole(model)
        out.append((float(loss), whole if plan.mesh.rank == 0 else None))
    return dict(steps=out, local=tuple(model.embedding.weight.shape),
                via=tr._jit_step.compiled_via, grads=grads,
                coordinate=dict(plan.mesh.coordinate))


def job_sparse_update(sizes, opt, table, ids, grads, compress, inf_dp=None,
                      key=None):
    """sparse_ep_update of the rank's rows of ``table`` (placed over ep)
    with its rows of ``ids`` and ``grads`` (over dp), ``opt`` an
    optimizer by name and arguments (lr first): the table's and each
    row-wise state leaf's rows after the update. ``inf_dp``: the dp
    index whose rows' first gradient entry is inf (on both its ep
    ranks, which hold the same rows); ``key``: JAX key data for
    stochastic rounding."""
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.embedding import sparse_ep_update

    m = W.mesh(**sizes)
    t = _placed(table, m)
    o = getattr(TO, opt[0])(*opt[1:])
    st = o.init_leaf(t)
    g = _rows(grads, m).clone()
    if m.coordinate["dp"] == inf_dp:
        g[0, 0] = float("inf")
    new, new_st = sparse_ep_update(
        o, t, _rows(ids, m).long(), g, st, opt[1], 0, mesh=m,
        compress=compress,
        key=None if key is None else np.asarray(key, np.uint32))
    return dict(table=W.host(new),
                state={k: W.host(v) for k, v in new_st.items()
                       if torch.is_tensor(v) and v.ndim
                       and v.shape[0] == t.shape[0]},
                coordinate=dict(m.coordinate))


def job_sparse_plan(cfg, state, batches, lr, compress):
    """DeepFM (``cfg``, sparse tables) trained through
    sparse_ep_minimize_fn under Plan(dp=2, ep=2, tables=...) with
    Adam(lr), one step a batch of ``batches`` (global (ids, dense)), on
    the rank's rows: the losses, then the whole parameters (rank 0), the
    tables' rows and the bytes the exchange recorded."""
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.embedding import sparse_ep_minimize_fn
    from paddle_tpu_torch.models import deepfm as TD
    from paddle_tpu_torch.parallel import Plan
    from paddle_tpu_torch.quant.collectives import _comm_metrics

    model = _deepfm(cfg, state)
    plan = Plan(dp=2, ep=2, tables=[TABLES], device="cpu")
    params = plan.place(dict(model.named_parameters()))

    def forward_loss(p, ids, dense):
        logits, _ = model.functional_call(p, ids, dense)
        return TD.loss_fn(logits, _labels(ids))

    init_fn, step_fn = sparse_ep_minimize_fn(model, forward_loss,
                                             TO.Adam(lr), plan=plan,
                                             compress=compress)
    st = init_fn(params)
    sh = plan.batch_sharding()
    losses = []
    telemetry.enable()
    try:
        met = _comm_metrics()
        before = (met["bytes_int8"].value, met["bytes_fp32"].value)
        for ids, dense in batches:
            loss, params, st = step_fn(
                params, st, sh.local(torch.from_numpy(np.array(ids))).long(),
                sh.local(torch.from_numpy(np.array(dense))))
            losses.append(float(loss))
        recorded = (met["bytes_int8"].value - before[0],
                    met["bytes_fp32"].value - before[1])
    finally:
        telemetry.disable()
    whole = W._whole(model)
    moments = {n: {k: W.host(v) for k, v in s.items() if torch.is_tensor(v)
                   and v.ndim} for n, s in st["sparse"].items()}
    return dict(losses=losses, params=whole if plan.mesh.rank == 0 else None,
                moments=moments, recorded=recorded,
                coordinate=dict(plan.mesh.coordinate))


def job_from_array(table):
    """HostBackedTable.from_array of the rank's placed rows of ``table``
    over ep=4: its host rows and a lookup on the CPU."""
    from paddle_tpu_torch.embedding import HostBackedTable

    m = W.mesh(ep=4)
    t = HostBackedTable.from_array(_placed(table, m), capacity=4,
                                   device="cpu")
    return t.rows, W.host(t.lookup(np.array([0, 63, 17]))), t.device_bytes


def job_prefetcher(kw, batches):
    """DevicePrefetcher onto the dp=2 x ep=2 mesh (``kw``: "mesh" or
    "sharding", and stage_per_shard): the rank's staged batches and what
    the prefetch_rows hook saw."""
    from paddle_tpu_torch.core.sharding_types import NamedSharding
    from paddle_tpu_torch.core.sharding_types import PartitionSpec as P
    from paddle_tpu_torch.data.device_loader import DevicePrefetcher

    m = W.mesh(dp=2, ep=2)
    args = dict(kw)
    if args.pop("place") == "mesh":
        args["mesh"] = m
    else:
        args["sharding"] = NamedSharding(m, P("dp"))
    seen = []
    pref = DevicePrefetcher(batches, size=2,
                            prefetch_rows=lambda b: seen.append(
                                b["ids"].shape), **args)
    staged = [{k: W.host(v) for k, v in b.items()} for b in pref]
    return dict(staged=staged, seen=seen, per_shard=pref.stage_per_shard,
                coordinate=dict(m.coordinate))


def job_plan_place(table):
    """Plan(dp=2, ep=2, tables=[emb.weight]).place on this rank: each
    leaf's local rows and spec."""
    from paddle_tpu_torch.parallel import Plan
    from paddle_tpu_torch.parallel import sharding as S

    plan = Plan(dp=2, ep=2, tables=[r"emb\.weight$"], device="cpu")
    placed = plan.place({"emb.weight": torch.from_numpy(np.array(table)),
                         "fc.w": torch.zeros(8)})
    return {n: (W.host(t), None if S.sharding_of(t) is None
                else tuple(S.sharding_of(t).spec))
            for n, t in placed.items()}, dict(plan.mesh.coordinate)
