"""The ranks' halves of tests/test_torch_pipeline.py and
test_torch_hybrid.py (not collected: no ``test_`` prefix): each job runs
on every rank of a tests/torch_world.py world of 4 gloo ranks and
returns what the parent holds against the JAX package. Like
torch_world.py, it imports neither JAX nor the JAX package."""

from __future__ import annotations

import numpy as np
import torch

import torch_world as W


def tanh_block(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def tanh_block_w(p, h):
    return torch.tanh(h @ p["w"])


def aux_block(p, h):
    """tests/test_moe_pipeline.py's block: its aux depends on the
    microbatch's content (a wrong microbatch/aux pairing shows)."""
    h2 = h + p["w"]
    return h2, torch.stack([h2.sum(), h2.max()])


BLOCKS = {"tanh": tanh_block, "tanh_w": tanh_block_w, "aux": aux_block}


def _gather_pp(g, leaf, m):
    """The whole stack of the gradient ``g`` of a ``pp``-placed ``leaf``
    (or ``g`` itself)."""
    from paddle_tpu_torch.parallel import sharding as S
    from paddle_tpu_torch.parallel.collective import allgather

    if S.sharding_of(leaf) is None or m.size_of("pp") == 1:
        return g
    return allgather(g, "pp", dim=0, mesh=m)


def job_pipeline(sizes, block, params, x, m, schedule="gpipe", v=1,
                 placed=False, ring=False, aux_size=0, remat=True):
    """pipeline_apply on this rank: the stack whole (``params``, logical
    order) or placed by stage_param_sharding (``placed``; in ring order
    when ``ring``), ``x`` split over ``dp``. The objective is the global
    batch's sum(out ** 2) / B (plus the aux terms); returns this rank's
    output rows, the aux, the input's gradient rows and each stacked
    leaf's gradient summed over dp, whole, in the order given."""
    from paddle_tpu_torch.parallel import pipeline as PL
    from paddle_tpu_torch.parallel import sharding as S
    from paddle_tpu_torch.parallel.collective import allreduce

    mesh = W.mesh(**sizes)
    n = mesh.size_of("pp")
    stack = {k: torch.from_numpy(np.array(a)) for k, a in params.items()}
    if ring:
        stack = PL.ring_order_layers(stack, n, v)
    stack = {k: a.clone().requires_grad_() for k, a in stack.items()}
    if placed:
        shs = PL.stage_param_sharding(stack, n, mesh=mesh)
        for k in stack:
            S.place(stack[k], shs[k])
    xt = W.local(x, mesh, ("dp",)).requires_grad_()
    fn = BLOCKS[block]
    with torch.enable_grad():
        out = PL.pipeline_apply(fn, stack, xt, num_microbatches=m,
                                mesh=mesh, schedule=schedule,
                                virtual_stages=v, layers_in_ring_order=ring,
                                aux_size=aux_size, remat=remat)
        aux = None
        if aux_size:
            out, aux = out
        loss = (out ** 2).sum() / x.shape[0]
        if aux_size:
            loss = loss + aux.sum() * 0.1
        loss.backward()
    grads = {}
    for k, a in stack.items():
        g = _gather_pp(a.grad, a, mesh)
        g = allreduce(g, "dp", mesh=mesh)
        if ring:
            g = PL.ring_order_layers(g, n, v, inverse=True)
        grads[k] = W.host(g)
    return dict(out=W.host(out), aux=W.host(aux), dx=W.host(xt.grad),
                grads=grads, shapes={k: tuple(a.shape)
                                     for k, a in stack.items()})


def job_gpipe_layers(sizes, state, x, m):
    """GPipe over port Linear(D, D, act="tanh") blocks loaded with
    ``state`` ({name: (L, ...)}): its output on this rank's rows."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.parallel import GPipe

    mesh = W.mesh(**sizes)
    L, D = state["weight"].shape[:2]
    blocks = [tnn.Linear(D, D, act="tanh", device="cpu") for _ in range(L)]
    with torch.no_grad():
        for i, blk in enumerate(blocks):
            blk.weight.copy_(torch.from_numpy(np.array(state["weight"][i])))
            blk.bias.copy_(torch.from_numpy(np.array(state["bias"][i])))
    gp = GPipe(blocks, num_microbatches=m, mesh=mesh)
    with torch.no_grad():
        out = gp(W.local(x, mesh, ("dp",)))
    return W.host(out)


# --- test_torch_hybrid.py ----------------------------------------------------

def _whole_tree(tree):
    """Each leaf whole (its shards all-gathered over its spec's axes, by
    every rank), on the host."""
    from paddle_tpu_torch.nn.layer import use

    with torch.no_grad():
        return {k: W.host(use(v)) for k, v in tree.items()}


def _flash_calls(A, calls):
    """Wrap ``ops.attention._flash_fns`` so each flash forward, dq and
    dk/dv call adds (kind, q heads, kv heads) to ``calls``."""
    orig = A._flash_fns

    def fns(interpret):
        out = []
        for kind, f in zip(("fwd", "dq", "dkv"), orig(interpret)):
            def call(q, k, *a, _f=f, _kind=kind, **kw):
                calls.append((_kind, q.shape[2], k.shape[2]))
                return _f(q, k, *a, **kw)
            out.append(call)
        return tuple(out)

    A._flash_fns = fns
    return orig


def job_hybrid(kind, sizes, kw, steps=2, arrays=None, flash=False):
    """``steps`` pipelined SGD steps of the port's hybrid builder
    ``kind`` (transformer, bert, gpt) on this rank, from ``arrays`` (the
    JAX builder's params, numpy; the port's own weights when None), and
    one step of its ``ref_step`` from the same params; with ``flash`` the
    attention runs the flash entry points (their plain versions on the
    CPU) and the pipelined steps' calls are recorded with their heads.
    Returns the initial whole params (rank 0), per step the loss and the
    whole params (rank 0), the ref step's, this rank's mesh coordinate
    and its unsharded "rest" leaves (for the pp check)."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.parallel import hybrid as H
    from paddle_tpu_torch.parallel import sharding as S
    from paddle_tpu_torch.utils.convert import hybrid_params

    mesh = W.mesh(**sizes)
    build = {"transformer": H.build_hybrid_transformer_step,
             "bert": H.build_bert_hybrid_step,
             "gpt": H.build_gpt_hybrid_step}[kind]
    kw = dict(kw)
    cfg = kw.pop("cfg", None)
    if cfg is not None:
        from paddle_tpu_torch.models import bert, gpt

        kw["cfg"] = (gpt.GPTConfig if kind == "gpt"
                     else bert.BertConfig)(**cfg)
    if kind == "transformer":
        step, params, feed = build(mesh, **kw)
        ref_step = None
    else:
        step, ref_step, params, feed = build(mesh, **kw)
    if arrays is not None:
        params = hybrid_params(arrays, params)
    rank0 = mesh.rank == 0

    def flat(p):
        return p if kind == "transformer" else {
            f"{g}/{k}": v for g in p for k, v in p[g].items()}

    def whole(p):
        w = _whole_tree(flat(p))             # every rank gathers
        return w if rank0 else None

    init = whole(params)
    calls = []
    orig = _flash_calls(A, calls) if flash else None
    try:
        with A.force_flash(flash):
            out, p = [], params
            for _ in range(steps):
                loss, p = step(p, *feed)
                out.append((float(loss), whole(p)))
            n_calls = {c: sum(1 for k, *_ in calls if k == c)
                       for c in ("fwd", "dq", "dkv")}
            ref = None
            if ref_step is not None:
                loss, rp = ref_step(params, *feed)
                ref = (float(loss), whole(rp))
    finally:
        if orig is not None:
            A._flash_fns = orig
    rest = {} if kind == "transformer" else {
        k: W.host(v) for k, v in p["rest"].items()
        if S.sharding_of(v) is None}
    return dict(init=init, steps=out, ref=ref,
                coordinate=dict(mesh.coordinate), rest=rest,
                calls=sorted(set(calls)), n_calls_step=n_calls)
