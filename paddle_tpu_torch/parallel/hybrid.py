"""Composed parallelism: dp x tp x pp on one mesh (counterpart of
paddle_tpu/parallel/hybrid.py).

- **dp**: each rank takes its rows of the batch; the loss is the global
  batch's (``context_parallel.token_mean``) and the gradients are
  averaged over ``dp``.
- **tp**: Megatron's column/row pairs inside each block, from
  ``transformer_tp_rules`` on the stacked leaves (the rule shifted past
  the layer dim) and on the embedding and head; each layer's slice
  carries its tp sharding, so attention and the FFNs compute on the
  rank's heads and columns (parallel/sharding.py ``tp_pair``), and the
  vocab tables gather at use.
- **pp**: the block stack is pipelined by
  :func:`~paddle_tpu_torch.parallel.pipeline.pipeline_apply` (remat per
  stage), its leaves stacked (L, ...) and placed over ``pp`` (ring order
  under the interleaved schedule, so a rank's chunks are its shard).

Each builder returns ``(step, ref_step, params, feed)`` as the JAX ones
do (the transformer builder ``(step, params, (x, y))``): ``step(params,
*feed) -> (loss, new_params)`` is the plain SGD update ``w - lr * g``
over the pipelined loss, ``ref_step`` the same over the sequential fold
(the rank all-gathers the stack over ``pp`` and applies the layers in
logical order; its backward cuts the rank's rows again), ``params``
``{"layers": stacked, "rest": ...}`` this rank's shards (each placed leaf
carries its ``_pt_sharding``), and ``feed`` the rank's rows over ``dp``.
Each step also has ``.value_and_grad(params, *feed) -> (loss, grads)``,
the gradients in the params' structure and layout, and ``.update(params,
grads)``, the SGD update it applies.

The rows: ``feed`` holds, for each microbatch, this dp rank's share of
the JAX microbatch (microbatch i is the global rows [i B/m, (i + 1)
B/m), split over ``dp``), so the tokens a microbatch gathers over
``dp`` (a Switch-MoE FFN routes the global microbatch) are the JAX
microbatch's, in order. The weights are built on the CPU from ``seed``
(the same values whatever the mesh: a one-rank build is the unsharded
reference), then each rank keeps its shards on ``mesh.device`` (the
model's own parameters stay on the host; its buffers move);
``utils.convert.hybrid_params`` loads a JAX builder's weights instead."""

from __future__ import annotations

import numpy as np
import torch

from ..core.enforce import enforce
from ..core.mesh import mesh_scope
from ..core.sharding_types import NamedSharding, PartitionSpec as P
from . import sharding as S
from .pipeline import microbatched_aux_fold, pipeline_apply, ring_order_layers


def _check_mesh(mesh):
    for ax in ("dp", "tp", "pp"):
        enforce(ax in mesh.shape, "hybrid mesh needs axis %r", ax)


def _microbatch_rows(a, mesh, num_microbatches: int):
    """This dp rank's rows of the global batch ``a`` (leading dim B): for
    each microbatch, the rank's slice of the JAX microbatch (the module
    docstring)."""
    n_dp = mesh.size_of("dp")
    d = mesh.coordinate.get("dp", 0)
    m = num_microbatches
    b = a.shape[0] // (m * n_dp)
    idx = np.concatenate([np.arange(i * n_dp * b + d * b,
                                    i * n_dp * b + (d + 1) * b)
                          for i in range(m)])
    return a[idx]


def _leaf(value, sharding, device):
    """A trainable leaf of ``value`` (CPU) cut to this rank's shard under
    ``sharding``, on ``device``."""
    t = torch.nn.Parameter(value.detach().clone())
    S.place(t, sharding, device=device)
    return t


def _place_hybrid_params(mesh, stacked, rest, rules, ring, n_pp,
                        virtual_stages):
    """Ring-order the stack when the interleaved schedule needs it, infer
    the tp/ep specs of ``rest`` and of the stacked leaves (``pp`` on the
    layer dim, the rule shifted past it), and cut every leaf to this
    rank's shard on ``mesh.device``: ``{"layers": ..., "rest": ...}``."""
    if ring:
        stacked = ring_order_layers(stacked, n_pp, virtual_stages)
    rest_spec = S.infer_param_spec(rest, rules, mesh)
    stacked_spec = {
        name: P("pp", *spec) for name, spec in S.infer_param_spec(
            {n: v[0] for n, v in stacked.items()}, rules, mesh).items()}

    def put(tree, spec_map, default):
        return {n: _leaf(v, NamedSharding(mesh, spec_map.get(n, default)),
                         mesh.device) for n, v in tree.items()}

    return {"layers": put(stacked, stacked_spec, P("pp")),
            "rest": put(rest, rest_spec, P())}


def _whole_stack(layers, mesh):
    """The whole (L, ...) stack from this rank's ``pp`` shard (all-gathered
    over ``pp``, the backward cutting the rank's rows), each leaf's tp
    sharding past the layer dim kept for the layers."""
    from .collective import gather_at_use

    out = {}
    for name, t in layers.items():
        sh = S.sharding_of(t)
        w = t
        if mesh.size_of("pp") > 1:
            w = gather_at_use(t, NamedSharding(mesh, P("pp")))
        if sh is not None and any(p is not None for p in sh.spec[1:]):
            w._pt_layer_sharding = NamedSharding(mesh, P(*sh.spec[1:]))
            w._pt_layer_shape = tuple(t._pt_global_shape[1:])
        out[name] = w
    return out


def _dp_mean(grads, mesh):
    """Each gradient's mean over ``dp`` (one collective per dtype)."""
    from .collective import allreduce

    if mesh.size_of("dp") == 1:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    flat = allreduce(flat, "dp", "mean", mesh=mesh)
    return [p.view_as(g) for g, p in zip(grads, flat.split(
        [g.numel() for g in grads]))]


def _like(new, old):
    """``new`` marked with ``old``'s sharding (a placed leaf's)."""
    sh = S.sharding_of(old)
    if sh is not None:
        S.mark(new, sh, old._pt_global_shape)
    return new


def _steps(mesh, loss_fn, lr):
    """(step, ref_step) from ``loss_fn(params, *feed, pipelined=)``: the
    gradients averaged over ``dp``, then the SGD update. The gradient is
    ``backward()``'s: ``autograd.grad`` over the leaves would prune the
    ring hops of a rank's fill ticks, which its neighbours run
    (parallel/pipeline.py)."""

    def make(pipelined):
        def value_and_grad(params, *feed):
            names = [(g, k) for g in sorted(params)
                     for k in sorted(params[g])]
            leaves = [params[g][k] for g, k in names]
            for p in leaves:
                p.grad = None
            with mesh_scope(mesh), torch.enable_grad():
                loss = loss_fn(params, *feed, pipelined=pipelined)
                loss.backward()
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in leaves]
            for p in leaves:
                p.grad = None
            grads = _dp_mean(grads, mesh)
            out = {g: {} for g in params}
            for (g, k), gr, p in zip(names, grads, leaves):
                out[g][k] = _like(gr, p)
            return loss.detach(), {g: {k: out[g][k] for k in params[g]}
                                   for g in params}

        def update(params, grads):
            with torch.no_grad():
                return {g: {k: _like(torch.nn.Parameter(
                    w - lr * grads[g][k]), w)
                    for k, w in params[g].items()} for g in params}

        def step(params, *feed):
            loss, grads = value_and_grad(params, *feed)
            return loss, update(params, grads)

        step.value_and_grad = value_and_grad
        step.update = update
        return step

    return make(True), make(False)


def build_hybrid_transformer_step(mesh, *, layers: int = 4,
                                  d_model: int = 16, d_ff: int = 32,
                                  num_classes: int = 8, batch: int = 8,
                                  num_microbatches: int = 2,
                                  lr: float = 0.1, seed: int = 0):
    """A dp x tp x pp training step on ``mesh`` over a tiny residual
    stack (``h + tanh(h @ w1) @ w2`` a layer, w1 column- and w2
    row-parallel over ``tp``, stacked over ``pp``) and a linear
    classifier. Returns ``(step, params, (x, y))`` with
    ``step(params, x, y) -> (loss, new_params)``; the weights and the
    batch are the JAX builder's numpy draws from ``seed``, bit for bit
    (``params`` flat: ``w1``, ``w2``, ``head``)."""
    from .collective import copy_to_tp, reduce_from_tp
    from .context_parallel import token_mean

    _check_mesh(mesh)
    L, n_pp = layers, mesh.size_of("pp")
    enforce(L % n_pp == 0, "pp size %s must divide layer count %s", n_pp, L)
    div = num_microbatches * mesh.size_of("dp")
    enforce(batch % div == 0,
            "microbatches x dp (%s) must divide batch size %s", div, batch)
    rng = np.random.default_rng(seed)
    scale = d_model ** -0.5
    dev = mesh.device

    def put(a, spec):
        return _leaf(torch.from_numpy(np.asarray(a)),
                     NamedSharding(mesh, spec), dev)

    params = {
        "w1": put(rng.normal(scale=scale, size=(L, d_model, d_ff))
                  .astype(np.float32), P("pp", None, "tp")),
        "w2": put(rng.normal(scale=scale, size=(L, d_ff, d_model))
                  .astype(np.float32), P("pp", "tp", None)),
        "head": put(rng.normal(scale=scale, size=(d_model, num_classes))
                    .astype(np.float32), P()),
    }
    x = rng.normal(size=(batch, d_model)).astype(np.float32)
    y = rng.integers(0, num_classes, size=(batch,))
    x = torch.from_numpy(_microbatch_rows(x, mesh, num_microbatches)).to(dev)
    y = torch.from_numpy(_microbatch_rows(y, mesh, num_microbatches)).to(dev)

    def block_fn(p, h):
        # the column-parallel product, then the row-parallel one closed
        # by one sum over tp (identities where tp has one rank)
        h1 = torch.tanh(copy_to_tp(h, "tp", mesh=mesh) @ p["w1"])
        return h + reduce_from_tp(h1 @ p["w2"], "tp", mesh=mesh)

    def loss_fn(p, x, y, *, pipelined):
        # always pipelined: the JAX builder has no sequential form
        stack = {"w1": p["layers"]["w1"], "w2": p["layers"]["w2"]}
        h = pipeline_apply(block_fn, stack, x,
                           num_microbatches=num_microbatches, mesh=mesh)
        logp = torch.log_softmax(h @ p["rest"]["head"], dim=-1)
        nll = -logp.gather(1, y[:, None].long()).sum()
        return token_mean(nll, torch.tensor(y.numel(), device=dev))

    step, _ = _steps(mesh, loss_fn, lr)

    def flat_step(p, x, y):
        loss, new = step({"layers": {"w1": p["w1"], "w2": p["w2"]},
                          "rest": {"head": p["head"]}}, x, y)
        return loss, {"w1": new["layers"]["w1"], "w2": new["layers"]["w2"],
                      "head": new["rest"]["head"]}

    return flat_step, params, (x, y)


def _sub(tree, prefix):
    """Strip ``prefix.`` from the matching keys (functional_call's
    feed)."""
    pre = prefix + "."
    return {k[len(pre):]: v for k, v in tree.items() if k.startswith(pre)}


def _stacked_blocks_runner(mesh, template, moe, num_microbatches,
                           pipeline_schedule, virtual_stages):
    """The block stack's execution shared by the BERT and GPT builders:
    pipelined (both schedules, ring weight order, the MoE aux carried)
    or the sequential fold. Returns ``run(layers, x, *, pipelined) ->
    (h, aux)`` and the ring flag."""
    n_pp = mesh.size_of("pp")
    ring = pipeline_schedule == "interleaved" and virtual_stages > 1

    def block_fn(p_l, h):
        out, _ = template.functional_call(p_l, h, training=False)
        return out

    def block_fn_aux(p_l, h):
        out, nb = template.functional_call(p_l, h, training=False)
        # [load-balance, router-z]; kept_fraction stays a diagnostic
        return out, torch.stack([nb["ffn.aux_loss"],
                                 nb["ffn.router_z_loss"]])

    def run(layers, x, *, pipelined):
        from .pipeline import _fold

        if pipelined:
            out = pipeline_apply(block_fn_aux if moe else block_fn, layers,
                                 x, num_microbatches=num_microbatches,
                                 mesh=mesh, schedule=pipeline_schedule,
                                 virtual_stages=virtual_stages,
                                 layers_in_ring_order=ring,
                                 aux_size=2 if moe else 0)
            return out if moe else (out, None)
        whole = _whole_stack(layers, mesh)
        if ring:
            # the sequential fold applies the layers in logical order
            for name, w in whole.items():
                keep = {k: getattr(w, k) for k in ("_pt_layer_sharding",
                                                   "_pt_layer_shape")
                        if hasattr(w, k)}
                whole[name] = ring_order_layers(w, n_pp, virtual_stages,
                                                inverse=True)
                for k, val in keep.items():
                    setattr(whole[name], k, val)
        if moe:
            # per-MICROBATCH, as every pipelined schedule routes
            return microbatched_aux_fold(
                block_fn_aux, whole, x, num_microbatches=num_microbatches,
                aux_size=2, remat=False)
        L = next(iter(whole.values())).shape[0]
        return _fold(block_fn, whole, x, range(L)), None

    return run, ring


def _buffers_to(model, device):
    """Move ``model``'s buffers to ``device``: the steps bind every
    parameter they use (``functional_call``), so the module's own
    parameters stay on the host."""
    for mod in model.modules():
        for name, b in mod._buffers.items():
            if b is not None:
                mod._buffers[name] = b.to(device)


def _model_params(model, prefix_of_blocks, blocks):
    """(stacked block leaves, the other leaves) of a freshly built model,
    detached on the CPU."""
    from ..nn.layer import stacked_parameters

    with torch.no_grad():
        stacked = {k: v.detach().clone()
                   for k, v in stacked_parameters(list(blocks)).items()}
    rest = {k: v.detach().clone() for k, v in model.named_parameters()
            if not k.startswith(prefix_of_blocks)}
    return stacked, rest


def _rules(mesh, moe):
    from ..nn.moe import expert_param_spec
    from .sharding import transformer_tp_rules

    rules = transformer_tp_rules()
    if moe and "ep" in mesh.shape:
        rules = rules + expert_param_spec("ep")
    return rules


def _checks(mesh, cfg, n_pp, virtual_stages, batch, num_microbatches,
            what):
    enforce(cfg.num_layers % (n_pp * virtual_stages) == 0,
            "pp size x virtual stages (%s x %s) must divide num_layers %s",
            n_pp, virtual_stages, cfg.num_layers)
    div = num_microbatches * mesh.size_of("dp")
    enforce(batch % div == 0,
            "microbatches x dp (%s) must divide batch size %s", div, batch)
    enforce(cfg.dropout == 0.0,
            "hybrid %s step needs dropout == 0 (deterministic loss-match "
            "contract)", what)


def build_bert_hybrid_step(mesh, *, cfg=None, batch: int = 8,
                           seq_len: int = 16, num_microbatches: int = 2,
                           lr: float = 0.01, seed: int = 0,
                           vocab_chunk: int = 256,
                           pipeline_schedule: str = "gpipe",
                           virtual_stages: int = 1):
    """The composed step of ``BertForPretraining``: the post-norm encoder
    blocks pipelined over ``pp`` with Megatron's pairs over ``tp`` (the
    flash kernels at the rank's heads on the card), the MLM head through
    the fused chunked linear-CE and the NSP head, the batch over ``dp``.
    With ``cfg.moe_experts > 0`` the blocks' load-balance and router-z
    losses ride the pipeline's aux carry (weights 0.01 and 1e-3) and the
    experts split over ``ep`` when the mesh has it. Returns ``(step,
    ref_step, params, (ids, mlm_labels, nsp_label))`` (the module
    docstring)."""
    from ..core.random import make_generator, seed as set_seed
    from ..models.bert import BertConfig, BertForPretraining
    from ..ops import loss as OL
    from ..ops.fused_loss import linear_cross_entropy
    from ..nn.layer import use
    from .context_parallel import token_mean

    _check_mesh(mesh)
    if cfg is None:
        cfg = BertConfig(vocab_size=512, hidden_size=64, num_layers=4,
                         num_heads=4, intermediate_size=128,
                         max_position=64, dropout=0.0)
    n_pp = mesh.size_of("pp")
    _checks(mesh, cfg, n_pp, virtual_stages, batch, num_microbatches,
            "BERT")
    set_seed(seed)
    model = BertForPretraining(cfg, device="cpu",
                               generator=make_generator(seed, "cpu"))
    moe = getattr(cfg, "moe_experts", 0) > 0
    moe_aux_w, moe_z_w = 0.01, 1e-3
    stacked, rest = _model_params(model, "bert.encoder.layers.",
                                  model.bert.encoder.layers)
    params = _place_hybrid_params(mesh, stacked, rest, _rules(mesh, moe),
                                 pipeline_schedule == "interleaved"
                                 and virtual_stages > 1, n_pp,
                                 virtual_stages)
    _buffers_to(model, mesh.device)
    template = model.bert.encoder.layers[0]
    run_blocks, _ = _stacked_blocks_runner(
        mesh, template, moe, num_microbatches, pipeline_schedule,
        virtual_stages)

    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, size=(batch, seq_len))
    mlm_labels = np.where(rng.random((batch, seq_len)) < 0.15,
                          rng.integers(0, cfg.vocab_size,
                                       size=(batch, seq_len)), -100)
    nsp_label = rng.integers(0, 2, size=(batch,))
    feed = tuple(torch.from_numpy(_microbatch_rows(
        a, mesh, num_microbatches)).to(mesh.device)
        for a in (ids, mlm_labels, nsp_label))

    def loss_fn(p, ids, mlm_labels, nsp_label, *, pipelined):
        r = p["rest"]
        x, _ = model.bert.embeddings.functional_call(
            _sub(r, "bert.embeddings"), ids, training=False)
        h, aux = run_blocks(p["layers"], x, pipelined=pipelined)
        pooled, _ = model.bert.pooler.functional_call(
            _sub(r, "bert.pooler"), h[:, 0])
        hm, _ = model.mlm_transform.functional_call(
            _sub(r, "mlm_transform"), h)
        hm, _ = model.mlm_norm.functional_call(_sub(r, "mlm_norm"), hm)
        b, t, d = hm.shape
        labels = mlm_labels.reshape(-1)
        mlm = linear_cross_entropy(
            hm.reshape(b * t, d), use(r["mlm_decoder.weight"]),
            use(r["mlm_decoder.bias"]), labels, chunk=vocab_chunk,
            ignore_index=-100)
        mlm = token_mean(mlm.sum(), (labels != -100).sum())
        nsp_logits, _ = model.nsp.functional_call(_sub(r, "nsp"), pooled)
        nsp = OL.softmax_with_cross_entropy(nsp_logits, nsp_label)
        nsp = token_mean(nsp.sum(), torch.tensor(nsp.numel(),
                                                 device=nsp.device))
        loss = mlm + nsp
        if moe:
            loss = loss + moe_aux_w * aux[0] + moe_z_w * aux[1]
        return loss

    step, ref_step = _steps(mesh, loss_fn, lr)
    return step, ref_step, params, feed


def build_gpt_hybrid_step(mesh, *, cfg=None, batch: int = 8,
                          seq_len: int = 16, num_microbatches: int = 2,
                          lr: float = 0.01, seed: int = 0,
                          vocab_chunk: int = 256,
                          pipeline_schedule: str = "gpipe",
                          virtual_stages: int = 1):
    """The composed step of ``GPTForCausalLM``: RoPE + GQA attention (the
    flash kernels at the rank's (H/tp, Hkv/tp) heads on the card), RMSNorm
    pre-norm blocks, SwiGLU or Switch-MoE FFNs pipelined over ``pp``, the
    tied head through the fused chunked linear-CE (the ``tp``-split table
    gathered at use), the batch over ``dp``. The kv heads must divide by
    ``tp``. Returns ``(step, ref_step, params, (ids,))`` (the module
    docstring)."""
    from ..core.random import make_generator, seed as set_seed
    from ..models.gpt import GPTConfig, GPTForCausalLM
    from ..nn.layer import use
    from ..ops.fused_loss import linear_cross_entropy
    from ..ops.nn import embedding
    from .context_parallel import token_mean

    _check_mesh(mesh)
    if cfg is None:
        cfg = GPTConfig(vocab_size=512, hidden_size=64, num_layers=4,
                        num_heads=4, num_kv_heads=2, intermediate_size=128,
                        max_position=64)
    n_pp = mesh.size_of("pp")
    _checks(mesh, cfg, n_pp, virtual_stages, batch, num_microbatches, "GPT")
    enforce(cfg.tie_embeddings,
            "hybrid GPT step assumes the tied head (embed.weight.T)")
    set_seed(seed)
    model = GPTForCausalLM(cfg, device="cpu",
                           generator=make_generator(seed, "cpu"))
    moe = cfg.moe_experts > 0
    moe_aux_w, moe_z_w = 0.01, 1e-3
    stacked, rest = _model_params(model, "blocks.", model.blocks)
    params = _place_hybrid_params(mesh, stacked, rest, _rules(mesh, moe),
                                 pipeline_schedule == "interleaved"
                                 and virtual_stages > 1, n_pp,
                                 virtual_stages)
    _buffers_to(model, mesh.device)
    run_blocks, _ = _stacked_blocks_runner(
        mesh, model.blocks[0], moe, num_microbatches, pipeline_schedule,
        virtual_stages)

    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, size=(batch, seq_len))
    feed = (torch.from_numpy(_microbatch_rows(
        ids, mesh, num_microbatches)).to(mesh.device),)

    def loss_fn(p, ids, *, pipelined):
        r = p["rest"]
        x = embedding(ids, use(r["embed.weight"]))
        h, aux = run_blocks(p["layers"], x, pipelined=pipelined)
        hn, _ = model.norm_f.functional_call(_sub(r, "norm_f"), h)
        labels = torch.cat([ids[:, 1:], torch.full(
            (ids.shape[0], 1), -100, dtype=ids.dtype, device=ids.device)],
            dim=1).reshape(-1)
        b, t, d = hn.shape
        losses = linear_cross_entropy(
            hn.reshape(b * t, d), use(r["embed.weight"]).T, None, labels,
            chunk=vocab_chunk, ignore_index=-100)
        loss = token_mean(losses.sum(), (labels != -100).sum())
        if moe:
            loss = loss + moe_aux_w * aux[0] + moe_z_w * aux[1]
        return loss

    step, ref_step = _steps(mesh, loss_fn, lr)
    return step, ref_step, params, feed
