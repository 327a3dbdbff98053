"""The ranks' halves of tests/test_torch_quant_comm.py (not collected: no
``test_`` prefix): each job runs on every rank of a tests/torch_world.py
world of 4 gloo ranks, takes its share of the seeded global arrays it is
given and returns what the parent holds against the JAX package. Like
torch_world.py, it imports neither JAX nor the JAX package."""

from __future__ import annotations

import numpy as np
import torch

import torch_world as W


def _dp4():
    return W.mesh(dp=4)


def job_ring(x_rows, kw, key=None):
    """quantized_psum over dp=4 of this rank's row of ``x_rows`` (4, N)."""
    from paddle_tpu_torch.quant import collectives as QC

    m = _dp4()
    x = torch.from_numpy(np.array(x_rows[m.rank]))
    if key is not None:
        kw = dict(kw, key=np.asarray(key, np.uint32))
    return W.host(QC.quantized_psum(x, "dp", 4, mesh=m, **kw))


def job_ring_wire(x_rows, group):
    """The tensors the ring hands the point-to-point exchange on this
    rank, as (dtype, shape) in order, around one quantized_psum."""
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.quant import collectives as QC

    m = _dp4()
    sent = []
    real = C._ppermute

    def recording(ctx, xs, perm):
        sent.extend((str(x.dtype), tuple(x.shape)) for x in xs)
        return real(ctx, xs, perm)

    C._ppermute = recording
    try:
        QC.quantized_psum(torch.from_numpy(np.array(x_rows[m.rank])), "dp",
                          4, group=group, mesh=m)
    finally:
        C._ppermute = real
    return sent


def job_sr_draws(x_rows, keys):
    """The stochastic ring over dp=4 once per key of ``keys``: the
    outputs (K, N)."""
    from paddle_tpu_torch.quant import collectives as QC

    m = _dp4()
    x = torch.from_numpy(np.array(x_rows[m.rank]))
    return np.stack([W.host(QC.quantized_psum(
        x, "dp", 4, key=np.asarray(k, np.uint32), mesh=m)) for k in keys])


def job_partitioned(stacked, kw, key=None):
    """quantized_psum_partitioned of this rank's rows of ``stacked`` (its
    shard over dp)."""
    from paddle_tpu_torch.quant import collectives as QC

    m = _dp4()
    x = W.local(stacked, m, ("dp",))
    if key is not None:
        kw = dict(kw, key=np.asarray(key, np.uint32))
    return W.host(QC.quantized_psum_partitioned(x, "dp", mesh=m, **kw))


def job_tree(big, small, cnt):
    """quantized_pmean_tree over dp=4 of each rank's rows."""
    from paddle_tpu_torch.quant import collectives as QC

    m = _dp4()
    tree = {"w": torch.from_numpy(np.array(big[m.rank])),
            "b": torch.from_numpy(np.array(small[m.rank])),
            "step": torch.from_numpy(np.array(cnt[m.rank]))}
    out = QC.quantized_pmean_tree(tree, "dp", 4, mesh=m)
    return {k: W.host(v) for k, v in out.items()}


def job_compress_sharded(whole, spec, key=None):
    """compress_grads of this rank's shard of ``whole`` under ``spec``
    over Plan(fsdp=4): the shard it returns, gathered whole."""
    from paddle_tpu_torch.core.sharding_types import (NamedSharding,
                                                      PartitionSpec as P)
    from paddle_tpu_torch.nn.layer import use
    from paddle_tpu_torch.parallel import sharding as S
    from paddle_tpu_torch.quant import collectives as QC

    plan = _plan(fsdp=4)
    sh = NamedSharding(plan.mesh, P(*spec))
    g = torch.from_numpy(np.array(whole))
    local = S.mark(sh.local(g).clone(), sh, g.shape)
    out = QC.compress_grads({"g": local}, key=None if key is None
                            else np.asarray(key, np.uint32))["g"]
    assert tuple(out.shape) == tuple(local.shape)
    assert S.sharding_of(out) is sh
    with torch.no_grad():
        return W.host(use(out))


_PLANS = {}


def _plan(**sizes):
    """One Plan (and its mesh) per sizes, built in one order on every
    rank."""
    from paddle_tpu_torch.parallel import Plan

    key = tuple(sorted(sizes.items()))
    if key not in _PLANS:
        _PLANS[key] = Plan(**sizes, min_shard_size=64, device="cpu")
        _PLANS[key].mesh
    return _PLANS[key]


def job_trainer(state, batch, steps, sizes, comp=None, trainer_comp=None,
                opt=("SGD", 0.5), multi=0, accum=1):
    """MnistMLP(16, 8) under Trainer.supervised on ``Plan(**sizes)``
    (min_shard_size 64) with ``grad_compression`` on the plan (``comp``)
    or the trainer (``trainer_comp``), ``grad_accum_steps=accum``:
    ``steps`` train_step calls, then ``train_steps(batch, multi)`` when
    ``multi``. Returns the losses,
    rank 0's whole parameters after each step, the trainer's mode, its
    static payload bytes, the counters' advance (telemetry on), and
    whether this rank's parameters equal its dp peers' bit for bit."""
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.models import mnist as TM
    from paddle_tpu_torch.parallel import Plan, Trainer
    from paddle_tpu_torch.parallel.collective import allgather
    from paddle_tpu_torch.quant import collectives as QC
    from paddle_tpu_torch.utils.convert import load_numpy_state

    plan = Plan(**sizes, min_shard_size=64, grad_compression=comp,
                device="cpu")
    model = TM.MnistMLP(16, 8, device="cpu")
    load_numpy_state(model, state)
    tt = Trainer.supervised(model, getattr(TO, opt[0])(*opt[1:]),
                            TM.loss_fn, plan=plan,
                            grad_compression=trainer_comp,
                            grad_accum_steps=accum)
    sh = tt.data_sharding()
    data = {"x": sh.local(torch.from_numpy(np.array(batch["x"]))),
            "label": sh.local(torch.from_numpy(np.array(batch["label"])))}
    telemetry.enable()
    try:
        mets = QC._comm_metrics()
        v0 = (mets["bytes_int8"].value, mets["bytes_fp32"].value)
        out = []
        rank0 = plan.mesh.rank == 0

        def record(loss):
            whole = W._whole(model)         # every rank gathers
            out.append((float(loss), whole if rank0 else None))

        for _ in range(steps):
            record(tt.train_step(data)[0])
        if multi:
            record(tt.train_steps(data, multi)[0])
        advance = (mets["bytes_int8"].value - v0[0],
                   mets["bytes_fp32"].value - v0[1])
    finally:
        telemetry.disable()
    same = True
    if "dp" in sizes and sizes["dp"] > 1:
        for p in model.parameters():
            peers = allgather(p.detach()[None], "dp", mesh=plan.mesh)
            same = same and all(torch.equal(peers[0], q) for q in peers)
    return dict(steps=out, mode=tt.grad_compression,
                comm_bytes=tt._comm_bytes, advance=advance, same=same,
                via=tt._jit_step.compiled_via)


def job_compression_off_runs_no_quant_code(state, batch):
    """With grad_compression off, a Plan(dp=4) step reaches no function
    of quant/collectives.py but the byte accounting (each one patched to
    raise)."""
    from paddle_tpu_torch.quant import collectives as QC

    def boom(*a, **k):
        raise AssertionError("compression code reached while off")

    saved = {n: getattr(QC, n) for n in (
        "quantized_pmean_tree", "quantized_psum", "quantized_pmean",
        "compress_grads", "_encode_chunk")}
    for n in saved:
        setattr(QC, n, boom)
    try:
        run = job_trainer(state, batch, 1, dict(dp=4))
    finally:
        for n, f in saved.items():
            setattr(QC, n, f)
    return run["steps"][0][0]
