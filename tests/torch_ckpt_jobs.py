"""The ranks' halves of tests/test_torch_multihost_ckpt.py (not
collected: no ``test_`` prefix; imports neither JAX nor the JAX package).
Each job runs on every rank of a ``torch_world.World`` of 4 gloo ranks
and returns what the parent holds against the JAX package's checkpoint
functions: whole trees as {path: array} on rank 0, a rank's shards with
their windows elsewhere."""

from __future__ import annotations

import numpy as np
import torch

import torch_world as W


def _plan(kw):
    from paddle_tpu_torch.parallel import Plan

    return Plan(**{**kw, "rules": W._rules(kw.get("rules")),
                   "device": "cpu"})


def _gather(t):
    """The whole tensor of a placed leaf (every rank of its axes calls);
    a whole leaf as it is."""
    from paddle_tpu_torch.parallel import sharding as S
    from paddle_tpu_torch.parallel.collective import allgather

    sh = S.sharding_of(t) if torch.is_tensor(t) else None
    if sh is None:
        return t
    with torch.no_grad():
        for dim, part in enumerate(sh.spec):
            if part is not None:
                t = allgather(t, part, dim=dim, mesh=sh.mesh)
    return t


def whole_tree(tree):
    """{path: numpy array} of ``tree`` with every placed leaf gathered
    (every rank calls; the results are the same on each)."""
    from paddle_tpu_torch.checkpoint import _flatten, _to_numpy

    out = {}
    for path, leaf in _flatten(tree):
        leaf = _gather(leaf)
        out[path] = (_to_numpy(leaf.detach().clone())[0]
                     if torch.is_tensor(leaf) else np.asarray(leaf))
    return out


def _gpt_trainer(cfg, plan):
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.core.random import seed as set_seed
    from paddle_tpu_torch.models import gpt as TG

    set_seed(5)
    model = TG.GPTForCausalLM(TG.GPTConfig(**cfg), device="cpu")
    return W._trainer("gpt", model, TO.Adam(1e-3), None, plan=_plan(plan))


def job_gpt_save(cfg, plan, ids, steps, d):
    """``steps`` Adam steps of a GPT under ``plan``, then the per-host
    save at ``d``: the whole state (rank 0) and the files this rank
    wrote."""
    from paddle_tpu_torch import checkpoint as C

    tt = _gpt_trainer(cfg, plan)
    batch = tt.data_sharding().local(torch.from_numpy(ids).long())
    for _ in range(steps):
        tt.train_step(batch)
    files = C.WRITTEN["files"]
    tt.save_checkpoint(d)
    wrote = C.WRITTEN["files"] - files
    whole = whole_tree(tt.state())
    return dict(whole=whole if tt.mesh.rank == 0 else None, wrote=wrote)


def job_gpt_restore(cfg, plan, d, ids):
    """A fresh GPT trainer under ``plan`` restored from ``d``: the whole
    state (rank 0), each leaf's local shape, and the next step's loss."""
    tt = _gpt_trainer(cfg, plan)
    tt.restore_checkpoint(d)
    whole = whole_tree(tt.state())
    local = {k: tuple(v.shape) for k, v in tt.params.items()}
    batch = tt.data_sharding().local(torch.from_numpy(ids).long())
    loss = float(tt.train_step(batch)[0])
    return dict(whole=whole if tt.mesh.rank == 0 else None, local=local,
                loss=loss)


def job_restore_shards(d, plans, shardings=None):
    """``restore_state(d)`` under each plan's mesh (or ``shardings``: path
    -> spec tuple, on that mesh): each leaf's local numpy and the window
    (starts, stops) it holds, or None for a whole leaf."""
    from paddle_tpu_torch.checkpoint import _flatten, _to_numpy, restore_state
    from paddle_tpu_torch.core.sharding_types import PartitionSpec as P

    out = []
    for kw in plans:
        mesh = _plan(kw).mesh
        sh = None if shardings is None else {
            k: P(*v) for k, v in shardings.items()}
        tree = restore_state(d, mesh=mesh, shardings=sh)
        got = {}
        for path, leaf in _flatten(tree):
            spec = getattr(leaf, "_pt_sharding", None)
            win = None if spec is None else [
                (s.start or 0, s.stop) for s in spec.index(
                    leaf._pt_global_shape)]
            got[path] = (_to_numpy(leaf)[0], win)
        out.append(got)
    return out


def job_ep_table(table, d_ep, d_dense):
    """A (V, D) table placed over ep=4 (``Plan(ep=4, tables=)``) saved per
    host at ``d_ep``; the whole table saved at ``d_dense``. Returns the
    rank's rows restored under Plan(dp=2, ep=2), the table under
    Plan(dp=4) (no ep axis: whole), the dense checkpoint onto ep=4, and
    HostBackedTable.load of the per-host save."""
    from paddle_tpu_torch.checkpoint import restore_state, save_state
    from paddle_tpu_torch.core.sharding_types import PartitionSpec as P
    from paddle_tpu_torch.embedding import HostBackedTable
    from paddle_tpu_torch.parallel import Plan

    emb = r"emb\.weight$"
    plan4 = Plan(ep=4, tables=[emb], device="cpu")
    w = torch.from_numpy(table.copy())
    plan4.place({"emb.weight": w})
    spec = tuple(w._pt_sharding.spec)
    save_state(d_ep, {"emb.weight": w})
    save_state(d_dense, {"emb.weight": torch.from_numpy(table.copy())})
    p22 = Plan(dp=2, ep=2, tables=[emb], device="cpu")
    got22 = restore_state(d_ep, mesh=p22.mesh)["emb.weight"]
    got_dp = restore_state(d_ep, mesh=Plan(dp=4, device="cpu").mesh)[
        "emb.weight"]
    dense = restore_state(d_dense, mesh=plan4.mesh,
                          shardings={"emb.weight": P("ep", None)})[
        "emb.weight"]
    # the host table's own layout ({"rows": table}), saved per host
    save_state(d_ep + "_rows", {"rows": w})
    host = HostBackedTable.load(d_ep + "_rows", capacity=8, device="cpu")
    return dict(spec=spec, ep_index=p22.mesh.coordinate["ep"],
                rank=plan4.mesh.coordinate["ep"],
                got22=got22.numpy(), got_dp=got_dp.numpy(),
                dp_placed=hasattr(got_dp, "_pt_sharding"),
                dense=dense.numpy(), host=np.asarray(host.rows))


def _controller(root, run, **kw):
    import torch.distributed as dist

    from paddle_tpu_torch.resilience import FleetController
    from paddle_tpu_torch.resilience.controller import (ClientTransport,
                                                        coordination_client)

    return FleetController(rank=dist.get_rank(), world=dist.get_world_size(),
                           transport=ClientTransport(coordination_client(),
                                                     run),
                           coordination_dir=root, run_id=run,
                           hold_poll_s=0.01, **kw)


def job_coordinated_save(root, run, d, dead_rank=None):
    """A CheckpointManager(coordinator=) save of step 1 of a placed leaf
    on the store transport. With ``dead_rank``, that rank is marked dead
    on the file root (the launcher's marker) and does not save: the
    others' save must fail typed, naming it. Returns (the
    BarrierTimeoutError's message, its missing ranks, whether
    GLOBAL_COMMITTED is present, the globally committed steps)."""
    import os

    import torch.distributed as dist

    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.parallel import Plan
    from paddle_tpu_torch.resilience import BarrierTimeoutError

    rank = dist.get_rank()
    plan = Plan(fsdp=4, min_shard_size=8, device="cpu")
    w = torch.arange(64, dtype=torch.float32).reshape(16, 4)
    plan.place({"w": w})
    ctl = _controller(root, run, dead_grace_s=0.5)
    mgr = CheckpointManager(d, async_save=False, coordinator=ctl)
    if dead_rank is not None and rank == dead_rank:
        os.makedirs(root, exist_ok=True)
        with open(os.path.join(root, f"{run}.dead.{rank}"), "w") as f:
            f.write("1")
        return None
    ctl.start()
    err = missing = None
    try:
        mgr.save(1, {"w": w})
    except BarrierTimeoutError as e:
        err, missing = str(e), e.missing
    finally:
        ctl.stop()
    glob = os.path.exists(os.path.join(d, "step_1", "GLOBAL_COMMITTED"))
    return err, missing, glob, mgr.globally_committed_steps()


def job_agree_restore(run, steps_by_rank):
    """Each rank's agree_restore_step over the store transport."""
    import torch.distributed as dist

    ctl = _controller(None, run)
    return ctl.agree_restore_step(steps_by_rank[dist.get_rank()])
