"""A world of gloo ranks on the CPU for the port's distributed tests (not
collected: no ``test_`` prefix).

``World(n, tmp_dir)`` spawns ``n`` processes (``torch.multiprocessing``,
the spawn start method), each of which joins a gloo process group over a
file store in ``tmp_dir`` (no TCP port: several test workers run at
once), sets ``torch.set_num_threads(1)`` and then runs the jobs it is
fed, so a test file pays for one spawn. ``world.run(fn, *args)`` calls
``fn(*args)`` on every rank and returns the per-rank results in rank
order; ``fn`` must be importable by name in the ranks (a module-level
function of a module on the parent's ``sys.path`` that imports neither
JAX nor the JAX package, such as this one). A rank's exception is raised
in the parent with the rank's traceback; a job that does not finish in
``timeout`` seconds (a collective left waiting) ends the world, which
the next ``run`` spawns anew.

The jobs below are the ranks' halves of tests/test_torch_mesh.py,
test_torch_context_parallel.py and test_torch_seq_parallel.py: each
builds its mesh (every rank the same meshes in one order), takes its
shard of the seeded global arrays it is given, and returns what the
parent compares with the JAX functions."""

from __future__ import annotations

import os
import queue
import traceback

import numpy as np
import torch


def _rank_main(rank, n, store, jobs, results):
    torch.set_num_threads(1)
    from paddle_tpu_torch.parallel.collective import init_world

    init_world(rank, n, "file://" + store, backend="gloo")
    while True:
        job = jobs.get()
        if job is None:
            break
        fn, args, kw = job
        try:
            results.put((rank, True, fn(*args, **kw)))
        except Exception:               # reported to the parent
            results.put((rank, False, traceback.format_exc()))


class World:
    """``n`` gloo ranks fed jobs through queues."""

    def __init__(self, n: int, tmp_dir, timeout: float = 120.0):
        self.n, self.tmp_dir, self.timeout = n, str(tmp_dir), timeout
        self._spawns = 0
        self.procs = None

    def _start(self):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._spawns += 1
        store = os.path.join(self.tmp_dir, f"store{self._spawns}")
        self.jobs = [ctx.Queue() for _ in range(self.n)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(r, self.n, store, self.jobs[r],
                                        self.results), daemon=True)
                      for r in range(self.n)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, **kw):
        if self.procs is None:
            self._start()
        for q in self.jobs:
            q.put((fn, args, kw))
        out, errors = [None] * self.n, []
        for _ in range(self.n):
            try:
                rank, ok, value = self.results.get(timeout=self.timeout)
            except queue.Empty:
                self.close(force=True)
                raise TimeoutError(f"{fn.__name__}: a rank did not finish "
                                   f"in {self.timeout} s") from None
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                if len(errors) == 1:
                    # the other ranks may wait in a collective forever
                    self.close(force=True)
                    break
        if errors:
            raise RuntimeError("\n".join(errors))
        return out

    def close(self, force: bool = False):
        if self.procs is None:
            return
        if not force:
            for q in self.jobs:
                q.put(None)
            for p in self.procs:
                p.join(timeout=10)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        self.procs = None


# --- helpers the jobs share ---------------------------------------------------

_MESHES = {}


def mesh(dp=1, sp=1, **kw):
    """The rank's mesh of these sizes, built once per rank (every rank
    builds meshes in the same order: the jobs run in one order)."""
    from paddle_tpu_torch.core import mesh as M

    key = (dp, sp, tuple(sorted(kw.items())))
    if key not in _MESHES:
        _MESHES[key] = M.build_mesh(dp=dp, sp=sp, device="cpu", **kw)
    return _MESHES[key]


def local(x, m, spec):
    """The rank's shard of global array ``x`` under ``spec`` (a tuple of
    PartitionSpec entries) as a tensor, or None."""
    from paddle_tpu_torch.core import mesh as M

    if x is None:
        return None
    return torch.from_numpy(np.array(M.NamedSharding(m, M.P(*spec)).local(
        np.asarray(x))))


def host(x):
    """A host copy (a parameter's numpy view would follow later
    in-place updates)."""
    return None if x is None else x.detach().clone().numpy()


# --- test_torch_mesh.py --------------------------------------------------------

def job_mesh_coordinates(sizes):
    m = mesh(**sizes)
    return m.rank, dict(m.coordinate), m.devices.tolist()


def job_device_mesh(sizes):
    """The mesh's layout as a torch DeviceMesh: its dim names, shape and
    this rank's coordinate."""
    m = mesh(**sizes)
    dm = m.device_mesh
    return (tuple(dm.mesh_dim_names), tuple(dm.mesh.shape),
            dm.get_coordinate(), m.rank)


def job_collective(name, x, axis, kw, cot):
    """The collective ``name`` over ``axis`` on the rank's row of ``x``
    (the global (n, ...) array split over its leading dim across every
    rank); its value, and the gradient of sum(out * cot's rank row) where
    JAX has one."""
    from paddle_tpu_torch.parallel import collective as C

    m = mesh(dp=2, sp=2)
    xt = torch.from_numpy(np.array(x[m.rank])).requires_grad_(
        cot is not None)
    with torch.enable_grad():
        out = getattr(C, name)(xt, axis, **kw, mesh=m)
        grad = None
        if cot is not None:
            (out * torch.from_numpy(np.array(cot[m.rank]))).sum().backward()
            grad = host(xt.grad)
    return host(out), grad


def job_axis_index(axis):
    from paddle_tpu_torch.parallel import collective as C

    return C.axis_index(axis, mesh=mesh(dp=2, sp=2))


def job_ppermute_many(x, perm):
    """ppermute of a tuple (float and bool) in one exchange."""
    from paddle_tpu_torch.parallel import collective as C

    m = mesh(dp=1, sp=4)
    xt = torch.from_numpy(np.array(x[m.rank]))
    a, b = C.ppermute((xt, xt > 0), "sp", perm, mesh=m)
    return host(a), host(b)


def job_allreduce_max_has_no_grad():
    from paddle_tpu_torch.parallel import collective as C

    m = mesh(dp=1, sp=4)
    x = torch.ones(3, requires_grad=True)
    with torch.enable_grad():
        y = C.allreduce(x * (m.rank + 1), "sp", "max", mesh=m)
        value = host(y)
        try:
            y.sum().backward()
        except Exception as e:          # the typed error is the result
            return value, type(e).__name__, str(e)
    return value, None, None


def job_params_agree():
    """Every rank builds GPT tiny from the same seed and gets the same
    weights (no broadcast): the sum of each rank's parameters."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import gpt

    seed(0)
    model = gpt.GPTForCausalLM(gpt.GPTConfig.tiny(), device="cpu")
    return float(sum(p.double().sum() for p in model.parameters()))


# --- test_torch_context_parallel.py -----------------------------------------

def _attention(fn_name, m, spec, q, k, v, kw, km, seg, ct, force):
    """One context-parallel call on the rank's shards; returns its output
    shard and the shards of d sum(out * ct) / d (q, k, v)."""
    from paddle_tpu_torch.ops.attention import force_flash
    from paddle_tpu_torch.ops.kernels import flash_attention as FK
    from paddle_tpu_torch.parallel import context_parallel as CP

    mspec = spec[:2]
    tq, tk, tv = (local(a, m, spec).requires_grad_() for a in (q, k, v))
    kw = dict(kw)
    if km is not None:
        kw["kv_mask"] = local(km, m, mspec)
    if seg is not None:
        kw["segment_ids"] = local(seg, m, mspec)
    n_flash = [0]
    real = FK.ring_fwd_block

    def counting(*a, **k):
        n_flash[0] += 1
        return real(*a, **k)

    # the flash hops call the entry point (its plain version on the CPU);
    # the einsum hop calls the plain version directly
    FK.ring_fwd_block = counting
    try:
        with force_flash(force), torch.enable_grad():
            out = getattr(CP, fn_name)(tq, tk, tv, mesh=m, **kw)
            (out * local(ct, m, spec)).sum().backward()
    finally:
        FK.ring_fwd_block = real
    return (host(out), host(tq.grad), host(tk.grad), host(tv.grad),
            n_flash[0])


def job_context_parallel(fn_name, sizes, spec, q, k, v, kw, km, seg, ct,
                         force=False):
    return _attention(fn_name, mesh(**sizes), spec, q, k, v, kw, km, seg,
                      ct, force)


def job_sharded_flash_dropout(sizes, spec, q, k, v, key, seeds_by_gen, p):
    """sharded_flash_attention with dropout: the generator the rank's
    folded key seeds maps to the seeds the JAX call draws for that key
    (``seeds_by_gen``: {generator seed: (B, H) seeds}), so the masks are
    the JAX shard's, bit for bit."""
    from paddle_tpu_torch.ops import attention as TA
    from paddle_tpu_torch.parallel import context_parallel as CP

    m = mesh(**sizes)
    real = TA._dropout_seeds
    used = []

    def seeds(gen, b, h, dev):
        used.append(gen.initial_seed())
        return torch.from_numpy(np.array(seeds_by_gen[gen.initial_seed()]))

    TA._dropout_seeds = seeds
    try:
        out = CP.sharded_flash_attention(
            local(q, m, spec), local(k, m, spec), local(v, m, spec), mesh=m,
            batch_axis="dp", head_axis="sp", dropout_p=p,
            dropout_key=np.asarray(key, np.uint32))
    finally:
        TA._dropout_seeds = real
    return host(out), used


def job_cp_error(fn_name, sizes, q, k, v, kw):
    """The typed error a context-parallel call raises on this rank's
    (given, not sharded) inputs."""
    from paddle_tpu_torch.parallel import context_parallel as CP

    m = mesh(**sizes)
    try:
        getattr(CP, fn_name)(*(torch.from_numpy(np.array(a))
                               for a in (q, k, v)), mesh=m, **kw)
    except Exception as e:
        return type(e).__name__, str(e)
    return None, None


# --- test_torch_seq_parallel.py ----------------------------------------------

def _gpt(cfg, state, impl):
    from paddle_tpu_torch.models import gpt as TG
    from paddle_tpu_torch.utils.convert import load_numpy_state

    model = TG.GPTForCausalLM(TG.GPTConfig(**cfg, seq_parallel=impl),
                              device="cpu")
    load_numpy_state(model, state)
    return model


def _mesh_grads(model, m, op):
    """{name: the parameter's gradient reduced over the mesh}, rank 0
    only (the others return None)."""
    from paddle_tpu_torch.parallel.collective import allreduce

    out = {n: host(allreduce(torch.zeros_like(p) if p.grad is None
                             else p.grad, ("dp", "sp"), op, mesh=m))
           for n, p in model.named_parameters()}
    return out if m.rank == 0 else None


def job_gpt_seq(impl, sizes, cfg, state, ids, labels):
    """GPT on the rank's (B/dp, T) ids: its logits (gathered over sp),
    forward_loss with ``labels`` and the gradients' mean over the mesh."""
    from paddle_tpu_torch.core.mesh import mesh_scope

    m = mesh(**sizes)
    model = _gpt(cfg, state, impl).train()
    rows = local(ids, m, ("dp",)).long()
    lab = local(labels, m, ("dp",)).long()
    with mesh_scope(m):
        with torch.no_grad():
            logits = model(rows)
        with torch.enable_grad():
            loss = model.forward_loss(rows, labels=lab, vocab_chunk=96)
            loss.backward()
    return host(logits), float(loss), _mesh_grads(model, m, "mean")


def job_layer_seq(kind, impl, sizes, kw, state, x, mask, ct, causal):
    """An encoder stack or a rotary attention layer on the rank's (B/dp,
    T/sp, D) rows: its output rows, d sum(out * ct) / dx on them, and
    each parameter's gradient summed over the mesh (the objective is
    the sum of the ranks' pieces)."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.core.mesh import mesh_scope
    from paddle_tpu_torch.utils.convert import load_numpy_state

    m = mesh(**sizes)
    layer = (tnn.TransformerEncoder if kind == "encoder"
             else tnn.MultiHeadAttention)(**kw, seq_parallel=impl,
                                          device="cpu")
    load_numpy_state(layer, state)
    spec = ("dp", "sp")
    xt = local(x, m, spec).requires_grad_()
    with mesh_scope(m), torch.enable_grad():
        if kind == "encoder":
            mk = local(mask, m, spec)
            out = layer(xt, mask=None if mk is None else mk[:, None, None])
        else:
            out = layer(xt, causal=causal)
        (out * local(ct, m, spec)).sum().backward()
    return host(out), host(xt.grad), _mesh_grads(layer, m, "sum")


def job_trainer_seq(impl, sizes, cfg, state, ids, steps, lr):
    """``steps`` SGD steps of Trainer(mesh=) on the rank's rows: the
    losses, and rank 0's parameters after each step."""
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.parallel import Trainer

    m = mesh(**sizes)
    model = _gpt(cfg, state, impl)
    tt = Trainer(model, TO.SGD(lr), lambda model, batch, gen: (
        model.forward_loss(batch, vocab_chunk=96), {}), mesh=m)
    rows = tt.data_sharding().local(torch.from_numpy(np.array(ids))).long()
    out = []
    for _ in range(steps):
        loss, _ = tt.train_step(rows)
        params = ({n: host(p) for n, p in model.named_parameters()}
                  if m.rank == 0 else None)
        out.append((float(loss), params))
    return out


def job_data_parallel(cfg, state, ids, labels, steps, lr):
    """DataParallel over every rank (dp=4): the losses and rank 0's
    parameters after each SGD step."""
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.models import gpt as TG
    from paddle_tpu_torch.parallel import DataParallel

    model = _gpt(cfg, state, None)
    tt = DataParallel(model, TO.SGD(lr), TG.loss_fn)
    assert tt.mesh.shape["dp"] == 4
    sh = tt.data_sharding()
    batch = {"x": sh.local(torch.from_numpy(np.array(ids))).long(),
             "label": sh.local(torch.from_numpy(np.array(labels))).long()}
    out = []
    for _ in range(steps):
        loss, _ = tt.train_step(batch)
        params = ({n: host(p) for n, p in model.named_parameters()}
                  if tt.mesh.rank == 0 else None)
        out.append((float(loss), params))
    return out


# --- test_torch_global_loss.py -----------------------------------------------

def _bert(cfg, state, impl):
    from paddle_tpu_torch.models import bert as TB
    from paddle_tpu_torch.utils.convert import load_numpy_state

    model = TB.BertForPretraining(TB.BertConfig(**cfg, seq_parallel=impl),
                                  device="cpu")
    load_numpy_state(model, state)
    return model


def job_bert_loss(method, impl, sizes, cfg, state, args, chunk):
    """BERT's ``method`` (forward_fused_loss or forward_packed_loss) on
    the rank's rows of the global ``args``: the loss and the gradients'
    mean over the mesh."""
    from paddle_tpu_torch.core.mesh import mesh_scope

    m = mesh(**sizes)
    model = _bert(cfg, state, impl).train()
    rows = [local(a, m, ("dp",)) for a in args]
    rows = [r.long() if r.dtype != torch.bool else r for r in rows]
    with mesh_scope(m), torch.enable_grad():
        loss = getattr(model, method)(*rows, vocab_chunk=chunk)
        loss.backward()
    return float(loss), _mesh_grads(model, m, "mean")


def job_supervised_bert(sizes, cfg, state, x, label, steps, lr):
    """``steps`` SGD steps of Trainer.supervised over the mesh, BERT with
    ``bert.pretrain_loss``, on the rank's rows: the losses and rank 0's
    parameters after each step."""
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.models import bert as TB
    from paddle_tpu_torch.parallel import Trainer

    m = mesh(**sizes)
    model = _bert(cfg, state, None)
    tt = Trainer.supervised(model, TO.SGD(lr), TB.pretrain_loss, mesh=m)
    sh = tt.data_sharding()

    def rows(a):
        if isinstance(a, dict):
            return {k: rows(v) for k, v in a.items()}
        return sh.local(torch.from_numpy(np.array(a))).long()

    batch = {"x": rows(x), "label": rows(label)}
    out = []
    for _ in range(steps):
        loss, _ = tt.train_step(batch)
        params = ({n: host(p) for n, p in model.named_parameters()}
                  if m.rank == 0 else None)
        out.append((float(loss), params))
    return out


# --- test_torch_{plan,tensor_parallel,mesh_repairs}.py -----------------------

def _rules(name):
    """The rule set a job names (specs do not cross the queues)."""
    if name is None:
        return ()
    from paddle_tpu_torch.nn.moe import expert_param_spec
    from paddle_tpu_torch.parallel import transformer_tp_rules

    return {"tp": transformer_tp_rules, "ep": expert_param_spec}[name]()


class BNNet:
    """Linear(8, 6) -> BatchNorm(6) -> ReLU -> Linear(6, 3), the port's
    side of the BatchNorm jobs (the test builds the JAX one)."""

    @staticmethod
    def build():
        from paddle_tpu_torch import nn as tnn

        class Net(tnn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = tnn.Linear(8, 6, device="cpu")
                self.bn = tnn.BatchNorm(6, device="cpu")
                self.head = tnn.Linear(6, 3, device="cpu")

            def forward(self, x):
                return self.head(torch.relu(self.bn(self.fc(x))))

        return Net()


def _model(kind, cfg, state):
    from paddle_tpu_torch.models import mnist as TM
    from paddle_tpu_torch.utils.convert import load_numpy_state

    if kind == "gpt":
        impl = cfg.pop("seq_parallel", None)
        return _gpt(cfg, state, impl)
    if kind == "bert":
        return _bert(cfg, state, None)
    if kind == "nmt":
        from paddle_tpu_torch.models import transformer as TT

        model = TT.TransformerNMT(TT.NMTConfig(**cfg), device="cpu")
        load_numpy_state(model, state)
        return model
    model = (TM.MnistMLP(**cfg, device="cpu") if kind == "mnist"
             else BNNet.build())
    load_numpy_state(model, state)
    return model


def _trainer(kind, model, opt, aux, **kw):
    from paddle_tpu_torch.models import bert as TB
    from paddle_tpu_torch.models import gpt as TG
    from paddle_tpu_torch.models import mnist as TM
    from paddle_tpu_torch.parallel import Trainer

    if kind == "gpt":
        return Trainer(model, opt, lambda m, batch, g: (
            m.forward_loss(batch, vocab_chunk=96), {}), **kw)
    if kind == "nmt":
        return Trainer(model, opt, lambda m, b, g: (m.forward_fused_loss(
            b["src"], b["tgt"], b["labels"], vocab_chunk=96), {}), **kw)
    loss = {"bert": TB.pretrain_loss, "mnist": TM.loss_fn,
            "bn": TM.loss_fn, "gpt_sup": TG.loss_fn}[kind]
    return Trainer.supervised(model, opt, loss, **(aux or {}), **kw)


def _whole(model):
    """{name: the whole parameter}, gathered where it is a placed shard
    (every rank takes part; rank 0 keeps the result)."""
    from paddle_tpu_torch.nn.layer import use

    with torch.no_grad():
        return {n: host(use(p)) for n, p in model.named_parameters()}


def job_plan_trainer(kind, cfg, state, batch, steps, opt, plan=None,
                     mesh_sizes=None, zero=None, aux=None, seed=None):
    """``steps`` updates of a Trainer on the rank's rows of ``batch``
    under ``plan`` (Plan keywords, ``rules`` by name), or ``mesh_sizes``
    (build_mesh keywords) with ``zero`` (zero_dp_rules' min_size);
    ``aux``: ``Trainer.supervised``'s MoE loss weights. Per
    step: the loss and (rank 0) the whole parameters; then the rank's
    layout (each leaf's local and global shape and spec, the moments'
    specs), the buffers, the gather-at-use fallbacks counted and the
    step's ``compiled_via``."""
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.core.random import seed as set_seed
    from paddle_tpu_torch.parallel import Plan
    from paddle_tpu_torch.parallel import sharding as S

    if seed is not None:
        set_seed(seed)
    kind_model = "gpt" if kind == "gpt_sup" else kind
    model = _model(kind_model, dict(cfg), state)
    kw = {}
    if plan is not None:
        kw["plan"] = Plan(**{**plan, "rules": _rules(plan.get("rules")),
                             "device": "cpu"})
    if mesh_sizes is not None:
        kw["mesh"] = mesh(**mesh_sizes)
    if zero is not None:
        kw["opt_state_rules"] = S.zero_dp_rules(min_size=zero)
    tt = _trainer(kind, model, getattr(TO, opt[0])(*opt[1:]), aux, **kw)
    sh = tt.data_sharding()

    def rows(a):
        if isinstance(a, dict):
            return {k: rows(v) for k, v in a.items()}
        t = torch.from_numpy(np.array(a))
        return sh.local(t.long() if not t.is_floating_point() else t)

    data = rows(batch)
    S.FALLBACKS.clear()
    rank0 = tt.mesh is None or tt.mesh.rank == 0
    out = []
    for _ in range(steps):
        loss, _ = tt.train_step(data)
        whole = _whole(model)
        out.append((float(loss), whole if rank0 else None))
    layout = {}
    for n, p in model.named_parameters():
        spec = S.sharding_of(p)
        layout[n] = (tuple(p.shape), tuple(getattr(p, "_pt_global_shape",
                                                   p.shape)),
                     None if spec is None else str(tuple(spec.spec)),
                     1 if spec is None else spec.mesh.axis_size(
                         spec.axes()))
    moments = [sorted((k, None if S.sharding_of(t) is None
                       else str(tuple(S.sharding_of(t).spec)),
                       tuple(t.shape))
                      for k, t in s.items() if torch.is_tensor(t))
               for s in tt.opt_state["leaf"]]
    buffers = {n: host(b) for n, b in model.named_buffers()}
    return dict(steps=out, layout=layout, moments=moments, buffers=buffers,
                fallbacks=dict(S.FALLBACKS),
                via=tt._jit_step.compiled_via)


def job_dropout_masks(sizes, n_steps):
    """The layer dropout masks (p = 0.5 on a (64, 64) block of ones) a
    Trainer under the mesh ``sizes`` draws in each of ``n_steps`` steps,
    with the rank's mesh coordinate."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.core.random import seed as set_seed
    from paddle_tpu_torch.parallel import Trainer

    set_seed(3)
    m = mesh(**sizes)
    model = tnn.Linear(64, 1, device="cpu")
    drop = tnn.Dropout(0.5)

    def builder(model, batch, gen):
        keep = drop(torch.ones(64, 64)) != 0
        return model(keep.float()).sum(), {"keep": keep}

    tt = Trainer(model, TO.SGD(0.0), builder, mesh=m)
    masks = [tt.train_step(None)[1]["keep"].numpy() for _ in range(n_steps)]
    return dict(m.coordinate), masks


def job_tp_against_whole(kind, cfg, state, batch, plan, steps, opt, seed):
    """``steps`` updates with dropout on under ``plan`` (one that splits
    no batch) and, in the same rank, without a mesh from the same
    global-stream seed: a tp rank draws the whole layer's masks (its
    heads' attention seeds, its columns' FFN mask), so both give the
    same losses and parameters."""
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.core.random import seed as set_seed
    from paddle_tpu_torch.parallel import Plan

    runs = []
    for p in (plan, None):
        set_seed(seed)
        model = _model(kind, dict(cfg), state)
        kw = {} if p is None else {"plan": Plan(
            **{**p, "rules": _rules(p.get("rules")), "device": "cpu"})}
        tt = _trainer(kind, model, getattr(TO, opt[0])(*opt[1:]), None,
                      **kw)

        def rows(a):
            if isinstance(a, dict):
                return {k: rows(v) for k, v in a.items()}
            return torch.from_numpy(np.array(a)).long()

        data = rows(batch)
        losses = [float(tt.train_step(data)[0]) for _ in range(steps)]
        runs.append((losses, _whole(model)))
    return runs


def job_moe_seq(sizes, cfg, state, ids):
    """A MoE GPT's forward_loss on the rank's (B/dp, T) ids under the
    mesh (``cfg`` may name seq_parallel): the loss, the gradients' mean
    over the mesh (rank 0) and each block's recorded aux, z and kept
    terms."""
    from paddle_tpu_torch.core.mesh import mesh_scope

    m = mesh(**sizes)
    cfg = dict(cfg)
    model = _gpt(cfg, state, cfg.pop("seq_parallel", None)).train()
    rows = local(ids, m, ("dp",)).long()
    with mesh_scope(m), torch.enable_grad():
        loss = model.forward_loss(rows, vocab_chunk=96)
        loss.backward()
    terms = [(float(b.ffn.aux_loss), float(b.ffn.router_z_loss),
              float(b.ffn.kept_fraction)) for b in model.blocks]
    return float(loss), _mesh_grads(model, m, "mean"), terms


def job_fp16_skip_agrees(inf_rank):
    """A MixedPrecisionOptimizer step on MnistMLP's placed shards under
    Plan(fsdp=4) whose grads are finite everywhere but on ``inf_rank``:
    whether this rank applied the step, and its next loss scale."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.models import mnist as TM
    from paddle_tpu_torch.parallel import Plan

    plan = Plan(fsdp=4, min_shard_size=64, device="cpu")
    model = TM.MnistMLP(16, 8, device="cpu")
    params = dict(model.named_parameters())
    plan.place(params)
    opt = amp.MixedPrecisionOptimizer(TO.SGD(0.1), init_loss_scaling=8.0,
                                      decr_every_n_nan_or_inf=1)
    state = opt.init(params)
    grads = {n: torch.ones_like(p) for n, p in params.items()}
    if plan.mesh.rank == inf_rank:
        grads["fc1.weight"][0, 0] = float("inf")
    before = {n: p.detach().clone() for n, p in params.items()}
    opt.apply(params, grads, state)
    applied = any(not torch.equal(before[n], p) for n, p in params.items())
    return applied, float(state["scaler"]["scale"])
