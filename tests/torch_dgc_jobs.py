"""The ranks' halves of tests/test_torch_dgc_geo.py (not collected: no
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


def job_quantized_allreduce(x_rows, bits=8):
    """quantized_allreduce over dp=4 of this rank's row of ``x_rows``."""
    from paddle_tpu_torch.parallel import quantized_allreduce

    m = _dp4()
    x = torch.from_numpy(np.array(x_rows[m.rank]))
    return W.host(quantized_allreduce(x, "dp", bits, mesh=m))


def job_dgc_allreduce(tree_rows, sparsity, quantize):
    """dgc_allreduce over dp=4 of this rank's row of each leaf."""
    from paddle_tpu_torch.parallel import dgc_allreduce

    m = _dp4()
    tree = {k: torch.from_numpy(np.array(v[m.rank]))
            for k, v in tree_rows.items()}
    out = dgc_allreduce(tree, "dp", sparsity=sparsity, quantize=quantize,
                        mesh=m)
    return {k: W.host(v) for k, v in out.items()}


def job_geo(kind, cfg, state, x, y, sync_every, steps, opt, flush):
    """GeoSGDTrainer over dp=4 around Trainer.supervised(the ``kind``
    model of torch_world.py (MnistMLP or BNNet) with ``state``, ``opt``
    an optimizer by name and arguments, mesh=dp4) on the rank's rows of
    (x, y), ``steps`` steps: per step the loss and the divergence; then
    the rank's replica (parameters and buffers), and after ``flush``
    (geo.sync()) its parameters, buffers and optimizer state."""
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.models import mnist as TM
    from paddle_tpu_torch.parallel import GeoSGDTrainer, Trainer

    m = _dp4()
    model = W._model(kind, dict(cfg), state)
    tr = Trainer.supervised(model, getattr(TO, opt[0])(*opt[1:]),
                            TM.loss_fn, mesh=m)
    geo = GeoSGDTrainer(tr, sync_every=sync_every)
    sh = tr.data_sharding()
    batch = {"x": sh.local(torch.from_numpy(np.array(x))),
             "label": sh.local(torch.from_numpy(np.array(y))).long()}
    steps_out = []
    assert float(geo.divergence) == 0.0
    for _ in range(steps):
        loss, _ = geo.train_step(batch)
        steps_out.append((float(loss), float(geo.divergence)))

    def state_now():
        return dict(params={n: W.host(p) for n, p in tr.params.items()},
                    buffers={n: W.host(b) for n, b in model.named_buffers()},
                    opt_state=[{k: W.host(v) for k, v in s.items()}
                               for s in tr.opt_state["leaf"]],
                    step=tr.opt_state["step"])

    out = dict(steps=steps_out, replica=state_now(), rank=m.rank)
    if flush:
        geo.sync()
        out["flushed"] = state_now()
        out["divergence"] = float(geo.divergence)
    return out
