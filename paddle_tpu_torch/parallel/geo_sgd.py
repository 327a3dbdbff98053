"""Geo-async training, the communicator capability (counterpart of
paddle_tpu/parallel/geo_sgd.py; reference:
paddle/fluid/operators/distributed/communicator.h:160 Communicator: a
background thread batching gradient pushes to the parameter server every
``geo_sgd_need_push_nums`` steps, the trainers running on stale local
parameters between pushes).

No RPC and no parameter server: each data-parallel worker trains its own
replica of the parameters, buffers and optimizer state on its own rows,
and every ``sync_every`` steps the replicas average their parameters
over the axis (local SGD / federated averaging), so the traffic is 1/K
of a data-parallel step's.

Multi-controller (core/mesh.py): the JAX package stacks the replicas
along a leading worker axis and steps them inside one ``shard_map``; in
the port each rank holds its replica, which is the wrapped trainer's own
state (no stacked axis: the rank is the replica). A local step is the
trainer's forward and backward on the rank's rows inside
``core.mesh.local_batch()`` (its losses and batch statistics the rank's)
with no gradient reduce, then the optimizer's update: reusing the mesh
Trainer's step would average the gradients over dp and turn geo-SGD into
plain data parallelism. Use::

    geo = GeoSGDTrainer(trainer, sync_every=16)
    for batch in loader:                 # the rank's rows
        loss, _ = geo.train_step(batch)  # local step; averages every 16
    geo.sync()                           # parameters, buffers, moments
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..clip import tree_leaves
from ..core.enforce import enforce
from ..core.mesh import local_batch
from ..core.random import fold_in, split_key


class GeoSGDTrainer:
    """Wrap a ``parallel.Trainer`` built with ``mesh=`` so each rank of
    ``axis`` trains its own replica, averaged over the axis every
    ``sync_every`` steps."""

    def __init__(self, trainer, sync_every: int = 16, axis: str = "dp"):
        enforce(sync_every >= 1, "sync_every must be >= 1, got %s",
                sync_every)
        self.trainer = trainer
        self.sync_every = sync_every
        self.axis = axis
        self.mesh = trainer.mesh
        enforce(self.mesh is not None and axis in self.mesh.shape,
                "mesh has no %r axis", axis)
        self._since_sync = 0

    # -- the averages ---------------------------------------------------------

    def _average(self, tensors) -> None:
        """Set each float tensor of ``tensors`` to its mean over the axis,
        in place (one collective per dtype)."""
        from .collective import sum_over

        ts = [t for t in tensors
              if torch.is_tensor(t) and t.is_floating_point()]
        n = self.mesh.axis_size(self.axis)
        with torch.no_grad():
            for t, total in zip(ts, sum_over(ts, lambda i: (self.axis,),
                                             self.mesh)):
                t.copy_(total / n)

    def _params(self):
        return list(self.trainer.params.values())

    # -- driver -------------------------------------------------------------

    def train_step(self, batch) -> Tuple[torch.Tensor, dict]:
        """One local step of this rank's replica on its rows of the batch
        (the key split off the trainer's, folded with the rank's index on
        the axis); every ``sync_every``-th call averages the parameters
        over the axis. Returns the mean of the ranks' losses."""
        from .collective import allreduce

        tr = self.trainer
        tr._key, sub = split_key(tr._key)
        key = fold_in(sub, self.mesh.axis_index(self.axis))
        with local_batch():
            loss, _, grads = tr._loss_and_grads(batch, key)
        tr.optimizer.apply(tr.params, grads, tr.opt_state)
        self._since_sync += 1
        if self._since_sync >= self.sync_every:
            self._average(self._params())
            self._since_sync = 0
        loss = allreduce(loss.detach().reshape(1), self.axis, "mean",
                         mesh=self.mesh)[0]
        return loss, {}

    def sync(self) -> None:
        """Flush: average the parameters, the buffers and the optimizer
        state over the axis now, in the wrapped trainer (its state is the
        replica), so evaluation and resume see the consensus running
        statistics and moments (reference: Communicator flush on barrier
        or save)."""
        tr = self.trainer
        self._average(self._params() + list(tr._buffers().values())
                      + tree_leaves(tr.opt_state))
        self._since_sync = 0

    @property
    def divergence(self) -> torch.Tensor:
        """The largest |replica - mean of the replicas| over the
        parameters, the same on every rank (0 right after a sync): a
        staleness hook. Every rank of the axis must call it."""
        from .collective import allreduce

        params = self._params()
        with torch.no_grad():
            flat = torch.cat([p.detach().reshape(-1).float()
                              for p in params])
            mean = allreduce(flat, self.axis, "mean", mesh=self.mesh)
            spread = (flat - mean).abs().max().reshape(1)
            return allreduce(spread, self.axis, "max", mesh=self.mesh)[0]
