"""Fleet: the distributed-training entry point and multi-process bring-up
(counterpart of paddle_tpu/fleet.py; reference:
python/paddle/fluid/incubate/fleet/base/fleet_base.py Fleet,
base/role_maker.py RoleMaker, incubate/fleet/collective DistributedStrategy).

``fleet.init()`` discovers this process's role from the launcher's
environment, joins the ``torch.distributed`` process group when the
world has more than one process (rank 0's endpoint is the TCP store's
address, the role the JAX package's coordination service plays), builds
the mesh the strategy describes over the world's ranks, one device a
process, and hands back the training helpers. Every process is a
worker.

Each process trains on one device: the card ``LOCAL_RANK`` picks (modulo
the cards it sees), or the device an earlier ``set_device`` chose, which
is how a worker asks for the CPU. With no card and no such request
``init`` raises :class:`DeviceUnavailableError`: it never falls back to
the CPU quietly. The backend is NCCL when every rank has a card of its
own and gloo otherwise (the CPU, or ranks sharing one card:
``parallel.collective.init_world``). ``PT_COLLECTIVE_TIMEOUT_S``, which
the launcher sets, bounds how long a collective waits: a collective
whose peer died can otherwise wait for torch's default (30 minutes)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import torch

from .core.enforce import DeviceUnavailableError, enforce
from .core.mesh import build_mesh, build_multihost_mesh, set_mesh

__all__ = ["RoleMaker", "DistributedStrategy", "Fleet", "init", "instance"]

# seconds a collective may wait before it raises (the launcher sets half
# its grace window: a collective left waiting by a dead peer fails in
# time for the survivor to stop preempted; torch's default when unset)
ENV_COLLECTIVE_TIMEOUT = "PT_COLLECTIVE_TIMEOUT_S"


@dataclass
class RoleMaker:
    """Rank discovery. Reads, in priority order: the explicit arguments,
    ``PADDLE_TRAINER_ID``/``PADDLE_TRAINERS_NUM`` and
    ``PADDLE_TRAINER_ENDPOINTS``, torch's ``RANK``/``WORLD_SIZE`` and
    ``MASTER_ADDR:MASTER_PORT``, then the single-process defaults. The
    coordinator is the explicit one, else ``MASTER_ADDR:MASTER_PORT``,
    else rank 0's endpoint."""

    rank: Optional[int] = None
    world_size: Optional[int] = None
    coordinator: Optional[str] = None
    endpoints: Optional[List[str]] = None

    def __post_init__(self):
        env = os.environ
        if self.rank is None:
            self.rank = int(env.get("PADDLE_TRAINER_ID",
                                    env.get("RANK", 0)))
        if self.world_size is None:
            self.world_size = int(env.get("PADDLE_TRAINERS_NUM",
                                          env.get("WORLD_SIZE", 1)))
        if self.endpoints is None:
            eps = env.get("PADDLE_TRAINER_ENDPOINTS", "")
            self.endpoints = [e for e in eps.split(",") if e]
        if self.coordinator is None:
            if env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
                self.coordinator = (f"{env['MASTER_ADDR']}:"
                                    f"{env['MASTER_PORT']}")
            elif self.endpoints:
                self.coordinator = self.endpoints[0]
        enforce(0 <= self.rank < self.world_size,
                "rank %s out of range for world size %s", self.rank,
                self.world_size)

    def is_first_worker(self) -> bool:
        return self.rank == 0

    def worker_num(self) -> int:
        return self.world_size

    def worker_index(self) -> int:
        return self.rank


@dataclass
class DistributedStrategy:
    """How the job's mesh and step are shaped: the axis sizes (``dp``
    None takes the ranks the others leave), the mixed-precision policy,
    gradient accumulation, and which axis spans the hosts
    (``dcn_axis``). ``donate_inputs`` is kept for the JAX package's
    scripts; the port's steps update in place already, so it changes
    nothing."""

    dp: Optional[int] = None
    tp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1
    amp: Optional[str] = None          # mixed-precision policy name
    gradient_merge_steps: int = 1      # microbatch accumulation
    donate_inputs: bool = True
    dcn_axis: str = "dp"


def _rank_device(role: RoleMaker) -> torch.device:
    """This process's device: the one ``set_device`` chose, else the card
    ``LOCAL_RANK`` (else the rank) picks, made the current one."""
    from .core import places

    if places._default_device is not None:
        return places._default_device
    if not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "fleet.init found no CUDA device; a worker that trains on the "
            "CPU asks for it first: set_device(CPUPlace(0))")
    local = int(os.environ.get("LOCAL_RANK", role.rank))
    places.set_device(places.TPUPlace(local % torch.cuda.device_count()))
    return places._default_device


class Fleet:
    """The process-global fleet (``fleet.init()`` and the module-level
    calls use one instance)."""

    def __init__(self):
        self._role: Optional[RoleMaker] = None
        self._strategy = DistributedStrategy()
        self._initialized = False
        self._joined = False
        self.mesh = None
        self.backend: Optional[str] = None

    # -- lifecycle -----------------------------------------------------------

    def init(self, role: Optional[RoleMaker] = None,
             strategy: Optional[DistributedStrategy] = None,
             connect: bool = True) -> "Fleet":
        """Bring up the distributed runtime: with more than one process
        (and ``connect``), join the process group at
        ``tcp://<coordinator>`` (rank 0 hosts its store); then build the
        strategy's mesh over the world's ranks on this process's device
        and make it the current mesh. Without ``connect`` the mesh is a
        layout over the role's ranks unless a process group is up."""
        self._role = role or RoleMaker()
        # always reset: a failed earlier init must not leak its strategy
        self._strategy = strategy if strategy is not None \
            else DistributedStrategy()
        device = _rank_device(self._role)
        if self._role.world_size > 1 and connect:
            enforce(self._role.coordinator is not None,
                    "multi-process fleet needs a coordinator address "
                    "(MASTER_ADDR/MASTER_PORT or PADDLE_TRAINER_ENDPOINTS)")
            from .parallel.collective import init_world

            timeout = os.environ.get(ENV_COLLECTIVE_TIMEOUT)
            self.backend = init_world(
                self._role.rank, self._role.world_size,
                f"tcp://{self._role.coordinator}",
                timeout_s=float(timeout) if timeout else None)
            self._joined = True
        self._initialized = True
        self._build_mesh(device)
        return self

    def _build_mesh(self, device):
        s = self._strategy
        n = self._role.world_size
        model_par = s.tp * s.pp * s.sp * s.ep
        dp = s.dp if s.dp is not None else max(n // model_par, 1)
        enforce(dp * model_par == n,
                "strategy (dp=%s tp=%s pp=%s sp=%s ep=%s) does not cover "
                "%s devices", dp, s.tp, s.pp, s.sp, s.ep, n)
        enforce(s.dcn_axis in ("dp", "pp", "tp", "sp", "ep"),
                "unknown dcn_axis %r (mesh axes: dp/pp/tp/sp/ep)",
                s.dcn_axis)
        ranks = list(range(n))
        if n > 1 and s.dcn_axis != "dp":
            self.mesh = build_multihost_mesh(
                n, dcn_axis=s.dcn_axis, dp=dp, tp=s.tp, pp=s.pp, sp=s.sp,
                ep=s.ep, devices=ranks, device=device)
        else:
            self.mesh = build_mesh(dp=dp, tp=s.tp, pp=s.pp, sp=s.sp,
                                   ep=s.ep, devices=ranks, device=device)
        set_mesh(self.mesh)

    def shutdown(self):
        """Leave the process group this fleet joined."""
        if self._joined:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
            self._joined = False
        self._initialized = False

    # -- role queries --------------------------------------------------------

    @property
    def initialized(self) -> bool:
        return self._initialized

    def is_first_worker(self) -> bool:
        self._check()
        return self._role.is_first_worker()

    def worker_index(self) -> int:
        self._check()
        return self._role.worker_index()

    def worker_num(self) -> int:
        self._check()
        return self._role.worker_num()

    def worker_endpoints(self) -> List[str]:
        self._check()
        return list(self._role.endpoints or [])

    # -- training helpers ----------------------------------------------------

    def distributed_optimizer(self, optimizer):
        """``optimizer`` under the strategy: decorated for its AMP policy
        (the gradient mean over dp is the Trainer's)."""
        self._check()
        if self._strategy.amp:
            from .amp import decorate

            optimizer = decorate(optimizer, policy=self._strategy.amp)
        return optimizer

    def trainer(self, model, optimizer, loss_fn, metrics_fn=None, **kw):
        """A supervised Trainer on the fleet's mesh with the strategy's
        policy and accumulation."""
        self._check()
        from .parallel.api import Trainer

        return Trainer.supervised(
            model, optimizer, loss_fn, metrics_fn, mesh=self.mesh,
            amp=self._strategy.amp,
            grad_accum_steps=self._strategy.gradient_merge_steps, **kw)

    def controller(self, **kw):
        """A :class:`resilience.FleetController` for this role (a full
        ``init`` is not needed: rank and world come from the role's
        environment), its transport the process group's store when one
        is up, else the file root ``PT_FLEET_DIR``. Give it to
        ``TrainLoop.run(controller=...)``."""
        from .resilience.controller import FleetController

        role = self._role if self._role is not None else RoleMaker()
        kw.setdefault("rank", role.rank)
        kw.setdefault("world", role.world_size)
        return FleetController(**kw)

    def _check(self):
        enforce(self._initialized, "call fleet.init() first")


# the module-level singleton: ``from paddle_tpu_torch import fleet;
# fleet.init()``
_fleet = Fleet()


def init(role: Optional[RoleMaker] = None,
         strategy: Optional[DistributedStrategy] = None,
         connect: bool = True) -> Fleet:
    return _fleet.init(role=role, strategy=strategy, connect=connect)


def instance() -> Fleet:
    return _fleet


def __getattr__(name):
    # module attributes delegate to the singleton (fleet.worker_num() ...)
    if hasattr(Fleet, name) and not name.startswith("_"):
        return getattr(_fleet, name)
    raise AttributeError(name)
