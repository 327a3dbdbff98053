"""The elastic fleet controller (counterpart of
paddle_tpu/resilience/controller.py): the control plane that agrees on
one "preempt at step N" for a job of many processes, makes every
periodic save a step-agreed two-phase transaction, and agrees on one
restore step at resume.

The pieces:

- :class:`FleetController`: one per rank, driven by
  ``TrainLoop.run(controller=...)``. On a preemption notice (its
  :class:`~.preemption.PreemptionHandler`'s SIGTERM flag, the notice
  watcher, or a peer's published ack) the rank publishes
  ``preempt.ack.<rank> = <its step>`` and holds; once every live rank's
  ack is in, the agreed step is ``max(acks)``: held ranks train up to
  it, every rank commits that step, and :meth:`confirm_committed` keeps
  a rank from reporting a clean exit before the whole fleet's
  checkpoint is on disk. Ranks whose steps are collective (a plan over
  the process group) cannot hold at different boundaries without
  deadlocking in the next step: they agree in lockstep
  (:meth:`FleetController.check`), each acking the step after the one
  it noticed at and training on until every ack is in.
- Transports. :class:`ClientTransport` rides a ``torch.distributed``
  store (the default process group's: the TCPStore that ``fleet.init``
  brings up, or the FileStore of the tests) where the JAX package rides
  its coordination service; :class:`FileTransport` is the
  shared-filesystem fallback, with the JAX package's key layout
  ``<root>/<run_id>.<key>`` byte for byte, so the two packages can share
  one root. Keys are namespaced by a per-attempt ``run_id``, so an
  elastic restart never reads a dead attempt's state.
- A notice watcher thread polls a :class:`FileNotice` or
  :class:`HttpNotice` (``PT_PREEMPT_NOTICE``) and raises the preempt
  flag ahead of SIGTERM.
- :class:`BarrierTimeoutError`: what every coordination wait
  (checkpoint barriers included) raises on expiry, naming the ranks
  that never arrived.

Every wait here is on the store or on files, never a device
collective: the checkpoint writer thread runs while the training step's
collectives use the process group (under NCCL an interleaved barrier
hangs). A c10d store differs from the JAX key-value service in three
ways the transport absorbs: a ``get`` of a missing key blocks until the
store's timeout (probed with ``check`` first), the store cannot list
its keys (``sweep`` returns 0, as the JAX ``ClientTransport.sweep``
does), and a store whose host rank died raises on every call (read as a
missing key, so a wait ends in a :class:`BarrierTimeoutError` naming
the rank, never a hang).

``launch.py --elastic`` closes the loop: a dead worker is marked
``dead.<rank>`` on the file root (survivors drop it from agreement and
exit clean within the grace window) and the job respawns on N-1 ranks
from the last globally committed checkpoint.

Pod-level aggregation, as in the JAX package: each rank publishes its
debug server's endpoint on the transport (``publish_endpoint``), and any
rank's ``/podz`` fans out to every rank's /healthz, /statusz and /memz
(``podz``), its ``/tracez?trace_id=`` to every rank's trace ring, merged
into one clock-aligned chrome trace (``tracez_fanout``). The agreement,
the commits and the staged saves leave events on the trace ring
(``fleet.preempt.*``, ``fleet.commit.confirmed``, ``fleet.ckpt.*``)
while telemetry is on."""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from .. import telemetry
from ..core.enforce import EnforceError, enforce
from ..telemetry import tracing as _tracing
from ..utils.atomic import atomic_write_text
from . import faults as _faults
from .preemption import PreemptionHandler
from .retry import RetryPolicy, retry_io

__all__ = [
    "BarrierTimeoutError", "ClientTransport", "FileNotice",
    "FleetController", "HttpNotice", "active", "auto_transport",
    "notice_source_from_env",
]

_ACTIVE: Optional["FleetController"] = None

# Transport writes retry under a short deadline-bounded policy: a
# shared-FS blip (OSError) or a store hiccup (RuntimeError: torch's
# DistStoreError is one) costs a bounded backoff, never a torn commit
# or a wedge.
_KV_POLICY = RetryPolicy(max_attempts=4, base_delay_s=0.02,
                         max_delay_s=0.5, deadline_s=10.0,
                         retry_on=(OSError, RuntimeError))

# the env protocol (launch.py sets it for every worker):
ENV_FLEET_DIR = "PT_FLEET_DIR"       # FileTransport root (shared FS)
ENV_RUN_ID = "PT_FLEET_RUN_ID"       # per-attempt key namespace
ENV_NOTICE = "PT_PREEMPT_NOTICE"     # notice source: http(s) URL | path


@telemetry.cached_instruments
def _fleet_metrics(reg):
    return {
        "agreements": reg.counter(
            "pt_fleet_preempt_agreements_total",
            "coordinated preempt-at-step agreements reached"),
        "notices": reg.counter(
            "pt_fleet_preempt_notices_total",
            "preemption notices raised by the metadata watcher"),
        "barrier_timeouts": reg.counter(
            "pt_barrier_timeouts_total",
            "coordination barrier / fleet-agreement waits that "
            "timed out"),
        "commit_lag": reg.gauge(
            "pt_checkpoint_commit_lag_steps",
            "steps this rank's newest staged checkpoint is ahead of "
            "the fleet's newest globally-committed step (commit "
            "drift; 0 = the whole fleet is caught up)"),
    }


def note_barrier_timeout() -> None:
    """Count one coordination-wait expiry in ``pt_barrier_timeouts_total``
    (the checkpoint barriers share it)."""
    if telemetry.enabled():
        _fleet_metrics()["barrier_timeouts"].inc()


class BarrierTimeoutError(EnforceError):
    """A coordination wait (checkpoint barrier, preempt agreement,
    commit confirmation) expired; ``missing`` names the ranks that never
    arrived. An :class:`EnforceError`, so the train loop propagates it:
    a half-agreed fleet fails loudly, never recovers into divergence."""

    def __init__(self, tag: str, *, missing: Optional[List[int]] = None,
                 world: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 detail: Optional[str] = None):
        self.tag = tag
        self.missing = sorted(missing) if missing else []
        self.world = world
        self.timeout_s = timeout_s
        who = (f"missing ranks {self.missing}" if self.missing
               else "missing ranks unknown (coordination-service "
                    "barrier)")
        msg = (f"barrier/agreement '{tag}' timed out after "
               f"{timeout_s}s ({who}, world={world})")
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


# ---------------------------------------------------------------------------
# Coordination transports
# ---------------------------------------------------------------------------

class FileTransport:
    """Shared-filesystem key-value store: one atomically published file
    per key, ``<root>/<run_id>.<key>`` (the JAX package's layout), so a
    successor attempt never reads a dead one's keys."""

    kind = "file"

    def __init__(self, root: str, run_id: str = "r0",
                 stale_age_s: float = 120.0):
        self.root = root
        self.run_id = run_id
        self.stale_age_s = stale_age_s

    def _path(self, key: str) -> str:
        return os.path.join(self.root, f"{self.run_id}.{key}")

    def put(self, key: str, value: str) -> None:
        os.makedirs(self.root, exist_ok=True)
        atomic_write_text(self._path(key), value)

    def get(self, key: str) -> Optional[str]:
        try:
            with open(self._path(key)) as f:
                return f.read()
        except OSError:
            return None

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except OSError:
            pass  # already gone (a peer reclaimed it first)

    def sweep(self) -> int:
        """Remove other runs' keys older than ``stale_age_s``; returns
        how many went."""
        prefix = self.run_id + "."
        try:
            names = os.listdir(self.root)
        except OSError:
            return 0
        removed = 0
        now = time.time()
        for name in names:
            if name.startswith(prefix):
                continue
            path = os.path.join(self.root, name)
            try:
                if now - os.path.getmtime(path) > self.stale_age_s:
                    os.unlink(path)
                    removed += 1
            except OSError:
                pass  # a peer swept it first
        return removed


class ClientTransport:
    """A ``torch.distributed`` store (``TCPStore``, ``FileStore``,
    ``HashStore`` or a ``PrefixStore`` over one) as the transport; keys
    are ``pt_fleet/<run_id>/<key>``.

    ``get`` probes with ``check`` (a store's ``get`` of a missing key
    blocks until the store's timeout) and reads a store error as a
    missing key: when the rank that hosts a TCPStore dies, every call
    of the survivors raises, and their waits must end in the typed
    timeout naming the missing ranks. ``delete`` leaves the key: a peer
    may be between its ``check`` and its ``get`` of it, and the store
    dies with the job."""

    kind = "client"

    def __init__(self, client, run_id: str = "r0"):
        self._client = client
        self.run_id = run_id

    def _key(self, key: str) -> str:
        return f"pt_fleet/{self.run_id}/{key}"

    def put(self, key: str, value: str) -> None:
        self._client.set(self._key(key), value)

    def get(self, key: str) -> Optional[str]:
        k = self._key(key)
        try:
            if not self._client.check([k]):
                return None
            return self._client.get(k).decode()
        except Exception:
            return None

    def delete(self, key: str) -> None:
        pass

    def sweep(self) -> int:
        return 0  # the store dies with the job; nothing persists


def coordination_client():
    """The default process group's store, or None without a process
    group (a single process, or ``fleet.init(connect=False)``)."""
    try:
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            return None
        from torch.distributed.distributed_c10d import _get_default_store

        return _get_default_store()
    except Exception:
        return None


def auto_transport(*, run_id: Optional[str] = None,
                   root: Optional[str] = None):
    """The store transport when a process group is up, else the file
    fallback (root: ``root``, else ``PT_FLEET_DIR``, else
    ``./.pt_fleet``)."""
    run_id = run_id or os.environ.get(ENV_RUN_ID) or "r0"
    client = coordination_client()
    if client is not None:
        return ClientTransport(client, run_id)
    root = (root or os.environ.get(ENV_FLEET_DIR)
            or os.path.join(os.getcwd(), ".pt_fleet"))
    return FileTransport(root, run_id)


# ---------------------------------------------------------------------------
# Preemption notice sources (the watcher's input)
# ---------------------------------------------------------------------------

class FileNotice:
    """The notice is a file appearing at ``path``."""

    def __init__(self, path: str):
        self.path = path

    def poll(self) -> bool:
        return os.path.exists(self.path)

    def describe(self) -> str:
        return f"file:{self.path}"


class HttpNotice:
    """A metadata poller: a body other than ``NONE`` (or one containing
    ``trigger``, when given) at ``url`` is a notice. The default URL is
    the instance maintenance-event endpoint of a cloud metadata
    server."""

    DEFAULT_URL = ("http://metadata.google.internal/computeMetadata/v1/"
                   "instance/maintenance-event")

    def __init__(self, url: Optional[str] = None,
                 trigger: Optional[str] = None,
                 timeout_s: float = 2.0):
        self.url = url or self.DEFAULT_URL
        self.trigger = trigger
        self.timeout_s = timeout_s

    def poll(self) -> bool:
        import urllib.request

        req = urllib.request.Request(
            self.url, headers={"Metadata-Flavor": "Google"})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            body = r.read().decode("utf-8", "replace").strip()
        if self.trigger is not None:
            return self.trigger in body
        return body not in ("", "NONE")

    def describe(self) -> str:
        return f"http:{self.url}"


def notice_source_from_env(env=None):
    """The notice source ``PT_PREEMPT_NOTICE`` names: an ``http(s)://``
    URL is an :class:`HttpNotice`, anything else a :class:`FileNotice`
    path; None when unset."""
    env = os.environ if env is None else env
    spec = env.get(ENV_NOTICE)
    if not spec:
        return None
    if spec.startswith("http://") or spec.startswith("https://"):
        return HttpNotice(spec)
    return FileNotice(spec)


def _fetch_json(url: str, timeout_s: float = 2.0):
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as r:
            return json.loads(r.read().decode("utf-8"))
    except Exception as e:  # per-rank rows degrade, /podz never 500s
        return {"error": repr(e)}


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------


class FleetController:
    """One rank's view of the fleet control plane.

    Protocol (symmetric: no special rank, so losing any rank degrades
    the same way):

    1. A rank notices preemption: its handler's flag, :meth:`request`,
       or (sampled every ``poll_interval_s``) the shared
       ``preempt.flag`` a peer published.
    2. It publishes ``preempt.ack.<rank> = <its step>`` and holds until
       every live rank's ack is present (ranks marked ``dead.<rank>``
       by the launcher, or ``done.<rank>`` by a clean exit, drop out).
       Expiry raises :class:`BarrierTimeoutError` naming the missing.
    3. The agreed step is ``max(acks)``: no rank rewinds; held ranks
       train up to it, then every rank commits it and confirms through
       ``committed.<rank>``.

    ``rank``/``world`` default to ``PADDLE_TRAINER_ID`` /
    ``PADDLE_TRAINERS_NUM``, then torch's ``RANK`` / ``WORLD_SIZE``."""

    def __init__(self, *, rank: Optional[int] = None,
                 world: Optional[int] = None,
                 transport=None,
                 handler: Optional[PreemptionHandler] = None,
                 notice_source=None,
                 coordination_dir: Optional[str] = None,
                 run_id: Optional[str] = None,
                 poll_interval_s: float = 0.25,
                 hold_poll_s: float = 0.02,
                 watch_interval_s: float = 2.0,
                 agree_timeout_s: float = 60.0,
                 commit_timeout_s: float = 300.0,
                 ckpt_timeout_s: float = 300.0,
                 dead_grace_s: float = 5.0,
                 podz_fetch_timeout_s: float = 2.0):
        env = os.environ
        if rank is None:
            rank = int(env.get("PADDLE_TRAINER_ID", env.get("RANK", 0)))
        if world is None:
            world = int(env.get("PADDLE_TRAINERS_NUM",
                                env.get("WORLD_SIZE", 1)))
        enforce(0 <= rank < world,
                "rank %s out of range for world size %s", rank, world)
        self.rank = rank
        self.world = world
        self.run_id = run_id or env.get(ENV_RUN_ID) or "r0"
        if transport is None and world > 1:
            transport = auto_transport(run_id=self.run_id,
                                       root=coordination_dir)
        self.transport = transport
        # the launcher writes its dead markers to the file root whatever
        # the workers coordinate over: consult it beside a store
        self._marker_transport = None
        if transport is not None and \
                getattr(transport, "kind", "") != "file":
            root = coordination_dir or os.environ.get(ENV_FLEET_DIR)
            if root:
                self._marker_transport = FileTransport(root,
                                                       self.run_id)
        self.handler = handler if handler is not None \
            else PreemptionHandler()
        if notice_source is None:
            notice_source = notice_source_from_env()
        self.notice_source = notice_source
        self.poll_interval_s = poll_interval_s
        self.hold_poll_s = hold_poll_s
        self.watch_interval_s = watch_interval_s
        self.agree_timeout_s = agree_timeout_s
        self.commit_timeout_s = commit_timeout_s
        self.ckpt_timeout_s = ckpt_timeout_s
        self.dead_grace_s = dead_grace_s
        self.podz_fetch_timeout_s = podz_fetch_timeout_s
        self._own_endpoint: Optional[str] = None
        self.acked_step: Optional[int] = None
        self._ack_at: Optional[float] = None
        self.agreed_step: Optional[int] = None
        self.last_checkpoint_step: Optional[int] = None
        self.last_committed_step: Optional[int] = None
        # the staged-key ledger: async writer threads running
        # coordinated saves touch it
        self._staged_steps: List[int] = []
        self._staged_lock = threading.Lock()
        self.last_staged_step: Optional[int] = None
        self.last_global_commit_step: Optional[int] = None
        self.last_commit_barrier_s: Optional[float] = None
        self.agreed_restore_step: Optional[int] = None
        self.committed_view: Optional[Dict[int, int]] = None
        self.last_wait_s: Optional[float] = None
        # the watcher thread and the loop both write these
        self._req_mu = threading.Lock()
        self.request_reason: Optional[str] = None
        self._notice = False
        # the throttle starts now: no transport read until one interval
        # has elapsed
        self._last_peek = time.monotonic()
        self._watch_error: Optional[str] = None
        self._watcher: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._started = False

    # -- lifecycle ----------------------------------------------------------

    @property
    def started(self) -> bool:
        return self._started

    def start(self) -> "FleetController":
        """Become the process's active controller, sweep dead runs'
        transport litter and start the notice watcher (when a source is
        configured)."""
        global _ACTIVE
        if self._started:
            return self
        self._started = True
        _ACTIVE = self
        if self.transport is not None:
            self.transport.sweep()
        if self.notice_source is not None:
            self._stop_evt.clear()
            self._watcher = threading.Thread(
                target=self._watch, daemon=True,
                name="pt-fleet-watcher")
            self._watcher.start()
        return self

    def stop(self) -> None:
        global _ACTIVE
        self._stop_evt.set()
        if self._watcher is not None:
            self._watcher.join(timeout=5)
            self._watcher = None
        if _ACTIVE is self:
            _ACTIVE = None
        self._started = False

    def __enter__(self) -> "FleetController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- preemption notice --------------------------------------------------

    def request(self, reason: str = "api") -> None:
        """Raise the preempt flag without a signal; the next
        :meth:`check` starts the agreement."""
        with self._req_mu:
            self.request_reason = self.request_reason or reason
            self._notice = True
        if telemetry.enabled():
            # the agreement's breadcrumbs on the trace ring: the fleet
            # /tracez fan-in shows request -> acks -> agreement on each
            # rank's lane beside its step spans
            _tracing.event("fleet.preempt.request", rank=self.rank,
                           reason=reason)
        self.handler.request()

    def _requested(self) -> bool:
        if self._notice:
            return True
        if self.handler.requested():
            with self._req_mu:
                self.request_reason = self.request_reason or "signal"
            return True
        return False

    def _watch(self) -> None:
        """Poll the notice source (and the ``fleet.notice`` injection
        point: a ``corrupt`` rule is a synthetic notice) until a notice
        lands, then raise the flag once and exit. A failing poll is
        recorded, never fatal."""
        while not self._stop_evt.wait(self.watch_interval_s):
            try:
                inj = _faults.active()
                fired = (inj is not None
                         and bool(inj.fire("fleet.notice")))
                if fired or self.notice_source.poll():
                    if telemetry.enabled():
                        _fleet_metrics()["notices"].inc()
                    self.request(reason="notice")
                    return
            except Exception as e:
                with self._req_mu:
                    self._watch_error = repr(e)

    # -- the agreement ------------------------------------------------------

    def _marker(self, key: str) -> Optional[str]:
        """``key`` on the transport or on the launcher's file root."""
        v = (self.transport.get(key)
             if self.transport is not None else None)
        if v is None and self._marker_transport is not None:
            v = self._marker_transport.get(key)
        return v

    def _live_ranks(self) -> List[int]:
        """The ranks still taking part: neither marked dead by the
        launcher nor announced done. This rank always counts."""
        if self.transport is None:
            return [self.rank]
        return [r for r in range(self.world)
                if r == self.rank
                or (self._marker(f"dead.{r}") is None
                    and self._marker(f"done.{r}") is None)]

    def _peer_ack_seen(self) -> bool:
        # one well-known key: the hot-path sample is O(1) at any world
        if self.transport is None:
            return False
        return self.transport.get("preempt.flag") is not None

    def _wait_all_raw(self, prefix: str, *, timeout_s: float,
                      what: str) -> Dict[int, str]:
        """Gather ``<prefix>.<rank>``: wait only on live ranks, but keep
        every published value (a rank that published and then died still
        counts, so every survivor computes the same result)."""
        deadline = time.monotonic() + timeout_s
        t0 = time.monotonic()
        while True:
            vals: Dict[int, str] = {}
            for r in range(self.world):
                v = self.transport.get(f"{prefix}.{r}")
                if v is not None:
                    vals[r] = v
            missing = [r for r in self._live_ranks()
                       if r not in vals]
            if not missing:
                self.last_wait_s = round(time.monotonic() - t0, 3)
                return vals
            if time.monotonic() >= deadline:
                note_barrier_timeout()
                raise BarrierTimeoutError(
                    what, missing=missing, world=self.world,
                    timeout_s=timeout_s)
            time.sleep(self.hold_poll_s)

    def _wait_all(self, prefix: str, *, timeout_s: float,
                  what: str) -> Dict[int, int]:
        return {r: int(v) for r, v in self._wait_all_raw(
            prefix, timeout_s=timeout_s, what=what).items()}

    def check(self, step: int, lockstep: bool = False) -> Optional[int]:
        """The per-step drive: the agreed preempt step once one exists
        (the loop commits when ``step >= agreed``), else None. Until a
        preemption is in flight it costs a flag peek and a transport
        read at most every ``poll_interval_s``.

        ``lockstep``: the ranks' steps are collective (a trainer whose
        mesh spans the process group), so no rank can finish a step
        its peers have not started, and a rank that held at a boundary
        while a peer ran the next step would deadlock both. Then the
        flag is read at every boundary, a rank that notices at boundary
        ``n`` acks ``n + 1`` and trains on, and the agreement is
        ``max(acks)`` once every live rank's ack is visible: every rank
        notices by the boundary after the first notice, so all see every
        ack by the boundary after that, which is at most ``max(acks)``;
        no rank passes the agreed step and none holds (:meth:`_agree`)."""
        if self.agreed_step is not None:
            return self.agreed_step
        requested = self._requested()
        if not requested and self.world > 1:
            now = time.monotonic()
            if lockstep or now - self._last_peek >= self.poll_interval_s:
                self._last_peek = now
                if self._peer_ack_seen():
                    requested = True
                    with self._req_mu:
                        self.request_reason = (self.request_reason
                                               or "peer")
        if not requested:
            return None
        return self._agree(step, lockstep)

    def _agree(self, step: int, lockstep: bool = False) -> Optional[int]:
        if self.world <= 1 or self.transport is None:
            self.agreed_step = int(step)
        elif lockstep:
            if self.acked_step is None:
                self.acked_step = int(step) + 1
                self._ack_at = time.monotonic()
                self.transport.put(f"preempt.ack.{self.rank}",
                                   str(self.acked_step))
                self.transport.put("preempt.flag", str(self.rank))
                self._event_ack()
            acks: Dict[int, int] = {}
            for r in range(self.world):
                v = self.transport.get(f"preempt.ack.{r}")
                if v is not None:
                    acks[r] = int(v)
            missing = [r for r in self._live_ranks() if r not in acks]
            if missing:
                if time.monotonic() - self._ack_at >= self.agree_timeout_s:
                    note_barrier_timeout()
                    raise BarrierTimeoutError(
                        "preempt-agreement", missing=missing,
                        world=self.world, timeout_s=self.agree_timeout_s)
                return None  # train on: the peers' acks are on the way
            self.agreed_step = max(acks.values())
        else:
            if self.acked_step is None:
                # publish, then hold: the ack freezes this rank's step,
                # so max(acks) is a step no rank has passed
                self.acked_step = int(step)
                self.transport.put(f"preempt.ack.{self.rank}",
                                   str(int(step)))
                self.transport.put("preempt.flag", str(self.rank))
                self._event_ack()
            acks = self._wait_all("preempt.ack",
                                  timeout_s=self.agree_timeout_s,
                                  what="preempt-agreement")
            self.agreed_step = max(acks.values())
        if telemetry.enabled():
            _fleet_metrics()["agreements"].inc()
            _tracing.event("fleet.preempt.agreed", rank=self.rank,
                           step=int(self.agreed_step))
        return self.agreed_step

    def _event_ack(self) -> None:
        if telemetry.enabled():
            _tracing.event("fleet.preempt.ack", rank=self.rank,
                           step=int(self.acked_step))

    def confirm_committed(self, step: int) -> Dict[int, int]:
        """Publish this rank's committed step and wait for every live
        rank's; returns {rank: step}."""
        step = int(step)
        if self.world <= 1 or self.transport is None:
            self.last_committed_step = step
            self.committed_view = {self.rank: step}
            return dict(self.committed_view)
        self.transport.put(f"committed.{self.rank}", str(step))
        vals = self._wait_all("committed",
                              timeout_s=self.commit_timeout_s,
                              what="commit-confirmation")
        self.last_committed_step = step
        self.committed_view = vals
        if telemetry.enabled():
            _tracing.event("fleet.commit.confirmed", rank=self.rank,
                           step=step)
        return vals

    def note_checkpoint(self, step: int) -> None:
        """Record the newest step a save targeted."""
        self.last_checkpoint_step = int(step)
        self._update_commit_lag()

    def note_done(self, step: int) -> None:
        """Announce a clean exit, so peers drop this rank from later
        agreements (best effort: the launcher's dead marker and grace
        kill bound the rest)."""
        if self.transport is None:
            return
        try:
            self.transport.put(f"done.{self.rank}", str(int(step)))
        except Exception:
            pass  # a failed announce degrades to the agreement timeout

    # -- step-agreed periodic saves (two-phase global commit) ---------------
    #
    # Each rank stages its step-N checkpoint, publishes
    # ``ckpt.staged.<N>.<rank>``, and the global ``ckpt.committed.<N>``
    # lands once every live rank staged. CheckpointManager(coordinator=)
    # drives this and mirrors the commit into a per-step
    # GLOBAL_COMMITTED file, the record a restarted fleet trusts.

    def _kv_put(self, key: str, value: str) -> None:
        enforce(self.transport is not None,
                "no coordination transport (world=%s)", self.world)
        retry_io(lambda: self.transport.put(key, value),
                 policy=_KV_POLICY, what="fleet.kv_put")

    def note_stage(self, step: int) -> None:
        """Phase 1: this rank's step-``step`` checkpoint is on disk."""
        step = int(step)
        self._kv_put(f"ckpt.staged.{step}.{self.rank}", str(step))
        with self._staged_lock:
            self._staged_steps.append(step)
        self.last_staged_step = step
        self._update_commit_lag()
        if telemetry.enabled():
            _tracing.event("fleet.ckpt.staged", rank=self.rank, step=step)

    def wait_global_commit(self, step: int) -> Optional[float]:
        """Phase 2: hold until every live rank staged ``step``, then land
        the global marker (every rank writes the same value). Returns
        the wait in seconds, or None when the commit defers to a
        preempt agreement in flight (a rank that published the preempt
        flag holds in its ack wait and will not stage this step until
        the agreement resolves; the step stays staged, and the agreed
        step's save commits).

        Before any agreement a rank marked dead fails the commit after
        ``dead_grace_s`` (the launcher's teardown SIGTERM normally lands
        first and routes the save into the coordinated exit): committing
        without its regions would publish a torn step. After an
        agreement the fleet already dropped it. Ranks announced done
        never hold the commit."""
        step = int(step)
        what = f"ckpt-commit step {step}"
        t0 = time.monotonic()
        deadline = t0 + self.ckpt_timeout_s
        prefix = f"ckpt.staged.{step}"
        dead_seen_at: Optional[float] = None
        while True:
            missing: List[int] = []
            dead: List[int] = []
            for r in range(self.world):
                if r == self.rank:
                    continue
                if self.transport.get(f"{prefix}.{r}") is not None:
                    continue
                if self._marker(f"done.{r}") is not None:
                    continue
                if self._marker(f"dead.{r}") is not None:
                    if self.agreed_step is not None:
                        continue  # the agreement dropped it already
                    dead.append(r)
                else:
                    missing.append(r)
            if not missing and not dead:
                break
            if self.transport.get(f"ckpt.committed.{step}") \
                    is not None:
                break  # a peer landed the commit: that is the outcome
            if self.agreed_step is None and (
                    self._requested()
                    or self.transport.get("preempt.flag") is not None):
                return None
            if dead:
                if dead_seen_at is None:
                    dead_seen_at = time.monotonic()
                if time.monotonic() - dead_seen_at >= \
                        self.dead_grace_s:
                    note_barrier_timeout()
                    raise BarrierTimeoutError(
                        what, missing=dead + missing,
                        world=self.world,
                        timeout_s=self.ckpt_timeout_s,
                        detail=f"rank(s) {dead} died mid-commit")
                time.sleep(self.hold_poll_s)
                continue
            if time.monotonic() >= deadline:
                note_barrier_timeout()
                raise BarrierTimeoutError(
                    what, missing=missing, world=self.world,
                    timeout_s=self.ckpt_timeout_s)
            time.sleep(self.hold_poll_s)
        self._kv_put(f"ckpt.committed.{step}", str(step))
        wait_s = time.monotonic() - t0
        if self.last_global_commit_step is None or \
                step > self.last_global_commit_step:
            self.last_global_commit_step = step
        # a commit of N proves every live rank finished the saves below
        # N: reclaim this rank's older staged keys (the committed markers
        # stay: a late waiter falls back to them)
        with self._staged_lock:
            reclaim = [s for s in self._staged_steps if s < step]
            self._staged_steps = [s for s in self._staged_steps
                                  if s >= step]
        for s in reclaim:
            self.transport.delete(f"ckpt.staged.{s}.{self.rank}")
        self.last_commit_barrier_s = round(wait_s, 4)
        self._update_commit_lag()
        if telemetry.enabled():
            _tracing.event("fleet.ckpt.global_commit", rank=self.rank,
                           step=step)
        return wait_s

    def global_commit_seen(self, step: int) -> bool:
        """Whether the fleet-wide commit marker for ``step`` is on the
        transport."""
        if self.transport is None:
            return False
        return self.transport.get(f"ckpt.committed.{int(step)}") \
            is not None

    def agree_restore_step(self, local_steps) -> Optional[int]:
        """Restore-time agreement: every rank publishes the steps it can
        restore and the fleet restores the newest step every live rank
        has (None: a cold start on every rank). Runs before training, so
        the rank set is the launcher's spawned set."""
        steps = sorted({int(s) for s in local_steps})
        if self.world <= 1 or self.transport is None:
            agreed = steps[-1] if steps else None
        else:
            self._kv_put(f"restore.steps.{self.rank}",
                         json.dumps(steps))
            if not steps:
                # the intersection is empty whatever the peers hold; the
                # published empty list lets each peer see that too
                agreed = None
            else:
                vals = self._wait_all_raw(
                    "restore.steps", timeout_s=self.agree_timeout_s,
                    what="restore-agreement")
                common: Optional[set] = None
                for v in vals.values():
                    s = set(json.loads(v))
                    common = s if common is None else (common & s)
                agreed = max(common) if common else None
        self.agreed_restore_step = agreed
        if agreed is not None and (
                self.last_global_commit_step is None
                or agreed > self.last_global_commit_step):
            # the caller promotes the agreed step: the commit-lag gauge
            # reports drift from it after a resume
            self.last_global_commit_step = agreed
            self._update_commit_lag()
        return agreed

    def _update_commit_lag(self) -> None:
        if not telemetry.enabled():
            return
        local = self.last_staged_step
        if local is None:
            local = self.last_checkpoint_step
        if local is None:
            return
        _fleet_metrics()["commit_lag"].set(
            max(0, local - (self.last_global_commit_step or 0)))

    # -- pod-level aggregation ------------------------------------------------

    def publish_endpoint(self, host: str, port: int) -> None:
        """Announce this rank's debug-server address through the
        transport so any rank's /podz can fan out to it. The debug
        server binds loopback by default, which a REMOTE aggregator
        cannot reach — on a real multi-host fleet set
        ``PT_PODZ_ADVERTISE_HOST`` (this host's routable name) or bind
        the server on one; the single-host rig needs neither."""
        host = os.environ.get("PT_PODZ_ADVERTISE_HOST") or host
        self._own_endpoint = f"{host}:{port}"
        if self.transport is not None:
            self.transport.put(f"debug.{self.rank}",
                               self._own_endpoint)

    def _podz_row(self, r: int) -> Dict[str, Any]:
        if r == self.rank and self._own_endpoint:
            ep = self._own_endpoint
        elif self.transport is not None:
            ep = self.transport.get(f"debug.{r}")
        else:
            ep = None
        dead = self._marker(f"dead.{r}") is not None
        done = self._marker(f"done.{r}")
        row: Dict[str, Any] = {"rank": r, "endpoint": ep,
                               "dead": dead,
                               "done_at_step": (int(done)
                                                if done else None)}
        if ep and not dead:
            t = self.podz_fetch_timeout_s
            h = _fetch_json(f"http://{ep}/healthz", t)
            row["healthz"] = h
            if isinstance(h, dict):
                row["heartbeat_age_s"] = h.get("last_step_age_s")
            s = _fetch_json(f"http://{ep}/statusz", t)
            if isinstance(s, dict) and "error" not in s:
                row["backend"] = s.get("backend")
                res = s.get("resilience")
                view = (res.get("controller")
                        if isinstance(res, dict) else None)
                if isinstance(view, dict):
                    row["last_checkpoint_step"] = view.get(
                        "last_checkpoint_step")
                    row["last_committed_step"] = view.get(
                        "last_committed_step")
                    # fleet-wide commit next to the local one: a rank
                    # whose local step runs ahead of the global commit
                    # is the one wedging (or outpacing) the fleet —
                    # commit drift is visible at a glance
                    row["last_committed_global"] = view.get(
                        "last_global_commit_step")
                    row["last_staged_step"] = view.get(
                        "last_staged_step")
                    row["preempt"] = {
                        k: view.get(k)
                        for k in ("preempt_requested", "acked_step",
                                  "agreed_preempt_step")}
            else:
                row["statusz_error"] = (s.get("error")
                                        if isinstance(s, dict)
                                        else repr(s))
            m = _fetch_json(f"http://{ep}/memz", t)
            if isinstance(m, dict):
                row["peak_mem_bytes"] = m.get("peak_mem_bytes")
        return row

    def podz(self) -> Dict[str, Any]:
        """One fleet view: fan out to every rank's /healthz + /statusz
        + /memz and distill per-rank heartbeat age, last committed
        step, and preempt state. Unreachable ranks degrade to an error
        row — /podz renders whatever the fleet can still tell it.
        Ranks fetch CONCURRENTLY: a scrape of a partially-wedged fleet
        is bounded near one rank's fetch budget, not world x timeouts."""
        from concurrent.futures import ThreadPoolExecutor

        if self.world <= 1:
            rows = [self._podz_row(0)]
        else:
            with ThreadPoolExecutor(
                    max_workers=min(8, self.world),
                    thread_name_prefix="pt-podz-fetch") as ex:
                rows = list(ex.map(self._podz_row,
                                   range(self.world)))
        return {"world_size": self.world,
                "aggregator_rank": self.rank,
                "run_id": self.run_id,
                "preempt_requested": self._requested(),
                "agreed_preempt_step": self.agreed_step,
                "last_committed_global": self.last_global_commit_step,
                "ranks": {str(row["rank"]): row for row in rows}}

    def tracez_fanout(self,
                      trace_id: Optional[str] = None) -> Dict[str, Any]:
        """/podz-style TRACE aggregation for training fleets (mounted
        on the debug server's ``/tracez?trace_id=`` when a controller
        is attached): fan out to every rank's /tracez, align each
        rank's spans via its clock-offset handshake, and merge ONE
        chrome-trace — per-rank lanes carrying the rank-tagged
        ``train.step`` spans and the preempt-agreement events.
        Unreachable/dead ranks degrade to error rows."""
        from concurrent.futures import ThreadPoolExecutor

        collections: List[Dict[str, Any]] = []
        rows: Dict[str, Any] = {}
        # ``local=1`` forces each rank's LOCAL ring: every rank mounts
        # this same fan-out on its own /tracez, so without it two
        # ranks' aggregators would recurse into each other
        q = (f"?trace_id={trace_id}&local=1" if trace_id
             else "?local=1")

        def fetch(r: int):
            if r == self.rank:
                return r, _tracing.collection(trace_id,
                                              proc=f"rank{r}"), "local"
            if self._marker(f"dead.{r}") is not None:
                return r, None, "dead"
            ep = (self.transport.get(f"debug.{r}")
                  if self.transport is not None else None)
            if not ep:
                return r, None, "no endpoint published"
            j = _fetch_json(f"http://{ep}/tracez{q}",
                            self.podz_fetch_timeout_s)
            if isinstance(j, dict) and "trace_spans" in j:
                j["proc"] = f"rank{r}"
                return r, j, ep
            return r, None, (j.get("error") if isinstance(j, dict)
                             else repr(j))

        with ThreadPoolExecutor(
                max_workers=min(8, max(1, self.world)),
                thread_name_prefix="pt-tracez-fetch") as ex:
            for r, j, info in ex.map(fetch, range(self.world)):
                if j is not None:
                    collections.append(j)
                    rows[str(r)] = {
                        "rank": r, "source": info,
                        "spans": len(j.get("trace_spans",
                                           j.get("spans", [])))}
                else:
                    rows[str(r)] = {"rank": r, "error": info}
        return {"world_size": self.world,
                "aggregator_rank": self.rank,
                "trace_id": trace_id,
                "ranks": rows,
                "trace": _tracing.merge_chrome_trace(collections)}

    # -- introspection ------------------------------------------------------

    def statusz(self) -> Dict[str, Any]:
        """This rank's view as a dict: agreement state, notice source,
        the commit ledger and the last checkpoint barrier's latency."""
        from .. import checkpoint as _ckpt

        bs = _ckpt.barrier_stats()
        return {
            "active": self._started,
            "rank": self.rank,
            "world_size": self.world,
            "run_id": self.run_id,
            "transport": (getattr(self.transport, "kind", None)
                          if self.transport is not None else None),
            "notice_source": (self.notice_source.describe()
                              if self.notice_source is not None
                              else None),
            "watcher_alive": (self._watcher is not None
                              and self._watcher.is_alive()),
            "watch_error": self._watch_error,
            "preempt_requested": self._requested(),
            "request_reason": self.request_reason,
            "acked_step": self.acked_step,
            "agreed_preempt_step": self.agreed_step,
            "last_checkpoint_step": self.last_checkpoint_step,
            "last_committed_step": self.last_committed_step,
            "last_staged_step": self.last_staged_step,
            "last_global_commit_step": self.last_global_commit_step,
            "last_commit_barrier_s": self.last_commit_barrier_s,
            "agreed_restore_step": self.agreed_restore_step,
            "last_agreement_wait_s": self.last_wait_s,
            "last_barrier_latency_s": bs["last_latency_s"],
            "barrier_timeouts": bs["timeouts"],
        }


def active() -> Optional[FleetController]:
    """The process's started controller, or None."""
    return _ACTIVE
