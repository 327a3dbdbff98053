"""Resumable training loop with failure detection (counterpart of
paddle_tpu/train_loop.py): periodic checkpoints with retention,
auto-resume from the newest committed step that verifies, a nan/inf
guard (the reference's FLAGS_check_nan_inf, raise or skip with
rollback), a step watchdog, bounded in-process recovery from a failed
step, preemption grace, and a graceful ``close()`` that writes the
final snapshot and joins the writers.

Recovery note: only errors in ``recoverable`` (RuntimeError and OSError
by default, never an EnforceError, NotImplementedError or
RecursionError) roll back to the last snapshot and continue. A CUDA
fault such as an illegal address poisons the process's CUDA context, so
no in-process recovery helps it: the run dies and a restarted process
resumes from the last committed step. The tests drive recovery with an
injected ``FaultError`` (an OSError) only.

Fleet-coordinated preemption (``controller=``, a
:class:`resilience.FleetController`): a notice on any rank starts a
preempt-at-step agreement, every rank trains up to the agreed step,
commits one checkpoint there and confirms it before reporting
``preempted``; every periodic save becomes a fleet transaction and the
resume restores the newest step the whole fleet holds. A peer that
dies mid-run preempts the fleet with nothing written; the launcher's
respawn resumes from the last globally committed step.

Live diagnostics (``telemetry``, off by default), as in the JAX package:
``debug_port=`` serves the debug endpoints for the run,
``flight_recorder=`` records every step (its one added host read is the
loss), and while telemetry is on each step feeds the training
instruments, the signature tracker, the run's trace, the regression
sentinel (its baselines next to the checkpoints), the cost ledger (the
step's first real call counted: ``train.step``) and the goodput ledger.
No other host read is added: the goodput split is the JAX package's,
by host stamps around the ``train_step`` call up to the nan guard's
loss read, and the loss scale comes from a copy into pinned memory,
read once an event says it has landed."""

from __future__ import annotations

import collections
import contextlib
import math
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import torch

from . import telemetry
from .checkpoint import CheckpointManager
from .core.config import FLAGS
from .core.enforce import EnforceError, enforce
from .resilience import faults as _faults
from .resilience.preemption import PreemptionHandler, _preempt_metrics
from .telemetry import costs as _costs
from .telemetry import profiling as _profiling
from .telemetry import recompile as _recompile
from .telemetry import server as _dbg_server
from .telemetry import tracing as _tracing
from .telemetry.diag import FlightRecorder

_NULL_CM = contextlib.nullcontext()


@telemetry.cached_instruments
def _train_metrics(reg):
    """Training instrument set, memoized against the registry generation
    (touched every step). Only reached while telemetry is enabled."""
    return {
        "steps": reg.counter("pt_train_steps_total",
                             "optimizer steps completed"),
        "step_time": reg.histogram(
            "pt_train_step_seconds",
            "wall time per training step (dispatch + loss fence)",
            unit="s"),
        "examples_per_sec": reg.gauge(
            "pt_train_examples_per_sec",
            "throughput over the last step (batch size / step time)"),
        "nan_skips": reg.counter(
            "pt_train_nan_skips_total",
            "steps dropped by the nan/inf guard"),
        "loss_scale": reg.gauge(
            "pt_train_loss_scale", "current dynamic loss scale"),
        "loss_scale_events": reg.counter(
            "pt_train_loss_scale_events_total",
            "dynamic loss-scale growth/backoff events"),
    }


def _batch_size(batch) -> int:
    """Leading dim of the first array leaf (0 when undeterminable)."""
    if isinstance(batch, dict):
        vals = [batch[k] for k in sorted(batch)]
    elif isinstance(batch, (list, tuple)):
        vals = list(batch)
    else:
        vals = [batch]
    for v in vals:
        shape = getattr(v, "shape", None)
        if shape:
            return int(shape[0])
    return 0


class _ScaleReads:
    """The loss-scale gauges without a host read of their own. On the
    card each clean step's scale is copied into pinned memory behind an
    event and read once the event has completed (``query()``, no wait):
    at the latest the next step, since the nan guard's loss read waits
    for the copy, or at the end of the run. On the CPU the value is
    read at once."""

    def __init__(self):
        self.pending: collections.deque = collections.deque()
        self._pinned = []        # free pinned scalars

    def push(self, scale) -> None:
        if not torch.is_tensor(scale) or not scale.is_cuda:
            self.pending.append((float(scale), None))
            return
        buf = (self._pinned.pop() if self._pinned else
               torch.empty((), dtype=torch.float32, pin_memory=True))
        buf.copy_(scale, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self.pending.append((buf, ev))

    def ready(self, final: bool = False) -> List[float]:
        """The scales whose copies have landed, in step order (all of
        them when ``final``)."""
        out = []
        while self.pending:
            buf, ev = self.pending[0]
            if ev is not None and not ev.query():
                if not final:
                    break
                ev.synchronize()
            self.pending.popleft()
            if ev is None:
                out.append(buf)
            else:
                out.append(float(buf.item()))  # pinned host memory
                self._pinned.append(buf)
        return out


class NanInfError(EnforceError):
    """Raised when the nan/inf guard trips with policy='raise'."""


class Watchdog:
    """Step-progress watchdog: calls ``on_stall(age)`` (default: print)
    once per stall when no heartbeat came within ``timeout_s``."""

    def __init__(self, timeout_s: float = 600.0,
                 on_stall: Optional[Callable[[float], None]] = None,
                 poll_s: Optional[float] = None):
        self.timeout_s = timeout_s
        self.on_stall = on_stall or (lambda age: print(
            f"[watchdog] no training progress for {age:.0f}s"))
        self._poll_s = (poll_s if poll_s is not None
                        else min(timeout_s / 4, 30.0))
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        # beat() and the watchdog thread both write these
        self._mu = threading.Lock()
        self._fired = False
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._last_beat = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="pt-watchdog")
        self._thread.start()
        return self

    def beat(self):
        with self._mu:
            self._last_beat = time.monotonic()
            self._fired = False

    def _run(self):
        while not self._stop.wait(self._poll_s):
            with self._mu:
                age = time.monotonic() - self._last_beat
                fire = age > self.timeout_s and not self._fired
                if fire:
                    self._fired = True
            if fire:
                self.on_stall(age)      # outside the lock

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    @property
    def stalled(self) -> bool:
        return self._fired


def _finite(loss) -> bool:
    """Whether a scalar loss (a tensor, read back, or a number) is
    finite."""
    return math.isfinite(float(loss))


class TrainLoop:
    """Drive a ``Trainer`` over a stream of batches with auto-resume.

    - resume: restores the newest committed checkpoint before the first
      step;
    - ``checkpoint_every``: periodic snapshots (parameters, buffers,
      optimizer state, key), written on a thread and retention-GC'd;
    - nan guard: ``nan_policy`` 'raise' raises :class:`NanInfError`,
      'skip' drops the step by restoring the last snapshot, 'off' skips
      the check unless ``FLAGS.check_nan_inf`` is set;
    - ``watchdog_timeout_s``: stall detection while ``run`` runs;
    - ``max_recoveries``: failed steps (``recoverable`` errors) rolled
      back to the last snapshot, per ``run`` call."""

    def __init__(self, trainer, checkpoint_dir: str,
                 checkpoint_every: int = 1000, max_to_keep: int = 5,
                 nan_policy: str = "raise",
                 watchdog_timeout_s: Optional[float] = None,
                 on_stall: Optional[Callable] = None,
                 max_recoveries: int = 0,
                 recoverable: tuple = (RuntimeError, OSError)):
        enforce(nan_policy in ("raise", "skip", "off"),
                "nan_policy must be raise|skip|off, got %s", nan_policy)
        enforce(max_recoveries >= 0, "max_recoveries must be >= 0")
        self.trainer = trainer
        self.manager = CheckpointManager(checkpoint_dir,
                                         max_to_keep=max_to_keep)
        self.checkpoint_every = checkpoint_every
        self.nan_policy = nan_policy
        self.step = 0
        self._watchdog = (Watchdog(watchdog_timeout_s, on_stall)
                          if watchdog_timeout_s else None)
        self.max_recoveries = max_recoveries
        self.recoverable = tuple(recoverable)
        self._recoveries_this_run = 0
        self._faulted = False
        # the input pipeline run() built for prefetch=/bucket_by= (its
        # host_wait_s reads how long the steps waited for input)
        self.prefetcher = None
        self.debug_server = None  # set while run(debug_port=) is live
        self._backend_name: Optional[str] = None
        self._last_loss_scale: Optional[float] = None
        # the goodput split of each step of the last run (telemetry on)
        self.step_splits: list = []
        # "idle" -> "running" -> "completed" | "preempted" | "faulted"
        self.status = "idle"
        self.history: Dict[str, Any] = {"resumed_from": None,
                                        "skipped_steps": [],
                                        "recoveries": []}

    def _is_recoverable(self, e: BaseException) -> bool:
        if isinstance(e, (EnforceError, NotImplementedError,
                          RecursionError)):
            return False  # deterministic bugs and config errors
        return isinstance(e, self.recoverable)

    # -- lifecycle -----------------------------------------------------------

    def maybe_resume(self) -> Optional[int]:
        """Restore the newest committed step that verifies (a torn or
        bit-flipped newer one falls back) and continue from it; None when
        there is no checkpoint.

        With a coordinator every rank restores the same step, the newest
        one every live rank holds committed (``agree_restore_step``),
        which is then promoted to globally committed and every marker
        above it demoted (``align_global``); None on every rank when
        they share none. That step is restored exactly: an integrity
        error propagates rather than let one rank fall back alone."""
        coord = self.manager._coord()
        if coord is not None:
            agreed = coord.agree_restore_step(
                self.manager.committed_steps())
            self.manager.align_global(agreed)
            if agreed is None:
                return None
            self.trainer.restore_checkpoint(self.manager, agreed)
            self.step = agreed
            self.history["resumed_from"] = agreed
            return agreed
        if self.manager.latest_step() is None:
            return None
        self.trainer.restore_checkpoint(self.manager, None)
        latest = self.manager.last_restored_step
        self.step = latest
        self.history["resumed_from"] = latest
        return latest

    def _note_rollback(self, restored: Optional[int],
                       expected: Optional[int], why: str) -> None:
        """After a rollback whose verified restore fell back past the
        newest committed step, the step counter follows what was
        restored, and the rewind is recorded."""
        if restored is None or restored == expected:
            return
        self.history["recoveries"].append(
            {"step": self.step, "rolled_back_to": restored,
             "error": why + " fell back past a corrupt step"})
        self.step = restored

    def _guard(self, loss) -> bool:
        """True if the step is clean; applies the policy when not."""
        if self.nan_policy == "off" and not FLAGS.get("check_nan_inf"):
            return True
        if _finite(loss):
            return True
        if self.nan_policy == "raise":
            raise NanInfError(f"non-finite loss at step {self.step}: "
                              f"{float(loss)}")
        if telemetry.enabled():
            _train_metrics()["nan_skips"].inc()
        self.history["skipped_steps"].append(self.step)
        latest = self.manager.latest_step()
        if latest is not None:
            # the update already applied: roll back to the last snapshot
            self.trainer.restore_checkpoint(self.manager, None)
            self._note_rollback(self.manager.last_restored_step, latest,
                                "nan-skip rollback")
        return False

    def run(self, batches: Iterable, num_steps: Optional[int] = None,
            resume: bool = True,
            on_step: Optional[Callable[[int, Any, Dict], None]] = None,
            prefetch: Union[int, str, None] = None, bucket_by=None,
            pad_value=0, debug_port: Optional[int] = None,
            flight_recorder: Optional[FlightRecorder] = None,
            preemption: Union[bool, PreemptionHandler, None] = None,
            controller=None):
        """Train until ``num_steps`` (global, resumed steps included) or
        the end of the data; returns the final step count, which may end
        below ``num_steps`` after a recovery (the data stream is not
        rewound: the batches between the snapshot and the fault are
        skipped).

        - ``prefetch=N`` stages batches on the trainer's device N ahead
          on a thread (data/device_loader.py); ``"auto"`` grows the depth
          while the host waits. ``bucket_by`` pads the batch axis to a
          bucket set (``"pow2"`` or a list), ``pad_value`` the padding.
        - ``preemption=True`` installs a SIGTERM/SIGINT grace handler for
          the run (or pass a :class:`PreemptionHandler`): on a signal the
          step in flight finishes, the loop stops with ``status ==
          "preempted"``, and ``close()`` writes the final checkpoint.
        - an armed :class:`FaultInjector` is consulted at ``step.nan``
          after each step: a ``corrupt`` rule poisons the loss, a raising
          rule fails the step as a device fault would.
        - ``controller=FleetController(...)`` coordinates preemption
          over the fleet (the module docstring): it is attached to the
          manager before the resume, and its handler is the preemption
          handler (shared with an explicit ``preemption=``). On an
          agreement the loop trains up to the agreed step, saves it
          coordinated, confirms, and stops with ``status ==
          "preempted"`` and ``history["preempt_agreed_step"]``; a clean
          end announces ``done``. An expired agreement or commit raises
          :class:`BarrierTimeoutError` naming the missing ranks. When
          the trainer's mesh spans the process group the agreement runs
          in lockstep (``FleetController.check``). A step that fails
          while the launcher marks a peer dead (waited for up to
          ``dead_grace_s``) stops the run as ``"preempted"`` with
          ``history["lost_ranks"]`` and writes nothing: no save completes
          without the dead rank, and the last globally committed step
          is where the respawned job resumes.
        - ``debug_port=P`` serves /metrics /healthz /statusz /tracez
          /memz (and POST /profilez) on 127.0.0.1:P for the run (0 =
          ephemeral; ``self.debug_server`` holds it); starting it
          enables telemetry, and its thread is joined before run()
          returns. With a controller, /podz and the fleet /tracez fan-in
          are mounted and this rank's endpoint is published.
        - ``flight_recorder=FlightRecorder(...)`` records each step's
          loss (one host read), loss scale, step time and queue depth
          and applies its policy on an anomaly: ``record`` goes on,
          ``skip_step`` drops a non-finite step by rolling back to the
          last checkpoint (with none to roll back to it halts; a finite
          anomaly never rolls back), ``halt`` raises
          :class:`telemetry.diag.AnomalyHalt`. Consulted only while
          telemetry is enabled."""
        if prefetch is not None or bucket_by is not None:
            from .data.device_loader import DevicePrefetcher

            batches = self.prefetcher = DevicePrefetcher(
                batches, size=(prefetch if isinstance(prefetch, str)
                               else int(prefetch or 0)),
                bucket_by=bucket_by, pad_value=pad_value,
                device=self.trainer.device)
        if flight_recorder is not None:
            # provenance for the dump bundle (never overriding what the
            # caller recorded there)
            for k, v in (("checkpoint_dir", self.manager.directory),
                         ("nan_policy", self.nan_policy),
                         ("num_steps", num_steps),
                         ("checkpoint_every", self.checkpoint_every)):
                flight_recorder.run_config.setdefault(k, v)
        ctl = controller
        if ctl is not None and self.manager.coordinator is not ctl:
            # before the resume: it runs the restore agreement, and the
            # periodic saves become fleet transactions (a new attempt's
            # controller replaces the old one's key namespace)
            self.manager.coordinator = ctl
        if resume:
            self.maybe_resume()
        self._recoveries_this_run = 0
        self._faulted = False
        self.debug_server = None
        self.step_splits = []
        self.status = "running"
        pre: Optional[PreemptionHandler] = None
        own_pre = False
        if preemption is not None and preemption is not False:
            pre = PreemptionHandler() if preemption is True else preemption
            if not pre.installed:
                pre.install()
                own_pre = True
        if ctl is not None:
            if pre is not None:
                ctl.handler = pre   # one flag: the signal starts the agreement
            else:
                pre = ctl.handler
                if not pre.installed:
                    try:
                        pre.install()
                        own_pre = True
                    except ValueError:
                        # not the main thread: notices and peer acks
                        # still preempt
                        pass
        own_ctl = False
        if ctl is not None and not ctl.started:
            ctl.start()
            own_ctl = True
        inj = _faults.active()
        if self._watchdog:
            self._watchdog.start()

        # the ranks' steps are collective: the agreement runs in lockstep
        # (FleetController.check)
        mesh = getattr(self.trainer, "mesh", None)
        lockstep = ctl is not None and ctl.world > 1 and \
            mesh is not None and mesh.size > 1

        def lost_ranks(wait_s: float):
            """The peers the launcher marked dead, waiting up to
            ``wait_s`` for a marker to land."""
            deadline = time.monotonic() + wait_s
            while True:
                dead = [r for r in range(ctl.world) if r != ctl.rank
                        and ctl._marker(f"dead.{r}") is not None]
                if dead or time.monotonic() >= deadline:
                    return dead
                time.sleep(ctl.hold_poll_s)

        def stop_lost(dead):
            """A peer died: the fleet is preempted. Nothing is written:
            no save can complete without the dead rank (its barriers and
            its regions), so the last globally committed step is the
            fleet's restore point; a save in flight tears."""
            self.status = "preempted"
            self.history["preempted_at"] = self.step
            self.history["lost_ranks"] = dead
            self._faulted = True        # close() writes no snapshot
            try:
                self.manager.wait_until_finished()
            except (EnforceError, RuntimeError, OSError) as e:
                self.history["torn_saves"] = [repr(e)]

        def commit_preempt():
            """The coordinated epilogue: one checkpoint at the agreed
            step, confirmed on the transport."""
            dead = lost_ranks(0.0)
            if dead:
                stop_lost(dead)
                return
            self.status = "preempted"
            self.history["preempted_at"] = self.step
            self.history["preempt_agreed_step"] = ctl.agreed_step
            self.manager.wait_until_finished()
            # a rank whose data ran dry below the agreed step stages its
            # step alone and announces done first, so the peers' commit
            # at the agreed step does not hold for it
            below = ctl.agreed_step is not None and \
                self.step < ctl.agreed_step
            if below:
                ctl.note_done(self.step)
            coord = self.manager._coord()
            if self.step > 0 and \
                    self.step not in self.manager.committed_steps():
                self.manager.save(self.step, self.trainer.state(),
                                  coordinate=not below)
                self.manager.wait_until_finished()
            elif self.step > 0 and coord is not None and not below:
                # the periodic save of this step may have deferred its
                # global commit to the agreement: every rank runs it now
                # (idempotent)
                self.manager._global_commit(self.step, coord)
            ctl.note_checkpoint(self.step)
            committed = ctl.confirm_committed(self.step)
            if committed and len(set(committed.values())) > 1:
                print(f"[fleet] ranks committed differing steps: "
                      f"{committed}", file=sys.stderr)

        scales = _ScaleReads()
        try:
            if debug_port is not None:
                # inside the guarded block: the finally stops whatever
                # got started
                self._start_debug_server(debug_port, num_steps, batches,
                                         ctl)
            # the run's trace: step spans land on one trace id per run,
            # tagged with this rank, so the fleet /tracez fan-in merges
            # rank lanes of one job
            run_trace = (_tracing.new_trace() if telemetry.enabled()
                         else None)
            if telemetry.enabled():
                # perf baselines live next to the checkpoints they
                # describe (a fresh run dir re-arms the sentinel)
                _profiling.sentinel().attach(os.path.join(
                    self.manager.directory, "perf_baselines.json"))
            rank = ctl.rank if ctl is not None else 0
            plan = getattr(self.trainer, "plan", None)
            n_parts = plan.num_devices if plan is not None else 1
            batches_it = iter(batches)
            while True:
                # the host input wait (goodput bucket 1): the
                # prefetcher's wait for its queue, else the fetch
                t_fetch = (time.perf_counter() if telemetry.enabled()
                           else None)
                if t_fetch is not None:
                    for scale in scales.ready():
                        self._note_scale(scale)
                    hw0 = getattr(batches, "host_wait_s", None)
                try:
                    batch = next(batches_it)
                except StopIteration:
                    break
                if t_fetch is not None:
                    input_wait = (batches.host_wait_s - hw0
                                  if hw0 is not None else
                                  time.perf_counter() - t_fetch)
                if ctl is not None:
                    # a flag peek and a throttled transport read until a
                    # preemption is in flight; then this rank acks and
                    # holds, and ranks below the agreed step train on
                    agreed = ctl.check(self.step, lockstep=lockstep)
                    if agreed is not None and self.step >= agreed:
                        commit_preempt()
                        break
                elif pre is not None and pre.requested():
                    # the step in flight has finished: stop clean and let
                    # close() write the final checkpoint
                    self.status = "preempted"
                    self.history["preempted_at"] = self.step
                    break
                if num_steps is not None and self.step >= num_steps:
                    break
                telem = telemetry.enabled() and t_fetch is not None
                step_cm = cost_cm = _NULL_CM
                if telem:
                    # one signature record per step: a batch whose shapes
                    # or dtypes drift shows here
                    _recompile.record("train_loop.step", batch)
                    if run_trace is None:
                        run_trace = _tracing.new_trace()
                    step_cm = _tracing.span("train.step", ctx=run_trace,
                                            rank=rank, step=self.step + 1)
                    # the step's cost, counted over its first real call
                    counted = not _costs.known("train.step")
                    cost_cm = _costs.counting(
                        "train.step", n_partitions=n_parts,
                        origin="train_loop", device=self.trainer.device)
                    t0 = time.perf_counter()
                try:
                    with step_cm, cost_cm:
                        loss, metrics = self.trainer.train_step(batch)
                    # dispatch stamp: the host time of the step's call
                    t_disp = time.perf_counter() if telem else None
                    if inj is not None and inj.fire("step.nan"):
                        loss = torch.tensor(float("nan"))
                except Exception as e:
                    if ctl is not None and ctl.world > 1 and \
                            isinstance(e, RuntimeError) and \
                            not isinstance(e, EnforceError):
                        # a collective with a dead peer fails: wait for
                        # the launcher's marker before calling it a fault
                        dead = lost_ranks(ctl.dead_grace_s)
                        if dead:
                            stop_lost(dead)
                            break
                    if not self._is_recoverable(e) or \
                            self._recoveries_this_run >= \
                            self.max_recoveries:
                        self._faulted = True
                        raise
                    # a snapshot still being written may be newer than
                    # the last committed one: don't rewind further
                    self.manager.wait_until_finished()
                    if self.manager.latest_step() is None:
                        self._faulted = True
                        raise
                    self._recoveries_this_run += 1
                    self.trainer.restore_checkpoint(self.manager, None)
                    latest = self.manager.last_restored_step
                    self.history["recoveries"].append(
                        {"step": self.step, "rolled_back_to": latest,
                         "error": repr(e)})
                    self.step = latest
                    continue
                if telem and flight_recorder is not None:
                    # the recorder sees the step BEFORE the nan guard; its
                    # policy subsumes the guard for runs that configure it
                    if self._record_step(flight_recorder, loss, metrics,
                                         t0, batches):
                        continue
                if not self._guard(loss):
                    continue
                self.step += 1
                if telem:
                    # the goodput split by host stamps, as the JAX package
                    # splits it: dispatch is the host time of the
                    # train_step call, device compute the rest of the step
                    # up to the guard's loss read, which is its fence (under
                    # nan_policy='off' there is none: the device's work
                    # then shows as a later step's dispatch)
                    t_end = time.perf_counter()
                    self._note_step(t_end - t0, batch, batches, counted)
                    self._note_split(t_end - t_fetch, input_wait,
                                     t_disp - t0)
                    opt = getattr(self.trainer, "optimizer", None)
                    if opt is not None and hasattr(opt, "current_scale"):
                        scales.push(opt.current_scale(self.trainer.opt_state))
                if self._watchdog:
                    self._watchdog.beat()
                if telem:
                    # /healthz last-step age: our server when we own one
                    # (a co-resident loop's stall stays visible on its
                    # own endpoint), else a broadcast
                    if self.debug_server is not None:
                        self.debug_server.note("step")
                    else:
                        _dbg_server.note("step")
                if on_step is not None:
                    on_step(self.step, loss, metrics)
                if self.checkpoint_every and \
                        self.step % self.checkpoint_every == 0:
                    t_ck = time.perf_counter() if telem else None
                    self.manager.save(self.step, self.trainer.state())
                    if t_ck is not None:
                        # goodput bucket 4: save()'s host time (the
                        # pinned snapshot; the writes run on a thread)
                        _profiling.goodput().note_checkpoint_stall(
                            time.perf_counter() - t_ck)
                    if ctl is not None:
                        ctl.note_checkpoint(self.step)
            if ctl is not None and self.status == "running" and \
                    ctl.agreed_step is not None:
                # the data ran dry (or num_steps landed) below the agreed
                # step: commit and confirm what there is, peers hold for it
                commit_preempt()
        except BaseException:
            self.status = "faulted"
            raise
        finally:
            if telemetry.enabled():
                for scale in scales.ready(final=True):
                    self._note_scale(scale)
                # persist the sentinel's baselines next to the checkpoints
                _profiling.sentinel().save()
            if self.debug_server is not None:
                # joined before run() returns (the object stays on self
                # for inspection)
                self.debug_server.stop()
            if own_pre:
                pre.uninstall()
            if self.status == "running":
                self.status = "completed"
            if ctl is not None and self.status == "completed":
                # announced before leaving: a later agreement must not
                # hold for a rank that finished (a faulted exit is the
                # launcher's to mark dead)
                ctl.note_done(self.step)
            if own_ctl:
                ctl.stop()
            self.close()
        if self.status == "preempted" and telemetry.enabled():
            # counted after close(): the final checkpoint is on disk
            _preempt_metrics()["clean_exits"].inc()
        return self.step

    # -- telemetry -----------------------------------------------------------

    def _start_debug_server(self, port: int, num_steps, batches,
                            ctl) -> None:
        self.debug_server = _dbg_server.DebugServer(
            port=port, owned=True,
            run_config={"role": "train_loop",
                        "checkpoint_dir": self.manager.directory,
                        "nan_policy": self.nan_policy,
                        "num_steps": num_steps}).start()
        srv = self.debug_server
        # on-demand bounded device capture, as the serving replicas mount
        srv.add_post("/profilez", _profiling.make_profilez())
        if hasattr(batches, "current_depth"):
            pf = batches
            srv.add_status(
                "input_pipeline",
                lambda: {"prefetch_depth": pf.current_depth,
                         "auto": pf.auto,
                         "queue_depth": pf.last_queue_depth,
                         "last_real_rows": pf.last_real_rows})
        plan = getattr(self.trainer, "plan", None)
        if plan is not None:
            tr = self.trainer
            srv.add_status("sharding_plan",
                           lambda: plan.describe(getattr(tr, "params", None)))
        if ctl is not None:
            # pod-level aggregation: announce this rank's endpoint and
            # mount the controller's fan-outs on /podz and /tracez
            ctl.publish_endpoint(srv.host, srv.port)
            srv.set_fleet(ctl.podz)
            srv.set_trace_fanin(ctl.tracez_fanout)

    def _backend(self) -> str:
        """The sentinel's backend key (the card's kind, or ``cpu``),
        resolved once."""
        if self._backend_name is None:
            self._backend_name = _costs.backend_key(self.trainer.device)
        return self._backend_name

    def _record_step(self, rec: FlightRecorder, loss, metrics, t0,
                     batches) -> bool:
        """Feed the flight recorder (its one host read: the loss, with a
        device grad norm in the same read) and apply its policy. True
        when the step is dropped (``skip_step`` on a non-finite step)."""
        gn = metrics.get("grad_norm") if isinstance(metrics, dict) else None
        if torch.is_tensor(loss) and torch.is_tensor(gn):
            host_loss, gn = torch.stack([loss.detach().float().reshape(()),
                                         gn.detach().float().reshape(())]
                                        ).tolist()
        else:
            host_loss = float(loss)
        action = rec.record_step(
            self.step + 1, loss=host_loss, grad_norm=gn,
            loss_scale=self._last_loss_scale,
            step_time=time.perf_counter() - t0,
            queue_depth=getattr(batches, "last_queue_depth", None))
        if action == "halt":
            # the post-anomaly state is suspect (the update applied):
            # close() must not snapshot it over the last good checkpoint
            self._faulted = True
            raise rec.halt_error(f"step {self.step + 1}")
        if action != "skip_step" or \
                not rec.anomalies[-1]["kind"].startswith("nan"):
            # record, or a finite anomaly (spike, stall): the update is
            # sound and a rollback would destroy real progress
            return False
        self.manager.wait_until_finished()
        latest = self.manager.latest_step()
        if latest is None:
            # nothing to roll back to: training on would train on poison
            self._faulted = True
            raise rec.halt_error(f"step {self.step + 1} (skip_step with no "
                                 f"checkpoint to roll back to)")
        self.history["skipped_steps"].append(self.step)
        _train_metrics()["nan_skips"].inc()
        self.trainer.restore_checkpoint(self.manager, None)
        self._note_rollback(self.manager.last_restored_step, latest,
                            "recorder skip_step")
        return True

    def _note_step(self, dt: float, batch, batches, counted: bool) -> None:
        """A completed step's immediate telemetry (host numbers only):
        the sentinel (not for a step the cost ledger counted, which the
        count itself slows), the ledger's MFU, the step counters."""
        if not counted:
            _profiling.sentinel().observe("train.step", self._backend(), dt)
        _costs.observe_step("train.step", dt)
        tmet = _train_metrics()
        tmet["steps"].inc()
        tmet["step_time"].observe(dt)
        # the pre-pad rows when the prefetcher padded the batch
        bs = getattr(batches, "last_real_rows", None) or _batch_size(batch)
        if bs and dt > 0:
            tmet["examples_per_sec"].set(bs / dt)

    def _note_split(self, wall: float, wait: float, disp: float) -> None:
        """A step's goodput buckets: the input wait, the dispatch, and
        device compute as the rest of the step's wall."""
        dev = max(0.0, wall - wait - disp)
        _profiling.goodput().note_step(input_wait=wait, dispatch=disp,
                                       device_compute=dev)
        self.step_splits.append({"step": self.step, "wall_s": wall,
                                 "input_wait_s": wait, "dispatch_s": disp,
                                 "device_compute_s": dev})

    def _note_scale(self, scale: float) -> None:
        tmet = _train_metrics()
        tmet["loss_scale"].set(scale)
        if self._last_loss_scale is not None and \
                scale != self._last_loss_scale:
            tmet["loss_scale_events"].inc()
        self._last_loss_scale = scale

    def close(self):
        """Graceful shutdown: join the writers, then write the final
        snapshot unless the run faulted or the step is committed."""
        if self._watchdog:
            self._watchdog.stop()
        # join first so committed_steps() sees them; an earlier write's
        # failure must not stop the final snapshot, so it is deferred
        deferred: Optional[BaseException] = None
        try:
            self.manager.wait_until_finished()
        except BaseException as e:
            deferred = e
        # never snapshot the state after an unrecovered fault: the next
        # run resumes from the last good checkpoint instead
        if self.step > 0 and not self._faulted and \
                self.step not in self.manager.committed_steps():
            self.manager.save(self.step, self.trainer.state(),
                              coordinate=False)
        self.manager.wait_until_finished()
        if deferred is not None:
            if sys.exc_info()[0] is None:
                raise deferred
            print(f"[train_loop] deferred checkpoint-write failure: "
                  f"{deferred!r}", file=sys.stderr)
