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
respawn resumes from the last globally committed step. The JAX
package's live diagnostics (``debug_port=``, ``flight_recorder=``) come
with telemetry (ROADMAP queue 1 item 8) and raise
:class:`UnimplementedError` naming it. Its XLA-only step-cost
registration has no counterpart."""

from __future__ import annotations

import math
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional, Union

import torch

from .checkpoint import CheckpointManager
from .core.config import FLAGS
from .core.enforce import EnforceError, UnimplementedError, enforce
from .resilience import faults as _faults
from .resilience.preemption import PreemptionHandler


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
            flight_recorder=None,
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
        - ``debug_port``, ``flight_recorder`` raise
          :class:`UnimplementedError` (queue 1 item 8)."""
        for name, value in (("debug_port", debug_port),
                            ("flight_recorder", flight_recorder)):
            if value is not None:
                raise UnimplementedError(
                    f"TrainLoop.run {name}= is not ported yet: ROADMAP "
                    f"queue 1 item 8 (telemetry)")
        if prefetch is not None or bucket_by is not None:
            from .data.device_loader import DevicePrefetcher

            batches = self.prefetcher = DevicePrefetcher(
                batches, size=(prefetch if isinstance(prefetch, str)
                               else int(prefetch or 0)),
                bucket_by=bucket_by, pad_value=pad_value,
                device=self.trainer.device)
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

        try:
            batches_it = iter(batches)
            while True:
                try:
                    batch = next(batches_it)
                except StopIteration:
                    break
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
                try:
                    loss, metrics = self.trainer.train_step(batch)
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
                if not self._guard(loss):
                    continue
                self.step += 1
                if self._watchdog:
                    self._watchdog.beat()
                if on_step is not None:
                    on_step(self.step, loss, metrics)
                if self.checkpoint_every and \
                        self.step % self.checkpoint_every == 0:
                    self.manager.save(self.step, self.trainer.state())
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
        return self.step

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
