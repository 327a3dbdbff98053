"""One-command multi-process bring-up: ``python -m paddle_tpu_torch.launch``
(counterpart of paddle_tpu/launch.py; reference:
python/paddle/distributed/launch.py).

Usage::

    python -m paddle_tpu_torch.launch --nproc 2 train.py [script args...]

Behaviour:

- spawns ``nproc`` copies of the script, each with its rank's
  environment (:func:`build_worker_env`): the ``PADDLE_*`` protocol
  ``fleet.RoleMaker`` reads, torch's ``RANK``/``WORLD_SIZE``/
  ``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT`` (rank 0's endpoint is
  the TCP store's address), the fleet controller's ``PT_FLEET_DIR``
  (under the log dir) and per-attempt ``PT_FLEET_RUN_ID``, and
  ``PT_COLLECTIVE_TIMEOUT_S``, half the grace window (a collective left
  waiting by a dead peer raises in time for the survivor to stop
  ``preempted``);
- rank 0 streams to this process's stdout and stderr, the others write
  ``<log_dir>/workerlog.<rank>``;
- a worker that exits non-zero fails the job fast: its log tail is
  replayed, it is marked ``dead.<rank>`` on the fleet's file root (the
  survivors' controllers drop it from agreement instead of holding in
  its barrier), the others get SIGTERM and ``grace`` seconds to commit,
  then a kill;
- ``--elastic``: the job respawns on the N-1 surviving slots with fresh
  ranks, a fresh ``PT_FLEET_RUN_ID`` (``L<pid>a<attempt>``) and a fresh
  store port, so no key or socket of the dead attempt reads as live;
  the worker's ``TrainLoop`` resume restores the last globally
  committed checkpoint onto the smaller world;
- a SIGTERM to the launcher is relayed to every worker (their grace
  window to commit), and stragglers are killed when it expires;
- the exit code is the last attempt's first non-zero worker code,
  else 0.

``--platform cpu`` hides the cards from the workers
(``CUDA_VISIBLE_DEVICES=""``); a worker still has to ask for the CPU,
or ``fleet.init`` raises. ``--local-devices`` has no meaning here (one
device a process) and raises; ``--serve`` and its flags come with the
serving fleet (ROADMAP queue 1 item 8) and raise."""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional, Tuple

__all__ = ["build_worker_env", "launch", "main"]

_ITEM8 = "is not ported yet: ROADMAP queue 1 item 8 (the serving fleet)"
# fleet.ENV_COLLECTIVE_TIMEOUT (the launcher imports nothing heavy)
_ENV_COLLECTIVE_TIMEOUT = "PT_COLLECTIVE_TIMEOUT_S"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def build_worker_env(rank: int, nproc: int, endpoints: List[str],
                     base_env=None, platform: Optional[str] = None,
                     local_devices: Optional[int] = None,
                     fleet_dir: Optional[str] = None,
                     run_id: Optional[str] = None) -> dict:
    """The environment of one worker: the ``PADDLE_*`` keys, torch's
    rendezvous keys (``MASTER_ADDR:MASTER_PORT`` = ``endpoints[0]``),
    and ``PT_FLEET_DIR``/``PT_FLEET_RUN_ID`` for the fleet controller.
    ``platform="cpu"`` hides the cards; ``local_devices`` raises (one
    device a process)."""
    from .core.enforce import InvalidArgumentError

    if local_devices:
        raise InvalidArgumentError(
            "local_devices forces virtual CPU devices per worker in the "
            "JAX package; a torch worker drives one device")
    env = dict(os.environ if base_env is None else base_env)
    env["PADDLE_TRAINER_ID"] = str(rank)
    env["PADDLE_TRAINERS_NUM"] = str(nproc)
    env["PADDLE_TRAINER_ENDPOINTS"] = ",".join(endpoints)
    host, _, port = endpoints[0].rpartition(":")
    env["RANK"] = str(rank)
    env["LOCAL_RANK"] = str(rank)
    env["WORLD_SIZE"] = str(nproc)
    env["MASTER_ADDR"] = host
    env["MASTER_PORT"] = port
    if fleet_dir:
        env["PT_FLEET_DIR"] = fleet_dir
    if run_id:
        env["PT_FLEET_RUN_ID"] = run_id
    if platform:
        from .core.enforce import enforce

        enforce(platform in ("cpu", "gpu", "cuda"),
                "platform must be cpu or gpu, got %s", platform)
        if platform == "cpu":
            env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def _mark_dead(fleet_dir: str, run_id: str, rank: int) -> None:
    """Publish ``dead.<rank>`` in the FileTransport layout
    (``<root>/<run_id>.<key>``), so the survivors' controllers drop the
    rank and exit within the grace window. Plain stdlib: the teardown
    path imports nothing heavy."""
    try:
        os.makedirs(fleet_dir, exist_ok=True)
        path = os.path.join(fleet_dir, f"{run_id}.dead.{rank}")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write("1")
        os.replace(tmp, path)
    except OSError:
        pass  # best effort: the grace kill still bounds the teardown


def _run_attempt(script: str, script_args: List[str], *, nproc: int,
                 endpoints: List[str], log_dir: str,
                 platform: Optional[str], grace: float,
                 deadline: Optional[float], fleet_dir: str,
                 run_id: str,
                 relayed: List[bool]) -> Tuple[int, Optional[int]]:
    """One spawn of the worker set. Returns (exit code, the rank whose
    unexpected death tore the attempt down; None for a clean, relayed
    or timed-out attempt)."""
    procs, logs, log_files = [], [], []
    for rank in range(nproc):
        env = build_worker_env(rank, nproc, endpoints, platform=platform,
                               fleet_dir=fleet_dir, run_id=run_id)
        # gloo (and NCCL) wait on a collective whose peer died until
        # their timeout: half the grace window lets the survivor notice
        # the dead rank and stop preempted before its grace kill
        env.setdefault(_ENV_COLLECTIVE_TIMEOUT, str(max(grace / 2, 5.0)))
        if rank == 0:
            out, path = None, None  # rank 0 streams live
        else:
            path = os.path.join(log_dir, f"workerlog.{rank}")
            out = open(path, "w")
            log_files.append(out)
        logs.append(path)
        procs.append(subprocess.Popen(
            [sys.executable, script, *script_args], env=env,
            stdout=out, stderr=subprocess.STDOUT if out else None))

    relayed_at: List[Optional[float]] = [None]
    # one grace clock for both teardowns (a relayed preemption and a
    # worker's failure): when it expires the stragglers are killed
    kill_at: List[Optional[float]] = [None]

    def _relay(signum, frame):
        if relayed_at[0] is not None:
            return  # the grace clock is running already
        relayed_at[0] = time.time()
        relayed[0] = True
        kill_at[0] = relayed_at[0] + grace
        print(f"[launch] SIGTERM: relaying to {nproc} workers "
              f"(grace {grace}s)", file=sys.stderr)
        for q in procs:
            if q.poll() is None:
                q.send_signal(signal.SIGTERM)

    prev_term = None
    try:
        prev_term = signal.signal(signal.SIGTERM, _relay)
    except ValueError:
        pass  # not the main thread: no relay

    rc = 0
    failed_rank: Optional[int] = None
    try:
        pending = set(range(nproc))
        while pending:
            for rank in sorted(pending):
                code = procs[rank].poll()
                if code is None:
                    continue
                pending.discard(rank)
                if code != 0 and rc == 0:
                    rc = code
                    if relayed_at[0] is not None:
                        continue  # preempting: peers keep their grace
                    failed_rank = rank
                    print(f"[launch] rank {rank} exited with {code}; "
                          f"failing fast (peers get {grace}s to "
                          "commit)", file=sys.stderr)
                    if logs[rank]:
                        _replay_tail(logs[rank], rank)
                    # the dead marker first: when the SIGTERM lands the
                    # peers' controllers already count the rank gone
                    _mark_dead(fleet_dir, run_id, rank)
                    kill_at[0] = time.time() + grace
                    for q in procs:
                        if q.poll() is None:
                            q.terminate()
            if kill_at[0] is not None and pending and \
                    time.time() > kill_at[0]:
                print(f"[launch] grace window ({grace}s) expired; "
                      f"killing ranks {sorted(pending)}", file=sys.stderr)
                for q in procs:
                    if q.poll() is None:
                        q.kill()
                if relayed_at[0] is not None:
                    rc = rc or 143  # the job was preempted, not clean
                kill_at[0] = None
            if deadline and time.time() > deadline and pending:
                print(f"[launch] timeout; terminating ranks "
                      f"{sorted(pending)}", file=sys.stderr)
                for q in procs:
                    if q.poll() is None:
                        q.terminate()
                rc = rc or 124
                failed_rank = None  # a timeout is not an elastic event
                break
            time.sleep(0.05)
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    except KeyboardInterrupt:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        raise
    finally:
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
        for f in log_files:
            f.close()
    return rc, failed_rank


def launch(script: str, script_args: List[str], *, nproc: int,
           endpoints: Optional[List[str]] = None,
           log_dir: str = "launch_logs", platform: Optional[str] = None,
           timeout: Optional[float] = None,
           local_devices: Optional[int] = None,
           grace: float = 30.0, elastic: bool = False,
           max_restarts: Optional[int] = None,
           min_procs: int = 1) -> int:
    """Run the job; returns its exit code (0: every rank exited 0).

    Fail-fast, the preemption relay and ``elastic`` as the module
    docstring says. An elastic job restarts at most ``max_restarts``
    times (default ``nproc - 1``: down to one worker), never below
    ``min_procs``, never after a relayed preemption or the global
    ``timeout``. Each attempt takes fresh endpoints (a fresh store
    port) unless ``endpoints`` were given, whose dead slot is then
    dropped."""
    from .core.enforce import InvalidArgumentError

    if local_devices:
        raise InvalidArgumentError(
            "launch local_devices= forces virtual CPU devices per worker "
            "in the JAX package; a torch worker drives one device")
    os.makedirs(log_dir, exist_ok=True)
    fleet_dir = os.path.join(log_dir, "fleet")
    deadline = time.time() + timeout if timeout else None
    restarts_left = 0
    if elastic:
        restarts_left = (max_restarts if max_restarts is not None
                         else max(nproc - 1, 0))
    attempt = 0
    cur_endpoints = endpoints
    relayed = [False]
    while True:
        eps = cur_endpoints
        if eps is None:
            eps = [f"127.0.0.1:{_free_port()}" for _ in range(nproc)]
        if len(eps) != nproc:
            raise ValueError(f"{len(eps)} endpoints for {nproc} processes")
        run_id = f"L{os.getpid()}a{attempt}"
        rc, failed_rank = _run_attempt(
            script, script_args, nproc=nproc, endpoints=eps,
            log_dir=log_dir, platform=platform, grace=grace,
            deadline=deadline, fleet_dir=fleet_dir, run_id=run_id,
            relayed=relayed)
        if rc == 0 or relayed[0] or failed_rank is None or \
                restarts_left <= 0:
            return rc
        if nproc - 1 < max(min_procs, 1):
            print(f"[launch] elastic: cannot drop below "
                  f"min_procs={max(min_procs, 1)}; giving up",
                  file=sys.stderr)
            return rc
        if deadline and time.time() > deadline:
            return rc
        restarts_left -= 1
        attempt += 1
        nproc -= 1
        if cur_endpoints is not None:
            cur_endpoints = [e for i, e in enumerate(cur_endpoints)
                             if i != failed_rank]
        print(f"[launch] elastic restart #{attempt}: rank {failed_rank} "
              f"died (rc {rc}); respawning on {nproc} surviving "
              f"worker(s) from the last committed checkpoint",
              file=sys.stderr)


def _replay_tail(path: str, rank: int, n: int = 40) -> None:
    try:
        with open(path) as f:
            lines = f.read().splitlines()
        print(f"[launch] last {min(n, len(lines))} lines of rank {rank} "
              f"({path}):", file=sys.stderr)
        for line in lines[-n:]:
            print(f"  [rank {rank}] {line}", file=sys.stderr)
    except OSError:
        pass


# the serving flags, each raising with --serve (ROADMAP queue 1 item 8)
_SERVE_FLAGS = ("spec", "from_artifact", "spec_kw", "autoscale",
                "deadline_s", "trace_sample")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.launch",
        description="multi-process distributed launcher (reference: "
                    "python -m paddle.distributed.launch)")
    ap.add_argument("--nproc", type=int, default=1,
                    help="number of worker processes (trainers)")
    ap.add_argument("--endpoints", default=None,
                    help="comma-separated host:port per rank (default: "
                    "free local ports; rank 0's hosts the store)")
    ap.add_argument("--log-dir", default="launch_logs",
                    help="directory for workerlog.<rank> files (rank 0 "
                    "streams to this terminal)")
    ap.add_argument("--platform", default=None,
                    help="cpu hides the cards from the workers "
                    "(CUDA_VISIBLE_DEVICES=''); each worker still asks "
                    "for the CPU itself")
    ap.add_argument("--local-devices", type=int, default=None,
                    help="the JAX package's virtual CPU devices per "
                    "worker; a torch worker drives one device (raises)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="kill the job after this many seconds")
    ap.add_argument("--grace", type=float, default=30.0,
                    help="seconds workers get to checkpoint and exit "
                    "after a relayed SIGTERM or a peer's death before "
                    "being killed")
    ap.add_argument("--elastic", action="store_true",
                    help="respawn the job on the N-1 surviving workers "
                    "(resuming from the last committed checkpoint) when "
                    "a worker dies, instead of dying with it")
    ap.add_argument("--max-restarts", type=int, default=None,
                    help="elastic restart budget (default: nproc-1)")
    ap.add_argument("--min-procs", type=int, default=1,
                    help="never restart with fewer workers than this")
    ap.add_argument("--serve", action="store_true",
                    help="serving bring-up (ROADMAP queue 1 item 8; "
                    "raises)")
    ap.add_argument("--spec", default=None, help="--serve (raises)")
    ap.add_argument("--from-artifact", dest="from_artifact", default=None,
                    help="--serve (raises)")
    ap.add_argument("--spec-kw", dest="spec_kw", default=None,
                    help="--serve (raises)")
    ap.add_argument("--prefill-workers", dest="prefill_workers", type=int,
                    default=0, help="--serve (raises)")
    ap.add_argument("--port", type=int, default=0, help="--serve (raises)")
    ap.add_argument("--trace-sample", dest="trace_sample", type=float,
                    default=None, help="--serve (raises)")
    ap.add_argument("--dispatch", default="pull", choices=("pull", "push"),
                    help="--serve (raises)")
    ap.add_argument("--prefix-hash-tokens", dest="prefix_hash_tokens",
                    type=int, default=64, help="--serve (raises)")
    ap.add_argument("--autoscale", default=None, metavar="MIN,MAX",
                    help="--serve (raises)")
    ap.add_argument("--reliability", action="store_true",
                    help="--serve (raises)")
    ap.add_argument("--deadline-s", dest="deadline_s", type=float,
                    default=None, help="--serve (raises)")
    ap.add_argument("script", nargs="?", default=None,
                    help="training script to run per rank")
    ap.add_argument("script_args", nargs=argparse.REMAINDER,
                    help="arguments passed through to the script")
    args = ap.parse_args(argv)
    from .core.enforce import UnimplementedError

    if args.serve or args.reliability or args.prefill_workers or any(
            getattr(args, f) is not None for f in _SERVE_FLAGS):
        raise UnimplementedError(f"launch --serve {_ITEM8}")
    if not args.script:
        ap.error("script is required")
    endpoints = args.endpoints.split(",") if args.endpoints else None
    return launch(args.script, args.script_args, nproc=args.nproc,
                  endpoints=endpoints, log_dir=args.log_dir,
                  platform=args.platform, timeout=args.timeout,
                  local_devices=args.local_devices, grace=args.grace,
                  elastic=args.elastic, max_restarts=args.max_restarts,
                  min_procs=args.min_procs)


if __name__ == "__main__":
    sys.exit(main())
