"""The port's launcher (paddle_tpu_torch/launch.py) end to end on the
CPU, against the JAX package's tests/test_fleet_controller.py launch and
e2e cases, with workers that train a plan-sharded MnistMLP(16, 8) over
gloo (``fleet.init()``, ``Plan(fsdp=world)``, ``TrainLoop(
checkpoint_every=2)`` on one shared directory, ``controller=
fleet.controller()``):

- fail-fast: a failing rank's code is the job's, a survivor that ignores
  SIGTERM is killed when the grace window ends, and the rank is marked
  dead on the fleet root;
- ``--elastic`` 2 -> 1: rank 1 dies by SIGKILL after a global commit;
  the survivor stops ``preempted`` with the lost rank named, the
  respawned world of one resumes at or after the committed step with
  the checkpoint's exact values and finishes, rc 0;
- the JAX launcher's options that mean nothing here raise:
  ``local_devices`` (one device a process), ``--serve`` (ROADMAP queue 1
  item 8);
- slow (as the JAX package marks its e2e tests): a SIGTERM to one rank
  makes both commit one agreed step, globally, rc 0."""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

from paddle_tpu import launch as jlaunch
from paddle_tpu_torch import launch as L
from paddle_tpu_torch.core import InvalidArgumentError, UnimplementedError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_STUBBORN_RANK0 = textwrap.dedent("""
    import os, signal, sys, time
    if os.environ["PADDLE_TRAINER_ID"] == "1":
        sys.exit(3)
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    time.sleep(120)
""")

_WORKER = textwrap.dedent("""
    import json, os, signal, sys, time
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import checkpoint, fleet, optimizer
    from paddle_tpu_torch.models import mnist as M
    from paddle_tpu_torch.parallel import Plan, Trainer
    from paddle_tpu_torch.train_loop import TrainLoop

    base, mode, num_steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
    run_id = os.environ["PT_FLEET_RUN_ID"]

    def put(name, payload):
        path = os.path.join(base, name)
        with open(path + ".w", "w") as f:
            json.dump(payload, f)
        os.replace(path + ".w", path)

    pt.set_device(pt.CPUPlace(0))
    f = fleet.init()
    rank, world = f.worker_index(), f.worker_num()
    ctl = fleet.controller(poll_interval_s=0.05, agree_timeout_s=30.0,
                           commit_timeout_s=30.0, watch_interval_s=0.05)
    put(f"pid.{{rank}}.{{run_id}}", {{"pid": os.getpid()}})
    pt.seed(0)
    tr = Trainer.supervised(M.MnistMLP(16, 8, device="cpu"),
                            optimizer.Adam(1e-3), M.loss_fn,
                            plan=Plan(fsdp=world, min_shard_size=64,
                                      device="cpu"))
    sh = tr.data_sharding()

    def batches():
        rng = np.random.default_rng(0)
        while True:
            x = rng.normal(size=(8, 784)).astype(np.float32)
            y = rng.integers(0, 10, 8)
            yield {{"x": sh.local(torch.from_numpy(x)),
                    "label": sh.local(torch.from_numpy(y))}}

    ck = os.path.join(base, "ckpt")
    loop = TrainLoop(tr, ck, checkpoint_every=2, max_to_keep=50)
    loop.manager.coordinator = ctl
    resumed = loop.maybe_resume()
    exact = None
    if resumed is not None:
        saved = checkpoint.restore_state(os.path.join(ck, f"step_{{resumed}}"))
        exact = all(torch.equal(p, saved["params"][n])
                    for n, p in tr.params.items())

    def on_step(step, loss, metrics):
        put(f"step.{{rank}}.{{run_id}}", {{"step": step}})
        if mode == "kill" and rank == 1 and run_id.endswith("a0") \\
                and step == 5:
            g = os.path.join(ck, "step_4", "GLOBAL_COMMITTED")
            t0 = time.time()
            while not os.path.exists(g) and time.time() - t0 < 10:
                time.sleep(0.01)
            os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(0.02)

    n = loop.run(batches(), num_steps=num_steps, on_step=on_step,
                 resume=False, controller=ctl)
    put(f"out.{{rank}}.{{run_id}}", {{
        "status": loop.status, "final_step": n, "world": world,
        "resumed_from": resumed, "exact": exact,
        "agreed": loop.history.get("preempt_agreed_step"),
        "lost": loop.history.get("lost_ranks")}})
""")


def _read(base, name):
    try:
        with open(os.path.join(base, name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _launch(base, mode, num_steps, *flags, env=None):
    script = os.path.join(base, "worker.py")
    with open(script, "w") as f:
        f.write(_WORKER.format(repo=REPO))
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.launch", "--nproc", "2",
         "--platform", "cpu", "--log-dir", os.path.join(base, "logs"),
         *flags, script, base, mode, str(num_steps)], cwd=REPO,
        env=dict(os.environ, **(env or {})), start_new_session=True)


def _finish(p, timeout):
    try:
        return p.wait(timeout=timeout)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()


def _global_steps(ck):
    return sorted(int(n[5:]) for n in os.listdir(ck)
                  if n.startswith("step_") and "." not in n
                  and os.path.exists(os.path.join(ck, n, "GLOBAL_COMMITTED")))


def test_fail_fast_kills_stubborn_survivor_within_grace(tmp_path):
    script = tmp_path / "w.py"
    script.write_text(_STUBBORN_RANK0)
    log_dir = str(tmp_path / "logs")
    t0 = time.time()
    rc = L.launch(str(script), [], nproc=2, log_dir=log_dir, grace=1.5)
    assert rc == 3                       # the failing rank's code
    assert time.time() - t0 < 15
    assert os.path.exists(os.path.join(log_dir, "fleet",
                                       f"L{os.getpid()}a0.dead.1"))


def test_elastic_two_to_one_resumes_the_committed_step(tmp_path):
    base = str(tmp_path)
    p = _launch(base, "kill", 8, "--elastic", "--grace", "10")
    rc = _finish(p, 60)
    a0, a1 = f"L{p.pid}a0", f"L{p.pid}a1"
    survivor = _read(base, f"out.0.{a0}")
    assert survivor["status"] == "preempted" and survivor["lost"] == [1]
    assert _read(base, f"out.1.{a0}") is None            # SIGKILLed
    again = _read(base, f"out.0.{a1}")
    assert again["world"] == 1 and again["status"] == "completed"
    assert again["resumed_from"] >= 4 and again["exact"] is True
    assert again["final_step"] == 8
    assert _read(base, f"out.1.{a1}") is None            # N-1 ranks
    assert rc == 0


def test_worker_env_matches_the_jax_launcher():
    eps = ["10.0.0.1:6170", "10.0.0.2:6170"]
    got = L.build_worker_env(1, 2, eps, base_env={}, fleet_dir="/fd",
                             run_id="rid")
    want = jlaunch.build_worker_env(1, 2, eps, base_env={}, fleet_dir="/fd",
                                    run_id="rid")
    for k, v in want.items():
        if k.startswith(("PADDLE_", "PT_FLEET_")):
            assert got[k] == v, k
    assert (got["RANK"], got["WORLD_SIZE"], got["LOCAL_RANK"]) == \
        ("1", "2", "1")
    assert (got["MASTER_ADDR"], got["MASTER_PORT"]) == ("10.0.0.1", "6170")
    assert L.build_worker_env(0, 1, eps[:1], base_env={},
                              platform="cpu")["CUDA_VISIBLE_DEVICES"] == ""


def test_options_without_a_torch_meaning_raise(tmp_path):
    with pytest.raises(InvalidArgumentError, match="one device"):
        L.build_worker_env(0, 1, ["h:1"], local_devices=8)
    with pytest.raises(InvalidArgumentError, match="one device"):
        L.main(["--nproc", "1", "--local-devices", "8", "x.py"])
    for argv in (["--serve", "--spec", "m:f"], ["--spec", "m:f", "x.py"]):
        with pytest.raises(UnimplementedError, match="queue 1 item 8"):
            L.main(argv)


def test_workers_get_half_the_grace_as_collective_timeout(tmp_path):
    """A collective whose peer died waits for its timeout (gloo does not
    always see the peer's sockets close): the launcher gives each
    worker half its grace window, which fleet.init hands to the process
    group, so a survivor stops preempted before its grace kill."""
    script = tmp_path / "w.py"
    script.write_text(
        "import os, sys\n"
        "open(sys.argv[1], 'w').write(os.environ['PT_COLLECTIVE_TIMEOUT_S'])\n")
    out = tmp_path / "t"
    assert L.launch(str(script), [str(out)], nproc=1,
                    log_dir=str(tmp_path / "l"), grace=20.0) == 0
    assert float(out.read_text()) == 10.0


def test_elastic_respects_min_procs(tmp_path):
    script = tmp_path / "w.py"
    script.write_text("import sys; sys.exit(9)\n")
    assert L.launch(str(script), [], nproc=2, log_dir=str(tmp_path / "l"),
                    grace=2.0, elastic=True, min_procs=2) == 9


@pytest.mark.slow
@pytest.mark.chaos
def test_sigterm_to_one_rank_commits_one_agreed_step(tmp_path):
    base = str(tmp_path)
    p = _launch(base, "train", 100000)
    a0 = f"L{p.pid}a0"
    t0 = time.time()
    while (_read(base, f"step.1.{a0}") or {}).get("step", 0) < 5:
        assert time.time() - t0 < 60 and p.poll() is None
        time.sleep(0.05)
    os.kill(_read(base, f"pid.1.{a0}")["pid"], signal.SIGTERM)
    assert _finish(p, 60) == 0
    outs = [_read(base, f"out.{r}.{a0}") for r in (0, 1)]
    agreed = outs[0]["agreed"]
    assert all(o["status"] == "preempted" and o["final_step"] == agreed
               and o["agreed"] == agreed for o in outs)
    assert agreed in _global_steps(os.path.join(base, "ckpt"))


@pytest.mark.slow
@pytest.mark.chaos
def test_elastic_restart_then_notice_ends_clean(tmp_path):
    """The smoke's run (b) on the CPU: an elastic job loses rank 1 after a
    global commit, resumes on one rank, and a PT_PREEMPT_NOTICE file
    ends it with rc 0."""
    base = str(tmp_path)
    notice = os.path.join(base, "NOTICE")
    p = _launch(base, "kill", 100000, "--elastic", "--grace", "10",
                env={"PT_PREEMPT_NOTICE": notice})
    a1 = f"L{p.pid}a1"
    t0 = time.time()
    while _read(base, f"step.0.{a1}") is None:
        assert time.time() - t0 < 60 and p.poll() is None
        time.sleep(0.05)
    open(notice, "w").write("1")
    assert _finish(p, 60) == 0
    out = _read(base, f"out.0.{a1}")
    assert out["status"] == "preempted" and out["world"] == 1
    assert out["resumed_from"] >= 4 and out["exact"] is True
    # a world of one commits alone: COMMITTED, no fleet marker needed
    assert out["agreed"] == out["final_step"]
    assert os.path.exists(os.path.join(base, "ckpt",
                                       f"step_{out['agreed']}", "COMMITTED"))
