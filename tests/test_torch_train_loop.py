"""The port's TrainLoop, Watchdog and input pipeline
(paddle_tpu_torch/train_loop.py, data/device_loader.py) on the CPU.

- Every case of tests/test_train_loop.py on the port (MnistMLP(16, 8),
  Adam(1e-3), batches of 8): checkpoints written and GC'd, crash-resume
  at the step, parameters exact after resume, the nan guard's raise and
  skip-with-rollback, the final snapshot, the watchdog, and the elastic
  recovery cases (a transient fault, an exhausted budget, a zero
  budget, unrecoverable types, EnforceError never recovered, a fault
  before the first checkpoint, no post-fault snapshot, the budget per
  run). ``train_steps`` against single steps lives in
  tests/test_torch_train.py.
- FaultInjector at ``step.nan``: a corrupt rule drives the guard, a
  raising rule (FaultError) the recovery path.
- A 2-layer GPT with dropout 0.1 (vocab 512, hidden 256, B=2, T=64): 4
  steps uninterrupted, and 2 steps, a checkpoint, a rebuilt model and
  trainer (another weight seed) and 2 more: the losses at steps 3-4 are
  equal, exactly (the key round-trips, and the dropout masks follow).
- ``prefetch=2`` and ``prefetch="auto"``: the same losses as no
  prefetch, exactly; ``bucket_by``: a ragged last batch padded as the
  JAX package's BucketPadder pads it (equal arrays); preemption stops
  the loop and the final checkpoint lands; the options that come with
  later items raise naming them."""

import time

import numpy as np
import pytest
import torch

from paddle_tpu.data import device_loader as JDL
import paddle_tpu_torch
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.core import EnforceError, UnimplementedError
from paddle_tpu_torch.core.config import FLAGS
from paddle_tpu_torch.data.device_loader import (BucketPadder,
                                                 DevicePrefetcher,
                                                 prefetch_to_device)
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.mnist import MnistMLP
from paddle_tpu_torch.parallel import Trainer
from paddle_tpu_torch.resilience import (FaultError, FaultInjector,
                                         PreemptionHandler)
from paddle_tpu_torch.train_loop import NanInfError, TrainLoop, Watchdog

RNG = np.random.default_rng(61)


def make_trainer(seed=0):
    model = MnistMLP(16, 8, device="cpu",
                     generator=torch.Generator().manual_seed(seed))
    return Trainer.supervised(
        model, TO.Adam(1e-3),
        lambda out, label: torch.nn.functional.cross_entropy(out, label))


def batches(n, bs=8, rng=RNG):
    for _ in range(n):
        yield {"x": torch.from_numpy(rng.normal(size=(bs, 784)).astype(
                   np.float32)),
               "label": torch.from_numpy(rng.integers(0, 10, bs))}


def bad_batch():
    return {"x": torch.full((8, 784), float("nan")),
            "label": torch.from_numpy(RNG.integers(0, 10, 8))}


class TestTrainLoop:
    def test_checkpoints_written_and_gced(self, tmp_path):
        loop = TrainLoop(make_trainer(), str(tmp_path), checkpoint_every=2,
                         max_to_keep=2)
        assert loop.run(batches(10)) == 10
        assert loop.manager.all_steps() == [8, 10]
        assert loop.status == "completed"

    def test_crash_resume_continues_at_step(self, tmp_path):
        loop = TrainLoop(make_trainer(), str(tmp_path), checkpoint_every=5)
        loop.run(batches(7))                   # close() snapshots step 7
        assert loop.manager.latest_step() == 7
        loop2 = TrainLoop(make_trainer(), str(tmp_path), checkpoint_every=5)
        assert loop2.run(batches(100), num_steps=12) == 12
        assert loop2.history["resumed_from"] == 7

    def test_resume_restores_params_exactly(self, tmp_path):
        tr = make_trainer()
        TrainLoop(tr, str(tmp_path), checkpoint_every=100).run(batches(4))
        saved = {k: v.detach().clone() for k, v in tr.params.items()}
        tr2 = make_trainer(seed=1)
        assert not torch.equal(tr2.params["fc1.weight"],
                               saved["fc1.weight"])
        TrainLoop(tr2, str(tmp_path)).maybe_resume()
        for k, v in tr2.params.items():
            assert torch.equal(v.detach(), saved[k]), k

    def test_nan_raise_policy(self, tmp_path):
        loop = TrainLoop(make_trainer(), str(tmp_path), nan_policy="raise")
        with pytest.raises(NanInfError, match="non-finite loss at step"):
            loop.run(iter([bad_batch()]))
        assert loop.status == "faulted"

    def test_nan_skip_policy_rolls_back(self, tmp_path):
        tr = make_trainer()
        loop = TrainLoop(tr, str(tmp_path), checkpoint_every=2,
                         nan_policy="skip")
        loop.run(batches(2))                   # checkpoints at step 2
        before = {k: v.detach().clone() for k, v in tr.params.items()}
        loop.run(iter([bad_batch()]), resume=False)
        assert loop.history["skipped_steps"] == [2]
        for k, v in tr.params.items():
            assert torch.equal(v.detach(), before[k]), k

    def test_nan_off_policy_and_flag(self, tmp_path):
        loop = TrainLoop(make_trainer(), str(tmp_path), nan_policy="off")
        loop.run(iter([bad_batch()]))
        assert loop.step == 1
        # the flag turns the check on: a non-raise policy then skips
        FLAGS.set("check_nan_inf", True)
        try:
            flagged = TrainLoop(make_trainer(), str(tmp_path / "f"),
                                nan_policy="off")
            flagged.run(iter([bad_batch()]))
        finally:
            FLAGS.reset("check_nan_inf")
        assert flagged.step == 0 and flagged.history["skipped_steps"] == [0]
        with pytest.raises(EnforceError, match="nan_policy"):
            TrainLoop(make_trainer(), str(tmp_path), nan_policy="ignore")

    def test_final_close_snapshots(self, tmp_path):
        loop = TrainLoop(make_trainer(), str(tmp_path),
                         checkpoint_every=1000)
        loop.run(batches(3))
        assert loop.manager.latest_step() == 3

    def test_on_step_sees_every_step(self, tmp_path):
        seen = []
        TrainLoop(make_trainer(), str(tmp_path)).run(
            batches(3), on_step=lambda s, loss, m: seen.append(
                (s, float(loss))))
        assert [s for s, _ in seen] == [1, 2, 3]
        assert all(np.isfinite(v) for _, v in seen)


class TestWatchdog:
    def test_fires_on_stall_and_resets_on_beat(self):
        fired = []
        wd = Watchdog(timeout_s=0.3, on_stall=lambda age: fired.append(age),
                      poll_s=0.05).start()
        try:
            for _ in range(4):
                time.sleep(0.1)
                wd.beat()
            assert not fired
            time.sleep(0.6)
            assert fired and wd.stalled
            wd.beat()
            assert not wd.stalled
        finally:
            wd.stop()

    def test_loop_heartbeats_watchdog(self, tmp_path):
        loop = TrainLoop(make_trainer(), str(tmp_path),
                         watchdog_timeout_s=60)
        loop.run(batches(2))
        assert loop._watchdog is not None and not loop._watchdog.stalled


class TestElasticRecovery:
    def _flaky(self, fail_at, exc=RuntimeError):
        tr = make_trainer()
        real = tr.train_step
        state = {"calls": 0}

        def step(batch):
            state["calls"] += 1
            if state["calls"] in fail_at:
                raise exc("simulated device fault")
            return real(batch)

        tr.train_step = step
        return tr, state

    def test_recovers_from_transient_fault(self, tmp_path):
        tr, _ = self._flaky(fail_at={5})
        loop = TrainLoop(tr, str(tmp_path), checkpoint_every=2,
                         max_recoveries=1)
        assert loop.run(batches(12), num_steps=8) == 8
        assert len(loop.history["recoveries"]) == 1
        rec = loop.history["recoveries"][0]
        assert "simulated device fault" in rec["error"]
        assert rec["step"] == 4 and rec["rolled_back_to"] == 4

    def test_recovery_budget_exhausted_reraises(self, tmp_path):
        tr, _ = self._flaky(fail_at={3, 4, 5, 6, 7, 8, 9})
        loop = TrainLoop(tr, str(tmp_path), checkpoint_every=1,
                         max_recoveries=2)
        with pytest.raises(RuntimeError, match="simulated device fault"):
            loop.run(batches(12), num_steps=10)
        assert len(loop.history["recoveries"]) == 2

    def test_zero_budget_fails_fast(self, tmp_path):
        tr, _ = self._flaky(fail_at={2})
        loop = TrainLoop(tr, str(tmp_path), checkpoint_every=1)
        with pytest.raises(RuntimeError):
            loop.run(batches(6), num_steps=6)

    def test_unrecoverable_error_types_propagate(self, tmp_path):
        tr, _ = self._flaky(fail_at={2}, exc=ValueError)
        loop = TrainLoop(tr, str(tmp_path), checkpoint_every=1,
                         max_recoveries=3)
        with pytest.raises(ValueError):
            loop.run(batches(6), num_steps=6)

    def test_enforce_errors_never_recovered(self, tmp_path):
        tr, _ = self._flaky(fail_at={2}, exc=EnforceError)
        loop = TrainLoop(tr, str(tmp_path), checkpoint_every=1,
                         max_recoveries=5)
        with pytest.raises(EnforceError):
            loop.run(batches(6), num_steps=6)
        assert loop.history["recoveries"] == []

    def test_fault_before_first_checkpoint_reraises(self, tmp_path):
        tr, _ = self._flaky(fail_at={1})
        loop = TrainLoop(tr, str(tmp_path), checkpoint_every=100,
                         max_recoveries=5)
        with pytest.raises(RuntimeError):
            loop.run(batches(6), num_steps=6)

    def test_no_post_fault_snapshot(self, tmp_path):
        tr, _ = self._flaky(fail_at={6})
        loop = TrainLoop(tr, str(tmp_path), checkpoint_every=2)
        with pytest.raises(RuntimeError):
            loop.run(batches(10), num_steps=10)
        assert loop.manager.latest_step() == 4

    def test_recovery_budget_is_per_run(self, tmp_path):
        tr, _ = self._flaky(fail_at={3, 8})
        loop = TrainLoop(tr, str(tmp_path), checkpoint_every=1,
                         max_recoveries=1)
        loop.run(batches(5), num_steps=4)
        assert len(loop.history["recoveries"]) == 1
        loop.run(batches(5), num_steps=8)
        assert len(loop.history["recoveries"]) == 2


class TestInjectedFaults:
    def test_step_nan_corrupt_drives_the_guard(self, tmp_path):
        tr = make_trainer()
        loop = TrainLoop(tr, str(tmp_path), checkpoint_every=2,
                         nan_policy="skip")
        with FaultInjector(seed=0).on("step.nan", corrupt=True, at=(3,)):
            loop.run(batches(5))
        assert loop.history["skipped_steps"] == [2]
        assert loop.step == 4
        with FaultInjector(seed=0).on("step.nan", corrupt=True, at=(1,)):
            with pytest.raises(NanInfError):
                TrainLoop(make_trainer(), str(tmp_path / "r")).run(
                    batches(2))

    def test_step_nan_raising_rule_is_recovered(self, tmp_path):
        loop = TrainLoop(make_trainer(), str(tmp_path), checkpoint_every=2,
                         max_recoveries=1)
        with FaultInjector(seed=0).on("step.nan", at=(5,)) as inj:
            assert loop.run(batches(10), num_steps=6) == 6
        assert inj.fired["step.nan"] == 1
        rec = loop.history["recoveries"]
        assert len(rec) == 1 and "FaultError" in rec[0]["error"]
        assert rec[0]["rolled_back_to"] == 4
        assert issubclass(FaultError, OSError)


class TestPreemption:
    def test_request_stops_clean_and_final_snapshot_lands(self, tmp_path):
        handler = PreemptionHandler()
        loop = TrainLoop(make_trainer(), str(tmp_path),
                         checkpoint_every=100)

        def on_step(step, loss, metrics):
            if step == 3:
                handler.request()

        loop.run(batches(10), on_step=on_step, preemption=handler)
        assert loop.status == "preempted"
        assert loop.history["preempted_at"] == 3
        assert loop.manager.latest_step() == 3
        assert not handler.installed           # the loop uninstalled it

    def test_unported_options_raise_naming_their_item(self, tmp_path):
        loop = TrainLoop(make_trainer(), str(tmp_path))
        for kw, item in ((dict(debug_port=0), "item 8"),
                         (dict(flight_recorder=object()), "item 8"),
                         (dict(controller=object()), "item 11")):
            with pytest.raises(UnimplementedError, match=item):
                loop.run(batches(1), **kw)
        with pytest.raises(UnimplementedError, match="item 11"):
            DevicePrefetcher(batches(1), mesh=object(), device="cpu")


CFG = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
           num_kv_heads=2, intermediate_size=512, max_position=64,
           dropout=0.1)


def _gpt_trainer(seed):
    # the stream seeded as the weights are: a trainer's start key is the
    # stream's next key, so two trainers of one seed start alike
    paddle_tpu_torch.seed(seed)
    model = TG.GPTForCausalLM(TG.GPTConfig(**CFG), device="cpu",
                              generator=torch.Generator().manual_seed(seed))
    return Trainer(model, TO.Adam(1e-3),
                   lambda m, b, g: (m.forward_loss(b), {}))


def _gpt_batches(n):
    rng = np.random.default_rng(5)
    return [torch.from_numpy(rng.integers(1, 512, (2, 64))) for _ in
            range(n)]


def test_dropout_gpt_resume_draws_the_same_masks(tmp_path):
    data = _gpt_batches(4)
    whole = []
    TrainLoop(_gpt_trainer(1), str(tmp_path / "a"), checkpoint_every=0).run(
        iter(data), on_step=lambda s, loss, m: whole.append(float(loss)))
    first = TrainLoop(_gpt_trainer(1), str(tmp_path / "b"),
                      checkpoint_every=2)
    first.run(iter(data[:2]))
    resumed = []
    loop = TrainLoop(_gpt_trainer(2), str(tmp_path / "b"),
                     checkpoint_every=2)
    loop.run(iter(data[2:]), num_steps=4,
             on_step=lambda s, loss, m: resumed.append(float(loss)))
    assert loop.history["resumed_from"] == 2
    assert resumed == whole[2:]
    # and a run with another key draws other masks
    other = _gpt_trainer(1)
    other._key = other._key + np.uint32(1)
    assert float(other.train_step(data[0])[0]) != whole[0]


@pytest.mark.parametrize("prefetch", [2, "auto", 0])
def test_prefetch_gives_the_same_losses(tmp_path, prefetch):
    data = list(batches(6, rng=np.random.default_rng(3)))
    runs = []
    for i, pf in enumerate((None, prefetch)):
        losses = []
        TrainLoop(make_trainer(), str(tmp_path / str(i))).run(
            iter(data), prefetch=pf,
            on_step=lambda s, loss, m: losses.append(float(loss)))
        runs.append(losses)
    assert runs[0] == runs[1] and len(runs[0]) == 6


def test_bucket_padder_matches_jax_on_a_ragged_last_batch():
    rng = np.random.default_rng(7)
    batch = {"x": rng.normal(size=(5, 3)).astype(np.float32),
             "label": rng.integers(0, 10, 5).astype(np.int32),
             "class_w": np.ones(10, np.float32)}
    for kw in (dict(buckets="pow2"), dict(buckets=[4, 8], mode="edge"),
               dict(buckets=[2, 4]), dict(buckets="pow2", pad_value=-1)):
        jgot, jadded = JDL.BucketPadder(**kw).pad(batch)
        tgot, tadded = BucketPadder(**kw).pad(batch)
        assert tadded == jadded
        for k in batch:
            np.testing.assert_array_equal(np.asarray(tgot[k]),
                                          np.asarray(jgot[k]), k)
        # tensors pad the same as arrays
        tens, _ = BucketPadder(**kw).pad({k: torch.from_numpy(v)
                                          for k, v in batch.items()})
        for k in batch:
            np.testing.assert_array_equal(tens[k].numpy(),
                                          np.asarray(jgot[k]), k)


def test_loop_bucket_by_pads_the_ragged_batch(tmp_path):
    data = list(batches(2, bs=8)) + list(batches(1, bs=5))
    seen = []
    tr = make_trainer()
    real = tr.train_step
    tr.train_step = lambda b: seen.append(b["x"].shape[0]) or real(b)
    TrainLoop(tr, str(tmp_path)).run(iter(data), bucket_by="pow2")
    assert seen == [8, 8, 8]


def test_prefetcher_staging_and_teardown():
    data = list(batches(5, rng=np.random.default_rng(9)))
    pf = prefetch_to_device(data, size=2, device="cpu", bucket_by=[8])
    out = list(pf)
    assert len(out) == 5 and pf.batches_staged == 5
    for a, b in zip(out, data):
        assert torch.equal(a["x"], b["x"])
        assert a["x"] is not b["x"]            # donate_safe: a copy
    assert pf.last_real_rows == 8 and pf.host_wait_s >= 0.0
    # abandoning the iterator releases the worker; a worker error
    # re-raises in the consumer
    it = iter(DevicePrefetcher(data, size=1, device="cpu"))
    next(it)
    it.close()

    def broken():
        yield data[0]
        raise OSError("reader failed")

    with pytest.raises(OSError, match="reader failed"):
        list(DevicePrefetcher(broken(), size=2, device="cpu"))
    with pytest.raises(EnforceError, match="'auto'"):
        DevicePrefetcher(data, size="fast", device="cpu")
    auto = DevicePrefetcher(data, size="auto", auto_cap=3, device="cpu")
    assert auto.current_depth == 2 and len(list(auto)) == 5
