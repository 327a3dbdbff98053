"""The port's fleet (paddle_tpu_torch/fleet.py) against the JAX package's
(tests/test_fleet.py:36-229), in one process:

- ``RoleMaker`` on the same ``PADDLE_*`` environment gives the JAX
  RoleMaker's rank, world, endpoints and coordinator; torch's
  ``RANK``/``WORLD_SIZE``/``MASTER_ADDR:MASTER_PORT`` stand where the JAX
  package reads ``JAX_*``;
- a strategy gives the mesh shape (and, across hosts, the rank layout)
  the JAX fleet builds over as many devices as the port's world has
  ranks, or the same error: the port's mesh here is a layout over the
  role's 4 ranks (``connect=False``), the JAX one over 4 of the CPU sim's
  devices;
- the helpers: the AMP wrap, the one-call trainer, gradient merge, the
  module-level delegation, ``controller()`` from the role, the lazy
  top-level ``paddle_tpu_torch.fleet``;
- no silent fallback: with no card and no ``set_device(CPUPlace(0))``,
  ``init`` raises DeviceUnavailableError."""

import os

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.core.mesh as JM
from paddle_tpu import fleet as jfleet
from paddle_tpu.core.enforce import EnforceError as JEnforceError
import paddle_tpu_torch
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import fleet
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.core import (DeviceUnavailableError, EnforceError,
                                   places)
from paddle_tpu_torch.core import mesh as TM
from paddle_tpu_torch.core.dtypes import set_policy
from paddle_tpu_torch.models import mnist as TMN

ENV = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ENDPOINTS",
       "JAX_PROCESS_ID", "JAX_NUM_PROCESSES", "JAX_COORDINATOR_ADDRESS",
       "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(places, "_default_device", torch.device("cpu"))
    monkeypatch.setattr(TM, "_current_mesh", TM._current_mesh)
    monkeypatch.setattr(JM, "_current_mesh", JM._current_mesh)
    yield
    fleet.instance()._initialized = False


@pytest.fixture
def four_jax_devices(monkeypatch):
    devs = jax.devices()[:4]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: list(devs))


class TestRoleMaker:
    def test_single_process_defaults(self):
        r = fleet.RoleMaker()
        assert (r.rank, r.world_size, r.coordinator, r.endpoints) == \
            (0, 1, None, [])
        assert r.is_first_worker()

    def test_paddle_env_matches_the_jax_role(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
        monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", ",".join(
            f"10.0.0.{i}:6170" for i in range(1, 5)))
        got, want = fleet.RoleMaker(), jfleet.RoleMaker()
        assert (got.rank, got.world_size, got.endpoints, got.coordinator) \
            == (want.rank, want.world_size, want.endpoints,
                want.coordinator) == (2, 4, want.endpoints, "10.0.0.1:6170")
        assert not got.is_first_worker()

    def test_torch_env_in_place_of_jax(self, monkeypatch):
        monkeypatch.setenv("RANK", "1")
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("MASTER_ADDR", "host0")
        monkeypatch.setenv("MASTER_PORT", "1234")
        r = fleet.RoleMaker()
        assert (r.rank, r.world_size, r.coordinator) == (1, 2, "host0:1234")
        # the PADDLE_* protocol wins over torch's, as over JAX_*
        monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
        assert fleet.RoleMaker().rank == 0

    def test_bad_rank_rejected(self):
        with pytest.raises(EnforceError):
            fleet.RoleMaker(rank=5, world_size=2)


def _shape(mesh):
    return {k: int(v) for k, v in mesh.shape.items()}


@pytest.mark.parametrize("strategy", [
    dict(), dict(tp=2), dict(dp=2, sp=2), dict(tp=2, dcn_axis="tp"),
    dict(ep=4, dcn_axis="ep"), dict(dp=5), dict(tp=3),
    dict(dcn_axis="zz")],
    ids=["dp", "tp2", "dp2-sp2", "tp-over-hosts", "ep-over-hosts",
         "dp-too-big", "tp-indivisible", "bad-axis"])
def test_strategy_builds_the_jax_mesh_or_the_same_error(strategy,
                                                         four_jax_devices):
    def build(mod, err):
        role = mod.RoleMaker(rank=0, world_size=4)
        try:
            return mod.init(role=role, strategy=mod.DistributedStrategy(
                **strategy), connect=False).mesh
        except err as e:
            return str(e).split(" (")[0].split(":")[0]

    want = build(jfleet, JEnforceError)
    got = build(fleet, EnforceError)
    if isinstance(want, str):
        assert isinstance(got, str) and got.split()[0:2] == \
            want.split()[0:2], (got, want)
        return
    assert _shape(got) == _shape(want)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.devices, ids)
    assert got.device == torch.device("cpu")


def test_multiprocess_needs_coordinator():
    with pytest.raises(EnforceError, match="coordinator"):
        fleet.init(role=fleet.RoleMaker(rank=0, world_size=2), connect=True)


def test_no_card_and_no_request_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setattr(places, "_default_device", None)
    with pytest.raises(DeviceUnavailableError, match="CPUPlace"):
        fleet.init()


class TestHelpers:
    def test_module_level_delegation_and_lazy_name(self):
        f = fleet.init()
        assert f.initialized and f.mesh.shape["dp"] == 1
        assert fleet.worker_num() == 1 and fleet.is_first_worker()
        assert fleet.instance() is f
        assert paddle_tpu_torch.fleet is fleet
        f.shutdown()
        assert not f.initialized

    def test_distributed_optimizer_amp_wrap(self):
        f = fleet.init(strategy=fleet.DistributedStrategy(amp="mixed_fp16"))
        try:
            opt = f.distributed_optimizer(TO.Adam(1e-3))
            assert isinstance(opt, tamp.MixedPrecisionOptimizer)
        finally:
            set_policy("float32")

    def test_one_call_trainer_trains_and_merges(self):
        rng = np.random.default_rng(0)
        paddle_tpu_torch.seed(0)
        f = fleet.init(strategy=fleet.DistributedStrategy(
            gradient_merge_steps=2))
        tr = f.trainer(TMN.MnistMLP(32, 16, device="cpu"), TO.Adam(1e-2),
                       TMN.loss_fn)
        assert tr.grad_accum_steps == 2 and tr.mesh is f.mesh
        batch = {"x": torch.from_numpy(rng.normal(size=(8, 784)).astype(
                     np.float32)),
                 "label": torch.from_numpy(rng.integers(0, 10, 8))}
        losses = [float(tr.train_step(batch)[0]) for _ in range(10)]
        assert losses[-1] < losses[0]

    def test_controller_takes_the_role(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "3")
        monkeypatch.setenv("PT_FLEET_DIR", str(tmp_path))
        monkeypatch.setenv("PT_FLEET_RUN_ID", "rr")
        fleet.instance()._role = None
        ctl = fleet.controller(poll_interval_s=0.0)
        assert (ctl.rank, ctl.world, ctl.run_id) == (1, 3, "rr")
        assert ctl.transport.kind == "file"
        assert ctl.transport.root == str(tmp_path)
