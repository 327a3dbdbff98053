"""The port's checkpoint (paddle_tpu_torch/checkpoint.py) and the
Trainer's save and restore, on the CPU, against the JAX package's.

- Every single-process case of tests/test_checkpoint.py on the port:
  round trip (structure, bfloat16, int32 0-dim, None, empty dicts),
  async save and wait with retention, target shape and dtype mismatch,
  async failures surfacing at join and at wait, a custom node rejected,
  a trainer resuming identically (losses equal bit for bit on the CPU),
  the manager with a trainer, and the layer save/load convenience. The
  per-host and mesh calls raise naming ROADMAP queue 1 item 11.
- An async save followed at once by an in-place optimizer step saves
  the pre-step bytes, exactly.
- For the same numpy state the port's and the JAX package's
  ``manifest.json`` agree on skeleton, paths, files, dtypes, shapes and
  checksums (the files' bytes too); only ``spec`` may differ.
- Across the packages, both ways, with the 2-layer test GPT (vocab 512,
  hidden 256, 4 heads over 2 kv heads, B=2, T=64): a JAX Trainer's
  3-step Adam checkpoint restores into the port's Trainer with
  parameters, both moments, step and key bit-equal; then both take 2
  more steps on the same batch with losses at atol 1e-4 (observed
  equal) and keys equal (the port splits its key as JAX does). The
  reverse passes the JAX package's own ``restore_checkpoint`` with its
  target check, bit-equal. Repeated with ``amp.decorate`` under
  ``mixed_fp16`` (the scaler state exact) and with
  ``grad_accum_steps=2`` (the accumulator and its count exact).
- A FaultInjector corrupting the newest step's leaf writes: the
  verified restore falls back to the step before; an explicit restore
  of that step raises ChecksumError; a crc32c-tagged checkpoint
  verifies without a native crc32c module (the pure fallback)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import amp as JAMP
from paddle_tpu import checkpoint as JC
from paddle_tpu import optimizer as JO
from paddle_tpu import parallel as JP
from paddle_tpu.core import dtypes as JD
from paddle_tpu.models import gpt as JG
from paddle_tpu.models import mnist as JM
from paddle_tpu_torch import amp as TAMP
from paddle_tpu_torch import checkpoint as C
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.checkpoint import (CheckpointManager, restore_state,
                                         save_state)
from paddle_tpu_torch.core import EnforceError, UnimplementedError
from paddle_tpu_torch.core import dtypes as TD
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.mnist import MnistMLP
from paddle_tpu_torch.parallel import Trainer
from paddle_tpu_torch.resilience import (ChecksumError, FaultInjector,
                                         integrity)
from paddle_tpu_torch.utils.convert import load_numpy_state

CFG = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
           num_kv_heads=2, intermediate_size=512, max_position=64)
B, T = 2, 64


@pytest.fixture(autouse=True)
def float32_policy():
    yield
    TD.set_policy("float32")
    JD.set_policy("float32")


def _tree():
    return {
        "params": {"w": torch.arange(32, dtype=torch.float32).reshape(8, 4),
                   "b": torch.ones(4, dtype=torch.bfloat16)},
        "opt": {"step": torch.tensor(7, dtype=torch.int32),
                "leaf": [{"m": torch.zeros((8, 4))}, {}]},
        "rng": None,
    }


def _leaves(tree):
    return [x for _, x in C._flatten(tree)]


def _assert_tree_equal(a, b):
    fa, fb = _leaves(a), _leaves(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.dtype == y.dtype
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def test_round_trip_plain(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = _tree()
    save_state(d, tree)
    got = restore_state(d)
    _assert_tree_equal(tree, got)
    assert got["rng"] is None
    assert isinstance(got["opt"]["leaf"], list) and got["opt"]["leaf"][1] \
        == {}
    assert got["params"]["b"].dtype == torch.bfloat16
    assert got["opt"]["step"].shape == () and \
        got["opt"]["step"].dtype == torch.int32
    # and the JAX package reads the same files
    jgot = JC.restore_state(d)
    assert jgot["params"]["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jgot["params"]["w"]),
                                  tree["params"]["w"].numpy())
    assert int(jgot["opt"]["step"]) == 7


def test_bfloat16_leaves_cross_both_ways(tmp_path):
    vals = np.linspace(-3, 3, 24, dtype=np.float32).reshape(4, 6)
    JC.save_state(str(tmp_path / "j"), {"w": jnp.asarray(vals,
                                                         jnp.bfloat16)})
    got = restore_state(str(tmp_path / "j"))["w"]
    want = torch.from_numpy(vals).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    save_state(str(tmp_path / "t"), {"w": want})
    back = JC.restore_state(str(tmp_path / "t"))["w"]
    assert back.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back, np.float32),
                                  want.float().numpy())


def test_async_save_and_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "mgr"), max_to_keep=2,
                            async_save=True)
    for s in (1, 2, 3):
        mgr.save(s, {"x": torch.full((4,), float(s))})
    mgr.wait_until_finished()
    assert mgr.all_steps() == [2, 3]
    assert mgr.latest_step() == 3
    assert torch.equal(mgr.restore()["x"], torch.full((4,), 3.0))
    assert torch.equal(mgr.restore(2)["x"], torch.full((4,), 2.0))
    assert mgr.last_restored_step == 2


def test_target_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "ckpt")
    save_state(d, {"w": torch.zeros((4, 4))})
    with pytest.raises(EnforceError, match="shape"):
        restore_state(d, target={"w": torch.zeros((2, 2))})
    with pytest.raises(EnforceError, match="dtype"):
        restore_state(d, target={"w": torch.zeros((4, 4),
                                                  dtype=torch.bfloat16)})


def test_async_write_failure_surfaces(tmp_path):
    target = tmp_path / "blocked"
    target.write_text("a file where the checkpoint dir must go")
    handle = save_state(str(target / "sub"), {"x": torch.zeros(2)},
                        async_save=True)
    with pytest.raises(Exception):
        handle.join()


def test_manager_async_failure_raises_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "mgr"), async_save=True)
    (tmp_path / "mgr" / "step_5").write_text("collides with the step dir")
    mgr.save(5, {"x": torch.zeros(2)})
    with pytest.raises(Exception):
        mgr.wait_until_finished()


def test_custom_pytree_node_rejected(tmp_path):
    class Box:
        def __init__(self, a, b):
            self.a, self.b = a, b

    with pytest.raises(EnforceError, match="custom pytree"):
        save_state(str(tmp_path / "c"), {"box": Box(torch.zeros(2),
                                                    torch.ones(2))})


def test_namedtuple_comes_back_as_tuple(tmp_path):
    import collections

    Pair = collections.namedtuple("Pair", "a b")
    save_state(str(tmp_path / "n"), {"p": Pair(torch.ones(2), 3)})
    got = restore_state(str(tmp_path / "n"))["p"]
    assert type(got) is tuple and int(got[1]) == 3


def test_per_host_and_mesh_calls_raise_naming_item_11(tmp_path):
    d = str(tmp_path / "c")
    with pytest.raises(UnimplementedError, match="queue 1 item 11"):
        save_state(d, {"x": torch.zeros(2)}, per_host=True)
    save_state(d, {"x": torch.zeros(2)})
    for kw in (dict(mesh=object()), dict(shardings={"x": None})):
        with pytest.raises(UnimplementedError, match="queue 1 item 11"):
            restore_state(d, **kw)
    with pytest.raises(UnimplementedError, match="queue 1 item 11"):
        CheckpointManager(str(tmp_path / "m"), coordinator=object())
    # a JAX per-host (shard-region) checkpoint is refused, not misread
    devs = jax.devices()
    if len(devs) >= 2:
        from jax.sharding import NamedSharding, PartitionSpec as P

        mesh = pt.build_mesh(dp=2, devices=devs[:2])
        w = jax.device_put(jnp.arange(8, dtype=jnp.float32).reshape(4, 2),
                           NamedSharding(mesh, P("dp")))
        JC.save_state(str(tmp_path / "ph"), {"w": w}, per_host=True)
        with pytest.raises(UnimplementedError, match="queue 1 item 11"):
            restore_state(str(tmp_path / "ph"))


def test_async_save_then_step_keeps_the_pre_step_bytes(tmp_path):
    model = MnistMLP(16, 8, device="cpu")
    params = dict(model.named_parameters())
    opt = TO.Adam(0.1)
    state = opt.init(params)
    before = {k: v.detach().clone() for k, v in params.items()}
    handle = save_state(str(tmp_path / "a"), {"params": params},
                        async_save=True)
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    opt.apply(params, grads, state)            # in place, at once
    handle.join()
    got = restore_state(str(tmp_path / "a"))["params"]
    for k in params:
        assert torch.equal(got[k], before[k]), k
        assert not torch.equal(params[k].detach(), before[k]), k


def _npy_state():
    rng = np.random.default_rng(3)
    return {"params": {"b.w": rng.normal(size=(3, 5)).astype(np.float32),
                       "a": rng.normal(size=(4,)).astype(np.float32),
                       "h": rng.normal(size=(2, 2)).astype(np.float16)},
            "opt_state": {"step": np.int32(4),
                          "leaf": [{"m": np.ones((4,), np.float32)}, {}]},
            "rng": np.array([0, 5], np.uint32), "none": None,
            "t": (np.arange(3, dtype=np.int32),)}


def test_manifest_matches_jax_for_the_same_state(tmp_path):
    st = _npy_state()
    jtree = jax.tree_util.tree_map(jnp.asarray, st)
    ttree = {
        "params": {k: torch.from_numpy(v) for k, v in st["params"].items()},
        "opt_state": {"step": torch.tensor(4, dtype=torch.int32),
                      "leaf": [{"m": torch.ones(4)}, {}]},
        "rng": torch.from_numpy(st["rng"]), "none": None,
        "t": (torch.arange(3, dtype=torch.int32),)}
    JC.save_state(str(tmp_path / "j"), jtree)
    save_state(str(tmp_path / "t"), ttree)
    with open(tmp_path / "j" / "manifest.json") as f:
        jm = json.load(f)
    with open(tmp_path / "t" / "manifest.json") as f:
        tm = json.load(f)
    assert tm["format"] == jm["format"] == "paddle_tpu_ckpt/v1"
    assert tm["skeleton"] == jm["skeleton"]
    assert tm["checksums"] == jm["checksums"]

    def strip(leaves):
        return [{k: v for k, v in e.items() if k != "spec"} for e in leaves]

    assert strip(tm["leaves"]) == strip(jm["leaves"])
    assert all(e["spec"] is None for e in tm["leaves"])
    for e in tm["leaves"]:
        assert (tmp_path / "t" / e["file"]).read_bytes() == \
            (tmp_path / "j" / e["file"]).read_bytes(), e["path"]
    for d in ("j", "t"):
        marker = json.loads((tmp_path / d / "COMMITTED").read_text())
        assert marker["process_count"] == 1


def _mnist_trainer(opt=None):
    model = MnistMLP(16, 8, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    return Trainer.supervised(
        model, opt or TO.Adam(1e-3),
        lambda out, label: torch.nn.functional.cross_entropy(out, label))


def _mnist_batch(seed=0, bs=16):
    rng = np.random.default_rng(seed)
    return {"x": torch.from_numpy(rng.normal(size=(bs, 784)).astype(
                np.float32)),
            "label": torch.from_numpy(rng.integers(0, 10, bs))}


def test_trainer_save_restore_resumes_identically(tmp_path):
    batch = _mnist_batch()
    tr = _mnist_trainer()
    for _ in range(3):
        tr.train_step(batch)
    d = str(tmp_path / "resume")
    tr.save_checkpoint(d)
    want = [float(tr.train_step(batch)[0]) for _ in range(3)]
    tr2 = _mnist_trainer()
    storage = {k: v.data_ptr() for k, v in tr2.params.items()}
    tr2.restore_checkpoint(d)
    assert {k: v.data_ptr() for k, v in tr2.params.items()} == storage
    got = [float(tr2.train_step(batch)[0]) for _ in range(3)]
    assert got == want


def test_trainer_manager_integration(tmp_path):
    tr = _mnist_trainer(TO.SGD(0.1))
    mgr = CheckpointManager(str(tmp_path / "mgr"), max_to_keep=3)
    tr.save_checkpoint(mgr, step=0)
    mgr.wait_until_finished()
    assert mgr.all_steps() == [0]
    tr.restore_checkpoint(mgr)
    with pytest.raises(EnforceError, match="needs a step"):
        tr.save_checkpoint(mgr)


def test_trainer_restore_refuses_another_model(tmp_path):
    tr = _mnist_trainer()
    tr.save_checkpoint(str(tmp_path / "c"))
    other = Trainer.supervised(MnistMLP(32, 8, device="cpu"), TO.Adam(1e-3),
                               lambda o, y: o.sum())
    before = {k: v.detach().clone() for k, v in other.params.items()}
    with pytest.raises(EnforceError, match="shape"):
        other.restore_checkpoint(str(tmp_path / "c"))
    for k, v in other.params.items():          # nothing was copied
        assert torch.equal(v.detach(), before[k])


def test_layer_save_load_convenience(tmp_path):
    m = MnistMLP(16, 8, device="cpu")
    p = str(tmp_path / "layer")
    C.save(m, p)
    m2 = MnistMLP(16, 8, device="cpu",
                  generator=torch.Generator().manual_seed(1))
    m2.load_state_dict(C.load(p))
    for (n, a), b in zip(m.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), n
    # across the packages: a JAX layer file loads into the port's layer
    pt.seed(0)
    jm = JM.MnistMLP(hidden1=16, hidden2=8)
    JC.save(jm, str(tmp_path / "jlayer"))
    m2.load_state_dict(C.load(str(tmp_path / "jlayer")))
    for n, v in m2.state_dict().items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(jm.state_dict()[n]))


# ----- across the packages ----------------------------------------------

def _pair(seed):
    pt.seed(seed)
    jm = JG.GPTForCausalLM(JG.GPTConfig(**CFG))
    tm = TG.GPTForCausalLM(TG.GPTConfig(**CFG), device="cpu")
    load_numpy_state(tm, {k: np.asarray(v)
                          for k, v in jm.named_parameters().items()})
    return jm, tm


def _jax_trainer(jm, opt, **kw):
    def loss_builder(params, buffers, rng, batch):
        out, nb = jm.functional_call(params, batch, buffers=buffers,
                                     rng=rng, training=rng is not None,
                                     method="forward_loss")
        return out, ({}, nb)

    return JP.Trainer(jm, opt, loss_builder, **kw)


def _torch_trainer(tm, opt, **kw):
    return Trainer(tm, opt, lambda model, batch, gen: (
        model.forward_loss(batch), {}), **kw)


def _ids(seed):
    return np.random.default_rng(seed).integers(1, 512, (B, T)).astype(
        np.int32)


def _key(jt):
    return np.asarray(jax.random.key_data(jt._rng))


def _opt_leaves(state):
    """(path, value) of an optimizer state, by the checkpoint's paths."""
    return [(p, np.asarray(v.numpy() if torch.is_tensor(v) else v))
            for p, v in C._flatten(state)]


def _assert_state_equal(tt, jt):
    """Parameters, optimizer state (moments, step, scaler), key and the
    accumulator of the two trainers, bit for bit."""
    for name, p in tt.params.items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(jt.params[name]), name)
    t_opt = _opt_leaves(tt.state()["opt_state"])
    j_opt = [(p, np.asarray(v)) for p, v in C._flatten(
        jax.tree_util.tree_map(np.asarray, jt.opt_state))]
    assert [p for p, _ in t_opt] == [p for p, _ in j_opt]
    for (path, a), (_, b) in zip(t_opt, j_opt):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, path)
    np.testing.assert_array_equal(tt._key, _key(jt))
    if tt.grad_accum_steps > 1:
        assert tt._accum_count == int(jt._accum_count)
        for name, a in tt._accum.items():
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(jt._accum[name]), name)


CROSS = {
    "adam": dict(opt=lambda M: M.Adam(1e-3), kw={}, steps=3),
    "mixed_fp16": dict(opt=lambda M: (JAMP if M is JO else TAMP).decorate(
        M.Adam(1e-3), init_loss_scaling=2.0 ** 12), kw={"amp": "mixed_fp16"},
        steps=3),
    "grad_accum": dict(opt=lambda M: M.Adam(1e-3),
                       kw={"grad_accum_steps": 2}, steps=3),
}


@pytest.mark.parametrize("case", list(CROSS))
def test_jax_checkpoint_restores_into_the_port(case, tmp_path):
    spec = CROSS[case]
    jm, tm = _pair(8)
    jt = _jax_trainer(jm, spec["opt"](JO), **spec["kw"])
    tt = _torch_trainer(tm, spec["opt"](TO), **spec["kw"])
    ids = _ids(9)
    for _ in range(spec["steps"]):
        jt.train_step(jnp.asarray(ids))
    d = str(tmp_path / "jax")
    jt.save_checkpoint(d)
    tt.restore_checkpoint(d)
    _assert_state_equal(tt, jt)
    for _ in range(2):
        jl, _ = jt.train_step(jnp.asarray(ids))
        tl, _ = tt.train_step(torch.from_numpy(ids))
        np.testing.assert_allclose(float(tl), float(jl), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tt._key, _key(jt))


@pytest.mark.parametrize("case", list(CROSS))
def test_port_checkpoint_restores_into_jax(case, tmp_path):
    spec = CROSS[case]
    jm, tm = _pair(10)
    tt = _torch_trainer(tm, spec["opt"](TO), **spec["kw"])
    ids = torch.from_numpy(_ids(11))
    for _ in range(spec["steps"]):
        tt.train_step(ids)
    d = str(tmp_path / "port")
    tt.save_checkpoint(d)
    TD.set_policy("float32")
    pt.seed(99)                                # another initial key
    jt = _jax_trainer(JG.GPTForCausalLM(JG.GPTConfig(**CFG)),
                      spec["opt"](JO), **spec["kw"])
    jt.restore_checkpoint(d)                   # with the target check
    _assert_state_equal(tt, jt)


def test_jax_target_check_refuses_a_mismatched_port_checkpoint(tmp_path):
    _, tm = _pair(12)
    tt = _torch_trainer(tm, TO.Adam(1e-3))
    tt.save_checkpoint(str(tmp_path / "c"))
    pt.seed(0)
    jm = JG.GPTForCausalLM(JG.GPTConfig(**dict(CFG, vocab_size=256)))
    jt = _jax_trainer(jm, JO.Adam(1e-3))
    from paddle_tpu.core.enforce import EnforceError as JEnforceError

    with pytest.raises(JEnforceError, match="shape"):
        jt.restore_checkpoint(str(tmp_path / "c"))


# ----- integrity ------------------------------------------------------------

def test_corrupt_newest_step_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "m"), max_to_keep=3,
                            async_save=False)
    mgr.save(1, {"x": torch.full((64,), 1.0)})
    with FaultInjector(seed=0).on("ckpt.write", corrupt=True,
                                  match="step_2"):
        mgr.save(2, {"x": torch.full((64,), 2.0)})
    assert mgr.committed_steps() == [1, 2]     # torn bytes, committed dir
    got = mgr.restore()
    assert mgr.last_restored_step == 1
    assert torch.equal(got["x"], torch.full((64,), 1.0))
    with pytest.raises(ChecksumError, match="checksum mismatch"):
        mgr.restore(2)
    # the same at read time
    with FaultInjector(seed=0).on("restore.read", corrupt=True,
                                  match="step_1", times=1):
        with pytest.raises(ChecksumError):
            mgr.restore(1)


def test_torn_step_without_marker_is_skipped_and_collected(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "m"), max_to_keep=2,
                            async_save=False)
    for s in (1, 2):
        mgr.save(s, {"x": torch.full((4,), float(s))})
    os.remove(tmp_path / "m" / "step_2" / "COMMITTED")
    assert mgr.committed_steps() == [1] and mgr.all_steps() == [1, 2]
    assert torch.equal(mgr.restore()["x"], torch.full((4,), 1.0))
    # a kill mid-swap leaves a step's only copy as .old: GC puts it back
    os.rename(tmp_path / "m" / "step_1", tmp_path / "m" / "step_1.old")
    mgr.save(3, {"x": torch.full((4,), 3.0)})
    assert mgr.committed_steps() == [1, 3]
    assert not (tmp_path / "m" / "step_2").exists()


def test_transient_write_fault_is_retried(tmp_path):
    with FaultInjector(seed=0).on("ckpt.write", times=1) as inj:
        save_state(str(tmp_path / "c"), {"x": torch.ones(3)})
    assert inj.fired["ckpt.write"] == 1
    assert torch.equal(restore_state(str(tmp_path / "c"))["x"],
                       torch.ones(3))


def test_checksum_tags_and_pure_crc32c(monkeypatch):
    data = bytes(range(256)) * 5
    tag = integrity.checksum_bytes(data)
    from paddle_tpu.resilience import integrity as JI

    assert tag == JI.checksum_bytes(data)      # same algorithm, same value
    integrity.verify_bytes(data, tag)
    integrity.verify_bytes(memoryview(data), tag)
    import zlib

    crc = f"crc32:{zlib.crc32(data) & 0xffffffff:08x}"
    integrity.verify_bytes(data, crc)
    if tag.startswith("crc32c:"):
        monkeypatch.setattr(integrity, "_IMPL", None)
        integrity.verify_bytes(data, tag)      # the pure fallback
        assert integrity.checksum_bytes(data) == crc
    with pytest.raises(ChecksumError, match="unknown checksum algorithm"):
        integrity.verify_bytes(data, "md5:00")
    with pytest.raises(ChecksumError, match="mismatch"):
        integrity.verify_bytes(data + b"x", tag)
