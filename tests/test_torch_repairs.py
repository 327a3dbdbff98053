"""The two parity faults found in the port against the JAX package, held
against it on the CPU:

- the embedding lookup has ``jnp.take``'s fill semantics: an id in
  [-V, 0) reads row id + V, an id outside [-V, V) a row of NaN; so one
  bad prompt token poisons its own request in a BatchedDecoder and no
  other, where the port's lookup used to raise;
- ``Trainer.train_steps(batch, n)`` moves the key as the JAX Trainer's
  fused scan does (split once a call, the sub-key split n ways), so the
  key after it, and in a checkpoint saved after it, is the JAX
  package's.

Tolerances: the lookup exactly (a gather); the key and the checkpoint's
key exactly (threefry bit for bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import optimizer as JO
from paddle_tpu import parallel as JP
from paddle_tpu.models import mnist as JM
from paddle_tpu.ops import nn as JN
from paddle_tpu_torch import checkpoint as C
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models import mnist as TM
from paddle_tpu_torch.ops import nn as TN
from paddle_tpu_torch.parallel import Trainer
from paddle_tpu_torch.serving import BatchedDecoder
from paddle_tpu_torch.utils.convert import load_numpy_state

V = 6
# out of range on both sides, the wrapped negatives, the edges
IDS = np.array([[-V - 1, -V, -1, 0], [V - 1, V, 2 * V, 3]], np.int32)


@pytest.mark.parametrize("padding_idx", [None, 3, -1])
def test_embedding_fills_like_jnp_take(padding_idx):
    table = np.random.default_rng(0).normal(size=(V, 4)).astype(np.float32)
    want = np.asarray(JN.embedding(jnp.asarray(IDS), jnp.asarray(table),
                                   padding_idx))
    got = TN.embedding(torch.from_numpy(IDS), torch.from_numpy(table),
                       padding_idx).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[0, 0]).all() and np.isnan(got[1, 1:3]).all()
    if padding_idx is None:             # -V and -1 wrap
        np.testing.assert_array_equal(got[0, 1:3], table[[0, V - 1]])


def test_embedding_gradient_reaches_only_rows_in_range():
    table = torch.randn(V, 4, requires_grad=True)
    TN.embedding(torch.from_numpy(IDS), table).nan_to_num(0.0).sum(
    ).backward()
    counts = np.zeros(V)
    for i in IDS.ravel():
        if -V <= i < V:
            counts[i % V] += 1
    np.testing.assert_array_equal(table.grad[:, 0].numpy(), counts)


def _tiny_gpt():
    cfg = TG.GPTConfig(vocab_size=64, hidden_size=128, num_layers=1,
                       num_heads=2, num_kv_heads=1, intermediate_size=128,
                       max_position=128)
    return TG.GPTForCausalLM(cfg, device="cpu", generator=torch.Generator(
        ).manual_seed(3)).eval()


@pytest.mark.parametrize("paged", [False, True])
def test_decoder_serves_beside_an_out_of_range_token(paged):
    """Four requests in four slots, one carrying token 71 of a 64-token
    vocabulary: nothing raises, and the three good requests' tokens
    equal a run without the bad one."""
    model = _tiny_gpt()
    kw = dict(pages=8, page_size=64) if paged else {}
    prompts = [[1, 2, 3], [5, 6, 7, 8], [9, 10], [11, 12, 13]]
    outs = []
    for bad in (False, True):
        dec = BatchedDecoder(model, slots=4, capacity=128, device="cpu",
                             **kw)
        ps = [list(p) for p in prompts]
        if bad:
            ps[1][2] = 64 + 7
        rids = [dec.submit(p, 6) for p in ps]
        res = dec.run()
        outs.append([np.asarray(res[r]) for r in rids])
    for i in (0, 2, 3):
        np.testing.assert_array_equal(outs[1][i], outs[0][i])
    assert outs[1][1].shape == (6,)


# ----- the trainer's key across train_steps --------------------------------

START = np.array([7, 11], np.uint32)
AFTER_3 = np.array([2598293523, 2951297909], np.uint32)


def _trainers():
    pt.seed(0)
    jm = JM.MnistMLP(16, 8)
    tm = TM.MnistMLP(16, 8, device="cpu")
    load_numpy_state(tm, {k: np.asarray(v)
                          for k, v in jm.named_parameters().items()})
    jt = JP.Trainer.supervised(jm, JO.Adam(1e-3), JM.loss_fn)
    tt = Trainer.supervised(tm, TO.Adam(1e-3), TM.loss_fn)
    jt._rng = jax.random.wrap_key_data(jnp.asarray(START))
    tt._key = START.copy()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 784)).astype(np.float32)
    y = rng.integers(0, 10, (8,)).astype(np.int32)
    return (jt, {"x": jnp.asarray(x), "label": jnp.asarray(y)},
            tt, {"x": torch.from_numpy(x), "label": torch.from_numpy(y)})


def test_train_steps_moves_the_key_as_jax(tmp_path):
    jt, jbatch, tt, tbatch = _trainers()
    jl, _ = jt.train_steps(jbatch, 3)
    tl, _ = tt.train_steps(tbatch, 3)
    jkey = np.asarray(jax.random.key_data(jt._rng))
    np.testing.assert_array_equal(jkey, AFTER_3)
    np.testing.assert_array_equal(tt._key, AFTER_3)
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-4, rtol=0)
    # the key a checkpoint saved after it carries, in both packages
    tt.save_checkpoint(str(tmp_path / "port"))
    jt.save_checkpoint(str(tmp_path / "jax"))
    for d in ("port", "jax"):
        st = C.restore_state(str(tmp_path / d))
        np.testing.assert_array_equal(np.asarray(st["rng"]), AFTER_3)


def test_train_steps_differs_from_n_train_step_calls():
    """n train_step calls split the key n times: another key than one
    train_steps call, as in the JAX package."""
    _, _, tt, tbatch = _trainers()
    for _ in range(3):
        tt.train_step(tbatch)
    assert not np.array_equal(tt._key, AFTER_3)
    jt, jbatch, _, _ = _trainers()
    for _ in range(3):
        jt.train_step(jbatch)
    np.testing.assert_array_equal(
        tt._key, np.asarray(jax.random.key_data(jt._rng)))
