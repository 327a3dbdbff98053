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
key exactly (threefry bit for bit).

And the out-of-range reads of ``ops/decode.py``, which raised on the
CPU and asserted on the card: the CTC
loss, the CRF and edit distance with labels and lengths out of range
give the JAX package's values (``take_along_axis`` reads NaN, ``x[...]``
clamps and drops the clamped read's gradient), losses within 1e-5 and
their gradients within 1e-5."""

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


def _decode_case(name):
    from paddle_tpu.ops import decode as JD
    from paddle_tpu_torch.ops import decode as TD

    rng = np.random.default_rng(7)
    if name == "ctc_loss":
        lp = rng.normal(size=(3, 6, 5)).astype(np.float32)
        lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
        # a label past V, an input length past T, a label length past L
        args = [lp, np.array([[1, 2], [3, 7], [2, 2]], np.int32),
                np.array([6, 9, 4], np.int32), np.array([2, 2, 3], np.int32)]
        return JD.ctc_loss, TD.ctc_loss, args, (0,)
    if name == "linear_chain_crf":
        em = rng.normal(size=(3, 4, 5)).astype(np.float32)
        tr = rng.normal(size=(5, 5)).astype(np.float32)
        st = rng.normal(size=(5,)).astype(np.float32)
        sp = rng.normal(size=(5,)).astype(np.float32)
        # a label past N in row 1, a negative one (wraps) in row 2, lengths
        # past T in rows 0 and 2
        labels = np.array([[0, 1, 2, 3], [4, 5, 1, 2], [1, 1, -1, 2]],
                          np.int32)
        args = [em, tr, labels, np.array([6, 4, 9], np.int32), st, sp]

        def j(e, t, l, n, s0, s1):
            return JD.linear_chain_crf(e, t, l, n, start_transitions=s0,
                                       stop_transitions=s1)

        def t(e, t_, l, n, s0, s1):
            return TD.linear_chain_crf(e, t_, l, n, start_transitions=s0,
                                       stop_transitions=s1)
        return j, t, args, (0, 1, 4, 5)
    hyp = rng.integers(0, 4, (3, 5)).astype(np.int32)
    ref = rng.integers(0, 4, (3, 4)).astype(np.int32)
    args = [hyp, np.array([5, 3, 7], np.int32), ref,
            np.array([4, 9, 2], np.int32)]
    normalized = name.endswith("normalized")
    return (lambda *a: JD.edit_distance(*a, normalized=normalized),
            lambda *a: TD.edit_distance(*a, normalized=normalized), args, ())


@pytest.mark.parametrize("name", ["ctc_loss", "linear_chain_crf",
                                  "edit_distance",
                                  "edit_distance_normalized"])
def test_decode_ops_read_out_of_range_as_jax(name):
    from torch_parity import check_pair

    jfn, tfn, args, grad = _decode_case(name)
    check_pair(jfn, tfn, args, atol=1e-5, rtol=1e-5, grad=grad)
