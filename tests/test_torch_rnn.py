"""The recurrent stack (``ops/rnn.py``, ``ops/sequence.py``
``sequence_mask``, ``nn/rnn_layers.py``, the cells and ``RNN`` of
``nn/layers.py``, ``models/stacked_lstm.py``) against the JAX package's
on the same inputs and weights (numpy seeds), float32 on the CPU, the
JAX side jitted:

- every function of ops/rnn.py: its outputs and the gradients of
  ``sum(out * cot)`` to every input, with and without ``lengths``
  (rows shorter than the padded length, one of length 0), forwards and
  ``is_reverse``, lstm with ``forget_bias``, initial states and
  lstmp's projection;
- LSTM and GRU layers, 2 layers, bidirectional, with lengths (outputs,
  final states, gradients); GRUCell, LSTMCell and RNN (batch- and
  time-major, with lengths);
- a tiny StackedLSTM (vocab 64, width 16, 2 layers, T=12, lengths in
  [6, 12]): its logits, and 4 Adam steps through Trainer.supervised
  against the JAX Trainer's losses.

Tolerances: outputs 1e-5 and gradients 1e-5 of each input's largest
JAX-gradient entry (1e-4 for the layers and the model, whose float32
orders of summation differ more); Trainer losses 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as JO
from paddle_tpu import parallel as JP
from paddle_tpu.models import stacked_lstm as JSL
from paddle_tpu.ops import rnn as JR
from paddle_tpu.ops import sequence as JSQ
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.models import stacked_lstm as TSL
from paddle_tpu_torch.ops import rnn as TR
from paddle_tpu_torch.ops import sequence as TSQ
from paddle_tpu_torch.parallel import Trainer
from paddle_tpu_torch.utils.convert import load_numpy_state

B, T, D, H = 3, 7, 5, 4
LENGTHS = np.array([7, 4, 0], np.int32)


def _rand(rng, *shape, scale=0.5):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _check(jfn, tfn, arrays, tol=1e-5, grad_args=None):
    """``jfn``/``tfn`` map the arrays to an output pytree; compare the
    outputs, and the gradients of ``sum(out_leaf * cot)`` over the
    leaves to the arrays at ``grad_args`` (all by default)."""
    grad_args = range(len(arrays)) if grad_args is None else grad_args
    jout = jax.jit(jfn)(*map(jnp.asarray, arrays))
    leaves = jax.tree_util.tree_leaves(jout)
    rng = np.random.default_rng(99)
    cots = [rng.normal(size=np.shape(l)).astype(np.float32) for l in leaves]

    def jloss(*a):
        return sum(jnp.sum(l * c) for l, c in
                   zip(jax.tree_util.tree_leaves(jfn(*a)), cots))

    jg = jax.jit(jax.grad(jloss, argnums=tuple(grad_args)))(
        *map(jnp.asarray, arrays))
    targs = [torch.tensor(a, requires_grad=i in grad_args)
             for i, a in enumerate(arrays)]
    tout = tfn(*targs)
    tleaves = jax.tree_util.tree_leaves(
        tout, is_leaf=lambda x: torch.is_tensor(x))
    assert len(tleaves) == len(leaves)
    for tl, jl in zip(tleaves, leaves):
        np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                                   rtol=0, atol=tol)
    sum(torch.sum(tl * torch.from_numpy(c))
        for tl, c in zip(tleaves, cots)).backward()
    for i, g in zip(grad_args, jg):
        g = np.asarray(g)
        got = targs[i].grad
        got = np.zeros_like(g) if got is None else got.numpy()
        np.testing.assert_allclose(got, g, rtol=0,
                                   atol=tol * max(np.abs(g).max(), 1e-30),
                                   err_msg=f"grad {i}")


def test_sequence_mask():
    lengths = np.array([3, 0, 5])
    for jd, td in ((jnp.float32, torch.float32), (jnp.bool_, torch.bool)):
        want = np.asarray(JSQ.sequence_mask(jnp.asarray(lengths), 5, jd))
        got = TSQ.sequence_mask(torch.from_numpy(lengths), 5, td)
        np.testing.assert_array_equal(got.numpy(), want)


def test_lstm_and_gru_units():
    rng = np.random.default_rng(0)
    g4, h, c = _rand(rng, B, 4 * H), _rand(rng, B, H), _rand(rng, B, H)
    _check(lambda *a: JR.lstm_unit(*a, forget_bias=1.0),
           lambda *a: TR.lstm_unit(*a, forget_bias=1.0), [g4, h, c])
    _check(lambda *a: JR.lstm_unit(*a, gate_activation="relu",
                                   cell_activation="identity"),
           lambda *a: TR.lstm_unit(*a, gate_activation="relu",
                                   cell_activation="identity"), [g4, h, c])
    g3, w = _rand(rng, B, 3 * H), _rand(rng, H, 3 * H)
    _check(JR.gru_unit, TR.gru_unit, [g3, h, w])


LSTM_CASES = {
    "plain": dict(),
    "lengths": dict(lengths=True),
    "reverse_lengths": dict(lengths=True, is_reverse=True),
    "forget_bias_h0_c0": dict(forget_bias=1.0, states=True),
    "lstmp": dict(proj=True, lengths=True, proj_activation="tanh"),
    "lstmp_reverse": dict(proj=True, lengths=True, is_reverse=True),
}


@pytest.mark.parametrize("case", list(LSTM_CASES))
def test_lstm_matches_jax(case):
    o = dict(LSTM_CASES[case])
    rng = np.random.default_rng(1)
    r = 3 if o.pop("proj", False) else H
    arrays = [_rand(rng, B, T, D), _rand(rng, D, 4 * H), _rand(rng, r, 4 * H),
              _rand(rng, 4 * H)]
    if r != H:
        arrays.append(_rand(rng, H, r))
    if o.pop("states", False):
        arrays += [_rand(rng, B, r), _rand(rng, B, H)]
    lengths = LENGTHS if o.pop("lengths", False) else None

    def call(mod, lib):
        def f(x, w_ih, w_hh, bias, *rest):
            kw = dict(o)
            rest = list(rest)
            if r != H:
                kw["proj_weight"] = rest.pop(0)
            if rest:
                kw["h0"], kw["c0"] = rest
            if lengths is not None:
                kw["lengths"] = lib(lengths)
            return mod.lstm(x, w_ih, w_hh, bias=bias, **kw)
        return f

    _check(call(JR, jnp.asarray), call(TR, torch.from_numpy), arrays)


@pytest.mark.parametrize("case", ["plain", "lengths", "reverse_lengths",
                                  "h0"])
def test_gru_matches_jax(case):
    rng = np.random.default_rng(2)
    arrays = [_rand(rng, B, T, D), _rand(rng, D, 3 * H), _rand(rng, H, 3 * H),
              _rand(rng, 3 * H)]
    if case == "h0":
        arrays.append(_rand(rng, B, H))
    kw = dict(is_reverse=case == "reverse_lengths")

    def call(mod, lib):
        def f(x, w_ih, w_hh, bias, *h0):
            extra = dict(kw)
            if h0:
                extra["h0"] = h0[0]
            if case in ("lengths", "reverse_lengths"):
                extra["lengths"] = lib(LENGTHS)
            return mod.gru(x, w_ih, w_hh, bias=bias, **extra)
        return f

    _check(call(JR, jnp.asarray), call(TR, torch.from_numpy), arrays)


def test_lstmp_row_conv_conv_shift_sequence_conv():
    rng = np.random.default_rng(3)
    x = _rand(rng, B, T, D)
    _check(lambda x, a, b, p, c: JR.lstmp(x, a, b, p, bias=c),
           lambda x, a, b, p, c: TR.lstmp(x, a, b, p, bias=c),
           [x, _rand(rng, D, 4 * H), _rand(rng, 2, 4 * H), _rand(rng, H, 2),
            _rand(rng, 4 * H)])
    w = _rand(rng, 3, D)
    for lengths in (None, LENGTHS):
        conv = [lambda x, w, m=m, lib=lib: m.row_conv(
            x, w, None if lengths is None else lib(lengths))
            for m, lib in ((JR, jnp.asarray), (TR, torch.from_numpy))]
        _check(*conv, [x, w])
    _check(JR.conv_shift, TR.conv_shift, [_rand(rng, B, 8), _rand(rng, B, 3)])
    for ctx_len, start, lengths in ((3, None, None), (3, None, LENGTHS),
                                    (4, -1, LENGTHS), (2, 1, None)):
        def seq(m, lib):
            return lambda x, w, bias: m.sequence_conv(
                x, w, None if lengths is None else lib(lengths),
                context_length=ctx_len, context_start=start, bias=bias)
        _check(seq(JR, jnp.asarray), seq(TR, torch.from_numpy),
               [x, _rand(rng, ctx_len * D, 6), _rand(rng, 6)])


@pytest.mark.parametrize("reverse", [False, True])
def test_dynamic_rnn_with_a_tuple_state(reverse):
    rng = np.random.default_rng(4)

    def run(mod, lib, wrap):
        def f(x, wx, wh, h0, c0):
            def cell(xt, state):
                h, c = state
                nh = lib.tanh(xt @ wx + h @ wh)
                return nh * 2.0, (nh, c + nh)

            return mod.dynamic_rnn(cell, x, (h0, c0), lengths=wrap(LENGTHS),
                                   is_reverse=reverse)
        return f

    _check(run(JR, jnp, jnp.asarray), run(TR, torch, torch.from_numpy),
           [_rand(rng, B, T, D), _rand(rng, D, H), _rand(rng, H, H),
            _rand(rng, B, H), _rand(rng, B, H)])


def _layer_pair(jcls, tcls, *args, **kw):
    pt.seed(5)
    jm, tm = jcls(*args, **kw), tcls(*args, device="cpu", **kw)
    assert list(jm.named_parameters()) == [n for n, _ in
                                           tm.named_parameters()]
    load_numpy_state(tm, {k: np.asarray(v)
                          for k, v in jm.named_parameters().items()})
    return jm, tm


def _layer_check(jm, tm, inputs, call, tol=1e-4):
    """Outputs and parameter gradients of ``call(model, *inputs)``."""
    def jf(p):
        out = jm.functional_call(p, *inputs[0], training=False, **inputs[1])[0]
        return out

    jout = jax.jit(jf)(jm.named_parameters())
    leaves = jax.tree_util.tree_leaves(jout)
    rng = np.random.default_rng(98)
    cots = [rng.normal(size=np.shape(l)).astype(np.float32) for l in leaves]
    jg = jax.jit(jax.grad(lambda p: sum(
        jnp.sum(l * c) for l, c in zip(jax.tree_util.tree_leaves(jf(p)),
                                       cots))))(jm.named_parameters())
    tout = call(tm)
    tleaves = jax.tree_util.tree_leaves(
        tout, is_leaf=lambda x: torch.is_tensor(x))
    for tl, jl in zip(tleaves, leaves):
        np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                                   rtol=0, atol=tol)
    sum(torch.sum(tl * torch.from_numpy(c))
        for tl, c in zip(tleaves, cots)).backward()
    for k, p in tm.named_parameters():
        g = np.asarray(jg[k])
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=tol * max(np.abs(g).max(), 1e-30),
                                   err_msg=k)


@pytest.mark.parametrize("kind", ["LSTM", "GRU"])
def test_stacked_bidirectional_layers_match_jax(kind):
    jm, tm = _layer_pair(getattr(jnn, kind), getattr(tnn, kind), D, H,
                         num_layers=2, direction="bidirect", scan_unroll=2)
    x = _rand(np.random.default_rng(6), B, T, D)
    _layer_check(jm, tm, ((jnp.asarray(x),),
                          dict(lengths=jnp.asarray(LENGTHS))),
                 lambda m: m(torch.from_numpy(x),
                             lengths=torch.from_numpy(LENGTHS)))


@pytest.mark.parametrize("time_major", [False, True])
def test_cells_and_rnn_match_jax(time_major):
    rng = np.random.default_rng(7)
    x = _rand(rng, B, T, D)
    xs = x.transpose(1, 0, 2) if time_major else x
    h0, c0 = _rand(rng, B, H), _rand(rng, B, H)
    for jc, tc, state in ((jnn.LSTMCell, tnn.LSTMCell, (h0, c0)),
                          (jnn.GRUCell, tnn.GRUCell, h0)):
        pt.seed(8)
        jm = jnn.RNN(jc(D, H), time_major=time_major)
        tm = tnn.RNN(tc(D, H, device="cpu"), time_major=time_major)
        load_numpy_state(tm, {k: np.asarray(v) for k, v in
                              jm.named_parameters().items()})
        jstate = jax.tree_util.tree_map(jnp.asarray, state)
        tstate = jax.tree_util.tree_map(torch.from_numpy, state)
        lengths = None if time_major else LENGTHS
        jkw = {} if lengths is None else dict(lengths=jnp.asarray(lengths))
        _layer_check(jm, tm, ((jnp.asarray(xs), jstate), jkw),
                     lambda m: m(torch.from_numpy(xs), tstate,
                                 lengths=None if lengths is None
                                 else torch.from_numpy(lengths)))


SL = dict(vocab_size=64, embed_dim=16, hidden_dim=16, num_layers=2)


def test_stacked_lstm_logits_and_trainer_match_jax():
    pt.seed(9)
    jm = JSL.StackedLSTM(**SL)
    tm = TSL.StackedLSTM(**SL, device="cpu")
    load_numpy_state(tm, {k: np.asarray(v)
                          for k, v in jm.named_parameters().items()})
    rng = np.random.default_rng(10)
    ids = rng.integers(0, 64, (6, 12))
    lengths = rng.integers(6, 13, (6,))
    label = (ids[:, 0] % 2).astype(np.int32)
    want = jax.jit(lambda i, n: jm(i, n))(jnp.asarray(ids),
                                          jnp.asarray(lengths))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)

    def jloss(out, y):
        return JSL.loss_fn(out, y)

    class JWrap(jnn.Layer):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, x):
            return self.m(x[0], x[1])

    class TWrap(tnn.Layer):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, x):
            return self.m(x[0], x[1])

    jt = JP.Trainer.supervised(JWrap(jm), JO.Adam(1e-2), jloss,
                               mesh=pt.build_mesh(dp=1,
                                                  devices=jax.devices()[:1]))
    tt = Trainer.supervised(TWrap(tm), TO.Adam(1e-2), TSL.loss_fn)
    jb = {"x": (jnp.asarray(ids), jnp.asarray(lengths)),
          "label": jnp.asarray(label)}
    tb = {"x": (torch.from_numpy(ids), torch.from_numpy(lengths)),
          "label": torch.from_numpy(label)}
    want = [float(jt.train_step(jb)[0]) for _ in range(4)]
    got = [float(tt.train_step(tb)[0]) for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got[-1] < got[0]
    acc = TSL.eval_metrics(tm(torch.from_numpy(ids),
                              torch.from_numpy(lengths)),
                           torch.from_numpy(label))["acc"]
    assert 0.0 <= float(acc) <= 1.0
