"""The port's functional entry points of ``nn/layer.py``
(``Layer.functional_call``, ``Layer.apply_fn``, ``inject_state``,
``stacked_parameters``) against the JAX package's, on the CPU, float32,
on the same weights and numpy inputs:

- ``functional_call`` with BatchNorm buffers in training mode returns
  the JAX package's output and new running statistics, and leaves the
  caller's dicts, the layer's own tensors and its modes as they were;
  ``method=`` runs another method; gradients reach the passed tensors;
- ``apply_fn`` is ``functional_call`` without buffers;
- ``inject_state`` binds two models at once, lets gradients flow to
  the bound tensors, and puts the same ``nn.Parameter`` objects back;
- ``stacked_parameters`` stacks as the JAX package does and refuses
  layers of another structure.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import nn as jnn
from paddle_tpu.core import dtypes as JDT
from paddle_tpu.nn import layer as JL
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core import EnforceError
from paddle_tpu_torch.core import dtypes as TDT
from paddle_tpu_torch.nn import layer as TL
from paddle_tpu_torch.utils.convert import load_numpy_state

TOL = 1e-5


@pytest.fixture(autouse=True)
def fresh_streams():
    pt.seed(0)
    ptt.seed(0)
    JDT.set_policy("float32")
    TDT.set_policy("float32")
    yield


class JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.bn = jnn.BatchNorm(3)
        self.fc = jnn.Linear(12, 2)

    def forward(self, x):
        return self.fc(self.bn(x).reshape(x.shape[0], -1))

    def scaled(self, x, k=2.0):
        return self.forward(x) * k


class TNet(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.bn = tnn.BatchNorm(3, device="cpu")
        self.fc = tnn.Linear(12, 2, device="cpu")

    def forward(self, x):
        return self.fc(self.bn(x).reshape(x.shape[0], -1))

    def scaled(self, x, k=2.0):
        return self.forward(x) * k


def _np(t):
    return t.detach().numpy()


def _pair():
    jm, tm = JNet(), TNet()
    load_numpy_state(tm, {k: np.asarray(v)
                          for k, v in jm.named_parameters().items()})
    return jm, tm


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 3, 2, 2)).astype(np.float32)
    params = {"fc.weight": rng.normal(size=(12, 2)).astype(np.float32),
              "fc.bias": rng.normal(size=(2,)).astype(np.float32),
              "bn.weight": rng.normal(size=(3,)).astype(np.float32),
              "bn.bias": rng.normal(size=(3,)).astype(np.float32)}
    buffers = {"bn.mean": rng.normal(size=(3,)).astype(np.float32),
               "bn.variance": rng.uniform(0.5, 2, (3,)).astype(np.float32)}
    return x, params, buffers


@pytest.mark.parametrize("method", ["forward", "scaled"])
@pytest.mark.parametrize("training", [True, False])
def test_functional_call_matches_jax_and_mutates_nothing(method, training):
    jm, tm = _pair()
    x, params, buffers = _inputs()
    jout, jbuf = jm.functional_call(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        buffers={k: jnp.asarray(v) for k, v in buffers.items()},
        training=training, method=method)
    tparams = {k: torch.tensor(v, requires_grad=True)
               for k, v in params.items()}
    tbuf = {k: torch.tensor(v) for k, v in buffers.items()}
    before = {k: v.clone() for k, v in {**tparams, **tbuf}.items()}
    own = dict(tm.state_dict(keep_vars=True))
    own_values = {k: v.detach().clone() for k, v in own.items()}
    tm.eval()
    tout, tnew = tm.functional_call(tparams, torch.from_numpy(x),
                                    buffers=tbuf, training=training,
                                    method=method)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=TOL)
    assert sorted(tnew) == sorted(jbuf)
    for k, v in tnew.items():
        np.testing.assert_allclose(_np(v), np.asarray(jbuf[k]), atol=TOL,
                                   err_msg=k)
    # the caller's tensors, the layer's own objects and values, its modes
    for k, v in {**tparams, **tbuf}.items():
        assert torch.equal(v, before[k]), k
    for k, v in tm.state_dict(keep_vars=True).items():
        assert v is own[k] and torch.equal(v.detach(), own_values[k]), k
    assert not any(m.training for m in tm.modules())
    # gradients reach the passed tensors
    tout.sum().backward()
    assert all(p.grad is not None and p.grad.abs().sum() > 0
               for p in tparams.values())


def test_functional_call_without_buffers_keeps_the_layers():
    """No ``buffers=``: the layer's own statistics run on copies; the
    updated ones come back and the layer's stay."""
    jm, tm = _pair()
    x, params, _ = _inputs()
    _, jbuf = jm.functional_call({k: jnp.asarray(v)
                                  for k, v in params.items()},
                                 jnp.asarray(x), training=True)
    mean0 = tm.bn.mean.clone()
    _, tnew = tm.functional_call({k: torch.from_numpy(v)
                                  for k, v in params.items()},
                                 torch.from_numpy(x), training=True)
    assert torch.equal(tm.bn.mean, mean0)
    np.testing.assert_allclose(_np(tnew["bn.mean"]),
                               np.asarray(jbuf["bn.mean"]), atol=TOL)
    with pytest.raises(EnforceError, match="unknown parameter"):
        tm.functional_call({"fc.nope": torch.zeros(1)}, torch.from_numpy(x))


def test_apply_fn_matches_jax():
    jm = JL.Sequential(jnn.Linear(5, 4), jnn.Linear(4, 2))
    tm = tnn.Sequential(tnn.Linear(5, 4, device="cpu"),
                        tnn.Linear(4, 2, device="cpu"))

    class Wrap(tnn.Layer):                 # Sequential is not a Layer
        def __init__(self, inner):
            super().__init__()
            self.net = inner

        def forward(self, x):
            return self.net(x)

    class JWrap(jnn.Layer):
        def __init__(self, inner):
            super().__init__()
            self.net = inner

        def forward(self, x):
            return self.net(x)

    jw, tw = JWrap(jm), Wrap(tm)
    rng = np.random.default_rng(1)
    params = {k: rng.normal(size=tuple(v.shape)).astype(np.float32)
              for k, v in jw.named_parameters().items()}
    x = rng.normal(size=(3, 5)).astype(np.float32)
    jout = jw.apply_fn()({k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(x))
    tout = tw.apply_fn()({k: torch.from_numpy(v) for k, v in params.items()},
                         torch.from_numpy(x))
    np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=TOL)


def test_inject_state_binds_two_models_and_restores_parameters():
    _, a = _pair()
    b = tnn.Linear(2, 1, device="cpu")
    x, params, buffers = _inputs()
    a_objs = dict(a.named_parameters())
    b_objs = dict(b.named_parameters())
    bound_a = {k: torch.tensor(v, requires_grad=True)
               for k, v in params.items()}
    bound_b = {"weight": torch.ones(2, 1, requires_grad=True)}
    tbuf = {k: torch.from_numpy(v) for k, v in buffers.items()}
    buf0 = {k: v.clone() for k, v in tbuf.items()}
    with TL.inject_state((a, bound_a, tbuf), (b, bound_b)):
        assert a.fc.weight is bound_a["fc.weight"]
        assert b.weight is bound_b["weight"]
        out = b(a.train()(torch.from_numpy(x))).sum()
    out.backward()
    assert bound_b["weight"].grad is not None
    assert all(p.grad is not None for p in bound_a.values())
    for k, p in a.named_parameters():
        assert p is a_objs[k] and isinstance(p, torch.nn.Parameter), k
        assert p.grad is None, k
    for k, p in b.named_parameters():
        assert p is b_objs[k], k
    for k, v in tbuf.items():
        assert torch.equal(v, buf0[k]), k      # buffers ran on copies
    # JAX's inject_state on the same bindings gives the same output
    jm, _ = _pair()
    jb = jnn.Linear(2, 1)
    with JL.inject_state((jm, {k: jnp.asarray(v) for k, v in params.items()},
                          {k: jnp.asarray(v) for k, v in buffers.items()}),
                         (jb, {"weight": jnp.ones((2, 1)),
                               "bias": jnp.asarray(_np(b.bias))})):
        jout = jnp.sum(jb(jm(jnp.asarray(x))))
    np.testing.assert_allclose(float(out.detach()), float(jout), rtol=TOL)


def test_stacked_parameters_matches_jax():
    jl = [jnn.Linear(3, 2) for _ in range(3)]
    tl = [tnn.Linear(3, 2, device="cpu") for _ in range(3)]
    for j, t in zip(jl, tl):
        load_numpy_state(t, {k: np.asarray(v)
                             for k, v in j.named_parameters().items()})
    js, ts = JL.stacked_parameters(jl), TL.stacked_parameters(tl)
    assert list(ts) == list(js) == ["bias", "weight"]
    for k in js:
        np.testing.assert_array_equal(_np(ts[k]), np.asarray(js[k]))
    with pytest.raises(EnforceError, match="structurally identical"):
        TL.stacked_parameters([tl[0], tnn.Linear(3, 2, bias_attr=False,
                                                 device="cpu")])
    with pytest.raises(EnforceError, match="at least one layer"):
        TL.stacked_parameters([])
