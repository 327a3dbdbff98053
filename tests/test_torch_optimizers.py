"""The port's fourteen optimizer rules and ExponentialMovingAverage
(paddle_tpu_torch/optimizer/optimizers.py) against the JAX package's on
the same numpy parameters and grads, float32 on the CPU.

- Each class with its default setting and one non-default setting, 3
  updates: every parameter and every state leaf after each update at
  atol 1e-5 (observed at most 3.8e-6, on accumulators of magnitude ~10:
  the same float32 formulas in the same order, a last-bit rounding
  apart; LarsMomentum and Lamb reduce a norm per tensor, summed in
  another order). The grads have no entry below 0.1 in magnitude, so the
  adaptive rules' divisions stay well-conditioned.
- The EMA's shadow and bias-corrected average over 3 updates, same
  tolerance; its count is 3 in both.
- The state's leaf order is the JAX package's: ``opt.init`` on a dict of
  parameters gives the i-th state entry to the i-th parameter by sorted
  name (``jax.tree_util``'s dict order), for the 2-layer test GPT's
  parameters too (the pinned repair: the port flattened dicts in
  insertion order, which ``named_parameters()`` is not sorted in)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import gpt as JG
from paddle_tpu.optimizer import optimizers as JO
from paddle_tpu_torch.core import UnimplementedError
from paddle_tpu_torch.clip import tree_leaves
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.optimizer import optimizers as TO

# insertion order is not sorted order: the leaf-order repair shows here
SHAPES = {"b.w": (3, 2, 2), "a.weight": (4, 5), "a.bias": (5,)}
ATOL = 1e-5


def _params(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(seed):
    """Entries in +-[0.1, 1.5): none near zero."""
    rng = np.random.default_rng(seed)
    return {k: (rng.choice([-1.0, 1.0], size=s)
                * rng.uniform(0.1, 1.5, size=s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=0)


# name -> (default construction, a non-default one), over the module M
CASES = {
    "SGD": (lambda M: M.SGD(), lambda M: M.SGD(0.3)),
    "Momentum": (lambda M: M.Momentum(),
                 lambda M: M.Momentum(0.05, momentum=0.8, use_nesterov=True)),
    "LarsMomentum": (lambda M: M.LarsMomentum(),
                     lambda M: M.LarsMomentum(0.1, momentum=0.5,
                                              lars_coeff=0.01,
                                              lars_weight_decay=1e-3)),
    "Adam": (lambda M: M.Adam(), lambda M: M.Adam(1e-2, beta1=0.8,
                                                  beta2=0.99, epsilon=1e-6)),
    "AdamW": (lambda M: M.AdamW(), lambda M: M.AdamW(1e-2,
                                                     weight_decay=0.1)),
    "Adamax": (lambda M: M.Adamax(), lambda M: M.Adamax(1e-2, beta1=0.7,
                                                        beta2=0.9)),
    "Adagrad": (lambda M: M.Adagrad(),
                lambda M: M.Adagrad(0.05, epsilon=1e-4,
                                    initial_accumulator_value=0.1)),
    "DecayedAdagrad": (lambda M: M.DecayedAdagrad(),
                       lambda M: M.DecayedAdagrad(0.05, decay=0.8)),
    "Adadelta": (lambda M: M.Adadelta(),
                 lambda M: M.Adadelta(0.5, rho=0.9, epsilon=1e-4)),
    "RMSProp": (lambda M: M.RMSProp(),
                lambda M: M.RMSProp(0.02, rho=0.9, momentum=0.5,
                                    centered=True)),
    "Ftrl": (lambda M: M.Ftrl(),
             lambda M: M.Ftrl(0.1, l1=0.01, l2=0.02, lr_power=-0.6)),
    "Lamb": (lambda M: M.Lamb(), lambda M: M.Lamb(1e-2, weight_decay=0.0,
                                                  beta1=0.8)),
    "ProximalGD": (lambda M: M.ProximalGD(0.1),
                   lambda M: M.ProximalGD(0.1, l1=0.05, l2=0.1)),
    "ProximalAdagrad": (lambda M: M.ProximalAdagrad(0.1),
                        lambda M: M.ProximalAdagrad(0.1, l1=0.05, l2=0.1)),
}


def test_fourteen_classes():
    assert len(CASES) == 14
    for name in CASES:
        assert issubclass(getattr(TO, name), TO.Optimizer)


@pytest.mark.parametrize("setting", ["default", "other"])
@pytest.mark.parametrize("name", list(CASES))
def test_three_updates_match_jax(name, setting):
    make = CASES[name][setting == "other"]
    jopt, topt = make(JO), make(TO)
    start = _params(0)
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = _grads(step + 1)
        jp, js = jopt.apply(jp, {k: jnp.asarray(v) for k, v in g.items()},
                            js)
        tp2, ts2 = topt.apply(tp, {k: torch.from_numpy(v)
                                   for k, v in g.items()}, ts)
        assert tp2 is tp and ts2 is ts         # updated in place
        for k in SHAPES:
            _close(tp[k], jp[k])
        # every state leaf, in the JAX package's leaf order and keys
        assert len(ts["leaf"]) == len(js["leaf"])
        for t_leaf, j_leaf in zip(ts["leaf"], js["leaf"]):
            assert sorted(t_leaf) == sorted(j_leaf)
            for key in j_leaf:
                _close(t_leaf[key], j_leaf[key])
    assert ts["step"] == int(js["step"]) == 3


def test_ema_matches_jax():
    jema, tema = JO.ExponentialMovingAverage(0.9), \
        TO.ExponentialMovingAverage(0.9)
    start = _params(3)
    js = jema.init({k: jnp.asarray(v) for k, v in start.items()})
    ts = tema.init({k: torch.from_numpy(v) for k, v in start.items()})
    for step in range(3):
        p = _params(10 + step)
        js = jema.update({k: jnp.asarray(v) for k, v in p.items()}, js)
        ts = tema.update({k: torch.from_numpy(v) for k, v in p.items()},
                         ts)
        for k in SHAPES:
            _close(ts["shadow"][k], js["shadow"][k])
    assert ts["count"] == int(js["count"]) == 3
    want, got = jema.average(js), tema.average(ts)
    for k in SHAPES:
        _close(got[k], want[k])


def test_state_leaf_order_is_jax_order():
    """The i-th state entry belongs to the i-th parameter by sorted name
    in both packages: moments initialised from the parameters themselves
    (Adagrad's accumulator would hide it, so a rule whose state copies
    the parameter is used: the state's shapes and values say whose it
    is)."""
    class Tag(TO.Optimizer):
        def init_leaf(self, p):
            return {"tag": p.clone()}

    class JTag(JO.Optimizer):
        def init_leaf(self, p):
            return {"tag": p}

    start = _params(4)
    ts = Tag().init({k: torch.from_numpy(v) for k, v in start.items()})
    js = JTag().init({k: jnp.asarray(v) for k, v in start.items()})
    want = [start[k] for k in sorted(start)]
    assert list(start) != sorted(start)        # insertion order differs
    for t_leaf, j_leaf, w in zip(ts["leaf"], js["leaf"], want):
        np.testing.assert_array_equal(t_leaf["tag"].numpy(), w)
        np.testing.assert_array_equal(np.asarray(j_leaf["tag"]), w)


def test_gpt_state_leaf_order_matches_jax():
    cfg = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
               num_kv_heads=2, intermediate_size=512, max_position=64)
    pt.seed(0)
    jm = JG.GPTForCausalLM(JG.GPTConfig(**cfg))
    tm = TG.GPTForCausalLM(TG.GPTConfig(**cfg), device="cpu")
    tparams = dict(tm.named_parameters())
    jparams = jm.named_parameters()
    assert list(tparams) != sorted(tparams)    # the repair's case
    jleaves, _ = jax.tree_util.tree_flatten_with_path(jparams)
    jnames = [path[0].key for path, _ in jleaves]
    assert jnames == sorted(jparams)
    tleaves = tree_leaves(tparams)
    assert [id(x) for x in tleaves] == [id(tparams[n]) for n in jnames]
    ts = TO.Adam(1e-3).init(tparams)
    js = JO.Adam(1e-3).init(jparams)
    for name, t_leaf, j_leaf in zip(jnames, ts["leaf"], js["leaf"]):
        assert tuple(t_leaf["m"].shape) == tuple(j_leaf["m"].shape) == \
            tuple(tparams[name].shape), name


def test_static_entry_points_raise_naming_their_item():
    opt = TO.Adam(1e-3)
    with pytest.raises(UnimplementedError, match="queue 1 item 12"):
        opt.apply_gradients([])
    with pytest.raises(UnimplementedError, match="queue 1 item 12"):
        opt.apply_optimize(None, params_grads=[])
