"""Mixed precision in the port (paddle_tpu_torch core/dtypes.py,
amp.py, optimizer/loss_scaler.py, the Linear's policy reads, Trainer
amp=) against the JAX package on the same seeded numpy inputs, on the
CPU.

Tolerances: casts, the loss-scale state and the scaler's unscaled grads
exactly (the same float32 operations); the scaled round trip through
SGD 1e-6 (the JAX test's own bound, one float32 multiply and one
subtract per entry); a Linear under a bfloat16 policy 2e-2 (bfloat16
keeps 8 bits, so one rounding of a product entry of magnitude < 4 moves
it by up to 1.6e-2) and under mixed_fp16 1e-3 (float16 keeps 11 bits:
an entry of magnitude < 2 rounds by up to 1e-3); float32 1e-6; the
MnistMLP trainings' losses the same per policy. Each test puts the
global policy back to float32, in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu as pt
from paddle_tpu import amp as JAMP
from paddle_tpu import optimizer as JO
from paddle_tpu import parallel as JP
from paddle_tpu.core import dtypes as JD
from paddle_tpu.core.enforce import EnforceError as JEnforceError
from paddle_tpu.models import mnist as JM
from paddle_tpu.optimizer.loss_scaler import DynamicLossScaler as JScaler
from paddle_tpu_torch import amp as TAMP
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.core import EnforceError, InvalidArgumentError
from paddle_tpu_torch.core import dtypes as TD
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.mnist import MnistMLP
from paddle_tpu_torch.ops import attention as TA
from paddle_tpu_torch.optimizer import DynamicLossScaler
from paddle_tpu_torch.parallel import Trainer
from paddle_tpu_torch.utils.convert import load_numpy_state

TOL = {"float32": 1e-6, "bfloat16": 2e-2, "mixed_bf16": 2e-2,
       "mixed_fp16": 1e-3}


@pytest.fixture(autouse=True)
def float32_policy():
    yield
    TD.set_policy("float32")
    JD.set_policy("float32")


def _np(x):
    """A float32 (or integer) numpy copy of a torch or JAX array."""
    if torch.is_tensor(x):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind in "fV" or \
        x.dtype.name == "bfloat16" else x


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


# ----- the policy -----------------------------------------------------------

def test_policies_and_dtype_predicates_match_jax():
    assert TD.POLICIES.keys() == JD.POLICIES.keys()
    for name, pol in TD.POLICIES.items():
        ref = JD.POLICIES[name]
        assert (pol.param_dtype, pol.compute_dtype, pol.output_dtype) == (
            ref.param_dtype, ref.compute_dtype, ref.output_dtype), name
    for name in TD._DTYPES:
        assert TD.is_floating(name) == JD.is_floating(name), name
        assert TD.is_integer(name) == JD.is_integer(name), name
    assert TD.get_policy() == TD.Policy() and JD.get_policy() == JD.Policy()


@pytest.mark.parametrize("policy", sorted(TD.POLICIES))
def test_policy_casts_floating_leaves_of_a_tree(policy):
    rng = np.random.default_rng(0)
    f = rng.normal(size=(3, 5)).astype(np.float32) * 3
    i = rng.integers(-9, 9, (4,)).astype(np.int32)
    b = rng.normal(size=(2,)).astype(np.float32)
    tree_t = {"f": torch.from_numpy(f), "n": [torch.from_numpy(i),
              (torch.from_numpy(b).to(torch.bfloat16),)]}
    tree_j = {"f": jnp.asarray(f), "n": [jnp.asarray(i),
              (jnp.asarray(b).astype(jnp.bfloat16),)]}
    for cast in ("cast_to_compute", "cast_to_output"):
        got = getattr(TD.POLICIES[policy], cast)(tree_t)
        want = getattr(JD.POLICIES[policy], cast)(tree_j)
        assert got["n"][0] is tree_t["n"][0]         # integer leaf untouched
        for g, w in ((got["f"], want["f"]), (got["n"][0], want["n"][0]),
                     (got["n"][1][0], want["n"][1][0])):
            assert str(g.dtype).split(".")[-1] == str(w.dtype), (g.dtype,
                                                                 w.dtype)
            np.testing.assert_array_equal(_np(g), _np(w))


def test_policy_scope_restores_after_an_exception():
    for D in (TD, JD):
        with pytest.raises(ZeroDivisionError):
            with D.policy_scope("mixed_bf16"):
                with D.policy_scope(D.Policy("float32", "float16",
                                             "float16")) as inner:
                    assert D.get_policy() is inner
                    1 / 0
        assert D.get_policy() == D.POLICIES["float32"]
    with TAMP.amp_guard() as pol:
        assert pol == TD.POLICIES["mixed_bf16"]
    assert TD.get_policy() == TD.POLICIES["float32"]


@pytest.mark.parametrize("call", ["set_policy", "policy_scope"])
def test_unknown_policy_name_raises_typed(call):
    with pytest.raises(JEnforceError, match="unknown policy"):
        with JD.policy_scope("fp8"):
            pass
    with pytest.raises(EnforceError, match="unknown policy fp8"):
        if call == "set_policy":
            TD.set_policy("fp8")
        else:
            with TD.policy_scope("fp8"):
                pass
    assert TD.get_policy() == TD.POLICIES["float32"]


# ----- the op lists ---------------------------------------------------------

@pytest.mark.parametrize("white,black", [
    (None, None), ({"softmax"}, {"matmul"}), ({"exp", "log"}, None),
    (None, {"conv2d", "relu"})])
def test_amp_lists_overrides_match_jax(white, black):
    got = TAMP.AutoMixedPrecisionLists(white, black)
    want = JAMP.AutoMixedPrecisionLists(white, black)
    assert got.white_list == want.white_list
    assert got.black_list == want.black_list
    for op in sorted(want.white_list | want.black_list | {"relu", "tanh"}):
        assert got.should_run_fp32(op) == want.should_run_fp32(op), op


def test_amp_lists_refuse_an_op_in_both_custom_lists():
    with pytest.raises(EnforceError, match="both custom"):
        TAMP.AutoMixedPrecisionLists({"exp"}, {"exp"})
    with pytest.raises(JEnforceError, match="both custom"):
        JAMP.AutoMixedPrecisionLists({"exp"}, {"exp"})


# ----- the loss scaler ------------------------------------------------------

def _grad_script(seed):
    """Finite and non-finite grad trees, in a fixed order."""
    rng = np.random.default_rng(seed)
    out = []
    for bad in (0, 0, 0, np.inf, np.nan, 0, -np.inf, np.inf, 0, 0, 0, 0,
                0, np.nan, np.nan, np.nan, 0, 0):
        w = (rng.normal(size=(4, 3)) * 1e3).astype(np.float32)
        b = rng.normal(size=(3,)).astype(np.float32)
        if bad:
            w[1, 2] = bad
        out.append({"w": w, "b": b})
    return out


@pytest.mark.parametrize("kw", [
    dict(init_scale=2.0 ** 22, incr_every_n_steps=2,
         decr_every_n_nan_or_inf=1),              # grows into the 2^24 cap
    dict(init_scale=4.0, incr_every_n_steps=3,
         decr_every_n_nan_or_inf=1),              # shrinks onto the floor 1
    dict(init_scale=2.0 ** 15, incr_every_n_steps=4,
         decr_every_n_nan_or_inf=2, incr_ratio=3.0, decr_ratio=0.25),
])
def test_dynamic_loss_scaler_state_sequence_matches_jax(kw):
    ts, js = DynamicLossScaler(**kw), JScaler(**kw)
    st, sj = ts.init(), js.init()
    assert st["good_steps"].dtype == torch.int32 and st["scale"].dtype == \
        torch.float32 and st["scale"].dim() == 0
    scales = []
    for grads in _grad_script(1):
        ut, st, fin_t = ts.unscale_and_update(
            {k: torch.from_numpy(v) for k, v in grads.items()}, st)
        uj, sj, fin_j = js.unscale_and_update(
            {k: jnp.asarray(v) for k, v in grads.items()}, sj)
        assert bool(fin_t) == bool(fin_j)
        for key in ("scale", "good_steps", "bad_steps"):
            assert st[key].item() == np.asarray(sj[key]).item(), key
            assert st[key].dtype == (torch.float32 if key == "scale"
                                     else torch.int32)
        for k in grads:
            np.testing.assert_array_equal(_np(ut[k]), _np(uj[k]))
        scales.append(st["scale"].item())
        loss = torch.tensor(1.5)
        assert ts.scale_loss(loss, st).item() == float(
            js.scale_loss(jnp.asarray(1.5), sj))
    assert len(set(scales)) > 2, scales           # the scale really moved


# ----- the optimizer wrapper ------------------------------------------------

def _sgd_pair(scale=8.0, **kw):
    t = TAMP.decorate(TO.SGD(0.1), init_loss_scaling=scale, **kw)
    j = JAMP.decorate(JO.SGD(0.1), init_loss_scaling=scale, **kw)
    return t, j


def test_scaled_round_trip_equals_plain_sgd():
    topt, jopt = _sgd_pair(decr_every_n_nan_or_inf=1)
    g = np.array([1.0, 2.0, 3.0], np.float32)
    pt_ = {"w": torch.ones(3)}
    st = topt.init(pt_)
    pj = {"w": jnp.ones(3)}
    sj = jopt.init(pj)
    topt.apply(pt_, {"w": torch.from_numpy(g) * topt.current_scale(st)}, st)
    pj, sj = jopt.apply(pj, {"w": jnp.asarray(g) * jopt.current_scale(sj)},
                        sj)
    _close(pt_["w"], 1.0 - 0.1 * g, 1e-6)
    _close(pt_["w"], pj["w"], 1e-6)
    assert topt.current_scale(st).item() == 8.0
    assert float(topt.current_lr(st)) == pytest.approx(0.1)
    assert topt.scale_loss(torch.tensor(2.0), st).item() == 16.0


def test_nonfinite_step_leaves_params_and_inner_state_unchanged():
    topt = TAMP.decorate(TO.Adam(1e-2), init_loss_scaling=8.0,
                         decr_every_n_nan_or_inf=1)
    rng = np.random.default_rng(3)
    params = {"w": torch.from_numpy(rng.normal(size=(4, 3)).astype(
        np.float32)), "b": torch.zeros(3)}
    st = topt.init(params)
    topt.apply(params, {"w": torch.ones(4, 3) * 8.0,
                        "b": torch.ones(3) * 8.0}, st)     # one real step
    before = {k: v.clone() for k, v in params.items()}
    inner = [{k: v.clone() for k, v in leaf.items()}
             for leaf in st["inner"]["leaf"]]
    step = st["inner"]["step"]
    bad = {"w": torch.ones(4, 3), "b": torch.tensor([1.0, np.inf, 0.0])}
    topt.apply(params, bad, st)
    for k in params:
        assert torch.equal(params[k], before[k]), k
    for leaf, old in zip(st["inner"]["leaf"], inner):
        for k in leaf:
            assert torch.equal(leaf[k], old[k]), k
    assert st["inner"]["step"] == step == 1
    assert topt.current_scale(st).item() == 4.0               # halved
    assert st["scaler"]["bad_steps"].item() == 0


def test_optimizer_sequence_with_skips_matches_jax():
    """decorate's default decr_every_n_nan_or_inf (2): params and scale
    state step by step against JAX over finite and non-finite grads."""
    topt, jopt = _sgd_pair(scale=2.0 ** 10)
    rng = np.random.default_rng(4)
    w0 = rng.normal(size=(4, 3)).astype(np.float32)
    pt_, pj = {"w": torch.from_numpy(w0.copy())}, {"w": jnp.asarray(w0)}
    st, sj = topt.init(pt_), jopt.init(pj)
    for grads in _grad_script(5):
        g = grads["w"]
        topt.apply(pt_, {"w": torch.from_numpy(g)}, st)
        pj, sj = jopt.apply(pj, {"w": jnp.asarray(g)}, sj)
        _close(pt_["w"], pj["w"], 1e-6)
        for key in ("scale", "good_steps", "bad_steps"):
            assert st["scaler"][key].item() == np.asarray(
                sj["scaler"][key]).item(), key
        assert st["inner"]["step"] == int(sj["inner"]["step"])


def test_static_scaling_keeps_the_scale():
    topt, jopt = _sgd_pair(scale=16.0, use_dynamic_loss_scaling=False)
    pt_, pj = {"w": torch.ones(2)}, {"w": jnp.ones(2)}
    st, sj = topt.init(pt_), jopt.init(pj)
    for g in (16.0, np.inf, 16.0, np.nan):
        topt.apply(pt_, {"w": torch.full((2,), g)}, st)
        pj, sj = jopt.apply(pj, {"w": jnp.full((2,), g)}, sj)
        assert topt.current_scale(st).item() == 16.0
        _close(pt_["w"], pj["w"], 1e-6)
    assert st["inner"]["step"] == 2                  # the two inf/nan skipped


@pytest.mark.parametrize("policy", [None, "mixed_bf16", "bfloat16"])
def test_decorate_sets_the_policy(policy):
    kw = {} if policy is None else {"policy": policy}
    opt = TAMP.decorate(TO.Adam(1e-3), init_loss_scaling=64.0, **kw)
    JAMP.decorate(JO.Adam(1e-3), init_loss_scaling=64.0, **kw)
    assert isinstance(opt, TAMP.MixedPrecisionOptimizer)
    assert TD.get_policy() == TD.POLICIES[policy or "mixed_fp16"]
    assert TD.get_policy().compute_dtype == JD.get_policy().compute_dtype
    assert opt.scaler.init_scale == 64.0
    assert opt.scaler.decr_every_n_nan_or_inf == 2
    assert DynamicLossScaler().decr_every_n_nan_or_inf == 1


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_cast_params_casts_floating_leaves(dtype):
    rng = np.random.default_rng(6)
    w = rng.normal(size=(5, 4)).astype(np.float32)
    n = np.arange(4, dtype=np.int32)
    params = {"w": torch.nn.Parameter(torch.from_numpy(w)),
              "n": torch.from_numpy(n)}
    got = TAMP.cast_params(params, getattr(torch, dtype))
    want = JAMP.cast_params({"w": jnp.asarray(w), "n": jnp.asarray(n)},
                            getattr(jnp, dtype))
    assert got is not params and got["n"] is params["n"]
    assert got["w"].dtype == getattr(torch, dtype)
    assert not got["w"].requires_grad
    np.testing.assert_array_equal(_np(got["w"]), _np(want["w"]))
    assert TAMP.cast_params(params)["w"].dtype == torch.bfloat16


# ----- the Linear under each policy -----------------------------------------

@pytest.mark.parametrize("policy", sorted(TD.POLICIES))
def test_linear_under_each_policy_matches_jax(policy):
    pt.seed(7)
    jl = pt.nn.Linear(48, 40, act="relu")
    tl = tnn.Linear(48, 40, act="relu", device="cpu")
    rng = np.random.default_rng(8)
    jl.set_parameters({"bias": rng.normal(size=(40,)).astype(np.float32)})
    load_numpy_state(tl, {k: np.asarray(v)
                          for k, v in jl.named_parameters().items()})
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    ct = rng.normal(size=(2, 5, 40)).astype(np.float32)

    def jloss(p, xx):
        out, _ = jl.functional_call(p, xx)
        return (out.astype(jnp.float32) * ct).sum(), out

    with JD.policy_scope(policy):
        (_, want), (want_g, want_gx) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jl.named_parameters(),
                                                 jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    with TD.policy_scope(policy):
        got = tl(xt)
    (got.float() * torch.from_numpy(ct)).sum().backward()  # outside scope
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _close(got, want, TOL[policy])
    # the grads are the float32 masters', whatever the compute dtype
    for name, p in tl.named_parameters():
        assert p.grad.dtype == torch.float32
        ref = np.abs(_np(want_g[name])).max()
        _close(p.grad, want_g[name], TOL[policy] * max(ref, 1.0))
    assert xt.grad.dtype == torch.float32
    _close(xt.grad, want_gx, TOL[policy] * max(np.abs(_np(want_gx)).max(),
                                               1.0))
    assert tl.weight.dtype == torch.float32 and TD.get_policy() == \
        TD.POLICIES["float32"]


def test_float16_outputs_reach_the_flash_wrappers_typed_error(monkeypatch):
    """A custom policy with float16 outputs sends float16 q/k/v to the
    flash kernels, which take float32 and bfloat16 only (as the JAX
    kernels do): a typed error, not a silent fallback."""
    monkeypatch.setattr(TA, "_flash_ok", lambda q, k: TA.flash_shape_ok(
        q.shape[1], k.shape[1], q.shape[-1]))
    model = TG.GPTForCausalLM(TG.GPTConfig(
        vocab_size=64, hidden_size=128, num_layers=1, num_heads=2,
        num_kv_heads=1, intermediate_size=128, max_position=64),
        device="cpu")
    ids = torch.from_numpy(np.random.default_rng(9).integers(
        0, 64, (1, 64)))
    with TD.policy_scope(TD.Policy("float32", "float16", "float16")):
        with pytest.raises(InvalidArgumentError,
                           match="float32 or bfloat16, got torch.float16"):
            model.forward_loss(ids)
    with TD.policy_scope("mixed_fp16"):          # float32 outputs: fine
        assert torch.isfinite(model.forward_loss(ids))


# ----- Trainer(amp=) on the MnistMLP (tests/test_amp.py's trainings) ---------

def _mnist_pair():
    pt.seed(0)
    jm = JM.MnistMLP(hidden1=32, hidden2=16)
    tm = MnistMLP(32, 16, device="cpu")
    load_numpy_state(tm, {k: np.asarray(v)
                          for k, v in jm.named_parameters().items()})
    rng = np.random.default_rng(31)
    x = rng.normal(size=(16, 784)).astype(np.float32)
    label = rng.integers(0, 10, 16)
    return jm, tm, x, label


def _torch_ce(logits, label):
    return F.cross_entropy(logits.float(), label)


@pytest.mark.parametrize("policy", ["mixed_bf16", "bfloat16"])
def test_mnist_trainer_bf16_policies_match_jax(policy):
    jm, tm, x, label = _mnist_pair()
    jt = JP.Trainer.supervised(jm, JO.Adam(1e-3), JM.loss_fn, amp=policy)
    tt = Trainer.supervised(tm, TO.Adam(1e-3), _torch_ce, amp=policy)
    losses = []
    for _ in range(5):
        jl, _ = jt.train_step({"x": jnp.asarray(x),
                               "label": jnp.asarray(label)})
        tl, _ = tt.train_step({"x": torch.from_numpy(x),
                               "label": torch.from_numpy(label)})
        _close(tl, jl, TOL[policy])
        losses.append(float(tl))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert TD.get_policy() == TD.POLICIES["float32"]   # the scope closed
    el, _ = tt.eval_step({"x": torch.from_numpy(x),
                          "label": torch.from_numpy(label)})
    assert el.dtype == torch.float32 and torch.isfinite(el)


def test_mnist_trainer_decorated_fp16_matches_jax():
    jm, tm, x, label = _mnist_pair()
    jt = JP.Trainer.supervised(
        jm, JAMP.decorate(JO.Adam(1e-3), init_loss_scaling=128.0),
        JM.loss_fn, amp="mixed_fp16")
    tt = Trainer.supervised(
        tm, TAMP.decorate(TO.Adam(1e-3), init_loss_scaling=128.0),
        _torch_ce, amp="mixed_fp16")
    losses = []
    for _ in range(5):
        jl, _ = jt.train_step({"x": jnp.asarray(x),
                               "label": jnp.asarray(label)})
        tl, _ = tt.train_step({"x": torch.from_numpy(x),
                               "label": torch.from_numpy(label)})
        _close(tl, jl, TOL["mixed_fp16"])
        losses.append(float(tl))
    # the reported loss is the unscaled one
    assert losses[0] < 10.0 and losses[-1] < losses[0], losses
    for key in ("scale", "good_steps", "bad_steps"):
        assert tt.opt_state["scaler"][key].item() == np.asarray(
            jt.opt_state["scaler"][key]).item(), key
    assert tt.opt_state["inner"]["step"] == 5
