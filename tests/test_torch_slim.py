"""Slim compression of the port (``paddle_tpu_torch/slim``) against the
JAX package's ``paddle_tpu/slim`` on the same numpy-seeded inputs, on the
CPU.

Tolerances and why:
- masks, kept indices, shrunk tensors, the bisected uniform ratio and
  the greedy per-param ratios: exact. The rules compare magnitudes (or
  channel L1 norms) against the k-th largest, so equal inputs give
  equal masks; the structured cases assert that their channel norms sit
  further apart than float32 reduction noise, so that "equal" tests the
  rule (ties at the threshold all kept, half-to-even k) and not the
  summation order. Planted ties are exact copies, equal in both.
- sensitivities: 1e-6 (a metric of float32 forwards).
- the Compressor on ``tests/test_slim.py``'s toy data: params 1e-5, and
  the eval history, epoch, masks and prune ratios equal.
- distillation of a ``GPTConfig.tiny()`` teacher into a one-layer
  student, weights from the JAX package: the distilled loss of each step
  within 1e-5 of its size (at T = 4 the loss is ~72, where float32's
  spacing is 7.6e-6: a fixed 1e-5 would ask for one ulp of a sum the
  two packages reduce in other orders), params 1e-4 of each one's
  largest entry after two SGD(1.0) steps that move every attention
  weight by more than 1e-2 of its largest entry; the teacher bitwise
  unchanged. Not Adam: its first steps move an entry by about lr times
  the sign of its gradient, so an entry whose gradient is float32 noise
  (the gradients agree to 2e-6 of their largest entry) moves by up to
  lr in either package; at Adam(1e-2) and Adam(1e-3) one entry of 32768
  sat just past the limit. The Compressor's Adam runs are held across
  the packages on the toy data (the Context test).
- the distillation losses within 1e-6 of their size (T^2-scaled values
  of 1-20) and their gradients within 1e-6.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import optimizer as JO
from paddle_tpu import slim as JS
from paddle_tpu.models import gpt as JG
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch import slim as TS
from paddle_tpu_torch.core import EnforceError
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.utils.convert import load_numpy_state


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _eq(got, want):
    np.testing.assert_array_equal(_np(got), _np(want))


def _same_dicts(got, want):
    """Same keys in the same order, values exactly equal."""
    assert list(got) == list(want)
    for k in want:
        _eq(got[k], want[k])


def _separated(norms, axis_len):
    """The channel norms lie further apart than float32 reduction noise."""
    s = np.sort(np.asarray(norms, np.float64))
    assert len(s) == axis_len
    assert np.min(np.diff(s)) > 1e-4 * s[-1]


def _channels(shape, axis, seed):
    """A weight whose channels along ``axis`` have well-separated L1
    norms (each channel scaled by a distinct factor)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32)
    scale = np.ones(len(shape), int)
    scale[axis] = shape[axis]
    factors = (1.0 + 0.37 * rng.permutation(shape[axis])).astype(np.float32)
    return w * factors.reshape(scale)


def _norms(w, axis):
    return np.abs(w.astype(np.float64)).sum(
        axis=tuple(i for i in range(w.ndim) if i != axis))


# ---------------------------------------------------------------------------
# masks, search and shrink: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ratio", [0.0, 0.25, 0.5, 0.75, 0.9, 0.975])
def test_magnitude_mask_exact(ratio):
    w = np.random.default_rng(1).normal(size=(20, 10)).astype(np.float32)
    got = TS.magnitude_mask(torch.from_numpy(w), ratio)
    assert got.dtype == torch.float32
    _eq(got, JS.magnitude_mask(jnp.asarray(w), ratio))


@pytest.mark.parametrize("ratio", [0.3, 0.5, 0.55, 0.7])
def test_magnitude_mask_keeps_every_tie_at_the_threshold(ratio):
    """Magnitudes from a set of five values: the threshold falls inside
    a run of ties, all of which are kept (more than k entries)."""
    rng = np.random.default_rng(2)
    w = (rng.integers(1, 6, size=(8, 9)) * rng.choice([-1, 1], (8, 9))
         ).astype(np.float32)
    got = TS.magnitude_mask(torch.from_numpy(w), ratio)
    _eq(got, JS.magnitude_mask(jnp.asarray(w), ratio))
    k = max(int(round(w.size * (1 - ratio))), 1)
    assert float(got.sum()) >= k


@pytest.mark.parametrize("ratio", [-0.1, 1.0])
def test_magnitude_mask_rejects_the_ratio_as_jax(ratio):
    with pytest.raises(Exception, match=r"prune ratio must be in \[0,1\)"):
        JS.magnitude_mask(jnp.ones((4,)), ratio)
    with pytest.raises(EnforceError,
                       match=r"prune ratio must be in \[0,1\), got "
                       + str(ratio)):
        TS.magnitude_mask(torch.ones(4), ratio)


@pytest.mark.parametrize("shape,axis", [((12, 16), 0), ((12, 16), 1),
                                        ((8, 4, 3, 3), 0),
                                        ((8, 6, 3, 3), 1)])
@pytest.mark.parametrize("ratio", [0.25, 0.5, 0.8])
def test_structured_channel_mask_exact(shape, axis, ratio):
    w = _channels(shape, axis, seed=3)
    _separated(_norms(w, axis), shape[axis])
    got = TS.structured_channel_mask(torch.from_numpy(w), ratio, axis)
    want = JS.structured_channel_mask(jnp.asarray(w), ratio, axis)
    _eq(got, want)
    _eq(TS.channel_keep_indices(got, axis),
        JS.channel_keep_indices(want, axis))


def test_structured_channel_mask_keeps_tied_channels():
    """Two channels that are exact copies tie at the threshold: both are
    kept (k = 6 of 12 columns, 7 survive)."""
    w = _channels((10, 12), 1, seed=4)
    order = np.argsort(_norms(w, 1))
    w[:, order[6]] = w[:, order[5]]        # the 6th largest = the 7th
    got = TS.structured_channel_mask(torch.from_numpy(w), 0.5, 1)
    _eq(got, JS.structured_channel_mask(jnp.asarray(w), 0.5, 1))
    assert int(got[0].sum()) == 7


def _named(seed):
    """A params dict with the JAX layout's names: an embedding, a 1-D
    norm scale, Linear weights (in, out) and a bias."""
    rng = np.random.default_rng(seed)
    out = {"embed.weight": rng.normal(size=(40, 16)),
           "blocks.0.norm1.weight": 1 + 0.1 * rng.normal(size=(16,)),
           "blocks.0.ffn.gate.weight": _channels((16, 24), 1, seed + 1),
           "blocks.0.ffn.gate.bias": rng.normal(size=(24,)),
           "blocks.0.ffn.down.weight": _channels((24, 16), 1, seed + 2),
           "head.weight": _channels((16, 10), 1, seed + 3)}
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _both(named):
    return ({k: torch.from_numpy(v.copy()) for k, v in named.items()},
            {k: jnp.asarray(v) for k, v in named.items()})


@pytest.mark.parametrize("structured", [False, True])
@pytest.mark.parametrize("ratios,match", [
    (0.5, None),
    ({"blocks.0.ffn.gate.weight": 0.25, "head.weight": 0.6,
      "blocks.0.norm1.weight": 0.5, "embed.weight": 0.0}, None),
    (0.4, lambda n: ".ffn." in n)], ids=["global", "dict", "custom-match"])
def test_pruner_masks_exact(structured, ratios, match):
    tp, jp = _both(_named(5))
    for name in ("blocks.0.ffn.gate.weight", "blocks.0.ffn.down.weight",
                 "head.weight"):
        _separated(_norms(_np(jp[name]), 1), jp[name].shape[1])
    tpr = TS.Pruner(ratios, structured=structured, axis=1, match=match)
    jpr = JS.Pruner(ratios, structured=structured, axis=1, match=match)
    tm, jm = tpr.make_masks(tp), jpr.make_masks(jp)
    _same_dicts(tm, jm)
    if match is None:
        # the default match takes the embedding and the 1-D scale too
        assert ("blocks.0.norm1.weight" in tm) == (ratios != 0.0)
        assert "blocks.0.ffn.gate.bias" not in tm
    _same_dicts(TS.Pruner.apply(tp, tm), JS.Pruner.apply(jp, jm))
    assert TS.Pruner.sparsity(tp, tm) == JS.Pruner.sparsity(jp, jm)


@pytest.mark.parametrize("structured", [False, True])
@pytest.mark.parametrize("target", [0.3, 0.5, 0.7])
def test_uniform_ratio_search_returns_the_same_float(structured, target):
    tp, jp = _both(_named(6))
    match = (lambda n: n.endswith("weight") and "norm" not in n)
    got = TS.uniform_ratio_search(
        tp, TS.Pruner(target, structured=structured, axis=1, match=match),
        target)
    want = JS.uniform_ratio_search(
        jp, JS.Pruner(target, structured=structured, axis=1, match=match),
        target)
    assert got == want


def _sens():
    """Sensitivities with equal trades, so dict order decides ties."""
    return {"b": {0.2: 0.01, 0.4: 0.02, 0.6: 0.2},
            "a": {0.2: 0.01, 0.4: 0.05, 0.6: 0.1},
            "c": {0.2: 0.0, 0.4: 0.3, 0.6: 0.31}}


@pytest.mark.parametrize("cap", [None, 0.06])
@pytest.mark.parametrize("target", [0.2, 0.35, 0.5])
def test_greedy_ratios_for_target_exact(cap, target):
    shapes = {"a": (10, 10), "b": (5, 20), "c": (4, 25)}
    tp = {k: torch.zeros(s) for k, s in shapes.items()}
    jp = {k: jnp.zeros(s) for k, s in shapes.items()}
    for sens in (_sens(), dict(reversed(list(_sens().items())))):
        got = TS.greedy_ratios_for_target(sens, tp, target, cap)
        want = JS.greedy_ratios_for_target(sens, jp, target, cap)
        assert list(got.items()) == list(want.items())
    with pytest.raises(EnforceError, match="absent from the model"):
        TS.greedy_ratios_for_target({"zz": {0.1: 0.0}}, tp, 0.5)


def _mlp():
    rng = np.random.default_rng(7)
    named = {"fc1.weight": _channels((6, 10), 1, 8),
             "fc1.bias": rng.normal(size=(10,)).astype(np.float32),
             "fc2.weight": rng.normal(size=(10, 3)).astype(np.float32)}
    return named, [("fc1.weight", 1, [("fc1.bias", 0), ("fc2.weight", 0)])]


@pytest.mark.parametrize("ratio", [0.4, {"fc1.weight": 0.7}])
def test_shrink_params_exact(ratio):
    named, plan = _mlp()
    tp, jp = _both(named)
    tsmall, tkept = TS.shrink_params(tp, plan, ratio)
    jsmall, jkept = JS.shrink_params(jp, plan, ratio)
    _same_dicts(tkept, jkept)
    _same_dicts(tsmall, jsmall)
    assert tsmall["fc1.weight"].shape[1] < 10
    assert torch.equal(tp["fc1.weight"], torch.from_numpy(named["fc1.weight"]))


def test_shrink_params_raises_with_jax_messages():
    named, plan = _mlp()
    tp, _ = _both(named)
    with pytest.raises(EnforceError, match="unknown param b in shrink plan"):
        TS.shrink_params(tp, [("b", 1, [])], 0.5)
    with pytest.raises(EnforceError,
                       match="unknown follower nope in shrink plan"):
        TS.shrink_params(tp, [("fc1.weight", 1, [("nope", 0)])], 0.5)
    with pytest.raises(EnforceError, match="shrink needs a ratio"):
        TS.shrink_params(tp, plan, {"other": 0.5})


# ---------------------------------------------------------------------------
# sensitivities
# ---------------------------------------------------------------------------


def _linear_eval(named, framework):
    """-MSE of the two-layer MLP against a fixed target: a smooth metric
    every pruning step moves."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    y = rng.normal(size=(32, 3)).astype(np.float32)

    def ev(p):
        w1, b1, w2 = (_np(p[k]) for k in ("fc1.weight", "fc1.bias",
                                           "fc2.weight"))
        out = np.maximum(x @ w1 + b1, 0) @ w2
        return -float(np.mean((out - y) ** 2))

    calls = []

    def counted(p):
        calls.append(framework)
        return ev(p)

    return counted, calls


@pytest.mark.parametrize("structured", [False, True])
def test_compute_sensitivities_and_files_cross(structured, tmp_path):
    named, _ = _mlp()
    tp, jp = _both(named)
    ratios = (0.2, 0.5, 0.7)
    tev, tcalls = _linear_eval(named, "port")
    jev, jcalls = _linear_eval(named, "jax")
    tfile, jfile = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    got = TS.compute_sensitivities(tp, tev, TS.Pruner(0.5,
                                   structured=structured, axis=1), ratios,
                                   tfile)
    want = JS.compute_sensitivities(jp, jev, JS.Pruner(0.5,
                                    structured=structured, axis=1), ratios,
                                    jfile)
    assert list(got) == list(want) == ["fc1.weight", "fc2.weight"]
    for n in want:
        assert list(got[n]) == list(want[n])
        np.testing.assert_allclose(list(got[n].values()),
                                   list(want[n].values()), atol=1e-6)
    # each package resumes from the other's file: eval_fn once, for the
    # base, and the file's entries in the file's order
    for mod, params, path, other in ((TS, tp, jfile, want),
                                     (JS, jp, tfile, got)):
        ev, calls = _linear_eval(named, "resume")
        back = mod.compute_sensitivities(params, ev, mod.Pruner(0.5),
                                         ratios, path)
        assert calls == ["resume"]
        assert list(back) == sorted(other)
        for n in other:
            np.testing.assert_allclose(
                [back[n][r] for r in ratios],
                [json.load(open(path))[n][str(r)] for r in ratios])


# ---------------------------------------------------------------------------
# the Compressor on tests/test_slim.py's toy data
# ---------------------------------------------------------------------------


def _toy(seed=0, n=64, d=8, classes=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w_true = rng.normal(size=(d, classes)).astype(np.float32)
    y = np.argmax(x @ w_true, axis=1)
    w0 = rng.normal(scale=0.3, size=(d, classes)).astype(np.float32)

    def eval_fn(p):
        logits = x @ _np(p["fc.weight"]) + _np(p["fc.bias"])
        return float((np.argmax(logits, 1) == y).mean())

    def jloss(p, xb, yb, logits_only=False):
        logits = xb @ p["fc.weight"] + p["fc.bias"]
        if logits_only:
            return logits
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, yb[:, None], axis=1))

    def tloss(p, xb, yb, logits_only=False):
        logits = xb @ p["fc.weight"] + p["fc.bias"]
        if logits_only:
            return logits
        logp = torch.log_softmax(logits, -1)
        return -torch.mean(torch.gather(logp, 1, yb[:, None]))

    def jreader():
        for i in range(0, n, 16):
            yield jnp.asarray(x[i:i + 16]), jnp.asarray(y[i:i + 16])

    def treader():
        for i in range(0, n, 16):
            yield (torch.from_numpy(x[i:i + 16]),
                   torch.from_numpy(y[i:i + 16]))

    jparams = {"fc.weight": jnp.asarray(w0),
               "fc.bias": jnp.zeros((classes,))}
    tparams = {"fc.weight": torch.from_numpy(w0.copy()),
               "fc.bias": torch.zeros(classes)}
    return (tparams, tloss, treader), (jparams, jloss, jreader), eval_fn


def _compressors(opt, strategies=lambda S: [], **kw):
    """(port Compressor, JAX Compressor) on the toy data; ``opt(O)`` and
    ``strategies(S)`` build each package's optimizer and strategies."""
    (tp, tl, tr), (jp, jl, jr), ev = _toy()
    return (TS.Compressor(tp, opt(TO), tl, tr, eval_fn=ev,
                          strategies=strategies(TS), **kw),
            JS.Compressor(jp, opt(JO), jl, jr, eval_fn=ev,
                          strategies=strategies(JS), **kw))


def _same_run(tctx, jctx, atol=1e-5):
    assert list(tctx.params) == list(jctx.params)
    for k in jctx.params:
        np.testing.assert_allclose(_np(tctx.params[k]),
                                   _np(jctx.params[k]), atol=atol, rtol=0,
                                   err_msg=k)
    assert tctx.eval_history == jctx.eval_history
    assert tctx.epoch_id == jctx.epoch_id
    _same_dicts(tctx.masks, jctx.masks)
    assert tctx.extra.get("prune_ratios") == jctx.extra.get("prune_ratios")


def test_compressor_epochs_match_jax():
    tc, jc = _compressors(lambda O: O.SGD(0.5), epochs=4)
    _same_run(tc.run(), jc.run())
    assert len(tc.context.eval_history) == 4


def test_compressor_leaves_the_callers_tensors_alone():
    (tp, tl, tr), _, ev = _toy()
    before = {k: v.clone() for k, v in tp.items()}
    for v in tp.values():
        v.requires_grad_(True)
    ctx = TS.Compressor(tp, TO.Adam(0.05), tl, tr, eval_fn=ev,
                        epochs=2).run()
    for k, v in tp.items():
        assert torch.equal(v.detach(), before[k]) and v.grad is None
        assert not torch.equal(ctx.params[k], before[k])


@pytest.mark.parametrize("structured", [False, True])
def test_uniform_prune_strategy_matches_jax(structured):
    tc, jc = _compressors(
        lambda O: O.SGD(0.3), epochs=3,
        strategies=lambda S: [S.UniformPruneStrategy(
            target_ratio=0.5, structured=structured, axis=1,
            start_epoch=1)])
    tctx, jctx = tc.run(), jc.run()
    _same_run(tctx, jctx)
    w, m = _np(tctx.params["fc.weight"]), _np(tctx.masks["fc.weight"])
    assert np.all(w[m == 0] == 0)
    assert abs(TS.Pruner.sparsity(tctx.params, tctx.masks) - 0.5) < 0.06


def test_sensitive_prune_strategy_matches_jax(tmp_path):
    files = iter([str(tmp_path / "t.json"), str(tmp_path / "j.json")])
    tc, jc = _compressors(
        lambda O: O.SGD(0.3), epochs=2,
        strategies=lambda S: [S.SensitivePruneStrategy(
            target_ratio=0.4, ratios=(0.2, 0.4, 0.6),
            sensitivities_file=next(files), start_epoch=0)])
    tctx, jctx = tc.run(), jc.run()
    assert tctx.extra["prune_ratios"]
    _same_run(tctx, jctx)
    assert json.load(open(tmp_path / "t.json")).keys() == \
        json.load(open(tmp_path / "j.json")).keys()


def _teachers():
    tc, jc = _compressors(lambda O: O.SGD(0.5), epochs=6)
    return tc.run().params, jc.run().params


def test_distillation_strategy_matches_jax():
    tteach, jteach = _teachers()
    tkeep = {k: v.clone() for k, v in tteach.items()}

    def strategies(S):
        teacher = tteach if S is TS else jteach
        return [S.DistillationStrategy(
            lambda tp, xb, yb: xb @ tp["fc.weight"] + tp["fc.bias"],
            teacher, distiller=S.Distiller(temperature=2.0, soft_weight=1.0,
                                           hard_weight=0.0))]

    tc, jc = _compressors(lambda O: O.SGD(0.5), epochs=4,
                          strategies=strategies)
    tctx, jctx = tc.run(), jc.run()
    _same_run(tctx, jctx)
    _same_dicts(tteach, tkeep)


def test_distillation_wrapper_is_stable_across_epochs():
    seen = []

    class Spy(TS.Strategy):
        def on_epoch_begin(self, ctx):
            seen.append(id(ctx.loss_wrapper))

    (tp, tl, tr), _, ev = _toy()
    strat = TS.DistillationStrategy(
        lambda p, xb, yb: xb @ p["fc.weight"] + p["fc.bias"], dict(tp))
    c = TS.Compressor(tp, TO.SGD(0.1), tl, tr, eval_fn=ev, epochs=3,
                      strategies=[strat, Spy()])
    c.run()
    assert len(seen) == 3 and len(set(seen)) == 1


def test_checkpoint_resume_matches_jax(tmp_path):
    runs = []
    for name in ("t", "j"):
        d = str(tmp_path / name)
        first = _compressors(lambda O: O.SGD(0.5), epochs=2,
                             checkpoint_dir=d)[name == "j"].run()
        runs.append((first, _compressors(lambda O: O.SGD(0.5), epochs=4,
                                         checkpoint_dir=d)[name == "j"]
                     .run()))
    (t1, t2), (j1, j2) = runs
    _same_run(t1, j1)
    _same_run(t2, j2)
    assert t2.epoch_id == 4 and t2.eval_history[:2] == t1.eval_history


def test_convergence_stops_early_as_jax():
    tc, jc = _compressors(lambda O: O.SGD(0.0), epochs=50,
                          converge_delta=0.01)
    tctx, jctx = tc.run(), jc.run()
    _same_run(tctx, jctx)
    assert tctx.epoch_id == 5


def test_config_factory_matches_jax(tmp_path):
    cfg = {"strategies": [
        {"kind": "uniform_prune", "target_ratio": 0.3, "start_epoch": 1,
         "end_epoch": 3},
        {"kind": "sensitive_prune", "target_ratio": 0.2,
         "ratios": [0.1, 0.2]}]}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    for config in (cfg, str(path)):
        got = TS.build_strategies(config)
        want = JS.build_strategies(config)
        assert [type(s).__name__ for s in got] == \
            [type(s).__name__ for s in want]
        assert [(s.start_epoch, s.end_epoch, s.target_ratio) for s in got] \
            == [(s.start_epoch, s.end_epoch, s.target_ratio) for s in want]
    with pytest.raises(EnforceError, match="unknown strategy kind 'nope'"):
        TS.build_strategies({"strategies": [{"kind": "nope"}]})
    with pytest.raises(EnforceError, match="'strategies' list"):
        TS.build_strategies({"prune": {"ratios": 0.5}})
    # the factory's strategies drive the port's Compressor as the JAX one
    tc, jc = _compressors(lambda O: O.SGD(0.5), epochs=2,
                          strategies=lambda S: S.build_strategies(
                              {"strategies": [{"kind": "uniform_prune",
                                               "target_ratio": 0.3,
                                               "start_epoch": 1}]}))
    _same_run(tc.run(), jc.run())


@pytest.mark.parametrize("prune", [False, True], ids=["no-masks", "masks"])
def test_context_crosses_between_the_packages(prune, tmp_path):
    """A Context saved by either package after epoch 1 resumes in the
    other's Compressor; both end at the uninterrupted run's params
    (Adam: the moments and the step count cross too). Without pruning
    the mask set is empty and round-trips as {}."""

    def strategies(S):
        return ([S.UniformPruneStrategy(target_ratio=0.5, start_epoch=0)]
                if prune else [])

    def make(i, epochs, d=None):
        return _compressors(lambda O: O.Adam(0.05), epochs=epochs,
                            strategies=strategies, checkpoint_dir=d)[i]

    whole = make(1, 3).run()
    for first, second in ((1, 0), (0, 1)):
        d = str(tmp_path / f"ctx{first}")
        make(first, 1, d).run()
        resumed = make(second, 3, d)
        ctx = resumed.run()
        assert ctx.epoch_id == 3
        assert (len(ctx.masks) > 0) == prune
        for k in whole.params:
            np.testing.assert_allclose(_np(ctx.params[k]),
                                       _np(whole.params[k]), atol=1e-5,
                                       rtol=0)
        assert ctx.eval_history == whole.eval_history
        _same_dicts({k: _np(v) for k, v in ctx.masks.items()},
                    {k: _np(v) for k, v in whole.masks.items()})


# ---------------------------------------------------------------------------
# distillation of a GPT, weights from the JAX package
# ---------------------------------------------------------------------------


def _gpt_pair(cfg):
    jm = JG.GPTForCausalLM(cfg)
    tm = TG.GPTForCausalLM(cfg, device="cpu")
    load_numpy_state(tm, {k: np.asarray(v)
                          for k, v in jm.named_parameters().items()})
    return tm, jm


def test_distilling_a_gpt_matches_jax():
    pt.seed(0)
    ptt.seed(0)
    cfg_t = JG.GPTConfig.tiny()
    cfg_s = JG.GPTConfig.tiny()
    cfg_s.num_layers = 1
    tteacher, jteacher = _gpt_pair(cfg_t)
    tstudent, jstudent = _gpt_pair(cfg_s)
    rng = np.random.default_rng(11)
    ids = [rng.integers(0, cfg_t.vocab_size, (2, 16)) for _ in range(2)]
    labels = [np.concatenate([i[:, 1:], np.full((2, 1), -100)], 1)
              for i in ids]
    losses = {"port": [], "jax": []}

    class TRec(TS.Distiller):
        def loss(self, *a, **k):
            v = super().loss(*a, **k)
            losses["port"].append(float(v.detach()))
            return v

    class JRec(JS.Distiller):
        def loss(self, *a, **k):
            v = super().loss(*a, **k)
            jax.debug.callback(lambda t: losses["jax"].append(float(t)), v)
            return v

    def loss_fn(model):
        def f(p, x, y, logits_only=False):
            if logits_only:
                return model.functional_call(p, x)[0]
            return model.functional_call(p, x, y,
                                         method="forward_loss")[0]
        return f

    def teacher_apply(model):
        return lambda p, x, y: model.functional_call(p, x)[0]

    tteach = dict(tteacher.named_parameters())
    tkeep = {k: v.detach().clone() for k, v in tteach.items()}
    tc = TS.Compressor(
        dict(tstudent.named_parameters()), TO.SGD(1.0),
        loss_fn(tstudent),
        lambda: ((torch.from_numpy(i), torch.from_numpy(l))
                 for i, l in zip(ids, labels)),
        strategies=[TS.DistillationStrategy(
            teacher_apply(tteacher), tteach, TRec())])
    jc = JS.Compressor(
        jstudent.named_parameters(), JO.SGD(1.0), loss_fn(jstudent),
        lambda: ((jnp.asarray(i, jnp.int32), jnp.asarray(l, jnp.int32))
                 for i, l in zip(ids, labels)),
        strategies=[JS.DistillationStrategy(
            teacher_apply(jteacher), jteacher.named_parameters(), JRec())])
    tctx, jctx = tc.run(), jc.run()
    jax.effects_barrier()
    assert len(losses["port"]) == len(losses["jax"]) == 2
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5,
                               atol=0)
    assert list(tctx.params) == list(jctx.params)
    for k in jctx.params:
        want = _np(jctx.params[k])
        np.testing.assert_allclose(_np(tctx.params[k]), want,
                                   atol=1e-4 * np.abs(want).max(), rtol=0,
                                   err_msg=k)
    # the two steps moved every weight matrix well beyond the tolerance
    start = dict(tstudent.named_parameters())
    moved = min(float((tctx.params[k] - start[k].detach()).abs().max()
                       / start[k].detach().abs().max())
                for k in start if k.endswith("proj.weight"))
    assert moved > 1e-2, moved
    for k, v in tteach.items():
        assert torch.equal(v.detach(), tkeep[k]) and v.grad is None
    assert len(tctx.opt_state["leaf"]) == len(tctx.params)


# ---------------------------------------------------------------------------
# the distillation losses, with their gradients
# ---------------------------------------------------------------------------


def _grads_close(tfn, jfn, arrays, atol=1e-6):
    """The value within ``atol`` of its size and the gradient by every
    input within ``atol``, port against JAX."""
    tin = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    tout = tfn(*tin)
    tout.backward()
    jout, jg = jax.jit(jax.value_and_grad(
        jfn, argnums=tuple(range(len(arrays)))))(*map(jnp.asarray, arrays))
    np.testing.assert_allclose(float(tout.detach()), float(jout), rtol=atol,
                               atol=0)
    for a, b in zip(tin, jg):
        np.testing.assert_allclose(_np(a.grad), np.asarray(b), atol=atol,
                                   rtol=0)


def _f(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("t", [1.0, 2.0, 4.0])
def test_soft_label_loss_and_grad(t):
    s, te = _f((3, 5, 11), 1, 2.0), _f((3, 5, 11), 2, 2.0)
    _grads_close(lambda a, b: TS.soft_label_loss(a, b, t),
                 lambda a, b: JS.soft_label_loss(a, b, t), [s, te])


def test_fsp_and_l2_feature_losses_and_grads():
    xs = [_f((2, 3, 4, 4), 3), _f((2, 5, 4, 4), 4), _f((2, 3, 4, 4), 5),
          _f((2, 5, 4, 4), 6)]
    _grads_close(lambda a, b, c, d: TS.fsp_loss((a, b), (c, d)),
                 lambda a, b, c, d: JS.fsp_loss((a, b), (c, d)), xs)
    _grads_close(TS.l2_feature_loss, JS.l2_feature_loss, xs[:1] + xs[2:3])


@pytest.mark.parametrize("hard", [0.0, 0.3])
def test_distiller_loss_and_grad(hard):
    """Labels with ignore-index holes: the hard term's mean counts them
    as zeros, in both."""
    s, te = _f((2, 6, 9), 7, 2.0), _f((2, 6, 9), 8, 2.0)
    fs, ft = _f((2, 8), 9), _f((2, 8), 10)
    label = np.random.default_rng(12).integers(0, 9, (2, 6))
    label[:, -1] = -100
    kw = dict(temperature=3.0, soft_weight=0.6, hard_weight=hard,
              feature_weight=0.2)
    td, jd = TS.Distiller(**kw), JS.Distiller(**kw)
    _grads_close(
        lambda a, b, c, d: td.loss(a, b, torch.from_numpy(label), [(c, d)]),
        lambda a, b, c, d: jd.loss(a, b, jnp.asarray(label), [(c, d)]),
        [s, te, fs, ft])
    defaults = TS.Distiller()
    assert (defaults.temperature, defaults.soft_weight,
            defaults.hard_weight) == (4.0, 0.7, 0.3)
