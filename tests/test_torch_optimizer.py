"""The port's optimizers, learning-rate schedules, clips and
regularizers (paddle_tpu_torch/optimizer, clip.py, regularizer.py)
against the JAX package's on the same numpy parameters and grads,
float32 on the CPU.

- SGD, Adam and AdamW (also with a clip and a regularizer) over 3 steps:
  every parameter after each step at atol 1e-6. The grads have no entry
  below 0.1 in magnitude, so Adam's normalised step m / (sqrt(v) + eps)
  stays well-conditioned and the two frameworks' last-bit differences
  stay at the float32 rounding of values of magnitude ~1.
- Every lr schedule over steps 0..19 at rtol 1e-6 (the same float32
  formulas; transcendental functions may differ in the last bit).
- The clip classes, global_norm and the regularizers at atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import clip as JC
from paddle_tpu import regularizer as JR
from paddle_tpu.optimizer import lr_scheduler as JL
from paddle_tpu.optimizer import optimizers as JO
from paddle_tpu_torch import clip as TC
from paddle_tpu_torch import regularizer as TR
from paddle_tpu_torch.optimizer import lr_scheduler as TL
from paddle_tpu_torch.optimizer import optimizers as TO

SHAPES = {"a.weight": (4, 5), "a.bias": (5,), "b.w": (3, 2, 2)}


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


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=0)


OPTIMIZERS = {
    "sgd": lambda M, C, R: M.SGD(0.1),
    "adam": lambda M, C, R: M.Adam(1e-2),
    "adamw": lambda M, C, R: M.AdamW(1e-2, weight_decay=0.1),
    "adam_clip_l2": lambda M, C, R: M.Adam(
        1e-2, grad_clip=C.GradientClipByGlobalNorm(1.0),
        regularization=R.L2Decay(0.01)),
    "sgd_value_l1": lambda M, C, R: M.SGD(
        0.1, grad_clip=C.GradientClipByValue(0.5),
        regularization=R.L1Decay(0.01)),
    "adam_schedule": lambda M, C, R: M.Adam(
        (JL if M is JO else TL).ExponentialDecay(1e-2, 2, 0.5)),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_three_steps_match_jax(name):
    jopt = OPTIMIZERS[name](JO, JC, JR)
    topt = OPTIMIZERS[name](TO, TC, TR)
    start = _params(0)
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = _grads(step + 1)
        jp, js = jopt.apply(jp, {k: jnp.asarray(v) for k, v in g.items()},
                            js)
        tp2, ts = topt.apply(tp, {k: torch.from_numpy(v)
                                  for k, v in g.items()}, ts)
        assert tp2 is tp                   # updated in place
        for k in SHAPES:
            _close(tp[k], jp[k])
    assert ts["step"] == 3
    _close(topt.current_lr(ts), jopt.current_lr(js))


SCHEDULES = {
    "constant": lambda L: L.Constant(0.3),
    "noam": lambda L: L.NoamDecay(512, 8, scale=2.0),
    "exponential": lambda L: L.ExponentialDecay(0.1, 4, 0.7),
    "exponential_stair": lambda L: L.ExponentialDecay(0.1, 4, 0.7, True),
    "natural_exp": lambda L: L.NaturalExpDecay(0.1, 3, 0.5, True),
    "inverse_time": lambda L: L.InverseTimeDecay(0.1, 5, 0.5),
    "polynomial": lambda L: L.PolynomialDecay(0.1, 10, 1e-3, power=2.0),
    "polynomial_cycle": lambda L: L.PolynomialDecay(0.1, 6, 1e-3,
                                                    cycle=True),
    "piecewise": lambda L: L.PiecewiseDecay([3, 9], [0.1, 0.05, 0.01]),
    "cosine": lambda L: L.CosineDecay(0.1, 3, 7),
    "warmup": lambda L: L.LinearWarmup(L.CosineDecay(0.1, 3, 7), 5, 0.0,
                                       0.1),
    "warmup_constant": lambda L: L.LinearWarmup(0.1, 4, 0.01, 0.1),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_values_match_jax(name):
    js, ts = SCHEDULES[name](JL), SCHEDULES[name](TL)
    want = [float(js(jnp.asarray(s, jnp.int32))) for s in range(20)]
    got = [float(ts(s)) for s in range(20)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert TL.make_schedule(0.5)(3).item() == 0.5
    assert TL.make_schedule(ts) is ts


CLIPS = {
    "value": lambda C: C.GradientClipByValue(0.7),
    "value_asym": lambda C: C.GradientClipByValue(0.7, min=-0.2),
    "norm": lambda C: C.GradientClipByNorm(1.0),
    "global_norm": lambda C: C.GradientClipByGlobalNorm(1.5),
    "global_norm_loose": lambda C: C.GradientClipByGlobalNorm(100.0),
}


@pytest.mark.parametrize("name", list(CLIPS))
def test_clips_match_jax(name):
    g = _grads(4)
    want = CLIPS[name](JC)({k: jnp.asarray(v) for k, v in g.items()})
    got = CLIPS[name](TC)({k: torch.from_numpy(v) for k, v in g.items()})
    for k in SHAPES:
        _close(got[k], want[k])
    _close(TC.global_norm(list(got.values())),
           JC.global_norm(list(want.values())))
    x = np.linspace(-2, 2, 9).astype(np.float32)
    _close(TC.ErrorClipByValue(1.0, -0.5)(torch.from_numpy(x)),
           JC.ErrorClipByValue(1.0, -0.5)(jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["L1Decay", "L2Decay"])
def test_regularizers_match_jax(kind):
    p, g = _params(5), _grads(6)
    jr, tr = getattr(JR, kind)(0.03), getattr(TR, kind)(0.03)
    want = jr.apply_to_grads({k: jnp.asarray(v) for k, v in p.items()},
                             {k: jnp.asarray(v) for k, v in g.items()})
    got = tr.apply_to_grads({k: torch.from_numpy(v) for k, v in p.items()},
                            {k: torch.from_numpy(v) for k, v in g.items()})
    for k in SHAPES:
        _close(got[k], want[k])
    _close(tr.loss_term({k: torch.from_numpy(v) for k, v in p.items()}),
           jr.loss_term({k: jnp.asarray(v) for k, v in p.items()}))
