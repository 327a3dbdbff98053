"""The sliding-window fake quantization of the port
(``paddle_tpu_torch/quant/ops.py`` ``RangeState``, ``range_state_init``,
``fake_quantize_range_abs_max``) against the JAX package's, on the same
numpy-seeded inputs.

Twelve calls at ``window_size=4`` wrap the ring buffer three times; the
inputs' scales vary so that a large abs-max leaves the window and the
scale falls. Outputs, scales and windows are held at
``tests/test_torch_quant_ops.py``'s tolerance, atol 1e-6 (the same
float32 operations in the same order), the step counts exactly; then an
``is_test`` call quantizes at the state's scale and returns the state
unchanged. The straight-through gradient of one call, with a state
carried from earlier calls, is held against ``jax.grad`` at atol 1e-6,
but at the abs-max element, which also takes the gradient through the
scale (a sum over the tensor, reduced in another order): rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.quant import ops as JQ
from paddle_tpu_torch import quant as TQP
from paddle_tpu_torch.quant import ops as TQ

ATOL = 1e-6
WINDOW = 4
# per-call input scales: call 1's abs-max dominates the window until
# call 5 overwrites its slot
SCALES = (1.0, 6.0, 0.5, 2.0, 1.5, 0.25, 3.0, 0.75, 1.0, 4.0, 0.5, 2.5)


def _inputs():
    rng = np.random.default_rng(18)
    return [(rng.normal(size=(7, 33)) * s).astype(np.float32)
            for s in SCALES]


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


def _run_both(xs, bits=8):
    jst = JQ.range_state_init(WINDOW)
    tst = TQ.range_state_init(WINDOW)
    jfq = (lambda x, st: JQ.fake_quantize_range_abs_max(x, st, bits))
    out = []
    for x in xs:
        jo, jst = jfq(jnp.asarray(x), jst)
        to, tst = TQ.fake_quantize_range_abs_max(torch.from_numpy(x), tst,
                                                 bits)
        out.append((to, tst, jo, jst))
    return out


def test_init_state_matches():
    j, t = JQ.range_state_init(WINDOW), TQ.range_state_init(WINDOW)
    assert t.step.dtype == torch.int32 and t.step.ndim == 0
    assert t.scales_window.shape == (WINDOW,)
    _close(t.scale, j.scale)
    _close(t.scales_window, j.scales_window)
    assert TQP.RangeState is TQ.RangeState
    assert TQP.fake_quantize_range_abs_max is TQ.fake_quantize_range_abs_max
    assert TQP.range_state_init is TQ.range_state_init


@pytest.mark.parametrize("bits", [8, 4])
def test_twelve_calls_wrap_the_ring_as_jax(bits):
    xs = _inputs()
    scales = []
    for i, (to, tst, jo, jst) in enumerate(_run_both(xs, bits)):
        _close(to, jo)
        _close(tst.scale, jst.scale)
        _close(tst.scales_window, jst.scales_window)
        assert tst.step.dtype == torch.int32
        assert int(tst.step) == int(jst.step) == i + 1
        # the scale is the max over the whole window
        assert float(tst.scale) == float(torch.amax(tst.scales_window))
        scales.append(float(tst.scale))
    # call 1's large abs-max sets the scale until its slot is rewritten
    assert scales[1] == scales[4] > scales[5]


def test_is_test_quantizes_at_the_state_scale():
    xs = _inputs()
    *_, (to, tst, jo, jst) = _run_both(xs)
    x = _inputs()[3]
    jo, jst2 = JQ.fake_quantize_range_abs_max(jnp.asarray(x), jst,
                                              is_test=True)
    to, tst2 = TQ.fake_quantize_range_abs_max(torch.from_numpy(x), tst,
                                              is_test=True)
    assert tst2 is tst
    _close(to, jo)
    _close(tst2.scales_window, jst2.scales_window)


def test_straight_through_gradient_matches_jax_grad():
    """With a state carried from five calls, this call's abs-max sets the
    scale: identity inside the clip range, and the gradient through the
    scale (the window's max) at the abs-max element split as JAX splits
    it."""
    xs = _inputs()
    prior = _run_both(xs[:5])[-1]
    tst, jst = prior[1], prior[3]
    x = xs[5] * 16.0
    c = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)

    def jloss(xx):
        out, _ = JQ.fake_quantize_range_abs_max(xx, jst)
        return jnp.sum(out * c)

    jg = jax.jit(jax.grad(jloss))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    out, st = TQ.fake_quantize_range_abs_max(tx, tst)
    torch.sum(out * torch.from_numpy(c)).backward()
    assert float(st.scale.detach()) == float(np.abs(x).max())
    # every element but the abs-max one at 1e-6; that one also takes the
    # gradient through the scale, a sum over all 231 elements, which the
    # two packages reduce in other orders: 1e-5 of its size
    top = np.abs(x).argmax()
    got, want = tx.grad.numpy().ravel(), np.asarray(jg).ravel()
    rest = np.arange(got.size) != top
    np.testing.assert_allclose(got[rest], want[rest], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[top], want[top], rtol=1e-5, atol=0)
