"""The port's fused linear cross-entropy (paddle_tpu_torch/ops/
fused_loss.py) against the JAX package's on the same numpy inputs,
float32 on the CPU: N=48 rows, D=32, V=1000 in chunks of 256 and 300 (V
divides neither), with and without a bias, with ignore_index holes.
Per-row losses and the grads of hidden, weight and bias at atol 2e-5: the
same chunked online logsumexp in float32, summed in another order
(observed ~1e-6 on losses of magnitude ~10)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import fused_loss as JF
from paddle_tpu_torch.ops import fused_loss as TF

ATOL = 2e-5
N, D, V = 48, 32, 1000


def _inputs(seed, bias):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) * 0.5).astype(np.float32)
    b = (rng.normal(size=(V,)) * 0.1).astype(np.float32) if bias else None
    labels = rng.integers(0, V, (N,)).astype(np.int32)
    labels[[3, 17, 40]] = -100             # ignore_index holes
    g = rng.normal(size=(N,)).astype(np.float32)
    return h, w, b, labels, g


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("chunk", [256, 300])
@pytest.mark.parametrize("bias", [False, True])
def test_losses_and_grads_match_jax(chunk, bias):
    h, w, b, labels, g = _inputs(chunk + bias, bias)
    args = [jnp.asarray(h), jnp.asarray(w),
            None if b is None else jnp.asarray(b)]
    want, vjp = jax.vjp(lambda h, w, b: JF.linear_cross_entropy(
        h, w, b, jnp.asarray(labels), chunk), *args)
    want_g = vjp(jnp.asarray(g))
    th, tw = (torch.from_numpy(x).requires_grad_() for x in (h, w))
    tb = None if b is None else torch.from_numpy(b).requires_grad_()
    got = TF.linear_cross_entropy(th, tw, tb, torch.from_numpy(labels),
                                  chunk)
    (got * torch.from_numpy(g)).sum().backward()
    _close(got.detach(), want)
    assert not got[3] and not got[40]      # ignored rows contribute 0
    _close(th.grad, want_g[0])
    _close(tw.grad, want_g[1])
    if bias:
        _close(tb.grad, want_g[2])


def test_mean_form_matches_jax():
    h, w, b, labels, _ = _inputs(1, True)
    want, want_g = jax.value_and_grad(
        lambda h: JF.mean_linear_cross_entropy(
            h, jnp.asarray(w), jnp.asarray(b), jnp.asarray(labels), 128))(
        jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_()
    got = TF.mean_linear_cross_entropy(th, torch.from_numpy(w),
                                       torch.from_numpy(b),
                                       torch.from_numpy(labels), 128)
    got.backward()
    _close(got.detach(), want)
    _close(th.grad, want_g)


def test_all_rows_ignored_gives_zero():
    h, w, _, labels, _ = _inputs(2, False)
    labels[:] = -100
    got = TF.mean_linear_cross_entropy(torch.from_numpy(h),
                                       torch.from_numpy(w), None,
                                       torch.from_numpy(labels))
    assert float(got) == 0.0
