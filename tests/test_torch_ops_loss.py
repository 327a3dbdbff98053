"""``ops/loss.py`` of the port against the JAX package's, on the CPU:
one case per function, the same numpy-seeded inputs through both (the
JAX side jitted), the losses within atol 1e-6 + rtol 1e-6 and the
gradients of a fixed random projection within 1e-5, in float32.
``cross_entropy`` is held with hard labels of shape (N,) and (N, 1),
with soft labels and with probabilities under its eps floor;
``bpr_loss`` with labels at the first and last class (its mask); both
with labels out of range (-1 wraps, C and -C-1 give NaN, as
``jnp.take_along_axis`` does); the hinge losses, the sigmoid cross
entropy and the teacher-student loss at their kinks (exactly 0 and the
clip bounds, where JAX splits a tie and ``abs`` has derivative +1);
``sampled_softmax_with_cross_entropy`` draws from a key, so it matches
the JAX draw in distribution only: its loss averaged over 4000 rows
within 2% of the JAX call's, and the loss equal to the one
recomputed from the port's own draw."""

import functools

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.ops import loss as J
from paddle_tpu_torch.ops import loss as T
from torch_parity import check_pair

RNG = np.random.default_rng(2)
P = functools.partial


def f32(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def probs(n, c):
    e = np.exp(f32(n, c) * 2)
    p = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    p[0, 0] = 0.0                       # under the eps floor
    return p


def unit(*shape):
    return RNG.uniform(0.05, 0.95, size=shape).astype(np.float32)


def bits(*shape):
    return (RNG.random(shape) < 0.5).astype(np.float32)


LABELS = RNG.integers(0, 5, (6,)).astype(np.int32)
LABELS[0], LABELS[1] = 0, 4
OUT_LABELS = np.array([0, 5, -1, -6], np.int32)
PROBS_FLOOR = probs(4, 5)
PROBS_FLOOR[0, 0] = np.float32(1e-8)

# name -> (args, static kwargs, grad positions)
CASES = {
    "cross_entropy": ([probs(6, 5), LABELS], {}, (0,)),
    "cross_entropy_n1": ([probs(6, 5), LABELS.reshape(6, 1)], {}, (0,)),
    "cross_entropy_soft": ([probs(6, 5), probs(6, 5)],
                           dict(soft_label=True), (0, 1)),
    "cross_entropy_axis0": ([probs(6, 5).T.copy(), LABELS],
                            dict(axis=0), (0,)),
    "square_error_cost": ([f32(4, 3), f32(4, 3)], {}, (0, 1)),
    "smooth_l1_loss": ([f32(4, 3, 2), f32(4, 3, 2)], dict(sigma=2.0),
                       (0, 1)),
    "smooth_l1_loss_weighted": ([f32(4, 3), f32(4, 3), unit(4, 3),
                                 unit(4, 3)], {}, (0, 1)),
    "huber_loss": ([f32(8), f32(8)], dict(delta=0.7), (0, 1)),
    "modified_huber_loss": ([f32(10) * 2, bits(10)], {}, (0,)),
    "hinge_loss": ([f32(8, 1), bits(8, 1)], {}, (0,)),
    "log_loss": ([unit(8, 1), bits(8, 1)], {}, (0,)),
    "bpr_loss": ([f32(6, 5), LABELS.reshape(6, 1)], {}, (0,)),
    "kldiv_loss": ([f32(4, 5), unit(4, 5) * bits(4, 5)], {}, (0, 1)),
    "kldiv_loss_sum": ([f32(4, 5), unit(4, 5)], dict(reduction="sum"),
                       (0, 1)),
    "kldiv_loss_batchmean": ([f32(4, 5), unit(4, 5)],
                             dict(reduction="batchmean"), (0,)),
    "kldiv_loss_none": ([f32(4, 5), unit(4, 5)], dict(reduction="none"),
                        (0,)),
    "margin_rank_loss": ([np.sign(f32(6, 1)), f32(6, 1), f32(6, 1)],
                         dict(margin=0.1), (1, 2)),
    "rank_loss": ([bits(6, 1), f32(6, 1), f32(6, 1)], {}, (1, 2)),
    "teacher_student_sigmoid_loss": (
        [f32(8) * 10, np.array([-2.0, -1.5, -1.2, 0.0, 1.0, 0.3, -3.0, 0.7],
                               np.float32)], {}, (0,)),
    "npair_loss": ([f32(6, 4), f32(6, 4), np.array([0, 1, 0, 2, 1, 0],
                                                   np.int32)], {}, (0, 1)),
    "mse_loss": ([f32(4, 3), f32(4, 3)], {}, (0, 1)),
    "dice_loss": ([unit(2, 3, 4), RNG.integers(0, 4, (2, 3, 1)).astype(
        np.int32)], {}, (0,)),
    "smooth_l1": ([f32(4, 3, 2), f32(4, 3, 2)], {}, (0, 1)),
    "softmax_with_cross_entropy": ([f32(6, 5), LABELS], {}, (0,)),
    "sigmoid_cross_entropy_with_logits": ([f32(4, 3), bits(4, 3)], {},
                                          (0,)),
    "label_smooth": ([np.eye(5, dtype=np.float32)[LABELS]],
                     dict(epsilon=0.2), (0,)),
    # out-of-range labels: -1 wraps to the last class, C and -C-1 read
    # NaN (jnp.take_along_axis); a probability exactly at the eps floor
    # splits its gradient (jnp.maximum)
    "cross_entropy_out_of_range": ([PROBS_FLOOR, OUT_LABELS], {}, (0,)),
    "bpr_loss_out_of_range": ([f32(4, 5), OUT_LABELS.reshape(4, 1)], {},
                              (0,)),
    # kinks: the gradient at exactly 0 and at the bounds (JAX's: abs has
    # derivative +1 at 0, maximum / minimum / clip split a tie)
    "sigmoid_cross_entropy_with_logits_kink": (
        [np.array([[0.0, -0.0, 1.5], [0.0, -2.0, 0.0]], np.float32),
         np.array([[1.0, 0.0, 1.0], [0.3, 1.0, 0.0]], np.float32)], {},
        (0,)),
    "hinge_loss_kink": ([np.array([[1.0], [-1.0], [0.5], [1.0]], np.float32),
                         np.array([[1.0], [0.0], [1.0], [0.0]], np.float32)],
                        {}, (0,)),
    "margin_rank_loss_kink": ([np.array([[1.0], [-1.0], [1.0]], np.float32),
                               np.array([[0.5], [0.25], [2.0]], np.float32),
                               np.array([[0.5], [0.25], [1.0]], np.float32)],
                              {}, (1, 2)),
    "teacher_student_sigmoid_loss_kink": (
        [np.array([15.0, -15.0, 0.0, 0.0, 3.0], np.float32),
         np.array([0.5, 1.0, -2.0, 0.0, -1.5], np.float32)], {}, (0,)),
}


def _fn(module, name):
    base = name
    while not hasattr(module, base):
        base = base.rsplit("_", 1)[0]
    return getattr(module, base)


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_jax(name):
    args, kw, grad = CASES[name]
    check_pair(P(_fn(J, name), **kw), P(_fn(T, name), **kw), args,
               grad=grad, gatol=1e-5)


def test_sampled_softmax_matches_jax_in_distribution():
    n, v, s = 4000, 50, 8
    logits = f32(n, v)
    label = RNG.integers(0, v, (n,)).astype(np.int32)
    key = np.asarray(jax.random.key_data(jax.random.key(5)))
    tl = torch.from_numpy(logits)
    got = T.sampled_softmax_with_cross_entropy(tl, torch.from_numpy(label),
                                               s, key=key)
    again = T.sampled_softmax_with_cross_entropy(
        tl, torch.from_numpy(label), s, key=key)
    want = np.asarray(J.sampled_softmax_with_cross_entropy(
        logits, label, s, key=jax.random.key(5)))
    assert got.shape == want.shape == (n, 1)
    assert torch.equal(got, again)
    assert abs(float(got.mean()) - float(want.mean())) < 0.02 * float(
        want.mean())
    # the loss of the port's own draw, recomputed
    gen = torch.Generator().manual_seed(
        (int(key[0]) << 32) | int(key[1]))
    sampled = torch.randint(0, v, (n, s), generator=gen)
    idx = torch.cat([torch.from_numpy(label).long()[:, None], sampled], 1)
    picked = torch.gather(tl, 1, idx)
    recomputed = -torch.log_softmax(picked, 1)[:, :1]
    torch.testing.assert_close(got, recomputed, rtol=0, atol=1e-6)


def test_every_public_name_has_a_case():
    import inspect

    names = {n for n, f in vars(J).items() if inspect.isfunction(f)
             and not n.startswith("_") and f.__module__ == J.__name__}
    covered = {_fn(J, c).__name__ for c in CASES}
    covered.add("sampled_softmax_with_cross_entropy")
    assert names <= covered, sorted(names - covered)
