"""``ops/sequence.py`` of the port against the JAX package's, on the CPU,
over the padded (B, T, ...) + lengths layout: one case per function, the
same numpy-seeded inputs through both (the JAX side jitted, except the
ops that read a size from the data: ``sequence_unpad``,
``sequence_expand`` without ``rmax`` and ``sequence_erase``), float
outputs within atol 1e-6 + rtol 1e-6 (integer outputs equal) and grads
within 1e-5. Every batch has a padded row and an empty one where the op
allows it; ``sequence_reverse`` and ``sequence_pool(pool_type="last")``
also take lengths past T. ``hash_embedding_ids`` matches bit for bit (uint32
wraparound, emulated in int64), negative and large ids included;
``sequence_scatter`` adds duplicate positions; ``chunk_eval`` is held
in each scheme (IOB, IOE, IOBES, plain), with excluded types, on random
tag sequences and on the reference's worked example."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import sequence as J
from paddle_tpu_torch.ops import sequence as T
from torch_parity import check_pair, compare

RNG = np.random.default_rng(4)
P = functools.partial
B, L = 4, 6
LENS = np.array([6, 3, 0, 4], np.int32)
LONG_LENS = np.array([8, 3, 0, 7], np.int32)


def f32(*shape):
    return RNG.normal(size=shape).astype(np.float32)


CASES = {
    "sequence_pad": (P(J.sequence_pad, maxlen=L, pad_value=-1.0),
                     P(T.sequence_pad, maxlen=L, pad_value=-1.0),
                     [f32(int(LENS.sum()), 3), LENS], (0,)),
    "sequence_pool_sum": (P(J.sequence_pool, pool_type="sum"),
                          P(T.sequence_pool, pool_type="sum"),
                          [f32(B, L, 3), LENS], (0,)),
    "sequence_pool_average": (P(J.sequence_pool, pool_type="average"),
                              P(T.sequence_pool, pool_type="average"),
                              [f32(B, L, 3), LENS], (0,)),
    "sequence_pool_sqrt": (P(J.sequence_pool, pool_type="sqrt"),
                           P(T.sequence_pool, pool_type="sqrt"),
                           [f32(B, L, 3), LENS], (0,)),
    "sequence_pool_max": (P(J.sequence_pool, pool_type="max"),
                          P(T.sequence_pool, pool_type="max"),
                          [f32(B, L, 3), LENS], (0,)),
    "sequence_pool_last": (P(J.sequence_pool, pool_type="last"),
                           P(T.sequence_pool, pool_type="last"),
                           [f32(B, L, 3), LENS], (0,)),
    "sequence_pool_first": (P(J.sequence_pool, pool_type="first"),
                            P(T.sequence_pool, pool_type="first"),
                            [f32(B, L, 3), LENS], (0,)),
    "sequence_softmax": (J.sequence_softmax, T.sequence_softmax,
                         [f32(B, L), LENS], (0,)),
    "sequence_reverse": (J.sequence_reverse, T.sequence_reverse,
                         [f32(B, L, 2), LENS], (0,)),
    "sequence_expand": (P(J.sequence_expand, rmax=5),
                        P(T.sequence_expand, rmax=5),
                        [f32(B, 3), np.array([2, 5, 0, 1], np.int32)], (0,)),
    "sequence_expand_as": (P(J.sequence_expand_as, rmax=4),
                           P(T.sequence_expand_as, rmax=4),
                           [f32(B, 2, 2), np.array([4, 1, 0, 3], np.int32)],
                           (0,)),
    "sequence_concat": (
        lambda a, b, la, lb: J.sequence_concat([a, b], [la, lb]),
        lambda a, b, la, lb: T.sequence_concat([a, b], [la, lb]),
        [f32(B, L, 2), f32(B, 3, 2), LENS, np.array([1, 3, 2, 0],
                                                    np.int32)], (0, 1)),
    "sequence_slice": (J.sequence_slice, T.sequence_slice,
                       [f32(B, L, 2), LENS, np.array([1, 0, 0, 2], np.int32),
                        np.array([3, 2, 0, 2], np.int32)], (0,)),
    "sequence_enumerate": (P(J.sequence_enumerate, win_size=3, pad_value=-1),
                           P(T.sequence_enumerate, win_size=3, pad_value=-1),
                           [RNG.integers(1, 50, (B, L)).astype(np.int32),
                            LENS], ()),
    "im2sequence": (P(J.im2sequence, kernel=(2, 3), stride=(1, 2),
                      padding=(1, 0)),
                    P(T.im2sequence, kernel=(2, 3), stride=(1, 2),
                      padding=(1, 0)), [f32(2, 3, 5, 7)], (0,)),
    "position_encoding": (P(J.position_encoding, alpha=0.5, beta=2.0),
                          P(T.position_encoding, alpha=0.5, beta=2.0),
                          [f32(2, 5, 7)], (0,)),
    "hash_embedding_ids": (
        P(J.hash_embedding_ids, num_buckets=1000, num_hash=2),
        P(T.hash_embedding_ids, num_buckets=1000, num_hash=2),
        [np.array([[0, 1, -1, 2 ** 31 - 1], [-2 ** 31, 123456789, 7, 4095]],
                  np.int32)], ()),
    "hash_embedding_ids_one": (
        P(J.hash_embedding_ids, num_buckets=97),
        P(T.hash_embedding_ids, num_buckets=97),
        [RNG.integers(-2 ** 31, 2 ** 31 - 1, (3, 5)).astype(np.int32)], ()),
    "sequence_reshape": (P(J.sequence_reshape, new_dim=3),
                         P(T.sequence_reshape, new_dim=3),
                         [f32(B, L, 2), LENS], (0,)),
    "sequence_scatter": (J.sequence_scatter, T.sequence_scatter,
                         [f32(B, 5), np.array([[0, 0, 4, 2], [1, 3, 3, 3],
                                               [2, 2, 0, 1], [4, 9, -1, 0]],
                                              np.int32), f32(B, 4),
                          np.array([4, 3, 0, 2], np.int32)], (0, 2)),
    "sequence_scatter_no_lengths": (
        J.sequence_scatter, T.sequence_scatter,
        [f32(2, 5), np.array([[0, 0, 4], [1, 3, 3]], np.int32), f32(2, 3)],
        (0, 2)),
    "add_position_encoding": (P(J.add_position_encoding, alpha=1.5, beta=0.5),
                              P(T.add_position_encoding, alpha=1.5, beta=0.5),
                              [f32(2, 5, 8)], (0,)),
    "add_position_encoding_odd": (J.add_position_encoding,
                                  T.add_position_encoding, [f32(2, 4, 7)],
                                  (0,)),
    "sequence_mask": (P(J.sequence_mask, maxlen=L),
                      P(T.sequence_mask, maxlen=L), [LENS], ()),
    # lengths past T: reverse reads NaN past the end (take_along_axis),
    # the last step clamps to row T - 1 (x[...])
    "sequence_reverse_long": (J.sequence_reverse, T.sequence_reverse,
                              [f32(B, L, 2), LONG_LENS], (0,)),
    "sequence_pool_last_long": (P(J.sequence_pool, pool_type="last"),
                                P(T.sequence_pool, pool_type="last"),
                                [f32(B, L, 3), LONG_LENS], (0,)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sequence_op_matches_jax(name):
    jfn, tfn, args, grad = CASES[name]
    check_pair(jfn, tfn, args, grad=grad, gatol=1e-5)


def test_eager_ops_match_jax():
    """The ops whose output size is read from the data, eagerly."""
    x = f32(B, L, 2)
    compare(T.sequence_unpad(torch.from_numpy(x), torch.from_numpy(LENS)),
            J.sequence_unpad(jnp.asarray(x), jnp.asarray(LENS)), 0, 0)
    ref = np.array([2, 5, 0, 1], np.int32)
    y = f32(B, 3)
    compare(T.sequence_expand(torch.from_numpy(y), torch.from_numpy(ref)),
            J.sequence_expand(jnp.asarray(y), jnp.asarray(ref)), 0, 0)
    compare(T.sequence_expand(torch.from_numpy(y), [2, 5, 0, 1]),
            J.sequence_expand(jnp.asarray(y), [2, 5, 0, 1]), 0, 0)
    ids = RNG.integers(0, 6, (B, L)).astype(np.int32)
    compare(T.sequence_erase(torch.from_numpy(ids), torch.from_numpy(LENS),
                             [0, 3]),
            J.sequence_erase(jnp.asarray(ids), jnp.asarray(LENS), [0, 3]),
            0, 0)


SCHEMES = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("excluded", [(), (1,)])
def test_chunk_eval_matches_jax(scheme, excluded):
    types = 3
    labels = RNG.integers(0, SCHEMES[scheme] * types + 1, (5, 9)).astype(
        np.int32)
    infer = np.where(RNG.random((5, 9)) < 0.7, labels,
                     RNG.integers(0, SCHEMES[scheme] * types + 1, (5, 9))
                     ).astype(np.int32)
    lens = np.array([9, 4, 0, 7, 1], np.int32)
    check_pair(lambda i, l, n: J.chunk_eval(i, l, n, types, scheme, excluded),
               lambda i, l, n: T.chunk_eval(i, l, n, types, scheme, excluded),
               [infer, labels, lens])


def test_chunk_eval_reference_example():
    """IOB with 2 types (B-0=0, I-0=1, B-1=2, I-1=3, O=4): inference
    has chunks [0,1] t0, [3,4] t1, [5] t0; the label [0,1] t0, [3] t1,
    [5,6] t0: one correct of three each side."""
    infer = np.array([[0, 1, 4, 2, 3, 0, 4]], np.int32)
    label = np.array([[0, 1, 4, 2, 4, 0, 1]], np.int32)
    got = T.chunk_eval(torch.from_numpy(infer), torch.from_numpy(label),
                       torch.tensor([7]), 2, "IOB")
    want = J.chunk_eval(infer, label, np.array([7]), 2, "IOB")
    compare(got, want, 1e-7, 0)
    assert [int(v) for v in got[3:]] == [3, 3, 1]


def test_every_public_name_has_a_case():
    import inspect

    names = {n for n, f in vars(J).items() if inspect.isfunction(f)
             and not n.startswith("_") and f.__module__ == J.__name__}
    covered = {n for n in names if any(c == n or c.startswith(n + "_")
                                       for c in CASES)}
    covered |= {"sequence_unpad", "sequence_erase", "chunk_eval"}
    assert names <= covered, sorted(names - covered)
