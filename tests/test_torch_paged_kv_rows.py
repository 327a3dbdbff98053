"""The port's per-row chunk writes and page export/import
(paddle_tpu_torch/ops/paged_kv.py ``write_chunk_rows``, ``export_pages``,
``import_pages``) and the page pool's reference counts
(serving.PagedKVPool ``share``/``free``) against the JAX package.

All exact: the writes store the same float values (or the same
absmax_encode codes and scales, on equal float inputs) at the same
places, with the same positions dropped past the table's capacity;
export and import are gathers and stores. The storage forms do not mix:
a float pool refuses a (q, scale) payload and an int8 pool a float one,
as in the JAX package (typed errors)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import EnforceError
from paddle_tpu_torch.ops import paged_kv as TP
from paddle_tpu_torch.serving import PagedKVPool

PS, KV, D = 64, 2, 16
PAGES = 6
# (B, n_log) page table: row 2 reuses a page of row 0 past its live range
TABLE = np.array([[4, 1], [0, 5], [2, 3]], np.int32)
# per-row chunk starts: in range, across a page edge, and past the
# table's capacity (128) in part or in whole
T0_CASES = {
    "in_range": [0, 10, 40],
    "page_edge": [60, 62, 63],
    "past_capacity": [120, 128, 200],
    "mixed": [126, 3, 130],
}


@pytest.fixture(scope="module")
def jp():
    import jax.numpy as jnp

    from paddle_tpu.ops import paged_kv as JP

    return jnp, JP


def _float_pool(seed):
    return np.random.default_rng(seed).normal(
        size=(PAGES, PS, KV, D)).astype(np.float32)


def _int8_pool(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (PAGES, PS, KV, D)).astype(np.int8),
            rng.uniform(0.001, 0.05, (PAGES, PS, KV)).astype(np.float32))


def _both(jnp, JP, kind, seed):
    """The same pool in both packages: (jax pool, port pool)."""
    if kind == "float":
        p = _float_pool(seed)
        return jnp.asarray(p), torch.from_numpy(p.copy())
    q, s = _int8_pool(seed)
    return (JP.QuantizedPool(jnp.asarray(q), jnp.asarray(s)),
            TP.QuantizedPool(torch.from_numpy(q.copy()),
                             torch.from_numpy(s.copy())))


def _same(tpool, jpool):
    if isinstance(tpool, TP.QuantizedPool):
        np.testing.assert_array_equal(tpool.q.numpy(), np.asarray(jpool.q))
        np.testing.assert_array_equal(tpool.scale.numpy(),
                                      np.asarray(jpool.scale))
    else:
        np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("case", list(T0_CASES))
def test_write_chunk_rows_matches_jax(jp, kind, case):
    """Each row's S=5 positions land at its own page/offset; positions
    past the table's capacity drop, as JAX's mode="drop" scatter."""
    jnp, JP = jp
    rng = np.random.default_rng(5)
    t0 = np.array(T0_CASES[case], np.int32)
    k = rng.normal(size=(3, 5, KV, D)).astype(np.float32)
    v = rng.normal(size=(3, 5, KV, D)).astype(np.float32)
    jk, tk = _both(jnp, JP, kind, 1)
    jv, tv = _both(jnp, JP, kind, 2)
    jk, jv = JP.write_chunk_rows(jk, jv, jnp.asarray(TABLE),
                                 jnp.asarray(t0), jnp.asarray(k),
                                 jnp.asarray(v), PS)
    TP.write_chunk_rows(tk, tv, torch.from_numpy(TABLE),
                        torch.from_numpy(t0), torch.from_numpy(k),
                        torch.from_numpy(v), PS)
    _same(tk, jk)
    _same(tv, jv)


def test_write_chunk_rows_all_dropped_leaves_pool(jp):
    """Every row parked past capacity: nothing is written."""
    p = _float_pool(3)
    tk, tv = torch.from_numpy(p.copy()), torch.from_numpy(p.copy())
    k = torch.ones(3, 4, KV, D)
    TP.write_chunk_rows(tk, tv, torch.from_numpy(TABLE),
                        torch.tensor([128, 200, 129]), k, -k, PS)
    np.testing.assert_array_equal(tk.numpy(), p)
    np.testing.assert_array_equal(tv.numpy(), p)


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("ids", [[3], [0, 5], [4, 1, 2]],
                         ids=["one", "two", "three"])
def test_export_import_round_trip_matches_jax(jp, kind, ids):
    """export_pages equals JAX's; importing JAX's payload into another
    pool equals JAX's import_pages; exporting again gives the payload
    back."""
    jnp, JP = jp
    jsrc, tsrc = _both(jnp, JP, kind, 4)
    jdst, tdst = _both(jnp, JP, kind, 6)
    ids_np = np.asarray(ids, np.int32)
    jpay = JP.export_pages(jsrc, jnp.asarray(ids_np))
    tpay = TP.export_pages(tsrc, ids_np)
    if kind == "int8":
        jpay = tuple(np.asarray(a) for a in jpay)
        tpay = tuple(a.numpy() for a in tpay)
        for a, b in zip(tpay, jpay):
            np.testing.assert_array_equal(a, b)
    else:
        jpay, tpay = np.asarray(jpay), tpay.numpy()
        np.testing.assert_array_equal(tpay, jpay)
    jdst = JP.import_pages(jdst, jnp.asarray(ids_np), jpay)
    TP.import_pages(tdst, ids_np, jpay)
    _same(tdst, jdst)
    back = TP.export_pages(tdst, ids_np)
    if kind == "int8":
        for a, b in zip(back, jpay):
            np.testing.assert_array_equal(a.numpy(), b)
    else:
        np.testing.assert_array_equal(back.numpy(), jpay)


def test_import_refuses_a_mixed_storage_form(jp):
    """A float pool cannot take a (q, scale) payload and an int8 pool
    cannot take a float one — in both packages."""
    jnp, JP = jp
    q, s = _int8_pool(7)
    fpool = torch.from_numpy(_float_pool(7))
    qpool = TP.QuantizedPool(torch.from_numpy(q.copy()),
                             torch.from_numpy(s.copy()))
    with pytest.raises(EnforceError, match="quantized"):
        TP.import_pages(fpool, [0], (q[:1], s[:1]))
    with pytest.raises(EnforceError, match="payload"):
        TP.import_pages(qpool, [0], _float_pool(8)[:1])
    with pytest.raises(Exception, match="quantized"):
        JP.import_pages(jnp.asarray(_float_pool(7)), jnp.asarray([0]),
                        (q[:1], s[:1]))


def test_share_and_refcounted_free():
    """A shared page returns to the free list only when its last
    reference goes; an over-free and a share of a free page are typed
    errors."""
    pool = PagedKVPool(pages=2, page_size=64, kv_heads=2, head_dim=64,
                       device="cpu")
    a = pool.alloc(1)
    pool.share(a)
    pool.free(a)                   # 2 -> 1: still live
    assert pool.free_pages == 1
    pool.free(a)                   # 1 -> 0: back on the free list
    assert pool.free_pages == 2
    with pytest.raises(EnforceError, match="double free"):
        pool.free(a)
    with pytest.raises(EnforceError, match="unallocated"):
        pool.share(a)
    with pytest.raises(EnforceError, match="outside pool"):
        pool.share([5])


def test_refcounts_match_jax_over_a_sequence():
    """The same alloc/share/free sequence leaves the same free list and
    counts in both packages."""
    from paddle_tpu.serving import PagedKVPool as JaxPool

    jpool = JaxPool(pages=5, page_size=64, kv_heads=2, head_dim=64,
                    arrays=False)
    tpool = PagedKVPool(pages=5, page_size=64, kv_heads=2, head_dim=64,
                        arrays=False, device="cpu")
    for p in (jpool, tpool):
        a = p.alloc(3)
        p.share(a[:2])
        p.share(a[:1])
        p.free(a)
        b = p.alloc(1)
        p.free(a[:1])
        p.share(b)
    assert tpool._free == jpool._free
    np.testing.assert_array_equal(tpool._ref, jpool._ref)
