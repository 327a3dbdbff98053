"""The int8 half of the port's paged-KV ops (paddle_tpu_torch/ops/
paged_kv.py: QuantizedPool, quantize-on-append writes, dequantize-on-
gather) and the int8 paged decode kernel's plain version
(ops/kernels/decode_attention.py ``decode_attention_paged_quant_plain``)
against the JAX package.

Tolerances and why:
- writes into a QuantizedPool (``write_rows``/``write_chunk``, with
  parked rows and out-of-pool page ids): values and scales exactly equal
  — the same ``absmax_encode`` arithmetic on equal float inputs, and the
  same dropped rows.
- ``gather_rows`` dequantization: atol 1e-6 (one float32 multiply in
  both; agreement is in fact exact).
- the int8 decode plain version against JAX ``flash_decode_paged(
  k_scale=, v_scale=)`` run in interpret mode: atol 2e-5, as the float
  decode kernels' parity (the same masked softmax in float32 over the
  same dequantized keys; only the order of sums differs, ~1e-6). The
  same holds for the plain split walk (``_attend_plain_split``, the
  kernels' per-chunk partials and merge) over the dequantized pages.

The test marked ``gpu`` holds the CUDA kernel against its plain version
on the card and skips here:
``python3 -m pytest --noconftest -m gpu tests/test_torch_paged_kv_int8.py``
(JAX is imported inside the CPU tests only)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import paged_kv as TP
from paddle_tpu_torch.ops.kernels import decode_attention as K
from paddle_tpu_torch.quant.ops import absmax_encode

PS, D = 64, 64


def _jax():
    import jax.numpy as jnp

    from paddle_tpu.ops import paged_kv as JP

    return jnp, JP


def _pools(pages, kv, seed):
    """The same int8 pool (values and scales) in both packages."""
    jnp, JP = _jax()
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (pages, PS, kv, D)).astype(np.int8)
    s = rng.uniform(0.001, 0.05, (pages, PS, kv)).astype(np.float32)
    jpool = JP.QuantizedPool(jnp.asarray(q), jnp.asarray(s))
    tpool = TP.QuantizedPool(torch.from_numpy(q.copy()),
                             torch.from_numpy(s.copy()))
    return jpool, tpool


def _same_pool(tpool, jpool):
    np.testing.assert_array_equal(tpool.q.numpy(), np.asarray(jpool.q))
    np.testing.assert_array_equal(tpool.scale.numpy(),
                                  np.asarray(jpool.scale))


@pytest.mark.parametrize("t", [
    [70, 128, 0],         # row 1 parked
    [0, 128, 128],        # parked rows' clamped spot is row 0's write
    [128, 128, 200],      # every row dropped
    [63, 64, 127],        # page edges
], ids=["parked", "collides", "all_dropped", "page_edges"])
def test_write_rows_quantized_matches_jax(t):
    jnp, JP = _jax()
    jk, tk = _pools(6, 2, seed=1)
    jv, tv = _pools(6, 2, seed=2)
    # row 2's second page id lies outside the pool: its writes drop
    table = np.array([[4, 1], [0, 5], [2, 99]], np.int32)
    rng = np.random.default_rng(3)
    k = rng.normal(size=(3, 1, 2, D)).astype(np.float32)
    v = rng.normal(size=(3, 1, 2, D)).astype(np.float32) * 3
    t = np.array(t, np.int32)
    jk, jv = JP.write_rows(jk, jv, jnp.asarray(table), jnp.asarray(t),
                           jnp.asarray(k), jnp.asarray(v), PS)
    TP.write_rows(tk, tv, torch.from_numpy(table), torch.from_numpy(t),
                  torch.from_numpy(k), torch.from_numpy(v), PS)
    _same_pool(tk, jk)
    _same_pool(tv, jv)


@pytest.mark.parametrize("t0", [0, 100, 120, 130])
def test_write_chunk_quantized_matches_jax(t0):
    jnp, JP = _jax()
    jk, tk = _pools(4, 2, seed=4)
    table_row = np.array([3, 1], np.int32)
    k = np.random.default_rng(5).normal(size=(1, 16, 2, D)).astype(
        np.float32)
    jk, jv = JP.write_chunk(jk, jk, jnp.asarray(table_row), t0,
                            jnp.asarray(k), jnp.asarray(-k), PS)
    tv = TP.QuantizedPool(tk.q.clone(), tk.scale.clone())
    TP.write_chunk(tk, tv, torch.from_numpy(table_row), t0,
                   torch.from_numpy(k), torch.from_numpy(-k), PS)
    _same_pool(tk, jk)
    _same_pool(tv, jv)


@pytest.mark.parametrize("upto", [None, 70])
def test_gather_rows_dequantizes_as_jax(upto):
    jnp, JP = _jax()
    jpool, tpool = _pools(5, 2, seed=6)
    table = np.array([[4, 0, 2], [1, 3, 7]], np.int32)   # 7 clamps
    want = JP.gather_rows(jpool, jnp.asarray(table), upto=upto)
    got = TP.gather_rows(tpool, torch.from_numpy(table), upto=upto)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_quantized_pool_mirrors_the_value_plane():
    _, tpool = _pools(3, 2, seed=7)
    assert tpool.shape == (3, PS, 2, D) and tpool.dtype == torch.int8
    assert tpool.nbytes == TP.quantized_pool_nbytes(tpool.shape) == (
        3 * PS * 2 * (D + 4))


def _decode_inputs(h, kv, seed, b=3, nlog=4, pages=16, d=D):
    """TestQuantizedKernel._mk of tests/test_paged_kv.py: seeded float
    pools quantized per vector with absmax_encode, a shuffled table."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    kf = rng.normal(size=(pages, PS, kv, d)).astype(np.float32)
    vf = rng.normal(size=(pages, PS, kv, d)).astype(np.float32)
    kq, ks = absmax_encode(torch.from_numpy(kf), axis=-1)
    vq, vs = absmax_encode(torch.from_numpy(vf), axis=-1)
    table = rng.permutation(pages)[:b * nlog].reshape(b, nlog).astype(
        np.int32)
    return (q, kq.numpy(), ks[..., 0].numpy(), vq.numpy(),
            vs[..., 0].numpy(), table)


def _both(inputs, t, window):
    from paddle_tpu.ops.pallas.flash_decode import flash_decode_paged

    jnp, _ = _jax()
    q, kq, ks, vq, vs, table = inputs
    want = flash_decode_paged(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(table), t if np.isscalar(t) else jnp.asarray(t),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), window=window,
        interpret=True)
    tt = t if np.isscalar(t) else torch.from_numpy(t)
    got = K.decode_attention_paged_quant(
        *(torch.from_numpy(x) for x in (q, kq, ks, vq, vs, table)), tt,
        window=window)
    return got, want


@pytest.mark.parametrize("window", [None, 50])
@pytest.mark.parametrize("h,kv", [(8, 4), (4, 4), (8, 1)])
def test_quant_decode_plain_matches_pallas(h, kv, window):
    inputs = _decode_inputs(h, kv, seed=h + kv)
    got, want = _both(inputs, np.array([30, 130, 255], np.int32), window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("t", [(255, 256, 512), (257, 0, 300)],
                         ids=["edge_parked", "beyond_edge"])
def test_quant_split_walk_matches_pallas(t, window):
    """Two 256-position chunks over int8 pools (n_log 8): cursors on and
    beside the chunk edge, a parked row, an empty chunk, a window across
    the edge."""
    from paddle_tpu.ops.pallas.flash_decode import flash_decode_paged

    jnp, _ = _jax()
    q, kq, ks, vq, vs, table = _decode_inputs(8, 2, seed=sum(t), nlog=8,
                                              pages=32)
    tt = np.asarray(t, np.int32)
    want = flash_decode_paged(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(table), jnp.asarray(tt), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), window=window, interpret=True)
    tab = torch.from_numpy(table)
    got = K._attend_plain_split(
        torch.from_numpy(q),
        K.dequantize_pages(torch.from_numpy(kq), torch.from_numpy(ks), tab),
        K.dequantize_pages(torch.from_numpy(vq), torch.from_numpy(vs), tab),
        torch.from_numpy(tt), window, D ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_quant_decode_scalar_cursor_and_gather_oracle():
    """A scalar cursor broadcasts; the plain version also equals
    attention over ``gather_rows``' dequantized cache (the attend
    fallback)."""
    inputs = _decode_inputs(8, 4, seed=9)
    got, want = _both(inputs, 77, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    q, kq, ks, vq, vs, table = (torch.from_numpy(x) for x in inputs)
    oracle = K.decode_attention_plain(
        q, TP.gather_rows(TP.QuantizedPool(kq, ks), table),
        TP.gather_rows(TP.QuantizedPool(vq, vs), table), 77)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=1e-6,
                               rtol=0)


def _attend_both(kpool_t, vpool_t, kpool_j, vpool_j, q, table, t):
    """The port's attend and the JAX package's (its gather path here)."""
    jnp, JP = _jax()
    got = TP.attend(torch.from_numpy(q), kpool_t, vpool_t,
                    torch.from_numpy(table), torch.from_numpy(t))
    want = JP.attend(jnp.asarray(q), kpool_j, vpool_j, jnp.asarray(table),
                     jnp.asarray(t))
    return got, want


# head_dim 96 lies outside the JAX decode kernels' head dims (64, 128,
# 256): the port's dispatch must not depend on it, so that on the card
# every shape launches the kernel or raises
@pytest.mark.parametrize("d", [64, 96], ids=["d64", "d96"])
def test_attend_routes_quantized_pools_to_the_int8_wrapper(monkeypatch, d):
    """ops.paged_kv.attend hands the int8 wrapper the raw planes (and the
    float wrapper is not called) whatever the head_dim; its output equals
    JAX attend's to 2e-5."""
    jnp, JP = _jax()
    inputs = _decode_inputs(8, 4, seed=10, d=d)
    q, kq, ks, vq, vs, table = (torch.from_numpy(x) for x in inputs)
    calls = []
    real = K.decode_attention_paged_quant

    def spy(*a, **kw):
        calls.append(a[1] is kq and a[2] is ks)
        return real(*a, **kw)

    monkeypatch.setattr(K, "decode_attention_paged_quant", spy)
    monkeypatch.setattr(K, "decode_attention_paged",
                        lambda *a, **kw: pytest.fail("float wrapper"))
    t = np.array([5, 100, 200], np.int32)
    got, want = _attend_both(
        TP.QuantizedPool(kq, ks), TP.QuantizedPool(vq, vs),
        *(JP.QuantizedPool(jnp.asarray(a), jnp.asarray(b))
          for a, b in ((inputs[1], inputs[2]), (inputs[3], inputs[4]))),
        inputs[0], inputs[5], t)
    assert calls == [True] and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("d", [64, 96], ids=["d64", "d96"])
def test_attend_routes_float_pools_to_the_paged_wrapper(monkeypatch, d):
    """A float pool goes to the float paged wrapper whatever the
    head_dim; its output equals JAX attend's to 2e-5."""
    jnp, _ = _jax()
    rng = np.random.default_rng(11)
    q = rng.normal(size=(3, 1, 8, d)).astype(np.float32)
    kp, vp = (rng.normal(size=(16, PS, 4, d)).astype(np.float32)
              for _ in range(2))
    table = rng.permutation(16)[:12].reshape(3, 4).astype(np.int32)
    calls = []
    real = K.decode_attention_paged

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(K, "decode_attention_paged", spy)
    got, want = _attend_both(torch.from_numpy(kp), torch.from_numpy(vp),
                             jnp.asarray(kp), jnp.asarray(vp), q, table,
                             np.array([0, 70, 255], np.int32))
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


@pytest.mark.gpu
def test_cuda_int8_decode_kernel_matches_plain():
    """On the card: the int8 paged kernel against its plain version at
    the serving shape (B=8, H=12, Hkv=4, D=64, 64-token pages, a shuffled
    table with garbage past the live range and a parked row), q float32
    (atol 1e-4) and bfloat16 compared in float32 (atol 2e-2); and the
    int8 write_rows under sync debug mode "error"."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, cap, h, kv = 8, 2048, 12, 4
    pages = b * cap // PS + 8
    t = torch.tensor([0, 63, 64, 65, 1000, 2047, 2048, 5000],
                     dtype=torch.int32, device=dev)
    # on and beside the split's chunk edges (256 positions a chunk)
    t_edges = torch.tensor([255, 256, 257, 511, 512, 513, 1279, 2048],
                           dtype=torch.int32, device=dev)
    kq, ks = absmax_encode(torch.randn(pages, PS, kv, D, generator=gen,
                                       device=dev), axis=-1)
    vq, vs = absmax_encode(torch.randn(pages, PS, kv, D, generator=gen,
                                       device=dev), axis=-1)
    ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    table = torch.randperm(pages, generator=gen, device=dev)
    table = table[:b * cap // PS].reshape(b, -1).to(torch.int32)
    table[0, 1:] = 10 ** 6
    table[1, 1:] = -7
    for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        q = torch.randn(b, 1, h, D, generator=gen, device=dev).to(dtype)
        for window, tt in ((None, t), (256, t), (None, t_edges),
                           (100, t_edges)):
            n0 = K.decode_attention_paged_quant.launches
            got = K.decode_attention_paged_quant(q, kq, ks, vq, vs, table,
                                                 tt, window=window)
            want = K.decode_attention_paged_quant_plain(
                q, kq, ks, vq, vs, table, tt, window)
            torch.cuda.synchronize()
            assert K.decode_attention_paged_quant.launches == n0 + 1
            assert got.dtype == dtype
            assert (got.float() - want.float()).abs().max().item() < atol
    kp, vp = TP.QuantizedPool(kq.clone(), ks.clone()), TP.QuantizedPool(
        vq.clone(), vs.clone())
    k_t = torch.randn(b, 1, kv, D, generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        TP.write_rows(kp, vp, table, t, k_t, -k_t, PS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    wq, wsc = absmax_encode(k_t[:, 0], axis=-1)
    for row in range(b):
        tt = int(t[row])
        if tt < cap:
            page = int(table[row, tt // PS])
            assert torch.equal(kp.q[page, tt % PS], wq[row])
            assert torch.equal(kp.scale[page, tt % PS], wsc[row, :, 0])
