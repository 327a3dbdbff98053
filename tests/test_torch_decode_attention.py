"""The port's decode-attention kernels (paddle_tpu_torch/ops/kernels/
decode_attention.py). On the CPU their plain versions are held against
the JAX package's Pallas kernels flash_decode and flash_decode_paged,
run in interpret mode as tests/test_pallas_decode.py runs them: B=3,
cap=256, D=64, float32, atol 2e-5. The plain version of the kernels'
split walk (``_attend_plain_split``: per-chunk partials merged with the
log-sum-exp rule) is held against the same Pallas kernels at cap=512 (two
256-position chunks), atol 2e-5: cursors on and beside the chunk edge,
chunks with no live key, windows across the edge, parked rows, GQA
groups 1/2/4. The test marked ``gpu`` holds the
CUDA kernels against the plain versions on the card and skips here. JAX
is imported only by the tests that use it, so that the gpu test also
runs where JAX is not installed:
``python3 -m pytest --noconftest -m gpu tests/test_torch_decode_attention.py``
(the suite's conftest imports JAX)."""

import itertools

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import decode_attention as K

ATOL = 2e-5
B, CAP, D, PS = 3, 256, 64, 64
PAGES = 16
HEADS = [(8, 8), (8, 4), (8, 1)]


def _qkv(h, kv, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, h, D)).astype(np.float32)
    k = rng.normal(size=(B, CAP, kv, D)).astype(np.float32)
    v = rng.normal(size=(B, CAP, kv, D)).astype(np.float32)
    return q, k, v


def _pallas():
    """The JAX package's decode kernels and jax.numpy."""
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas.flash_decode import (flash_decode,
                                                    flash_decode_paged)

    return jnp, flash_decode, flash_decode_paged


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("t", [(0, 63, 255), (64, 255, 0)])
@pytest.mark.parametrize("h,kv", HEADS)
def test_contiguous_plain_matches_pallas(h, kv, t, window):
    jnp, flash_decode, _ = _pallas()
    q, k, v = _qkv(h, kv, seed=h * 10 + kv)
    t = np.asarray(t, np.int32)
    want = flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(t), window=window, block_k=64)
    got = K.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(t),
                             window=window)
    _close(got, want)


def _paged_inputs(h, kv, t, seed):
    """A shuffled page table whose entries past each row's live range
    hold garbage (out-of-pool ids included), over a random pool."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, h, D)).astype(np.float32)
    kp = rng.normal(size=(PAGES, PS, kv, D)).astype(np.float32)
    vp = rng.normal(size=(PAGES, PS, kv, D)).astype(np.float32)
    n_log = CAP // PS
    table = rng.permutation(PAGES)[:B * n_log].reshape(B, n_log)
    table = table.astype(np.int32)
    for b, tb in enumerate(t):
        if tb < CAP:       # a parked row (t = capacity) reads every page
            live = tb // PS + 1
            table[b, live:] = rng.integers(-50, 50, n_log - live)
    return q, kp, vp, table


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("t", [(0, 63, CAP), (64, 255, CAP)])
@pytest.mark.parametrize("h,kv", HEADS)
def test_paged_plain_matches_pallas(h, kv, t, window):
    jnp, _, flash_decode_paged = _pallas()
    q, kp, vp, table = _paged_inputs(h, kv, t, seed=h + kv)
    t = np.asarray(t, np.int32)
    want = flash_decode_paged(jnp.asarray(q), jnp.asarray(kp),
                              jnp.asarray(vp), jnp.asarray(table),
                              jnp.asarray(t), window=window)
    got = K.decode_attention_paged(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(t), window=window)
    _close(got, want)


def test_scalar_cursor_broadcasts():
    jnp, flash_decode, _ = _pallas()
    q, k, v = _qkv(8, 4, seed=3)
    want = flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        100, block_k=64)
    got = K.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), 100)
    _close(got, want)


SPLIT_CAP = 2 * K.CHUNK
SPLIT_CURSORS = [(0, 255, 256), (257, 511, 100)]


def _split_want_got(h, kv, t, window, paged):
    """The Pallas kernel (interpret mode) and the plain split walk over
    the same cache, contiguous or paged (a shuffled table with garbage
    past each row's live range; a parked row)."""
    jnp, flash_decode, flash_decode_paged = _pallas()
    rng = np.random.default_rng(h * 7 + kv + sum(t))
    q = rng.normal(size=(B, 1, h, D)).astype(np.float32)
    tt = np.asarray(t, np.int32)
    if not paged:
        k, v = (rng.normal(size=(B, SPLIT_CAP, kv, D)).astype(np.float32)
                for _ in range(2))
        want = flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(tt), window=window, block_k=64)
        kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    else:
        n_log, pages = SPLIT_CAP // PS, 32
        kp, vp = (rng.normal(size=(pages, PS, kv, D)).astype(np.float32)
                  for _ in range(2))
        table = rng.permutation(pages)[:B * n_log].reshape(B, n_log)
        table = table.astype(np.int32)
        for b, tb in enumerate(tt):
            if tb < SPLIT_CAP:
                live = tb // PS + 1
                table[b, live:] = rng.integers(-50, 50, n_log - live)
        want = flash_decode_paged(jnp.asarray(q), jnp.asarray(kp),
                                  jnp.asarray(vp), jnp.asarray(table),
                                  jnp.asarray(tt), window=window)
        tab = torch.from_numpy(table)
        kt = K.gather_pages(torch.from_numpy(kp), tab)
        vt = K.gather_pages(torch.from_numpy(vp), tab)
    got = K._attend_plain_split(torch.from_numpy(q), kt, vt,
                                torch.from_numpy(tt), window, D ** -0.5)
    return got, want


@pytest.mark.parametrize("window", [None, 40, 300])
@pytest.mark.parametrize("t", SPLIT_CURSORS, ids=["edge", "beyond_edge"])
@pytest.mark.parametrize("h,kv", [(8, 8), (8, 4), (8, 2)],
                         ids=["g1", "g2", "g4"])
def test_plain_split_matches_pallas_contiguous(h, kv, t, window):
    """Chunks of 256 positions: cursors 0 / 255 / 256 / 257 / 511 / 100;
    window 40 from 257 and 300 from 511 cross the chunk edge, and leave
    a chunk with no live key, as does t = 100 without a window."""
    got, want = _split_want_got(h, kv, t, window, paged=False)
    _close(got, want)


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("t", [(255, 256, SPLIT_CAP), (257, 0, SPLIT_CAP)],
                         ids=["edge", "beyond_edge"])
@pytest.mark.parametrize("h,kv", [(8, 4), (8, 2)], ids=["g2", "g4"])
def test_plain_split_matches_pallas_paged(h, kv, t, window):
    """The paged form's split walk, parked rows (t = capacity) included."""
    got, want = _split_want_got(h, kv, t, window, paged=True)
    _close(got, want)


def test_plain_split_equals_whole_row_plain_version():
    """At cap 256 the split walk is one chunk; at cap 1024 with ragged
    cursors it merges 4: both within 1e-6 of the whole-row plain
    version."""
    gen = torch.Generator().manual_seed(5)
    for cap in (256, 1024):
        q = torch.randn(4, 1, 8, D, generator=gen)
        k, v = (torch.randn(4, cap, 2, D, generator=gen) for _ in range(2))
        t = torch.tensor([0, cap // 2 - 1, cap // 2, cap + 3],
                         dtype=torch.int32)
        for window in (None, 300):
            np.testing.assert_allclose(
                K._attend_plain_split(q, k, v, t, window, 0.125).numpy(),
                K._attend_plain(q, k, v, t, window, 0.125).numpy(),
                atol=1e-6, rtol=0)


def test_card_rows_must_be_16_byte_multiples():
    """On the card the kernels copy 16-byte vectors: a head_dim whose
    rows are not 16-byte multiples raises a typed error before any
    launch (checked here on the helper the wrappers call)."""
    from paddle_tpu_torch.core import InvalidArgumentError

    K._check_rows((torch.zeros(2, 4, 1, 8),), 8)
    with pytest.raises(InvalidArgumentError, match="16-byte"):
        K._check_rows((torch.zeros(2, 4, 1, 6),), 6)
    with pytest.raises(InvalidArgumentError, match="16-byte"):
        K._check_rows((torch.zeros(2, 4, 1, 12, dtype=torch.bfloat16),), 12)


@pytest.mark.parametrize("embed,heads,cap", [(512, 8, 256), (256, 8, 100)],
                         ids=["d64_cap256", "d32_cap100"])
def test_layer_decode_takes_the_wrapper_at_any_shape(monkeypatch, embed,
                                                     heads, cap):
    """A decode step of the attention layer calls the decode wrapper
    whatever the head_dim and the capacity (on the card: the kernel or a
    typed error, never the plain path), and equals the layer's masked
    plain path to 1e-5."""
    from paddle_tpu_torch.nn.layers import MultiHeadAttention
    from paddle_tpu_torch.ops.attention import cache_keep_mask

    calls = []
    real = K.decode_attention

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(K, "decode_attention", spy)
    gen = torch.Generator().manual_seed(cap)
    attn = MultiHeadAttention(embed, heads, num_kv_heads=heads // 2,
                              device="cpu", generator=gen)
    x = torch.randn(B, 1, embed, generator=gen)
    k = torch.randn(B, cap, heads // 2, embed // heads, generator=gen)
    v = torch.randn(B, cap, heads // 2, embed // heads, generator=gen)
    pos = torch.tensor([[0], [cap // 2], [cap - 1]], dtype=torch.int32)
    with torch.no_grad():
        got = attn.attend_kv(x, k, v, decode_t=pos[:, 0])
        want = attn.attend_kv(x, k, v, attn_mask=cache_keep_mask(pos, cap))
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=0)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """On the card: both kernels against their plain versions, float32
    (atol 1e-4) and bfloat16 compared in float32 (atol 2e-2), with
    windows (one across a chunk edge of the split), cursors on and beside
    the chunk edges, a shuffled table with garbage past the live range
    and a parked row; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    b, cap, h, kv, d = 8, 2048, 12, 4, 64
    cursors = [torch.tensor(c, dtype=torch.int32, device=dev) for c in (
        [0, 63, 64, 65, 1000, 2047, 2048, 5000],
        # on and beside the split's chunk edges (256 positions a chunk)
        [255, 256, 257, 511, 512, 513, 1279, 1280])]
    for (dtype, atol), t in itertools.product(
            ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)), cursors):
        def rand(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(dtype)

        q = rand(b, 1, h, d)
        k, v = rand(b, cap, kv, d), rand(b, cap, kv, d)
        pages = b * cap // PS + 8
        kp, vp = rand(pages, PS, kv, d), rand(pages, PS, kv, d)
        table = torch.randperm(pages, generator=gen, device=dev)
        table = table[:b * cap // PS].reshape(b, -1).to(torch.int32)
        table[0, 1:] = 10 ** 6
        table[1, 1:] = -7
        # window 100 from 257 or 1280 crosses a chunk edge
        for window in (None, 256, 100):
            n0 = K.decode_attention.launches
            got = K.decode_attention(q, k, v, t, window=window)
            want = K.decode_attention_plain(q, k, v, t, window)
            torch.cuda.synchronize()
            assert K.decode_attention.launches == n0 + 1
            assert (got.float() - want.float()).abs().max().item() < atol
            n0 = K.decode_attention_paged.launches
            got = K.decode_attention_paged(q, kp, vp, table, t,
                                           window=window)
            want = K.decode_attention_paged_plain(q, kp, vp, table, t,
                                                  window)
            torch.cuda.synchronize()
            assert K.decode_attention_paged.launches == n0 + 1
            assert (got.float() - want.float()).abs().max().item() < atol
    # head_dim 256 in float32: two K/V tile buffers do not fit in shared
    # memory, so the kernel runs single-buffered
    q, k, v = (torch.randn(*shape, generator=gen, device=dev)
               for shape in ((2, 1, 8, 256), (2, 700, 4, 256),
                             (2, 700, 4, 256)))
    t = torch.tensor([300, 699], dtype=torch.int32, device=dev)
    for window in (None, 100):
        got = K.decode_attention(q, k, v, t, window=window)
        want = K.decode_attention_plain(q, k, v, t, window)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() < 1e-4
