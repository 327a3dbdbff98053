"""The port's decode-attention kernels (paddle_tpu_torch/ops/kernels/
decode_attention.py). On the CPU their plain versions are held against
the JAX package's Pallas kernels flash_decode and flash_decode_paged,
run in interpret mode as tests/test_pallas_decode.py runs them: B=3,
cap=256, D=64, float32, atol 2e-5. The test marked ``gpu`` holds the
CUDA kernels against the plain versions on the card and skips here. JAX
is imported only by the tests that use it, so that the gpu test also
runs where JAX is not installed:
``python3 -m pytest --noconftest -m gpu tests/test_torch_decode_attention.py``
(the suite's conftest imports JAX)."""

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


@pytest.mark.parametrize("embed,heads,cap", [(512, 8, 256), (256, 8, 100)],
                         ids=["d64_cap256", "d32_cap100"])
def test_layer_decode_takes_the_wrapper_at_any_shape(monkeypatch, embed,
                                                     heads, cap):
    """A decode step of the attention layer calls the decode wrapper
    whatever the head_dim and the capacity (on the card: the kernel or a
    typed error, never the plain path), and equals the layer's masked
    plain path to 1e-5."""
    from paddle_tpu_torch.nn.layers import MultiHeadAttention

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
        got = attn.attend_kv(x, k, v, pos, decode_kernel=True)
        want = attn.attend_kv(x, k, v, pos)
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=0)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """On the card: both kernels against their plain versions, float32
    (atol 1e-4) and bfloat16 compared in float32 (atol 2e-2), with
    windows, a shuffled table with garbage past the live range and a
    parked row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    b, cap, h, kv, d = 8, 2048, 12, 4, 64
    t = torch.tensor([0, 63, 64, 65, 1000, 2047, 2048, 5000],
                     dtype=torch.int32, device=dev)
    for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
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
        for window in (None, 256):
            n0 = K.decode_attention.launches
            got = K.decode_attention(q, k, v, t, window=window)
            want = K.decode_attention_plain(q, k, v, t, window)
            torch.cuda.synchronize()
            assert K.decode_attention.launches == n0 + 1
            assert (got.float() - want.float()).abs().max().item() < atol
            got = K.decode_attention_paged(q, kp, vp, table, t,
                                           window=window)
            want = K.decode_attention_paged_plain(q, kp, vp, table, t,
                                                  window)
            torch.cuda.synchronize()
            assert (got.float() - want.float()).abs().max().item() < atol
