"""The port's flash attention (paddle_tpu_torch/ops/attention.py
``flash_attention`` over ops/kernels/flash_attention.py). On the CPU the
plain forward and backward run, held against the JAX package's
``flash_attention(..., interpret=True)`` (the Pallas _fwd_kernel,
_dq_kernel and _dkv_kernel in interpret mode) and its ``jax.vjp``:
B=2, Tk=128, H=4, D=64, float32, o and dq/dk/dv at atol 2e-5 (both sides
compute the same masked online softmax in float32; only the order of
the sums differs, observed ~1e-6). lse is held against a float64
logsumexp of the masked scores at atol 1e-5 (float32 rounding of scores
of magnitude ~30).

The test marked ``gpu`` holds the three CUDA kernels against their plain
versions on the card (float32 atol 1e-4, bfloat16 compared in float32
atol 2e-2; reasons at CARD_TOL) and skips here; JAX is imported only by
the tests that use it, so that it also runs where JAX is not installed:
``python3 -m pytest --noconftest -m gpu tests/test_torch_flash_attention.py``
(the suite's conftest imports JAX)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import InvalidArgumentError, UnimplementedError
from paddle_tpu_torch.ops import attention as TA
from paddle_tpu_torch.ops.kernels import flash_attention as K

ATOL = 2e-5
B, T, H, D = 2, 128, 4, 64

# (kv heads, causal, window, Tq, kv_mask)
CASES = [
    (4, True, None, 128, False),
    (4, False, None, 128, False),
    (2, True, None, 128, False),
    (1, True, 48, 128, False),
    (2, False, 48, 128, False),
    (2, True, None, 128, True),
    (1, False, None, 64, True),
    (4, True, 48, 64, False),
]


def _inputs(hkv, tq, mask, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, tq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, hkv, D)).astype(np.float32)
    ct = rng.normal(size=(B, tq, H, D)).astype(np.float32)
    km = None
    if mask:
        # padded tail on row 0, and row 1 with no live key at all
        km = np.ones((B, T), bool)
        km[0, 100:] = False
        km[1, :] = False
    return q, k, v, ct, km


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("hkv,causal,window,tq,mask", CASES)
def test_forward_and_grads_match_pallas(hkv, causal, window, tq, mask):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas.flash_attention import flash_attention

    q, k, v, ct, km = _inputs(hkv, tq, mask, seed=hkv + tq)
    jkm = None if km is None else jnp.asarray(km)
    want, vjp = jax.vjp(
        lambda q, k, v: flash_attention(q, k, v, causal=causal,
                                        window=window, kv_mask=jkm,
                                        interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(ct))
    tq_, tk_, tv_ = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = TA.flash_attention(tq_, tk_, tv_, causal=causal, window=window,
                             kv_mask=None if km is None
                             else torch.from_numpy(km))
    (got * torch.from_numpy(ct)).sum().backward()
    _close(got.detach(), want)
    for g, w in zip((tq_.grad, tk_.grad, tv_.grad), want_grads):
        _close(g, w)
    if mask:        # the row with no live key outputs zeros, grads zero
        assert not got[1].abs().max() and not tk_.grad[1].abs().max()


@pytest.mark.parametrize("hkv,causal,window,tq,mask", CASES[::2])
def test_lse_is_the_masked_logsumexp(hkv, causal, window, tq, mask):
    q, k, v, _, km = _inputs(hkv, tq, mask, seed=7)
    tkm = None if km is None else torch.from_numpy(km)
    _, lse = K.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, scale=D ** -0.5, window=window, kv_mask=tkm)
    g = H // hkv
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  np.repeat(k, g, axis=2).astype(np.float64)) * D ** -0.5
    keep = K._keep(B, tq, T, causal, window, tkm, "cpu").numpy()
    keep = np.broadcast_to(keep, (B, 1, 1, tq, T))[:, 0, 0][:, None]
    s = np.where(keep, s, -np.inf)
    m = s.max(-1, keepdims=True)
    live = np.isfinite(m[..., 0])
    with np.errstate(divide="ignore"):      # log(0) on the dead rows
        want = np.where(live, (np.log(np.exp(s - np.where(
            np.isfinite(m), m, 0)).sum(-1)) + np.where(live, m[..., 0], 0)),
            K.NEG_INF).astype(np.float32)
    _close(lse, want, atol=1e-5)


def test_sdpa_routes_gate_passing_shapes_to_flash(monkeypatch):
    """With the gate open (as on the card), a causal self-attention and a
    key-padding mask both take flash_attention; a per-query mask and
    use_flash=False stay on xla_attention. Outputs agree either way."""
    calls = []
    real = TA.flash_attention
    monkeypatch.setattr(TA, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(TA, "_flash_ok", lambda q, k: TA.flash_shape_ok(
        q.shape[1], k.shape[1], q.shape[-1]))
    q, k, v, _, km = _inputs(2, 128, True, seed=3)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    pad = torch.from_numpy(km)[:, None, None, :]
    want = TA.xla_attention(q, k, v, mask=pad, causal=True)
    got = TA.scaled_dot_product_attention(q, k, v, mask=pad, causal=True)
    _close(got, want, atol=1e-5)
    assert len(calls) == 1
    TA.scaled_dot_product_attention(q, k, v, causal=True, use_flash=False)
    per_query = torch.ones((128, 128), dtype=torch.bool).tril()
    TA.scaled_dot_product_attention(q, k, v, mask=per_query)
    assert len(calls) == 1


def test_unported_options_raise():
    q = torch.zeros((1, 64, 2, 64))
    with pytest.raises(UnimplementedError, match="queue 2 item 1"):
        TA.flash_attention(q, q, q, segment_ids=torch.zeros((1, 64)))
    with pytest.raises(UnimplementedError, match="queue 2 item 1"):
        TA.scaled_dot_product_attention(q, q, q, dropout_p=0.1)


def test_wrappers_check_shapes():
    q = torch.zeros((1, 64, 4, 64))
    with pytest.raises(Exception, match="divisible by kv heads"):
        K.flash_attention_fwd(q, torch.zeros((1, 64, 3, 64)),
                              torch.zeros((1, 64, 3, 64)), causal=True,
                              scale=1.0)
    with pytest.raises(Exception, match="kv_mask"):
        K.flash_attention_fwd(q, q, q, causal=True, scale=1.0,
                              kv_mask=torch.ones((1, 32), dtype=torch.bool))


def _card_cases():
    """(B, Tq, Tk, H, Hkv, D, causal, window, kv_mask) on the card: the
    training shape, then each option the gate admits."""
    return [
        (8, 1024, 1024, 12, 4, 64, True, None, False),
        (2, 512, 512, 12, 4, 64, False, None, False),
        (2, 512, 512, 12, 12, 64, True, None, False),
        (2, 512, 512, 12, 1, 64, True, None, False),
        (2, 1024, 1024, 4, 2, 64, True, 256, False),
        (2, 512, 512, 4, 2, 64, False, 256, False),
        (3, 512, 512, 4, 2, 64, True, None, True),
        (2, 512, 1024, 4, 2, 64, True, None, False),
        (2, 256, 256, 4, 2, 128, True, None, True),
        (2, 256, 256, 4, 2, 256, True, 100, False),
    ]


def card_inputs(case, dtype, gen):
    """q, k, v, do, kv_mask for one case, on the card."""
    b, tq, tk, h, hkv, d, _, _, mask = case

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v = rand(b, tq, h, d), rand(b, tk, hkv, d), rand(b, tk, hkv, d)
    do = rand(b, tq, h, d)
    km = None
    if mask:
        km = torch.ones((b, tk), dtype=torch.bool, device="cuda")
        km[0, tk - 100:] = False       # a padded tail
        km[1, :] = False               # a row with no live key
    return q, k, v, do, km


def kernel_errors(case, dtype, gen):
    """Max abs difference, in float32, of o, lse, dq, dk, dv between each
    kernel and its plain version on the same inputs."""
    q, k, v, do, km = card_inputs(case, dtype, gen)
    kw = dict(causal=case[6], scale=case[5] ** -0.5, window=case[7],
              kv_mask=km)
    o, lse = K.flash_attention_fwd(q, k, v, **kw)
    o_p, lse_p = K.flash_attention_fwd_plain(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = K.flash_attention_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = K.flash_attention_dkv(q, k, v, do, lse, delta, **kw)
    dq_p = K.flash_attention_dq_plain(q, k, v, do, lse, delta, **kw)
    dk_p, dv_p = K.flash_attention_dkv_plain(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    return {name: (a.float() - b.float()).abs().max().item()
            for name, a, b in (("o", o, o_p), ("lse", lse, lse_p),
                               ("dq", dq, dq_p), ("dk", dk, dk_p),
                               ("dv", dv, dv_p))}


# float32: the forward's online softmax rescales in another order than
# the plain whole-row softmax (observed <= 1e-6; the backward recomputes
# from the same lse and agrees to 0); bfloat16, compared in float32: one
# bf16 rounding of an output of magnitude < 4 is up to 1.6e-2
CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for case in _card_cases():
        for dtype in (torch.float32, torch.bfloat16):
            n = (K.flash_attention_fwd.launches,
                 K.flash_attention_dq.launches,
                 K.flash_attention_dkv.launches)
            err = kernel_errors(case, dtype, gen)
            assert (K.flash_attention_fwd.launches,
                    K.flash_attention_dq.launches,
                    K.flash_attention_dkv.launches) == tuple(
                        x + 1 for x in n)
            print(case, dtype, {k: f"{e:.2e}" for k, e in err.items()})
            assert max(err.values()) <= CARD_TOL[dtype], (case, dtype, err)


@pytest.mark.gpu
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q = torch.zeros((1, 64, 2, 32), device="cuda")
    with pytest.raises(InvalidArgumentError, match="head_dim"):
        K.flash_attention_fwd(q, q, q, causal=True, scale=1.0)
    q = torch.zeros((1, 64, 2, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(InvalidArgumentError, match="float32 or bfloat16"):
        K.flash_attention_fwd(q, q, q, causal=True, scale=1.0)
