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

The float32 kernels run their products as "3xTF32" on the tensor
cores; ``test_split_tf32_products_keep_float32_accuracy`` models that
arithmetic on the CPU, the tensor core's truncating accumulate included,
and the card cases (the longest walk among them) check it.

The tests marked ``gpu`` hold the three CUDA kernels against their plain
versions on the card (float32 atol 1e-4, bfloat16 compared in float32
atol 2e-2; reasons at CARD_TOL), check that all three give the same bits
on every run and exact zeros (lse exactly -1e30) where no key is live,
that the forward copies rows that are not 16-byte aligned, and skip
here; JAX is imported only by
the tests that use it, so that it also runs where JAX is not installed:
``python3 -m pytest --noconftest -m gpu tests/test_torch_flash_attention.py``
(the suite's conftest imports JAX)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import EnforceError, InvalidArgumentError
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
    """Segment ids and dropout are ported (tests/test_torch_flash_options.py
    holds them against the Pallas kernels); what they refuse raises,
    typed, as the JAX package's checks do."""
    q = torch.zeros((1, 64, 2, 64))
    with pytest.raises(EnforceError, match="dropout_key"):
        TA.flash_attention(q, q, q, dropout_p=0.1)
    with pytest.raises(EnforceError, match="dropout_p must be in"):
        TA.flash_attention(q, q, q, dropout_p=1.0,
                           dropout_key=torch.Generator())
    with pytest.raises(EnforceError, match="segment_ids must be"):
        TA.flash_attention(q, q, q, segment_ids=torch.zeros((1, 32)))
    with pytest.raises(EnforceError, match="self-attention"):
        TA.scaled_dot_product_attention(q[:, :32], q, q,
                                        segment_ids=torch.zeros((1, 64)))
    with pytest.raises(EnforceError, match="torch.Generator"):
        TA.xla_attention(q, q, q, dropout_p=0.1, dropout_key=object())
    with pytest.raises(EnforceError, match="seeds"):
        K.flash_attention_fwd(q, q, q, causal=False, scale=1.0,
                              dropout_p=0.1)


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
    training shape, then each option the gate admits, query lengths that
    are not a multiple of the D=64 dq block's 128 rows (the last block
    runs short), and the training shape at four times the length (the
    longest walk: dk/dv sum over 3 x 4096 query rows)."""
    return [
        (8, 1024, 1024, 12, 4, 64, True, None, False),
        (2, 512, 512, 12, 4, 64, False, None, False),
        (2, 512, 512, 12, 12, 64, True, None, False),
        (2, 512, 512, 12, 1, 64, True, None, False),
        (2, 1024, 1024, 4, 2, 64, True, 256, False),
        (2, 512, 512, 4, 2, 64, False, 256, False),
        (3, 512, 512, 4, 2, 64, True, None, True),
        (2, 512, 1024, 4, 2, 64, True, None, False),
        (2, 192, 320, 4, 2, 64, True, None, False),
        (2, 192, 256, 4, 2, 64, False, None, False),
        (2, 64, 192, 4, 2, 64, True, None, False),
        (2, 64, 128, 4, 2, 64, False, None, True),
        (1, 4096, 4096, 12, 4, 64, True, None, False),
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
# the plain whole-row softmax and runs its products on the tensor cores
# (observed <= 1.9e-6). The backward pair sums
# in another order too (3xTF32 on the tensor cores, each 8-deep step
# rounded into its sum): on the card it is within 1.3e-5 of a float64
# reference in every case, where the plain version itself is up to
# 4.6e-5 from it (dv over 3 x 4096 query rows), and the two differ by up
# to 5.2e-5 (tools/torch_flash_accuracy.py). bfloat16, compared in
# float32: one bf16 rounding of an output of magnitude < 4 is up to
# 1.6e-2
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
    # rows that do not start on 16-byte boundaries (a head_dim slice of
    # wider rows, and a base one element off) are copied for the kernel's
    # 16-byte cp.async, not refused and not misread
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        wide = torch.randn((2, 128, 4, 72), generator=gen,
                           device="cuda").to(dtype)
        flat = torch.randn(2 * 128 * 2 * 64 + 1, generator=gen,
                           device="cuda").to(dtype)
        q = wide[..., :64]
        k = flat[1:].view(2, 128, 2, 64)
        v = torch.randn((2, 128, 2, 64), generator=gen,
                        device="cuda").to(dtype)
        o, lse = K.flash_attention_fwd(q, k, v, causal=True, scale=0.125)
        o_c, lse_c = K.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                           v, causal=True, scale=0.125)
        assert torch.equal(o, o_c) and torch.equal(lse, lse_c)
        o_p, _ = K.flash_attention_fwd_plain(q, k, v, causal=True,
                                             scale=0.125)
        assert (o.float() - o_p.float()).abs().max() <= CARD_TOL[dtype]


# ----- the float32 backward's arithmetic: 3xTF32 ---------------------------

def _tf32(x):
    """float32 -> the nearest TF32 value (10 stored significand bits),
    ties away from zero: the card's cvt.rna.tf32.f32."""
    x = np.asarray(x, np.float32)
    return ((x.view(np.int32) + 0x1000) & -0x2000).view(np.float32)


def _rz32(x):
    """float64 -> float32, rounded toward zero (held in float64)."""
    _, e = np.frexp(x)
    quantum = np.ldexp(1.0, e - 24)
    return np.trunc(x / quantum) * quantum


def _mma(c, prods):
    """One tensor-core accumulate c + sum(prods) over the last axis, as
    modelled here: the products are exact (a TF32 pair has 22 significand
    bits); they and the float32 accumulator are aligned to the largest
    exponent among them and truncated there to 24 bits, summed, and the
    sum is cut to float32 toward zero. NVIDIA does not document the
    accumulate, so this is an assumption (no extra alignment bits); the
    card cases are the check of it."""
    t = np.concatenate([c[..., None], prods], -1)
    _, e = np.frexp(np.abs(t).max(-1, keepdims=True))
    quantum = np.ldexp(1.0, e - 24)
    return _rz32((np.trunc(t / quantum) * quantum).sum(-1))


def _tf32_dot(a, b, passes, rounded_add=True):
    """Dot products over the last axis as the backward kernels take them:
    8-deep steps (m16n8k8). passes=3: lo.hi, hi.lo and hi.hi of the split
    x = hi + lo, hi = tf32(x), lo = tf32(x - hi); passes=1: one TF32
    product. rounded_add: each step's passes go into a zeroed fragment,
    added to the running sum with a float32 add rounded to nearest (the
    kernels' Mma::step, in every product); else every pass accumulates
    into the running sum on the tensor core."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    ah, bh, al, bl = (x.astype(np.float64) for x in (ah, bh, al, bl))
    pairs = [(al, bh), (ah, bl), (ah, bh)] if passes == 3 else [(ah, bh)]
    acc = np.zeros(a.shape[:-1])
    for i in range(0, a.shape[-1], 8):
        s = slice(i, i + 8)
        t = np.zeros_like(acc) if rounded_add else acc
        for x, y in pairs:
            t = _mma(t, x[..., s] * y[..., s])
        acc = np.float32(acc + t).astype(np.float64) if rounded_add else t
    return acc


def _sequential_dot(a, b):
    """The float32 sum the CUDA-core kernels took, one term at a time."""
    acc = np.zeros(a.shape[:-1], np.float32)
    for i in range(a.shape[-1]):
        acc = np.float32(acc + a[..., i] * b[..., i])
    return acc


@pytest.mark.parametrize("n", [64, 128, 256, 1024, 12288])
def test_split_tf32_products_keep_float32_accuracy(n):
    """The float32 backward's dots against float64, in the model above,
    on data shaped as the kernels see it: n = D (64/128/256) is a score
    q.k * D^-0.5 with unit normal q and k; n = 1024 a p-weighted sum over
    the keys (p >= 0 summing to 1 along the row, as dq = ds.k weighs
    them); n = 12288 dv's longest walk on the card, p^T.do over 3 heads x
    4096 query rows (row r sees r + 1 keys, so p of the key they share
    falls as 1/r). The kernels' scheme (3xTF32, each step added with a
    rounded add) stays within 1e-5, ten times inside the card tolerance
    CARD_TOL (1e-4), and no worse than twice the CUDA-core kernels'
    sequential float32 sum. Accumulating every pass on the tensor core
    drifts with each truncation (over three times the error here; on
    the card dv missed 1e-4 that way), and one TF32 pass leaves 1e-4
    (three decimal digits), which is why float32 takes three. The card
    cases, the longest walk among them, are the check of the model."""
    rng = np.random.default_rng(n)
    rows = 256 if n > 1024 else 2048
    a, b = rng.normal(size=(2, rows, n))
    if n == 1024:
        z = rng.normal(size=(rows, n)) * 2
        p = np.exp(z - z.max(-1, keepdims=True))
        a = a * p / p.sum(-1, keepdims=True)
    elif n > 1024:
        r = np.tile(np.arange(n // 3), 3)
        e = np.exp(rng.normal(size=(rows, n)))
        a = e / (e + r * np.exp(0.5))
    else:
        b = b * n ** -0.5
    a, b = a.astype(np.float32), b.astype(np.float32)
    want = (a.astype(np.float64) * b).sum(-1)

    def err(x):
        return np.abs(x - want).max()

    three = err(_tf32_dot(a, b, 3))
    direct = err(_tf32_dot(a, b, 3, rounded_add=False))
    one = err(_tf32_dot(a, b, 1))
    sequential = err(_sequential_dot(a, b))
    tol = CARD_TOL[torch.float32]
    assert three <= tol / 10, (three, tol)
    assert three <= 2 * sequential, (three, sequential)
    assert direct > 3 * three, (direct, three)
    assert one > tol, (one, tol)


def test_tf32_rounding_model():
    """The model's rounding: 10 stored bits, to nearest, ties away; and
    the accumulate's truncation toward zero."""
    x = np.array([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                  -(1.0 + 2 ** -11), 3.0 + 2 ** -12], np.float32)
    want = [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10), 3.0]
    assert _tf32(x).tolist() == want
    assert _rz32(np.array([1.0 + 2 ** -24, -(1.0 + 2 ** -24)])).tolist() \
        == [1.0, -1.0]
    # 1 + 2^-25 x 8: every product falls below the quantum of the sum's
    # largest term and is cut
    got = _mma(np.array([1.0]), np.full((1, 8), 2.0 ** -25))
    assert got.tolist() == [1.0]


# ----- the backward pair on the card --------------------------------------

def _backward(case, dtype, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q, k, v, do, km = card_inputs(case, dtype, gen)
    kw = dict(causal=case[6], scale=case[5] ** -0.5, window=case[7],
              kv_mask=km)
    o, lse = K.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return (q, k, v, do, lse, delta), kw


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_pair_gives_the_same_bits_every_run(dtype):
    """No atomics and a fixed order of sums: two launches on the same
    inputs give bit-identical o, lse, dq, dk and dv."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args, kw = _backward(_card_cases()[0], getattr(torch, dtype), seed=2)
    first = (*K.flash_attention_fwd(*args[:3], **kw),
             K.flash_attention_dq(*args, **kw),
             *K.flash_attention_dkv(*args, **kw))
    second = (*K.flash_attention_fwd(*args[:3], **kw),
              K.flash_attention_dq(*args, **kw),
              *K.flash_attention_dkv(*args, **kw))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_pair_is_exactly_zero_where_no_key_is_live(dtype):
    """Causal with Tq = 2 Tk: query rows 0..Tk-1 sit before every key;
    a kv_mask leaves batch row 1 with no live key and row 0 with a padded
    tail. The forward's o of those query rows is exactly 0 and their lse
    exactly -1e30; dq of those rows, and dk/dv of row 1 and of the padded
    keys, are exactly 0 (p = 0 there, so every term of their sums is)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    case = (2, 512, 256, 4, 2, 64, True, None, True)
    args, kw = _backward(case, getattr(torch, dtype), seed=3)
    o, lse = K.flash_attention_fwd(*args[:3], **kw)
    dq = K.flash_attention_dq(*args, **kw)
    dk, dv = K.flash_attention_dkv(*args, **kw)
    torch.cuda.synchronize()
    # the forward: o exactly 0 and lse exactly -1e30 on the dead rows
    for dead_o, dead_lse in ((o[:, :256], lse[:, :, :256]), (o[1], lse[1])):
        assert not dead_o.abs().max()
        assert torch.all(dead_lse == torch.tensor(K.NEG_INF,
                                                  dtype=torch.float32))
    assert o[0, 256:].abs().max() > 0 and lse[0, :, 256:].max() > -1e29
    assert not dq[:, :256].abs().max() and not dq[1].abs().max()
    for g in (dk, dv):
        assert not g[1].abs().max() and not g[0, 256 - 100:].abs().max()
    # and the live part is not trivially zero
    assert dq[0, 256:].abs().max() > 0 and dk[0, :100].abs().max() > 0
