"""The flash-attention options of the port: packed-row segment ids and
attention dropout (paddle_tpu_torch/ops/attention.py over
ops/kernels/flash_attention.py).

- The dropout hash: the port's ``dropout_keep`` against the TPU kernels'
  ``_dropout_keep`` (paddle_tpu/ops/pallas/flash_attention.py), exactly,
  for seeds at both ends of int32, block offsets away from 0 and p in
  {0.1, 0.5, 0.9}, on 256 x 256 blocks.
- The plain kernel versions, through the port's ``flash_attention`` and
  its autograd, against the JAX ``flash_attention(..., interpret=True)``
  (the Pallas _fwd_kernel, _dq_kernel and _dkv_kernel in interpret
  mode) and its ``jax.vjp``: segments with causal, window, kv_mask and
  GQA; dropout, with the seeds the JAX call draws
  (``jax.random.randint(key, (b, h), -2**31, 2**31 - 1)``) handed to the
  port; everything together, as ``test_flash_all_features_compose`` in
  tests/test_pallas_attention.py. o and dq/dk/dv at atol 2e-5 (the same
  float32 math in another summation order, as in
  test_torch_flash_attention.py). B=2, T=128, H=4, D=64.
- ``xla_attention`` and ``scaled_dot_product_attention`` with segment
  ids against the JAX ``xla_attention`` at 1e-5; under dropout the
  plain path and the flash path compute one function from one
  generator seed.
- The ctypes layout guard, with a stand-in library.

The tests marked ``gpu`` hold the three CUDA kernels against their plain
versions on the card with segments, dropout at p 0.1 and 0.5, and both
with a kv_mask, causal and not, GQA, float32 (atol 1e-4) and bfloat16
(compared in float32, atol 2e-2), D 64 and 128; they skip here:
``python3 -m pytest --noconftest -m gpu tests/test_torch_flash_options.py``
(JAX is imported only inside the tests that use it)."""

import ctypes

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import KernelLaunchError
from paddle_tpu_torch.ops import attention as TA
from paddle_tpu_torch.ops.kernels import flash_attention as K

ATOL = 2e-5
B, T, H, D = 2, 128, 4, 64


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=0)


def _segments():
    """Packed rows: three documents and a padding tail (segment 0) in row
    0, two documents filling row 1."""
    seg = np.zeros((B, T), np.int32)
    seg[0, :40], seg[0, 40:90], seg[0, 90:120] = 1, 2, 3
    seg[1, :77], seg[1, 77:] = 1, 2
    return seg


def _inputs(hkv, mask, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, hkv, D)).astype(np.float32)
    ct = rng.normal(size=(B, T, H, D)).astype(np.float32)
    km = None
    if mask:
        km = np.ones((B, T), bool)
        km[0, 100:] = False
        km[1, 60:70] = False
    return q, k, v, ct, km


# ----- the hash ------------------------------------------------------------

@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("seed", [0, 123, -1, -2 ** 31 + 1, 2 ** 31 - 2])
def test_dropout_keep_is_bit_identical_to_the_tpu_hash(seed, p):
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas.flash_attention import _dropout_keep

    for row0, col0 in ((0, 0), (128, 256), (1000, 37), (2 ** 20, 3)):
        want = np.asarray(_dropout_keep(jnp.int32(seed), row0, col0, 256,
                                        256, p))
        got = K.dropout_keep(seed, row0, col0, 256, 256, p).numpy()
        np.testing.assert_array_equal(got, want)
    assert abs(got.mean() - (1 - p)) < 5 * np.sqrt(p * (1 - p) / got.size)


# ----- the plain versions against Pallas interpret ------------------------

def _jax_seeds(key, h=H):
    import jax
    import jax.numpy as jnp

    return np.array(jax.random.randint(key, (B, h), -2 ** 31, 2 ** 31 - 1,
                                       dtype=jnp.int32))


def _against_pallas(monkeypatch, hkv, causal, window, mask, segs,
                    dropout_p, seed):
    """Port and JAX flash attention on the same inputs (and, under
    dropout, the same seeds): o and the grads of (o * ct).sum()."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas.flash_attention import flash_attention

    q, k, v, ct, km = _inputs(hkv, mask, seed)
    seg = _segments() if segs else None
    key = jax.random.PRNGKey(seed)
    jkw = dict(causal=causal, window=window, interpret=True,
               kv_mask=None if km is None else jnp.asarray(km),
               segment_ids=None if seg is None else jnp.asarray(seg),
               dropout_p=dropout_p, dropout_key=key if dropout_p else None)
    want, vjp = jax.vjp(lambda q, k, v: flash_attention(q, k, v, **jkw),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(ct))
    seeds = torch.from_numpy(_jax_seeds(key))
    monkeypatch.setattr(TA, "_dropout_seeds", lambda gen, b, h, dev: seeds)
    tq_, tk_, tv_ = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = TA.flash_attention(
        tq_, tk_, tv_, causal=causal, window=window,
        kv_mask=None if km is None else torch.from_numpy(km),
        segment_ids=None if seg is None else torch.from_numpy(seg),
        dropout_p=dropout_p,
        dropout_key=torch.Generator() if dropout_p else None)
    (got * torch.from_numpy(ct)).sum().backward()
    _close(got.detach(), want)
    for g, w in zip((tq_.grad, tk_.grad, tv_.grad), want_grads):
        _close(g, w)
    return got.detach()


# (kv heads, causal, window, kv_mask)
SEG_CASES = [
    (4, False, None, False),
    (4, True, None, False),
    (2, False, 48, False),
    (1, True, None, True),
]


@pytest.mark.parametrize("hkv,causal,window,mask", SEG_CASES)
def test_segments_match_pallas(monkeypatch, hkv, causal, window, mask):
    got = _against_pallas(monkeypatch, hkv, causal, window, mask, True, 0.0,
                          seed=hkv + 10 * causal)
    # a query never reads another document: position 0's output is built
    # from segment 1's values only, so it differs from the unpacked row's
    seg = torch.from_numpy(_segments())
    q, k, v, _, _ = (None if x is None else torch.from_numpy(x)
                     for x in _inputs(hkv, False, 3))
    alone = TA.flash_attention(q[:, :40], k[:, :40], v[:, :40])
    packed = TA.flash_attention(q, k, v, segment_ids=seg)
    _close(packed[0, :40], alone[0], atol=1e-5)
    assert got.shape == (B, T, H, D)


# (kv heads, causal, p)
DROP_CASES = [(4, False, 0.1), (4, True, 0.5), (2, False, 0.1)]


@pytest.mark.parametrize("hkv,causal,p", DROP_CASES)
def test_dropout_matches_pallas(monkeypatch, hkv, causal, p):
    _against_pallas(monkeypatch, hkv, causal, None, False, False, p,
                    seed=hkv + int(10 * p))


def test_all_features_compose(monkeypatch):
    """Segments, dropout, a kv_mask and causal together, with GQA."""
    _against_pallas(monkeypatch, 2, True, None, True, True, 0.1, seed=21)


# ----- the plain path -----------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_xla_and_sdpa_with_segments_match_jax(monkeypatch, causal):
    import jax.numpy as jnp

    from paddle_tpu.ops import attention as JA

    q, k, v, _, km = _inputs(2, True, 5)
    seg = _segments()
    pad = km[:, None, None, :]
    want = JA.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            mask=jnp.asarray(pad), causal=causal,
                            segment_ids=jnp.asarray(seg))
    tq_, tk_, tv_ = (torch.from_numpy(x) for x in (q, k, v))
    kw = dict(mask=torch.from_numpy(pad), causal=causal,
              segment_ids=torch.from_numpy(seg))
    _close(TA.xla_attention(tq_, tk_, tv_, **kw), want, atol=1e-5)
    # the flash route, with the gate open as on the card
    calls = []
    real = TA.flash_attention
    monkeypatch.setattr(TA, "_flash_ok", lambda q, k: True)
    monkeypatch.setattr(TA, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _close(TA.scaled_dot_product_attention(tq_, tk_, tv_, **kw), want,
           atol=1e-5)
    assert calls == [1]


def test_plain_path_and_flash_path_drop_the_same_entries(monkeypatch):
    """Under dropout, xla_attention and flash_attention draw the same
    seeds from generators seeded alike and hash them the same way: one
    function, so the card's check steps can compare them."""
    q, k, v, _, _ = (None if x is None else torch.from_numpy(x)
                     for x in _inputs(2, False, 6))
    seg = torch.from_numpy(_segments())

    def gen():
        return torch.Generator().manual_seed(11)

    plain = TA.xla_attention(q, k, v, causal=True, segment_ids=seg,
                             dropout_p=0.2, dropout_key=gen())
    flash = TA.flash_attention(q, k, v, causal=True, segment_ids=seg,
                               dropout_p=0.2, dropout_key=gen())
    undropped = TA.flash_attention(q, k, v, causal=True, segment_ids=seg)
    _close(flash, plain, atol=1e-5)
    assert (flash - undropped).abs().max() > 0.1
    # the generator advanced by one (B, H) draw in each
    g = gen()
    TA._dropout_seeds(g, B, H, "cpu")
    g2 = gen()
    TA.flash_attention(q, k, v, dropout_p=0.2, dropout_key=g2)
    assert torch.equal(g.get_state(), g2.get_state())


# ----- the ctypes layout guard --------------------------------------------

class _FakeLib:
    def __init__(self, size):
        self.pt_flash_args_size = lambda: size


def test_layout_guard_refuses_a_struct_of_another_size():
    K._check_layout(_FakeLib(ctypes.sizeof(K._FlashArgs)))
    with pytest.raises(KernelLaunchError, match="ctypes mirror"):
        K._check_layout(_FakeLib(ctypes.sizeof(K._FlashArgs) - 8))
    # the struct carries the segment, seed and dropout fields
    names = [n for n, _ in K._FlashArgs._fields_]
    assert {"seg", "seeds", "dropout_p", "dropout_scale"} <= set(names)


# ----- the CUDA kernels on the card ---------------------------------------

def card_option_cases():
    """(B, T, H, Hkv, D, causal, segments, dropout_p, kv_mask) on the
    card: segments, dropout at 0.1 and 0.5, and both with a kv_mask,
    causal and not, GQA, D 64 and 128; the first is BERT's shape."""
    return [
        (32, 128, 12, 12, 64, False, True, 0.1, False),
        (4, 256, 12, 4, 64, True, True, 0.0, False),
        (4, 256, 12, 12, 64, False, False, 0.5, False),
        (4, 256, 12, 4, 64, True, False, 0.1, False),
        (4, 192, 8, 2, 64, False, True, 0.1, True),
        (3, 256, 8, 2, 128, True, True, 0.5, True),
    ]


def card_option_inputs(case, dtype, gen):
    """q, k, v, do and the option tensors of one case, on the card."""
    b, t, h, hkv, d, _, segs, p, mask = case

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v, do = (rand(b, t, h, d), rand(b, t, hkv, d), rand(b, t, hkv, d),
                   rand(b, t, h, d))
    seg = km = seeds = None
    if segs:
        # documents of 16-t tokens packed into each row, a padding tail
        lens = torch.randint(16, t + 1, (b, t), generator=gen,
                             device="cuda")
        ends = torch.cumsum(lens, 1)
        pos = torch.arange(t, device="cuda")
        seg = (pos[None, :, None] >= ends[:, None, :]).sum(-1) + 1
        seg[:, t - 5:] = 0
        seg = seg.to(torch.int32)
    if mask:
        km = torch.ones((b, t), dtype=torch.bool, device="cuda")
        km[0, t - 50:] = False
    if p:
        seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (b, h), generator=gen,
                              device="cuda", dtype=torch.int32)
    kw = dict(causal=case[5], scale=d ** -0.5, kv_mask=km, segment_ids=seg,
              seeds=seeds, dropout_p=p)
    return q, k, v, do, kw


def option_errors(case, dtype, gen):
    """Max abs difference, in float32, of o, lse, dq, dk, dv between each
    kernel and its plain version on the same inputs and seeds."""
    q, k, v, do, kw = card_option_inputs(case, dtype, gen)
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


# float32 and bfloat16 as test_torch_flash_attention.py's CARD_TOL: the
# mask changes which entries count, not the arithmetic
CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.gpu
def test_cuda_kernels_with_segments_and_dropout_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for case in card_option_cases():
        for dtype in (torch.float32, torch.bfloat16):
            err = option_errors(case, dtype, gen)
            print(case, dtype, {k: f"{e:.2e}" for k, e in err.items()})
            assert max(err.values()) <= CARD_TOL[dtype], (case, dtype, err)
