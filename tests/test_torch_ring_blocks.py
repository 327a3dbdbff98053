"""Ring attention's hop entry points of the port
(paddle_tpu_torch/ops/kernels/flash_attention.py ``ring_fwd_block`` and
``ring_bwd_block``, their plain versions on CPU tensors) against the JAX
package's (paddle_tpu/ops/pallas/flash_attention.py, the Pallas kernels in
interpret mode, jitted): q-side and kv-side segment ids given apart,
rows with no live key in the block (from the ids and from a kv_mask),
a kv_mask, GQA, the diagonal causal block and a past one, delta given
and not. The backward takes the JAX forward's o and lse, as a ring hop
takes the merged ones. float32 at atol 1e-5. B=2, T=128, H=4, D=64.

The kernels against these plain versions on the card:
``chip_smoke.py`` ``[kernels:ring]``."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import EnforceError
from paddle_tpu_torch.ops.kernels import flash_attention as K

# the module (the package re-exports a function of the same name)
JF = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
ATOL = 1e-5
B, T, H, D = 2, 128, 4, 64
SCALE = D ** -0.5


def _ids(rng):
    """q-side and kv-side ids apart: row 0's queries in segment 3 find no
    key of theirs in the block (dead rows), row 1 shares its ids."""
    qseg = np.ones((B, T), np.int32)
    qseg[0, 40:80], qseg[0, 80:] = 2, 3
    kseg = np.ones((B, T), np.int32)
    kseg[0, :60], kseg[0, 60:] = 1, 2
    qseg[1] = kseg[1] = rng.integers(1, 3, T)
    kseg[1].sort()
    qseg[1].sort()
    return qseg, kseg


def _inputs(hkv, mask, segs, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(B, T, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(B, T, hkv, D)).astype(np.float32)
            for _ in range(2))
    kvm = None
    if mask:
        kvm = np.ones((B, T), bool)
        kvm[0, 100:] = False
        kvm[1, :] = False                # no live key in the whole row
    qseg, kseg = _ids(rng) if segs else (None, None)
    return q, k, v, kvm, qseg, kseg, do


@functools.lru_cache(maxsize=None)
def _jax_fns(causal):
    kw = dict(causal=causal, scale=SCALE, block_q=64, block_k=64,
              interpret=True)

    @jax.jit
    def fwd(q, k, v, kvm, qseg, kseg):
        return JF.ring_fwd_block(q, k, v, kvm, qseg, kseg, **kw)

    @jax.jit
    def bwd(q, k, v, kvm, qseg, kseg, o, lse, do, delta):
        return JF.ring_bwd_block(q, k, v, kvm, qseg, kseg, o, lse, do,
                                 delta=delta, **kw)

    return fwd, bwd


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("causal,hkv,mask,segs,with_delta", [
    (False, 4, False, False, False),
    (True, 4, False, False, True),
    (False, 2, True, False, False),
    (True, 2, False, True, True),
    (False, 4, True, True, False),
    (True, 1, True, True, False),
], ids=["plain", "diagonal-delta", "gqa-mask-dead", "diagonal-gqa-ids",
        "mask-ids", "diagonal-mqa-mask-ids"])
def test_ring_blocks_match_jax(causal, hkv, mask, segs, with_delta):
    q, k, v, kvm, qseg, kseg, do = _inputs(hkv, mask, segs, 3)
    fwd, bwd = _jax_fns(causal)
    j_args = [None if x is None else jnp.asarray(x)
              for x in (q, k, v, kvm, qseg, kseg)]
    j_o, j_lse = fwd(*j_args)
    t_args = [_t(x) for x in (q, k, v, kvm, qseg, kseg)]
    o, lse = K.ring_fwd_block(*t_args, causal=causal, scale=SCALE)
    _close(o, j_o)
    _close(lse, j_lse)
    if mask or segs:
        # the dead rows: o = 0 and lse at the finite -1e30
        dead = lse < -1e29
        assert bool(dead.any())
        assert float(o.permute(0, 2, 1, 3)[dead].abs().max()) == 0.0
    delta = (np.asarray(j_o) * do).sum(-1) if with_delta else None
    j_grads = bwd(*j_args, j_o, j_lse, jnp.asarray(do),
                  None if delta is None else jnp.asarray(delta))
    grads = K.ring_bwd_block(*t_args, _t(j_o), _t(j_lse), _t(do),
                             causal=causal, scale=SCALE, delta=_t(delta))
    for got, want in zip(grads, j_grads):
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want)
    assert K.ring_fwd_block.launches == K.ring_bwd_block.launches == 0


def test_one_id_array_serves_both_sides():
    """With one array on both sides the hop is the single-device flash
    call: kv_segment_ids = segment_ids changes nothing."""
    q, k, v, _, qseg, _, do = _inputs(4, False, True, 5)
    tq, tk, tv, ts = (_t(x) for x in (q, k, v, qseg))
    o, lse = K.ring_fwd_block(tq, tk, tv, None, ts, ts, causal=True,
                              scale=SCALE)
    o1, lse1 = K.flash_attention_fwd(tq, tk, tv, causal=True, scale=SCALE,
                                     segment_ids=ts)
    assert torch.equal(o, o1) and torch.equal(lse, lse1)


def test_ring_blocks_refuse_what_the_kernels_refuse():
    q, k, v, _, qseg, kseg, _ = _inputs(4, False, True, 6)
    tq, tk, tv = (_t(x) for x in (q, k, v))
    with pytest.raises(EnforceError, match="both segment id arrays"):
        K.ring_fwd_block(tq, tk, tv, None, _t(qseg), None, causal=False,
                         scale=SCALE)
    with pytest.raises(EnforceError, match="kv_segment_ids must be"):
        K.ring_fwd_block(tq, tk, tv, None, _t(qseg), _t(kseg[:, :64]),
                         causal=False, scale=SCALE)
    with pytest.raises(EnforceError, match="float32 or bfloat16"):
        K.ring_fwd_block(tq.double(), tk.double(), tv.double(), None, None,
                         None, causal=False, scale=SCALE)
    with pytest.raises(EnforceError, match="only when Tq == Tk"):
        K.flash_attention_fwd(tq, tk[:, :64], tv[:, :64], causal=False,
                              scale=SCALE, segment_ids=_t(qseg))

