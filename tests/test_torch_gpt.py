"""The port's GPT (paddle_tpu_torch/models/gpt.py) against the JAX one on
the same weights, crossed with load_numpy_state: a head_dim-64 config
(vocab 512, hidden 256, 4 heads over 2 kv heads, 2 layers, SwiGLU 512,
max_position 128), float32 on the CPU, logits at atol 1e-4. The JAX
decode steps run under force_flash, so they reach the Pallas decode
kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import gpt as JG
from paddle_tpu.ops import attention as JA
from paddle_tpu_torch.core import InvalidArgumentError
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.utils.convert import load_numpy_state

ATOL = 1e-4
CFG = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
           num_kv_heads=2, intermediate_size=512, max_position=128)


def _pair(seed=0, **over):
    cfg = dict(CFG, **over)
    pt.seed(seed)
    jm = JG.GPTForCausalLM(JG.GPTConfig(**cfg)).eval()
    tm = TG.GPTForCausalLM(TG.GPTConfig(**cfg), device="cpu").eval()
    load_numpy_state(tm, {k: np.asarray(v)
                          for k, v in jm.named_parameters().items()})
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _ids(shape, seed):
    return np.random.default_rng(seed).integers(1, 512, shape).astype(
        np.int32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=0)


def test_parameter_names_and_layouts_match(pair):
    jm, tm = pair
    jp = {k: tuple(v.shape) for k, v in jm.named_parameters().items()}
    tp = {k: tuple(v.shape) for k, v in tm.named_parameters()}
    assert jp == tp
    assert "blocks.1.self_attn.q_proj.weight" in tp
    assert tp["blocks.0.ffn.gate.weight"] == (256, 512)    # (in, out)


@pytest.mark.parametrize("window", [None, 5])
def test_forward_logits(window):
    jm, tm = _pair(1, attn_window=window)
    ids = _ids((2, 16), 2)
    with torch.inference_mode():
        got = tm(torch.from_numpy(ids))
    _close(got, jm(jnp.asarray(ids)))


@pytest.mark.parametrize("t_rows", [(16, 9, 12), (15, 0, 1)])
def test_chunk_then_step_rows(pair, t_rows):
    """Prefill (B, 16) with _chunk_logits, then one _step_logits_rows
    position per row at its own cursor through the decode kernel path."""
    jm, tm = pair
    ids = _ids((3, 16), 3)
    tok = _ids((3,), 4)
    t_rows = np.asarray(t_rows, np.int32)
    cap = 64
    j_caches = [blk.self_attn.init_cache(3, cap) for blk in jm.blocks]
    j_chunk, j_caches = jm._chunk_logits(jnp.asarray(ids), j_caches, 0)
    with JA.force_flash():
        j_step, _ = jm._step_logits_rows(jnp.asarray(tok), j_caches,
                                         jnp.asarray(t_rows),
                                         decode_kernel=True)
    with torch.inference_mode():
        t_caches = [blk.self_attn.init_cache(3, cap) for blk in tm.blocks]
        t_chunk, t_caches = tm._chunk_logits(torch.from_numpy(ids),
                                             t_caches, 0)
        t_step, t_caches = tm._step_logits_rows(
            torch.from_numpy(tok), t_caches, torch.from_numpy(t_rows),
            decode_kernel=True)
    _close(t_chunk, j_chunk)
    _close(t_step, j_step)


def _agree_up_to_near_ties(got, want, ref_logits, tp):
    """Tokens equal up to the first mismatch, and that mismatch (if any)
    sits where the JAX logits' top-2 gap is below 1e-4 (a near tie that
    either framework may break either way)."""
    for b in range(want.shape[0]):
        diff = np.nonzero(got[b] != want[b])[0]
        if len(diff) == 0:
            continue
        i = diff[0]
        assert i >= tp, (b, i)
        top2 = np.sort(ref_logits[b, i - 1])[-2:]
        assert top2[1] - top2[0] < 1e-4, (b, i, top2)


def test_greedy_decode_tokens(pair):
    jm, tm = pair
    prompt = _ids((2, 6), 5)
    with JA.force_flash():
        want = np.asarray(jm.greedy_decode(jnp.asarray(prompt), 40))
    got = tm.greedy_decode(torch.from_numpy(prompt), 40).numpy()
    ref = np.asarray(jm(jnp.asarray(want)))
    assert got.shape == want.shape == (2, 40)
    _agree_up_to_near_ties(got, want, ref, 6)


def test_generate_sampled_needs_generator(pair):
    _, tm = pair
    with pytest.raises(Exception, match="torch.Generator"):
        tm.generate(torch.from_numpy(_ids((1, 4), 6)), 8, temperature=1.0)
    gen = torch.Generator().manual_seed(0)
    out = tm.generate(torch.from_numpy(_ids((1, 4), 6)), 8,
                      generator=gen, temperature=1.0, top_k=5)
    assert out.shape == (1, 8)


@pytest.mark.parametrize("over,item", [
    (dict(moe_experts=4), "item 9"),
    (dict(seq_parallel="ring"), "item 11"),
])
def test_later_slice_configs_raise(over, item):
    """Options of earlier queue items, ported since: the Switch-MoE FFN
    (item 9): a MoE GPT's logits match the JAX model's (its training,
    serving and remat error: tests/test_torch_moe.py); ``seq_parallel``
    (item 11): with no mesh the ring is one hop, and the logits match the
    JAX model's on its one-device mesh (the sharded runs:
    tests/test_torch_seq_parallel.py)."""
    from paddle_tpu.core.mesh import mesh_scope

    jm, tm = _pair(**over)
    ids = _ids((2, 12) if "moe_experts" in over else (2, 64), 9)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long())
    # the JAX ring runs over the current mesh: pin the one-device mesh
    # (an earlier test may have left a larger one current)
    with mesh_scope(pt.build_mesh(dp=1, devices=jax.devices()[:1])):
        want = jm(jnp.asarray(ids))
    _close(got, want)
    if "moe_experts" in over:
        assert [n for n, _ in tm.named_buffers()][:3] == [
            "blocks.0.ffn.aux_loss", "blocks.0.ffn.router_z_loss",
            "blocks.0.ffn.kept_fraction"]


def test_load_numpy_state_checks_names_and_shapes(pair):
    jm, tm = pair
    flat = {k: np.asarray(v) for k, v in jm.named_parameters().items()}
    bad = dict(flat)
    bad.pop("norm_f.weight")
    with pytest.raises(InvalidArgumentError, match="norm_f.weight"):
        load_numpy_state(tm, bad)
    bad = dict(flat)
    bad["embed.weight"] = bad["embed.weight"].T
    with pytest.raises(InvalidArgumentError, match="embed.weight"):
        load_numpy_state(tm, bad)
