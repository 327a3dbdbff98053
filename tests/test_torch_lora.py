"""LoRA (``nn/lora.py``) of the port against the JAX package's, on the
CPU, on ``GPTConfig.tiny()`` with the JAX weights carried across by name
(parameters and the frozen buffers, ``load_numpy_state``):

- ``apply_lora`` wraps the same paths; at init the adapted model is the
  base model bit for bit; the frozen weight and bias are buffers that
  do not require grad and stay in the state dict; the trainable
  parameters are the adapters plus the layers never wrapped;
- with adapters pushed off zero: logits within 2e-5 of the JAX
  model's, and the adapters' grads of the LM loss within 1e-5 of their
  largest JAX-gradient entry;
- four Adam(5e-3) steps on the adapters only, JAX's jitted
  value_and_grad against the port's Trainer with every other parameter
  frozen: losses and adapters within 2e-5; the frozen buffers bitwise
  unchanged; the Trainer holds no gradient and no optimizer state for
  a frozen weight; ``lora_b`` moved off zero;
- ``merge_lora``: the merged model's logits within 2e-5 of the adapted
  model's and of the JAX merged model's (the JAX test's bound), no
  LoRALinear and no adapter left, the merged weight in float32 cast to
  the weight's dtype;
- the policy read: one LoRALinear under ``mixed_bf16`` and
  ``bfloat16`` against the JAX one (outputs within 2e-2 relative to
  their scale, in the policy's output dtype);
- the typed errors the JAX test matches: "rank", "matched no" and
  "wraps nn.Linear".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as JO
from paddle_tpu.core import dtypes as JDT
from paddle_tpu.models import gpt as JG
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.core import dtypes as TDT
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.parallel import Trainer
from paddle_tpu_torch.utils.convert import load_numpy_state

TARGETS = ("q_proj", "v_proj")


@pytest.fixture(autouse=True)
def fresh_state():
    pt.seed(0)
    ptt.seed(0)
    JDT.set_policy("float32")
    TDT.set_policy("float32")
    yield
    JDT.set_policy("float32")
    TDT.set_policy("float32")


def _state(jm):
    flat = {k: np.asarray(v) for k, v in jm.named_parameters().items()}
    flat.update({k: np.asarray(v) for k, v in jm.named_buffers().items()})
    return flat


def _pair(r=4, targets=TARGETS, perturb=False):
    jm = JG.GPTForCausalLM(JG.GPTConfig.tiny()).eval()
    tm = TG.GPTForCausalLM(TG.GPTConfig.tiny(), device="cpu").eval()
    jp = jnn.apply_lora(jm, r=r, alpha=2 * r, targets=targets)
    tp = tnn.apply_lora(tm, r=r, alpha=2 * r, targets=targets)
    assert jp == tp
    if perturb:
        rng = np.random.default_rng(7)
        params = jm.named_parameters()
        for k in params:
            if k.endswith(("lora_a", "lora_b")):
                params[k] = params[k] + 0.05 * rng.normal(
                    size=params[k].shape).astype(np.float32)
        jm.set_parameters(params)
    load_numpy_state(tm, _state(jm))
    return jm, tm


def _ids(b=2, t=16, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (b, t)).astype(
        np.int32)


def test_init_is_exactly_the_base_model_and_the_base_is_frozen():
    tm = TG.GPTForCausalLM(TG.GPTConfig.tiny(), device="cpu").eval()
    ids = torch.from_numpy(_ids())
    base = tm(ids)
    before = dict(tm.named_parameters())
    paths = tnn.apply_lora(tm, r=4, targets=TARGETS)
    assert len(paths) == 4
    assert torch.equal(tm(ids), base)
    names = dict(tm.named_parameters())
    lp = tnn.lora_parameters(tm)
    assert len(lp) == 8 and all(k.endswith(("lora_a", "lora_b"))
                                for k in lp)
    assert set(names) == set(lp) | {k for k in before if not any(
        k.endswith(f"{t}.{w}") for t in TARGETS for w in ("weight", "bias"))}
    bufs = dict(tm.named_buffers())
    for p in paths:
        for w in ("weight", "bias"):
            key = f"{p}.{w}"
            if key in before:
                assert key in bufs and not bufs[key].requires_grad
                assert key in tm.state_dict()
                assert torch.equal(bufs[key], before[key].detach())


def test_adapted_logits_and_adapter_grads_match_jax():
    jm, tm = _pair(perturb=True)
    ids = _ids(seed=2)

    def jloss(lp):
        out, _ = jm.functional_call(lp, jnp.asarray(ids),
                                    method="forward_loss")
        return out

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jnn.lora_parameters(jm))
    np.testing.assert_allclose(tm(torch.from_numpy(ids)).detach().numpy(),
                               np.asarray(jm(jnp.asarray(ids))),
                               atol=2e-5, rtol=2e-5)
    tl = tm.forward_loss(torch.from_numpy(ids))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=1e-5)
    for k, p in tnn.lora_parameters(tm).items():
        want = np.asarray(jg[k])
        np.testing.assert_allclose(p.grad.numpy(), want,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)


def test_adapter_steps_match_jax_and_the_base_stays_frozen():
    jm, tm = _pair()
    ids = _ids(b=4, seed=1)
    opt = JO.Adam(5e-3)
    lp = jnn.lora_parameters(jm)
    st = opt.init(lp)

    @jax.jit
    def step(lp, st):
        def loss(p):
            out, _ = jm.functional_call(p, jnp.asarray(ids), training=True,
                                        method="forward_loss")
            return out

        l, g = jax.value_and_grad(loss)(lp)
        lp, st = opt.apply(lp, g, st)
        return l, lp, st

    lora = tnn.lora_parameters(tm)
    for name, p in tm.named_parameters():
        p.requires_grad_(name in lora)
    tr = Trainer(tm, TO.Adam(5e-3), lambda m, b, g: (m.forward_loss(b), {}))
    assert set(tr.params) == set(lora)
    frozen = {k: v.clone() for k, v in tm.state_dict().items()
              if k not in lora}
    losses = []
    for _ in range(4):
        jl, lp, st = step(lp, st)
        tl, _ = tr.train_step(torch.from_numpy(ids))
        np.testing.assert_allclose(float(tl), float(jl), atol=2e-5)
        losses.append(float(tl))
    assert losses[-1] < losses[0]
    for k, v in tr.params.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(lp[k]),
                                   atol=2e-5, err_msg=k)
    assert any(float(v.abs().max()) > 0 for k, v in tr.params.items()
               if k.endswith("lora_b"))
    for k, v in tm.state_dict().items():
        if k in frozen:
            assert torch.equal(v, frozen[k]), k
    for name, p in tm.named_parameters():
        if name not in lora:
            assert p.grad is None, name
    # Adam's state: one (m, v) per adapter, in sorted-name order
    leaves = tr.opt_state["leaf"]
    assert len(leaves) == len(lora)
    for (name, p), slot in zip(sorted(lora.items()), leaves):
        assert slot["m"].shape == slot["v"].shape == p.shape, name
    assert set(tr._buffers()) >= set(frozen)


def test_merge_matches_the_adapted_and_the_jax_merged_model():
    jm, tm = _pair(r=4, targets=None, perturb=True)
    ids = _ids(seed=3)
    want = tm(torch.from_numpy(ids)).detach()
    jmerged = jnn.merge_lora(jm)
    merged = tnn.merge_lora(tm)
    assert merged == jmerged
    assert not any(isinstance(m, tnn.LoRALinear) for m in tm.modules())
    assert not tnn.lora_parameters(tm)
    got = tm(torch.from_numpy(ids)).detach()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm(jnp.asarray(ids))),
                               atol=2e-5, rtol=2e-5)


def test_merged_weight_is_float32_then_the_weights_dtype():
    lin = tnn.Linear(8, 6, device="cpu", dtype="bfloat16")
    lo = tnn.LoRALinear(lin, r=2, alpha=4.0)
    with torch.no_grad():
        lo.lora_b.normal_()
    want = (lo.weight.float() + 2.0 * lo.lora_a @ lo.lora_b).to(
        torch.bfloat16)
    assert lo.merged_weight().dtype == torch.bfloat16
    assert torch.equal(lo.merged_weight(), want)
    assert lo.to_linear().weight.dtype == torch.bfloat16


@pytest.mark.parametrize("policy", ["mixed_bf16", "bfloat16"])
def test_policy_read_matches_jax(policy):
    jl = jnn.LoRALinear(jnn.Linear(16, 8, act="gelu"), r=4, alpha=8)
    tl = tnn.LoRALinear(tnn.Linear(16, 8, act="gelu", device="cpu"), r=4,
                        alpha=8)
    rng = np.random.default_rng(4)
    params = jl.named_parameters()
    params["lora_b"] = rng.normal(size=(4, 8)).astype(np.float32)
    jl.set_parameters(params)
    load_numpy_state(tl, _state(jl))
    x = rng.normal(size=(3, 16)).astype(np.float32)
    JDT.set_policy(policy)
    TDT.set_policy(policy)
    want = np.asarray(jl(jnp.asarray(x)).astype(jnp.float32))
    got = tl(torch.from_numpy(x))
    assert got.dtype == (torch.float32 if policy == "mixed_bf16"
                         else torch.bfloat16)
    np.testing.assert_allclose(got.float().detach().numpy(), want,
                               atol=2e-2 * np.abs(want).max())


def test_typed_errors():
    from paddle_tpu_torch.core import EnforceError

    tm = TG.GPTForCausalLM(TG.GPTConfig.tiny(), device="cpu")
    with pytest.raises(EnforceError, match="rank"):
        tnn.apply_lora(tm, r=0)
    with pytest.raises(EnforceError, match="matched no"):
        tnn.apply_lora(tm, r=2, targets=("no_such_proj",))
    with pytest.raises(EnforceError, match="wraps nn.Linear"):
        tnn.LoRALinear(tnn.RMSNorm(8, device="cpu"), r=2)
