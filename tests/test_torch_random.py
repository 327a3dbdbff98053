"""The port's global random stream (``core/random.py``) against the JAX
package's, bit for bit, on the CPU:

- ``seed``, ``next_key``, ``key_for`` and ``fold_in`` give the key data
  of ``jax.random`` (``make_key`` as ``jax.random.key`` with 64-bit mode
  off, as the JAX package runs);
- ``Layer.rng`` inside ``functional_call(rng=)`` folds the JAX
  package's keys, and outside one takes the stream's next key;
- after ``seed(s)`` and building the same model in both packages, a
  fresh Trainer's start key is the JAX Trainer's, for GPT, BERT, ResNet,
  MnistMLP, DeepFM, the Transformer NMT, ViT, GPT-moe, BERT-moe,
  SE-ResNeXt, StackedLSTM, the recommender, GPT with LoRA adapters
  (each adapter's key), and the NCE, HSigmoid and BilinearTensorProduct
  layers at tiny sizes: the port draws one key per parameter, in the
  JAX package's creation order; ``merge_lora`` moves the stream as the
  JAX merge does (its constant-initialised Linears draw one key per
  parameter and no random values). The JAX models are
  built with their initializers returning zeros (an eager initializer
  compiles a random kernel per shape, most of such a test's time); the
  keys are drawn before an initializer runs, so the stream moves the
  same.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import initializer as JI
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as JO
from paddle_tpu import parallel as JP
from paddle_tpu.core import dtypes as JDT
from paddle_tpu.core import random as JR
from paddle_tpu.models import bert as JB
from paddle_tpu.models import deepfm as JDF
from paddle_tpu.models import gpt as JG
from paddle_tpu.models import mnist as JM
from paddle_tpu.models import recommender as JREC
from paddle_tpu.models import resnet as JRN
from paddle_tpu.models import se_resnext as JSX
from paddle_tpu.models import stacked_lstm as JSL
from paddle_tpu.models import transformer as JNMT
from paddle_tpu.models import vit as JV
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.core import dtypes as TDT
from paddle_tpu_torch.core import random as TR
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.models import deepfm as TDF
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models import mnist as TM
from paddle_tpu_torch.models import recommender as TREC
from paddle_tpu_torch.models import resnet as TRN
from paddle_tpu_torch.models import se_resnext as TSX
from paddle_tpu_torch.models import stacked_lstm as TSL
from paddle_tpu_torch.models import transformer as TNMT
from paddle_tpu_torch.models import vit as TV
from paddle_tpu_torch.parallel import Trainer

SEEDS = [0, 7, 2 ** 31 + 5, 2 ** 40 + 3, -1]


@pytest.fixture(autouse=True)
def fresh_streams():
    pt.seed(0)
    ptt.seed(0)
    JDT.set_policy("float32")
    TDT.set_policy("float32")
    yield
    pt.seed(0)
    ptt.seed(0)


def _data(key):
    return np.asarray(jax.random.key_data(key))


@pytest.mark.parametrize("s", SEEDS)
def test_stream_is_jax_bit_for_bit(s):
    pt.seed(s)
    ptt.seed(s)
    assert ptt.core.get_seed() == pt.core.get_seed() == s
    np.testing.assert_array_equal(TR.make_key(s), _data(jax.random.key(s)))
    for n in (1, 3, 1, 2):
        j, t = JR.next_key(n), TR.next_key(n)
        if n == 1:
            j, t = [j], [t]
        assert len(t) == n
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b, _data(a))
    np.testing.assert_array_equal(TR.key_for("Linear.weight"),
                                  _data(JR.key_for("Linear.weight")))
    base_j, base_t = JR.next_key(), TR.next_key()
    np.testing.assert_array_equal(TR.key_for("Conv2D.bias", base_t),
                                  _data(JR.key_for("Conv2D.bias", base_j)))


@pytest.mark.parametrize("data", [0, 1, 12345, 2 ** 31 - 1, 2 ** 32 - 1])
def test_fold_in_is_jax_bit_for_bit(data):
    for s in (0, 3, 99):
        key = jax.random.key(s)
        np.testing.assert_array_equal(
            TR.fold_in(_data(key), data),
            _data(jax.random.fold_in(key, np.uint32(data))))
    crc = zlib.crc32(b"dropout") & 0x7FFFFFFF
    np.testing.assert_array_equal(
        TR.fold_in(TR.make_key(4), crc),
        _data(jax.random.fold_in(jax.random.key(4), crc)))


class _JKeys(jnn.Layer):
    def forward(self, x):
        return jnp.stack([jax.random.key_data(self.rng(t))
                          for t in ("default", "drop", "default")])


class _TKeys(tnn.Layer):
    def forward(self, x):
        return np.stack([self.rng(t) for t in ("default", "drop",
                                               "default")])


def test_layer_rng_folds_the_call_key_as_jax():
    jl, tl = _JKeys(), _TKeys()
    for s in (0, 11):
        jout, _ = jl.functional_call({}, 0, rng=jax.random.key(s))
        tout, _ = tl.functional_call({}, 0, rng=TR.make_key(s))
        np.testing.assert_array_equal(tout, np.asarray(jout))
    # without rng= the call key is key(0), as in the JAX package
    jout, _ = jl.functional_call({}, 0)
    tout, _ = tl.functional_call({}, 0)
    np.testing.assert_array_equal(tout, np.asarray(jout))
    # outside a functional call: the global stream's next key
    pt.seed(5)
    ptt.seed(5)
    np.testing.assert_array_equal(tl.rng("x"), _data(jl.rng("x")))
    np.testing.assert_array_equal(TR.next_key(), _data(JR.next_key()))


def test_create_parameter_draws_from_the_stream():
    """One key per parameter, generator or not; with none the values are
    the same for the same stream position and differ from another."""
    lin = tnn.Linear(4, 3, device="cpu")
    jnn.Linear(4, 3)
    np.testing.assert_array_equal(TR.next_key(), _data(JR.next_key()))
    ptt.seed(0)
    again = tnn.Linear(4, 3, device="cpu")
    other = tnn.Linear(4, 3, device="cpu")
    assert torch.equal(lin.weight, again.weight)
    assert not torch.equal(lin.weight, other.weight)
    ptt.seed(0)
    pt.seed(0)
    tnn.Linear(4, 3, device="cpu",
               generator=torch.Generator().manual_seed(1))
    jnn.Linear(4, 3)
    np.testing.assert_array_equal(TR.next_key(), _data(JR.next_key()))


GPT_CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
               num_kv_heads=2, intermediate_size=128, max_position=64)
GPT_MOE_CFG = dict(GPT_CFG, moe_experts=4)
BERT_CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2,
                intermediate_size=128, max_position=64)


def _deepfm_cfg(M):
    cfg = M.DeepFMConfig.tiny()
    cfg.embedding_axis = None
    return cfg


MODELS = {
    "gpt": (lambda: JG.GPTForCausalLM(JG.GPTConfig(**GPT_CFG)),
            lambda: TG.GPTForCausalLM(TG.GPTConfig(**GPT_CFG),
                                      device="cpu")),
    "bert": (lambda: JB.BertForPretraining(JB.BertConfig(**BERT_CFG)),
             lambda: TB.BertForPretraining(TB.BertConfig(**BERT_CFG),
                                           device="cpu")),
    "resnet20": (lambda: JRN.resnet20_cifar(),
                 lambda: TRN.resnet20_cifar(device="cpu")),
    "mnist_mlp": (lambda: JM.MnistMLP(32, 16),
                  lambda: TM.MnistMLP(32, 16, device="cpu")),
    "deepfm": (lambda: JDF.DeepFM(_deepfm_cfg(JDF)),
               lambda: TDF.DeepFM(_deepfm_cfg(TDF), device="cpu")),
    "nmt": (lambda: JNMT.TransformerNMT(JNMT.NMTConfig.tiny()),
            lambda: TNMT.TransformerNMT(TNMT.NMTConfig.tiny(),
                                        device="cpu")),
    "vit": (lambda: JV.ViT(JV.ViTConfig.tiny()),
            lambda: TV.ViT(TV.ViTConfig.tiny(), device="cpu")),
    "gpt_moe": (lambda: JG.GPTForCausalLM(JG.GPTConfig(**GPT_MOE_CFG)),
                lambda: TG.GPTForCausalLM(TG.GPTConfig(**GPT_MOE_CFG),
                                          device="cpu")),
    "bert_moe": (lambda: JB.BertForPretraining(JB.BertConfig.moe_smoke(2)),
                 lambda: TB.BertForPretraining(TB.BertConfig.moe_smoke(2),
                                               device="cpu")),
    "se_resnext": (lambda: JSX.SEResNeXt((1, 1, 1, 1), 10),
                   lambda: TSX.SEResNeXt((1, 1, 1, 1), 10, device="cpu")),
    "stacked_lstm": (lambda: JSL.StackedLSTM(64, 16, 16, 2),
                     lambda: TSL.StackedLSTM(64, 16, 16, 2, device="cpu")),
    "recommender": (lambda: JREC.RecommenderNet(),
                    lambda: TREC.RecommenderNet(device="cpu")),
    "gpt_lora": (lambda: _lora(JG.GPTForCausalLM(JG.GPTConfig(**GPT_CFG)),
                               jnn),
                 lambda: _lora(TG.GPTForCausalLM(TG.GPTConfig(**GPT_CFG),
                                                 device="cpu"), tnn)),
    "nce": (lambda: jnn.NCE(16, 50, sampler="log_uniform"),
            lambda: tnn.NCE(16, 50, sampler="log_uniform", device="cpu")),
    "hsigmoid": (lambda: jnn.HSigmoid(16, 50),
                 lambda: tnn.HSigmoid(16, 50, device="cpu")),
    "bilinear": (lambda: jnn.BilinearTensorProduct(4, 5, 6),
                 lambda: tnn.BilinearTensorProduct(4, 5, 6, device="cpu")),
}


def _lora(model, nn_mod):
    """``model`` with LoRA adapters on q_proj and v_proj (the JAX
    example's recipe): two keys per wrapped projection, lora_a then
    lora_b, in the walk order."""
    nn_mod.apply_lora(model, r=8, alpha=16, targets=("q_proj", "v_proj"))
    return model


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("s", [0, 42])
def test_fresh_trainer_key_is_the_jax_trainers(name, s, monkeypatch):
    def zeros(self, key, shape, dtype=jnp.float32):
        return jnp.zeros(shape, dtype)

    for cls in (JI.Constant, JI.Uniform, JI.Normal, JI.TruncatedNormal,
                JI.XavierUniform, JI.XavierNormal, JI.MSRA):
        monkeypatch.setattr(cls, "__call__", zeros)
    make_jax, make_port = MODELS[name]
    pt.seed(s)
    ptt.seed(s)
    jt = JP.Trainer(make_jax(), JO.SGD(0.1), lambda *a: None)
    tt = Trainer(make_port(), TO.SGD(0.1), lambda *a: None)
    np.testing.assert_array_equal(tt._key, _data(jt._rng))
    # and the streams stay together after the trainers
    np.testing.assert_array_equal(TR.next_key(), _data(JR.next_key()))


def test_lora_adapter_keys_and_the_merge_keep_the_streams_together(
        monkeypatch):
    """After seed(s), the same GPT and apply_lora: each adapter's
    initial values come from the JAX package's key for it (the port's
    generator seeded from key_for("LoRALinear.lora_a", key)), and after
    merge_lora both streams stand at the same key."""
    pt.seed(3)
    ptt.seed(3)
    jm = _lora(JG.GPTForCausalLM(JG.GPTConfig(**GPT_CFG)), jnn)
    tm = _lora(TG.GPTForCausalLM(TG.GPTConfig(**GPT_CFG), device="cpu"), tnn)
    np.testing.assert_array_equal(TR.next_key(), _data(JR.next_key()))
    # the keys each adapter drew: replay the stream from the seed
    ptt.seed(3)
    keys = []
    real = TR.next_key

    def spy(n=1):
        k = real(n)
        keys.append(k)
        return k

    monkeypatch.setattr("paddle_tpu_torch.nn.layer.next_key", spy)
    _lora(TG.GPTForCausalLM(TG.GPTConfig(**GPT_CFG), device="cpu"), tnn)
    monkeypatch.undo()
    a_keys = keys[-2 * 4::2]               # lora_a of each wrapped layer
    for key, (name, p) in zip(a_keys, [
            (n, p) for n, p in tm.named_parameters()
            if n.endswith("lora_a")]):
        gen = TR.seed_generator(torch.Generator(), TR.key_for(
            "LoRALinear.lora_a", key))
        want = torch.empty(p.shape).normal_(0.0, 0.02, generator=gen)
        assert torch.equal(p.detach(), want), name
    pt.seed(5)
    ptt.seed(5)
    jnn.merge_lora(jm)
    tnn.merge_lora(tm)
    np.testing.assert_array_equal(TR.next_key(), _data(JR.next_key()))
