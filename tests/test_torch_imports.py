"""Import hygiene and device rules of the port (paddle_tpu_torch):

- no module of the package, and not chip_smoke.py, imports jax, the
  JAX package or ml_dtypes (which comes with JAX: the checkpoint's
  bfloat16 leaves are viewed through torch);
- the package imports with no triton and no nvcc;
- with no CUDA, entry points called without ``device=`` raise a typed
  error instead of carrying on on the CPU (DeepFM and the sparse
  embedding, the NMT, its decoder layers and ViT too);
- on CPU tensors the kernel wrappers run their plain versions and their
  launch counters stay at 0 (an NMT training step and cached greedy
  decode among them)."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.core import (DeviceUnavailableError,
                                   KernelCompileError, resolve_device)
from paddle_tpu_torch import quant
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.mnist import MnistMLP
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import decode_attention as K
from paddle_tpu_torch.ops.kernels import flash_attention as FK
from paddle_tpu_torch.ops.kernels import quant_matmul as QM
from paddle_tpu_torch.serving import BatchedDecoder

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "paddle_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu", "ml_dtypes")
# the modules of the checkpoint-and-loop slice, each checked by name
RESILIENCE_SLICE = ("checkpoint", "train_loop", "resilience",
                    "resilience.faults", "resilience.integrity",
                    "resilience.preemption", "resilience.retry",
                    "utils.atomic", "core.config", "data.device_loader")
# the modules of the convolutional slice
CONV_SLICE = ("initializer", "ops.nn", "ops.math", "ops.tensor",
              "nn.layers", "models.mnist", "models.resnet", "quant.int8",
              "ops.kernels.quant_matmul")
# the modules of the foundation and DeepFM slice
DEEPFM_SLICE = ("core.random", "nn.layer", "nn.sparse", "optimizer.sparse",
                "ops.loss", "metrics", "models.deepfm", "parallel.api")
# the modules of the NMT and ViT slice
NMT_SLICE = ("nn.transformer", "ops.decode", "models.transformer",
             "models.vit", "models", "nn")
# the modules of the MoE, CNN-zoo and recurrent slice
MOE_ZOO_RNN_SLICE = ("nn.moe", "nn.rnn_layers", "ops.rnn", "ops.sequence",
                     "models.vgg", "models.alexnet", "models.googlenet",
                     "models.se_resnext", "models.stacked_lstm")
# the modules of the recommender, LoRA and op-library slice
OPS_LORA_SLICE = ("models.recommender", "nn.lora", "nn.sampling_layers",
                  "ops", "ops.tensor", "ops.math", "ops.reduction",
                  "ops.loss", "ops.sampling", "ops.sequence",
                  "ops.control_flow", "metrics")
# the modules of the slim slice and its surface gaps
SLIM_SLICE = ("slim", "slim.core", "slim.prune", "slim.distill",
              "quant.ops", "core.places", "core.enforce", "core",
              "data.bucketing", "data", "nn.layer")


# the int8 all-reduce and pipeline slice, and the rank-side job modules of
# the distributed tests (the ranks must never import JAX)
DIST_SLICE = ("quant.collectives", "parallel.pipeline", "parallel.hybrid",
              "parallel.plan", "utils.convert")
JOB_MODULES = ("torch_world.py", "torch_quant_jobs.py",
               "torch_pipeline_jobs.py", "torch_ckpt_jobs.py")
# the elastic multi-host slice
FLEET_SLICE = ("fleet", "launch", "resilience.controller", "checkpoint",
               "train_loop", "parallel.api", "embedding.host_table")


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, (path, bad)


def test_package_imports_without_triton_nvcc_or_jax():
    """Every module imports in a fresh interpreter with an empty PATH (no
    nvcc); neither triton nor jax gets imported."""
    code = (
        "import pkgutil, sys, paddle_tpu_torch\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "
        "'paddle_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [m for m in ('jax', 'paddle_tpu', 'triton', 'ml_dtypes') "
        "if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PATH": "", "PYTHONPATH": str(ROOT)},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr


@pytest.mark.parametrize("name", JOB_MODULES)
def test_rank_job_modules_are_jax_free(name):
    path = ROOT / "tests" / name
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert path.exists() and not bad, (name, bad)


@pytest.mark.parametrize("name", RESILIENCE_SLICE + CONV_SLICE
                         + DEEPFM_SLICE + NMT_SLICE + MOE_ZOO_RNN_SLICE
                         + OPS_LORA_SLICE + SLIM_SLICE + DIST_SLICE
                         + FLEET_SLICE)
def test_checkpoint_slice_modules_are_jax_free(name):
    path = PKG / (name.replace(".", "/") + ".py")
    if not path.exists():
        path = PKG / name.replace(".", "/") / "__init__.py"
    assert path in SOURCES
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, (name, bad)


def test_prefetcher_and_trainer_devices_without_cuda(no_cuda, tmp_path):
    """The prefetcher stages onto the card unless asked for the CPU; a
    checkpoint of CPU tensors needs no card."""
    from paddle_tpu_torch.checkpoint import restore_state, save_state
    from paddle_tpu_torch.data.device_loader import DevicePrefetcher

    with pytest.raises(DeviceUnavailableError):
        DevicePrefetcher([])
    assert DevicePrefetcher([], device="cpu").device.type == "cpu"
    save_state(str(tmp_path / "c"), {"x": torch.ones(2)})
    assert torch.equal(restore_state(str(tmp_path / "c"))["x"],
                       torch.ones(2))


def test_build_without_nvcc_raises_typed(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(KernelCompileError, match="nvcc"):
        _build.build("decode_attention")


def test_build_sources_and_hashed_library_path():
    for name in ("decode_attention", "flash_attention", "quant_matmul"):
        assert (_build.CSRC / f"{name}.cu").exists()
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"{name}-")
    with pytest.raises(KernelCompileError, match="no CUDA source"):
        _build.library_path("missing_kernel")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_without_cuda_raises(no_cuda):
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(DeviceUnavailableError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_model_without_device_raises_without_cuda(no_cuda):
    with pytest.raises(DeviceUnavailableError):
        TG.GPTForCausalLM(TG.GPTConfig.tiny())


def test_bert_without_device_raises_without_cuda(no_cuda):
    from paddle_tpu_torch.models import bert as TB

    cfg = TB.BertConfig.tiny()
    with pytest.raises(DeviceUnavailableError):
        TB.BertForPretraining(cfg)
    with pytest.raises(DeviceUnavailableError):
        TB.BertModel(cfg)
    model = TB.BertForPretraining(cfg, device="cpu")
    assert model.mlm_decoder.weight.device.type == "cpu"


def test_mnist_without_device_raises_without_cuda(no_cuda):
    with pytest.raises(DeviceUnavailableError):
        MnistMLP()
    assert MnistMLP(device="cpu").fc1.weight.device.type == "cpu"


def test_conv_models_without_device_raise_without_cuda(no_cuda):
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.models import resnet as TR
    from paddle_tpu_torch.models.mnist import MnistCNN

    for make in (MnistCNN, TR.resnet20_cifar,
                 lambda: tnn.Conv2D(3, 4, 3), lambda: tnn.BatchNorm(4)):
        with pytest.raises(DeviceUnavailableError):
            make()
    model = TR.resnet20_cifar(device="cpu")
    assert {b.device.type for b in model.buffers()} == {"cpu"}
    assert MnistCNN(device="cpu").conv1.weight.device.type == "cpu"


def test_deepfm_without_device_raises_without_cuda(no_cuda):
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.models import deepfm as TD

    cfg = TD.DeepFMConfig.tiny()
    cfg.embedding_axis = None
    for make in (lambda: TD.DeepFM(cfg),
                 lambda: tnn.Embedding(8, 4, is_sparse=True)):
        with pytest.raises(DeviceUnavailableError):
            make()
    model = TD.DeepFM(cfg, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_nmt_and_vit_without_device_raise_without_cuda(no_cuda):
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.models import transformer as TT
    from paddle_tpu_torch.models import vit as TV

    for make in (lambda: TT.TransformerNMT(TT.NMTConfig.tiny()),
                 lambda: TV.ViT(TV.ViTConfig.tiny()),
                 lambda: tnn.TransformerDecoder(1, 32, 4, 64),
                 lambda: tnn.PositionalEncoding(32)):
        with pytest.raises(DeviceUnavailableError):
            make()
    model = TT.TransformerNMT(TT.NMTConfig.tiny(), device="cpu")
    assert {t.device.type for t in model.state_dict().values()} == {"cpu"}
    assert TV.ViT(TV.ViTConfig.tiny(), device="cpu").pos_embed.is_cpu


def test_moe_zoo_and_rnn_without_device_raise_without_cuda(no_cuda):
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.models import (alexnet, bert, googlenet,
                                         se_resnext, stacked_lstm, vgg)

    moe_gpt = TG.GPTConfig.tiny()
    moe_gpt.moe_experts = 4
    for make in (lambda: TG.GPTForCausalLM(moe_gpt),
                 lambda: bert.BertForPretraining(bert.BertConfig.moe_smoke()),
                 lambda: tnn.SwitchFFN(8, 16, 4),
                 lambda: vgg.vgg16(10, image_size=32),
                 lambda: alexnet.alexnet(10),
                 lambda: googlenet.googlenet(10),
                 lambda: se_resnext.SEResNeXt((1, 1, 1, 1), 10),
                 lambda: stacked_lstm.StackedLSTM(64, 16, 16, 1),
                 lambda: tnn.LSTM(4, 8), lambda: tnn.GRU(4, 8),
                 lambda: tnn.LSTMCell(4, 8), lambda: tnn.GRUCell(4, 8)):
        with pytest.raises(DeviceUnavailableError):
            make()
    model = TG.GPTForCausalLM(moe_gpt, device="cpu")
    assert {t.device.type for t in model.state_dict().values()} == {"cpu"}
    model = stacked_lstm.StackedLSTM(64, 16, 16, 1, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_recommender_layers_and_creation_ops_raise_without_cuda(no_cuda):
    """The new entry points run on the card unless asked for the CPU:
    with no card and no ``device=`` they raise."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.models import recommender

    key = np.zeros(2, np.uint32)
    for make in (lambda: recommender.RecommenderNet(),
                 lambda: tnn.NCE(8, 20), lambda: tnn.HSigmoid(8, 20),
                 lambda: tnn.BilinearTensorProduct(2, 3, 4),
                 lambda: ops.fill_constant((2,), 1.0), lambda: ops.ones((2,)),
                 lambda: ops.zeros((2,)), lambda: ops.eye(2),
                 lambda: ops.linspace(0, 1, 3), lambda: ops.range(3),
                 lambda: ops.assign([1.0]),
                 lambda: ops.uniform_random((2,), key),
                 lambda: ops.gaussian_random((2,), key),
                 lambda: ops.truncated_gaussian_random((2,), key),
                 lambda: ops.sample_classes(key, (2,), 5),
                 lambda: ops.TensorArray(2, (3,))):
        with pytest.raises(DeviceUnavailableError):
            make()
    model = recommender.RecommenderNet(num_users=8, num_items=8,
                                       device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    gpt = TG.GPTForCausalLM(TG.GPTConfig.tiny(), device="cpu")
    tnn.apply_lora(gpt, r=2, targets=("q_proj",))
    assert {t.device.type for t in gpt.state_dict().values()} == {"cpu"}


def test_lora_gpt_on_cpu_takes_the_plain_versions_and_counts_nothing():
    """A LoRA-adapted GPT trains a step and, merged, serves paged on the
    CPU through the flash and decode wrappers' plain versions, counting
    no launch."""
    from paddle_tpu_torch import nn as tnn

    cfg = TG.GPTConfig(vocab_size=64, hidden_size=128, num_layers=1,
                       num_heads=2, num_kv_heads=1, intermediate_size=128,
                       max_position=128)
    model = TG.GPTForCausalLM(cfg, device="cpu")
    tnn.apply_lora(model, r=4, targets=("q_proj", "v_proj"))
    n = (K.decode_attention_paged.launches, FK.flash_attention_fwd.launches,
         FK.flash_attention_dq.launches, FK.flash_attention_dkv.launches)
    model.forward_loss(torch.randint(1, 64, (2, 64))).backward()
    tnn.merge_lora(model)
    dec = BatchedDecoder(model.eval(), slots=2, capacity=128, device="cpu",
                         pages=4, page_size=64)
    rid = dec.submit([1, 2, 3], 4)
    assert dec.run()[rid].shape == (4,)
    assert (K.decode_attention_paged.launches,
            FK.flash_attention_fwd.launches, FK.flash_attention_dq.launches,
            FK.flash_attention_dkv.launches) == n


def test_moe_gpt_on_cpu_takes_the_plain_versions_and_counts_nothing():
    """A MoE GPT's training step and arena run end to end on the CPU
    through the flash and decode wrappers' plain versions, counting no
    launch."""
    cfg = TG.GPTConfig(vocab_size=64, hidden_size=128, num_layers=1,
                       num_heads=2, num_kv_heads=1, intermediate_size=128,
                       max_position=128, moe_experts=4)
    model = TG.GPTForCausalLM(cfg, device="cpu")
    n = (K.decode_attention.launches, FK.flash_attention_fwd.launches,
         FK.flash_attention_dq.launches, FK.flash_attention_dkv.launches)
    model.forward_loss(torch.randint(1, 64, (2, 64))).backward()
    dec = BatchedDecoder(model.eval(), slots=2, capacity=128, device="cpu")
    rid = dec.submit([1, 2, 3], 4)
    assert dec.run()[rid].shape == (4,)
    assert (K.decode_attention.launches, FK.flash_attention_fwd.launches,
            FK.flash_attention_dq.launches,
            FK.flash_attention_dkv.launches) == n


def test_nmt_decode_on_cpu_takes_the_plain_versions_and_counts_nothing():
    """The NMT's training step and its cached greedy decode run end to
    end on the CPU through the flash and decode wrappers' plain versions,
    counting no launch."""
    from paddle_tpu_torch.models import transformer as TT

    cfg = TT.NMTConfig(src_vocab=64, tgt_vocab=64, d_model=128,
                       num_heads=2, num_encoder_layers=1,
                       num_decoder_layers=1, dim_feedforward=128,
                       dropout=0.0, max_len=64)
    model = TT.TransformerNMT(cfg, device="cpu")
    n = (K.decode_attention.launches, FK.flash_attention_fwd.launches,
         FK.flash_attention_dq.launches, FK.flash_attention_dkv.launches)
    src = torch.randint(3, 64, (2, 64))
    model.forward_fused_loss(src, src, src).backward()
    out = model.eval().greedy_decode_cached(src, max_len=4)
    assert out.shape == (2, 4)
    assert (K.decode_attention.launches, FK.flash_attention_fwd.launches,
            FK.flash_attention_dq.launches,
            FK.flash_attention_dkv.launches) == n


def test_int8_conv_on_cpu_takes_the_plain_version_and_counts_nothing():
    """A PTQ-swapped CNN (a plain, a strided and a grouped conv) runs end
    to end on the CPU through the plain quant_matmul, counting no
    launch."""
    from paddle_tpu_torch import nn as tnn

    n = QM.quant_matmul.launches
    model = tnn.Sequential(
        tnn.Conv2D(3, 8, 3, padding=1, act="relu", device="cpu"),
        tnn.Conv2D(8, 8, 3, stride=2, padding=1, device="cpu"),
        tnn.Conv2D(8, 4, 3, groups=2, data_format="NCHW", device="cpu"))
    q = quant.quantize_model(model)
    quant.calibrate(q, [torch.randn(2, 3, 8, 8)])
    assert quant.int8_swap(q, quant.freeze(q)) == 3
    assert q(torch.randn(2, 3, 8, 8)).shape == (2, 4, 2, 2)
    assert QM.quant_matmul.launches == n
    if not torch.cuda.is_available():
        assert n == 0


def test_decoder_without_device_raises_without_cuda(no_cuda):
    model = TG.GPTForCausalLM(TG.GPTConfig.tiny(), device="cpu")
    with pytest.raises(DeviceUnavailableError):
        BatchedDecoder(model, slots=2, capacity=64)
    dec = BatchedDecoder(model, slots=2, capacity=64, device="cpu")
    assert dec.device == torch.device("cpu")


def test_cpu_tensors_take_plain_versions_and_count_nothing():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 1, 4, 64)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 128, 2, 64)).astype(
        np.float32))
    pool = torch.from_numpy(rng.normal(size=(4, 64, 2, 64)).astype(
        np.float32))
    table = torch.tensor([[0, 1], [3, 2]], dtype=torch.int32)
    t = torch.tensor([5, 100], dtype=torch.int32)
    n = (K.decode_attention.launches, K.decode_attention_paged.launches)
    got = K.decode_attention(q, k, k, t, window=16)
    torch.testing.assert_close(got, K.decode_attention_plain(q, k, k, t, 16),
                               rtol=0, atol=0)
    got = K.decode_attention_paged(q, pool, pool, table, t)
    torch.testing.assert_close(
        got, K.decode_attention_paged_plain(q, pool, pool, table, t),
        rtol=0, atol=0)
    # a whole arena on the CPU goes through the wrappers without a launch
    model = TG.GPTForCausalLM(TG.GPTConfig(
        vocab_size=64, hidden_size=128, num_layers=1, num_heads=2,
        num_kv_heads=1, intermediate_size=128, max_position=128),
        device="cpu").eval()
    for kw in ({}, dict(pages=4, page_size=64)):
        dec = BatchedDecoder(model, slots=2, capacity=128, device="cpu",
                             **kw)
        rid = dec.submit([1, 2, 3], 4)
        assert dec.run()[rid].shape == (4,)
    # the three flash wrappers take their plain versions on CPU tensors,
    # and a training step of the model on the CPU launches nothing
    fn = (FK.flash_attention_fwd.launches, FK.flash_attention_dq.launches,
          FK.flash_attention_dkv.launches)
    kv = k[:, :128]
    kw = dict(causal=True, scale=0.125, window=None, kv_mask=None)
    qf = torch.from_numpy(rng.normal(size=(2, 128, 4, 64)).astype(
        np.float32))
    o, lse = FK.flash_attention_fwd(qf, kv, kv, **kw)
    want = FK.flash_attention_fwd_plain(qf, kv, kv, **kw)
    torch.testing.assert_close(o, want[0], rtol=0, atol=0)
    delta = (qf * o).sum(-1).transpose(1, 2).contiguous()
    torch.testing.assert_close(
        FK.flash_attention_dq(qf, kv, kv, qf, lse, delta, **kw),
        FK.flash_attention_dq_plain(qf, kv, kv, qf, lse, delta, **kw),
        rtol=0, atol=0)
    torch.testing.assert_close(
        FK.flash_attention_dkv(qf, kv, kv, qf, lse, delta, **kw),
        FK.flash_attention_dkv_plain(qf, kv, kv, qf, lse, delta, **kw),
        rtol=0, atol=0)
    model.train()
    model.forward_loss(torch.randint(1, 64, (2, 64))).backward()
    assert (K.decode_attention.launches,
            K.decode_attention_paged.launches) == n
    assert (FK.flash_attention_fwd.launches, FK.flash_attention_dq.launches,
            FK.flash_attention_dkv.launches) == fn
    if not torch.cuda.is_available():
        assert n == (0, 0) and fn == (0, 0, 0)


def test_version_and_exports():
    assert paddle_tpu_torch.__version__
    assert paddle_tpu_torch.resolve_device("cpu").type == "cpu"


def test_int8_paths_on_cpu_take_plain_versions_and_count_nothing():
    """The int8 decode and int8 matmul wrappers take their plain versions
    on CPU tensors; an int8 paged arena and a PTQ-swapped MnistMLP run
    end to end on the CPU with their launch counters unchanged."""
    n = (K.decode_attention_paged_quant.launches, QM.quant_matmul.launches,
         QM.quant_linear.launches)
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(2, 1, 4, 64)).astype(np.float32))
    kq = torch.from_numpy(rng.integers(-127, 128, (4, 64, 2, 64)).astype(
        np.int8))
    ks = torch.rand(4, 64, 2)
    table = torch.tensor([[0, 1], [3, 2]], dtype=torch.int32)
    t = torch.tensor([5, 100], dtype=torch.int32)
    torch.testing.assert_close(
        K.decode_attention_paged_quant(q, kq, ks, kq, ks, table, t),
        K.decode_attention_paged_quant_plain(q, kq, ks, kq, ks, table, t),
        rtol=0, atol=0)
    a = torch.from_numpy(rng.integers(-127, 128, (5, 9)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (9, 3)).astype(np.int8))
    assert torch.equal(QM.quant_matmul(a, b, 0.5, torch.ones(3)),
                       QM.quant_matmul_plain(a, b, 0.5, torch.ones(3)))
    model = TG.GPTForCausalLM(TG.GPTConfig(
        vocab_size=64, hidden_size=128, num_layers=1, num_heads=2,
        num_kv_heads=1, intermediate_size=128, max_position=128),
        device="cpu").eval()
    dec = BatchedDecoder(model, slots=2, capacity=128, device="cpu",
                         pages=4, page_size=64, kv_dtype="int8")
    rid = dec.submit([1, 2, 3], 4)
    assert dec.run()[rid].shape == (4,)
    mlp = quant.quantize_model(MnistMLP(16, 8, device="cpu"))
    quant.calibrate(mlp, [torch.randn(4, 784)])
    assert quant.int8_swap(mlp, quant.freeze(mlp)) == 3
    assert mlp(torch.randn(6, 784)).shape == (6, 10)
    assert (K.decode_attention_paged_quant.launches,
            QM.quant_matmul.launches, QM.quant_linear.launches) == n
    if not torch.cuda.is_available():
        assert n == (0, 0, 0)


def test_detection_entry_points_raise_without_cuda(no_cuda):
    """The detection slice's creation ops and layers run on the card
    unless asked for the CPU."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nn import layers

    for make in (lambda: ops.prior_box((2, 2), (8, 8), [4.0]),
                 lambda: ops.density_prior_box((2, 2), (8, 8), [4.0], [1.0],
                                               [1]),
                 lambda: ops.anchor_generator((2, 2), [4.0], [1.0],
                                              (4.0, 4.0)),
                 lambda: layers.MultiBoxHead([4, 4], 32, 3),
                 lambda: layers.SpectralNorm((3, 4))):
        with pytest.raises(DeviceUnavailableError):
            make()
    head = layers.MultiBoxHead([4, 4], 32, 3, device="cpu")
    assert {p.device.type for p in head.parameters()} == {"cpu"}
    boxes, _ = ops.prior_box((2, 2), (8, 8), [4.0], device="cpu")
    assert boxes.device.type == "cpu"
