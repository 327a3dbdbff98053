#!/usr/bin/env python3
"""Where a training step of the port spends its time, on the CUDA card,
under Trainer with Adam(1e-3) and the mixed-precision policy ``--amp``
(float32 by default; TF32 off, and half-precision matmuls reduce in
float32). ``--model``:

- ``gpt`` (the default): bench_gpt's configuration (bench.py:411-440),
  GPTConfig.small() with remat, max_position 1024, seeded random
  weights, one (8, 1024) batch of seeded ids;
- ``bert_base``: BERT-base pretraining (bench.py:354), BertConfig.base()
  with dropout 0.1, seeded weights, one (32, 128) batch as bench.py
  makes it (numpy seed 0), forward_fused_loss (MLM + NSP);
- ``bert_packed``: the same model over rows pack_sequences fills with
  documents of 16-128 tokens (bench.py:560), forward_packed_loss with
  their segment ids;
- ``resnet50`` and ``resnet50_nchw``: BASELINE config 2 as bench.py
  runs it (:327-352), resnet50(1000) in NHWC (the bench's layout) or
  NCHW, seeded weights, one (128, 3, 224, 224) batch of seeded images,
  all-zero labels; it prints images/s where the others print tokens/s;
- ``deepfm`` and ``deepfm_sparse``: BASELINE config 5 as bench.py runs
  it (:2197-2226 bench_deepfm, dense updates through Trainer; :2106-2194
  bench_deepfm_sparse, row-sparse updates through sparse_minimize_fn):
  26 fields, 13 dense features, embed 16, tower (400, 400, 400), batch
  4096, the stream seeded 0, ids uniform over the vocab (numpy seed 0),
  labels ids[:, 0] % 2, at each vocab of ``--vocab``; it prints
  examples/s;
- ``nmt``: the Transformer NMT, BASELINE config 4 as bench.py runs it
  (:485-513), NMTConfig.base() (dropout 0.1, label smoothing 0.1), the
  stream seeded 0, one (64, 64) source and target batch (numpy seed 0,
  ids in [3, vocab)), forward_fused_loss; tokens/s counts target tokens;
- ``vit``: ViT-B/16 as bench.py runs it (:655), ViTConfig.base() with
  remat, NHWC, the stream seeded 0, one (128, 224, 224, 3) batch of
  seeded images, labels arange(128) % 1000; it prints images/s;
- ``bert_moe``: bench.py's bench_bert_moe (:443-483), BertConfig.base()
  with dropout 0 and an 8-expert top-1 Switch FFN (capacity factor
  1.25), the stream seeded 0, one (16, 128) batch as bench.py makes it
  (numpy seed 0, 15% MLM labels), forward_fused_loss + 0.01 x the
  layers' aux losses;
- ``gpt_moe``: GPTConfig.small() with 8 experts, capacity factor 1.25,
  no remat, max_position 1024, the stream seeded 0, one (8, 1024) batch
  of seeded ids, forward_loss + 0.01 x the aux losses;
- ``vgg16``, ``alexnet``, ``googlenet``, ``se_resnext50`` (NHWC) and
  ``se_resnext50_nchw``: the bench's zoo cells (bench.py:2259-2365), 224
  px, 1000 classes, batch 64, 256, 128, 64 and 64, the stream seeded 0,
  seeded images, all-zero labels (googlenet's aux heads in its loss);
  images/s;
- ``stacked_lstm``: bench model 6 (bench.py:2227-2256), vocab 5149,
  embed and hidden 512, 3 layers, T=100, batch 64, lengths in [50, 100]
  (numpy seed 0), labels ids[:, 0] % 2; examples/s.

Each model and policy named runs in turn, in one process.

It runs two warm-up steps, times ``--steps`` steps on the host clock with
the profiler off (each ends in a synchronize), then profiles as many more
with torch.profiler, and prints: host wall ms per step (profiler off,
and on), device busy ms per step (the sum of CUDA kernel and memcpy
times), the device's idle share against the profiler-off wall time,
device ops per step, device ms per step by kind (the three flash
kernels, GEMMs, everything else), and the kernels with the most device
time.

    python3 tools/torch_train_profile.py [--steps 5]
        [--amp float32 mixed_bf16 bfloat16]
        [--model gpt bert_base bert_packed resnet50 resnet50_nchw
                 deepfm deepfm_sparse nmt vit bert_moe gpt_moe vgg16
                 alexnet googlenet se_resnext50 se_resnext50_nchw
                 stacked_lstm] [--vocab 100000 10000000]
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

KINDS = (("flash forward", ("flash_fwd_kernel",)),
         # cuDNN's convolutions (implicit GEMMs, named before GEMM's keys)
         ("conv", ("fprop", "dgrad", "wgrad", "conv2d", "convolution",
                   "implicit_convolve", "winograd")),
         ("batch norm", ("batch_norm", "bn_fw", "bn_bw", "batchnorm")),
         ("flash dq", ("flash_dq_kernel",)),
         ("flash dk/dv", ("flash_dkv_kernel",)),
         # cuBLAS 12.x on Hopper names many GEMMs nvjet_* (bf16 ones too)
         ("GEMM", ("gemm", "xmma", "cutlass", "splitKreduce", "nvjet")))


# bench.py's zoo cells: (constructor, batch, data format)
ZOO = ["vgg16", "alexnet", "googlenet", "se_resnext50", "se_resnext50_nchw"]
ZOO_BATCH = {"vgg16": 64, "alexnet": 256, "googlenet": 128,
             "se_resnext50": 64, "se_resnext50_nchw": 64}


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other (elementwise, reductions, copies)"


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--amp", nargs="+", default=["float32"],
                    choices=["float32", "mixed_bf16", "bfloat16"])
    ap.add_argument("--model", nargs="+", default=["gpt"],
                    choices=["gpt", "bert_base", "bert_packed", "resnet50",
                             "resnet50_nchw", "deepfm", "deepfm_sparse",
                             "nmt", "vit", "bert_moe", "gpt_moe"] + ZOO
                    + ["stacked_lstm"])
    ap.add_argument("--vocab", nargs="+", type=int,
                    default=[100_000, 10_000_000],
                    help="DeepFM's total vocab (the deepfm models only)")
    args = ap.parse_args()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"[card] {smi.stdout.strip()}")
    for name in args.model:
        for policy in args.amp:
            for vocab in (args.vocab if name.startswith("deepfm")
                          else [None]):
                profile_step(torch, profile, ProfilerActivity, name, policy,
                             args.steps, vocab)
    return 0


def gpt_setup(torch):
    """bench_gpt's model, batch and loss builder; the batch's tokens."""
    from paddle_tpu_torch.models import gpt

    cfg = gpt.GPTConfig.small()
    cfg.max_position, cfg.remat = 1024, True
    model = gpt.GPTForCausalLM(
        cfg, generator=torch.Generator(device="cuda").manual_seed(5))
    ids = torch.randint(0, cfg.vocab_size, (8, 1024),
                        generator=torch.Generator().manual_seed(6)).cuda()
    return (model, ids, lambda m, batch, g: (m.forward_loss(batch), {}),
            8 * 1024, None, "tokens")


def resnet_setup(torch, fmt):
    """bench.py's ResNet-50 cell: the model, one b128 224 px batch of
    seeded images with all-zero labels, the loss builder."""
    from paddle_tpu_torch.models import resnet

    gen = torch.Generator(device="cuda").manual_seed(22)
    model = resnet.resnet50(1000, data_format=fmt, device="cuda",
                            generator=gen)
    x = torch.randn(128, 3, 224, 224, generator=gen, device="cuda")
    label = torch.zeros(128, dtype=torch.long, device="cuda")
    return (model, (x, label),
            lambda m, batch, g: (resnet.loss_fn(m(batch[0]), batch[1]), {}),
            128, None, "images")


def bert_setup(torch, packed):
    """BERT-base, bench.py's batch (numpy seed 0) and loss builder; the
    batch's tokens and, packed, its real (segment > 0) tokens."""
    import numpy as np

    from paddle_tpu_torch.data import pack_sequences
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base()
    model = bert.BertForPretraining(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(15))
    rng = np.random.default_rng(0)
    b, t = 32, 128

    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.long,
                               device="cuda")

    if not packed:
        ids = dev(rng.integers(0, cfg.vocab_size, (b, t)))
        nsp = dev(rng.integers(0, 2, (b,)))
        return (model, (ids, ids, nsp),
                lambda m, batch, g: (m.forward_fused_loss(*batch), {}),
                b * t, None, "tokens")

    def docs():
        while True:
            yield rng.integers(3, cfg.vocab_size, int(rng.integers(16,
                                                                   t + 1)))

    pk = next(iter(pack_sequences(docs, capacity=t, batch_size=b)()))
    tokens = dev(pk["tokens"])
    seg = torch.as_tensor(pk["segment_ids"], device="cuda")
    return (model, (tokens, dev(pk["positions"]), seg, tokens),
            lambda m, batch, g: (m.forward_packed_loss(*batch), {}),
            b * t, int((seg > 0).sum()), "tokens")


def nmt_setup(torch):
    """bench.py's NMT cell: the model, one (64, 64) batch (numpy seed 0)
    and the fused-loss builder; the batch's target tokens."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import transformer as TR

    ptt.seed(0)
    cfg = TR.NMTConfig.base()
    model = TR.TransformerNMT(cfg, device="cuda")
    rng = np.random.default_rng(0)
    src = torch.as_tensor(rng.integers(3, cfg.src_vocab, (64, 64)),
                          device="cuda")
    tgt = torch.as_tensor(rng.integers(3, cfg.tgt_vocab, (64, 64)),
                          device="cuda")
    return (model, (src, tgt, tgt),
            lambda m, batch, g: (m.forward_fused_loss(*batch), {}),
            64 * 64, None, "tokens")


def vit_setup(torch):
    """bench.py's ViT-B/16 cell: the model (remat, NHWC), one b128 224 px
    batch of seeded images, labels arange(128) % 1000, the loss
    builder."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import vit

    ptt.seed(0)
    cfg = vit.ViTConfig.base()
    cfg.remat = True
    model = vit.ViT(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(24)
    x = torch.randn(128, 224, 224, 3, generator=gen, device="cuda")
    label = torch.arange(128, device="cuda") % cfg.num_classes
    return (model, (x, label),
            lambda m, batch, g: (vit.loss_fn(m(batch[0]), batch[1]), {}),
            128, None, "images")


def moe_aux(model):
    """0.01 x the sum of the Switch FFNs' aux losses (the bench's
    weight)."""
    return 0.01 * sum(v for k, v in model.named_buffers()
                      if k.endswith("ffn.aux_loss"))


def bert_moe_setup(torch):
    """bench_bert_moe's model, one (16, 128) batch (numpy seed 0) and the
    fused loss + 0.01 x aux."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import bert

    ptt.seed(0)
    cfg = bert.BertConfig.base()
    cfg.dropout, cfg.moe_experts = 0.0, 8
    model = bert.BertForPretraining(cfg, device="cuda")
    rng = np.random.default_rng(0)
    b, t = 16, 128
    ids = rng.integers(0, cfg.vocab_size, (b, t))
    mlm = np.where(rng.random((b, t)) < 0.15,
                   rng.integers(0, cfg.vocab_size, (b, t)), -100)
    nsp = rng.integers(0, 2, (b,))
    batch = tuple(torch.as_tensor(a, device="cuda") for a in (ids, mlm, nsp))
    return (model, batch,
            lambda m, bt, g: (m.forward_fused_loss(*bt) + moe_aux(m), {}),
            b * t, None, "tokens")


def gpt_moe_setup(torch):
    """GPTConfig.small() with 8 experts (no remat), one (8, 1024) batch
    of seeded ids, forward_loss + 0.01 x aux."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import gpt

    ptt.seed(0)
    cfg = gpt.GPTConfig.small()
    cfg.max_position, cfg.moe_experts = 1024, 8
    model = gpt.GPTForCausalLM(cfg, device="cuda")
    ids = torch.randint(0, cfg.vocab_size, (8, 1024),
                        generator=torch.Generator().manual_seed(6)).cuda()
    return (model, ids,
            lambda m, bt, g: (m.forward_loss(bt) + moe_aux(m), {}),
            8 * 1024, None, "tokens")


def zoo_setup(torch, name):
    """A zoo cell as bench.py runs it: 224 px seeded images, all-zero
    labels, the model's loss_fn."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import alexnet, googlenet, se_resnext, vgg

    ptt.seed(0)
    b = ZOO_BATCH[name]
    mod, model = {
        "vgg16": (vgg, lambda: vgg.vgg16(1000, device="cuda")),
        "alexnet": (alexnet, lambda: alexnet.alexnet(1000, device="cuda")),
        "googlenet": (googlenet,
                      lambda: googlenet.googlenet(1000, device="cuda")),
        "se_resnext50": (se_resnext, lambda: se_resnext.se_resnext50(
            1000, data_format="NHWC", device="cuda")),
        "se_resnext50_nchw": (se_resnext, lambda: se_resnext.se_resnext50(
            1000, data_format="NCHW", device="cuda")),
    }[name]
    model = model()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(b, 3, 224, 224, generator=gen, device="cuda")
    label = torch.zeros(b, dtype=torch.long, device="cuda")
    return (model, (x, label),
            lambda m, bt, g: (mod.loss_fn(m(bt[0]), bt[1]), {}),
            b, None, "images")


def stacked_lstm_setup(torch):
    """bench_stacked_lstm's cell: ids and lengths (numpy seed 0), labels
    ids[:, 0] % 2."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import stacked_lstm as SL

    ptt.seed(0)
    b, t = 64, 100
    model = SL.StackedLSTM(5149, 512, 512, 3, device="cuda")
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, 5149, (b, t)), device="cuda")
    lengths = torch.as_tensor(rng.integers(t // 2, t + 1, (b,)),
                              device="cuda")
    return (model, (ids, lengths),
            lambda m, bt, g: (SL.loss_fn(m(*bt), bt[0][:, 0] % 2), {}),
            b, None, "examples")


def deepfm_setup(torch, vocab, sparse, policy):
    """bench.py's DeepFM cell at ``vocab``: a step function (Trainer for
    dense updates, sparse_minimize_fn for row-sparse ones, the loss under
    ``policy``), the examples a step takes."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.core.dtypes import policy_scope
    from paddle_tpu_torch.models import deepfm as DF
    from paddle_tpu_torch.parallel import Trainer

    ptt.seed(0)
    cfg = DF.DeepFMConfig(total_vocab=vocab, num_fields=26, dense_dim=13,
                          embed_dim=16, embedding_axis=None,
                          sparse_grads=sparse)
    model = DF.DeepFM(cfg, device="cuda")
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, vocab, (4096, 26))).cuda()
    dense = torch.from_numpy(rng.normal(size=(4096, 13)).astype(
        np.float32)).cuda()

    def loss(p=None):
        logits = (model(ids, dense) if p is None
                  else model.functional_call(p, ids, dense)[0])
        return DF.loss_fn(logits, ids[:, 0] % 2)

    if not sparse:
        trainer = Trainer(model, optimizer.Adam(1e-3),
                          lambda m, b, g: (loss(), {}), amp=policy)
        return lambda: trainer.train_step(None), 4096

    def forward_loss(p):
        with policy_scope(policy):
            return loss(p)

    init_fn, step_fn = optimizer.sparse_minimize_fn(
        model, forward_loss, optimizer.Adam(1e-3))
    params = dict(model.named_parameters())
    state = init_fn(params)
    return lambda: step_fn(params, state), 4096


def trainer_setup(torch, name, policy):
    """The Trainer step of the model ``name``; the tokens (or images,
    examples) a step takes, its real tokens and the unit."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.parallel import Trainer

    model, batch, loss_builder, tokens, real, unit = (
        gpt_setup(torch) if name == "gpt"
        else gpt_moe_setup(torch) if name == "gpt_moe"
        else bert_moe_setup(torch) if name == "bert_moe"
        else zoo_setup(torch, name) if name in ZOO
        else stacked_lstm_setup(torch)
        if name == "stacked_lstm"
        else resnet_setup(torch, "NCHW" if name.endswith("nchw") else "NHWC")
        if name.startswith("resnet50")
        else nmt_setup(torch) if name == "nmt"
        else vit_setup(torch) if name == "vit"
        else bert_setup(torch, name == "bert_packed"))
    trainer = Trainer(model, optimizer.Adam(1e-3), loss_builder,
                      amp=policy)
    return lambda: trainer.train_step(batch), tokens, real, unit


def profile_step(torch, profile, ProfilerActivity, name, policy, n,
                 vocab=None):
    if name.startswith("deepfm"):
        step, tokens = deepfm_setup(torch, vocab, name == "deepfm_sparse",
                                    policy)
        real, unit = None, "examples"
    else:
        step, tokens, real, unit = trainer_setup(torch, name, policy)

    def run(k):
        t0 = time.perf_counter()
        for _ in range(k):
            step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(2)                                          # warm-up
    plain_wall = run(n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run(n)
    tag = (f"[train:{policy}]" if name == "gpt"
           else f"[train:{name}:{policy}]" if vocab is None
           else f"[train:{name}:V={vocab}:{policy}]")
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    ops = sum(e.count for e in events)
    print(f"{tag} {n} steps: host wall {1e3 * plain_wall / n:.3f} ms per "
          f"step (profiler on: {1e3 * wall / n:.3f}), device busy "
          f"{busy_us / 1e3 / n:.3f} ms per step, device idle share "
          f"{1 - busy_us / 1e6 / plain_wall:.3f}, {ops / n:.1f} device ops "
          f"per step, {tokens * n / plain_wall:.1f} {unit}/s"
          + ("" if real is None else
             f", {real * n / plain_wall:.1f} real tokens/s"))
    by_kind = {}
    for e in events:
        k = kind_of(e.key)
        t, c = by_kind.get(k, (0.0, 0))
        by_kind[k] = (t + e.self_device_time_total, c + e.count)
    for k, (t, c) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"{tag}   {t / 1e3 / n:9.3f} ms/step ({100 * t / busy_us:5.1f}"
              f"%) x{c // n:5d}  {k}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:16]:
        print(f"{tag}   {e.self_device_time_total / 1e3 / n:9.3f} ms/step "
              f"x{e.count // n:4d}  {kind_of(e.key)[:5]:5s} {e.key[:90]}")
    del step
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
