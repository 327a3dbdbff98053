"""The port's performance attribution (telemetry/costs.py,
telemetry/profiling.py, utils/flops.py, utils/memory.py) against the
JAX package's on the same inputs, and the zero-cost contract:

- the goodput ledger and the regression sentinel give the same
  snapshots and diagnostics on one seeded sequence, and either package
  reads the other's baseline file;
- the peak table's rows (the nominal CPU row equal to the JAX
  package's, the H100 row), rooflines and MFU;
- FLOPs: the port's count of one MLP training step (matmuls by
  ``torch.utils.flop_counter``'s rules) against the JAX package's
  ``lowered_flops`` (XLA's cost model, elementwise FLOPs included):
  measured gap 0.2%, held within 10%; a 2-layer GPT step at vocab 1024
  (the JAX fused head pads the vocabulary to its 1024-wide chunk, so a
  smaller vocabulary would compare different work): measured gap 1.3%,
  held within 10%. The kernel path (the flash wrappers' reckoned cost)
  and the plain path count the same FLOPs exactly, in training and in a
  paged serving tick;
- memory estimation's exact parts equal the JAX package's;
- with telemetry off a serving tick and a training step touch no
  instrument (tripwires on every telemetry entry they could reach)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import telemetry as JT
from paddle_tpu.models import gpt as JG
from paddle_tpu.models.mnist import MnistMLP as JMLP
from paddle_tpu.telemetry import costs as JC
from paddle_tpu.telemetry import profiling as JP
from paddle_tpu.utils import flops as JF
from paddle_tpu.utils import memory as JM
from paddle_tpu_torch import telemetry as TT
from paddle_tpu_torch.core import DeviceUnavailableError, InvalidArgumentError
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.mnist import MnistMLP as TMLP
from paddle_tpu_torch.ops import attention as TA
from paddle_tpu_torch.serving import BatchedDecoder
from paddle_tpu_torch.telemetry import costs as TC
from paddle_tpu_torch.telemetry import profiling as TP
from paddle_tpu_torch.utils import flops as TF
from paddle_tpu_torch.utils import memory as TM
from paddle_tpu_torch.utils.convert import load_numpy_state

GAP = 0.10      # the JAX count's elementwise FLOPs: its share, held below


@pytest.fixture(autouse=True)
def clean():
    for t in (JT, TT):
        t.enable()
        t.reset()
    yield
    for t in (JT, TT):
        t.reset()
        t.disable()


def _goodput(P):
    g = P.goodput()
    rng = np.random.default_rng(2)
    for _ in range(5):
        w, d, c = (float(x) for x in rng.uniform(0.001, 0.01, 3))
        g.note_step(input_wait=w, dispatch=d, device_compute=c)
        g.note_checkpoint_stall(w / 2)
        g.note_tick(int(rng.integers(1, 8)), 8)
    return g.snapshot()


def test_goodput_ledger_matches():
    assert _goodput(JP) == _goodput(TP)
    assert TT.registry().get("pt_goodput_ratio", {"role": "train"}).value \
        == JT.registry().get("pt_goodput_ratio", {"role": "train"}).value


def _sentinel(P, path, seq):
    s = P.RegressionSentinel(band=0.5, min_samples=4)
    s.attach(str(path))
    out = [str(s.observe("train.step", "gpu:NVIDIA H100 80GB HBM3", x))
           for x in seq]
    out += [str(s.observe("serving.step[k=1]", "cpu", x / 10, kind="itl"))
            for x in seq]
    out.append(s.observe("train.step", "cpu", 9.0, degraded=True))
    s.save()
    return out, s.baselines()


def test_sentinel_decides_alike_and_reads_the_other_baselines(tmp_path,
                                                             capsys):
    seq = [0.10, 0.11, 0.09, 0.10, 0.105, 0.30, 0.31, 0.1]
    jout, jbase = _sentinel(JP, tmp_path / "j.json", seq)
    tout, tbase = _sentinel(TP, tmp_path / "t.json", seq)
    assert jout == tout and jbase == tbase
    assert sum("PT-PERF-801" in str(x) for x in tout) == 1
    assert sum("PT-PERF-802" in str(x) for x in tout) == 1
    assert json.load(open(tmp_path / "j.json")) == \
        json.load(open(tmp_path / "t.json"))
    # a baseline written by one package alarms the other at once
    for P, other in ((TP, "j.json"), (JP, "t.json")):
        s = P.RegressionSentinel(band=0.5, min_samples=4)
        s.attach(str(tmp_path / other))
        assert "PT-PERF-801" in str(s.observe(
            "train.step", "gpu:NVIDIA H100 80GB HBM3", 1.0))
    capsys.readouterr()


def test_peak_rows_rooflines_and_mfu(monkeypatch):
    assert TC.backend_peaks() == {**JC.backend_peaks(), "backend": "cpu",
                                  "device_kind": None}
    assert JC.backend_peaks()["nominal"] is True
    for f, b in ((1e9, 1e9), (1e12, 1e9), (None, 1.0)):
        assert TC.roofline(f, b) == JC.roofline(f, b)
    h100 = TC.backend_peaks("NVIDIA H100 80GB HBM3")
    assert (h100["peak_flops"], h100["peak_hbm_bytes_per_s"],
            h100["nominal"]) == (989e12, 3.35e12, False)
    assert TF.device_peak_flops("NVIDIA H100 80GB HBM3", "int8") == 1979e12
    assert TF.device_peak_flops() is None           # the CPU: no MFU
    assert TF.mfu(1e12, "NVIDIA H100 80GB HBM3") == 1e12 / 989e12
    monkeypatch.setenv("PT_PEAK_FLOPS", "1e12")
    assert TF.device_peak_flops() == 1e12
    assert TC.backend_key() == "cpu"
    for fn in (TF.enable_compile_cache, TF._harden_cache_writes):
        with pytest.raises(InvalidArgumentError, match="no torch meaning"):
            fn()


def _mlp_pair():
    pt.seed(3)
    jm = JMLP(256, 128)
    tm = TMLP(256, 128, device="cpu")
    load_numpy_state(tm, {k: np.asarray(v)
                          for k, v in jm.named_parameters().items()})
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 784)).astype(np.float32)
    y = rng.integers(0, 10, 64)
    return jm, tm, x, y


def test_mlp_step_flops_against_jax_lowered_flops():
    jm, tm, x, y = _mlp_pair()

    def jloss(p):
        out, _ = jm.functional_call(p, jnp.asarray(x))
        logp = jax.nn.log_softmax(out)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                             axis=1))

    want = JF.lowered_flops(jax.jit(jax.value_and_grad(jloss)),
                            jm.named_parameters())

    def step():
        out = tm(torch.from_numpy(x))
        torch.nn.functional.cross_entropy(out, torch.from_numpy(y)).backward()

    got = TF.lowered_flops(step)
    # the matmuls alone: forward 2MNK per layer, backward twice that,
    # less the input's gradient, which nothing asks for
    dims = [(784, 256), (256, 128), (128, 10)]
    assert got == sum(6 * 64 * a * b for a, b in dims) - 2 * 64 * 784 * 256
    assert 0 <= (want - got) / want < GAP
    # the ledger registers the same count once, through analyze_callable
    rec = TC.analyze_callable("mlp.step", step)
    assert rec["flops"] == got and rec["hbm_bytes"] > 0
    assert rec["roofline"]["nominal"] is True
    assert TC.derive_mfu("mlp.step", 0.01) is None     # no CPU peak row


CFG = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=2,
           num_kv_heads=1, intermediate_size=256, max_position=64)


@pytest.fixture(scope="module")
def gpt_pair():
    pt.seed(0)
    jm = JG.GPTForCausalLM(JG.GPTConfig(**CFG))
    tm = TG.GPTForCausalLM(TG.GPTConfig(**CFG), device="cpu")
    load_numpy_state(tm, {k: np.asarray(v)
                          for k, v in jm.named_parameters().items()})
    ids = np.random.default_rng(0).integers(1, 1024, (2, 64))
    return jm, tm, ids.astype(np.int32)


def test_gpt_step_flops_kernel_path_equals_plain_and_jax(gpt_pair):
    jm, tm, ids = gpt_pair

    def jloss(p):
        out, _ = jm.functional_call(p, jnp.asarray(ids), training=True,
                                    method="forward_loss")
        return out

    want = JF.lowered_flops(jax.jit(jax.value_and_grad(jloss)),
                            jm.named_parameters())

    def step():
        tm.zero_grad()
        tm.forward_loss(torch.from_numpy(ids).long()).backward()

    _, plain = TF.count_call(step)
    with TA.force_flash():
        _, kern = TF.count_call(step)
    assert kern.kernels == {"flash_attention_fwd": 2,
                            "flash_attention_dq": 2,
                            "flash_attention_dkv": 2}
    assert not plain.kernels
    assert kern.flops == plain.flops
    assert 0 <= (want - plain.flops) / want < GAP
    # attention's reckoned share: 12 B H T^2 D a layer (4 forward, 8
    # backward); the rest is 6 x the matmul parameters x the tokens plus
    # the fused head's recompute of the logits (2 x tokens x H x V)
    b, t, h, d = 2, 64, 2, 64
    attn = 2 * 12 * b * h * t * t * d
    n = sum(p.numel() for name, p in tm.named_parameters()
            if p.ndim == 2 and "embed" not in name) + 128 * 1024
    assert kern.flops == attn + 6 * n * b * t + 2 * b * t * 128 * 1024


def test_paged_tick_flops_kernel_wrapper_equals_plain_path(gpt_pair,
                                                          monkeypatch):
    _, tm, ids = gpt_pair
    tm.eval()
    recs = []
    for gate in (True, False):
        monkeypatch.setattr(TA, "decode_flash_ok",
                            lambda *a, _g=gate, **k: _g)
        TC.reset()
        dec = BatchedDecoder(tm, slots=2, capacity=128, pages=6,
                             page_size=64, device="cpu")
        for n in (5, 9):
            dec.submit(ids[0, :n], 3)
        dec.run()
        recs.append(TC.get("serving.step[k=1]"))
    kern, plain = recs
    assert kern["kernel_calls"] == {"decode_attention_paged": 2}
    assert not plain["kernel_calls"]
    assert kern["flops"] == plain["flops"] > 0
    assert kern["origin"] == "serving" and kern["backend"] == "cpu"


def test_memory_estimates_match_jax(tmp_path):
    jm, tm, x, _ = _mlp_pair()
    want = JM.estimate_training_memory(jm, (jnp.asarray(x),))
    got = TM.estimate_training_memory(tm, (torch.from_numpy(x),))
    for k in ("params_bytes", "grads_bytes", "optimizer_state_bytes"):
        assert got[k] == want[k]
    assert got["activations_upper_bound_bytes"] >= 64 * (256 + 128 + 10) * 4
    assert TM.bytes_of_tree({"a": torch.zeros(5, 5), "b": np.zeros(3)}) \
        == 100 + 24 == JM.bytes_of_tree({"a": jnp.zeros((5, 5)),
                                         "b": np.zeros(3)})
    assert TM.format_bytes(2048) == JM.format_bytes(2048)
    src = np.arange(4, dtype=np.float32)
    owned = TM.owned_on_device(torch.from_numpy(src))
    owned += 1
    assert src[0] == 0.0
    with pytest.raises(DeviceUnavailableError):
        TM.memory_usage(lambda: None)


def _tripwire(monkeypatch, targets):
    def boom(*a, **k):
        raise AssertionError("telemetry touched while disabled")

    for mod, name in targets:
        monkeypatch.setattr(mod, name, boom)


def test_zero_cost_when_disabled(gpt_pair, monkeypatch, tmp_path):
    import paddle_tpu_torch.serving as S
    import paddle_tpu_torch.train_loop as L
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import Trainer
    from paddle_tpu_torch.telemetry import recompile as TR
    from paddle_tpu_torch.telemetry import server as TS
    from paddle_tpu_torch.telemetry import tracing as TTG

    _, tm, ids = gpt_pair
    TT.disable()
    _tripwire(monkeypatch, [
        (S, "_serving_metrics"), (L, "_train_metrics"), (TR, "record"),
        (TC, "counting"), (TC, "observe_step"), (TP, "goodput"),
        (TP, "sentinel"), (TTG, "span"), (TTG, "event"), (TTG, "current"),
        (TTG, "new_trace"), (TS, "note"), (TF, "count_call")])
    dec = BatchedDecoder(tm.eval(), slots=2, capacity=128, pages=6,
                         page_size=64, device="cpu")
    dec.submit(ids[0, :7], 3)
    assert len(dec.run()[0]) == 3
    tr = Trainer(tm.train(), Adam(1e-3),
                 lambda m, b, g: (m.forward_loss(b), {}))
    loop = L.TrainLoop(tr, str(tmp_path), checkpoint_every=0)
    assert loop.run([torch.from_numpy(ids).long()] * 2) == 2
    assert loop.step_splits == []


def test_a_counted_step_computes_what_an_uncounted_one_does():
    """The count runs each op's own kernel: an op with one (SiLU's
    backward, in the GPT's FFN, has CPU and CUDA kernels beside its
    composite formula, which rounds otherwise under mixed_bf16) is never
    swapped for its decomposition, so the counted first step of a 2-layer
    GPT trains exactly as an uncounted one (deterministic algorithms on:
    the CPU's embedding backward is not, counted or not)."""
    from paddle_tpu_torch.core import policy_scope

    cfg = dict(CFG, vocab_size=512)
    ids = torch.randint(0, 512, (2, 64),
                        generator=torch.Generator().manual_seed(0))
    grads = []
    torch.use_deterministic_algorithms(True)
    try:
        for count in (False, True):
            m = TG.GPTForCausalLM(TG.GPTConfig(**cfg), device="cpu",
                                  generator=torch.Generator().manual_seed(1))

            def step():
                with policy_scope("mixed_bf16"):
                    loss = m.forward_loss(ids)
                loss.backward()

            if count:
                assert TF.count_call(step)[1].flops > 0
            else:
                step()
            grads.append({n: p.grad for n, p in m.named_parameters()})
    finally:
        torch.use_deterministic_algorithms(False)
    assert [n for n in grads[0]
            if not torch.equal(grads[0][n], grads[1][n])] == []


def test_a_counted_call_feeds_no_baseline(gpt_pair, tmp_path, monkeypatch):
    """The first real call of a program runs under the ledger's count,
    which slows it: the sentinel takes every later tick and step, not
    that one (a resumed run with its baselines loaded would otherwise
    read its counted first step as a regression)."""
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import Trainer
    from paddle_tpu_torch.train_loop import TrainLoop

    _, tm, ids = gpt_pair
    monkeypatch.setattr(TP.sentinel(), "band", 1e9)   # count, never warn
    dec = BatchedDecoder(tm.eval(), slots=2, capacity=128, pages=6,
                         page_size=64, device="cpu")
    dec.submit(ids[0, :7], 4)
    dec.run()
    base = TP.sentinel().baselines()
    # the prefill emits the first token, then one tick a token
    assert TC.known("serving.step[k=1]") and dec.tick_count == 3
    assert base["serving.step[k=1]|cpu"]["n"] == dec.tick_count - 1
    tr = Trainer(tm.train(), Adam(1e-3),
                 lambda m, b, g: (m.forward_loss(b), {}))
    loop = TrainLoop(tr, str(tmp_path), checkpoint_every=0)
    assert loop.run([torch.from_numpy(ids).long()] * 3) == 3
    assert TC.known("train.step")
    assert TP.sentinel().baselines()["train.step|cpu"]["n"] == 2
