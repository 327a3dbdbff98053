"""The port's int8 matrix product (paddle_tpu_torch/ops/kernels/
quant_matmul.py) and its PTQ path (quant.qat, quant.int8) against the JAX
package.

Tolerances and why:
- ``quant_matmul`` (plain version on the CPU) against JAX's Pallas
  kernel in interpret mode (8x8x8 tiles, so every shape pads) and its
  XLA path: exactly equal. Integer sums are exact, and both take the
  scales' product first, then one float32 multiply.
- ``freeze()`` after ``calibrate`` on the same weights and batches:
  ``weight_int8`` exactly, ``weight_scale`` to 1e-7, ``act_scale`` to
  rtol 1e-5: the moving average runs over float matmuls that the two
  frameworks sum in different orders (~1e-6 relative).
- the int8 forward of the port on the JAX frozen entries against the
  JAX int8 forward: atol 1e-6 (the products are exact; the float32 bias
  add and ReLU between layers are the same operations).
- the int8 model against its fake-quant float model: relative error
  < 0.1, the JAX package's bound (tests/test_quant_matmul.py).
- the fused form's plain version ``quant_linear_plain`` (encode, product,
  bias, ReLU) against JAX ``int8_linear`` followed by ReLU on the same
  frozen entries: exactly equal (the same float32 operations in the same
  order); the fused and the unfused port paths: exactly equal.

The test marked ``gpu`` holds the CUDA kernel, in both forms, against its
plain versions on the card (exactly) and skips here:
``python3 -m pytest --noconftest -m gpu tests/test_torch_quant_matmul.py``
(JAX is imported inside the CPU tests only)."""

import itertools

import numpy as np
import pytest
import torch

from paddle_tpu_torch import quant
from paddle_tpu_torch.models.mnist import MnistMLP
from paddle_tpu_torch.core import InvalidArgumentError
from paddle_tpu_torch.nn import Linear, Sequential
from paddle_tpu_torch.ops.kernels import quant_matmul as QM
from paddle_tpu_torch.utils.convert import load_numpy_state

SHAPES = [(16, 32, 24), (33, 100, 17), (8, 784, 10), (1, 5, 3)]


def _jax():
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas.quant_matmul import quant_matmul

    return jnp, quant_matmul


def _operands(m, k, n, seed, per_channel):
    rng = np.random.default_rng(seed)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sa = np.float32(rng.uniform(0.001, 0.1))
    sb = (rng.uniform(0.001, 0.1, n).astype(np.float32) if per_channel
          else np.float32(rng.uniform(0.001, 0.1)))
    return a, b, sa, sb


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_tensor", "per_channel"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_quant_matmul_matches_jax_exactly(shape, per_channel):
    jnp, jqm = _jax()
    a, b, sa, sb = _operands(*shape, seed=sum(shape),
                             per_channel=per_channel)
    got = QM.quant_matmul(torch.from_numpy(a), torch.from_numpy(b),
                          torch.tensor(sa),
                          torch.from_numpy(np.asarray(sb)))
    assert got.dtype == torch.float32 and got.shape == shape[::2]
    xla = jqm(jnp.asarray(a), jnp.asarray(b), sa, jnp.asarray(sb),
              use_pallas=False)
    pallas = jqm(jnp.asarray(a), jnp.asarray(b), sa, jnp.asarray(sb),
                 interpret=True, tile_m=8, tile_n=8, tile_k=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_quant_matmul_bfloat16_out_matches_jax():
    jnp, jqm = _jax()
    a, b, sa, sb = _operands(24, 64, 40, seed=7, per_channel=True)
    got = QM.quant_matmul(torch.from_numpy(a), torch.from_numpy(b), sa,
                          torch.from_numpy(sb), out_dtype=torch.bfloat16)
    want = jqm(jnp.asarray(a), jnp.asarray(b), sa, jnp.asarray(sb),
               out_dtype=jnp.bfloat16, use_pallas=False)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("shape_a,shape_b", [((0, 4), (4, 4)),
                                             ((4, 0), (0, 4)),
                                             ((4, 4), (4, 0))])
def test_zero_sized_dims(shape_a, shape_b):
    jnp, jqm = _jax()
    a = np.zeros(shape_a, np.int8)
    b = np.zeros(shape_b, np.int8)
    got = QM.quant_matmul(torch.from_numpy(a), torch.from_numpy(b), 1.0, 1.0)
    want = jqm(jnp.asarray(a), jnp.asarray(b), 1.0, 1.0, interpret=True)
    assert tuple(got.shape) == (shape_a[0], shape_b[1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quant_matmul_checks():
    a = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(Exception, match="inner dims"):
        QM.quant_matmul(a, torch.zeros((4, 4), dtype=torch.int8), 1.0, 1.0)
    with pytest.raises(Exception, match="int8 operands"):
        QM.quant_matmul(a.float(), torch.zeros((8, 4)), 1.0, 1.0)
    with pytest.raises(InvalidArgumentError, match="float32 or bfloat16"):
        QM.quant_matmul(a, torch.zeros((8, 4), dtype=torch.int8), 1.0, 1.0,
                        out_dtype=torch.float16)


def _jax_ptq(h1, h2, batches):
    """JAX MnistMLP -> quantize_model -> calibrate -> freeze. Returns the
    model, its parameters (before calibration) and the frozen
    entries."""
    import jax.numpy as jnp

    import paddle_tpu as pt
    from paddle_tpu import quant as JQ
    from paddle_tpu.models.mnist import MnistMLP as JaxMLP

    pt.seed(0)
    jm = JQ.quantize_model(JaxMLP(h1, h2))
    params = {k: np.asarray(v) for k, v in jm.named_parameters().items()}
    JQ.calibrate(jm, [jnp.asarray(x) for x in batches])
    return jm, params, JQ.freeze(jm)


def _port_ptq(params, batches, h1, h2):
    tm = quant.quantize_model(MnistMLP(h1, h2, device="cpu"))
    load_numpy_state(tm, params)
    quant.calibrate(tm, [torch.from_numpy(x) for x in batches])
    return tm, quant.freeze(tm)


def _batches(n, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (8, d)).astype(np.float32) for _ in range(n)]


def test_mnist_ptq_freeze_and_int8_swap_match_jax():
    """QAT/PTQ on MnistMLP(64, 32): freeze() as JAX's (tolerances in the
    module docstring); int8_swap swaps 3 Linears; the port's int8 logits
    on the JAX frozen entries equal the JAX int8 logits; the int8 model
    lies within 0.1 of its fake-quant float model."""
    import jax.numpy as jnp

    from paddle_tpu import quant as JQ

    batches = _batches(4, 784, seed=2)
    jm, params, jfrozen = _jax_ptq(64, 32, batches)
    tm, tfrozen = _port_ptq(params, batches, 64, 32)
    assert sorted(tfrozen) == sorted(jfrozen) == ["fc1", "fc2", "fc3"]
    for path, je in jfrozen.items():
        te = tfrozen[path]
        assert te["weight_int8"].dtype == torch.int8 and te["bits"] == 8
        np.testing.assert_array_equal(te["weight_int8"].numpy(),
                                      np.asarray(je["weight_int8"]))
        np.testing.assert_allclose(te["weight_scale"].numpy(),
                                   np.asarray(je["weight_scale"]),
                                   atol=1e-7, rtol=0)
        np.testing.assert_allclose(te["act_scale"].numpy(),
                                   np.asarray(je["act_scale"]), rtol=1e-5)
    x = batches[0]
    ref = tm(torch.from_numpy(x))                 # fake-quant float, eval
    assert quant.int8_swap(tm, tfrozen) == 3
    with torch.no_grad():
        rel = ((tm(torch.from_numpy(x)) - ref).abs().max()
               / ref.abs().max().clamp_min(1e-6)).item()
    assert rel < 0.1, rel
    assert not any("weight_int8" in k for k, _ in tm.named_parameters())
    assert any("weight_int8" in k for k, _ in tm.named_buffers())

    # the same frozen entries in both packages: the int8 logits agree
    assert JQ.int8_swap(jm, jfrozen) == 3
    jm.eval()
    want = np.asarray(jm(jnp.asarray(x)))
    pm = quant.quantize_model(MnistMLP(64, 32, device="cpu"))
    load_numpy_state(pm, params)
    pfrozen = {p: {k: (torch.from_numpy(np.array(v))
                       if k != "bits" else v) for k, v in e.items()}
               for p, e in jfrozen.items()}
    assert quant.int8_swap(pm, pfrozen) == 3
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)

    # the swapped JAX model's buffers load into the swapped port model by
    # name, the int8 weights bit for bit
    state = {k: np.asarray(v) for k, v in jm.named_buffers().items()}
    load_numpy_state(tm, state)
    for k, v in tm.named_buffers():
        np.testing.assert_array_equal(v.numpy(), state[k])
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), want,
                                   atol=1e-6, rtol=0)


def test_sequential_qat_gradients_match_jax():
    """QAT through a Sequential of Linears (names "0", "1"): one training
    forward's loss and every parameter gradient (straight-through
    estimator through fake-quant weights and activations) against
    jax.grad of the JAX QuantedLayers, atol 1e-5 plus rtol 1e-5 (weight
    gradients up to ~3 are batch sums of float32 products, summed in
    another order: observed 1.5e-5 absolute, 6e-6 relative); the
    activation buffers after that training forward to rtol 1e-5."""
    import jax
    import jax.numpy as jnp

    import paddle_tpu as pt
    from paddle_tpu import nn as jnn
    from paddle_tpu import quant as JQ

    pt.seed(1)
    jq = JQ.quantize_model(jnn.Sequential(jnn.Linear(32, 64, act="relu"),
                                          jnn.Linear(64, 10)))
    params = {k: np.asarray(v) for k, v in jq.named_parameters().items()}
    tq = quant.quantize_model(Sequential(
        Linear(32, 64, act="relu", device="cpu"), Linear(64, 10,
                                                         device="cpu")))
    load_numpy_state(tq, params)
    x = _batches(1, 32, seed=3)[0]

    def jloss(p):
        out, bufs = jq.functional_call(p, jnp.asarray(x), training=True)
        return jnp.sum(out ** 2), bufs

    (jl, jbufs), jg = jax.value_and_grad(jloss, has_aux=True)(
        jq.named_parameters())
    tq.train()
    loss = (tq(torch.from_numpy(x)) ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for name, p in tq.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[name]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    for name, b in tq.named_buffers():
        np.testing.assert_allclose(b.numpy(), np.asarray(jbufs[name]),
                                   rtol=1e-5, err_msg=name)


def test_quant_linear_plain_matches_jax_int8_linear_and_relu():
    """Each frozen layer of a PTQ'd MnistMLP(64, 32): JAX int8_linear
    (encode, quant_matmul, bias) then ReLU, against quant_linear_plain on
    the packed weight with relu=True, exactly; without relu, against
    int8_linear alone."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu import quant as JQ
    from paddle_tpu_torch.quant.int8 import _linear_scales

    batches = _batches(4, 784, seed=12)
    _, params, jfrozen = _jax_ptq(64, 32, batches)
    rng = np.random.default_rng(13)
    for path, je in jfrozen.items():
        w = np.array(je["weight_int8"])
        x = rng.normal(0, 2, (16, w.shape[0])).astype(np.float32)
        bias = np.array(params[f"{path}.inner.bias"])
        want = JQ.int8_linear(jnp.asarray(x), je, bias=jnp.asarray(bias))
        a_scale, w_scale = _linear_scales(
            torch.from_numpy(np.array(je["act_scale"])),
            torch.from_numpy(np.array(je["weight_scale"])), w.shape[1],
            "cpu")
        w_packed = QM.pack_weight(torch.from_numpy(w))
        for relu in (False, True):
            got = QM.quant_linear_plain(torch.from_numpy(x), w_packed,
                                        a_scale, w_scale,
                                        torch.from_numpy(bias), relu)
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jax.nn.relu(want) if relu else want))


@pytest.mark.parametrize("k", [16, 20, 7], ids=["k16", "k20", "k7"])
def test_pack_weight_and_quant_linear_compose_the_unfused_path(k):
    """pack_weight lays the (K, N) weight out (N, K16), K16 = K rounded
    up to 16 with zero columns; quant_linear equals the unfused path
    (encode, quant_matmul, bias, ReLU) exactly, in float32 and bfloat16
    out; a packed weight of another K is refused."""
    from paddle_tpu_torch.quant.ops import _encode_at

    rng = np.random.default_rng(k)
    w = torch.from_numpy(rng.integers(-127, 128, (k, 5)).astype(np.int8))
    packed = QM.pack_weight(w)
    k16 = -(-k // 16) * 16
    assert packed.shape == (5, k16) and packed.is_contiguous()
    assert torch.equal(packed[:, :k], w.t())
    assert not packed[:, k:].any()
    x = torch.from_numpy(rng.normal(0, 3, (9, k)).astype(np.float32))
    sa, sb = torch.tensor(0.04), torch.from_numpy(
        rng.uniform(0.001, 0.1, 5).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=5).astype(np.float32))
    unfused = torch.relu(QM.quant_matmul(_encode_at(x, sa), w, sa, sb)
                         + bias)
    assert torch.equal(QM.quant_linear(x, packed, sa, sb, bias, True),
                       unfused)
    assert torch.equal(QM.quant_linear(x, packed, sa, sb, bias, True,
                                       out_dtype=torch.bfloat16),
                       unfused.to(torch.bfloat16))
    assert torch.equal(QM.quant_linear(x, packed, sa, sb),
                       QM.quant_matmul(_encode_at(x, sa), w, sa, sb))
    with pytest.raises(Exception, match="pack_weight"):
        QM.quant_linear(torch.zeros((2, 40)), packed, sa, sb)


def test_quant_linear_zero_sized_rows():
    packed = QM.pack_weight(torch.ones((4, 3), dtype=torch.int8))
    out = QM.quant_linear(torch.zeros((0, 4)), packed, 1.0, 1.0,
                          torch.ones(3), True)
    assert out.shape == (0, 3) and out.dtype == torch.float32


def test_int8_mlp_fused_forward_equals_unfused_entry_points():
    """A swapped MnistMLP's forward (Int8Linear: one quant_linear per
    layer) equals the same layers through the unfused public entry
    points (encode, quant_matmul, bias, ReLU), as chip_smoke.py's
    [int8:mnist] phase checks on the card."""
    from paddle_tpu_torch.quant.ops import _encode_at

    tm = quant.quantize_model(MnistMLP(64, 32, device="cpu"))
    quant.calibrate(tm, [torch.from_numpy(x)
                         for x in _batches(2, 784, seed=14)])
    assert quant.int8_swap(tm, quant.freeze(tm)) == 3
    x = torch.from_numpy(_batches(1, 784, seed=15)[0])
    h = x
    for layer in (tm.fc1, tm.fc2, tm.fc3):
        a_scale, w_scale, _ = layer._kernel_operands()
        h = QM.quant_matmul(_encode_at(h, a_scale), layer.weight_int8,
                            a_scale, w_scale) + layer.linear_bias
        if layer.act == "relu":
            h = torch.relu(h)
    with torch.no_grad():
        assert torch.equal(tm(x), h)


def test_int8_linear_takes_2d_only():
    entry = {"weight_int8": torch.zeros((4, 3), dtype=torch.int8),
             "weight_scale": torch.ones(3), "act_scale": torch.tensor(1.0)}
    with pytest.raises(InvalidArgumentError, match="rank 3"):
        quant.int8_linear(torch.zeros((2, 5, 4)), entry)
    with pytest.raises(Exception, match="int8 frozen weights"):
        quant.int8_linear(torch.zeros((2, 4)),
                          dict(entry, weight_int8=entry["weight_int8"].int()))


def test_int8_linear_follows_its_buffers():
    """Int8Linear derives its kernel scales and its packed weight once,
    and again after a load writes its buffers in place (the scales, then
    the int8 weight alone): the forward then equals int8_linear on the
    new entry exactly."""
    rng = np.random.default_rng(4)
    entry = {"weight_int8": torch.from_numpy(
                 rng.integers(-127, 128, (16, 8)).astype(np.int8)),
             "weight_scale": torch.from_numpy(
                 rng.uniform(0.5, 2, 8).astype(np.float32)),
             "act_scale": torch.tensor(3.0)}
    x = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32))
    layer = quant.Int8Linear(entry)
    assert torch.equal(layer(x), quant.int8_linear(x, entry))
    new = dict(entry, weight_scale=entry["weight_scale"] * 2,
               act_scale=torch.tensor(1.5))
    load_numpy_state(layer, {k: new[k].numpy()
                             for k in ("weight_scale", "act_scale")})
    assert torch.equal(layer(x), quant.int8_linear(x, new))
    # a load into weight_int8 alone: the packed copy follows it
    new = dict(new, weight_int8=torch.from_numpy(
        rng.integers(-127, 128, (16, 8)).astype(np.int8)))
    load_numpy_state(layer, {"weight_int8": new["weight_int8"].numpy()})
    assert torch.equal(layer._kernel_operands()[2],
                       QM.pack_weight(new["weight_int8"]))
    assert torch.equal(layer(x), quant.int8_linear(x, new))
    # the packed weight is a cache, not state
    assert sorted(layer.state_dict()) == ["act_scale", "weight_int8",
                                          "weight_scale"]


def test_int8_swap_reports_non_linear_layers(capsys):
    """A quantized layer of a type with no int8 executor (a transposed
    convolution: Conv2D has one since the convolution slice) stays on the
    fake-quant path and int8_swap says so, as the JAX version does."""

    class Conv2DTranspose(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.weight = torch.nn.Parameter(torch.ones(2, 2))

        def forward(self, x):
            return x @ self.weight

    model = Sequential(Conv2DTranspose(), Linear(2, 2, device="cpu"))
    q = quant.quantize_model(model, quant.QuantConfig(
        quantizable=("Linear", "Conv2DTranspose")))
    quant.calibrate(q, [torch.ones(3, 2)])
    assert quant.int8_swap(q, quant.freeze(q)) == 1
    assert "(Conv2DTranspose) has no int8 executor" in \
        capsys.readouterr().err
    assert isinstance(q[0], quant.QuantedLayer)
    assert isinstance(q[1], quant.Int8Linear)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_exactly():
    """On the card: quant_matmul and quant_linear against their plain
    versions, exactly, at MNIST's layer shapes and odd ones, per-tensor
    and per-channel scales, with and without bias and ReLU, float32 and
    bfloat16 out; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in ((8192, 784, 512), (8192, 512, 256), (8192, 256, 10),
                    (33, 100, 17), (1, 7, 5)):
        a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
        sa = torch.rand((), generator=gen, device="cuda") * 0.1
        for sb in (torch.rand((), generator=gen, device="cuda") * 0.1,
                   torch.rand((n,), generator=gen, device="cuda") * 0.1):
            for dt in (torch.float32, torch.bfloat16):
                n0 = QM.quant_matmul.launches
                got = QM.quant_matmul(a, b, sa, sb, out_dtype=dt)
                want = QM.quant_matmul_plain(a, b, sa, sb, out_dtype=dt)
                torch.cuda.synchronize()
                assert QM.quant_matmul.launches == n0 + 1
                assert torch.equal(got, want), (m, k, n, dt)
        # the fused form: float x encoded in the prologue, bias and ReLU
        x = torch.randn(m, k, generator=gen, device="cuda") * 2
        bias = torch.randn(n, generator=gen, device="cuda")
        packed = QM.pack_weight(b)
        for bb, relu, dt in itertools.product(
                (None, bias), (False, True), (torch.float32, torch.bfloat16)):
            n0 = QM.quant_linear.launches
            got = QM.quant_linear(x, packed, sa, sb, bb, relu, out_dtype=dt)
            want = QM.quant_linear_plain(x, packed, sa, sb, bb, relu,
                                         out_dtype=dt)
            torch.cuda.synchronize()
            assert QM.quant_linear.launches == n0 + 1
            assert torch.equal(got, want), (m, k, n, bb is None, relu, dt)
