"""The port's int8 convolution (``quant/int8.py`` ``int8_conv2d``,
``Int8Conv2D`` and the Conv2D branch of ``int8_swap``) against the JAX
package's, on the CPU, where ``quant_matmul`` takes its plain version.

Tolerances and why:
- ``int8_conv2d`` against the JAX ``int8_conv2d`` on the same frozen
  entry: exactly equal, for every variant of the JAX package's own tests
  (groups 1, grouped, depthwise, dilated, strided, NHWC, bias) and the
  stem's 7x7/2 (K = 147 columns, padded to 160 for the kernel). Integer
  sums are exact, and both scale in the same order: groups 1 as
  ``quant_matmul`` does, ``acc * (a_scale * w_scale)``; groups > 1 as
  the JAX integer conv does, ``(acc * a_scale) * w_scale``.
- PTQ -> freeze -> ``int8_swap`` on the JAX package's small CNN (3x3
  conv with ReLU, a grouped strided 3x3 conv, a 1x1 conv): the port's
  int8 model on the JAX frozen entries equal to the JAX swapped model's
  output exactly; the port's own freeze as JAX's (weights exactly,
  activation scales to rtol 1e-5: calibration sums floats in two
  orders); the int8 model within 0.1 of its fake-quant float model, the
  JAX package's bound.

The test marked ``gpu`` holds ``Int8Conv2D`` on the card against the
same layer on its plain version, exactly, and skips without a card:
``python3 -m pytest --noconftest -m gpu tests/test_torch_int8_conv.py``
(JAX is imported inside the CPU tests only)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import quant
from paddle_tpu_torch.core import InvalidArgumentError, UnimplementedError
from paddle_tpu_torch.ops.kernels import quant_matmul as QM
from paddle_tpu_torch.quant import int8 as TI
from paddle_tpu_torch.utils.convert import load_numpy_state

# name -> (C_in, O, kernel, stride, padding, dilation, groups, NHWC, bias)
VARIANTS = {
    "plain": (4, 8, 3, 1, 1, 1, 1, False, False),
    "strided": (4, 8, 3, 2, 1, 1, 1, False, True),
    "grouped": (8, 8, 3, 1, 1, 1, 4, False, False),
    "depthwise": (8, 8, 3, 1, 1, 1, 8, False, True),
    "dilated": (4, 8, 3, 1, 2, 2, 1, False, False),
    "nhwc": (4, 8, 3, 1, 1, 1, 1, True, True),
    "nhwc_grouped_strided": (8, 8, 3, 2, 1, 1, 2, True, False),
    "rect": (3, 5, (3, 2), (2, 1), (1, 0), 1, 1, False, False),
    "stem7x7": (3, 16, 7, 2, 3, 1, 1, False, False),
    "pointwise": (16, 8, 1, 1, 0, 1, 1, True, False),
}


def _entry(o, cpg, k, seed):
    rng = np.random.default_rng(seed)
    kk = (k, k) if isinstance(k, int) else k
    return {"weight_int8": rng.integers(-127, 128, (o, cpg) + kk
                                        ).astype(np.int8),
            "weight_scale": (rng.random(o) + 0.1).astype(np.float32),
            "act_scale": np.float32(2.5)}


def _variant(name, seed=0):
    cin, o, k, s, p, d, g, nhwc, bias = VARIANTS[name]
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(2, cin, 9, 10)).astype(np.float32)
    if nhwc:
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    b = rng.normal(size=o).astype(np.float32) if bias else None
    kw = dict(stride=s, padding=p, dilation=d, groups=g,
              data_format="NHWC" if nhwc else "NCHW")
    return x, _entry(o, cin // g, k, seed), b, kw


@pytest.mark.parametrize("name", list(VARIANTS))
def test_int8_conv2d_equals_jax_exactly(name):
    import jax.numpy as jnp

    from paddle_tpu.quant.int8 import int8_conv2d as jax_conv

    x, entry, b, kw = _variant(name)
    want = np.asarray(jax_conv(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in entry.items()},
        None if b is None else jnp.asarray(b), **kw))
    tentry = {k: torch.from_numpy(np.array(v)) for k, v in entry.items()}
    tb = None if b is None else torch.from_numpy(b)
    got = TI.int8_conv2d(torch.from_numpy(x), tentry, tb, **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    layer = TI.Int8Conv2D(tentry, bias=tb, **kw)
    np.testing.assert_array_equal(layer(torch.from_numpy(x)).numpy(), want)


def test_groups_one_is_one_quant_matmul_on_a_packed_weight(monkeypatch):
    """groups == 1: im2col in int8 into K16 columns (147 -> 160 at the
    stem), then one quant_matmul_packed call against the weight packed
    once per buffer version."""
    x, entry, _, kw = _variant("stem7x7")
    calls = []
    real = TI.quant_matmul_packed

    def spy(a, w, *args, **kwargs):
        calls.append((a.dtype, tuple(a.shape), tuple(w.shape)))
        return real(a, w, *args, **kwargs)

    monkeypatch.setattr(TI, "quant_matmul_packed", spy)
    layer = TI.Int8Conv2D({k: torch.from_numpy(np.array(v))
                           for k, v in entry.items()}, **kw)
    layer(torch.from_numpy(x))
    packed = layer._kernel_operands()[2]
    layer(torch.from_numpy(x))
    assert layer._kernel_operands()[2] is packed          # cached
    m = 2 * 5 * 5
    assert calls == [(torch.int8, (m, 160), (16, 160))] * 2
    # a load into the weight buffer re-packs
    new = np.random.default_rng(9).integers(-127, 128, (16, 3, 7, 7)
                                            ).astype(np.int8)
    load_numpy_state(layer, {"weight_int8": new})
    assert torch.equal(layer._kernel_operands()[2],
                       TI._conv_weight_packed(torch.from_numpy(new)))


def test_im2col_orders_columns_as_jax():
    import jax.numpy as jnp

    from paddle_tpu.quant.int8 import _im2col_nchw as jax_im2col

    x = np.random.default_rng(3).integers(-127, 128, (2, 3, 7, 6)).astype(
        np.int8)
    want, wshape = jax_im2col(jnp.asarray(x), 3, 2, (2, 1), (1, 0), 2)
    got, gshape = TI._im2col_nchw(torch.from_numpy(x), 3, 2, (2, 1), (1, 0),
                                  2)
    assert got.dtype == torch.int8 and gshape == wshape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_conv2d_errors_are_typed():
    x, entry, _, kw = _variant("plain")
    tentry = {k: torch.from_numpy(np.array(v)) for k, v in entry.items()}
    with pytest.raises(UnimplementedError, match="queue 2 item 3"):
        TI.int8_conv2d(torch.from_numpy(x), tentry, use_pallas=True)
    with pytest.raises(InvalidArgumentError, match="4-D"):
        TI.int8_conv2d(torch.from_numpy(x[0]), tentry)
    with pytest.raises(Exception, match="int8 frozen weights"):
        TI.int8_conv2d(torch.from_numpy(x), dict(
            tentry, weight_int8=tentry["weight_int8"].int()))


def _cnn(device="cpu"):
    return tnn.Sequential(
        tnn.Conv2D(3, 8, 3, padding=1, act="relu", device=device),
        tnn.Conv2D(8, 8, 3, stride=2, padding=1, groups=2, device=device),
        tnn.Conv2D(8, 4, 1, device=device))


def test_ptq_int8_swap_cnn_equals_jax():
    import jax.numpy as jnp

    import paddle_tpu as pt
    from paddle_tpu import nn as jnn
    from paddle_tpu import quant as JQ

    pt.seed(0)
    jm = JQ.quantize_model(jnn.Sequential(
        jnn.Conv2D(3, 8, 3, padding=1, act="relu"),
        jnn.Conv2D(8, 8, 3, stride=2, padding=1, groups=2),
        jnn.Conv2D(8, 4, 1)))
    params = {k: np.asarray(v) for k, v in jm.named_parameters().items()}
    rng = np.random.default_rng(4)
    batches = [rng.normal(0, 1, (2, 3, 8, 8)).astype(np.float32)
               for _ in range(3)]
    JQ.calibrate(jm, [jnp.asarray(b) for b in batches])
    jfrozen = JQ.freeze(jm)
    assert JQ.int8_swap(jm, jfrozen) == 3
    jm.eval()
    x = batches[0]
    want = np.asarray(jm(jnp.asarray(x)))

    # the port's own PTQ: freeze as JAX's, within 0.1 of its fake quant
    tm = quant.quantize_model(_cnn())
    load_numpy_state(tm, params)
    quant.calibrate(tm, [torch.from_numpy(b) for b in batches])
    tfrozen = quant.freeze(tm)
    assert sorted(tfrozen) == sorted(jfrozen) == ["0", "1", "2"]
    for path, je in jfrozen.items():
        te = tfrozen[path]
        np.testing.assert_array_equal(te["weight_int8"].numpy(),
                                      np.asarray(je["weight_int8"]))
        np.testing.assert_allclose(te["act_scale"].numpy(),
                                   np.asarray(je["act_scale"]), rtol=1e-5)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x))            # fake-quant float, eval
        assert quant.int8_swap(tm, tfrozen) == 3
        assert all(isinstance(tm[i], quant.Int8Conv2D) for i in range(3))
        out = tm(torch.from_numpy(x))
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    assert rel < 0.1, rel

    # the JAX frozen entries in the port: the JAX int8 output exactly
    pm = quant.quantize_model(_cnn())
    load_numpy_state(pm, params)
    pfrozen = {p: {k: (torch.from_numpy(np.array(v)) if k != "bits" else v)
                   for k, v in e.items()} for p, e in jfrozen.items()}
    assert quant.int8_swap(pm, pfrozen) == 3
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    # the swapped models' buffers carry by name, the int8 weights bit
    # for bit
    state = {k: np.asarray(v) for k, v in jm.named_buffers().items()}
    load_numpy_state(tm, state)
    assert sorted(dict(tm.named_buffers())) == sorted(state)


def test_conv_transpose_has_no_int8_executor(capsys):
    model = tnn.Sequential(tnn.Conv2DTranspose(3, 4, 3, device="cpu"),
                           tnn.Conv2D(4, 2, 1, device="cpu"))
    q = quant.quantize_model(model, quant.QuantConfig(
        quantizable=("Conv2DTranspose", "Conv2D")))
    quant.calibrate(q, [torch.randn(2, 3, 5, 5)])
    assert quant.int8_swap(q, quant.freeze(q)) == 1
    assert "(Conv2DTranspose) has no int8 executor" in \
        capsys.readouterr().err
    assert isinstance(q[0], quant.QuantedLayer)
    assert isinstance(q[1], quant.Int8Conv2D)


@pytest.mark.gpu
def test_cuda_int8_conv_matches_plain_exactly():
    """On the card: Int8Conv2D (groups 1: one quant_matmul launch a
    call; grouped and depthwise: the exact grouped product) against the
    same layer with the plain quant_matmul, exactly, in both layouts, at
    the stem's and the layer-4 3x3's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for cin, o, k, s, p, g, hw, fmt in (
            (3, 64, 7, 2, 3, 1, 224, "NHWC"), (512, 512, 3, 1, 1, 1, 7,
                                               "NCHW"),
            (64, 64, 3, 1, 1, 1, 56, "NHWC"), (32, 32, 3, 2, 1, 32, 28,
                                               "NCHW"),
            (32, 64, 3, 1, 1, 4, 14, "NHWC")):
        entry = {"weight_int8": torch.randint(
            -127, 128, (o, cin // g, k, k), generator=gen, device="cuda",
            dtype=torch.int8),
            "weight_scale": torch.rand((o,), generator=gen, device="cuda"),
            "act_scale": torch.tensor(3.0, device="cuda")}
        layer = TI.Int8Conv2D(entry, stride=s, padding=p, groups=g,
                              data_format=fmt).to("cuda")
        shape = (4, hw, hw, cin) if fmt == "NHWC" else (4, cin, hw, hw)
        x = torch.randn(shape, generator=gen, device="cuda")
        n0 = QM.quant_matmul.launches
        got = layer(x)
        torch.cuda.synchronize()
        assert QM.quant_matmul.launches == n0 + (g == 1)
        real = TI.quant_matmul_packed
        TI.quant_matmul_packed = lambda a, w, *r, **kw: \
            QM.quant_matmul_plain(a, w[:, :a.shape[1]].t(), *r, **kw)
        try:
            want = layer(x)
        finally:
            TI.quant_matmul_packed = real
        assert torch.equal(got, want), (cin, o, k, g, fmt)
