"""The surface gaps of files the port had already: ``core/enforce.py``,
``core/places.py``, ``nn/layer.py`` (the Paddle-style state methods and
``Parameter``), ``data/bucketing.py``, ``initializer.py`` and the
package re-exports, each against the JAX package on the CPU.

- the enforce helpers raise the same error types with the same
  messages;
- ``Layer`` traversal and setters on ``GPTConfig.tiny()``: sublayer
  paths and types in the same pre-order, the same parameters after
  ``set_parameters`` (an unknown own name raises the same message, a
  dotted name under no sublayer is skipped), ``set_buffers`` that never
  raises, ``update_buffer`` that does; ``Parameter`` registration and
  the update of an existing parameter by assignment;
- bucketing: equal outputs on seeded lengths;
- the initializer aliases are their targets;
- places: where the port keeps the JAX names but means the CUDA card,
  each difference is pinned (with no card: a cuda place raises instead
  of letting the CPU play the accelerator; ``default_place`` answers
  the CPU while ``resolve_device(None)`` still raises; only
  ``set_device`` changes what it returns)."""

import contextlib
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import initializer as JI
from paddle_tpu import nn as jnn
from paddle_tpu.core import places as JP
from paddle_tpu.data import bucketing as JB
from paddle_tpu.models import gpt as JG
from paddle_tpu_torch import data as tdata
from paddle_tpu_torch import initializer as TI
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core import config as TC
from paddle_tpu_torch.core import places as TP
from paddle_tpu_torch.data import bucketing as TB
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.utils.convert import load_numpy_state

# the modules (each package's core re-exports a function named enforce)
JE = importlib.import_module("paddle_tpu.core.enforce")
TE = importlib.import_module("paddle_tpu_torch.core.enforce")


def _raised(fn, *args):
    try:
        fn(*args)
    except Exception as e:     # noqa: BLE001 - the type is the result
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("name,args", [
    ("enforce_eq", (1, 2, "sizes")), ("enforce_eq", ("a", "a")),
    ("enforce_in", (3, [1, 2], "known")), ("enforce_in", (1, [1, 2])),
    ("not_found", ("no such var x",)),
    ("invalid_argument", ("bad shape",)),
    ("unimplemented", ("not yet",)),
    ("enforce", (False, "x is %s", 3))])
def test_enforce_helpers_raise_as_jax(name, args):
    got = _raised(getattr(TE, name), *args)
    assert got == _raised(getattr(JE, name), *args)
    if got is not None:
        assert issubclass(getattr(TE, got[0]), TE.EnforceError)


def test_core_and_top_level_reexports():
    from paddle_tpu_torch import core

    assert core.FLAGS is TC.FLAGS is ptt.FLAGS
    assert core.NotFoundError is TE.NotFoundError
    for name in ("Place", "CPUPlace", "TPUPlace", "default_place",
                 "device_count", "is_compiled_with_tpu", "set_device"):
        assert getattr(ptt, name) is getattr(TP, name) is getattr(core, name)
    assert core.device_pool is TP.device_pool
    import paddle_tpu_torch.ops

    assert ptt.ops is paddle_tpu_torch.ops
    assert tnn.Parameter is tnn.layer.Parameter
    for name in ("bucket_by_length", "pad_to", "quantile_boundaries"):
        assert getattr(tdata, name) is getattr(TB, name)


# ---------------------------------------------------------------------------
# Layer
# ---------------------------------------------------------------------------


@pytest.fixture
def gpts():
    pt.seed(0)
    jm = JG.GPTForCausalLM(JG.GPTConfig.tiny())
    tm = TG.GPTForCausalLM(TG.GPTConfig.tiny(), device="cpu")
    load_numpy_state(tm, {k: np.asarray(v)
                          for k, v in jm.named_parameters().items()})
    return tm, jm


def _params(m):
    p = m.named_parameters()
    return {k: np.asarray(v.detach() if torch.is_tensor(v) else v)
            for k, v in (p.items() if isinstance(p, dict) else p)}


def _same_params(tm, jm):
    t, j = _params(tm), _params(jm)
    assert list(t) == list(j)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_sublayer_traversal_matches_jax(gpts):
    tm, jm = gpts
    for t, j in ((tm, jm), (tm.blocks, jm.blocks), (tm.blocks[0],
                                                     jm.blocks[0])):
        tn, jn = list(t.named_sublayers()), list(j.named_sublayers())
        assert [n for n, _ in tn] == [n for n, _ in jn]
        assert [type(l).__name__ for _, l in tn] == \
            [type(l).__name__ for _, l in jn]
        assert [type(l).__name__ for l in t.sublayers()] == \
            [type(l).__name__ for l in j.sublayers()]
    # pre-order with the layer itself left out (torch's named_modules
    # yields the root first)
    assert list(tm.named_sublayers(prefix="m."))[0][0] == "m.embed"
    assert len(tm.sublayers()) == len(list(tm.modules())) - 1


def test_set_parameters_matches_jax(gpts):
    tm, jm = gpts
    rng = np.random.default_rng(3)
    new = {k: rng.normal(size=np.shape(v)).astype(np.float32)
           for k, v in _params(jm).items() if "blocks.1" in k
           or k == "norm_f.weight"}
    new["nothere.weight"] = np.zeros(3, np.float32)   # skipped by both
    keep = dict(tm.named_parameters())
    tm.set_parameters(new)
    jm.set_parameters({k: jnp.asarray(v) for k, v in new.items()})
    _same_params(tm, jm)
    # in place: the model's parameter objects stay
    assert all(p is keep[k] for k, p in tm.named_parameters())
    # an unknown name of a layer's own raises the same message
    t = _raised(tm.blocks[0].set_parameters, {"bogus": np.zeros(2)})
    j = _raised(jm.blocks[0].set_parameters, {"bogus": jnp.zeros(2)})
    assert t == j == ("EnforceError", "unknown parameter bogus on GPTBlock")
    # a new shape gives a new parameter of the layer's dtype and device
    tm.embed.set_parameters({"weight": np.ones((7, 128))})
    assert tm.embed.weight.shape == (7, 128)
    assert tm.embed.weight.dtype == torch.float32
    assert isinstance(tm.embed.weight, torch.nn.Parameter)


def test_set_buffers_and_update_buffer_match_jax(gpts):
    tm, jm = gpts
    flat = {"blocks.0.norm1.extra": np.arange(3, dtype=np.float32),
            "norm_f.stat": np.ones(2, np.float32),
            "nothere.x": np.zeros(1, np.float32)}
    tm.set_buffers(flat)                       # never raises
    jm.set_buffers({k: jnp.asarray(v) for k, v in flat.items()})
    tb, jb = dict(tm.named_buffers()), jm.named_buffers()
    assert list(tb) == list(jb) == ["blocks.0.norm1.extra", "norm_f.stat"]
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    tm.norm_f.update_buffer("stat", torch.full((2,), 5.0))
    assert float(dict(tm.named_buffers())["norm_f.stat"][0]) == 5.0
    t = _raised(tm.norm_f.update_buffer, "nope", torch.zeros(1))
    j = _raised(jm.norm_f.update_buffer, "nope", jnp.zeros(1))
    assert t == j == ("EnforceError", "unknown buffer nope")


def test_add_sublayer_and_parameter_registration_match_jax():
    pt.seed(0)
    ptt.seed(0)
    jl, tl = jnn.Linear(3, 4), tnn.Linear(3, 4, device="cpu")
    load_numpy_state(tl, _params(jl))
    value = np.random.default_rng(4).normal(size=(4,)).astype(np.float64)
    jl.scale = jnn.layer.Parameter(value)
    tl.scale = tnn.Parameter(value)
    assert isinstance(tl.scale, torch.nn.Parameter) and tl.scale.requires_grad
    # a float64 array comes in as float32, as jnp.asarray gives it
    assert tl.scale.dtype == torch.float32
    assert np.asarray(jl.scale).dtype == np.float32
    w = np.full((3, 4), 0.5, np.float32)
    jl.weight = w                      # updates the existing parameter
    keep = tl.weight
    tl.weight = w
    assert tl.weight is keep
    j2, t2 = jnn.Linear(4, 2), tnn.Linear(4, 2, device="cpu")
    load_numpy_state(t2, _params(j2))
    assert jl.add_sublayer("head", j2) is j2
    assert tl.add_sublayer("head", t2) is t2
    _same_params(tl, jl)
    with pytest.raises(TypeError):             # torch's own rule
        torch.nn.Linear(3, 4).weight = torch.zeros(4, 3)


# ---------------------------------------------------------------------------
# bucketing, initializer aliases
# ---------------------------------------------------------------------------


def _lengths(seed=5, n=200):
    return np.random.default_rng(seed).integers(3, 120, n).tolist()


@pytest.mark.parametrize("num,round_to", [(1, 8), (4, 8), (6, 16), (50, 1)])
def test_quantile_boundaries_match(num, round_to):
    ls = _lengths()
    assert TB.quantile_boundaries(ls, num, round_to) == \
        JB.quantile_boundaries(ls, num, round_to)


def test_bucket_by_length_and_pad_to_match():
    rng = np.random.default_rng(6)
    samples = [rng.integers(0, 50, n) for n in _lengths(7, 60)]
    tuples = [(s, i) for i, s in enumerate(samples)]
    bounds = [16, 48, 96]
    for data, kw in ((samples, {"drop_long": True}),
                     (tuples, {"drop_long": True, "pad_value": -1}),
                     (samples, {"drop_long": True,
                                "length_of": lambda s: len(s) + 20})):
        got = list(TB.bucket_by_length(lambda: iter(data), bounds, 8,
                                       **kw)())
        want = list(JB.bucket_by_length(lambda: iter(data), bounds, 8,
                                        **kw)())
        assert len(got) == len(want) > 3
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            np.testing.assert_array_equal(g["data"], w["data"])
            np.testing.assert_array_equal(g["lengths"], w["lengths"])
            assert g.get("extras") == w.get("extras")
        assert TB.compile_shape_count(got) == JB.compile_shape_count(want)
    for mod in (TB, JB):
        with pytest.raises(Exception, match="exceeds largest bucket 96"):
            list(mod.bucket_by_length(lambda: iter(samples), bounds, 8)())
        with pytest.raises(Exception, match="strictly increasing"):
            mod.bucket_by_length(lambda: iter([]), [4, 4], 2)
    s = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_array_equal(TB.pad_to(s, 9, 2.0), JB.pad_to(s, 9, 2.0))
    assert _raised(TB.pad_to, s, 4) == _raised(JB.pad_to, s, 4)


def test_initializer_aliases_are_their_targets():
    pairs = {"ConstantInitializer": "Constant",
             "UniformInitializer": "Uniform",
             "NormalInitializer": "Normal",
             "TruncatedNormalInitializer": "TruncatedNormal",
             "XavierInitializer": "XavierUniform",
             "MSRAInitializer": "MSRA", "BilinearInitializer": "Bilinear",
             "NumpyArrayInitializer": "NumpyArray"}
    for alias, target in pairs.items():
        assert getattr(JI, alias) is getattr(JI, target)
        assert getattr(TI, alias) is getattr(TI, target)
    assert TI.force_init_on_cpu() is JI.force_init_on_cpu() is False
    for mod in (TI, JI):
        with mod.init_on_cpu():
            pass
        assert isinstance(mod.init_on_cpu(),
                          contextlib.AbstractContextManager)


# ---------------------------------------------------------------------------
# places: the JAX names, meaning the CUDA card
# ---------------------------------------------------------------------------


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(TP, "_default_device", None)


def test_places_print_as_jax_with_the_card_as_cuda():
    assert repr(TP.CPUPlace(0)) == repr(JP.CPUPlace(0)) == "CPUPlace(0)"
    assert repr(JP.TPUPlace(1)) == "TPUPlace(1)"
    assert repr(TP.TPUPlace(1)) == "CUDAPlace(1)"
    assert TP.Place("tpu", 2) == TP.TPUPlace(2) == TP.Place("cuda", 2)
    assert hash(TP.TPUPlace(0)) == hash(TP.Place("cuda", 0))
    with pytest.raises(TE.EnforceError, match="place kind must be"):
        TP.Place("gpu")


def test_no_card_raises_where_jax_lets_the_cpu_play_the_accelerator(
        no_card):
    # the JAX package: with no accelerator, a CPU device plays TPU
    assert JP.TPUPlace(0).device().platform == "cpu"
    with pytest.raises(TE.DeviceUnavailableError, match="device='cpu'"):
        TP.TPUPlace(0).device()
    with pytest.raises(TE.DeviceUnavailableError):
        TP.set_device(TP.TPUPlace(0))
    assert not TP.is_compiled_with_tpu()
    assert TP.device_pool("tpu") == [] and TP.device_count("cuda") == 0


def test_default_place_is_a_query_only(no_card):
    assert TP.default_place() == TP.CPUPlace(0)
    assert repr(TP.default_place()) == repr(JP.default_place())
    assert TP.device_pool() == [TP.CPUPlace(0)] and TP.device_count() == 1
    assert TP.CPUPlace(0).device() == torch.device("cpu")
    with pytest.raises(TE.NotFoundError,
                       match=r"no cpu device with ordinal 1 \(found 1\)"):
        TP.CPUPlace(1).device()
    # no entry point resolves its device through default_place
    with pytest.raises(TE.DeviceUnavailableError):
        TP.resolve_device(None)
    with pytest.raises(TE.DeviceUnavailableError):
        TG.GPTForCausalLM(TG.GPTConfig.tiny())


def test_set_device_is_the_only_change_to_the_default(no_card):
    assert TP.set_device(TP.CPUPlace(0)) == TP.CPUPlace(0)
    assert TP.resolve_device(None) == torch.device("cpu")
    model = TG.GPTForCausalLM(TG.GPTConfig.tiny())
    assert model.device == torch.device("cpu")
    # an explicit device still wins
    assert TP.resolve_device("cpu") == torch.device("cpu")
