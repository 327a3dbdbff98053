"""The port's public namespaces hold every public name of the JAX
package's ``ops``, ``nn.layers`` and ``metrics`` (the names those
modules merely import, such as ``jax``, ``jnp``, ``math`` and
``typing.Callable``, aside), and the detection slice's classes and
functions are where users look for them.

Of the top-level package, ``slim``, ``quant``, ``core``, ``parallel``,
``nn``, ``nn.layer``, ``data``, ``data.bucketing`` and ``initializer``,
the names still missing are exactly those that later entries of
ROADMAP.md queue 1 own, each named with its entry."""

import ast
import importlib
import inspect
import types

import pytest

import paddle_tpu.metrics
import paddle_tpu.nn.layers
import paddle_tpu.ops
import paddle_tpu_torch.metrics
import paddle_tpu_torch.nn.layers
import paddle_tpu_torch.ops

ENTRY_7 = "queue 1 entry 7 (item 8, the profiler)"
ENTRY_8 = "queue 1 entry 8 (item 12, compat surfaces)"
# module -> {name still missing from the port: the entry that owns it}.
# Entry 6's mesh, collectives, context parallelism, plans, the int8
# gradient all-reduce, pipelines, the hybrid steps, the sharded
# embedding, dgc and geo-sgd are ported
STILL_MISSING = {
    "": {},
    "slim": {},
    "quant": {},
    "core": {**dict.fromkeys(("RecordEvent", "profiler", "start_profiler",
                              "stop_profiler"), ENTRY_7),
             **dict.fromkeys(("BuildStrategy", "ExecutionStrategy"),
                             ENTRY_8)},
    "parallel": {},
    "nn": {},
    "nn.layer": {},
    "data": dict.fromkeys(
        ("BPETokenizer", "DataFeeder", "DeviceLoader", "Fake",
         "MultiSlotDataGenerator", "MultiSlotDataset", "PipeReader",
         "batch", "buffered", "cache", "chain", "compose", "creator",
         "dataset", "firstn", "map_readers", "multiprocess_reader",
         "shuffle", "train_from_dataset", "xmap_readers"), ENTRY_8),
    "data.bucketing": {},
    "initializer": {},
}


def _imported_submodules(module):
    """The submodules ``module``'s source imports by name (``from .
    import a, b``): other submodules appear as attributes only once some
    other code has imported them."""
    tree = ast.parse(inspect.getsource(module))
    return {alias.asname or alias.name for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and node.module is None
            and node.level == 1 for alias in node.names}


def _public(module):
    """The public names ``module`` defines or re-exports: not an
    imported foreign module, a submodule its source does not import, or
    a typing name."""
    own = _imported_submodules(module)
    out = set()
    for name, obj in vars(module).items():
        if name.startswith("_"):
            continue
        if isinstance(obj, types.ModuleType) and name not in own:
            continue
        if getattr(obj, "__module__", None) == "typing":
            continue
        out.add(name)
    return out


@pytest.mark.parametrize("jax_mod,port_mod", [
    (paddle_tpu.ops, paddle_tpu_torch.ops),
    (paddle_tpu.nn.layers, paddle_tpu_torch.nn.layers),
    (paddle_tpu.metrics, paddle_tpu_torch.metrics)],
    ids=["ops", "nn.layers", "metrics"])
def test_no_public_name_of_the_jax_module_is_missing(jax_mod, port_mod):
    missing = _public(jax_mod) - set(dir(port_mod))
    assert not missing, sorted(missing)


def test_the_detection_slice_is_where_users_look():
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.ops import detection, detection_extra, nn_extra

    assert paddle_tpu_torch.nn.layers.LayerList is nn.LayerList
    assert inspect.isclass(paddle_tpu_torch.nn.layers.MultiBoxHead)
    assert nn.SpectralNorm is paddle_tpu_torch.nn.layers.SpectralNorm
    assert paddle_tpu_torch.metrics.DetectionMAP.__module__ == \
        "paddle_tpu_torch.metrics"
    assert paddle_tpu_torch.ops.detection is detection
    assert paddle_tpu_torch.ops.detection_extra is detection_extra
    assert paddle_tpu_torch.ops.nn_extra is nn_extra
    assert paddle_tpu_torch.ops.yolov3_loss is detection_extra.yolov3_loss
    assert paddle_tpu_torch.ops.interpolate is paddle_tpu_torch.ops.nn.\
        interpolate


@pytest.mark.parametrize("name", sorted(STILL_MISSING),
                         ids=[n or "top-level" for n in sorted(STILL_MISSING)])
def test_only_names_of_later_entries_are_missing(name):
    suffix = "." + name if name else ""
    jax_mod = importlib.import_module("paddle_tpu" + suffix)
    port_mod = importlib.import_module("paddle_tpu_torch" + suffix)
    missing = _public(jax_mod) - set(dir(port_mod))
    assert missing == set(STILL_MISSING[name]), (
        sorted(missing - set(STILL_MISSING[name])),
        sorted(set(STILL_MISSING[name]) - missing))


def test_fleet_is_a_lazy_top_level_name():
    """``paddle_tpu_torch.fleet`` loads on first access, as
    ``paddle_tpu.fleet`` does (the JAX package's lazy map), and keeps
    the JAX fleet's public names."""
    import paddle_tpu

    port = paddle_tpu_torch.fleet
    assert port is importlib.import_module("paddle_tpu_torch.fleet")
    assert set(paddle_tpu.fleet.__all__) == set(port.__all__)
    with pytest.raises(AttributeError):
        paddle_tpu_torch.no_such_module
