"""The port's meshes and collectives (paddle_tpu_torch/core/mesh.py,
paddle_tpu_torch/parallel/collective.py) against the JAX package's.

- Layouts, in this process: the rank array of ``build_mesh``,
  ``build_multihost_mesh`` and ``build_hybrid_mesh`` (given the ranks
  0..7, as the JAX builders are given 8 devices) against the JAX meshes'
  device ids, so rank r sits where the JAX mesh puts device r; the
  one-rank ``get_mesh()`` without a process group; the named sharding's
  slices and DTensor placements.
- In a world of 4 gloo ranks (tests/torch_world.py), mesh dp=2 x sp=2:
  each rank's coordinates; every collective's value on the rank's row of
  a seeded (4, 4, 8) array, and the gradient of sum(out * cotangent)
  where JAX has one, against the JAX function inside ``shard_map``
  (``check_vma=False``) over 4 of the 8 CPU devices, with the array
  split over ("dp", "sp"); values at 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import torch_world as W
from jax.sharding import PartitionSpec as JP
from paddle_tpu.parallel import collective as JC
from paddle_tpu.utils.compat import shard_map
from paddle_tpu_torch.core import EnforceError
from paddle_tpu_torch.core import mesh as M

ATOL = 1e-6


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = W.World(4, tmp_path_factory.mktemp("world"))
    yield w
    w.close()


def _ids(jmesh):
    return np.vectorize(lambda d: d.id)(jmesh.devices)


@pytest.mark.parametrize("sizes", [
    dict(dp=8), dict(dp=2, sp=4), dict(dp=2, tp=2, sp=2),
    dict(pp=2, tp=2, ep=2), dict(sp=8)])
def test_build_mesh_layout_matches_jax(sizes):
    jm = pt.build_mesh(**sizes, devices=jax.devices()[:8])
    tm = M.build_mesh(**sizes, devices=range(8), device="cpu")
    assert tm.devices.tolist() == _ids(jm).tolist()
    assert tm.shape == dict(jm.shape)


@pytest.mark.parametrize("kw", [
    dict(world_size=2, dcn_axis="dp", dp=4, sp=2),
    dict(world_size=2, dcn_axis="sp", dp=2, sp=4),
    dict(world_size=4, dcn_axis="tp", tp=4, sp=2)])
def test_multihost_layout_matches_jax(kw):
    from paddle_tpu.core.mesh import build_multihost_mesh

    jm = build_multihost_mesh(**kw, devices=jax.devices()[:8])
    tm = M.build_multihost_mesh(**kw, devices=range(8), device="cpu")
    assert tm.devices.tolist() == _ids(jm).tolist()


@pytest.mark.parametrize("kw", [dict(dcn_dp=2, dp=2, sp=2),
                                dict(dcn_dp=4, tp=2)])
def test_hybrid_layout_matches_jax(kw):
    from paddle_tpu.core.mesh import build_hybrid_mesh

    jm = build_hybrid_mesh(**kw, devices=jax.devices()[:8])
    tm = M.build_hybrid_mesh(**kw, devices=range(8), device="cpu")
    assert tm.devices.tolist() == _ids(jm).tolist()


def test_one_rank_mesh_without_a_process_group():
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import collective as C

    assert not dist.is_initialized()
    m = M.get_mesh()
    assert m.shape == dict.fromkeys(M.AXIS_NAMES, 1) and m.rank == 0
    x = torch.arange(6.0).reshape(2, 3).requires_grad_()
    for out in (C.allreduce(x, "sp"), C.allgather(x, ("dp", "sp")),
                C.reduce_scatter(x, "dp"), C.all_to_all(x, "sp", 0, 1),
                C.ppermute(x, "sp", [(0, 0)]), C.broadcast(x, "dp")):
        assert out is x
    assert C.allgather(x, "sp", tiled=False).shape == (1, 2, 3)
    assert C.axis_index("sp") == 0 and M.axis_size("sp") == 1
    assert not dist.is_initialized()
    with pytest.raises(EnforceError, match="mesh size 2 != device count 1"):
        M.build_mesh(dp=2)
    layout = M.build_mesh(dp=2, devices=[0, 1], device="cpu")
    with pytest.raises(EnforceError, match="no process group"):
        layout.group("dp")
    with M.mesh_scope(layout):
        assert M.get_mesh() is layout and M.axis_size("dp") == 2
    assert M.get_mesh() is m


def test_named_sharding_slices_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    m = M.build_mesh(dp=2, sp=4, devices=range(8), device="cpu")
    x = np.arange(4 * 8 * 3).reshape(4, 8, 3)
    s = M.sharding(M.P("dp", "sp"), m)
    # rank 0 is (dp 0, sp 0)
    np.testing.assert_array_equal(s.local(x), x[:2, :2])
    assert s.placements == (Shard(0), Replicate(), Replicate(), Shard(1),
                            Replicate())
    assert M.replicated(m).local(x) is not None
    assert M.data_sharding(m).index(x.shape) == (slice(0, 2), slice(None),
                                                 slice(None))
    from paddle_tpu_torch.core.config import DistributeConfig

    cfg = M.from_config(DistributeConfig(dp=2, sp=4), devices=range(8))
    assert cfg.devices.tolist() == m.devices.tolist()
    assert M.auto_mesh(range(1)).shape["dp"] == 1
    with pytest.raises(EnforceError, match="does not split"):
        s.index((3, 8))
    with pytest.raises(EnforceError, match="unknown mesh axis"):
        M.sharding(M.P("xx"), m)


def test_ranks_sit_where_jax_puts_their_devices(world):
    jm = pt.build_mesh(dp=2, sp=2, devices=jax.devices()[:4])
    ids = _ids(jm)
    for rank, coord, devices in world.run(W.job_mesh_coordinates,
                                          dict(dp=2, sp=2)):
        assert devices == ids.tolist()
        assert ids[tuple(coord[a] for a in M.AXIS_NAMES)] == rank


def test_device_mesh_has_the_jax_axes(world):
    for names, shape, coord, rank in world.run(W.job_device_mesh,
                                               dict(dp=2, sp=2)):
        assert names == M.AXIS_NAMES and shape == (2, 1, 1, 2, 1)
        assert list(coord) == [rank // 2, 0, 0, rank % 2, 0]


def test_ranks_build_the_same_parameters(world):
    sums = world.run(W.job_params_agree)
    assert len(set(sums)) == 1


def _jax_collective(name, x, axis, kw, cot):
    mesh = pt.build_mesh(dp=2, sp=2, devices=jax.devices()[:4])
    spec = JP(("dp", "sp"))

    def inner(xl):
        return getattr(JC, name)(xl[0], axis, **kw)[None]

    f = jax.jit(shard_map(inner, mesh=mesh, in_specs=spec, out_specs=spec,
                          check_vma=False))
    out = np.asarray(f(jnp.asarray(x)))
    grad = None
    if cot is not None:
        grad = np.asarray(jax.jit(jax.grad(
            lambda a: (f(a) * cot).sum()))(jnp.asarray(x)))
    return out, grad


CASES = [
    ("allreduce", "sp", dict(op="sum")),
    ("allreduce", "dp", dict(op="mean")),
    ("allreduce", ("dp", "sp"), dict(op="sum")),
    ("allreduce", ("sp", "dp"), dict(op="max")),
    ("allreduce", "sp", dict(op="min")),
    ("allgather", "sp", dict(tiled=True)),
    ("allgather", ("sp", "dp"), dict(tiled=True)),
    ("allgather", "dp", dict(tiled=False)),
    ("reduce_scatter", "sp", dict(scatter_dimension=0)),
    ("reduce_scatter", ("dp", "sp"), dict(scatter_dimension=0)),
    ("all_to_all", "sp", dict(split_axis=0, concat_axis=1)),
    ("all_to_all", ("sp", "dp"), dict(split_axis=1, concat_axis=0)),
    ("ppermute", "sp", dict(perm=[(0, 1), (1, 0)])),
    ("ppermute", ("dp", "sp"), dict(perm=[(0, 2), (2, 3), (3, 0)])),
    ("broadcast", "sp", dict(src=1)),
    ("broadcast", ("dp", "sp"), dict(src=2)),
]


@pytest.mark.parametrize("name,axis,kw", CASES,
                         ids=[f"{n}-{a}-{'-'.join(map(str, k.values()))}"
                              for n, a, k in CASES])
def test_collective_matches_jax(world, name, axis, kw):
    rng = np.random.default_rng(len(str(kw)))
    x = rng.normal(size=(4, 4, 8)).astype(np.float32)
    differentiable = kw.get("op") not in ("max", "min")
    j_out, j_grad = _jax_collective(name, x, axis, kw, None)
    cot = None
    if differentiable:
        cot = rng.normal(size=j_out.shape).astype(np.float32)
        _, j_grad = _jax_collective(name, x, axis, kw, cot)
    res = world.run(W.job_collective, name, x, axis, kw, cot)
    for rank, (out, grad) in enumerate(res):
        np.testing.assert_allclose(out, j_out[rank], atol=ATOL, rtol=0)
        if differentiable:
            np.testing.assert_allclose(grad, j_grad[rank], atol=ATOL,
                                       rtol=0)


@pytest.mark.parametrize("axis", ["dp", "sp", ("dp", "sp"), ("sp", "dp")])
def test_axis_index_matches_jax(world, axis):
    mesh = pt.build_mesh(dp=2, sp=2, devices=jax.devices()[:4])
    f = shard_map(lambda: jax.lax.axis_index(axis)[None], mesh=mesh,
                  in_specs=(), out_specs=JP(("dp", "sp")), check_vma=False)
    assert world.run(W.job_axis_index, axis) == np.asarray(f()).tolist()


def test_ppermute_of_a_tuple_and_max_without_gradient(world):
    x = np.random.default_rng(3).normal(size=(4, 5)).astype(np.float32)
    perm = [(i, (i + 1) % 4) for i in range(4)]
    for rank, (a, b) in enumerate(world.run(W.job_ppermute_many, x, perm)):
        np.testing.assert_array_equal(a, x[(rank - 1) % 4])
        np.testing.assert_array_equal(b, x[(rank - 1) % 4] > 0)
    for value, err, msg in world.run(W.job_allreduce_max_has_no_grad):
        np.testing.assert_array_equal(value, np.full(3, 4.0))
        assert err == "UnimplementedError" and "pmax" in msg
