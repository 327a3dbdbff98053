"""Context parallelism of the port (paddle_tpu_torch/parallel/
context_parallel.py) against the JAX package's, in value and gradient.

The port runs in a world of 4 gloo ranks (tests/torch_world.py), each on
its shard of the seeded global arrays under the JAX spec ``P("dp",
"sp")`` (``P("dp", None, "sp")`` for sharded_flash_attention's heads);
the JAX functions run on the global arrays over the same mesh on 4 of
the 8 CPU devices, jitted. The outputs and the gradients of sum(out *
cotangent) with respect to q, k and v are gathered from the ranks and
held at 2e-5 (float32, the same math summed in other orders).

- ring attention, both hops: the einsum hop (no force_flash) against the
  JAX einsum inner, with causal, kv_mask, segment_ids, a window and GQA;
  the flash hop (force_flash: the kernels' plain versions, the port's
  interpret mode) against the JAX flash inner (Pallas interpret) in one
  case and the JAX einsum inner in the others;
- Ulysses with causal, kv_mask, segment_ids, a window and GQA, and
  ``context_parallel_attention``'s dispatch;
- ``sharded_flash_attention`` over (dp, heads) with dropout: each rank's
  folded key seeds the generator whose seeds are the JAX shard's, so the
  masks are bit-equal to JAX's;
- each ``enforce`` of the JAX functions, on the rank's shapes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
import torch_world as W
from paddle_tpu.ops.attention import force_flash
from paddle_tpu.parallel import context_parallel as JCP

ATOL = 2e-5
B, T, H, D = 2, 256, 4, 64
MESHES = {"sp4": dict(dp=1, sp=4), "dp2sp2": dict(dp=2, sp=2)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = W.World(4, tmp_path_factory.mktemp("world"))
    yield w
    w.close()


def _jmesh(sizes):
    return pt.build_mesh(**sizes, devices=jax.devices()[:4])


def _inputs(hkv, seed, mask=False, segs=False):
    rng = np.random.default_rng(seed)
    q, ct = (rng.normal(size=(B, T, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(B, T, hkv, D)).astype(np.float32)
            for _ in range(2))
    km = seg = None
    if mask:
        km = np.ones((B, T), bool)
        km[0, 200:] = False
        km[1, 30:90] = False
    if segs:
        seg = np.ones((B, T), np.int32)
        seg[0, 50:170], seg[0, 170:] = 2, 3     # segments across shards
        seg[1, 100:] = 2
    return q, k, v, km, seg, ct


def _place(parts, sizes, spec, shape):
    """The global array from each rank's shard under ``spec``."""
    out = np.zeros(shape, np.float32)
    grid = (sizes.get("dp", 1), 1, 1, sizes.get("sp", 1), 1)
    for rank, part in enumerate(parts):
        coord = dict(zip(("dp", "pp", "tp", "sp", "ep"),
                         np.unravel_index(rank, grid)))
        idx = []
        for dim, n in enumerate(shape):
            ax = spec[dim] if dim < len(spec) else None
            if ax is None:
                idx.append(slice(None))
            else:
                k = n // grid[("dp", "pp", "tp", "sp", "ep").index(ax)]
                idx.append(slice(coord[ax] * k, (coord[ax] + 1) * k))
        out[tuple(idx)] = part
    return out


@functools.lru_cache(maxsize=None)
def _jax_fn(name, mesh_key, kw_items, has_km, has_seg, flash):
    jm = _jmesh(MESHES[mesh_key])
    kw = dict(kw_items)

    def f(q, k, v, km, seg, ct):
        extra = {}
        if has_km:
            extra["kv_mask"] = km
        if has_seg:
            extra["segment_ids"] = seg
        fn = lambda q, k, v: getattr(JCP, name)(q, k, v, mesh=jm, **kw,
                                                **extra)
        o, vjp = jax.vjp(fn, q, k, v)
        return o, vjp(ct)

    jf = jax.jit(f)

    def call(*args):
        with force_flash(flash):
            return jf(*args)

    return call


def _check(world, name, mesh_key, spec, kw, hkv, seed, mask=False,
           segs=False, port_flash=False, jax_flash=False):
    sizes = MESHES[mesh_key]
    q, k, v, km, seg, ct = _inputs(hkv, seed, mask, segs)
    j_o, j_g = _jax_fn(name, mesh_key, tuple(sorted(kw.items())), mask,
                       segs, jax_flash)(
        *(jnp.asarray(a) if a is not None else None
          for a in (q, k, v, km, seg, ct)))
    res = world.run(W.job_context_parallel, name, sizes, spec, q, k, v, kw,
                    km, seg, ct, port_flash)
    for i, (want, shape) in enumerate(zip((j_o,) + tuple(j_g),
                                          (q.shape, q.shape, k.shape,
                                           v.shape))):
        got = _place([r[i] for r in res], sizes, spec, shape)
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    return [r[4] for r in res]


SEQ = ("dp", "sp")


@pytest.mark.parametrize("kw,hkv,mask,segs", [
    (dict(causal=False), 4, False, False),
    (dict(causal=True), 2, False, False),
    (dict(causal=True), 4, True, True),
    (dict(causal=False, window=40), 2, True, False),
    (dict(causal=True, window=70), 4, False, True),
], ids=["plain", "causal-gqa", "causal-mask-ids", "window-gqa-mask",
        "causal-window-ids"])
def test_ring_einsum_hop_matches_jax(world, kw, hkv, mask, segs):
    hops = _check(world, "ring_attention", "sp4", SEQ, kw, hkv, 1, mask,
                  segs)
    assert hops == [0, 0, 0, 0]       # no flash hop: the einsum inner


def test_ring_flash_hop_matches_jax_flash(world):
    """Both flash inners: the port's plain hops, JAX's Pallas interpret
    kernels; causal GQA, so rank r runs r + 1 forward hops."""
    hops = _check(world, "ring_attention", "sp4", SEQ, dict(causal=True),
                  2, 2, port_flash=True, jax_flash=True)
    assert hops == [1, 2, 3, 4]


@pytest.mark.parametrize("kw,hkv,mask,segs,mesh_key", [
    (dict(causal=False), 4, True, True, "sp4"),
    (dict(causal=True), 2, True, False, "dp2sp2"),
], ids=["mask-ids", "causal-gqa-mask-dp2"])
def test_ring_flash_hop_matches_jax(world, kw, hkv, mask, segs, mesh_key):
    hops = _check(world, "ring_attention", mesh_key, SEQ, kw, hkv, 3, mask,
                  segs, port_flash=True)
    n = MESHES[mesh_key]["sp"]
    want = [(r % n) + 1 if kw["causal"] else n for r in range(4)]
    assert hops == want


@pytest.mark.parametrize("kw,hkv,mask,segs", [
    (dict(causal=True), 2, False, False),
    (dict(causal=False), 4, True, True),
    (dict(causal=True, window=50), 2, True, False),
], ids=["causal-gqa", "mask-ids", "causal-window-mask"])
def test_ulysses_matches_jax(world, kw, hkv, mask, segs):
    _check(world, "ulysses_attention", "dp2sp2", SEQ, kw, hkv, 4, mask,
           segs)


def test_context_parallel_attention_dispatches(world):
    _check(world, "context_parallel_attention", "dp2sp2", SEQ,
           dict(impl="ulysses", causal=True), 2, 5)
    _check(world, "context_parallel_attention", "sp4", SEQ,
           dict(impl="ring", causal=False), 2, 5)
    q, k, v, *_ = _inputs(2, 0)
    name, msg = world.run(W.job_cp_error, "context_parallel_attention",
                          MESHES["sp4"], q, k, v, dict(impl="sp"))[0]
    assert name == "ValueError" and "unknown context-parallel impl" in msg


def test_sharded_flash_attention_matches_jax(world):
    _check(world, "sharded_flash_attention", "dp2sp2", ("dp", None, "sp"),
           dict(causal=True, batch_axis="dp", head_axis="sp"), 2, 6,
           mask=True)


def test_sharded_flash_dropout_masks_are_jax_s(world):
    """Each shard folds its (dp, head) coordinates into the key; the
    port's generator seeded by the folded key maps to the seeds
    ``jax.random.randint`` draws from it, and the outputs agree."""
    import torch

    from paddle_tpu_torch.core.random import seed_generator

    jm = _jmesh(MESHES["dp2sp2"])
    q, k, v, *_ = _inputs(4, 7)
    key = jax.random.PRNGKey(11)
    p = 0.3
    j_o = jax.jit(lambda q, k, v: JCP.sharded_flash_attention(
        q, k, v, mesh=jm, batch_axis="dp", head_axis="sp", dropout_p=p,
        dropout_key=key))(q, k, v)
    seeds = {}
    for i in range(2):
        for j in range(2):
            folded = jax.random.fold_in(jax.random.fold_in(key, i), j)
            gen = seed_generator(torch.Generator(), np.asarray(folded))
            seeds[gen.initial_seed()] = np.asarray(jax.random.randint(
                folded, (B // 2, H // 2), -2 ** 31, 2 ** 31 - 1))
    res = world.run(W.job_sharded_flash_dropout, MESHES["dp2sp2"],
                    ("dp", None, "sp"), q, k, v, np.asarray(key), seeds, p)
    got = _place([r[0] for r in res], MESHES["dp2sp2"], ("dp", None, "sp"),
                 q.shape)
    np.testing.assert_allclose(got, np.asarray(j_o), atol=ATOL, rtol=0)
    used = [r[1][0] for r in res]
    assert len(set(used)) == 4            # each shard its own masks


@pytest.mark.parametrize("name,sizes,shapes,kw,match", [
    ("ring_attention", "sp4", ((2, 64, 4, 64), (2, 32, 4, 64)), {},
     "self-attention shaped"),
    ("ring_attention", "sp4", ((2, 64, 4, 64), (2, 64, 3, 64)), {},
     "multiple of kv heads"),
    ("ring_attention", "sp4", ((2, 64, 4, 64),) * 2, dict(window=0),
     "window must be >= 1"),
    ("ring_attention", "sp4", ((2, 64, 4, 64),) * 2,
     dict(kv_mask=np.ones((2, 32), bool)), "kv_mask must be"),
    ("ulysses_attention", "sp4", ((2, 64, 6, 64),) * 2, {},
     "must divide sp size"),
    ("ulysses_attention", "sp4", ((2, 64, 4, 64), (2, 64, 2, 64)), {},
     "kv heads 2 must divide sp size 4"),
    ("ulysses_attention", "sp4", ((2, 64, 4, 64), (2, 32, 4, 64)),
     dict(segment_ids=np.ones((2, 64), np.int32)), "self-attention"),
    ("sharded_flash_attention", "sp4", ((2, 64, 4, 64),) * 2,
     dict(head_axis="xx"), "is not a mesh axis"),
], ids=["ring-shape", "ring-gqa", "ring-window", "ring-mask", "ulysses-heads",
        "ulysses-kv-heads", "ulysses-ids", "sharded-axis"])
def test_enforce_errors(world, name, sizes, shapes, kw, match):
    import torch

    rng = np.random.default_rng(0)
    q = rng.normal(size=shapes[0]).astype(np.float32)
    k = rng.normal(size=shapes[1]).astype(np.float32)
    kw = {key: (torch.from_numpy(val) if isinstance(val, np.ndarray)
                else val) for key, val in kw.items()}
    err = world.run(W.job_cp_error, name, MESHES[sizes], q, k, k, kw)[0]
    assert err[0] == "EnforceError" and match in err[1], err
