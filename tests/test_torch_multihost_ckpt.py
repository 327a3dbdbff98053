"""Per-host checkpoints of the port (paddle_tpu_torch/checkpoint.py) on 4
gloo ranks (tests/torch_world.py; the ranks' jobs in
tests/torch_ckpt_jobs.py) against the JAX package's checkpoint.py:

- a GPT trained 2 Adam steps under Plan(fsdp=2, tp=2) and saved per host
  restores bit-equal in the JAX ``restore_state`` (every region written
  once, the sidecars, ``COMMITTED`` with the process count), and on the
  port's ranks under Plan(fsdp=4) (each leaf back on its new shard, the
  next step's loss equal on every rank);
- a JAX ``per_host=True`` save on the 8-device CPU sim restores on the
  port's ranks under Plan(fsdp=4) and Plan(dp=2, fsdp=2), bit-equal
  shard by shard (bfloat16 included), by the saved specs and by given
  shardings;
- an ep-placed table across ep shapes, onto a mesh without ep, a dense
  checkpoint onto an ep plan, and HostBackedTable.load of the per-host
  save (tests/test_embedding_ckpt.py:34-82);
- a coordinated save with a rank marked dead raises BarrierTimeoutError
  naming it and leaves no GLOBAL_COMMITTED; with every rank it lands;
- ``agree_restore_step`` over the store picks the newest common step."""

import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from paddle_tpu import checkpoint as JC

import torch_ckpt_jobs as J
import torch_world as W

from test_torch_plan import GPT_CFG


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = W.World(4, tmp_path_factory.mktemp("world"))
    yield w
    w.close()


def _flat_jax(tree):
    flat, _ = JC._leaf_paths(tree)
    return {p: np.asarray(v) for p, v in flat}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _ids(seed, b=4, t=16):
    return np.random.default_rng(seed).integers(0, 512, (b, t))


def test_port_per_host_save_restores_in_jax_and_across_plans(world,
                                                              tmp_path):
    d = str(tmp_path / "gpt")
    ids = _ids(3)
    res = world.run(J.job_gpt_save, GPT_CFG,
                    dict(fsdp=2, tp=2, rules="tp"), ids, 2, d)
    want = res[0]["whole"]
    man = json.load(open(os.path.join(d, "manifest.json")))
    regions = [s["file"] for e in man["leaves"] for s in e.get("shards", [])]
    whole = [e["file"] for e in man["leaves"] if "shards" not in e]
    assert regions and whole
    on_disk = set(os.listdir(d))
    assert set(regions + whole) <= on_disk
    # every region written once: the files the ranks wrote add up
    assert sum(r["wrote"] for r in res) == len(regions) + len(whole)
    # a rank that wrote regions left its checksums beside rank 0's
    # manifest; the tp rules split every large leaf over tp alone, so
    # the ranks at fsdp 1 (2 and 3) hold no region's first copy
    sidecars = {f"checksums.{r}.json" for r in range(1, 4)
                if res[r]["wrote"]}
    assert sidecars == {n for n in on_disk if n.startswith("checksums.")}
    assert [bool(r["wrote"]) for r in res] == [True, True, False, False]
    assert json.load(open(os.path.join(d, "COMMITTED")))[
        "process_count"] == 4
    specs = {e["path"]: e["spec"] for e in man["leaves"]}
    assert specs["params/blocks.0.self_attn.q_proj.weight"] == [None, "tp"]
    got = _flat_jax(JC.restore_state(d))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(_bits(got[k]), v, err_msg=k)
    # the port's ranks, under another plan shape
    back = world.run(J.job_gpt_restore, GPT_CFG, dict(fsdp=4), d, ids)
    for k, v in want.items():
        np.testing.assert_array_equal(back[0]["whole"][k], v, err_msg=k)
    assert back[0]["local"]["embed.weight"][0] == \
        want["params/embed.weight"].shape[0] // 4
    assert len({r["loss"] for r in back}) == 1


def _jax_state():
    rng = np.random.default_rng(7)
    devs = np.array(jax.devices()[:8]).reshape(1, 4, 2)
    mesh = Mesh(devs, ("dp", "fsdp", "tp"))
    host = {"w": rng.normal(size=(64, 32)).astype(np.float32),
            "b": rng.normal(size=(32,)).astype(np.float32),
            "e": rng.normal(size=(12, 6)).astype(np.float32),
            "h": rng.normal(size=(16, 8)).astype(ml_dtypes.bfloat16),
            "step": np.int32(9)}
    specs = {"w": P("fsdp", "tp"), "b": P("tp"), "e": P(),
             "h": P(("fsdp", "tp")), "step": P()}
    tree = {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
            for k, v in host.items()}
    return host, tree


def _check_shards(res, host, spec_of):
    for r, got in enumerate(res):
        for path, (arr, win) in got.items():
            want = host[path]
            if spec_of(path, r) is None:
                assert win is None, (path, r)
            else:
                assert win is not None, (path, r)
                want = want[tuple(slice(a, b) for a, b in win)]
            np.testing.assert_array_equal(arr, _bits(want),
                                          err_msg=f"{path} rank {r}")


def test_jax_per_host_save_restores_on_port_ranks(world, tmp_path):
    host, tree = _jax_state()
    d = str(tmp_path / "jax")
    JC.save_state(d, tree, per_host=True)
    man = json.load(open(os.path.join(d, "manifest.json")))
    assert {e["path"] for e in man["leaves"] if "shards" in e} >= {"w",
                                                                  "h"}
    plans = [dict(fsdp=4), dict(dp=2, fsdp=2)]
    for res in zip(*world.run(J.job_restore_shards, d, plans)):
        # saved specs re-applied: w and h split, b over tp (size 1)
        _check_shards(res, host, lambda p, r: None if p in ("e", "step")
                      else p)
    given = {"w": ("fsdp",), "e": ("fsdp", None), "b": ()}
    for res in zip(*world.run(J.job_restore_shards, d, plans, given)):
        _check_shards(res, host, lambda p, r: p if p in ("w", "e", "h")
                      else None)


def test_ep_table_restores_across_shapes(world, tmp_path):
    table = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    res = world.run(J.job_ep_table, table, str(tmp_path / "ep"),
                    str(tmp_path / "dense"))
    man = json.load(open(str(tmp_path / "ep" / "manifest.json")))
    assert man["leaves"][0]["spec"] == ["ep", None]
    for r in res:
        assert r["spec"] == ("ep", None)
        i = r["ep_index"]
        np.testing.assert_array_equal(r["got22"], table[i * 32:(i + 1) * 32])
        np.testing.assert_array_equal(r["got_dp"], table)
        assert not r["dp_placed"]
        j = r["rank"]
        np.testing.assert_array_equal(r["dense"], table[j * 16:(j + 1) * 16])
        np.testing.assert_array_equal(r["host"], table)
    # the JAX package reads the port's ep save whole, too
    np.testing.assert_array_equal(
        np.asarray(JC.restore_state(str(tmp_path / "ep"))["emb.weight"]),
        table)


def test_coordinated_save_with_a_dead_rank_raises_naming_it(world,
                                                             tmp_path):
    root = str(tmp_path / "fleet")
    res = world.run(J.job_coordinated_save, root, "dead1",
                    str(tmp_path / "a"), 3)
    assert res[3] is None
    for err, missing, glob, gsteps in res[:3]:
        # the ranks not yet arrived when the dead marker was seen, the
        # dead one among them, named
        assert 3 in missing and "rank(s) [3] died mid-save" in err
        assert not glob and gsteps == []
    res = world.run(J.job_coordinated_save, root, "live1",
                    str(tmp_path / "b"))
    for err, missing, glob, gsteps in res:
        assert err is None and glob and gsteps == [1]


def test_agree_restore_step_picks_the_newest_common_step(world):
    steps = [[2, 4, 6, 8], [4, 6, 8], [2, 4, 6], [6, 4, 10]]
    assert world.run(J.job_agree_restore, "agree1", steps) == [6] * 4
    assert world.run(J.job_agree_restore, "agree2",
                     [[2], [4], [2], [2]]) == [None] * 4
