"""Row-sparse embedding updates of the port (``nn/sparse.py``,
``Embedding(is_sparse=True)``, ``optimizer/sparse.py``) against the JAX
package's, on the CPU, float32: the cases of
tests/test_sparse_embedding_grads.py except the ep-mesh one (the
sharded embedding is not ported), each on the same weights (crossed
with ``load_numpy_state``) and the same numpy inputs as the jitted JAX
function.

- a sparse step matches the dense step on every touched row (sgd, adam,
  adagrad, momentum; two steps on the same ids), and JAX's sparse step,
  within 1e-5;
- rows outside the batch keep their parameters and accumulators bit
  for bit (lazy mode);
- the padding row never moves;
- merge_rows and apply_rows (ids exact, sums 1e-6);
- a layer called twice in one forward accumulates both call sites;
- ``Inject`` replays given rows in call order, as JAX's does;
- ids -1, V and V+5 as the JAX package treats them (-1 wraps to V - 1,
  V and beyond are dropped; in a step they gather NaN rows);
- the elements a sparse step computes are flat in the vocab, a dense
  step's grow with it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as JO
from paddle_tpu.core import dtypes as JDT
from paddle_tpu.optimizer import sparse as JS
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.core import dtypes as TDT
from paddle_tpu_torch.optimizer import sparse as TS
from paddle_tpu_torch.utils.convert import load_numpy_state

V, D = 500, 8
TOL = 1e-5

OPTS = {
    "sgd": lambda M: M.SGD(0.1),
    "adam": lambda M: M.Adam(0.01),
    "adagrad": lambda M: M.Adagrad(0.1),
    "momentum": lambda M: M.Momentum(0.1, momentum=0.9),
}


@pytest.fixture(autouse=True)
def fresh_streams():
    pt.seed(0)
    ptt.seed(0)
    JDT.set_policy("float32")
    TDT.set_policy("float32")
    yield


class JToy(jnn.Layer):
    def __init__(self, vocab=V, sparse=True, padding_idx=None):
        super().__init__()
        self.emb = jnn.Embedding(vocab, D, is_sparse=sparse,
                                 padding_idx=padding_idx)
        self.fc = jnn.Linear(D, 1)

    def forward(self, ids):
        return self.fc(jnp.mean(self.emb(ids), axis=1))


class TToy(tnn.Layer):
    def __init__(self, vocab=V, sparse=True, padding_idx=None):
        super().__init__()
        self.emb = tnn.Embedding(vocab, D, is_sparse=sparse,
                                 padding_idx=padding_idx, device="cpu")
        self.fc = tnn.Linear(D, 1, device="cpu")

    def forward(self, ids):
        return self.fc(torch.mean(self.emb(ids), dim=1))


def _pair(**kw):
    jm, tm = JToy(**kw), TToy(**kw)
    load_numpy_state(tm, {k: np.asarray(v)
                          for k, v in jm.named_parameters().items()})
    return jm, tm


def _jloss(model):
    def f(p, ids, y):
        out, _ = model.functional_call(p, ids)
        return jnp.mean((out.squeeze(-1) - y) ** 2)

    return f


def _tloss(model):
    def f(p, ids, y):
        out, _ = model.functional_call(p, ids)
        return torch.mean((out.squeeze(-1) - y) ** 2)

    return f


def _batch(seed=0, high=50):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, high, size=(4, 6))              # dup-heavy
    y = rng.normal(size=(4,)).astype(np.float32)
    return ids, y


def _tparams(tm):
    return {k: v.detach().clone() for k, v in tm.named_parameters()}


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("opt", list(OPTS))
def test_sparse_step_matches_dense_and_jax(opt):
    jm, tm = _pair()
    ids, y = _batch()
    ji, jy = jnp.asarray(ids), jnp.asarray(y)
    ti, ty = torch.from_numpy(ids), torch.from_numpy(y)
    jinit, jstep = JS.sparse_minimize_fn(jm, _jloss(jm), OPTS[opt](JO))
    jstep = jax.jit(jstep)
    tinit, tstep = TS.sparse_minimize_fn(tm, _tloss(tm), OPTS[opt](TO))
    tdense = OPTS[opt](TO).minimize_fn(_tloss(tm))
    jp = jm.named_parameters()
    jst = jinit(jp)
    tp, dp = _tparams(tm), _tparams(tm)
    tst, dst = tinit(tp), OPTS[opt](TO).init(dp)
    for i in range(2):       # the same ids twice: touched rows stay in step
        jl, jp, jst = jstep(jp, jst, ji, jy)
        tl, tp, tst = tstep(tp, tst, ti, ty)
        dl, dp, dst = tdense(dp, dst, ti, ty)
        np.testing.assert_allclose(float(tl), float(dl), rtol=TOL)
        np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
        for k in tp:
            np.testing.assert_allclose(_np(tp[k]), _np(dp[k]), atol=TOL,
                                       err_msg=f"{k} step {i} vs dense")
            np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), atol=TOL,
                                       err_msg=f"{k} step {i} vs JAX")
    assert tst["dense"]["step"] == int(jst["dense"]["step"]) == 2
    for name, leaf in tst["sparse"]["emb.weight"].items():
        np.testing.assert_allclose(
            _np(leaf), _np(jst["sparse"]["emb.weight"][name]), atol=TOL,
            err_msg=name)


def test_untouched_rows_bitwise_frozen():
    """Lazy semantics: rows outside the batch keep params AND state."""
    jm, tm = _pair()
    ids, y = _batch(high=50)                      # rows 50.. untouched
    tp = _tparams(tm)
    w0 = tp["emb.weight"].clone()
    init_fn, step_fn = TS.sparse_minimize_fn(tm, _tloss(tm), TO.Adam(0.05))
    state = init_fn(tp)
    s0 = {k: v.clone() for k, v in state["sparse"]["emb.weight"].items()}
    _, tp, state = step_fn(tp, state, torch.from_numpy(ids),
                           torch.from_numpy(y))
    touched = np.unique(ids)
    mask = np.ones(V, bool)
    mask[touched] = False
    w1 = tp["emb.weight"]
    assert torch.equal(w0[mask], w1[mask]), "untouched rows moved"
    assert not torch.allclose(w0[touched], w1[touched]), "touched rows frozen"
    for k, v in state["sparse"]["emb.weight"].items():
        assert v.shape[0] == V
        assert torch.equal(v[mask], s0[k][mask]), f"untouched {k} written"
        assert (v[touched] != 0).any(), f"touched {k} not written"
    jinit, jstep = JS.sparse_minimize_fn(jm, _jloss(jm), JO.Adam(0.05))
    jp = jm.named_parameters()
    _, jp1, _ = jax.jit(jstep)(jp, jinit(jp), jnp.asarray(ids),
                               jnp.asarray(y))
    np.testing.assert_allclose(_np(w1), np.asarray(jp1["emb.weight"]),
                               atol=TOL)


def test_padding_idx_row_never_updates():
    jm, tm = _pair(padding_idx=0)
    ids = np.asarray([[0, 1, 2, 0], [3, 0, 4, 0]])
    y = np.asarray([1.0, -1.0], np.float32)
    tp = _tparams(tm)
    w0 = tp["emb.weight"].clone()
    init_fn, step_fn = TS.sparse_minimize_fn(tm, _tloss(tm), TO.SGD(0.5))
    _, tp, _ = step_fn(tp, init_fn(tp), torch.from_numpy(ids),
                       torch.from_numpy(y))
    assert torch.equal(tp["emb.weight"][0], w0[0])
    assert not torch.allclose(tp["emb.weight"][1], w0[1])
    jinit, jstep = JS.sparse_minimize_fn(jm, _jloss(jm), JO.SGD(0.5))
    jp = jm.named_parameters()
    _, jp1, _ = jax.jit(jstep)(jp, jinit(jp), jnp.asarray(ids),
                               jnp.asarray(y))
    np.testing.assert_allclose(_np(tp["emb.weight"]),
                               np.asarray(jp1["emb.weight"]), atol=TOL)


def test_merge_rows_merges_duplicates():
    uids, merged = TS.merge_rows(torch.tensor([3, 1, 3, 3]),
                                 torch.tensor([[1.0], [2.0], [10.0],
                                               [100.0]]), vocab_size=8)
    got = {int(u): float(m[0]) for u, m in zip(uids, merged) if int(u) < 8}
    assert got == {1: 2.0, 3: 111.0}
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 40, (6, 7))
    g = rng.normal(size=(6, 7, 5)).astype(np.float32)
    tu, tm = TS.merge_rows(torch.from_numpy(ids), torch.from_numpy(g), 40)
    ju, jm = JS.merge_rows(jnp.asarray(ids), jnp.asarray(g), 40)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6)


def test_apply_rows_multi_hot_matches_manual_sgd_and_jax():
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.asarray([[1, 2], [2, 2]])
    g = np.ones((2, 2, 3), np.float32)
    tt = torch.from_numpy(table.copy())
    out, _ = TS.apply_rows(TO.SGD(1.0), tt, torch.from_numpy(ids),
                           torch.from_numpy(g), {},
                           TO.SGD(1.0).schedule(0), 0)
    assert out is tt                                 # in place
    want = table.copy()
    want[1] -= 1.0
    want[2] -= 3.0
    np.testing.assert_allclose(out.numpy(), want)
    jt, _ = JS.apply_rows(JO.SGD(1.0), jnp.asarray(table), jnp.asarray(ids),
                          jnp.asarray(g), {}, jnp.asarray(1.0),
                          jnp.asarray(0))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jt))


def test_multiple_calls_same_layer_accumulate():
    """A sparse embedding called twice in one forward (two fields sharing
    one table) accumulates both call sites' grads."""

    class JTwo(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = jnn.Embedding(V, D, is_sparse=True)
            self.fc = jnn.Linear(2 * D, 1)

        def forward(self, a, b):
            ha = jnp.mean(self.emb(a), axis=1)
            hb = jnp.mean(self.emb(b), axis=1)
            return self.fc(jnp.concatenate([ha, hb], -1))

    class TTwo(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = tnn.Embedding(V, D, is_sparse=True, device="cpu")
            self.fc = tnn.Linear(2 * D, 1, device="cpu")

        def forward(self, a, b):
            ha = torch.mean(self.emb(a), dim=1)
            hb = torch.mean(self.emb(b), dim=1)
            return self.fc(torch.cat([ha, hb], -1))

    jm, tm = JTwo(), TTwo()
    load_numpy_state(tm, {k: np.asarray(v)
                          for k, v in jm.named_parameters().items()})

    def jfl(p, a, b, y):
        out, _ = jm.functional_call(p, a, b)
        return jnp.mean((out.squeeze(-1) - y) ** 2)

    def tfl(p, a, b, y):
        out, _ = tm.functional_call(p, a, b)
        return torch.mean((out.squeeze(-1) - y) ** 2)

    rng = np.random.default_rng(0)
    a = rng.integers(0, 30, size=(4, 3))
    b = rng.integers(0, 30, size=(4, 5))
    y = rng.normal(size=(4,)).astype(np.float32)
    targs = [torch.from_numpy(v) for v in (a, b, y)]
    init_fn, step_fn = TS.sparse_minimize_fn(tm, tfl, TO.SGD(0.1))
    tp = _tparams(tm)
    tl, tp, _ = step_fn(tp, init_fn(tp), *targs)
    dp = _tparams(tm)
    dl, dp, _ = TO.SGD(0.1).minimize_fn(tfl)(dp, TO.SGD(0.1).init(dp),
                                             *targs)
    np.testing.assert_allclose(float(tl), float(dl), rtol=1e-6)
    np.testing.assert_allclose(_np(tp["emb.weight"]), _np(dp["emb.weight"]),
                               atol=1e-6)
    jinit, jstep = JS.sparse_minimize_fn(jm, jfl, JO.SGD(0.1))
    jp = jm.named_parameters()
    jl, jp1, _ = jax.jit(jstep)(jp, jinit(jp), jnp.asarray(a),
                                jnp.asarray(b), jnp.asarray(y))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(_np(tp["emb.weight"]),
                               np.asarray(jp1["emb.weight"]), atol=1e-6)


def test_inject_replays_rows_in_call_order_as_jax():
    """``Inject`` hands each call of a sparse embedding the rows given for
    its slot, in call order, with the padding id's rows zeroed."""
    from paddle_tpu.nn import sparse as JNS
    from paddle_tpu_torch.nn import sparse as TNS

    jm, tm = _pair(padding_idx=2)
    ids = np.asarray([[1, 2, 3], [2, 4, 5]])
    rng = np.random.default_rng(7)
    rows = [rng.normal(size=(2, 3, D)).astype(np.float32) for _ in range(2)]

    def run(NS, m, asarray, cat):
        slots = {f"{id(m.emb)}:{i}": asarray(r) for i, r in enumerate(rows)}
        with NS.Inject({id(m.emb)}, slots) as inj:
            assert NS.active() is inj
            out = cat([m.emb(asarray(ids)), m.emb(asarray(ids))])
        assert NS.active() is None
        return np.asarray(out)

    got = run(TNS, tm, torch.from_numpy, lambda x: torch.cat(x))
    want = run(JNS, jm, jnp.asarray, lambda x: jnp.concatenate(x))
    np.testing.assert_array_equal(got, want)
    assert (got[0::2, 1] == 0).all() and (got[1::2, 0] == 0).all()  # id 2
    assert np.array_equal(got[2, 0], rows[1][0, 0])    # the second call


OOR = [-1, V, V + 5]


def test_out_of_range_ids_apply_rows_as_jax():
    """-1 wraps to row V - 1; V and V + 5 are dropped (Adam, finite
    grads), as the JAX package's gather and scatter treat them."""
    rng = np.random.default_rng(5)
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = np.asarray([[OOR[0], 4, OOR[1]], [4, OOR[2], 9]])
    g = rng.normal(size=ids.shape + (D,)).astype(np.float32)
    topt, jopt = TO.Adam(0.1), JO.Adam(0.1)
    tt = torch.from_numpy(table.copy())
    tst = topt.init_leaf(tt)
    TS.apply_rows(topt, tt, torch.from_numpy(ids), torch.from_numpy(g), tst,
                  topt.schedule(0), 0)
    jt, jst = JS.apply_rows(jopt, jnp.asarray(table), jnp.asarray(ids),
                            jnp.asarray(g), jopt.init_leaf(
                                jnp.asarray(table)), jopt.schedule(0),
                            jnp.asarray(0))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=TOL)
    for k in tst:
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   atol=TOL, err_msg=k)
    moved = np.flatnonzero((tt.numpy() != table).any(axis=1)).tolist()
    assert moved == [4, 9, V - 1]
    # every id out of the table: nothing moves
    tt = torch.from_numpy(table.copy())
    TS.apply_rows(topt, tt, torch.tensor([V, V + 5]), torch.ones(2, D),
                  topt.init_leaf(tt), topt.schedule(0), 0)
    assert torch.equal(tt, torch.from_numpy(table))


def test_out_of_range_ids_in_a_step_as_jax():
    """In a whole step the ids V and V + 5 gather NaN rows (``jnp.take``)
    and poison their batch rows' loss terms; the port's step ends with
    the JAX package's values and NaNs, entry for entry."""
    jm, tm = _pair()
    ids, y = _batch(seed=2)
    ids[0, 1], ids[1, 2], ids[2, 0] = OOR
    jinit, jstep = JS.sparse_minimize_fn(jm, _jloss(jm), JO.Adam(0.01))
    jp = jm.named_parameters()
    jl, jp1, jst = jax.jit(jstep)(jp, jinit(jp), jnp.asarray(ids),
                                  jnp.asarray(y))
    init_fn, step_fn = TS.sparse_minimize_fn(tm, _tloss(tm), TO.Adam(0.01))
    tp = _tparams(tm)
    tl, tp, tst = step_fn(tp, init_fn(tp), torch.from_numpy(ids),
                          torch.from_numpy(y))
    assert np.isnan(float(jl)) and np.isnan(float(tl))
    for k in tp:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp1[k]), atol=TOL,
                                   err_msg=k)
    for k, v in tst["sparse"]["emb.weight"].items():
        np.testing.assert_allclose(_np(v), np.asarray(
            jst["sparse"]["emb.weight"][k]), atol=TOL, err_msg=k)


class _Elements(TorchDispatchMode):
    """Sums the elements each op writes: a fresh output's size, an
    in-place op's source (its largest other tensor argument, or its own
    size when it has none); a view writes nothing."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [a for a in tree_leaves((args, kwargs or {}))
               if isinstance(a, torch.Tensor)]
        if func.overloadpacket.__name__.endswith("_") and ins:
            self.count += max((t.numel() for t in ins[1:]),
                              default=ins[0].numel())
            return out
        stores = {t.untyped_storage().data_ptr() for t in ins}
        for o in tree_leaves(out):
            if isinstance(o, torch.Tensor) and \
                    o.untyped_storage().data_ptr() not in stores:
                self.count += o.numel()
        return out


def _step_elements(vocab, sparse):
    ptt.seed(0)
    tm = TToy(vocab=vocab, sparse=sparse)
    params = _tparams(tm)
    opt = TO.Adam(0.01)
    if sparse:
        init_fn, step_fn = TS.sparse_minimize_fn(tm, _tloss(tm), opt)
        state = init_fn(params)
    else:
        step_fn, state = opt.minimize_fn(_tloss(tm)), opt.init(params)
    ids = torch.zeros((8, 16), dtype=torch.long)
    y = torch.zeros((8,))
    step_fn(params, state, ids, y)                      # warm
    with _Elements() as mode:
        step_fn(params, state, ids, y)
    return mode.count


def test_step_elements_flat_in_vocab():
    """The whole point: a sparse step computes O(B*T*D), a dense one
    O(V*D)."""
    small, big = _step_elements(500, True), _step_elements(50_000, True)
    assert small == big, (small, big)
    dense_small = _step_elements(500, False)
    dense_big = _step_elements(50_000, False)
    assert dense_big - dense_small >= 10 * (50_000 - 500) * D, (
        dense_small, dense_big)
    assert big < dense_small
