"""Sharding rules: tensor parallelism as annotation (counterpart of
paddle_tpu/parallel/sharding.py).

A rule is a (parameter-name regex, PartitionSpec) pair; rules are
ordered, the first match wins, and an unmatched parameter replicates.
Megatron's column- and row-parallel layers are two specs: a column
weight ``P(None, "tp")`` with its bias ``P("tp")``, a row weight
``P("tp", None)``.

The JAX package hands the specs to GSPMD, which partitions one program.
The port is multi-controller (core/mesh.py): each rank holds the local
shard of each leaf under its spec, and a step computes what the
unsharded step computes by two rules. *Gather at use*: a layer that does
not compute on its shard all-gathers the leaf just before it uses it
(:func:`use`, :func:`collective.gather_at_use`), and the gather's
backward gives the rank its shard's gradient. *Local compute*: where a
layer knows the Megatron pair (``MultiHeadAttention``'s q/k/v columns
with ``out_proj``'s rows, an FFN's ``fc1``/``gate``/``up`` columns with
``fc2``/``down`` rows), the rank computes on its columns and one
all-reduce over ``tp`` closes the row-parallel product
(:func:`tp_pair`).

A placed leaf carries its ``NamedSharding`` as ``_pt_sharding`` and its
global shape as ``_pt_global_shape``, and stays listed in :data:`PLACED`
while it lives (:func:`mark`)."""

from __future__ import annotations

import re
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.enforce import enforce
from ..core.mesh import get_mesh
from ..core.sharding_types import NamedSharding, PartitionSpec as P, _axes
from ..nn.layer import use  # noqa: F401 - gather at use, re-exported

Rule = Tuple[str, P]

# counts of the reshards ``constraint`` made (a gather or a cut) and of
# the layers that fell back to gather at use where they could compute on
# their shard (tp divides no head or column count): {layer kind: count}
RESHARDS = {"copies": 0}
FALLBACKS: Dict[str, int] = {}
# the live placed leaves (parameters, buffers, moments), by id: the
# resharding guard (parallel/plan.py) holds each to its layout
PLACED: "weakref.WeakValueDictionary[int, torch.Tensor]" = \
    weakref.WeakValueDictionary()


def infer_param_spec(params: Dict[str, object], rules: Sequence[Rule],
                     mesh=None) -> Dict[str, P]:
    """Map each parameter name through the first matching rule (search,
    not fullmatch: anchor with $ where needed). Unmatched names are left
    out (replicated), as are matches whose sharded dims do not divide by
    their mesh axes (a 2-row segment table on tp=4)."""
    mesh = mesh or get_mesh()
    compiled = [(re.compile(pat), spec) for pat, spec in rules]
    out: Dict[str, P] = {}
    for name, value in params.items():
        for pat, spec in compiled:
            if pat.search(name):
                if _divisible(value, spec, mesh):
                    out[name] = spec
                break
    return out


def _divisible(value, spec: P, mesh) -> bool:
    shape = _global_shape(value)
    if shape is None:
        return True
    for dim, axes in enumerate(spec):
        if axes is None or dim >= len(shape):
            continue
        n = 1
        for ax in _axes(axes):
            n *= int(mesh.shape.get(ax, 1))
        if shape[dim] % n:
            return False
    return True


def _global_shape(value):
    """The whole shape of a leaf: its ``_pt_global_shape`` when it is a
    placed shard, else its ``.shape`` (None without one)."""
    shape = getattr(value, "_pt_global_shape", None)
    if shape is None:
        shape = getattr(value, "shape", None)
    return None if shape is None else tuple(shape)


def sharding_of(t) -> Optional[NamedSharding]:
    """The ``NamedSharding`` a placed leaf carries; None for a whole
    one."""
    return getattr(t, "_pt_sharding", None)


def mark(t: torch.Tensor, sharding: NamedSharding, whole) -> torch.Tensor:
    """Mark ``t`` as this rank's shard under ``sharding`` of a leaf of
    shape ``whole``, and list it in :data:`PLACED`."""
    t._pt_sharding = sharding
    t._pt_global_shape = tuple(whole)
    PLACED[id(t)] = t
    return t


def layout_of(t: torch.Tensor):
    """What a placed leaf's layout is: its local shape, its sharding and
    its device."""
    return tuple(t.shape), sharding_of(t), t.device


def place(t: torch.Tensor, sharding: NamedSharding, device=None):
    """Cut ``t`` to this rank's shard under ``sharding``, in place
    (``t.data``; the Parameter object stays, so optimizer state and the
    module keep it), on ``device`` when given, and mark it. A replicated
    spec marks nothing. Returns ``t``."""
    enforce(sharding_of(t) is None, "the leaf is placed already (under "
            "%s)", sharding_of(t))
    if not sharding.axes():
        if device is not None:
            t.data = t.data.to(device)
        return t
    whole = tuple(t.shape)
    with torch.no_grad():
        shard = sharding.local(t.data)
        t.data = shard.to(device if device is not None else shard.device,
                          copy=True).contiguous()
    return mark(t, sharding, whole)


def shard_params(params: Dict[str, object], rules: Sequence[Rule],
                 mesh=None) -> Dict[str, object]:
    """Each parameter cut to this rank's shard under the rules
    (unmatched: replicated, left as it is). The tensors are cut in place
    (:func:`place`) and returned by name."""
    mesh = mesh or get_mesh()
    spec_map = infer_param_spec(params, rules, mesh)
    out = {}
    for name, value in params.items():
        spec = spec_map.get(name, P())
        out[name] = place(value, NamedSharding(mesh, spec))
    return out


def constraint(x, spec: P, mesh=None):
    """``x`` laid out under ``spec`` (``with_sharding_constraint``): the
    identity where ``x`` is laid out so already; otherwise ``x`` (whole,
    or a shard that carries its sharding) is gathered and this rank's
    shard under ``spec`` cut from it, differentiably. Each such reshard
    counts in ``RESHARDS``."""
    mesh = mesh or get_mesh()
    target = NamedSharding(mesh, spec)
    current = sharding_of(x)
    if (current.spec if current is not None else P()) == target.spec \
            or (current is None and not target.axes()):
        return x
    RESHARDS["copies"] += 1
    whole = use(x)
    out = whole[target.index(whole.shape)]
    if target.axes():
        out._pt_sharding = target
        out._pt_global_shape = tuple(whole.shape)
    return out


def tp_pair(cols, rows, counts=(), kind: str = "layer"):
    """The Megatron pair of a layer: ``cols`` the Linear layers that open
    it (column-parallel, weight ``P(None, axis)``, bias ``P(axis)``),
    ``rows`` the one that closes it (weight ``P(axis, None)``,
    bias whole). Returns (axis, size, index) when every weight is
    placed so over one axis and ``axis``'s size divides each of
    ``counts`` (heads, kv heads); None when no weight is sharded, or
    when the layout is another (the layer then gathers at use). A pair
    laid out so whose axis does not divide ``counts`` counts a ``kind``
    fallback (:data:`FALLBACKS`). A layer that is no Linear (a LoRA
    adapter over a projection) gathers at use."""
    if not (all(hasattr(c, "column") for c in cols)
            and hasattr(rows, "row")):
        return None
    specs = [sharding_of(c.weight) for c in cols] + [
        sharding_of(rows.weight)]
    if all(s is None for s in specs):
        return None
    first = specs[0]
    if first is None or len(first.spec) != 2 or first.spec[0] is not None \
            or not isinstance(first.spec[1], str):
        return None
    axis = first.spec[1]
    mesh = first.mesh
    n = mesh.axis_size(axis)
    ok = all(s is not None and s.mesh is mesh and tuple(s.spec) == (None, axis)
             for s in specs[:-1])
    ok = ok and specs[-1] is not None and specs[-1].mesh is mesh \
        and tuple(specs[-1].spec) == (axis, None)
    for c in cols:
        if getattr(c, "has_bias", False):
            bs = sharding_of(c.bias)
            ok = ok and bs is not None and tuple(bs.spec) == (axis,)
    if getattr(rows, "has_bias", False):
        ok = ok and sharding_of(rows.bias) is None
    if not ok:
        return None
    if not all(k % n == 0 for k in counts):
        count_fallback(kind)
        return None
    return axis, n, mesh.axis_index(axis)


def count_fallback(kind: str) -> None:
    """One forward of a ``kind`` layer that gathered its tp-sharded
    weights at use because it could not compute on its shard."""
    FALLBACKS[kind] = FALLBACKS.get(kind, 0) + 1


# ---------------------------------------------------------------------------
# standard rule sets
# ---------------------------------------------------------------------------


def transformer_tp_rules(axis: str = "tp") -> List[Rule]:
    """Megatron-style TP for nn.transformer-built models (BERT, NMT,
    GPT): attention QKV and FFN-in column-parallel, attention-out and
    FFN-out row-parallel, vocab projections and embedding tables shard
    the vocab dim (the JAX package's regexes)."""
    col_w, col_b = P(None, axis), P(axis)
    row_w = P(axis, None)
    vocab_w = P(axis, None)
    return [
        (r"(q_proj|k_proj|v_proj)\.weight$", col_w),
        (r"(q_proj|k_proj|v_proj)\.bias$", col_b),
        (r"out_proj\.weight$", row_w),
        (r"fc1\.weight$", col_w),
        (r"fc1\.bias$", col_b),
        (r"fc2\.weight$", row_w),
        (r"(generator|mlm_decoder)\.weight$", P(None, axis)),
        (r"(generator|mlm_decoder)\.bias$", P(axis)),
        # the gated FFN: gate/up column-parallel, down row-parallel,
        # attribute-anchored
        (r"(^|\.)(gate|up)\.weight$", col_w),
        (r"(^|\.)down\.weight$", row_w),
        # 'embed' is the whole attribute name (GPT's token table), never
        # a suffix of one (ViT's patch_embed kernel replicates)
        (r"(^|\.)(tok|seg|src_emb|tgt_emb|embed)\.weight$", vocab_w),
    ]


def zero_dp_rules(axis: str = "dp",
                  min_size: int = 2 ** 16) -> "OptStateRules":
    """ZeRO-style optimizer-state sharding over ``axis``."""
    return OptStateRules(axis=axis, min_size=min_size)


class OptStateRules:
    """Shard each optimizer-state leaf of at least ``min_size`` elements
    along its first dim that ``axis`` divides. Under ``Trainer(mesh=,
    opt_state_rules=)`` the moments of a replicated parameter are the
    rank's slice; the rank updates that slice of the parameter and the
    slices are all-gathered over ``axis`` (optimizer/optimizers.py
    ``Optimizer.apply``)."""

    def __init__(self, axis: str = "dp", min_size: int = 2 ** 16):
        self.axis = axis
        self.min_size = min_size

    def spec_for(self, leaf, mesh=None) -> Optional[P]:
        mesh = mesh or get_mesh()
        n = int(mesh.shape.get(self.axis, 1))
        shape = _global_shape(leaf)
        if n <= 1 or shape is None:
            return None
        size = 1
        for s in shape:
            size *= int(s)
        if size < self.min_size:
            return None
        for dim, s in enumerate(shape):
            if s % n == 0 and s >= n:
                spec = [None] * len(shape)
                spec[dim] = self.axis
                return P(*spec)
        return None

    def place(self, tree, mesh=None):
        """``tree`` with each tensor leaf that :meth:`spec_for` shards cut
        to this rank's shard (in place, marked); a leaf placed already
        (the moment of a placed parameter) keeps its layout."""
        mesh = mesh or get_mesh()
        if isinstance(tree, dict):
            return {k: self.place(v, mesh) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.place(v, mesh) for v in tree)
        if isinstance(tree, torch.Tensor) and sharding_of(tree) is None:
            spec = self.spec_for(tree, mesh)
            if spec is not None:
                place(tree, NamedSharding(mesh, spec))
        return tree
