"""The Switch-MoE FFN (counterpart of paddle_tpu/nn/moe.py): top-1
(Switch) and top-2 (GShard) routing with the dense one-hot
dispatch/combine formulation, as in the JAX package.

Semantics kept from the JAX package:

- the router's logits, softmax, logsumexp and the aux terms are float32;
  the dispatch mask and the combine weights take ``x.dtype``;
- ties between router probabilities go to the lower expert index
  (``lax.top_k``'s order: a stable descending sort);
- a token's place in its expert's queue is the float32 cumsum of the
  one-hot choices, in arrival order; under top-2 every first choice
  claims its slot before any second choice;
- an expert takes at most ``capacity`` tokens; the rest are dropped and
  output exact zeros (the caller's residual carries them through);
- the kept count is a float32 sum of a bool mask.

The einsums run as ``torch.einsum``: the JAX package computes them
outside any Pallas kernel.

Under a mesh whose data axes (core/mesh.py ``reduce_axes``: dp, fsdp
under a plan, and sp) hold more than one rank, the routing is the global
batch's, as GSPMD runs the JAX layer: each rank's expert choices are
all-gathered into the global token order (the batch rows, then the
sequence), every position in an expert's queue and the capacity are the
global ones, and the rank dispatches its own tokens into the (E,
C_global) slots. ``aux_loss``, ``router_z_loss`` and ``kept_fraction``
are the global batch's (their sums all-reduced). :func:`expert_param_spec`
shards the experts over ``ep``; a rank gathers them at use
(parallel/sharding.py ``use``). The all-to-all expert dispatch, where
each ``ep`` rank computes its experts only, is a later speed item.

Buffers. A forward records ``aux_loss``, ``router_z_loss`` and
``kept_fraction`` as the JAX layer's ``update_buffer`` does. With
autograd recording, the recorded tensors carry the graph, so a loss
builder that adds ``w * aux_loss`` trains the router through the aux
term, the JAX contract; the Trainer detaches them after its backward
(nn/layer.py :func:`detach_buffers`), so no graph outlives its step and
a checkpoint saves plain values under the JAX names. Without autograd
the values are copied into the buffers in place: a tensor made under
``torch.inference_mode`` (a serving arena's forward) put in their place
could not be written outside it, by a checkpoint restore for one."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from .. import initializer as I
from ..core.enforce import enforce
from .layer import Layer, use

__all__ = ["SwitchFFN", "expert_param_spec", "switch_moe"]


def gelu_tanh(x):
    """``jax.nn.gelu``'s default, the tanh approximation (the port's
    ``ops.math.gelu`` defaults to the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def _einsum(eq: str, a, b):
    """``torch.einsum`` on the promoted dtype of its two operands, as
    ``jnp.einsum`` promotes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _route(x, router_w, top_k: int):
    """The router: float32 logits (S, E), their softmax, and each token's
    ``top_k`` experts (S, k), the lower index first among equal
    probabilities (``lax.top_k``'s order: a stable descending sort)."""
    logits = _einsum("sd,de->se", x, router_w).float()
    probs = torch.softmax(logits, dim=-1)
    top_i = torch.sort(probs, dim=-1, descending=True,
                       stable=True).indices[:, :top_k]
    return logits, probs, top_i


def switch_moe(x, router_w, w1, b1, w2, b2, *, capacity: int,
               act=gelu_tanh, top_k: int = 1):
    """Functional top-k MoE over tokens (k=1: Switch; k=2: GShard).

    x: (S, D) tokens; router_w: (D, E); w1: (E, D, F); b1: (E, F);
    w2: (E, F, D); b2: (E, D). Returns (y (S, D), aux_loss, z_loss,
    kept_fraction), the last three float32 scalars: aux is
    ``E * sum_e(fraction_e * mean_prob_e)`` over the first choices,
    z_loss ``mean(logsumexp(logits)^2)``, kept the share of the S * k
    assignments that fit ``capacity``."""
    return _switch_moe(x, router_w, w1, b1, w2, b2, capacity=capacity,
                       act=act, top_k=top_k)


class _Spread:
    """Where a rank's (b, t) tokens sit in the global batch: the mesh's
    batch axes split the rows, ``sp`` the sequence."""

    def __init__(self, mesh, axes, b, t):
        self.mesh, self.b, self.t = mesh, b, t
        self.axes = axes
        self.batch = tuple(a for a in axes if a != "sp")
        self.sp = "sp" in axes
        self.rows = mesh.axis_size(self.batch) * b
        self.cols = mesh.size_of("sp") * t if self.sp else t
        self.b0 = mesh.axis_index(self.batch) * b
        self.t0 = mesh.coordinate["sp"] * t if self.sp else 0

    @property
    def tokens(self) -> int:
        return self.rows * self.cols

    def gather(self, v):
        """(b * t, ...) per rank -> (B * T, ...) in the global order."""
        from ..parallel.collective import allgather

        v = v.reshape(self.b, self.t, *v.shape[1:])
        if self.sp:
            v = allgather(v, "sp", dim=1, mesh=self.mesh)
        if self.batch:
            v = allgather(v, self.batch, dim=0, mesh=self.mesh)
        return v.reshape(self.tokens, *v.shape[2:])

    def mine(self, v):
        """The rank's rows of a global (B * T, ...) tensor."""
        v = v.reshape(self.rows, self.cols, *v.shape[1:])
        v = v[self.b0:self.b0 + self.b, self.t0:self.t0 + self.t]
        return v.reshape(self.b * self.t, *v.shape[2:])

    def sum(self, v):
        """``v`` summed over the ranks (differentiable, the sum's JAX
        transpose)."""
        from ..parallel.collective import allreduce

        return allreduce(v, self.axes, mesh=self.mesh)


def _switch_moe(x, router_w, w1, b1, w2, b2, *, capacity: int,
                act=gelu_tanh, top_k: int = 1, spread=None):
    """:func:`switch_moe`, whose tokens are the rank's share of the global
    batch when ``spread`` (a :class:`_Spread`) is given: positions and
    the aux terms are then the global batch's, ``capacity`` the global
    one, and ``y`` the rank's tokens' outputs."""
    enforce(top_k in (1, 2), "top_k must be 1 or 2, got %s", top_k)
    s = x.shape[0]
    total = s if spread is None else spread.tokens
    e = router_w.shape[1]
    logits, probs, top_i = _route(x, router_w, top_k)
    z = torch.logsumexp(logits, dim=-1)
    if spread is None:
        z_loss = torch.mean(z * z)
    else:
        z_loss = spread.sum(torch.sum(z * z)) / total
    top_p = probs.gather(-1, top_i)
    # Switch top-1 scales by the raw probability; GShard top-2
    # renormalises the two gates to sum to 1 per token
    gates = top_p if top_k == 1 else top_p / top_p.sum(-1, keepdim=True)
    every_i = top_i if spread is None else spread.gather(top_i)
    onehots = [F.one_hot(every_i[:, j], e).float() for j in range(top_k)]
    # 1-based queue positions in arrival order; first choices first
    pos = [torch.cumsum(onehots[0], dim=0) * onehots[0]]
    if top_k == 2:
        first_counts = onehots[0].sum(0)
        pos.append((torch.cumsum(onehots[1], dim=0) + first_counts[None, :])
                   * onehots[1])
    if spread is not None:
        pos = [spread.mine(p) for p in pos]
    dmask = combine = None
    kept_ct = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(top_k):
        keep = (pos[j] > 0) & (pos[j] <= capacity)
        pos_c = (pos[j] - 1).clamp(0, capacity - 1).long()
        # the one-hot slot of each kept (token, expert), zero elsewhere
        dm = torch.zeros((s, e, capacity), dtype=x.dtype, device=x.device)
        dm.scatter_(2, pos_c[..., None], keep.to(x.dtype)[..., None])
        cm = dm * gates[:, j].to(x.dtype)[:, None, None]
        dmask = dm if dmask is None else dmask + dm
        combine = cm if combine is None else combine + cm
        # a bool mask counted in float32 (a bf16 sum saturates at 256)
        kept_ct = kept_ct + keep.float().sum()
    expert_in = _einsum("sec,sd->ecd", dmask, x)
    h = act(_einsum("ecd,edf->ecf", expert_in, w1) + b1[:, None, :])
    out_e = _einsum("ecf,efd->ecd", h, w2) + b2[:, None, :]
    y = _einsum("sec,ecd->sd", combine, out_e)         # dropped -> zeros
    frac = onehots[0].mean(0)
    if spread is None:
        mean_prob = probs.mean(0)
    else:
        mean_prob = spread.sum(probs.sum(0)) / total
        kept_ct = spread.sum(kept_ct.detach())
    aux = e * torch.sum(frac * mean_prob)
    kept = kept_ct / (total * top_k)
    return y, aux.float(), z_loss.float(), kept.float()


class SwitchFFN(Layer):
    """Drop-in MoE replacement for the position-wise FFN:
    ``forward(x (B, T, D)) -> (B, T, D)``, routing the call's B * T
    tokens at ``capacity(B * T)`` (under a mesh, the global batch's
    tokens at the global capacity: the module docstring). Parameters
    ``router_w``, ``w1``, ``b1``, ``w2``, ``b2`` (experts stacked on the
    leading axis) and the buffers ``aux_loss``, ``router_z_loss``,
    ``kept_fraction``, named and created in the JAX package's order.
    ``act`` defaults to the tanh GELU, ``jax.nn.gelu``'s default."""

    def __init__(self, d_model: int, d_ff: int, num_experts: int,
                 capacity_factor: float = 1.25, act=gelu_tanh, dtype=None,
                 router_top_k: int = 1, *, device=None, generator=None):
        super().__init__()
        enforce(num_experts >= 2, "SwitchFFN needs >= 2 experts, got %s",
                num_experts)
        enforce(capacity_factor > 0.0,
                "capacity_factor must be > 0, got %s", capacity_factor)
        enforce(router_top_k in (1, 2),
                "router_top_k must be 1 (Switch) or 2 (GShard), got %s",
                router_top_k)
        self.num_experts = num_experts
        self.capacity_factor = float(capacity_factor)
        self.act = act
        self.router_top_k = router_top_k
        self._recording = True
        kw = dict(device=device, generator=generator)
        self.create_parameter("router_w", (d_model, num_experts), dtype,
                              I.XavierUniform(), **kw)
        self.create_parameter("w1", (num_experts, d_model, d_ff), dtype,
                              I.XavierUniform(), **kw)
        self.create_parameter("b1", (num_experts, d_ff), dtype,
                              I.Constant(0.0), is_bias=True, **kw)
        self.create_parameter("w2", (num_experts, d_ff, d_model), dtype,
                              I.XavierUniform(), **kw)
        self.create_parameter("b2", (num_experts, d_model), dtype,
                              I.Constant(0.0), is_bias=True, **kw)
        home = self.router_w.device
        for name, value in (("aux_loss", 0.0), ("router_z_loss", 0.0),
                            ("kept_fraction", 1.0)):
            self.register_buffer(name, torch.full((), value,
                                                  dtype=torch.float32,
                                                  device=home))

    def capacity(self, tokens: int) -> int:
        """``ceil(tokens * k / E * capacity_factor)``, at least 1: top-k
        routing makes k assignments a token."""
        return max(1, math.ceil(tokens * self.router_top_k
                                / self.num_experts * self.capacity_factor))

    def _record(self, name: str, value) -> None:
        if not self._recording:
            return
        buf = self._buffers[name]
        if value.requires_grad or buf.requires_grad:
            self._buffers[name] = value
        else:
            with torch.no_grad():
                buf.copy_(value)

    def forward(self, x):
        from ..core.mesh import get_mesh, reduce_axes

        b, t, d = x.shape
        args = (x.reshape(b * t, d), use(self.router_w), use(self.w1),
                use(self.b1), use(self.w2), use(self.b2))
        axes = reduce_axes()
        if axes:
            spread = _Spread(get_mesh(), axes, b, t)
            y, aux, z_loss, kept = _switch_moe(
                *args, capacity=self.capacity(spread.tokens), act=self.act,
                top_k=self.router_top_k, spread=spread)
        else:
            y, aux, z_loss, kept = switch_moe(
                *args, capacity=self.capacity(b * t), act=self.act,
                top_k=self.router_top_k)
        self._record("aux_loss", aux)
        self._record("router_z_loss", z_loss)
        self._record("kept_fraction", kept)
        return y.reshape(b, t, d)


def expert_param_spec(axis: str = "ep"):
    """Sharding rules for SwitchFFN parameters: the experts over
    ``axis``, the router replicated (compose with
    ``parallel.sharding.transformer_tp_rules``)."""
    from ..core.sharding_types import PartitionSpec as P

    return [
        (r"(^|\.)w1$", P(axis, None, None)),
        (r"(^|\.)b1$", P(axis, None)),
        (r"(^|\.)w2$", P(axis, None, None)),
        (r"(^|\.)b2$", P(axis, None)),
    ]


@contextlib.contextmanager
def not_recording(module: torch.nn.Module):
    """The block runs ``module``'s SwitchFFNs without recording their
    buffers: the JAX package's scan over stacked layers runs each block
    through ``functional_call`` and drops what it records."""
    ffns = [m for m in module.modules() if isinstance(m, SwitchFFN)]
    saved = [m._recording for m in ffns]
    try:
        for m in ffns:
            m._recording = False
        yield
    finally:
        for m, was in zip(ffns, saved):
            m._recording = was
