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
outside any Pallas kernel. ``expert_param_spec`` (the 'ep' sharding
rules) belongs to the distributed slice (ROADMAP queue 1 item 11).

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
from .layer import Layer

__all__ = ["SwitchFFN", "switch_moe"]


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
    enforce(top_k in (1, 2), "top_k must be 1 or 2, got %s", top_k)
    s = x.shape[0]
    e = router_w.shape[1]
    logits, probs, top_i = _route(x, router_w, top_k)
    z = torch.logsumexp(logits, dim=-1)
    z_loss = torch.mean(z * z)
    top_p = probs.gather(-1, top_i)
    # Switch top-1 scales by the raw probability; GShard top-2
    # renormalises the two gates to sum to 1 per token
    gates = top_p if top_k == 1 else top_p / top_p.sum(-1, keepdim=True)
    onehots = [F.one_hot(top_i[:, j], e).float() for j in range(top_k)]
    # 1-based queue positions in arrival order; first choices first
    pos = [torch.cumsum(onehots[0], dim=0) * onehots[0]]
    if top_k == 2:
        first_counts = onehots[0].sum(0)
        pos.append((torch.cumsum(onehots[1], dim=0) + first_counts[None, :])
                   * onehots[1])
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
    mean_prob = probs.mean(0)
    aux = e * torch.sum(frac * mean_prob)
    kept = kept_ct / (s * top_k)
    return y, aux.float(), z_loss.float(), kept.float()


class SwitchFFN(Layer):
    """Drop-in MoE replacement for the position-wise FFN:
    ``forward(x (B, T, D)) -> (B, T, D)``, routing the call's B * T
    tokens at ``capacity(B * T)``. Parameters ``router_w``, ``w1``,
    ``b1``, ``w2``, ``b2`` (experts stacked on the leading axis) and the
    buffers ``aux_loss``, ``router_z_loss``, ``kept_fraction``, named
    and created in the JAX package's order. ``act`` defaults to the tanh
    GELU, ``jax.nn.gelu``'s default."""

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
        b, t, d = x.shape
        y, aux, z_loss, kept = switch_moe(
            x.reshape(b * t, d), self.router_w, self.w1, self.b1, self.w2,
            self.b2, capacity=self.capacity(b * t), act=self.act,
            top_k=self.router_top_k)
        self._record("aux_loss", aux)
        self._record("router_z_loss", z_loss)
        self._record("kept_fraction", kept)
        return y.reshape(b, t, d)


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
