"""Recurrent ops (counterpart of paddle_tpu/ops/rnn.py): the LSTM and
GRU units and sequences (with lstmp's recurrent projection), row_conv,
conv_shift, sequence_conv and the generic masked recurrence
dynamic_rnn, on a dense padded batch (B, T, D) with ``lengths``.

Each recurrence is a Python loop over time of torch ops in place of the
JAX package's ``lax.scan``; as there, the input projection of every
step is hoisted out of the loop as one (B*T, D) @ (D, G*H) matmul, so
the loop carries only the hidden-to-hidden product. Gate order is i, f,
g (c~), o for the LSTM and r, u (z), c for the GRU; ``forget_bias`` is
added before the gate activation. With ``lengths``, a padded step
freezes the carried state and outputs zeros; ``is_reverse`` walks the
whole padded length backwards, as the JAX scan over the flipped
sequence does. ``unroll`` is the JAX scan's unroll factor, a throughput
knob there that does not change the math; here it is accepted and has
no effect. cuDNN's fused LSTM is not used (a later performance
candidate, ROADMAP)."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.enforce import enforce

_ACTS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}


def _act(name: str):
    enforce(name in _ACTS, "unknown activation %s", name)
    return _ACTS[name]


def lstm_unit(x_gates, h, c, forget_bias: float = 0.0,
              gate_activation: str = "sigmoid",
              cell_activation: str = "tanh",
              candidate_activation: str = "tanh"):
    """One LSTM step from pre-projected gates (reference:
    operators/lstm_unit_op.cc). ``x_gates``: (B, 4H) = x@W_ih + h@W_hh + b
    in i, f, g, o order. Returns (new_h, new_c)."""
    gact, cact, candact = (_act(gate_activation), _act(cell_activation),
                           _act(candidate_activation))
    i, f, g, o = torch.chunk(x_gates, 4, dim=-1)
    new_c = gact(f + forget_bias) * c + gact(i) * candact(g)
    return gact(o) * cact(new_c), new_c


def gru_unit(x_gates, h, w_hh, gate_activation: str = "sigmoid",
             activation: str = "tanh"):
    """One GRU step (reference: operators/gru_unit_op.cc). ``x_gates``:
    (B, 3H) = x@W_ih + b in r, u, c order; ``w_hh``: (H, 3H)."""
    gact, act = _act(gate_activation), _act(activation)
    hsz = h.shape[-1]
    hh = h @ w_hh
    r = gact(x_gates[..., :hsz] + hh[..., :hsz])
    u = gact(x_gates[..., hsz:2 * hsz] + hh[..., hsz:2 * hsz])
    c = act(x_gates[..., 2 * hsz:] + r * hh[..., 2 * hsz:])
    return u * h + (1.0 - u) * c


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of equally shaped tuples, lists and
    dicts."""
    first = trees[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, *parts) for parts in zip(*trees))
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _mask_carry(new, old, active):
    """Freeze the carried state of finished (padded) rows."""
    return _tree_map(lambda n, o: torch.where(
        active.reshape((-1,) + (1,) * (n.ndim - 1)), n, o), new, old)


def _steps(t: int, lengths, is_reverse: bool, device):
    """[(time index, the rows active there or None)] in walking order."""
    order = range(t - 1, -1, -1) if is_reverse else range(t)
    if lengths is None:
        return [(i, None) for i in order]
    live = torch.arange(t, device=device)[:, None] < torch.as_tensor(
        lengths, device=device)[None, :]            # (T, B)
    return [(i, live[i]) for i in order]


def _gather_outputs(outs, is_reverse: bool):
    """The per-step outputs in time order, (B, T, ...)."""
    return torch.stack(outs[::-1] if is_reverse else outs, dim=1)


def lstm(x, w_ih, w_hh, bias=None, h0=None, c0=None, lengths=None,
         forget_bias: float = 0.0, is_reverse: bool = False,
         proj_weight=None, proj_activation: str = "identity",
         gate_activation: str = "sigmoid", cell_activation: str = "tanh",
         candidate_activation: str = "tanh", unroll: int = 1):
    """Full-sequence LSTM (reference: operators/lstm_op.cc; with
    ``proj_weight`` it is lstmp, operators/lstmp_op.cc).

    x: (B, T, D); w_ih: (D, 4H); w_hh: (R, 4H), R = H without projection
    or the projection's width with one; bias: (4H,); proj_weight: (H, R).
    Returns (outputs (B, T, R), (h_T, c_T))."""
    b, t, _ = x.shape
    hsz = w_ih.shape[-1] // 4
    rsz = w_hh.shape[0]
    h = x.new_zeros((b, rsz)) if h0 is None else h0
    c = x.new_zeros((b, hsz)) if c0 is None else c0
    gates_x = x @ w_ih
    if bias is not None:
        gates_x = gates_x + bias
    outs = []
    for i, active in _steps(t, lengths, is_reverse, x.device):
        new_h, new_c = lstm_unit(gates_x[:, i] + h @ w_hh, h, c,
                                 forget_bias, gate_activation,
                                 cell_activation, candidate_activation)
        if proj_weight is not None:
            new_h = _act(proj_activation)(new_h @ proj_weight)
        if active is not None:
            new_h, new_c = _mask_carry((new_h, new_c), (h, c), active)
            out = new_h * active.to(new_h.dtype)[:, None]
        else:
            out = new_h
        h, c = new_h, new_c
        outs.append(out)
    return _gather_outputs(outs, is_reverse), (h, c)


def gru(x, w_ih, w_hh, bias=None, h0=None, lengths=None,
        is_reverse: bool = False, gate_activation: str = "sigmoid",
        activation: str = "tanh", unroll: int = 1):
    """Full-sequence GRU (reference: operators/gru_op.cc).

    x: (B, T, D); w_ih: (D, 3H); w_hh: (H, 3H); bias: (3H,).
    Returns (outputs (B, T, H), h_T)."""
    b, t, _ = x.shape
    h = x.new_zeros((b, w_hh.shape[0])) if h0 is None else h0
    gates_x = x @ w_ih
    if bias is not None:
        gates_x = gates_x + bias
    outs = []
    for i, active in _steps(t, lengths, is_reverse, x.device):
        new_h = gru_unit(gates_x[:, i], h, w_hh, gate_activation,
                         activation)
        if active is not None:
            new_h = _mask_carry(new_h, h, active)
            out = new_h * active.to(new_h.dtype)[:, None]
        else:
            out = new_h
        h = new_h
        outs.append(out)
    return _gather_outputs(outs, is_reverse), h


def lstmp(x, w_ih, w_hh, proj_weight, bias=None, **kw):
    """Projected LSTM (reference: operators/lstmp_op.cc)."""
    return lstm(x, w_ih, w_hh, bias=bias, proj_weight=proj_weight, **kw)


def row_conv(x, weight, lengths=None):
    """Lookahead row convolution (reference: operators/row_conv_op.cc).
    x: (B, T, D); weight: (context, D). out[b, t] = sum_{k < context}
    w[k] * x[b, t + k], zero past the sequence's end."""
    t = x.shape[1]
    if lengths is not None:
        from .sequence import sequence_mask

        x = x * sequence_mask(lengths, t, x.dtype)[:, :, None]
    out = torch.zeros_like(x)
    for k in range(weight.shape[0]):
        out = out + torch.nn.functional.pad(
            x[:, k:, :] * weight[k][None, None, :], (0, 0, 0, k))
    return out


def conv_shift(x, y):
    """Circular convolution (reference: operators/conv_shift_op.cc).
    x: (B, M); y: (B, N), N odd and <= M. out[b, i] = sum_j y[b, j] *
    x[b, (i + j - N // 2) mod M]."""
    n = y.shape[1]
    enforce(n % 2 == 1, "conv_shift filter width must be odd, got %s", n)
    half = n // 2
    out = torch.zeros_like(x)
    for j in range(n):
        out = out + y[:, j:j + 1] * torch.roll(x, -(j - half), dims=1)
    return out


def sequence_conv(x, weight, lengths=None, context_length: int = 3,
                  context_start: Optional[int] = None, bias=None):
    """Sequence convolution over time (reference:
    operators/sequence_ops/sequence_conv_op.cc): the ``context_length``
    frames around each step (zero outside the sequence), concatenated
    and projected by ``weight`` (context_length * D, Dout).
    x: (B, T, D); returns (B, T, Dout)."""
    t, d = x.shape[1], x.shape[2]
    if context_start is None:
        context_start = -(context_length // 2)
    enforce(weight.shape[0] == context_length * d,
            "sequence_conv weight rows %s != context_length*D %s",
            weight.shape[0], context_length * d)
    if lengths is not None:
        from .sequence import sequence_mask

        x = x * sequence_mask(lengths, t, x.dtype)[:, :, None]
    pos = torch.arange(t, device=x.device)
    cols = []
    for k in range(context_length):
        offset = context_start + k
        shifted = torch.roll(x, -offset, dims=1)
        if offset != 0:      # zero what wrapped around
            keep = (pos < t - offset) if offset > 0 else (pos >= -offset)
            shifted = shifted * keep.to(x.dtype)[None, :, None]
        cols.append(shifted)
    out = torch.cat(cols, dim=-1) @ weight
    if bias is not None:
        out = out + bias
    return out


def dynamic_rnn(cell_fn, x, init_state, lengths=None, is_reverse=False):
    """Generic masked recurrence (the reference's DynamicRNN on the
    padded batch): ``cell_fn(x_t, state) -> (out_t, new_state)``, the
    state a tensor or a tuple/list/dict of them; x: (B, T, D). Returns
    (outs (B, T, ...), final_state)."""
    state = init_state
    outs = []
    for i, active in _steps(x.shape[1], lengths, is_reverse, x.device):
        out, new_state = cell_fn(x[:, i], state)
        if active is not None:
            new_state = _mask_carry(new_state, state, active)
            out = out * active.to(out.dtype).reshape(
                (-1,) + (1,) * (out.ndim - 1))
        state = new_state
        outs.append(out)
    return _gather_outputs(outs, is_reverse), state
