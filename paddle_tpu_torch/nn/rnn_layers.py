"""Stacked, optionally bidirectional LSTM and GRU layers (counterpart of
paddle_tpu/nn/rnn_layers.py, the reference's cudnn_lstm capability):
each direction of each layer is a recurrence of ops/rnn.py, its input
projection hoisted out of the loop over time.

Parameters ``w_ih_l{i}[_rev]`` (in, G*H), ``w_hh_l{i}[_rev]`` (H, G*H)
and ``bias_l{i}[_rev]`` (G*H,), created in the JAX package's order, so
weights cross by name. Dropout falls between layers. ``scan_unroll`` is
the JAX scan's unroll factor, a knob there that does not change the
math; it is accepted and has no effect here."""

from __future__ import annotations

import torch

from .. import initializer as I
from ..core.enforce import enforce
from ..ops import rnn as R
from .layer import Layer, use
from .layers import Dropout


class _RecurrentBase(Layer):
    """Shared stacked/bidirectional plumbing for LSTM and GRU."""

    num_gates = 4

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, direction: str = "forward",
                 dropout: float = 0.0, dtype=None, scan_unroll: int = 1, *,
                 device=None, generator=None):
        super().__init__()
        self.scan_unroll = scan_unroll
        enforce(direction in ("forward", "bidirect", "bidirectional"),
                "direction must be forward|bidirect, got %s", direction)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers = num_layers
        self.bidirectional = direction != "forward"
        self.dropout_p = dropout
        ndir = 2 if self.bidirectional else 1
        g = self.num_gates
        kw = dict(device=device, generator=generator)
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else hidden_size * ndir
            for d in range(ndir):
                sfx = f"l{layer}" + ("_rev" if d else "")
                self.create_parameter(f"w_ih_{sfx}",
                                      (in_sz, g * hidden_size), dtype,
                                      I.XavierUniform(), **kw)
                self.create_parameter(f"w_hh_{sfx}",
                                      (hidden_size, g * hidden_size), dtype,
                                      I.XavierUniform(), **kw)
                self.create_parameter(f"bias_{sfx}", (g * hidden_size,),
                                      dtype, I.Constant(0.0), is_bias=True,
                                      **kw)
        self.drop = Dropout(dropout) if dropout > 0 else None

    def _run_direction(self, x, sfx, lengths, is_reverse):
        raise NotImplementedError

    def _stack_states(self, finals):
        raise NotImplementedError

    def forward(self, x, lengths=None):
        """x: (B, T, D) -> (outputs (B, T, H * ndir), the final states
        stacked over (num_layers * ndir, B, H))."""
        finals = []
        h = x
        for layer in range(self.num_layers):
            fwd_out, fwd_fin = self._run_direction(h, f"l{layer}", lengths,
                                                   False)
            if self.bidirectional:
                bwd_out, bwd_fin = self._run_direction(
                    h, f"l{layer}_rev", lengths, True)
                h = torch.cat([fwd_out, bwd_out], dim=-1)
                finals += [fwd_fin, bwd_fin]
            else:
                h = fwd_out
                finals.append(fwd_fin)
            if self.drop is not None and layer < self.num_layers - 1:
                h = self.drop(h)
        return h, self._stack_states(finals)


class LSTM(_RecurrentBase):
    """Stacked (bi)LSTM. Final states: (h (L*ndir, B, H), c (L*ndir, B,
    H))."""

    num_gates = 4

    def _run_direction(self, x, sfx, lengths, is_reverse):
        return R.lstm(x, use(getattr(self, f"w_ih_{sfx}")),
                      use(getattr(self, f"w_hh_{sfx}")),
                      bias=use(getattr(self, f"bias_{sfx}")),
                      lengths=lengths,
                      is_reverse=is_reverse, unroll=self.scan_unroll)

    def _stack_states(self, finals):
        return (torch.stack([f[0] for f in finals]),
                torch.stack([f[1] for f in finals]))


class GRU(_RecurrentBase):
    """Stacked (bi)GRU. Final state: (L*ndir, B, H)."""

    num_gates = 3

    def _run_direction(self, x, sfx, lengths, is_reverse):
        return R.gru(x, use(getattr(self, f"w_ih_{sfx}")),
                     use(getattr(self, f"w_hh_{sfx}")),
                     bias=use(getattr(self, f"bias_{sfx}")),
                     lengths=lengths,
                     is_reverse=is_reverse, unroll=self.scan_unroll)

    def _stack_states(self, finals):
        return torch.stack(finals)
