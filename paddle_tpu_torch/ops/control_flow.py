"""Control flow (counterpart of paddle_tpu/ops/control_flow.py;
reference: operators/controlflow/ while_op.cc, conditional_block_op.cc,
recurrent_op.cc, compare_op.cc, logical_op.cc, and the python
StaticRNN/While/IfElse layers).

The JAX package wraps ``lax.while_loop``/``cond``/``switch``/``scan``;
PyTorch runs eagerly, so here they are Python control flow over tensors
with the same call contracts. A predicate or branch index that is a
tensor is read on the host: on the card each read is one host
synchronisation (``while_loop`` pays one per iteration, ``cond``,
``case`` and ``switch_case`` one per call). ``scan``, ``static_rnn``
and ``fori_loop`` with Python bounds read nothing back. Loop state is a
pytree of dicts, lists and tuples of tensors, as in the JAX package."""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import torch

from ..clip import tree_leaves, tree_map
from ..core.enforce import enforce
from ..core.places import resolve_device

# --- compare ops (REGISTER_COMPARE_OP family) ------------------------------


def less_than(x, y):
    return torch.lt(x, y)


def less_equal(x, y):
    return torch.le(x, y)


def greater_than(x, y):
    return torch.gt(x, y)


def greater_equal(x, y):
    return torch.ge(x, y)


def equal(x, y):
    return torch.eq(x, y)


def not_equal(x, y):
    return torch.ne(x, y)


# --- logical ops -----------------------------------------------------------


def logical_and(x, y):
    return torch.logical_and(x, y)


def logical_or(x, y):
    return torch.logical_or(x, y)


def logical_xor(x, y):
    return torch.logical_xor(x, y)


def logical_not(x):
    return torch.logical_not(x)


# --- structured control flow ----------------------------------------------


def _truth(pred) -> bool:
    """A predicate's value on the host (one synchronisation for a tensor
    on the card)."""
    return bool(pred)


def while_loop(cond: Callable, body: Callable, loop_vars: Any):
    """reference: while_op.cc — ``loop_vars = body(loop_vars)`` while
    ``cond(loop_vars)``; the predicate is read each iteration."""
    while _truth(cond(loop_vars)):
        loop_vars = body(loop_vars)
    return loop_vars


def cond(pred, true_fn: Callable, false_fn: Callable, *operands):
    """reference: conditional_block_op.cc / layers.cond."""
    return true_fn(*operands) if _truth(pred) else false_fn(*operands)


def case(pred_fn_pairs: Sequence[Tuple[Any, Callable]],
         default: Callable = None):
    """reference: python layers.case — the first true predicate's
    function; ``default`` when none is true (ValueError without one, as
    in the JAX package)."""
    for pred, fn in pred_fn_pairs:
        if _truth(pred):
            return fn()
    if default is None:
        raise ValueError("case: no predicate matched and no default")
    return default()


def switch_case(branch_index, branch_fns: Sequence[Callable], *operands):
    """reference: python layers.switch_case — ``lax.switch``: the index
    is clamped into [0, len(branch_fns) - 1]."""
    fns = list(branch_fns)
    i = min(max(int(branch_index), 0), len(fns) - 1)
    return fns[i](*operands)


def scan(f: Callable, init: Any, xs: Any, length: int = None,
         reverse: bool = False, unroll: int = 1):
    """The ``lax.scan`` contract (the recurrent_op replacement):
    ``f(carry, x) -> (carry, y)`` over the leading axis of the pytree
    ``xs`` (or ``length`` steps with ``xs`` None); returns (the last
    carry, the ys stacked on a new leading axis in step order).
    ``reverse`` walks from the end and stacks each y at its own index,
    as ``lax.scan`` does. ``unroll`` is a compiler hint in JAX and has
    no effect here."""
    leaves = [] if xs is None else tree_leaves(xs)
    n = leaves[0].shape[0] if leaves else length
    enforce(length is None or not leaves or n == length,
            "scan: length %s != the inputs' leading axis %s", length, n)
    steps = range(n - 1, -1, -1) if reverse else range(n)
    carry, ys = init, [None] * n
    for i in steps:
        x_i = None if xs is None else tree_map(lambda v: v[i], xs)
        carry, ys[i] = f(carry, x_i)
    if n == 0 or ys[0] is None:
        return carry, None
    return carry, tree_map(lambda *vs: torch.stack(vs), *ys)


def static_rnn(step_fn: Callable, inputs, initial_states,
               time_major: bool = False):
    """StaticRNN (reference: layers/control_flow.py StaticRNN):
    ``step_fn(x_t, states) -> (output_t, new_states)`` over the time axis
    of the pytree ``inputs`` ((B, T, ...), or (T, B, ...) when
    ``time_major``); returns (the outputs stacked on the time axis in the
    inputs' layout, the final states)."""
    if not time_major:
        inputs = tree_map(lambda x: x.transpose(0, 1), inputs)

    def body(states, x_t):
        out_t, new_states = step_fn(x_t, states)
        return new_states, out_t

    final_states, outs = scan(body, initial_states, inputs)
    if not time_major:
        outs = tree_map(lambda x: x.transpose(0, 1), outs)
    return outs, final_states


def fori_loop(lower, upper, body: Callable, init):
    """``val = body(i, val)`` for i in [lower, upper); tensor bounds are
    read on the host."""
    val = init
    for i in range(int(lower), int(upper)):
        val = body(i, val)
    return val


# --- tensor array ----------------------------------------------------------


class TensorArray:
    """A tensor array of fixed size on a preallocated buffer (reference:
    operators/tensor_array_read_write_op.cc): ``write`` returns a new
    array and leaves this one as it is, as in the JAX package. An index
    may be a tensor (read on the device, no host read); one out of range
    is clamped, as ``lax.dynamic_update_index_in_dim`` clamps it."""

    def __init__(self, size: int, element_shape, dtype=torch.float32,
                 buffer=None, *, device=None):
        self.size = size
        if buffer is not None:
            self.buffer = buffer
        else:
            self.buffer = torch.zeros((size,) + tuple(element_shape),
                                      dtype=dtype,
                                      device=resolve_device(device))

    def _index(self, index):
        if isinstance(index, int):
            index = index + self.size if index < 0 else index
            return min(max(index, 0), self.size - 1)
        index = index.long()
        index = torch.where(index < 0, index + self.size, index)
        return torch.clamp(index, 0, self.size - 1).reshape(1)

    def write(self, index, value) -> "TensorArray":
        i = self._index(index)
        value = value[None].to(self.buffer.dtype)
        if isinstance(i, int):
            buf = torch.cat([self.buffer[:i], value, self.buffer[i + 1:]])
        else:
            buf = self.buffer.index_copy(0, i, value)
        return TensorArray(self.size, value.shape[1:], value.dtype,
                           buffer=buf)

    def read(self, index):
        i = self._index(index)
        if isinstance(i, int):
            return self.buffer[i]
        return torch.index_select(self.buffer, 0, i)[0]

    def stack(self):
        return self.buffer
