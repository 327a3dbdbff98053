"""Tensor ops (counterpart of paddle_tpu/ops/tensor.py): creation,
shape, indexing and search (reference: paddle/fluid/operators/<name>_op.cc).

The creation ops take ``device=`` (the CUDA card when None; with no card
they raise :class:`DeviceUnavailableError`); every other op works on its
inputs' device.

Indexing keeps the JAX package's semantics for an index out of range,
where torch would raise on the CPU and assert on the card (an assert
poisons the CUDA context for the rest of the process). Each op clamps
the index, gathers or scatters, and masks, with no read back to the
host:

- ``gather`` is ``jnp.take``: an index in [-n, 0) wraps, one outside
  [-n, n) reads the fill value (NaN for floats, the type's minimum for
  signed integers, its maximum for unsigned ones, True for bool);
- ``gather_nd`` and ``multiplex`` index as ``x[...]`` does in JAX: a
  negative index wraps, then every index is clamped into range, and the
  gradient of a clamped read is dropped (the transposed scatter drops
  the row);
- ``scatter`` and ``scatter_nd_add`` are ``x.at[...]``: a negative index
  wraps, and a row out of range is dropped.

Search keeps the JAX tie orders: ``top_k`` puts the lower index first
(``lax.top_k``; ``torch.topk`` on the card promises no order), and
``argsort(descending=True)`` flips a stable ascending sort, so ties come
out last index first.

``where_index`` and ``unique_with_counts`` have outputs whose shape
depends on the data: on the card each reads its size back to the host,
one synchronisation a call. The random ops take the JAX package's
threefry key (key data, ``uint32[2]``) and draw from a
``torch.Generator`` seeded from it: distributed as the JAX package's
draws, not equal to them."""

from __future__ import annotations

import builtins
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from ..core.dtypes import to_dtype
from ..core.enforce import enforce
from ..core.places import resolve_device
from ..core.random import seed_generator

# --- creation --------------------------------------------------------------


def fill_constant(shape, value, dtype=torch.float32, *, device=None):
    return torch.full(tuple(shape), value, dtype=to_dtype(dtype),
                      device=resolve_device(device))


def fill_constant_batch_size_like(ref, shape, value, dtype=torch.float32,
                                  input_dim_idx: int = 0,
                                  output_dim_idx: int = 0):
    """``shape`` with its ``output_dim_idx`` entry taken from
    ``ref.shape[input_dim_idx]``, filled with ``value`` on ref's device."""
    shape = list(shape)
    shape[output_dim_idx] = ref.shape[input_dim_idx]
    return torch.full(tuple(shape), value, dtype=to_dtype(dtype),
                      device=ref.device)


def fill_zeros_like(x):
    return torch.zeros_like(x)


def ones(shape, dtype=torch.float32, *, device=None):
    return torch.ones(tuple(shape), dtype=to_dtype(dtype),
                      device=resolve_device(device))


def zeros(shape, dtype=torch.float32, *, device=None):
    return torch.zeros(tuple(shape), dtype=to_dtype(dtype),
                       device=resolve_device(device))


def eye(n, m=None, dtype=torch.float32, *, device=None):
    return torch.eye(n, n if m is None else m, dtype=to_dtype(dtype),
                     device=resolve_device(device))


def diag(v):
    """A 1-D ``v`` -> the square matrix with it on the diagonal; a 2-D
    one -> its diagonal (``jnp.diag``)."""
    return torch.diag(v)


def linspace(start, stop, num, dtype=torch.float32, *, device=None):
    return torch.linspace(start, stop, int(num), dtype=to_dtype(dtype),
                          device=resolve_device(device))


def arange(start, end=None, step=1, dtype=None, *, device=None):
    """``jnp.arange``'s arguments; with ``dtype`` None the type follows
    torch's inference (int64 for integer bounds, float32 otherwise)."""
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step,
                        dtype=None if dtype is None else to_dtype(dtype),
                        device=resolve_device(device))


def uniform_random(shape, key, min: float = -1.0,  # noqa: A002
                   max: float = 1.0,  # noqa: A002 - the reference's names
                   dtype=torch.float32, *, device=None):
    """U[min, max) of ``shape``, drawn from ``key``."""
    device = resolve_device(device)
    out = torch.empty(tuple(shape), dtype=to_dtype(dtype), device=device)
    gen = seed_generator(torch.Generator(device=device), key)
    return out.uniform_(min, max, generator=gen)


def gaussian_random(shape, key, mean: float = 0.0, std: float = 1.0,
                    dtype=torch.float32, *, device=None):
    """N(mean, std^2) of ``shape``, drawn from ``key``."""
    device = resolve_device(device)
    out = torch.empty(tuple(shape), dtype=to_dtype(dtype), device=device)
    gen = seed_generator(torch.Generator(device=device), key)
    return out.normal_(generator=gen) * std + mean


def truncated_gaussian_random(shape, key, mean: float = 0.0,
                              std: float = 1.0, dtype=torch.float32, *,
                              device=None):
    """A standard normal truncated to [-2, 2] (``jax.random.
    truncated_normal``'s bounds), times ``std``, plus ``mean``."""
    device = resolve_device(device)
    out = torch.empty(tuple(shape), dtype=to_dtype(dtype), device=device)
    gen = seed_generator(torch.Generator(device=device), key)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return out * std + mean


def assign(x, *, device=None):
    """``x`` as a tensor: a tensor as it is, anything else on ``device``
    (the CUDA card when None)."""
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(x, device=resolve_device(device))


# --- shape ops -------------------------------------------------------------


def reshape(x, shape):
    """reference: reshape2 — one -1, and 0 copies the input's dim."""
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return torch.reshape(x, shape)


def transpose(x, perm):
    return x.permute(*perm)


def flatten(x, axis: int = 1):
    """Collapse to 2-D at ``axis``: (prod(shape[:axis]), rest) (the
    reference's flatten2)."""
    lead = 1
    for s in x.shape[:axis]:
        lead *= s
    return x.reshape(lead, -1)


def squeeze(x, axes: Optional[Sequence[int]] = None):
    """Drop the size-1 ``axes`` (every size-1 dim when None or empty);
    a listed axis of another size raises, as in ``jnp.squeeze``."""
    if not axes:
        return torch.squeeze(x)
    for a in axes:
        enforce(x.shape[a] == 1, "cannot squeeze axis %s of size %s", a,
                x.shape[a])
    return torch.squeeze(x, tuple(axes))


def unsqueeze(x, axes: Union[int, Sequence[int]]):
    if isinstance(axes, int):
        axes = [axes]
    for a in sorted(axes):
        x = torch.unsqueeze(x, a)
    return x


def expand(x, expand_times: Sequence[int]):
    """reference: expand_op.cc — tile each dim ``expand_times`` times."""
    return torch.tile(x, tuple(expand_times))


def expand_as(x, target):
    return torch.broadcast_to(x, target.shape)


def stack(xs, axis: int = 0):
    return torch.stack(list(xs), dim=axis)


def unstack(x, axis: int = 0):
    return list(torch.unbind(x, dim=axis))


def concat(xs, axis: int = 0):
    return torch.cat(list(xs), dim=axis)


def split(x, num_or_sections, axis: int = 0):
    """``num_or_sections`` equal parts, or a list of sizes in which one
    -1 takes the rest."""
    if isinstance(num_or_sections, int):
        n = x.shape[axis]
        enforce(n % num_or_sections == 0,
                "split: dim %s of size %s is not divisible into %s", axis, n,
                num_or_sections)
        return list(torch.split(x, n // num_or_sections, dim=axis))
    sections = list(num_or_sections)
    if -1 in sections:
        rest = x.shape[axis] - builtins.sum(s for s in sections if s != -1)
        sections[sections.index(-1)] = rest
    return list(torch.split(x, sections, dim=axis))


def slice(x, axes, starts, ends):  # noqa: A001 - the reference's name
    """reference: slice_op.cc — Python slice bounds on each of ``axes``."""
    idx = [builtins.slice(None)] * x.ndim
    for ax, st, en in zip(axes, starts, ends):
        idx[ax] = builtins.slice(st, en)
    return x[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides):
    """Python slices with strides (negative ones too: torch slicing takes
    only positive steps, so those axes are gathered)."""
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        pos = range(*builtins.slice(st, en, sd).indices(x.shape[ax]))
        x = torch.index_select(x, ax, torch.tensor(list(pos),
                                                   dtype=torch.long,
                                                   device=x.device))
    return x


def crop(x, shape, offsets):
    """reference: crop_op.cc — the window of ``shape`` at ``offsets``."""
    return x[tuple(builtins.slice(o, o + s)
                   for o, s in zip(offsets, shape))]


def reverse(x, axis):
    if isinstance(axis, int):
        axis = [axis]
    return torch.flip(x, tuple(axis))


def pad(x, paddings, pad_value: float = 0.0):
    """reference: pad_op.cc — ``paddings`` is flat [before0, after0,
    before1, ...] over every dim."""
    cfg = []
    for i in reversed(range(x.ndim)):
        cfg += [paddings[2 * i], paddings[2 * i + 1]]
    return F.pad(x, cfg, value=pad_value)


def pad_constant_like(x, y, pad_value: float = 0.0):
    """reference: pad_constant_like_op.cc — ``y`` padded at the end of
    each dim up to x's shape."""
    cfg = []
    for xs, ys in reversed(list(zip(x.shape, y.shape))):
        cfg += [0, xs - ys]
    return F.pad(y, cfg, value=pad_value)


def shape(x):
    """The shape as an int32 vector on x's device."""
    return torch.tensor(tuple(x.shape), dtype=torch.int32, device=x.device)


def cast(x, dtype):
    """``x`` as ``dtype``. Float to integer converts as XLA's convert
    does: toward zero, saturating at the type's range, NaN to 0 (a bare
    ``.to`` wraps, or is undefined, out of range). The port keeps int64
    where the JAX package, without 64-bit mode, gives int32."""
    dt = to_dtype(dtype)
    if not x.dtype.is_floating_point or dt.is_floating_point or \
            dt.is_complex or dt == torch.bool:
        return x.to(dt)
    info = torch.iinfo(dt)
    # the limits as x's float type rounds them: a value at or past one
    # saturates; what lies strictly between converts exactly
    lo, hi = float(info.min), float(info.max)
    t = torch.trunc(x)
    inside = (t > lo) & (t < hi)
    out = torch.where(inside, t, torch.zeros_like(t)).to(dt)
    out = torch.where(t >= hi, torch.full((), info.max, dtype=dt,
                                          device=x.device), out)
    return torch.where(t <= lo, torch.full((), info.min, dtype=dt,
                                           device=x.device), out)


# --- indexing / search -----------------------------------------------------


def _fill_value(dtype):
    """``jnp.take``'s fill for an index out of range."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.max if dtype == torch.uint8 else info.min


def gather(x, index, axis: int = 0):
    """reference: gather_op.cc — ``jnp.take(x, index, axis)``: the
    slices of ``x`` along ``axis`` at ``index`` (any shape), with the
    fill for an index out of range (module docstring)."""
    axis = axis % x.ndim
    n = x.shape[axis]
    idx = index.long()
    inside = (idx >= -n) & (idx < n)
    safe = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    out = torch.index_select(x, axis, safe.reshape(-1))
    out = out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])
    mask = inside.reshape((1,) * axis + tuple(idx.shape)
                          + (1,) * (x.ndim - axis - 1))
    return torch.where(mask, out, torch.full((), _fill_value(x.dtype),
                                             dtype=x.dtype, device=x.device))


def _take_along(x, index, axis: int):
    """``jnp.take_along_axis(x, index, axis)``: ``index`` broadcasts
    against x off ``axis``; an index in [-n, 0) wraps, one outside
    [-n, n) reads the fill value (module docstring)."""
    n = x.shape[axis]
    idx = index.long()
    inside = (idx >= -n) & (idx < n)
    safe = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    out = torch.take_along_dim(x, safe, dim=axis)
    return torch.where(inside, out, torch.full((), _fill_value(x.dtype),
                                               dtype=x.dtype,
                                               device=x.device))


def _wrap_clamp(idx, n: int):
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def _in_range(idx, n: int):
    """Whether each index lies in range once a negative one wraps."""
    idx = idx.long()
    return (idx >= -n) & (idx < n)


def _drop_grad(out, ok):
    """``out`` with no gradient through the leading entries where ``ok``
    is False: JAX's ``x[idx]`` clamps an index out of range where it
    reads, and its transpose (a scatter-add) drops that row."""
    ok = ok.reshape(ok.shape + (1,) * (out.ndim - ok.ndim))
    return torch.where(ok, out, out.detach())


def gather_nd(x, index):
    """``x[tuple(index[..., j] for j)]``: the last axis of ``index``
    addresses x's first dims; each coordinate wraps if negative, then is
    clamped into range (its gradient dropped, as JAX's)."""
    k = index.shape[-1]
    coords = tuple(_wrap_clamp(index[..., j], x.shape[j]) for j in range(k))
    ok = torch.ones_like(coords[0], dtype=torch.bool)
    for j in range(k):
        ok = ok & _in_range(index[..., j], x.shape[j])
    return _drop_grad(x[coords], ok)


def _flat_rows(x, coords):
    """(linear row of x's first len(coords) dims, whether every
    coordinate is in range after a negative one wraps)."""
    lin = torch.zeros_like(coords[0], dtype=torch.long)
    ok = torch.ones_like(coords[0], dtype=torch.bool)
    for j, c in enumerate(coords):
        n = x.shape[j]
        c = c.long()
        c = torch.where(c < 0, c + n, c)
        ok = ok & (c >= 0) & (c < n)
        lin = lin * n + c.clamp(0, n - 1)
    return lin, ok


def _scatter_rows(x, coords, updates, add: bool):
    """``x.at[coords].set/add(updates)`` with rows out of range dropped:
    they are sent to one spare row past the end, which is cut off."""
    k = len(coords)
    lead = x.shape[:k]
    rows = 1
    for s in lead:
        rows *= s
    flat = x.reshape((rows,) + tuple(x.shape[k:]))
    lin, ok = _flat_rows(x, coords)
    lin = torch.where(ok, lin, rows).reshape(-1)
    upd = torch.broadcast_to(torch.as_tensor(updates, dtype=x.dtype,
                                             device=x.device),
                             tuple(ok.shape) + tuple(x.shape[k:]))
    upd = upd.reshape((-1,) + tuple(x.shape[k:]))
    ext = torch.cat([flat, flat.new_zeros((1,) + tuple(x.shape[k:]))])
    ext = (ext.index_add(0, lin, upd) if add
           else ext.index_copy(0, lin, upd))
    return ext[:rows].reshape(x.shape)


def scatter(x, index, updates, overwrite: bool = True):
    """reference: scatter_op.cc — rows of ``x`` at ``index`` set to
    ``updates`` (``overwrite``) or added to (duplicates summed); a row
    out of range is dropped."""
    return _scatter_rows(x, (index,), updates, add=not overwrite)


def scatter_nd_add(x, index, updates):
    """``x.at[tuple(index[..., j] for j)].add(updates)``: duplicates
    summed, an entry with a coordinate out of range dropped."""
    k = index.shape[-1]
    return _scatter_rows(x, tuple(index[..., j] for j in range(k)), updates,
                         add=True)


def top_k(x, k: int):
    """reference: top_k_op.cc — (values, indices) of the k largest over
    the last dim, ties to the lower index (``lax.top_k``): a stable
    descending sort, cut to k."""
    values, order = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], order[..., :k]


def argsort(x, axis: int = -1, descending: bool = False):
    """(sorted values, order): a stable ascending sort, flipped when
    ``descending``, so equal values come out last index first there."""
    order = torch.argsort(x, dim=axis, stable=True)
    if descending:
        order = torch.flip(order, (axis,))
    return torch.take_along_dim(x, order, dim=axis), order


def arg_max(x, axis: int = -1):
    return torch.argmax(x, dim=axis)


def arg_min(x, axis: int = -1):
    return torch.argmin(x, dim=axis)


def where_index(cond):
    """reference: where_op.cc — (N, ndim) indices of the nonzero
    entries. N depends on the data: on the card this reads it back, one
    host synchronisation a call."""
    return torch.nonzero(cond)


def where(cond, x, y):
    return torch.where(cond, x, y)


def multiplex(index, inputs):
    """reference: multiplex_op.cc — row i of ``inputs[index[i]]``; an
    index wraps if negative, then is clamped into range (its gradient
    dropped, as JAX's)."""
    stacked = torch.stack(list(inputs), dim=0)         # (K, N, ...)
    idx = _wrap_clamp(index.reshape(-1), stacked.shape[0])
    out = stacked[idx, torch.arange(stacked.shape[1], device=idx.device)]
    return _drop_grad(out, _in_range(index.reshape(-1), stacked.shape[0]))


def is_empty(x):
    return torch.tensor(x.numel() == 0, device=x.device)


def random_crop(x, shape, key):
    """reference: random_crop_op.cc — a window of ``shape`` over x's
    trailing dims at offsets drawn from ``key``. The offsets are drawn
    on the host (a CPU generator seeded from the key), so the crop reads
    nothing back from the card."""
    gen = seed_generator(torch.Generator(), key)
    lead = x.ndim - len(shape)
    idx = [builtins.slice(None)] * lead
    for xs, s in zip(x.shape[lead:], shape):
        o = int(torch.randint(0, xs - s + 1, (), generator=gen))
        idx.append(builtins.slice(o, o + s))
    return x[tuple(idx)]


def unique_with_counts(x):
    """reference: unique_with_counts_op — (sorted unique values, their
    counts). Their number depends on the data: on the card this reads it
    back, one host synchronisation a call."""
    return torch.unique(x, sorted=True, return_counts=True)


def roll(x, shifts, axis=None):
    return torch.roll(x, shifts, axis)


def tril(x, k: int = 0):
    return torch.tril(x, k)


def triu(x, k: int = 0):
    return torch.triu(x, k)
