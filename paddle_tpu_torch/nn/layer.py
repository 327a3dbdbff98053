"""Layer: the module system (counterpart of paddle_tpu/nn/layer.py).

The JAX package's Layer is a mutable container whose compiled entry
points are functional. Here it is a ``torch.nn.Module``: PyTorch runs
eagerly, and a layer's own parameters are its state. What carries over
is the naming — parameters are registered under the same dotted paths
(``blocks.0.self_attn.q_proj.weight``) and layouts, so a state moves
between the packages by name (utils/convert.py) — and the functional
entry points (``functional_call``, ``apply_fn``, :func:`inject_state`),
which run a layer on tensors the caller passes and leave the layer and
those tensors as they were.

Every layer takes an explicit ``device=`` (the CUDA card when None; see
core/places.py) and ``generator=`` (a ``torch.Generator`` on that device,
for its initial draws). Creating a parameter draws one key off the
global stream (core/random.py) whether or not a generator is given, as
the JAX package's ``create_parameter`` does, so the stream stays in step
with the JAX package's.

The JAX package's Paddle-style state methods carry over on every layer,
``LayerList`` and ``Sequential``: ``add_sublayer``, ``named_sublayers``
(pre-order, the layer itself left out: not torch's ``named_modules``),
``sublayers``, ``set_parameters`` (an unknown own name raises, a dotted
name under no sublayer is skipped), ``set_buffers`` (never raises) and
``update_buffer``. ``layer.w = Parameter(value)`` registers a trainable,
and assigning a tensor or an array to an existing parameter's name
updates that parameter (a plain ``torch.nn.Module`` raises
``TypeError``)."""

from __future__ import annotations

import contextlib
import itertools
import zlib
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

from ..core.dtypes import default_dtype, get_policy, policy_scope, to_dtype
# not_found: re-exported, as the JAX module's namespace has it
from ..core.enforce import enforce, not_found  # noqa: F401
from ..core.places import DeviceLike, resolve_device
from ..core.random import (current_generator, fold_in, key_for, make_key,
                           next_key, rng_scope, seed_generator)


class Parameter:
    """Marker wrapper: ``layer.w = Parameter(value)`` registers ``value``
    as a trainable parameter ``w`` (a float64 array that is not a tensor
    comes in as float32, as ``jnp.asarray`` gives it)."""

    def __init__(self, value):
        self.value = _as_value(value)


def _as_value(value) -> torch.Tensor:
    """``value`` as a detached tensor; a float64 array or number that is
    not a tensor becomes float32 (the JAX package's 64-bit mode is
    off)."""
    if isinstance(value, torch.Tensor):
        return value.detach()
    t = torch.as_tensor(value)
    return t.float() if t.dtype == torch.float64 else t


def _set_parameter(module: nn.Module, name: str, value) -> None:
    """Give parameter ``name`` of ``module`` the value ``value``: copied
    into the existing ``nn.Parameter`` (its dtype and device kept, so
    optimizer and Trainer references stay valid) when the shapes agree,
    else a new ``nn.Parameter`` on its device and of its dtype."""
    old = module._parameters[name]
    value = _as_value(value)
    with torch.no_grad():
        if old is not None and old.shape == value.shape:
            old.copy_(value)
            return
        if old is not None:
            value = value.to(device=old.device, dtype=old.dtype)
        module._parameters[name] = nn.Parameter(
            value.clone(), requires_grad=True if old is None
            else old.requires_grad)


def _named_sublayers(module: nn.Module, prefix: str = ""):
    for name, sub in module._modules.items():
        if sub is None:
            continue
        path = f"{prefix}{name}"
        yield path, sub
        yield from _named_sublayers(sub, f"{path}.")


def _sub_flat(flat: Dict[str, Any], name: str) -> Dict[str, Any]:
    prefix = f"{name}."
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


def _set_parameters(module: nn.Module, flat: Dict[str, Any]) -> None:
    for k, v in flat.items():
        if "." not in k:
            enforce(k in module._parameters, "unknown parameter %s on %s",
                    k, type(module).__name__)
            _set_parameter(module, k, v)
    for name, sub in module._modules.items():
        subflat = _sub_flat(flat, name)
        if subflat and sub is not None:
            _set_parameters(sub, subflat)


def _set_buffers(module: nn.Module, flat: Dict[str, Any]) -> None:
    for k, v in flat.items():
        if "." not in k:
            old = module._buffers.get(k)
            home = old.device if old is not None else _home(module)
            module._buffers[k] = _as_value(v).to(home)
    for name, sub in module._modules.items():
        subflat = _sub_flat(flat, name)
        if subflat and sub is not None:
            _set_buffers(sub, subflat)


class _LayerState:
    """The JAX package's Paddle-style state methods, shared by
    :class:`Layer`, :class:`LayerList` and :class:`Sequential` (each a
    ``torch.nn.Module``)."""

    def __setattr__(self, name: str, value: Any) -> None:
        if isinstance(value, Parameter):
            super().__setattr__(name, nn.Parameter(value.value))
            return
        params = self.__dict__.get("_parameters")
        if (params is not None and name in params and value is not None
                and not isinstance(value, nn.Parameter)):
            # re-assigning an existing parameter updates it
            _set_parameter(self, name, value)
            return
        super().__setattr__(name, value)

    def update_buffer(self, name: str, value) -> None:
        """Record a new value of buffer ``name`` (BN running stats), kept
        as given."""
        enforce(name in self._buffers, "unknown buffer %s", name)
        self._buffers[name] = value

    def add_sublayer(self, name: str, layer: nn.Module) -> nn.Module:
        self.add_module(name, layer)
        return layer

    def named_sublayers(self, prefix: str = ""):
        """(dotted path, sublayer) in pre-order, the layer itself left
        out."""
        return _named_sublayers(self, prefix)

    def sublayers(self) -> List[nn.Module]:
        return [l for _, l in self.named_sublayers()]

    def set_parameters(self, flat: Dict[str, Any]) -> None:
        """Set parameters by dotted name. An unknown name of this layer's
        own raises; a dotted name under no existing sublayer is
        skipped."""
        _set_parameters(self, flat)

    def set_buffers(self, flat: Dict[str, Any]) -> None:
        """Set (or add) buffers by dotted name; never raises."""
        _set_buffers(self, flat)


class Layer(_LayerState, nn.Module):
    """Base class for all network modules of the port. ``name_scope`` is
    accepted for the JAX package's signature, which stores nothing of it
    either."""

    def __init__(self, name_scope: Optional[str] = None):
        super().__init__()

    def create_parameter(self, name: str, shape, dtype=None,
                         initializer: Optional[Callable] = None,
                         is_bias: bool = False, *,
                         device: DeviceLike = None,
                         generator: Optional[torch.Generator] = None):
        """Create, initialise and register parameter ``name``
        (LayerHelper.create_parameter analog). One key is drawn off the
        global stream in any case; with no ``generator`` the values come
        from a generator seeded from ``key_for("<Class>.<name>", key)``,
        the JAX package's key for them (the two frameworks draw
        different numbers from it: only the distribution matches)."""
        from ..initializer import Constant, XavierUniform

        dtype = to_dtype(dtype) if dtype is not None else default_dtype()
        if initializer is None:
            initializer = Constant(0.0) if is_bias else XavierUniform()
        device = resolve_device(device)
        key = next_key()
        if generator is None:
            generator = seed_generator(torch.Generator(device=device),
                                       key_for(f"{type(self).__name__}."
                                               f"{name}", key))
        value = initializer(tuple(shape), dtype, device, generator)
        param = nn.Parameter(value)
        self.register_parameter(name, param)
        return param

    # --- rng ----------------------------------------------------------------

    def rng(self, tag: str = "default"):
        """Fresh key data for this layer during a functional call (the
        call's key folded with a per-call count, then with ``tag``'s
        crc32, as in the JAX package); outside one, the next key of the
        global stream."""
        ctx = _RNG_STACK[-1] if _RNG_STACK else None
        if ctx is None:
            return next_key()
        ctx["count"] += 1
        return fold_in(fold_in(ctx["key"], ctx["count"]), _stable_hash(tag))

    # --- functional entry points --------------------------------------------

    def functional_call(self, params: Dict[str, Any], *args,
                        buffers: Optional[Dict[str, Any]] = None,
                        rng=None, training: Optional[bool] = None,
                        method: str = "forward", **kwargs):
        """Run ``method`` (default forward) with ``params`` (and
        ``buffers``) in place of the layer's own, by dotted name; returns
        ``(output, new_buffers)``. Buffers run on copies, so a training
        BatchNorm's running update lands in ``new_buffers`` and neither
        the caller's tensors nor the layer's change; gradients flow to
        the ``params`` tensors. ``rng`` (key data) keys ``Layer.rng``
        and seeds the generator dropout draws from inside the call;
        ``training`` sets the mode for the call only. The layer's own
        parameter objects, buffers and modes are back in place after."""
        with _bound(self, params, buffers), _modes(self, training):
            ctx = {"key": rng if rng is not None else make_key(0),
                   "count": 0}
            _RNG_STACK.append(ctx)
            try:
                if rng is None:
                    out = getattr(self, method)(*args, **kwargs)
                else:
                    gen = seed_generator(torch.Generator(
                        device=_home(self)), rng)
                    with rng_scope(gen):
                        out = getattr(self, method)(*args, **kwargs)
            finally:
                _RNG_STACK.pop()
            new_buffers = dict(self.named_buffers())
        return out, new_buffers

    def apply_fn(self) -> Callable:
        """``f(params, *args, **kwargs) -> output``: functional_call
        without the buffers, for loss closures over buffer-free
        models."""

        def f(params, *args, **kwargs):
            out, _ = self.functional_call(params, *args, **kwargs)
            return out

        return f


_RNG_STACK: List[Dict[str, Any]] = []


def _stable_hash(s: str) -> int:
    return zlib.crc32(s.encode()) & 0x7FFFFFFF


def _home(module: nn.Module) -> torch.device:
    """The device of the module's first parameter or buffer (the CPU for
    a module with neither)."""
    for t in itertools.chain(module.parameters(), module.buffers()):
        return t.device
    return torch.device("cpu")


def _slot(module: nn.Module, name: str, kind: str):
    """(owner module, attribute) of the dotted ``name``, which must be a
    registered parameter or buffer (``kind``)."""
    path, _, attr = name.rpartition(".")
    try:
        owner = module.get_submodule(path) if path else module
    except AttributeError:
        owner = None
    table = getattr(owner, f"_{kind}s", {})
    enforce(attr in table, "unknown %s %s on %s", kind, name,
            type(module).__name__)
    return owner, attr


@contextlib.contextmanager
def _bound(module: nn.Module, params, buffers):
    """Put ``params`` (a dict by dotted name) in the module's slots for
    the block, and copies of ``buffers`` and of its other buffers
    (layers update running statistics in place); the original objects
    go back after."""
    saved = []
    try:
        for kind, flat in (("parameter", params), ("buffer", buffers)):
            for name, value in (flat or {}).items():
                owner, attr = _slot(module, name, kind)
                table = getattr(owner, f"_{kind}s")
                saved.append((table, attr, table[attr]))
                if kind == "buffer":
                    value = value.detach().clone()
                table[attr] = value
        for name, b in list(module.named_buffers()):
            if name not in (buffers or {}):
                owner, attr = _slot(module, name, "buffer")
                saved.append((owner._buffers, attr, b))
                owner._buffers[attr] = b.detach().clone()
        yield
    finally:
        for table, attr, value in reversed(saved):
            table[attr] = value


@contextlib.contextmanager
def _modes(module: nn.Module, training: Optional[bool]):
    """Set every submodule's training mode for the block (when
    ``training`` is given) and restore each one's own after."""
    saved = [(m, m.training) for m in module.modules()]
    try:
        if training is not None:
            module.train(training)
        yield
    finally:
        for m, mode in saved:
            m.training = mode


@contextlib.contextmanager
def inject_state(*bindings):
    """Bind ``(model, params[, buffers])`` tuples for the block: the
    multi-model sibling of ``Layer.functional_call`` (a speculative
    decoder's target and draft, a pipeline of bound methods). Tensors
    are put in the models' slots by dotted name (gradients flow to
    them; buffers run on copies, so neither the caller's nor the
    models' change), and the models' original ``nn.Parameter`` and
    buffer objects are put back on exit, so a Trainer's or an optimizer
    state's references stay valid."""
    with contextlib.ExitStack() as stack:
        for b in bindings:
            stack.enter_context(_bound(b[0], b[1],
                                       b[2] if len(b) > 2 else None))
        yield


def stacked_parameters(layers) -> Dict[str, torch.Tensor]:
    """Stack the parameters of structurally identical layers along a new
    leading axis (the uniform-block idiom of scan-over-layers encoders
    and the GPipe pipeline); enforces matching parameter names."""
    per = [dict(l.named_parameters()) for l in layers]
    enforce(per, "stacked_parameters needs at least one layer")
    names = sorted(per[0])
    for i, p in enumerate(per[1:], 1):
        enforce(sorted(p) == names,
                "layer %s is not structurally identical to layer 0 "
                "(params %s vs %s)", i, sorted(p), names)
    return {k: torch.stack([p[k] for p in per]) for k in names}


def use(t):
    """``t`` whole: all-gathered at use when it is a sharding plan's
    placed shard (parallel/sharding.py; the backward gives the rank its
    shard's gradient), else ``t`` itself."""
    sh = getattr(t, "_pt_sharding", None)
    if sh is None:
        return t
    from ..parallel.collective import gather_at_use

    return gather_at_use(t, sh)


def weight_placed(layer) -> bool:
    """Whether ``layer``'s ``weight`` is a sharding plan's placed shard
    (False for a layer without one: a W8A16 or int8 swap's)."""
    return getattr(getattr(layer, "weight", None), "_pt_sharding",
                   None) is not None


def detach_buffers(module: nn.Module) -> None:
    """Replace each buffer of ``module`` that carries an autograd graph
    (a SwitchFFN's aux terms recorded in a training forward, nn/moe.py)
    by its detached value, so that no graph outlives the step."""
    for m in module.modules():
        for name, b in m._buffers.items():
            if b is not None and b.requires_grad:
                m._buffers[name] = b.detach()


class LayerList(_LayerState, nn.ModuleList):
    """reference: dygraph LayerList — children named "0", "1", ..."""

    def __init__(self, layers=()):
        super().__init__(layers)


class Sequential(_LayerState, nn.Sequential):
    """reference: dygraph Sequential — children named "0", "1", ..., so
    parameter names match the JAX package's."""


def remat_call(fn: Callable, *args, remat_policy: Optional[str] = None,
               **kwargs):
    """``fn(*args, **kwargs)`` under ``torch.utils.checkpoint`` (the JAX
    package's ``jax.checkpoint`` per block): its activations are dropped
    after the forward and recomputed in the backward. ``remat_policy``:
    None recomputes everything; ``"dots"`` keeps the outputs of the
    matrix products without batch dims (the Linears' ``mm``/``addmm``,
    the JAX package's ``dots_with_no_batch_dims_saveable``) and
    recomputes the rest. The recompute runs
    inside ``backward()``, after the caller's scopes have closed, so it
    re-enters the mixed-precision policy and the :func:`rng_scope` the
    forward ran under (``jax.checkpoint`` traces it under them). It also
    replays the current generator from its state before the forward, so
    the recompute draws the forward's dropout masks again:
    ``torch.utils.checkpoint``'s ``preserve_rng_state`` saves the
    default generators, not an explicit ``torch.Generator``, and without
    the replay the recompute would drop other entries and give wrong
    gradients without an error. The generator is left where the backward
    found it."""
    import functools

    from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                        create_selective_checkpoint_contexts)

    enforce(remat_policy in (None, "dots"),
            "remat_policy must be None or 'dots', got %r", remat_policy)
    ckpt_kw = {}
    if remat_policy == "dots":
        saved = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

        def keep_dots(ctx, op, *a, **kw):
            return (CheckpointPolicy.MUST_SAVE if op in saved
                    else CheckpointPolicy.PREFER_RECOMPUTE)

        ckpt_kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, keep_dots)
    policy, gen = get_policy(), current_generator()
    state = gen.get_state() if gen is not None else None
    calls = []

    def run(*a, **kw):
        replay = gen is not None and bool(calls)
        calls.append(None)
        with policy_scope(policy), rng_scope(gen):
            if not replay:
                return fn(*a, **kw)
            now = gen.get_state()
            gen.set_state(state)
            try:
                return fn(*a, **kw)
            finally:
                gen.set_state(now)

    return checkpoint(run, *args, use_reentrant=False, **ckpt_kw, **kwargs)
