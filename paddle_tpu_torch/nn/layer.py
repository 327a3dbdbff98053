"""Layer: the module system (counterpart of paddle_tpu/nn/layer.py).

The JAX package's Layer is a mutable container whose compiled entry
points are functional. Here it is a ``torch.nn.Module``: PyTorch runs
eagerly, so nothing has to be injected. What carries over is the naming
— parameters are registered under the same dotted paths
(``blocks.0.self_attn.q_proj.weight``) and layouts, so a state moves
between the packages by name (utils/convert.py).

Every layer takes an explicit ``device=`` (the CUDA card when None; see
core/places.py) and ``generator=`` (a ``torch.Generator`` on that device,
for its initial draws)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..core.dtypes import default_dtype, get_policy, policy_scope, to_dtype
from ..core.enforce import enforce
from ..core.places import DeviceLike, resolve_device
from ..core.random import current_generator, rng_scope


class Layer(nn.Module):
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
        (LayerHelper.create_parameter analog)."""
        from ..initializer import Constant, XavierUniform

        dtype = to_dtype(dtype) if dtype is not None else default_dtype()
        if initializer is None:
            initializer = Constant(0.0) if is_bias else XavierUniform()
        value = initializer(tuple(shape), dtype, resolve_device(device),
                            generator)
        param = nn.Parameter(value)
        self.register_parameter(name, param)
        return param


class LayerList(nn.ModuleList):
    """reference: dygraph LayerList — children named "0", "1", ..."""

    def __init__(self, layers=()):
        super().__init__(layers)


class Sequential(nn.Sequential):
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
