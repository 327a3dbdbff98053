"""The in-place Linear rewrite (counterpart of paddle_tpu/nn/rewrite.py):
one walk of a layer tree that replaces matching Linear sublayers, which
``quant.apply_weight_only_int8`` wraps. Sublayers are the
``torch.nn.Module`` children (``_modules``); a replacement is re-bound
with ``setattr``, which registers it under the same name, so parameter
and buffer paths keep their prefixes."""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from torch import nn as tnn

from ..core.enforce import enforce
from .layers import Linear


def rewrite_linears(model: tnn.Module, make: Callable[[Linear], tnn.Module],
                    targets: Optional[Sequence[str]] = None,
                    predicate: Optional[
                        Callable[[str, tnn.Module], bool]] = None,
                    skip: Optional[Callable[[tnn.Module], bool]] = None,
                    what: str = "rewrite_linears") -> List[str]:
    """Replace matching Linear sublayers of ``model`` with
    ``make(linear)`` in place; returns the rewritten paths.
    ``targets``: attribute-name suffixes (None = every Linear);
    ``predicate(path, layer)`` filters further; ``skip(layer)`` guards
    against wrapping twice (e.g. an already-wrapped type)."""
    done: List[str] = []

    def walk(layer: tnn.Module, prefix: str):
        for name, sub in list(layer._modules.items()):
            if sub is None:
                continue
            path = f"{prefix}{name}"
            if skip is not None and skip(sub):
                continue
            if (isinstance(sub, Linear)
                    and (targets is None
                         or any(name == t or name.endswith(t)
                                for t in targets))
                    and (predicate is None or predicate(path, sub))):
                setattr(layer, name, make(sub))
                done.append(path)
            else:
                walk(sub, f"{path}.")

    enforce(not isinstance(model, Linear),
            "%s rewrites sublayers; wrap a bare Linear directly", what)
    walk(model, "")
    enforce(done, "%s matched no Linear sublayers (targets=%s)", what,
            targets)
    return done
