"""Pruning — masks, sensitivity analysis, ratio search, structural
shrink (counterpart of paddle_tpu/slim/prune.py; reference:
python/paddle/fluid/contrib/slim/prune/ — prune_strategy.py magnitude,
uniform and sensitive pruning, pruner.py structured pruning that follows
related params through the graph).

The rules are the JAX package's, to the tie: a mask keeps every entry
(or channel) at or above the k-th largest magnitude (L1 norm), with
``k = max(round(n * (1 - ratio)), 1)`` and Python's round (half to
even), so ties at the threshold are all kept. ``axis`` is an axis of the
JAX layout (Linear weights ``(in, out)``: ``axis=1`` selects output
channels). Dict order decides ties in the ratio search, as there."""

from __future__ import annotations

import json
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..core.enforce import enforce


def magnitude_mask(param, ratio: float) -> torch.Tensor:
    """0/1 mask keeping the largest-|w| (1-ratio) fraction (reference:
    prune_strategy magnitude pruning)."""
    enforce(0.0 <= ratio < 1.0, "prune ratio must be in [0,1), got %s",
            ratio)
    flat = torch.abs(param.reshape(-1))
    k = max(int(round(flat.numel() * (1.0 - ratio))), 1)
    thresh = torch.topk(flat, k).values[-1]
    return (torch.abs(param) >= thresh).to(param.dtype)


def structured_channel_mask(param, ratio: float, axis: int = 0):
    """Channel (filter) pruning: zero whole channels along ``axis`` with
    the smallest L1 norms (reference: slim filter pruning)."""
    reduce_axes = tuple(i for i in range(param.ndim) if i != axis)
    norms = torch.sum(torch.abs(param), dim=reduce_axes)
    k = max(int(round(norms.numel() * (1.0 - ratio))), 1)
    thresh = torch.topk(norms, k).values[-1]
    keep = (norms >= thresh).to(param.dtype)
    shape = [1] * param.ndim
    shape[axis] = param.shape[axis]
    return keep.reshape(shape).expand(param.shape).clone()


class Pruner:
    """Magnitude pruner over a params dict. ``make_masks`` selects by
    per-param ratio (dict of path→ratio or one global ratio; params not
    matched stay dense). ``apply`` zeroes; reapply after each optimizer
    step (or fold into the train step) to keep sparsity — the
    mask-persist role of the reference's pruning strategy. The default
    ``match`` is ``name.endswith("weight")``, embeddings and 1-D norm
    scales included; a 1-D param gets a magnitude mask even when
    ``structured``."""

    def __init__(self, ratios, structured: bool = False, axis: int = 0,
                 match: Optional[Callable[[str], bool]] = None):
        self.ratios = ratios
        self.structured = structured
        self.axis = axis
        self.match = match or (lambda name: name.endswith("weight"))

    def make_masks(self, params: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        masks = {}
        for name, p in params.items():
            if not self.match(name):
                continue
            ratio = (self.ratios.get(name)
                     if isinstance(self.ratios, dict) else self.ratios)
            if ratio is None or ratio <= 0:
                continue
            if self.structured and p.ndim >= 2:
                masks[name] = structured_channel_mask(p, ratio, self.axis)
            else:
                masks[name] = magnitude_mask(p, ratio)
        return masks

    @staticmethod
    def apply(params: Dict[str, torch.Tensor],
              masks: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {name: p * masks[name] if name in masks else p
                for name, p in params.items()}

    @staticmethod
    def sparsity(params: Dict[str, torch.Tensor],
                 masks: Dict[str, torch.Tensor]) -> float:
        """Fraction of masked-out weights (exact zeros of the masks) over
        the masked params."""
        zeros = total = 0
        for name in masks:
            m = masks[name]
            zeros += float(torch.sum(m == 0))
            total += m.numel()
        return zeros / max(total, 1)


# ---------------------------------------------------------------------------
# Sensitivity analysis + ratio search (reference: prune_strategy.py
# SensitivePruneStrategy._compute_sensitivities:726 — prune one param at a
# time at increasing ratios, measure the eval-metric drop, greedily pick
# per-param ratios for a target; UniformPruneStrategy._get_best_ratios:557
# — search ONE ratio hitting the target)
# ---------------------------------------------------------------------------


def compute_sensitivities(params: Dict[str, torch.Tensor],
                          eval_fn: Callable[[Dict[str, torch.Tensor]],
                                            float],
                          pruner: "Pruner",
                          ratios: Sequence[float] = (0.1, 0.2, 0.3, 0.4,
                                                     0.5, 0.6, 0.7),
                          sensitivities_file: Optional[str] = None
                          ) -> Dict[str, Dict[float, float]]:
    """{param -> {ratio -> metric loss}}: prune ONE param at each ratio,
    re-evaluate, record ``base_metric - metric`` (higher = more
    sensitive). Resumes from ``sensitivities_file`` when given (the
    reference persists between runs the same way): its entries come
    first, in the file's order, then new names in params order. The file
    is the JAX package's (JSON, ratios as string keys, sorted)."""
    sens: Dict[str, Dict[float, float]] = {}
    if sensitivities_file:
        try:
            with open(sensitivities_file) as f:
                sens = {k: {float(r): v for r, v in d.items()}
                        for k, d in json.load(f).items()
                        if k in params}  # stale entries (renamed layers,
                #                          shared files) are dropped
        except (OSError, ValueError):
            sens = {}
    base = float(eval_fn(params))
    for name, p in params.items():
        if not pruner.match(name):
            continue
        done = sens.setdefault(name, {})
        for ratio in ratios:
            if ratio in done:
                continue
            if pruner.structured and p.ndim >= 2:
                mask = structured_channel_mask(p, ratio, pruner.axis)
            else:
                mask = magnitude_mask(p, ratio)
            pruned = dict(params)
            pruned[name] = p * mask
            done[ratio] = base - float(eval_fn(pruned))
        if sensitivities_file:
            from ..utils.atomic import atomic_write_text

            atomic_write_text(sensitivities_file,
                              json.dumps(sens, indent=1, sort_keys=True))
    return sens


def greedy_ratios_for_target(sensitivities: Dict[str, Dict[float, float]],
                             params: Dict[str, torch.Tensor],
                             target_ratio: float,
                             max_metric_loss: Optional[float] = None
                             ) -> Dict[str, float]:
    """Pick per-param ratios reaching a GLOBAL sparsity ``target_ratio``
    while spending metric loss where it is cheapest: repeatedly take the
    single ratio upgrade with the best (extra zeros / extra metric loss)
    trade until the target is met (the greedy core of the reference's
    SensitivePruneStrategy._get_best_ratios); the first best in
    ``sensitivities``' order wins a tie."""
    unknown = sorted(set(sensitivities) - set(params))
    enforce(not unknown,
            "sensitivities contain params absent from the model: %s "
            "(stale sensitivities file?)", unknown)
    sizes = {n: int(params[n].numel()) for n in sensitivities}
    total = sum(sizes.values())
    enforce(total > 0, "no prunable params matched")
    chosen: Dict[str, float] = {n: 0.0 for n in sensitivities}

    def zeros():
        return sum(sizes[n] * chosen[n] for n in chosen)

    while zeros() < target_ratio * total:
        best, best_gain = None, -float("inf")
        for n, table in sensitivities.items():
            ups = sorted(r for r in table if r > chosen[n])
            if not ups:
                continue
            r = ups[0]
            extra = sizes[n] * (r - chosen[n])
            cost = max(table[r] - sensitivities[n].get(chosen[n], 0.0),
                       1e-9)
            if max_metric_loss is not None and table[r] > max_metric_loss:
                continue
            gain = extra / cost
            if gain > best_gain:
                best, best_gain = (n, r), gain
        if best is None:
            break  # no upgrade available under the loss cap
        chosen[best[0]] = best[1]
    return {n: r for n, r in chosen.items() if r > 0}


def uniform_ratio_search(params: Dict[str, torch.Tensor], pruner: "Pruner",
                         target_ratio: float, tol: float = 0.005,
                         iters: int = 20) -> float:
    """Binary-search ONE ratio whose masks reach a global ``target_ratio``
    sparsity over the matched params (reference:
    UniformPruneStrategy._get_best_ratios — it also bisects)."""
    lo, hi = 0.0, 0.999
    ratio = target_ratio
    for _ in range(iters):
        ratio = (lo + hi) / 2
        trial = Pruner(ratio, structured=pruner.structured,
                       axis=pruner.axis, match=pruner.match)
        masks = trial.make_masks(params)
        enforce(masks, "no prunable params matched")
        got = Pruner.sparsity(params, masks)
        if abs(got - target_ratio) <= tol:
            break
        if got < target_ratio:
            lo = ratio
        else:
            hi = ratio
    return ratio


# ---------------------------------------------------------------------------
# Structural shrink (reference: prune/pruner.py StructurePruner +
# prune_strategy.py _prune_parameters:404 — physically remove channels and
# follow every related param: the consumer weight's input axis, the
# producer's bias, the optimizer accumulators)
# ---------------------------------------------------------------------------


def channel_keep_indices(mask: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Indices of surviving channels in a structured mask (a channel is
    alive where its mask's L1 norm is > 0)."""
    reduce_axes = tuple(i for i in range(mask.ndim) if i != axis)
    alive = torch.sum(torch.abs(mask), dim=reduce_axes) > 0
    return torch.nonzero(alive, as_tuple=True)[0]


def shrink_params(params: Dict[str, torch.Tensor],
                  plan: Sequence[Tuple[str, int, Sequence[Tuple[str, int]]]],
                  ratios
                  ) -> Tuple[Dict[str, torch.Tensor],
                             Dict[str, torch.Tensor]]:
    """Physically remove channels (smaller tensors, real FLOP savings —
    not just zeros). ``plan`` entries: ``(producer_weight, prune_axis,
    followers)`` where followers are ``(param_name, axis)`` pairs sliced
    by the SAME kept indices (the consumer weight's input axis, the
    producer's bias, matching optimizer accumulators...). The structured
    mask is recomputed from the current weights.

    Returns (new params dict with sliced tensors, kept-index map)."""
    out = dict(params)
    kept: Dict[str, torch.Tensor] = {}
    for name, axis, followers in plan:
        enforce(name in out, "unknown param %s in shrink plan", name)
        ratio = ratios.get(name) if isinstance(ratios, dict) else ratios
        enforce(ratio is not None and 0 <= ratio < 1,
                "shrink needs a ratio in [0,1) for %s", name)
        mask = structured_channel_mask(out[name], ratio, axis)
        idx = channel_keep_indices(mask, axis)
        kept[name] = idx
        out[name] = torch.index_select(out[name], axis, idx)
        for fname, faxis in followers:
            enforce(fname in out, "unknown follower %s in shrink plan",
                    fname)
            out[fname] = torch.index_select(out[fname], faxis, idx)
    return out, kept
