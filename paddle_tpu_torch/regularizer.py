"""Weight regularization (counterpart of paddle_tpu/regularizer.py):
L2Decay and L1Decay add their decay term to the gradients, pluggable
into ``Optimizer(regularization=...)``. Trees are tensors or dicts,
lists and tuples of them (clip.tree_map)."""

from __future__ import annotations

import torch

from .clip import tree_leaves, tree_map


class L2Decay:
    def __init__(self, coeff: float):
        self.coeff = coeff

    def apply_to_grads(self, params, grads):
        return tree_map(lambda p, g: g + self.coeff * p, params, grads)

    def loss_term(self, params):
        return 0.5 * self.coeff * sum(torch.sum(torch.square(p))
                                      for p in tree_leaves(params))


class L1Decay:
    def __init__(self, coeff: float):
        self.coeff = coeff

    def apply_to_grads(self, params, grads):
        return tree_map(lambda p, g: g + self.coeff * torch.sign(p), params,
                        grads)

    def loss_term(self, params):
        return self.coeff * sum(torch.sum(torch.abs(p))
                                for p in tree_leaves(params))


L1DecayRegularizer = L1Decay
L2DecayRegularizer = L2Decay
