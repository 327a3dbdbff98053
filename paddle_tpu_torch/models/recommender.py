"""Recommender system — the book model (counterpart of
paddle_tpu/models/recommender.py; reference:
tests/book/test_recommender_system.py): MovieLens user and movie
features through embeddings and two fusion Linears, rated by 5 times
their cosine similarity.

The defaults are MovieLens-1M's widths (6041 users, 3953 movies, 2
genders, 7 ages, 21 jobs, 19 categories). Parameters are named, laid out
and created in the JAX package's order, so a JAX state loads by name
(utils/convert.py ``load_numpy_state``) and the global random stream
advances as the JAX package's does."""

from __future__ import annotations

from typing import Optional

import torch

from .. import nn
from ..core.places import resolve_device
from ..ops.math import cos_sim


class RecommenderNet(nn.Layer):
    """``forward(user, gender, age, job, item, categories)`` -> the
    predicted ratings (B, 1), in [-5, 5]. ``device``: the CUDA card when
    None; ``generator``: the initial weights' stream (when None, each
    parameter's comes from its key off the global stream)."""

    def __init__(self, num_users: int = 6041, num_items: int = 3953,
                 num_genders: int = 2, num_ages: int = 7,
                 num_jobs: int = 21, num_categories: int = 19,
                 embed_dim: int = 32, fc_dim: int = 200, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.user_emb = nn.Embedding(num_users, embed_dim, **kw)
        self.gender_emb = nn.Embedding(num_genders, 16, **kw)
        self.age_emb = nn.Embedding(num_ages, 16, **kw)
        self.job_emb = nn.Embedding(num_jobs, 16, **kw)
        self.user_fc = nn.Linear(embed_dim + 48, fc_dim, act="tanh", **kw)
        self.item_emb = nn.Embedding(num_items, embed_dim, **kw)
        self.cat_emb = nn.Embedding(num_categories, embed_dim, **kw)
        self.item_fc = nn.Linear(2 * embed_dim, fc_dim, act="tanh", **kw)

    def forward(self, user, gender, age, job, item, categories):
        """``categories``: (B, K) category ids padded with 0, summed over
        K as the reference's sequence_pool sums them (a pad is category
        0 and is summed too, as in the JAX package)."""
        u = torch.cat([self.user_emb(user), self.gender_emb(gender),
                       self.age_emb(age), self.job_emb(job)], dim=-1)
        u = self.user_fc(u)
        cat = torch.sum(self.cat_emb(categories), dim=1)
        i = torch.cat([self.item_emb(item), cat], dim=-1)
        i = self.item_fc(i)
        # the reference scales the cosine similarity to the 5-star range
        return 5.0 * cos_sim(u, i)


def loss_fn(pred, rating):
    """Mean squared error of the flattened predictions."""
    return torch.mean((pred.reshape(-1) - rating) ** 2)
