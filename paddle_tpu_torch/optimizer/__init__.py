"""Optimizers, learning-rate schedules, the loss scaler and the
row-sparse embedding updates of the port (counterpart of
paddle_tpu/optimizer)."""

from . import lr_scheduler
from .loss_scaler import DynamicLossScaler
from .lr_scheduler import (Constant, CosineDecay, ExponentialDecay,
                           InverseTimeDecay, LinearWarmup, LRSchedule,
                           NaturalExpDecay, NoamDecay, PiecewiseDecay,
                           PolynomialDecay, make_schedule)
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                         DecayedAdagrad, ExponentialMovingAverage, Ftrl,
                         Lamb, LarsMomentum, Momentum, Optimizer,
                         ProximalAdagrad, ProximalGD, RMSProp)
from .sparse import (apply_rows, find_sparse_embeddings, merge_rows,
                     sparse_minimize_fn)

__all__ = [
    "apply_rows", "find_sparse_embeddings", "merge_rows",
    "sparse_minimize_fn",
    "lr_scheduler", "DynamicLossScaler", "Constant", "CosineDecay",
    "ExponentialDecay", "InverseTimeDecay", "LinearWarmup", "LRSchedule",
    "NaturalExpDecay", "NoamDecay", "PiecewiseDecay", "PolynomialDecay",
    "make_schedule", "SGD", "Adadelta", "Adagrad", "Adam", "Adamax",
    "AdamW", "DecayedAdagrad", "ExponentialMovingAverage", "Ftrl", "Lamb",
    "LarsMomentum", "Momentum", "Optimizer", "ProximalAdagrad",
    "ProximalGD", "RMSProp",
]
