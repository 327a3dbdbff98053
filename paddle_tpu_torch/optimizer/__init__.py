"""Optimizers and learning-rate schedules of the port (counterpart of
paddle_tpu/optimizer)."""

from . import lr_scheduler
from .lr_scheduler import (Constant, CosineDecay, ExponentialDecay,
                           InverseTimeDecay, LinearWarmup, LRSchedule,
                           NaturalExpDecay, NoamDecay, PiecewiseDecay,
                           PolynomialDecay, make_schedule)
from .optimizers import SGD, Adam, AdamW, Optimizer

__all__ = [
    "lr_scheduler", "Constant", "CosineDecay", "ExponentialDecay",
    "InverseTimeDecay", "LinearWarmup", "LRSchedule", "NaturalExpDecay",
    "NoamDecay", "PiecewiseDecay", "PolynomialDecay", "make_schedule",
    "SGD", "Adam", "AdamW", "Optimizer",
]
