"""Learning-rate schedules (counterpart of
paddle_tpu/optimizer/lr_scheduler.py, with the same formulas).

A schedule is a callable ``step -> lr``: ``step`` a Python int or an
integer tensor, the result a 0-dim float32 tensor on the CPU, computed
in float32 in the JAX package's order of operations. A 0-dim CPU tensor
scales a CUDA tensor without a copy to the card."""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..core.enforce import enforce


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32, device="cpu")


class LRSchedule:
    def __call__(self, step):
        raise NotImplementedError


class Constant(LRSchedule):
    def __init__(self, value: float):
        self.value = value

    def __call__(self, step):
        return _f32(self.value)


class NoamDecay(LRSchedule):
    """reference: learning_rate_scheduler.py noam_decay."""

    def __init__(self, d_model: int, warmup_steps: int, scale: float = 1.0):
        self.d_model, self.warmup_steps, self.scale = (d_model, warmup_steps,
                                                       scale)

    def __call__(self, step):
        step = torch.clamp(_f32(step), min=1.0)
        a = step ** -0.5
        b = step * (self.warmup_steps ** -1.5)
        return self.scale * (self.d_model ** -0.5) * torch.minimum(a, b)


class ExponentialDecay(LRSchedule):
    def __init__(self, learning_rate: float, decay_steps: int,
                 decay_rate: float, staircase: bool = False):
        self.lr, self.steps, self.rate, self.staircase = (
            learning_rate, decay_steps, decay_rate, staircase)

    def __call__(self, step):
        exp = _f32(step) / self.steps
        if self.staircase:
            exp = torch.floor(exp)
        return self.lr * torch.pow(_f32(self.rate), exp)


class NaturalExpDecay(LRSchedule):
    def __init__(self, learning_rate: float, decay_steps: int,
                 decay_rate: float, staircase: bool = False):
        self.lr, self.steps, self.rate, self.staircase = (
            learning_rate, decay_steps, decay_rate, staircase)

    def __call__(self, step):
        exp = _f32(step) / self.steps
        if self.staircase:
            exp = torch.floor(exp)
        return self.lr * torch.exp(-self.rate * exp)


class InverseTimeDecay(LRSchedule):
    def __init__(self, learning_rate: float, decay_steps: int,
                 decay_rate: float, staircase: bool = False):
        self.lr, self.steps, self.rate, self.staircase = (
            learning_rate, decay_steps, decay_rate, staircase)

    def __call__(self, step):
        t = _f32(step) / self.steps
        if self.staircase:
            t = torch.floor(t)
        return self.lr / (1.0 + self.rate * t)


class PolynomialDecay(LRSchedule):
    def __init__(self, learning_rate: float, decay_steps: int,
                 end_learning_rate: float = 1e-4, power: float = 1.0,
                 cycle: bool = False):
        self.lr, self.steps = learning_rate, decay_steps
        self.end_lr, self.power, self.cycle = end_learning_rate, power, cycle

    def __call__(self, step):
        s = _f32(step)
        if self.cycle:
            mult = torch.ceil(torch.clamp(s, min=1.0) / self.steps)
            steps = self.steps * torch.clamp(mult, min=1.0)
        else:
            steps = self.steps
            s = torch.clamp(s, max=float(steps))
        frac = (1.0 - s / steps) ** self.power
        return (self.lr - self.end_lr) * frac + self.end_lr


class PiecewiseDecay(LRSchedule):
    """reference: piecewise_decay(boundaries, values)."""

    def __init__(self, boundaries: Sequence[int], values: Sequence[float]):
        enforce(len(values) == len(boundaries) + 1,
                "piecewise decay needs len(boundaries) + 1 values, got %s "
                "and %s", len(boundaries), len(values))
        self.boundaries = list(boundaries)
        self.values = list(values)

    def __call__(self, step):
        idx = int((torch.as_tensor(step) >= torch.as_tensor(
            self.boundaries)).sum())
        return _f32(self.values)[idx]


class CosineDecay(LRSchedule):
    """reference: cosine_decay(lr, step_each_epoch, epochs)."""

    def __init__(self, learning_rate: float, step_each_epoch: int,
                 epochs: int):
        self.lr, self.step_each_epoch, self.epochs = (
            learning_rate, step_each_epoch, epochs)

    def __call__(self, step):
        epoch = torch.floor(_f32(step) / self.step_each_epoch)
        return self.lr * 0.5 * (torch.cos(epoch * math.pi / self.epochs)
                                + 1.0)


class LinearWarmup(LRSchedule):
    """reference: linear_lr_warmup — wraps another schedule (or a
    constant)."""

    def __init__(self, learning_rate, warmup_steps: int, start_lr: float,
                 end_lr: float):
        self.base = (learning_rate if isinstance(learning_rate, LRSchedule)
                     else Constant(learning_rate))
        self.warmup_steps, self.start_lr, self.end_lr = (
            warmup_steps, start_lr, end_lr)

    def __call__(self, step):
        s = _f32(step)
        warm = self.start_lr + (self.end_lr - self.start_lr) * (
            s / self.warmup_steps)
        return torch.where(s < self.warmup_steps, warm, self.base(step))


def make_schedule(lr) -> LRSchedule:
    if isinstance(lr, LRSchedule):
        return lr
    return Constant(float(lr))
