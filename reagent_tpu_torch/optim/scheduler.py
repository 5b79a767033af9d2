"""Learning-rate scheduler configs.

Port of ``reagent_tpu/optim/scheduler.py`` (``StepLR``, ``MultiStepLR``,
``ExponentialLR``, ``LinearLR``, ``CosineAnnealingLR``, ``OneCycleLR``,
``with_scheduler``; reference: reagent/optimizer/scheduler.py).  A schedule
maps the schedule's own update count (an int32 scalar on the device, from
0) to a float32 multiplier.  ``with_scheduler`` chains it after the
optimizer, as ``optax.scale_by_schedule`` does in the JAX package
(:123-132): the multiplier scales the optimizer's whole step, weight decay
included, and the count is carried in ``OptState.schedule_count``, so a
checkpoint holds it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from reagent_tpu_torch.core.registry import Registry
from reagent_tpu_torch.optim.union import OptState, Rule

Tensor = torch.Tensor

LR_SCHEDULERS: Registry = Registry("optim.lr_scheduler")


@dataclasses.dataclass(frozen=True)
class LearningRateSchedulerConfig:
    """Base: ``multiplier(step)`` of the optimizer's base step."""

    def multiplier(self, step: Tensor) -> Tensor:
        raise NotImplementedError


def _f32(step: Tensor) -> Tensor:
    return step.to(torch.float32)


@LR_SCHEDULERS.register()
@dataclasses.dataclass(frozen=True)
class StepLR(LearningRateSchedulerConfig):
    step_size: int = 1000
    gamma: float = 0.1

    def multiplier(self, step: Tensor) -> Tensor:
        return torch.pow(self.gamma, _f32(torch.div(step, self.step_size, rounding_mode="floor")))


@LR_SCHEDULERS.register()
@dataclasses.dataclass(frozen=True)
class MultiStepLR(LearningRateSchedulerConfig):
    milestones: Sequence[int] = ()
    gamma: float = 0.1

    def multiplier(self, step: Tensor) -> Tensor:
        mult = torch.ones((), dtype=torch.float32, device=step.device)
        for m in self.milestones:
            mult = mult * torch.pow(self.gamma, _f32(step >= m))
        return mult


@LR_SCHEDULERS.register()
@dataclasses.dataclass(frozen=True)
class ExponentialLR(LearningRateSchedulerConfig):
    gamma: float = 0.99

    def multiplier(self, step: Tensor) -> Tensor:
        return torch.pow(self.gamma, _f32(step))


@LR_SCHEDULERS.register()
@dataclasses.dataclass(frozen=True)
class LinearLR(LearningRateSchedulerConfig):
    start_factor: float = 1.0 / 3
    end_factor: float = 1.0
    total_iters: int = 5

    def multiplier(self, step: Tensor) -> Tensor:
        t = torch.clamp(_f32(step) / self.total_iters, 0.0, 1.0)
        return self.start_factor + (self.end_factor - self.start_factor) * t


@LR_SCHEDULERS.register()
@dataclasses.dataclass(frozen=True)
class CosineAnnealingLR(LearningRateSchedulerConfig):
    T_max: int = 1000
    eta_min: float = 0.0

    def multiplier(self, step: Tensor) -> Tensor:
        frac = math.pi * _f32(torch.clamp(step, max=self.T_max)) / self.T_max
        return self.eta_min + (1.0 - self.eta_min) * 0.5 * (1 + torch.cos(frac))


@LR_SCHEDULERS.register()
@dataclasses.dataclass(frozen=True)
class OneCycleLR(LearningRateSchedulerConfig):
    """Warm up to ``max_lr_factor`` then cosine down (torch OneCycleLR's
    essentials, as the JAX package's)."""

    max_lr_factor: float = 10.0
    total_steps: int = 1000
    pct_start: float = 0.3

    def multiplier(self, step: Tensor) -> Tensor:
        warm = max(int(self.total_steps * self.pct_start), 1)
        s = _f32(step)
        up = self.max_lr_factor * s / warm
        t = torch.clamp((s - warm) / max(self.total_steps - warm, 1), 0.0, 1.0)
        down = self.max_lr_factor * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warm, up, down)


class ScheduledRule(Rule):
    """An optimizer's step times the schedule's multiplier at its count."""

    def __init__(self, rule: Rule, scheduler: LearningRateSchedulerConfig):
        self.rule = rule
        self.scheduler = scheduler

    def init(self, params) -> OptState:
        state = self.rule.init(params)
        return dataclasses.replace(state, schedule_count=torch.zeros_like(state.count))

    def updates(self, grads, state, params):
        u, new = self.rule.updates(grads, state, params)
        mult = self.scheduler.multiplier(state.schedule_count)
        return ({k: mult * v for k, v in u.items()},
                dataclasses.replace(new, schedule_count=state.schedule_count + 1))


def with_scheduler(optimizer: Rule, scheduler: Optional[LearningRateSchedulerConfig]) -> Rule:
    """The optimizer followed by the schedule's multiplier (reference
    ``make_optimizer_scheduler``); ``None`` leaves it as it is."""
    if scheduler is None:
        return optimizer
    return ScheduledRule(optimizer, scheduler)
