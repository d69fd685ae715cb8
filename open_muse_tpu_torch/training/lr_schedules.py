"""Learning-rate schedules: each is a plain function of the update count.

Counterpart of ``open_muse_tpu/training/lr_schedules.py`` (the reference's
``get_scheduler`` registry).  As with optax, the optimizer evaluates the
schedule at the count of updates made *before* the current one, so
``constant_with_warmup`` gives a first update of lr 0.
"""

from __future__ import annotations

import math
from enum import Enum
from typing import Optional

__all__ = ["SchedulerType", "get_scheduler"]


class SchedulerType(Enum):
    LINEAR = "linear"
    COSINE = "cosine"
    COSINE_WITH_RESTARTS = "cosine_with_restarts"
    POLYNOMIAL = "polynomial"
    CONSTANT = "constant"
    CONSTANT_WITH_WARMUP = "constant_with_warmup"


def _clip(v, lo=0.0, hi=1.0):
    return min(max(v, lo), hi)


def get_constant_schedule(base_lr: float):
    return lambda step: float(base_lr)


def get_constant_schedule_with_warmup(base_lr: float, num_warmup_steps: int):
    return lambda step: base_lr * min(step / max(1.0, num_warmup_steps), 1.0)


def get_linear_schedule_with_warmup(base_lr, num_warmup_steps, num_training_steps):
    def fn(step):
        if step < num_warmup_steps:
            return base_lr * _clip(step / max(1, num_warmup_steps))
        return base_lr * _clip((num_training_steps - step)
                               / max(1, num_training_steps - num_warmup_steps))

    return fn


def get_cosine_schedule_with_warmup(base_lr, num_warmup_steps, num_training_steps,
                                    num_cycles: float = 0.5):
    def fn(step):
        if step < num_warmup_steps:
            return base_lr * _clip(step / max(1, num_warmup_steps))
        progress = (step - num_warmup_steps) / max(1, num_training_steps - num_warmup_steps)
        return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)))

    return fn


def get_cosine_with_hard_restarts_schedule_with_warmup(base_lr, num_warmup_steps,
                                                       num_training_steps,
                                                       num_cycles: int = 1):
    def fn(step):
        if step < num_warmup_steps:
            return base_lr * _clip(step / max(1, num_warmup_steps))
        progress = (step - num_warmup_steps) / max(1, num_training_steps - num_warmup_steps)
        if progress >= 1.0:
            return 0.0
        return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * ((num_cycles * progress) % 1.0))))

    return fn


def get_polynomial_decay_schedule_with_warmup(base_lr, num_warmup_steps,
                                              num_training_steps, lr_end=1e-7,
                                              power=1.0):
    if not (base_lr > lr_end):
        raise ValueError(f"lr_end ({lr_end}) must be smaller than initial lr ({base_lr})")

    def fn(step):
        if step < num_warmup_steps:
            return base_lr * _clip(step / max(1, num_warmup_steps))
        if step > num_training_steps:
            return lr_end
        pct = 1 - (step - num_warmup_steps) / (num_training_steps - num_warmup_steps)
        return (base_lr - lr_end) * pct ** power + lr_end

    return fn


TYPE_TO_SCHEDULER_FUNCTION = {
    SchedulerType.LINEAR: get_linear_schedule_with_warmup,
    SchedulerType.COSINE: get_cosine_schedule_with_warmup,
    SchedulerType.COSINE_WITH_RESTARTS: get_cosine_with_hard_restarts_schedule_with_warmup,
    SchedulerType.POLYNOMIAL: get_polynomial_decay_schedule_with_warmup,
    SchedulerType.CONSTANT: get_constant_schedule,
    SchedulerType.CONSTANT_WITH_WARMUP: get_constant_schedule_with_warmup,
}


def get_scheduler(name, base_lr: float, num_warmup_steps: Optional[int] = None,
                  num_training_steps: Optional[int] = None, **kwargs):
    """Registry mirroring the JAX ``get_scheduler``: step -> lr."""
    name = SchedulerType(name)
    if name == SchedulerType.CONSTANT:
        return get_constant_schedule(base_lr)
    if num_warmup_steps is None:
        raise ValueError(f"{name} requires `num_warmup_steps`")
    if name == SchedulerType.CONSTANT_WITH_WARMUP:
        return get_constant_schedule_with_warmup(base_lr, num_warmup_steps)
    if num_training_steps is None:
        raise ValueError(f"{name} requires `num_training_steps`")
    return TYPE_TO_SCHEDULER_FUNCTION[name](base_lr, num_warmup_steps, num_training_steps,
                                            **kwargs)
