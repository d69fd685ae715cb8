"""Seeding and running averages for the trainers.

Counterpart of ``set_seed`` and ``AverageMeter`` in
``open_muse_tpu/utils/training_utils.py``, which imports jax.
"""

from __future__ import annotations

import random

import numpy as np
import torch

__all__ = ["set_seed", "AverageMeter"]


def set_seed(seed: int) -> None:
    """Seed python, numpy and torch (every device)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


class AverageMeter:
    """Running average (reference train_muse.py:229-246)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
