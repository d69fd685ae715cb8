"""Exponential moving average of the model's parameters, in fp32.

Counterpart of the EMA update inside ``open_muse_tpu/training/trainer.py``
``make_uvit_train_step`` and of its ``_ema_decay``: the shadow moves toward
the parameters *after* the optimizer update, with the decay taken at the
step count *before* it is incremented.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

__all__ = ["ema_decay", "EMA"]


def ema_decay(step: int, decay: float = 0.9999, update_after_step: int = 0,
              use_ema_warmup: bool = False, inv_gamma: float = 1.0, power: float = 2 / 3,
              min_decay: float = 0.0) -> float:
    s = max(0, step - update_after_step - 1)
    if s <= 0:
        cur = 0.0
    elif use_ema_warmup:
        cur = 1 - (1 + s / inv_gamma) ** -power
    else:
        cur = (1 + s) / (10 + s)
    return min(max(cur, min_decay), decay)


class EMA:
    """fp32 shadow of every parameter of ``model``: ``update(model, step)``
    sets ``shadow <- shadow - (1 - decay) * (shadow - param)``."""

    def __init__(self, model: nn.Module, decay: float = 0.9999):
        self.decay = decay
        self.shadow: Dict[str, torch.Tensor] = {
            name: p.detach().float().clone() for name, p in model.named_parameters()}

    @torch.no_grad()
    def update(self, model: nn.Module, step: int) -> None:
        d = ema_decay(step, decay=self.decay)
        params = dict(model.named_parameters())
        names = list(self.shadow)
        torch._foreach_lerp_([self.shadow[n] for n in names],
                             [params[n].detach().float() for n in names], 1.0 - d)

    def state_dict(self) -> dict:
        return {"decay": self.decay, "shadow": self.shadow}

    def load_state_dict(self, state: dict) -> None:
        self.decay = state["decay"]
        for name, value in state["shadow"].items():
            self.shadow[name].copy_(value)
