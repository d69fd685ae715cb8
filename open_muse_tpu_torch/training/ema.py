"""Exponential moving average of the model's parameters, in fp32.

Counterpart of the EMA update inside ``open_muse_tpu/training/trainer.py``
``make_uvit_train_step`` and of its ``_ema_decay``: the shadow moves toward
the parameters *after* the optimizer update, with the decay taken at the
step count *before* it is incremented, by the JAX formula ``e - (1 - d) *
(e - p)``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..parallel.tensor_parallel import local

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
    """fp32 shadow of every parameter of ``model``: ``set_step(step)`` writes
    ``ema_decay(step)`` into a 0-d tensor beside the shadow (host work,
    outside any graph) and ``update(model)`` sets ``shadow <- shadow - (1 -
    decay) * (shadow - param)`` on the device alone, so that a CUDA graph
    holding it reads each step's decay."""

    def __init__(self, model: nn.Module, decay: float = 0.9999):
        self.decay = decay
        self.shadow: Dict[str, torch.Tensor] = {
            name: p.detach().float().clone() for name, p in model.named_parameters()}
        self.step_decay = torch.zeros((), dtype=torch.float32,
                                      device=next(iter(self.shadow.values())).device)

    def set_step(self, step: int) -> None:
        self.step_decay.fill_(ema_decay(step, decay=self.decay))

    @torch.no_grad()
    def update(self, model: nn.Module) -> None:
        params = dict(model.named_parameters())
        names = list(self.shadow)
        # a DTensor shard's own elements (the shadow shards like its parameter)
        shadow = [local(self.shadow[n]) for n in names]
        diff = torch._foreach_sub(shadow, [local(params[n].detach()).float() for n in names])
        torch._foreach_mul_(diff, 1 - self.step_decay)
        torch._foreach_sub_(shadow, diff)

    def state_dict(self) -> dict:
        return {"decay": self.decay, "shadow": self.shadow}

    def load_state_dict(self, state: dict) -> None:
        self.decay = state["decay"]
        for name, value in state["shadow"].items():
            self.shadow[name].copy_(value)
