"""AdamW with the JAX package's weight-decay mask, schedule and clipping.

Counterpart of ``open_muse_tpu/training/optimizers.py`` for ``adamw`` and
``fused_adamw`` (one optimizer there: optax's AdamW, which XLA fuses).  The
update is ``torch.optim.AdamW``, whose arithmetic is optax's
``adamw``: bias-corrected moments, ``m / (sqrt(v) + eps)``, decoupled
decay ``lr * wd * p``.  Around it, as optax chains them:

- the schedule is read at the count of updates made before this one;
- ``max_grad_norm`` clips by the global norm first (``clip_by_global_norm``:
  grads are scaled by ``max_norm / norm`` when the norm is not below it);
- weight decay skips a parameter when its *flax* name contains one of
  ``NO_DECAY_SUBSTRINGS`` (``decay_mask_fn``).  The port's norm scales are
  called ``weight``, so the flax name is derived from the owning module.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch
from torch import nn

from ..core.convert import flax_key_candidates

__all__ = ["NO_DECAY_SUBSTRINGS", "flax_param_name", "decay_mask", "Optimizer",
           "get_optimizer", "global_norm"]

NO_DECAY_SUBSTRINGS = ("bias", "scale", "gamma", "beta", "embedding", "gammas",
                       "running_mean", "running_var")


def flax_param_name(model: nn.Module, name: str) -> str:
    """The JAX package's parameter path for the port's parameter ``name``:
    'transformer_layers.0.attn_layer_norm.weight' ->
    'transformer_layers_0.attn_layer_norm.scale'."""
    owner, _, leaf = name.rpartition(".")
    module = model.get_submodule(owner)
    if leaf == "weight":
        if isinstance(module, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            leaf = "kernel"
        elif isinstance(module, nn.Embedding):
            leaf = "embedding"
        else:
            leaf = "scale"
    rename = getattr(model, "_flax_key", lambda key: key)
    return next(c for c in flax_key_candidates(rename(name)) if c.rsplit(".", 1)[-1] == leaf)


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """True where weight decay applies, decided on the flax name as
    ``decay_mask_fn`` does."""
    return {name: not any(s in flax_param_name(model, name).lower()
                          for s in NO_DECAY_SUBSTRINGS)
            for name, _ in model.named_parameters()}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every element (``optax.global_norm``),
    in fp32."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class Optimizer:
    """AdamW driven like an optax chain: ``step(grad_norm)`` clips (when
    ``max_grad_norm`` is set), sets the lr from the schedule at the current
    update count, updates, and counts."""

    def __init__(self, model: nn.Module, schedule: Callable[[int], float], *,
                 beta1: float = 0.9, beta2: float = 0.999, weight_decay: float = 0.01,
                 epsilon: float = 1e-8, max_grad_norm: Optional[float] = None):
        mask = decay_mask(model)
        params = dict(model.named_parameters())
        groups = [{"params": [p for n, p in params.items() if mask[n]],
                   "weight_decay": weight_decay},
                  {"params": [p for n, p in params.items() if not mask[n]],
                   "weight_decay": 0.0}]
        self.params = list(params.values())
        self.torch_optimizer = torch.optim.AdamW(groups, lr=0.0, betas=(beta1, beta2),
                                                 eps=epsilon)
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.count = 0

    def zero_grad(self) -> None:
        self.torch_optimizer.zero_grad(set_to_none=True)

    def step(self, grad_norm: torch.Tensor) -> float:
        """One update from the parameters' ``.grad``; returns the lr used."""
        if self.max_grad_norm is not None:
            grads = [p.grad for p in self.params if p.grad is not None]
            scale = torch.where(grad_norm < self.max_grad_norm, torch.ones_like(grad_norm),
                                self.max_grad_norm / grad_norm)
            torch._foreach_mul_(grads, scale)
        lr = float(self.schedule(self.count))
        for group in self.torch_optimizer.param_groups:
            group["lr"] = lr
        self.torch_optimizer.step()
        self.count += 1
        return lr

    def state_dict(self) -> dict:
        return {"count": self.count, "adamw": self.torch_optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.torch_optimizer.load_state_dict(state["adamw"])


def get_optimizer(name: str, model: nn.Module,
                  learning_rate: Union[float, Callable[[int], float]],
                  beta1: float = 0.9, beta2: float = 0.999, weight_decay: float = 0.01,
                  epsilon: float = 1e-8, max_grad_norm: Optional[float] = None) -> Optimizer:
    name = name.lower()
    if name not in ("adamw", "fused_adamw"):
        raise ValueError(f"optimizer {name} not supported by the port (adamw, fused_adamw)")
    schedule = learning_rate if callable(learning_rate) else (lambda step: learning_rate)
    return Optimizer(model, schedule, beta1=beta1, beta2=beta2, weight_decay=weight_decay,
                     epsilon=epsilon, max_grad_norm=max_grad_norm)
