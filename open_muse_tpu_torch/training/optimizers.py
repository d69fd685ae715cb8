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
        elif not isinstance(module, nn.BatchNorm2d):  # Paella's BatchNorm names it weight
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
    """AdamW driven like an optax chain, and like ``optax.MultiSteps`` around
    it when ``accumulation_steps`` k > 1.

    A step is ``emit = begin_step()`` (host work: the schedule's value at
    the update count into the lr, the accumulation divisor), then
    ``update(grad_norm, emit)`` on the device alone, then
    ``end_step(emit)`` (the counters).  With k = 1 ``update`` clips the
    parameters' ``.grad`` by ``grad_norm`` (when ``max_grad_norm`` is set)
    and updates.  With k > 1 every call folds the grads into a running mean
    (``acc + (g - acc) / (n + 1)``, n the calls since the last update), and
    every k-th call emits: it clips the mean by the mean's own global norm,
    updates from it at the schedule's next value and zeroes it.

    On the card the AdamW is ``capturable`` and the lr and divisor are 0-d
    device tensors that ``begin_step`` fills, so that a CUDA graph holding
    ``update`` reads each step's values; on the CPU it is the plain AdamW
    with a float lr."""

    def __init__(self, model: nn.Module, schedule: Callable[[int], float], *,
                 beta1: float = 0.9, beta2: float = 0.999, weight_decay: float = 0.01,
                 epsilon: float = 1e-8, max_grad_norm: Optional[float] = None,
                 accumulation_steps: int = 1):
        mask = decay_mask(model)
        params = dict(model.named_parameters())
        groups = [{"params": [p for n, p in params.items() if mask[n]],
                   "weight_decay": weight_decay},
                  {"params": [p for n, p in params.items() if not mask[n]],
                   "weight_decay": 0.0}]
        self.params = list(params.values())
        device = self.params[0].device
        self.capturable = device.type == "cuda"
        self.lr = (torch.zeros((), dtype=torch.float32, device=device) if self.capturable
                   else 0.0)
        self.torch_optimizer = torch.optim.AdamW(groups, lr=0.0, betas=(beta1, beta2),
                                                 eps=epsilon, capturable=self.capturable)
        self._share_lr()
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.accumulation_steps = accumulation_steps
        self.mini_step = 0
        self.acc = ([torch.zeros_like(p, dtype=torch.float32) for p in self.params]
                    if accumulation_steps > 1 else [])
        self.acc_divisor = torch.ones((), dtype=torch.float32, device=device)

    def _share_lr(self) -> None:
        for group in self.torch_optimizer.param_groups:
            group["lr"] = self.lr

    def zero_grad(self) -> None:
        self.torch_optimizer.zero_grad(set_to_none=True)

    def begin_step(self) -> bool:
        """Host work before a step: the lr and divisor; True when this step
        updates the parameters."""
        lr = float(self.schedule(self.count))
        if self.capturable:
            self.lr.fill_(lr)
        else:
            self.lr = lr
            self._share_lr()
        if self.acc:
            self.acc_divisor.fill_(self.mini_step + 1)
        return self.mini_step == self.accumulation_steps - 1

    def end_step(self, emit: bool) -> None:
        self.mini_step = (self.mini_step + 1) % self.accumulation_steps
        self.count += int(emit)

    def update(self, grad_norm: torch.Tensor, emit: bool = True) -> None:
        """The step's device work from the parameters' ``.grad``."""
        grads = [p.grad for p in self.params]
        if self.acc:
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, self.acc_divisor)
            torch._foreach_add_(self.acc, diff)
            if not emit:
                return
            for p, a in zip(self.params, self.acc):
                p.grad = a
            grads, grad_norm = self.acc, global_norm(self.acc)
        if self.max_grad_norm is not None:
            scale = torch.where(grad_norm < self.max_grad_norm, torch.ones_like(grad_norm),
                                self.max_grad_norm / grad_norm)
            torch._foreach_mul_(grads, scale)
        self.torch_optimizer.step()
        if self.acc:
            torch._foreach_zero_(self.acc)

    def accumulators(self):
        """The accumulation buffers and divisor (empty with k = 1)."""
        return [*self.acc, self.acc_divisor] if self.acc else []

    def state_tensors(self):
        """AdamW's state tensors (moments, step counts) and the lr tensor: what
        a graph holding an update reads by pointer."""
        out = [self.lr] if self.capturable else []
        for state in self.torch_optimizer.state.values():
            out.extend(v for v in state.values() if isinstance(v, torch.Tensor))
        return out

    def state_dict(self) -> dict:
        adamw = self.torch_optimizer.state_dict()
        adamw["param_groups"] = [{**g, "lr": float(g["lr"])} for g in adamw["param_groups"]]
        out = {"count": self.count, "adamw": adamw}
        if self.acc:
            out.update(mini_step=self.mini_step, acc=self.acc)
        return out

    def load_state_dict(self, state: dict) -> None:
        """Also across devices: the groups keep this optimizer's
        ``capturable`` (AdamW's step counts move onto the card for it) and
        its lr tensor.  AdamW's state tensors are new ones, so a graph keyed
        on ``state_tensors`` captures afresh; the accumulation buffers are
        copied into."""
        self.count = int(state["count"])
        adamw = dict(state["adamw"])
        adamw["param_groups"] = [{**g, "capturable": self.capturable}
                                 for g in adamw["param_groups"]]
        self.torch_optimizer.load_state_dict(adamw)
        self._share_lr()
        if self.acc:
            self.mini_step = int(state.get("mini_step", 0))
            if "acc" in state:
                torch._foreach_copy_(self.acc, [a.to(self.acc[0].device) for a in state["acc"]])


def get_optimizer(name: str, model: nn.Module,
                  learning_rate: Union[float, Callable[[int], float]],
                  beta1: float = 0.9, beta2: float = 0.999, weight_decay: float = 0.01,
                  epsilon: float = 1e-8, max_grad_norm: Optional[float] = None,
                  accumulation_steps: int = 1) -> Optimizer:
    name = name.lower()
    if name not in ("adamw", "fused_adamw"):
        raise ValueError(f"optimizer {name} not supported by the port (adamw, fused_adamw)")
    schedule = learning_rate if callable(learning_rate) else (lambda step: learning_rate)
    return Optimizer(model, schedule, beta1=beta1, beta2=beta2, weight_decay=weight_decay,
                     epsilon=epsilon, max_grad_norm=max_grad_norm,
                     accumulation_steps=accumulation_steps)
