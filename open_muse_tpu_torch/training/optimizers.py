"""The JAX package's optimizers with its weight-decay mask, schedule and
clipping.

Counterpart of ``open_muse_tpu/training/optimizers.py``.  Each name is a
torch optimizer whose arithmetic is the optax chain's:

- ``adamw`` / ``fused_adamw`` (one optimizer there: optax's AdamW, which XLA
  fuses): ``torch.optim.AdamW``: bias-corrected moments, ``m / (sqrt(v) +
  eps)``, decoupled decay ``lr * wd * p``;
- ``8bit_adamw``: ``quant8.AdamW8bit``, both moments blockwise int8;
- ``bf16_adamw`` (``optax.adamw(mu_dtype=bfloat16)``): ``AdamWBf16Moment``,
  the first moment stored in bf16 and the update taken from it in fp32
  before it is rounded;
- ``lion`` (``optax.lion`` with the JAX package's ``beta2`` default of
  0.999): ``Lion``, ``sign((1 - b1) g + b1 mu)``, then ``mu <- b2 mu + (1 -
  b2) g``.

The last three apply ``add_decayed_weights`` and then the lr, the order of
the chain.  Around each, as optax chains them:

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

from ..core.convert import flax_key_candidates, jax_layout
from ..models.paella_vq import BatchNorm2dInference
from .quant8 import AdamW8bit, KeepStateDtypes

__all__ = ["NO_DECAY_SUBSTRINGS", "OPTIMIZERS", "flax_param_name", "decay_mask", "AdamWBf16Moment",
           "Lion", "Optimizer", "get_optimizer", "global_norm"]

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
        elif not isinstance(module, BatchNorm2dInference):  # Paella's BatchNorm names it weight
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


def _neg(lr):
    """-lr: a float, or a 0-d device tensor (a graph reads its value)."""
    return torch.neg(lr) if isinstance(lr, torch.Tensor) else -lr


class AdamWBf16Moment(KeepStateDtypes):
    """``optax.adamw(mu_dtype=bfloat16)``: per parameter ``step`` (a 0-d fp32
    tensor on its device), ``exp_avg`` (bf16) and ``exp_avg_sq`` (fp32).
    ``mu = (1 - b1) g + b1 mu`` is taken in fp32 with ``b1`` rounded to bf16
    (JAX's weakly typed scalar takes the bf16 moment's type; the jitted
    update keeps the product in fp32); the update is ``mu_hat /
    (sqrt(nu_hat) + eps)`` from that fp32 ``mu``, and only then is ``mu``
    rounded into its bf16 store."""

    state_dtypes = {"exp_avg": torch.bfloat16}

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamWBf16Moment takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            b1_bf16 = float(torch.tensor(b1, dtype=torch.bfloat16))
            neg_lr = _neg(group["lr"])
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(step=torch.zeros((), dtype=torch.float32, device=p.device),
                                 exp_avg=torch.zeros_like(p, dtype=torch.bfloat16),
                                 exp_avg_sq=torch.zeros_like(p, dtype=torch.float32))
                g = p.grad.float()
                step = state["step"].add_(1)
                mu = (1.0 - b1) * g + b1_bf16 * state["exp_avg"].float()
                nu = state["exp_avg_sq"].mul_(b2).add_((1.0 - b2) * (g * g))
                update = (mu / (1.0 - torch.pow(b1, step))) / (
                    (nu / (1.0 - torch.pow(b2, step))).sqrt() + group["eps"])
                state["exp_avg"].copy_(mu)
                if group["weight_decay"]:
                    update = update + group["weight_decay"] * p
                p.add_(update * neg_lr)
        return None


class Lion(KeepStateDtypes):
    """``optax.lion``: per parameter ``exp_avg`` (fp32); the update
    ``sign((1 - b1) g + b1 mu)``, then ``mu <- (1 - b2) g + b2 mu``."""

    def __init__(self, params, lr=1e-4, betas=(0.9, 0.999), weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Lion takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            params = [p for p in group["params"] if p.grad is not None]
            for p in params:
                if not self.state[p]:
                    self.state[p]["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
            grads = [p.grad.float() for p in params]
            mus = [self.state[p]["exp_avg"] for p in params]
            updates = torch._foreach_mul(grads, 1.0 - b1)
            torch._foreach_add_(updates, torch._foreach_mul(mus, b1))
            torch._foreach_sign_(updates)
            torch._foreach_mul_(mus, b2)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - b2))
            if group["weight_decay"]:
                torch._foreach_add_(updates, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_mul_(updates, _neg(group["lr"]))
            torch._foreach_add_(params, updates)
        return None


def _torch_optimizer(name: str, model: nn.Module, groups, betas, eps: float,
                     capturable: bool) -> torch.optim.Optimizer:
    if name in ("adamw", "fused_adamw"):
        return torch.optim.AdamW(groups, lr=0.0, betas=betas, eps=eps, capturable=capturable)
    if name == "8bit_adamw":
        layouts = {}
        for param_name, p in model.named_parameters():
            owner, _, leaf = param_name.rpartition(".")
            layouts[p] = jax_layout(model.get_submodule(owner), leaf)
        return AdamW8bit(groups, lr=0.0, betas=betas, eps=eps, layouts=layouts)
    if name == "bf16_adamw":
        return AdamWBf16Moment(groups, lr=0.0, betas=betas, eps=eps)
    return Lion(groups, lr=0.0, betas=betas)


OPTIMIZERS = ("adamw", "fused_adamw", "8bit_adamw", "bf16_adamw", "lion")


class Optimizer:
    """One of ``OPTIMIZERS`` driven like an optax chain, and like
    ``optax.MultiSteps`` around it when ``accumulation_steps`` k > 1.

    A step is ``emit = begin_step()`` (host work: the schedule's value at
    the update count into the lr, the accumulation divisor), then
    ``update(grad_norm, emit)`` on the device alone, then
    ``end_step(emit)`` (the counters).  With k = 1 ``update`` clips the
    parameters' ``.grad`` by ``grad_norm`` (when ``max_grad_norm`` is set)
    and updates.  With k > 1 every call folds the grads into a running mean
    (``acc + (g - acc) / (n + 1)``, n the calls since the last update), and
    every k-th call emits: it clips the mean by the mean's own global norm,
    updates from it at the schedule's next value and zeroes it.

    On the card the lr and divisor are 0-d device tensors that
    ``begin_step`` fills, the step counts lie on the device (AdamW is
    ``capturable``) and every update is done in place, so that a CUDA graph
    holding ``update`` reads each step's values; on the CPU the lr is a
    float."""

    def __init__(self, model: nn.Module, schedule: Callable[[int], float], *,
                 name: str = "adamw", beta1: float = 0.9, beta2: float = 0.999,
                 weight_decay: float = 0.01, epsilon: float = 1e-8,
                 max_grad_norm: Optional[float] = None, accumulation_steps: int = 1):
        if name not in OPTIMIZERS:
            raise ValueError(f"optimizer {name} not supported (one of {OPTIMIZERS})")
        mask = decay_mask(model)
        params = dict(model.named_parameters())
        groups = [{"params": [p for n, p in params.items() if mask[n]],
                   "weight_decay": weight_decay},
                  {"params": [p for n, p in params.items() if not mask[n]],
                   "weight_decay": 0.0}]
        self.name = name
        self.params = list(params.values())
        device = self.params[0].device
        self.capturable = device.type == "cuda"
        self.lr = (torch.zeros((), dtype=torch.float32, device=device) if self.capturable
                   else 0.0)
        self.torch_optimizer = _torch_optimizer(name, model, groups, (beta1, beta2), epsilon,
                                                self.capturable)
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
        """The optimizer's state tensors (moments or their codes, step
        counts) and the lr tensor: what a graph holding an update reads by
        pointer."""
        out = [self.lr] if self.capturable else []
        for state in self.torch_optimizer.state.values():
            out.extend(v for v in state.values() if isinstance(v, torch.Tensor))
        return out

    def state_dict(self) -> dict:
        inner = self.torch_optimizer.state_dict()
        inner["param_groups"] = [{**g, "lr": float(g["lr"])} for g in inner["param_groups"]]
        out = {"count": self.count, "torch_optimizer": inner}
        if self.acc:
            out.update(mini_step=self.mini_step, acc=self.acc)
        return out

    def load_state_dict(self, state: dict) -> None:
        """Also across devices: AdamW's groups keep this optimizer's
        ``capturable`` (its step counts move onto the card for it), every
        group this optimizer's lr tensor.  The state tensors are new ones,
        so a graph keyed on ``state_tensors`` captures afresh; the
        accumulation buffers are copied into."""
        self.count = int(state["count"])
        inner = dict(state["torch_optimizer"])
        if isinstance(self.torch_optimizer, torch.optim.AdamW):
            inner["param_groups"] = [{**g, "capturable": self.capturable}
                                     for g in inner["param_groups"]]
        self.torch_optimizer.load_state_dict(inner)
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
    """``name`` (one of ``OPTIMIZERS``, any case) over ``model``'s parameters,
    as the JAX ``get_optimizer`` builds it (``lion`` takes no epsilon)."""
    schedule = learning_rate if callable(learning_rate) else (lambda step: learning_rate)
    return Optimizer(model, schedule, name=name.lower(), beta1=beta1, beta2=beta2,
                     weight_decay=weight_decay, epsilon=epsilon, max_grad_norm=max_grad_norm,
                     accumulation_steps=accumulation_steps)
