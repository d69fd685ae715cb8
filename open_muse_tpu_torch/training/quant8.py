"""AdamW with blockwise 8-bit moments (``8bit_adamw``).

The port's own copy of ``open_muse_tpu/training/quant8.py``: both Adam
moments of a parameter with at least ``MIN_QUANT_SIZE`` elements live as one
uint8 code a element plus one fp32 absmax a block of ``BLOCK_SIZE``, ~2.03
bytes a parameter of optimizer state against 8 for fp32 moments.  The codes
index a dynamic (log-spaced) codebook over 7 decades: ``UNSIGNED_TABLE``
(0 and 255 magnitudes) for the second moment, ``SIGNED_TABLE`` (128
negative, 0, 127 positive) for the first; both are built in float64 and
cast to fp32, as in JAX.  Smaller parameters keep fp32 moments.

Blocks run along the last axis of the *JAX leaf*, so each parameter is
quantised in its JAX layout (``core.convert.jax_layout``: a ``Linear``
weight (out, in) as (in, out), a convolution OIHW as HWIO): blocking the
torch weight as it stands would group other elements under each absmax, and
the codes and updates would drift from JAX's.  The codes and absmax are
stored in that layout.

The math is JAX's, fp32 throughout: dequantise, ``mu = b1 mu + (1 - b1) g``,
``nu = b2 nu + (1 - b2) g^2``, the update ``mu_hat / (sqrt(nu_hat) + eps)``
with the bias corrections at the step count, the moments requantised; then
``add_decayed_weights`` (the group's ``weight_decay``) and the lr, the order
of the JAX chain.  The nearest code is a left ``searchsorted`` on the
sorted codebook with ties going to the upper code.  The lr may be a 0-d
device tensor and the step counts are device tensors, so a CUDA graph holds
the update.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["BLOCK_SIZE", "MIN_QUANT_SIZE", "SIGNED_TABLE", "UNSIGNED_TABLE", "quantize_blockwise", "dequantize_blockwise", "AdamW8bit"]

BLOCK_SIZE = 256          # bitsandbytes' 8-bit optimizer block
MIN_QUANT_SIZE = 4096     # bitsandbytes' min_8bit_size: smaller parameters stay fp32
_DECADES = 7.0            # the codebook's dynamic range (1e-7 .. 1)


def _make_tables() -> Tuple[np.ndarray, np.ndarray]:
    mags = np.logspace(-_DECADES, 0.0, 255)
    unsigned = np.concatenate([[0.0], mags])
    neg = -np.logspace(-_DECADES, 0.0, 128)[::-1]
    pos = np.logspace(-_DECADES, 0.0, 127)
    signed = np.concatenate([neg, [0.0], pos])
    return signed.astype(np.float32), unsigned.astype(np.float32)


SIGNED_TABLE, UNSIGNED_TABLE = _make_tables()


def _tile_scales(absmax: torch.Tensor, last: int, block_size: int) -> torch.Tensor:
    """(*lead, nb) -> (*lead, last): each element's block scale."""
    return absmax.repeat_interleave(block_size, dim=-1)[..., :last]


def quantize_blockwise(x: torch.Tensor, table: torch.Tensor,
                       block_size: int = BLOCK_SIZE) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``x`` (ndim >= 1) -> (codes uint8 of ``x``'s shape, absmax fp32
    (*lead, ceil(last / block_size))): the nearest codebook entry of each
    element divided by its block's absmax over the last axis."""
    last = x.shape[-1]
    nb = -(-last // block_size)
    xb = F.pad(x, (0, nb * block_size - last)).reshape(*x.shape[:-1], nb, block_size)
    absmax = xb.abs().amax(dim=-1)
    scale = _tile_scales(absmax, last, block_size)
    v = torch.where(scale > 0, x / scale.clamp_min(1e-38), 0.0).contiguous()
    hi = torch.searchsorted(table, v).clamp_(1, table.shape[0] - 1)
    lo = hi - 1
    pick_hi = (table[hi] - v) <= (v - table[lo])
    return torch.where(pick_hi, hi, lo).to(torch.uint8), absmax


def dequantize_blockwise(codes: torch.Tensor, absmax: torch.Tensor, table: torch.Tensor,
                         block_size: int = BLOCK_SIZE) -> torch.Tensor:
    return table[codes.long()] * _tile_scales(absmax, codes.shape[-1], block_size)


# a parameter's JAX layout: (the permutation of its axes, the axes then
# flipped), or None where the two layouts agree
Layout = Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]]


def _to_jax(x: torch.Tensor, layout: Layout) -> torch.Tensor:
    if layout is None:
        return x
    perm, flip = layout
    x = x.permute(perm)
    return x.flip(flip) if flip else x


def _from_jax(x: torch.Tensor, layout: Layout) -> torch.Tensor:
    if layout is None:
        return x
    perm, flip = layout
    if flip:
        x = x.flip(flip)
    return x.permute(tuple(int(i) for i in np.argsort(perm)))


class KeepStateDtypes(torch.optim.Optimizer):
    """A torch optimizer whose state keeps its own dtypes across
    ``load_state_dict``: torch casts loaded state to each parameter's dtype
    (``state_dtypes`` names the keys cast back; the values survive the round
    trip exactly) and leaves ``step`` where it was saved (moved here onto
    the parameter's device, where a captured graph increments it)."""

    state_dtypes: Dict[str, torch.dtype] = {}

    def load_state_dict(self, state_dict: dict) -> None:
        super().load_state_dict(state_dict)
        for p, state in self.state.items():
            for key, value in state.items():
                if key == "step":
                    state[key] = value.to(p.device, torch.float32)
                elif key in self.state_dtypes:
                    state[key] = value.to(self.state_dtypes[key])


class AdamW8bit(KeepStateDtypes):
    """``adamw8bit`` of the JAX package as a torch optimizer.

    ``layouts`` maps a parameter to its JAX layout (``core.convert.jax_layout``;
    missing: the layouts agree).  State of a parameter: ``step`` (a 0-d fp32
    tensor on its device) and either ``exp_avg`` / ``exp_avg_sq`` (fp32, a
    parameter under ``min_quant_size`` elements or 0-d) or their
    ``*_codes`` (uint8, the JAX layout) and ``*_absmax`` (fp32)."""

    state_dtypes = {"exp_avg_codes": torch.uint8, "exp_avg_sq_codes": torch.uint8}

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, layouts: Optional[Dict[torch.Tensor, Layout]] = None,
                 min_quant_size: int = MIN_QUANT_SIZE):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.layouts = layouts or {}
        self.min_quant_size = min_quant_size
        self._tables: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def tables(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(signed, unsigned) codebooks on ``device``, copied there once (by
        the first, eager step: a graph capture refuses host copies)."""
        if device not in self._tables:
            self._tables[device] = (torch.as_tensor(SIGNED_TABLE, device=device),
                                    torch.as_tensor(UNSIGNED_TABLE, device=device))
        return self._tables[device]

    def _quantized(self, p: torch.Tensor) -> bool:
        return p.dim() > 0 and p.numel() >= self.min_quant_size

    def _init_state(self, p: torch.Tensor) -> dict:
        state = {"step": torch.zeros((), dtype=torch.float32, device=p.device)}
        if not self._quantized(p):
            state["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
            state["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
            return state
        signed, unsigned = self.tables(p.device)
        zeros = _to_jax(torch.zeros_like(p, dtype=torch.float32), self.layouts.get(p))
        for key, table in (("exp_avg", signed), ("exp_avg_sq", unsigned)):
            state[f"{key}_codes"], state[f"{key}_absmax"] = quantize_blockwise(zeros, table)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW8bit takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr = group["lr"]
            neg_lr = torch.neg(lr) if isinstance(lr, torch.Tensor) else -lr
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(self._init_state(p))
                state["step"].add_(1)
                quantized = "exp_avg_codes" in state
                layout = self.layouts.get(p) if quantized else None
                g = _to_jax(p.grad.float(), layout)
                if quantized:
                    signed, unsigned = self.tables(p.device)
                    mu = dequantize_blockwise(state["exp_avg_codes"], state["exp_avg_absmax"],
                                              signed)
                    nu = dequantize_blockwise(state["exp_avg_sq_codes"],
                                              state["exp_avg_sq_absmax"], unsigned)
                else:
                    mu, nu = state["exp_avg"], state["exp_avg_sq"]
                mu = b1 * mu + (1.0 - b1) * g
                nu = b2 * nu + (1.0 - b2) * g * g
                step = state["step"]
                mu_hat = mu / (1.0 - torch.pow(b1, step))
                nu_hat = nu / (1.0 - torch.pow(b2, step))
                update = _from_jax(mu_hat / (nu_hat.sqrt() + group["eps"]), layout)
                # in place: a captured graph reads and writes the state by pointer
                if quantized:
                    for key, moment, table in (("exp_avg", mu, signed),
                                               ("exp_avg_sq", nu, unsigned)):
                        codes, absmax = quantize_blockwise(moment, table)
                        state[f"{key}_codes"].copy_(codes)
                        state[f"{key}_absmax"].copy_(absmax)
                else:
                    state["exp_avg"].copy_(mu)
                    state["exp_avg_sq"].copy_(nu)
                if group["weight_decay"]:
                    update = update + group["weight_decay"] * p
                p.add_(update * neg_lr)
        return None
