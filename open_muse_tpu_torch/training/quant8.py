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
stored in that layout.  A DTensor shard (tensor-parallel weights, FSDP2)
is quantised in the whole leaf's blocks: where its part of the JAX layout's
last axis does not start and end on block bounds (a GLU column shard of
1408 at tp 2), the blocks that straddle ranks take the largest absmax of
their parts (an all-reduce over the ranks that split the axis; trap 6 of the
tensor-parallel port), and the shard keeps the absmax of every block of the
leaf's rows.

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

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

__all__ = ["BLOCK_SIZE", "MIN_QUANT_SIZE", "SIGNED_TABLE", "UNSIGNED_TABLE", "quantize_blockwise",
           "dequantize_blockwise", "AdamW8bit", "BlockSplit"]

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


@dataclasses.dataclass(frozen=True)
class BlockSplit:
    """A shard's place on its leaf's last axis: its first column
    ``offset``, the leaf's ``total`` columns, and ``reduce_max``, which takes
    the elementwise max of an absmax over the ranks that split the axis."""

    offset: int
    total: int
    reduce_max: Callable[[torch.Tensor], None]


def _block_index(last: int, split: BlockSplit, block_size: int, device) -> torch.Tensor:
    return (torch.arange(last, device=device) + split.offset) // block_size


def quantize_blockwise(x: torch.Tensor, table: torch.Tensor, block_size: int = BLOCK_SIZE,
                       split: Optional[BlockSplit] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``x`` (ndim >= 1) -> (codes uint8 of ``x``'s shape, absmax fp32
    (*lead, ceil(last / block_size))): the nearest codebook entry of each
    element divided by its block's absmax over the last axis.  ``split``:
    ``x`` is a shard of a leaf's last axis, quantised in the leaf's blocks;
    the absmax is every block's of the leaf's rows, (*lead, ceil(total /
    block_size))."""
    last = x.shape[-1]
    if split is None:
        nb = -(-last // block_size)
        xb = F.pad(x, (0, nb * block_size - last)).reshape(*x.shape[:-1], nb, block_size)
        absmax = xb.abs().amax(dim=-1)
        scale = _tile_scales(absmax, last, block_size)
    else:
        index = _block_index(last, split, block_size, x.device)
        absmax = x.new_zeros(*x.shape[:-1], -(-split.total // block_size)).scatter_reduce_(
            -1, index.expand(x.shape), x.abs(), "amax")
        split.reduce_max(absmax)
        scale = absmax.index_select(-1, index)
    v = torch.where(scale > 0, x / scale.clamp_min(1e-38), 0.0).contiguous()
    hi = torch.searchsorted(table, v).clamp_(1, table.shape[0] - 1)
    lo = hi - 1
    pick_hi = (table[hi] - v) <= (v - table[lo])
    return torch.where(pick_hi, hi, lo).to(torch.uint8), absmax


def dequantize_blockwise(codes: torch.Tensor, absmax: torch.Tensor, table: torch.Tensor,
                         block_size: int = BLOCK_SIZE,
                         split: Optional[BlockSplit] = None) -> torch.Tensor:
    last = codes.shape[-1]
    if split is None:
        return table[codes.long()] * _tile_scales(absmax, last, block_size)
    return table[codes.long()] * absmax.index_select(
        -1, _block_index(last, split, block_size, codes.device))


# a parameter's JAX layout: (the permutation of its axes, the axes then
# flipped), or None where the two layouts agree
Layout = Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]]


def _to_jax(x: torch.Tensor, layout: Layout) -> torch.Tensor:
    if layout is None:
        return x
    perm, flip = layout
    x = x.permute(perm)
    return x.flip(flip) if flip else x


def block_split(p: torch.Tensor, layout: Layout,
                block_size: int = BLOCK_SIZE) -> Optional[BlockSplit]:
    """``p``'s ``BlockSplit`` where it is a DTensor shard whose part of the
    JAX layout's last axis does not fall on the leaf's block bounds; None
    where its local blocks are the leaf's."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return None
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    jax_last = p.dim() - 1
    axis = jax_last if layout is None else layout[0][jax_last]
    shape, offsets = compute_local_shape_and_global_offset(p.shape, p.device_mesh, p.placements)
    n, total, offset = shape[axis], p.shape[axis], offsets[axis]
    if layout is not None and jax_last in layout[1]:  # the axis is flipped
        offset = total - offset - n
    if offset % block_size == 0 and (n % block_size == 0 or offset + n == total):
        return None
    groups = [p.device_mesh.get_group(d) for d, placement in enumerate(p.placements)
              if placement.is_shard(axis)]

    def reduce_max(t: torch.Tensor) -> None:
        from ..parallel.mesh import _count

        for group in groups:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        _count(t)

    return BlockSplit(offset, total, reduce_max)


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
    ``*_codes`` (uint8, the JAX layout) and ``*_absmax`` (fp32).  A DTensor
    parameter's state is that of its local shard (``block_split``)."""

    state_dtypes = {"exp_avg_codes": torch.uint8, "exp_avg_sq_codes": torch.uint8}

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, layouts: Optional[Dict[torch.Tensor, Layout]] = None,
                 min_quant_size: int = MIN_QUANT_SIZE):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.layouts = layouts or {}
        self.min_quant_size = min_quant_size
        self._tables: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._splits: Dict[torch.Tensor, Optional[BlockSplit]] = {}

    def _split(self, p: torch.Tensor) -> Optional[BlockSplit]:
        if p not in self._splits:
            self._splits[p] = block_split(p, self.layouts.get(p))
        return self._splits[p]

    def tables(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(signed, unsigned) codebooks on ``device``, copied there once (by
        the first, eager step: a graph capture refuses host copies)."""
        if device not in self._tables:
            self._tables[device] = (torch.as_tensor(SIGNED_TABLE, device=device),
                                    torch.as_tensor(UNSIGNED_TABLE, device=device))
        return self._tables[device]

    def _quantized(self, p: torch.Tensor) -> bool:
        return p.dim() > 0 and p.numel() >= self.min_quant_size  # the whole leaf's count

    def _init_state(self, param: torch.Tensor) -> dict:
        from ..parallel.tensor_parallel import local

        p = local(param)
        state = {"step": torch.zeros((), dtype=torch.float32, device=p.device)}
        if not self._quantized(param):
            state["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
            state["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
            return state
        signed, unsigned = self.tables(p.device)
        zeros = _to_jax(torch.zeros_like(p, dtype=torch.float32), self.layouts.get(param))
        for key, table in (("exp_avg", signed), ("exp_avg_sq", unsigned)):
            state[f"{key}_codes"], state[f"{key}_absmax"] = quantize_blockwise(
                zeros, table, split=self._split(param))
        return state

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW8bit takes no closure")
        from ..parallel.tensor_parallel import local

        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr = group["lr"]
            neg_lr = torch.neg(lr) if isinstance(lr, torch.Tensor) else -lr
            for param in group["params"]:
                if param.grad is None:
                    continue
                state = self.state[param]
                if not state:
                    state.update(self._init_state(param))
                state["step"].add_(1)
                p = local(param)  # a DTensor shard's own elements
                quantized = "exp_avg_codes" in state
                layout = self.layouts.get(param) if quantized else None
                split = self._split(param) if quantized else None
                g = _to_jax(local(param.grad).float(), layout)
                if quantized:
                    signed, unsigned = self.tables(p.device)
                    mu = dequantize_blockwise(state["exp_avg_codes"], state["exp_avg_absmax"],
                                              signed, split=split)
                    nu = dequantize_blockwise(state["exp_avg_sq_codes"],
                                              state["exp_avg_sq_absmax"], unsigned, split=split)
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
                        codes, absmax = quantize_blockwise(moment, table, split=split)
                        state[f"{key}_codes"].copy_(codes)
                        state[f"{key}_absmax"].copy_(absmax)
                else:
                    state["exp_avg"].copy_(mu)
                    state["exp_avg_sq"].copy_(nu)
                if group["weight_decay"]:
                    update = update + group["weight_decay"] * p
                p.add_(update * neg_lr)
        return None
