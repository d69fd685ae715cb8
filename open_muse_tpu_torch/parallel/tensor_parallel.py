"""Tensor-parallel weights (``training.tp`` > 1): the collectives of a
Megatron-style split, and each rank's local view of its weights.

The JAX package splits attention heads, GLU columns and the v2 head's
vocabulary over the mesh's tp axis and lets GSPMD insert the collectives
(``open_muse_tpu/parallel/sharding.py``).  Here the split is written out:
``sharding.shard_params`` stores every parameter as a DTensor on the tp
mesh dim (``Shard`` on the dim its rule names for tp, else ``Replicate``),
``use_local_params`` hands each module its plain local tensors during the
forward (so every kernel runs on this rank's head or column shard), and the
modules put these collectives around their split products:

- ``copy_to_tp`` (identity forward, all-reduce backward) where a whole
  activation enters a column-split product (q / k / v, ``wi_0`` / ``wi_1``,
  the head's ``conv2``): each rank's input gradient is its part of the sum;
- ``reduce_from_tp`` (all-reduce forward, identity backward) after a
  row-split product (``out``, ``wo``): each rank's output is its part of
  the sum;
- ``gather_from_tp`` (all-gather of the last dim forward, this rank's slice
  backward) where every rank goes on with the whole of a split activation
  (the vocabulary-split logits, before the loss);
- ``scatter_to_tp`` (this rank's slice forward, all-gather backward) back
  from such a whole activation to the split one (v1's mid-MLP norm).

The fused attention sublayers (kernels 9 - 12) sum their own output and
gradients (``kernels.attn_sublayer``, ``tp=``).  Every collective is issued
on the current stream, so under NCCL a train step holding them stays one
captured CUDA graph, as ``mesh.DataParallel``'s do; gloo's cannot be
captured, and a step under gloo runs eagerly (``training.trainer``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["TensorParallel", "copy_to_tp", "reduce_from_tp", "gather_from_tp", "scatter_to_tp",
           "local", "use_local_params", "tensor_parallel_of"]


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallel:
    """The tp process group of this rank: ``rank`` its index in the group,
    ``size`` the group's size."""

    group: object
    rank: int
    size: int

    @property
    def nccl(self) -> bool:
        return dist.get_backend(self.group) == "nccl"

    def all_reduce_(self, tensors: List[torch.Tensor]) -> None:
        """Sum each tensor over the group, in place: one coalesced
        all-reduce a dtype under NCCL, one flat buffer a dtype otherwise."""
        from .mesh import _count

        for dtype in dict.fromkeys(t.dtype for t in tensors):  # the same order on every rank
            part = [t for t in tensors if t.dtype == dtype]
            if self.nccl:
                with dist._coalescing_manager(group=self.group):
                    for t in part:
                        dist.all_reduce(t, group=self.group)
            else:
                flat = torch.cat([t.reshape(-1) for t in part])
                dist.all_reduce(flat, group=self.group)
                torch._foreach_copy_(part, [v.view_as(t) for v, t in
                                            zip(flat.split([t.numel() for t in part]), part)])
            _count(part[0])

    def all_gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along the last dim, in rank order."""
        from .mesh import _count

        t = t.contiguous()
        if self.nccl:
            out = torch.empty((self.size, *t.shape), dtype=t.dtype, device=t.device)
            dist.all_gather_into_tensor(out, t, group=self.group)
        else:
            parts = [torch.empty_like(t) for _ in range(self.size)]
            dist.all_gather(parts, t, group=self.group)
            out = torch.stack(parts)
        _count(out)
        return out.movedim(0, -2).reshape(*t.shape[:-1], self.size * t.shape[-1])

    def shard_last(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``t``'s last dim."""
        n = t.shape[-1] // self.size
        return t[..., self.rank * n:(self.rank + 1) * n].contiguous()


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)  # autograd may share g
        ctx.tp.all_reduce_([g])
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        out = x.clone(memory_format=torch.contiguous_format)
        tp.all_reduce_([out])
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.all_gather_last(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.shard_last(g), None


class _ScatterToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.shard_last(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_gather_last(g), None


def copy_to_tp(x, tp: Optional[TensorParallel]):
    """``x`` entering column-split weights (its gradient summed over tp)."""
    return x if tp is None else _CopyToTP.apply(x, tp)


def reduce_from_tp(x, tp: Optional[TensorParallel]):
    """The sum over tp of row-split products' partial outputs."""
    return x if tp is None else _ReduceFromTP.apply(x, tp)


def gather_from_tp(x, tp: Optional[TensorParallel]):
    """The whole of a last-dim-split ``x`` on every rank."""
    return x if tp is None else _GatherFromTP.apply(x, tp)


def scatter_to_tp(x, tp: Optional[TensorParallel]):
    """This rank's part of a whole ``x``'s last dim."""
    return x if tp is None else _ScatterToTP.apply(x, tp)


def local(t):
    """A DTensor's local tensor (differentiable), any other tensor itself."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


# -- each module's local weights during the forward ---------------------------------

def _swap_in(module: nn.Module):
    """Shadow every DTensor parameter under ``module`` by its local tensor
    (in the owner's ``__dict__``, which attribute lookup reads before
    ``_parameters``); returns what it shadowed."""
    from torch.distributed.tensor import DTensor

    swapped = []
    for sub in module.modules():
        for name, p in sub._parameters.items():
            if isinstance(p, DTensor) and name not in sub.__dict__:
                sub.__dict__[name] = p.to_local()
                swapped.append((sub, name))
    return swapped


def use_local_params(model: nn.Module, layers=()) -> None:
    """While ``model`` (and each of ``layers``, the modules a checkpointed
    forward recomputes alone in the backward) runs its forward, each
    parameter reads as its local tensor: a plain tensor of this rank's
    shape, whose gradient flows back into the DTensor parameter's.  The
    hooks nest: a module inside a forward that already swapped swaps
    nothing."""
    for module in (model, *layers):
        stack: list = []

        def pre(mod, args, stack=stack):
            stack.append(_swap_in(mod))

        def post(mod, args, out, stack=stack):
            for sub, name in stack.pop() if stack else ():  # none where an earlier hook raised
                del sub.__dict__[name]

        module.register_forward_pre_hook(pre)
        # first among the forward hooks (before FSDP2's reshard), and also
        # when the forward raises
        module.register_forward_hook(post, prepend=True, always_call=True)


def tensor_parallel_of(model: nn.Module) -> Optional[TensorParallel]:
    """The tp group ``sharding.shard_params`` split ``model`` over
    (``model._tensor_parallel``), or None."""
    return getattr(model, "_tensor_parallel", None)
