"""Multi-head attention with an on-chip fp32 softmax (csrc/flash_attention.cu).

Counterpart of ``open_muse_tpu/ops/pallas/flash_attention.py
flash_attention``: q (B, Tq, H, D), k and v (B, Tk, H, D) -> (B, Tq, H, D),
with fp32 logits scaled by 1/sqrt(D), an fp32 softmax, the normalised
weights cast to the input type before the PV product, and PV summed in fp32
(the TPU kernel's ``_kernel``, ``:34-56``).

``flash_attention`` is a ``torch.autograd.Function``:
  * CPU tensors: the plain version;
  * CUDA tensors: the kernel, or a raise.  It takes bf16 (under CUDA
    autocast the inputs are cast to bf16 first), D 16 (the eval stacks'
    seeded CLIP towers and tiny v2 trunks), 32 (the mid-scale distillation
    trunk's blocks), 48 (v1) or 64 (v2's attention blocks, CLIP ViT-L/14's
    vision tower), any Tq and Tk, and views whose (H, D) axes are
    contiguous with batch and token strides that are multiples of 8 elements
    (the q / k / v chunks of a fused projection), at 16-byte aligned
    addresses.  Up to 288 keys (every path: v1's 257, v2's 77) a
    block stages all of K and V in shared memory and computes S once, one
    warp over every key of 16 query rows up to 80 keys and two warps each
    over half of them above; more keys (the 1024-token v1 trunks' 1025 and
    1024) take the source's two-pass variant.  The choice is made on Tk
    before the launch; every variant counts as one launch of this wrapper,
    and the two-pass one also in ``flash_attention_two_pass``.  The host's
    own launches (a graph's warm-up included, its replays not) are also
    counted by head dim in ``flash_attention.by_head_dim``, which tells
    which instantiations a path reaches.
The TPU kernel has no VJP (JAX enables it for inference only), so there is
no backward kernel: the backward recomputes the plain version from the saved
inputs and takes its gradient.
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from . import LaunchCounter, on_cpu, plain_vjp, stream_handle
from ._build import check, library

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_two_pass",
           "HEAD_DIMS", "ONE_PASS_MAX_KEYS"]

HEAD_DIMS = (16, 32, 48, 64)  # the kernel's instantiations
ONE_PASS_MAX_KEYS = 288  # csrc kMaxKeys: more keys take the two-pass variant
flash_attention_two_pass = LaunchCounter("flash_attention_two_pass")


def flash_attention_plain(q, k, v):
    """The TPU kernel's staging in PyTorch: fp32 logits * 1/sqrt(D), fp32
    softmax, weights cast to the input dtype, PV summed in fp32 and cast
    to it."""
    acc = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * (1.0 / math.sqrt(q.shape[-1]))
    weights = logits.softmax(dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(acc), v.to(acc)).to(q.dtype)


def _check_layout(q, k, v):
    """Raise unless the kernel takes these CUDA tensors."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: {name} {t.dtype}; the kernel takes bf16")
        d = t.shape[-1]
        if (t.stride(3) != 1 or t.stride(2) != d or t.stride(0) % 8 or t.stride(1) % 8
                or t.data_ptr() % 16):
            raise ValueError(f"flash_attention: {name} strides {t.stride()} at {t.data_ptr()}: "
                             "the (H, D) axes must be contiguous, the batch and token strides "
                             "multiples of 8 and the address 16-byte aligned")


def _forward(q, k, v):
    if on_cpu(q, k, v):
        return flash_attention_plain(q, k, v)
    _check_layout(q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 6)(q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                                   v.stride(0), v.stride(1))
    check(library().muse_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, tq, tk, d, strides,
        1.0 / math.sqrt(d), stream_handle(q)), "flash_attention")
    flash_attention.launches += 1
    flash_attention.by_head_dim[d] += 1
    if tk > ONE_PASS_MAX_KEYS:
        flash_attention_two_pass.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        return plain_vjp(flash_attention_plain, ctx.saved_tensors, (g,), ctx.needs_input_grad)


def flash_attention(q, k, v):
    """(B, Tq, H, D), (B, Tk, H, D) x 2 -> (B, Tq, H, D) in q's dtype.
    Differentiable."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or \
            (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    return _FlashAttention.apply(q, k, v)


flash_attention.launches = 0
flash_attention.by_head_dim = collections.Counter()
