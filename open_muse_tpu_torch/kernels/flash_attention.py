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
    addresses.  Up to 288 keys (v1's 257, v2's 256 and 77) S is computed
    once and kept in registers.  At head dims 48 and 64 a (batch, head)
    pair's K and V are read once, by TMA, into one block that walks over
    pairs (the next pair's K and V arriving while this one's are read) or,
    when the pairs do not fill the card, into every block of a cluster that
    shares the pair's row tiles (one multicast load); two or three
    warpgroups of 64 query rows run ``wgmma`` for S and for P V.  At 16 and
    32, and where the pairs do not fill the card at 96 keys or fewer or at
    head dim 48 (serving's text keys, v1 at batch 1), a block of 64 rows
    stages K and V by cp.async and runs mma.sync, one warp over every key of
    16 query rows up to 80 keys and two warps each over half of them
    above.  More keys (the 1024-token v1 trunks' 1025 and 1024, the
    512 px v2's 1024 inside kernel 9) take the two-pass variant, which
    streams 64-key tiles of K (pass 1: row max and sum) and of K and V
    (pass 2: P and P V) through rings in shared memory: on wgmma, 128 query
    rows a block, at head dim 64; on mma.sync, 64 rows a block, at the
    others.  The choice is made before the launch by ``variant``, the C
    launcher's rule (``takes_two_pass`` its first test); every variant
    counts as one launch of this wrapper, and the two-pass one also in
    ``flash_attention_two_pass``.  The host's own launches (a graph's
    warm-up included, its replays not) are also counted by head dim in
    ``flash_attention.by_head_dim`` and by variant in
    ``flash_attention.by_variant``, which tell which instantiations a path
    reaches.
The TPU kernel has no VJP (JAX enables it for inference only), so there is
no backward kernel: the backward recomputes the plain version from the saved
inputs and takes its gradient.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from . import LaunchCounter, on_cpu, plain_vjp, stream_handle
from ._build import check, library

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_two_pass",
           "takes_two_pass", "variant", "one_pass_chunks", "one_pass_cluster", "HEAD_DIMS",
           "ONE_PASS_MAX_KEYS", "VARIANTS"]

HEAD_DIMS = (16, 32, 48, 64)  # the kernel's instantiations
ONE_PASS_MAX_KEYS = 288  # csrc kMaxKeys: the one-pass capacity
ONE_PASS_WARP_KEYS = 80  # the mma.sync one-pass kernel's one warp a row group
WGMMA_ONE_PASS_DIMS = (48, 64)  # head dims of the one-pass wgmma kernel
MAX_CLUSTER = 8  # csrc op::kMaxCluster
H100_SMS = 132
VARIANTS = ("one_pass_mma", "one_pass_mma_split", "one_pass_wgmma", "one_pass_cluster",
            "two_pass_mma", "two_pass_wgmma")
flash_attention_two_pass = LaunchCounter("flash_attention_two_pass")


def takes_two_pass(tk: int) -> bool:
    """More keys than the one-pass kernels hold: the two-pass variant."""
    return tk > ONE_PASS_MAX_KEYS


def one_pass_chunks(tk: int) -> int:
    """csrc ``op::chunks_for``: the one-pass wgmma kernel's key capacity, in
    32-key chunks, that Tk takes: 1, 3 (96 keys), 8 (256) or 9 (288)."""
    return 1 if tk <= 32 else 3 if tk <= 96 else 8 if tk <= 256 else 9


def one_pass_cluster(bh: int, tq: int, tk: int, sms: int = H100_SMS) -> int:
    """csrc ``op::cluster_for``: the blocks of the one-pass wgmma kernel that
    share a (batch, head) pair.  1 (persistent blocks, one an SM, walking over
    the pairs) when the pairs fill the card; else as many as the card holds
    for every pair, but no more than give each of a block's consumer
    warpgroups (3 up to 256 keys, else 2) one 64-row tile, and at most 8."""
    tiles = -(-tq // 64)
    consumers = 3 if one_pass_chunks(tk) <= 8 else 2
    return max(1, min(sms // bh, -(-tiles // consumers), MAX_CLUSTER))


def variant(tk: int, d: int, bh: int, tq: int, sms: int = H100_SMS) -> str:
    """The C launcher's rule (csrc/flash_attention.cu ``launch``), on what it
    knows before the launch: the key count, the head dim, the (batch, head)
    pairs and the query rows (and the card's SM count)."""
    if takes_two_pass(tk):
        return "two_pass_wgmma" if d == 64 else "two_pass_mma"
    if d in WGMMA_ONE_PASS_DIMS:
        if one_pass_cluster(bh, tq, tk, sms) == 1:
            return "one_pass_wgmma"
        if d == 64 and tk > 96:
            return "one_pass_cluster"
    return "one_pass_mma" if tk <= ONE_PASS_WARP_KEYS else "one_pass_mma_split"


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    flash_attention.by_variant[variant(tk, d, b * h, tq, _sm_count(q.device.index or 0))] += 1
    if takes_two_pass(tk):
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
flash_attention.by_variant = collections.Counter()
