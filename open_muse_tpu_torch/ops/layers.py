"""Shared building blocks, the PyTorch counterparts of
``open_muse_tpu/ops/layers.py`` with the same precision staging.

Parameter names follow the open-muse torch modules (``weight`` / ``bias`` /
``gamma`` / ``beta``), so reference checkpoints load with ``load_state_dict``.

Where the JAX package sends a layer to a Pallas kernel, the port sends it to
the kernel's wrapper: ``RMSNorm`` to ``fused_residual_rmsnorm``, ``LayerNorm``
to ``fused_residual_layernorm`` and an unmasked ``dot_product_attention`` to
``flash_attention``; the wrappers are differentiable.  The norms take the
kernels' model staging, which rounds where the JAX layers round (the sum,
the rsqrt factor or normalised value, and the affine in the input type), so
a bf16 model computes what the JAX model computes off the TPU.
``use_kernels=False`` takes the code below them instead: the same staging
written out, bit for bit the norm kernels' plain model staging.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash_attention import flash_attention
from ..kernels.fused_norm import fused_residual_layernorm, fused_residual_rmsnorm
from ..parallel.tensor_parallel import copy_to_tp, reduce_from_tp, scatter_to_tp

__all__ = ["RMSNorm", "LayerNorm", "Norm", "GlobalResponseNorm", "AdaLNModulation",
           "sinusoidal_encode", "dot_product_attention", "Attention", "column_linear",
           "row_linear"]


def _result(out, prenorm, residual, return_residual):
    return (out, prenorm) if residual is not None or return_residual else out


class RMSNorm(nn.Module):
    """RMSNorm with the fused-residual prenorm contract:
    ``forward(x)`` -> normed; ``forward(x, residual)`` or
    ``return_residual=True`` -> (normed, x + residual).  Variance in fp32."""

    def __init__(self, dim: int, eps: float = 1e-6, elementwise_affine: bool = True):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim)) if elementwise_affine else None

    def forward(self, x, residual=None, return_residual: bool = False, use_kernels: bool = True):
        if use_kernels:
            out, prenorm = fused_residual_rmsnorm(
                x.contiguous(), None if residual is None else residual.contiguous(),
                self.weight, self.eps, staging="model")
            return _result(out, prenorm, residual, return_residual)
        if residual is not None:
            x = x + residual
        prenorm = x
        var = x.float().square().mean(-1, keepdim=True)
        out = x * torch.rsqrt(var + self.eps).to(x.dtype)
        if self.weight is not None:
            out = out * self.weight.to(out.dtype)
        return _result(out, prenorm, residual, return_residual)


class LayerNorm(nn.Module):
    """LayerNorm (optional bias / affine) with the RMSNorm residual contract;
    statistics in fp32, normalised value cast back before the affine."""

    def __init__(self, dim: int, eps: float = 1e-5, use_bias: bool = False,
                 elementwise_affine: bool = True):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim)) if elementwise_affine else None
        self.bias = nn.Parameter(torch.zeros(dim)) if elementwise_affine and use_bias else None

    def forward(self, x, residual=None, return_residual: bool = False, use_kernels: bool = True):
        if use_kernels:
            out, prenorm = fused_residual_layernorm(
                x.contiguous(), None if residual is None else residual.contiguous(),
                self.weight, self.bias, self.eps, staging="model")
            return _result(out, prenorm, residual, return_residual)
        if residual is not None:
            x = x + residual
        prenorm = x
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        out = ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)
        if self.weight is not None:
            out = out * self.weight.to(out.dtype)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return _result(out, prenorm, residual, return_residual)


def Norm(dim, norm_type: str = "layernorm", eps: float = 1e-5, use_bias: bool = False,
         elementwise_affine: bool = True) -> nn.Module:
    if norm_type == "layernorm":
        return LayerNorm(dim, eps, use_bias, elementwise_affine)
    if norm_type == "rmsnorm":
        return RMSNorm(dim, eps, elementwise_affine)
    raise ValueError(f"unknown norm_type {norm_type}")


class GlobalResponseNorm(nn.Module):
    """ConvNeXt-V2 GRN over NHWC maps: the norm is taken over the spatial
    axes (1, 2)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, 1, dim))

    def forward(self, x):
        gx = x.float().square().sum(dim=(1, 2), keepdim=True).sqrt()
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        dt = x.dtype
        return self.gamma.to(dt) * (x * nx.to(dt)) + self.beta.to(dt) + x


class AdaLNModulation(nn.Module):
    """x * (1 + scale) + shift with (scale | shift) = mapper(silu(cond)).
    ``precompute(cond)`` returns the mapped tensor, which is constant across
    decode steps; ``forward(x, cond, cached=...)`` then skips the matmul."""

    def __init__(self, cond_embed_dim: int, hidden_size: int, use_bias: bool = False):
        super().__init__()
        self.mapper = nn.Linear(cond_embed_dim, hidden_size * 2, bias=use_bias)

    def precompute(self, cond_embeds):
        return self.mapper(F.silu(cond_embeds))

    def forward(self, hidden_states, cond_embeds, cached=None):
        mapped = self.precompute(cond_embeds) if cached is None else cached
        scale, shift = mapped.chunk(2, dim=-1)
        shape = (scale.shape[0],) + (1,) * (hidden_states.dim() - 2) + (scale.shape[-1],)
        return hidden_states * (1 + scale.reshape(shape)) + shift.reshape(shape)


def sinusoidal_encode(features, embedding_dim: int, max_positions: float = 10000):
    """[cos | sin] sinusoidal features for micro-conditioning, fp32."""
    half_dim = embedding_dim // 2
    emb = math.log(max_positions) / half_dim
    emb = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=features.device) * -emb)
    emb = features.float()[:, None] * emb[None, :]
    emb = torch.cat([torch.cos(emb), torch.sin(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def dot_product_attention(query, key, value, scale: float | None = None, mask=None,
                          use_kernels: bool = True):
    """(B, T, H, D) attention: fp32 logits and softmax, probabilities cast
    to the value dtype before PV.  ``mask`` (broadcast to (B, H, Tq, Tk))
    marks logits replaced by the fp32 minimum.  ``use_kernels`` sends an
    unmasked call at the default scale to ``flash_attention``, as
    ``MUSE_TPU_PALLAS_ATTN=1`` does in JAX; masked calls stay here."""
    if mask is None and scale is None and use_kernels:
        return flash_attention(query, key, value)
    if scale is None:
        scale = 1.0 / math.sqrt(query.shape[-1])
    acc = torch.promote_types(query.dtype, torch.float32)
    logits = torch.einsum("bqhd,bkhd->bhqk", query.to(acc), key.to(acc)) * scale
    if mask is not None:
        logits = logits.masked_fill(mask, torch.finfo(torch.float32).min)
    weights = logits.softmax(dim=-1).to(value.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, value)


def column_linear(x, layer: nn.Linear, tp=None):
    """``layer(x)`` for a ``layer`` whose weight may be this rank's split of
    its output features (``tp``): its whole bias sliced to this rank's part.
    ``x`` is already this rank's input to the split (``copy_to_tp``)."""
    return F.linear(x, layer.weight, None if layer.bias is None else
                    scatter_to_tp(layer.bias, tp))


def row_linear(x, layer: nn.Linear, tp=None):
    """``layer(x)`` for a ``layer`` whose weight may be this rank's split of
    its input features (``tp``): the partial products summed over the ranks
    (``reduce_from_tp``), then the whole bias."""
    if tp is None:
        return F.linear(x, layer.weight, layer.bias)
    out = reduce_from_tp(F.linear(x, layer.weight), tp)
    return out if layer.bias is None else out + layer.bias


class Attention(nn.Module):
    """Multi-head self / cross attention with open-muse parameter names
    (query / key / value / out).  Self attention runs q, k and v as one
    matmul against the concatenated weights; cross attention takes the
    [k | v] projection of the context, which ``precompute_kv`` returns so a
    decode loop can compute it once.  Under tensor-parallel weights
    (``tp``, set by ``parallel.sharding.shard_params``) q / k / v hold this
    rank's heads and ``out`` their input features: the inputs enter through
    ``copy_to_tp``, the heads are the local ones, and the output is summed
    over the ranks."""

    tp_leaves = ("query.weight", "key.weight", "value.weight", "out.weight")
    tp = None
    head_multiple = 1  # a tp rank's head count must be a multiple of this, else no split

    def __init__(self, hidden_size: int, num_heads: int, context_dim: int | None = None,
                 use_bias: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        kv_in = context_dim or hidden_size
        self.query = nn.Linear(hidden_size, hidden_size, bias=use_bias)
        self.key = nn.Linear(kv_in, hidden_size, bias=use_bias)
        self.value = nn.Linear(kv_in, hidden_size, bias=use_bias)
        self.out = nn.Linear(hidden_size, hidden_size, bias=use_bias)

    def _cat(self, layers):
        weight = torch.cat([m.weight for m in layers], dim=0)
        bias = None if layers[0].bias is None else torch.cat(
            [scatter_to_tp(m.bias, self.tp) for m in layers])
        return weight, bias

    @property
    def local_heads(self) -> int:
        return self.num_heads if self.tp is None else self.num_heads // self.tp.size

    def qkv_weight(self):
        """(3I, D) [Wq | Wk | Wv] in nn.Linear layout (and the bias); I = D,
        or this rank's heads' width under tp."""
        return self._cat((self.query, self.key, self.value))

    def precompute_kv(self, context):
        """The (B, L, 2I) [k | v] projection of ``context``."""
        return F.linear(copy_to_tp(context, self.tp), *self._cat((self.key, self.value)))

    def forward(self, hidden_states, context=None, cached_kv=None, qkv_weight=None,
                attention_mask=None, use_kernels: bool = True):
        """``attention_mask`` (broadcast to (B, H, Tq, Tk), True = masked
        out) keeps the call on the plain path, as in JAX."""
        hidden_states = copy_to_tp(hidden_states, self.tp)
        if context is None and cached_kv is None:
            w, b = qkv_weight if qkv_weight is not None else self.qkv_weight()
            q, k, v = F.linear(hidden_states, w, b).chunk(3, dim=-1)
        else:
            q = column_linear(hidden_states, self.query, self.tp)
            kv = cached_kv if cached_kv is not None else self.precompute_kv(context)
            k, v = kv.chunk(2, dim=-1)
        bsz, q_len, _ = q.shape
        heads, hd = self.local_heads, self.hidden_size // self.num_heads
        attn = dot_product_attention(q.reshape(bsz, q_len, heads, hd),
                                     k.reshape(bsz, k.shape[1], heads, hd),
                                     v.reshape(bsz, v.shape[1], heads, hd),
                                     mask=attention_mask, use_kernels=use_kernels)
        return row_linear(attn.reshape(bsz, q_len, heads * hd), self.out, self.tp)
