"""Shared building blocks, the PyTorch counterparts of
``open_muse_tpu/ops/layers.py`` with the same precision staging.

Parameter names follow the open-muse torch modules (``weight`` / ``bias`` /
``gamma`` / ``beta``), so reference checkpoints load with ``load_state_dict``.

Where the JAX package sends a layer to a Pallas kernel, the port sends it to
the kernel's wrapper: ``RMSNorm`` to ``fused_residual_rmsnorm``, ``LayerNorm``
to ``fused_residual_layernorm`` and an unmasked ``dot_product_attention`` to
``flash_attention``; the wrappers are differentiable.  ``use_kernels=False``
takes the code below them instead: the XLA path's staging, which in fp32
computes what the kernels' plain versions do.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash_attention import flash_attention
from ..kernels.fused_norm import fused_residual_layernorm, fused_residual_rmsnorm

__all__ = ["RMSNorm", "LayerNorm", "Norm", "GlobalResponseNorm", "AdaLNModulation",
           "sinusoidal_encode", "dot_product_attention", "Attention"]


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
                self.weight, self.eps)
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
                self.weight, self.bias, self.eps)
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


class Attention(nn.Module):
    """Multi-head self / cross attention with open-muse parameter names
    (query / key / value / out).  Self attention runs q, k and v as one
    matmul against the concatenated weights; cross attention takes the
    [k | v] projection of the context, which ``precompute_kv`` returns so a
    decode loop can compute it once."""

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

    @staticmethod
    def _cat(layers):
        weight = torch.cat([m.weight for m in layers], dim=0)
        bias = None if layers[0].bias is None else torch.cat([m.bias for m in layers])
        return weight, bias

    def qkv_weight(self):
        """(3D, D) [Wq | Wk | Wv] in nn.Linear layout (and the bias)."""
        return self._cat((self.query, self.key, self.value))

    def precompute_kv(self, context):
        return F.linear(context, *self._cat((self.key, self.value)))

    def forward(self, hidden_states, context=None, cached_kv=None, qkv_weight=None,
                attention_mask=None, use_kernels: bool = True):
        """``attention_mask`` (broadcast to (B, H, Tq, Tk), True = masked
        out) keeps the call on the plain path, as in JAX."""
        if context is None and cached_kv is None:
            w, b = qkv_weight if qkv_weight is not None else self.qkv_weight()
            q, k, v = F.linear(hidden_states, w, b).chunk(3, dim=-1)
        else:
            q = self.query(hidden_states)
            kv = cached_kv if cached_kv is not None else self.precompute_kv(context)
            k, v = kv.chunk(2, dim=-1)
        bsz, q_len, _ = q.shape
        heads, hd = self.num_heads, self.hidden_size // self.num_heads
        attn = dot_product_attention(q.reshape(bsz, q_len, heads, hd),
                                     k.reshape(bsz, k.shape[1], heads, hd),
                                     v.reshape(bsz, v.shape[1], heads, hd),
                                     mask=attention_mask, use_kernels=use_kernels)
        return self.out(attn.reshape(bsz, q_len, self.hidden_size))
