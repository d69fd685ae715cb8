"""Fused trunk attention sublayers, forward (csrc/attn_sublayer.cu).

Counterparts of ``open_muse_tpu/ops/pallas/attn_sublayer.py``
``attn_sublayer_self`` and ``attn_sublayer_cross``; the plain versions are
``_xla_ref_self`` / ``_xla_ref_cross`` written in torch, with the same
precision staging as the unfused RMSNorm -> AdaLN -> Attention chain.
Weights follow torch's ``nn.Linear`` layout: ``wqkv`` is (3D, D), ``wq`` and
``wout`` are (D, D).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.layers import dot_product_attention
from . import on_cpu, require_cuda, stream_handle
from ._build import check, library

__all__ = ["attn_sublayer_self", "attn_sublayer_cross", "attn_sublayer_self_plain",
           "attn_sublayer_cross_plain", "sublayer_shapes_supported"]

HEAD_DIM = 64


def sublayer_shapes_supported(hidden: int, num_heads: int) -> bool:
    """The kernels take head_dim 64 in an even number of heads, as the TPU
    kernel does (attn_sublayer.py:157-184)."""
    return num_heads > 0 and num_heads % 2 == 0 and hidden == HEAD_DIM * num_heads


def _rmsnorm_adaln(x, res, ln_scale, adaln, eps):
    h = x + res
    var = h.float().square().mean(-1, keepdim=True)
    n = h * torch.rsqrt(var + eps).to(h.dtype)
    n = n * ln_scale.to(h.dtype)
    scale, shift = adaln.chunk(2, dim=-1)
    a = n * (1.0 + scale[:, None, :].to(h.dtype)) + shift[:, None, :].to(h.dtype)
    return h, a


def _heads(t, num_heads):
    b, s, d = t.shape
    return t.reshape(b, s, num_heads, d // num_heads)


def _attend(q, k, v, num_heads):
    b, s, d = q.shape
    out = dot_product_attention(_heads(q, num_heads), _heads(k, num_heads),
                                _heads(v, num_heads))
    return out.reshape(b, s, d)


def attn_sublayer_self_plain(x, res, ln_scale, adaln, wqkv, wout, num_heads, eps=1e-6):
    h, a = _rmsnorm_adaln(x, res, ln_scale, adaln, eps)
    q, k, v = F.linear(a, wqkv).chunk(3, dim=-1)
    return F.linear(_attend(q, k, v, num_heads), wout), h


def attn_sublayer_cross_plain(x, res, ln_scale, adaln, wq, wout, kv, num_heads, eps=1e-6):
    h, a = _rmsnorm_adaln(x, res, ln_scale, adaln, eps)
    k, v = kv.chunk(2, dim=-1)
    return F.linear(_attend(F.linear(a, wq), k, v, num_heads), wout), h


def _check(name, x, res, ln_scale, adaln, w_in, n_in, wout, num_heads):
    b, s, d = x.shape
    if (res is not None and res.shape != x.shape) or ln_scale.shape != (d,) \
            or adaln.shape != (b, 2 * d) or w_in.shape != (n_in, d) \
            or wout.shape != (d, d):
        raise ValueError(f"{name}: shape mismatch for x{tuple(x.shape)}")
    if not sublayer_shapes_supported(d, num_heads):
        raise ValueError(f"{name}: needs head_dim {HEAD_DIM} and an even head count, "
                         f"got hidden {d} with {num_heads} heads")


def _launch(name, x, res, ln_scale, adaln, w_in, wout, kv, num_heads, eps):
    b, s, d = x.shape
    n_in = w_in.shape[0]
    require_cuda(name, (torch.bfloat16,), x, res, ln_scale, adaln, w_in, wout, kv)
    h = torch.empty_like(x)
    out = torch.empty_like(x)
    a_buf = torch.empty_like(x)
    attn_buf = torch.empty_like(x)
    proj_buf = torch.empty((b, s, n_in), dtype=x.dtype, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    length = 0 if kv is None else kv.shape[1]
    check(library().muse_attn_sublayer(
        ptr(x), ptr(res), ptr(ln_scale), ptr(adaln), ptr(w_in), ptr(wout), ptr(kv),
        ptr(h), ptr(a_buf), ptr(proj_buf), ptr(attn_buf), ptr(out),
        b, s, d, num_heads, length, length, eps, stream_handle(x)), name)
    return out, h


def attn_sublayer_self(x, res, ln_scale, adaln, wqkv, wout, num_heads: int,
                       eps: float = 1e-6):
    """x, res (B, S, D); ln_scale (D,); adaln (B, 2D) mapped scale|shift;
    wqkv (3D, D); wout (D, D).  Returns (attention output, prenorm residual);
    ``res`` may be None (first trunk layer)."""
    _check("attn_sublayer_self", x, res, ln_scale, adaln, wqkv, 3 * x.shape[-1], wout,
           num_heads)
    if on_cpu(x, res, ln_scale, adaln, wqkv, wout):
        res = torch.zeros_like(x) if res is None else res
        return attn_sublayer_self_plain(x, res, ln_scale, adaln, wqkv, wout, num_heads, eps)
    result = _launch("attn_sublayer_self", x, res, ln_scale, adaln, wqkv, wout, None,
                     num_heads, eps)
    attn_sublayer_self.launches += 1
    return result


def attn_sublayer_cross(x, res, ln_scale, adaln, wq, wout, kv, num_heads: int,
                        eps: float = 1e-6):
    """Cross-attention variant: ``kv`` is the (B, L, 2D) [k|v] projection of
    the text context, computed once per request."""
    _check("attn_sublayer_cross", x, res, ln_scale, adaln, wq, x.shape[-1], wout, num_heads)
    if kv.shape[0] != x.shape[0] or kv.shape[2] != 2 * x.shape[-1]:
        raise ValueError(f"attn_sublayer_cross: kv{tuple(kv.shape)} vs x{tuple(x.shape)}")
    if on_cpu(x, res, ln_scale, adaln, wq, wout, kv):
        res = torch.zeros_like(x) if res is None else res
        return attn_sublayer_cross_plain(x, res, ln_scale, adaln, wq, wout, kv, num_heads,
                                         eps)
    result = _launch("attn_sublayer_cross", x, res, ln_scale, adaln, wq, wout, kv,
                     num_heads, eps)
    attn_sublayer_cross.launches += 1
    return result


attn_sublayer_self.launches = 0
attn_sublayer_cross.launches = 0
