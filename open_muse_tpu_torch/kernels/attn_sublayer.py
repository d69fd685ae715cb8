"""Fused trunk attention sublayers, forward and backward (csrc/attn_sublayer.cu).

Counterparts of ``open_muse_tpu/ops/pallas/attn_sublayer.py``
``attn_sublayer_self`` and ``attn_sublayer_cross`` with their backward
kernels ``_self_bwd_pallas`` and ``_cross_bwd_pallas``.  The plain forward
versions are ``_xla_ref_self`` / ``_xla_ref_cross`` written in torch, with the
same precision staging as the unfused RMSNorm -> AdaLN -> Attention chain;
the plain backward versions compute what the Pallas backward bodies return.
Weights follow torch's ``nn.Linear`` layout: ``wqkv`` is (3I, D), ``wq`` is
(I, D) and ``wout`` (D, I), and so are their gradients, with I = 64 x the
head count: the model width D, or on a tensor-parallel rank the width of
its heads (``parallel.tensor_parallel``), where the outputs and the
backward's dx, d(ln) and d(adaln) are that rank's partial sums.

``attn_sublayer_self`` / ``attn_sublayer_cross`` are ``torch.autograd``
Functions: on the CPU both directions run the plain versions, on the card
both run the kernels.  Under CUDA autocast their inputs are cast to bf16, the
one type the kernels take.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import LaunchCounter, at_least_fp32, on_cpu, require_cuda, stream_handle
from ._build import check, library
from .flash_attention import flash_attention_plain, takes_two_pass

__all__ = ["attn_sublayer_self", "attn_sublayer_cross", "attn_sublayer_self_plain",
           "attn_sublayer_cross_plain", "attn_sublayer_self_bwd", "attn_sublayer_cross_bwd",
           "attn_sublayer_self_bwd_plain", "attn_sublayer_cross_bwd_plain",
           "attn_sublayer_two_pass", "attn_sublayer_bwd_long", "bwd_one_block",
           "bwd_stats_shape", "sublayer_shapes_supported"]

HEAD_DIM = 64
CHUNK_ROWS = 32  # rows per partial sum of d(adaln) and d(ln) in the kernel
# the long route's row statistics (csrc lng::kStatRows, lng::kStatFloats): a
# query tile's max, 1 / sum and D
STAT_ROWS, STATS = 64, 3
# the self and cross forwards whose attention (flash_attention.cu's launcher,
# called inside the chain) takes the two-pass variant: more than 288 keys,
# as the 512 px v2's 1024 tokens in the self sublayer
attn_sublayer_two_pass = LaunchCounter("attn_sublayer_two_pass")
# the self and cross backwards whose attention takes the long route (more than
# 288 queries or 256 keys: the rows and columns kernels, as the 512 px trunk's
# 1024 tokens) instead of the one-block wgmma kernel
attn_sublayer_bwd_long = LaunchCounter("attn_sublayer_bwd_long")


def bwd_one_block(queries: int, keys: int) -> bool:
    """Whether the backward's attention over ``queries`` and ``keys`` takes
    the one-block wgmma kernel, by the rule in csrc/attn_sublayer.cu (read
    from the built library: the rule lives in C alone)."""
    return bool(library().muse_attn_bwd_one_block(queries, keys))


def bwd_stats_shape(batch: int, heads: int, queries: int) -> tuple:
    """The long route's fp32 scratch between its two kernels: each (batch,
    head) pair's query tiles of STAT_ROWS rows, a tile's STATS rows of
    statistics (max, 1 / sum, D) one after the other, as the C launcher
    indexes them."""
    return batch, heads, -(-queries // STAT_ROWS), STATS, STAT_ROWS


def sublayer_shapes_supported(hidden: int, num_heads: int, tp: int = 1) -> bool:
    """The kernels take head_dim 64 in an even number of heads, as the TPU
    kernel does (attn_sublayer.py:157-184): ``num_heads`` of the model's
    ``hidden``, split over ``tp`` ranks, each rank's share of the heads."""
    local = num_heads // tp if num_heads % tp == 0 else 0
    return local > 0 and local % 2 == 0 and hidden == HEAD_DIM * num_heads


def _rmsnorm_adaln(x, res, ln_scale, adaln, eps):
    h = x + res
    var = at_least_fp32(h).square().mean(-1, keepdim=True)
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
    out = flash_attention_plain(_heads(q, num_heads), _heads(k, num_heads),
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


# -- plain backward: what the Pallas backward bodies compute ------------------

def _recompute(x, res, ln_scale, adaln, eps):
    """`_recompute_fwd`: the forward with the rmsnorm residuals kept."""
    h = x + res
    r = torch.rsqrt(at_least_fp32(h).square().mean(-1, keepdim=True) + eps)
    hhat = h * r.to(h.dtype)
    scale, shift = adaln.chunk(2, dim=-1)
    a = (hhat * ln_scale.to(h.dtype)) * (1.0 + scale[:, None, :].to(h.dtype)) \
        + shift[:, None, :].to(h.dtype)
    return hhat, r, a


def _attention_bwd(q, k, v, dattn, num_heads):
    """`_heads_attention_bwd`: the forward output and dq, dk, dv; fp32
    logits, softmax and dp, bf16-cast probabilities and dl."""
    dt = q.dtype
    qh, kh, vh, doh = (_heads(t, num_heads) for t in (q, k, v, dattn))
    scale = 1.0 / math.sqrt(qh.shape[-1])
    pf = (torch.einsum("bqhd,bkhd->bhqk", at_least_fp32(qh), at_least_fp32(kh)) * scale
          ).softmax(dim=-1)
    pb = pf.to(dt)
    out = torch.einsum("bhqk,bkhd->bqhd", pb, vh)
    dv = torch.einsum("bhqk,bqhd->bkhd", pb, doh)
    dp = torch.einsum("bqhd,bkhd->bhqk", at_least_fp32(doh), at_least_fp32(vh))
    dl = (pf * (dp - (dp * pf).sum(-1, keepdim=True)) * scale).to(dt)
    dq = torch.einsum("bhqk,bkhd->bqhd", dl, kh)
    dk = torch.einsum("bhqk,bqhd->bkhd", dl, qh)
    flat = lambda t: t.reshape(t.shape[0], t.shape[1], -1)  # noqa: E731
    return flat(out), flat(dq), flat(dk), flat(dv)


def _rms_adaln_bwd(da, hhat, r, ln_scale, adaln, g_res):
    """`_rms_adaln_bwd`: AdaLN -> affine rmsnorm -> residual; returns
    (dx, dln, dadaln)."""
    d = hhat.shape[-1]
    a_scale = at_least_fp32(adaln[:, :d])[:, None, :]
    n2 = at_least_fp32(hhat * ln_scale.to(hhat.dtype))
    da_f = at_least_fp32(da)
    dadaln = torch.cat([(da_f * n2).sum(1), da_f.sum(1)], dim=-1).to(adaln.dtype)
    dn2 = da_f * (1.0 + a_scale)
    hhat_f = at_least_fp32(hhat)
    dln = (dn2 * hhat_f).sum(1).sum(0).to(ln_scale.dtype)
    dn = dn2 * at_least_fp32(ln_scale)
    dh = r * (dn - hhat_f * (dn * hhat_f).mean(-1, keepdim=True))
    dx = (dh.to(hhat.dtype) + g_res).to(hhat.dtype)
    return dx, dln, dadaln


def _weight_grad(g, act):
    """(g^T act) over every row, in the activations' dtype: the XLA einsums
    JAX runs outside its kernels (attn_sublayer.py:628-633)."""
    return g.reshape(-1, g.shape[-1]).t() @ act.reshape(-1, act.shape[-1])


def attn_sublayer_self_bwd_plain(x, res, ln_scale, adaln, wqkv, wout, g_out, g_res,
                                 num_heads, eps=1e-6):
    """(dx, dres, dln, dadaln, dwqkv, dwout) as `_self_bwd_pallas` returns
    them (dres is dx); weight gradients in nn.Linear layout."""
    hhat, r, a = _recompute(x, res, ln_scale, adaln, eps)
    q, k, v = F.linear(a, wqkv).chunk(3, dim=-1)
    dattn = g_out @ wout
    out, dq, dk, dv = _attention_bwd(q, k, v, dattn, num_heads)
    dqkv = torch.cat([dq, dk, dv], dim=-1)
    dx, dln, dadaln = _rms_adaln_bwd(dqkv @ wqkv, hhat, r, ln_scale, adaln, g_res)
    return (dx, dx, dln, dadaln, _weight_grad(dqkv, a).to(wqkv.dtype),
            _weight_grad(g_out, out).to(wout.dtype))


def attn_sublayer_cross_bwd_plain(x, res, ln_scale, adaln, wq, wout, kv, g_out, g_res,
                                  num_heads, eps=1e-6):
    """(dx, dres, dln, dadaln, dwq, dwout, dkv) as `_cross_bwd_pallas`
    returns them, for an unpadded kv (every key valid)."""
    hhat, r, a = _recompute(x, res, ln_scale, adaln, eps)
    k, v = kv.chunk(2, dim=-1)
    dattn = g_out @ wout
    out, dq, dk, dv = _attention_bwd(F.linear(a, wq), k, v, dattn, num_heads)
    dx, dln, dadaln = _rms_adaln_bwd(dq @ wq, hhat, r, ln_scale, adaln, g_res)
    return (dx, dx, dln, dadaln, _weight_grad(dq, a).to(wq.dtype),
            _weight_grad(g_out, out).to(wout.dtype), torch.cat([dk, dv], dim=-1))


# -- checks and launches -------------------------------------------------------

def _check(name, x, res, ln_scale, adaln, w_in, n_in, wout, num_heads, kv=None, grads=()):
    """``n_in``: the in-projection's rows in units of the inner width (3 for
    qkv, 1 for q)."""
    b, s, d = x.shape
    inner = HEAD_DIM * num_heads
    if num_heads <= 0 or num_heads % 2:
        raise ValueError(f"{name}: needs head_dim {HEAD_DIM} and an even head count, "
                         f"got {num_heads} heads")
    if (res is not None and res.shape != x.shape) or ln_scale.shape != (d,) \
            or adaln.shape != (b, 2 * d) or w_in.shape != (n_in * inner, d) \
            or wout.shape != (d, inner) or any(g.shape != x.shape for g in grads):
        raise ValueError(f"{name}: shape mismatch for x{tuple(x.shape)} with {num_heads} "
                         f"heads of {HEAD_DIM}: w_in{tuple(w_in.shape)} wout{tuple(wout.shape)}")
    if kv is not None and (kv.dim() != 3 or kv.shape[0] != b or kv.shape[2] != 2 * inner):
        raise ValueError(f"{name}: kv{tuple(kv.shape)} vs x{tuple(x.shape)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name, x, res, ln_scale, adaln, w_in, wout, kv, num_heads, eps):
    b, s, d = x.shape
    n_in, inner = w_in.shape[0], wout.shape[1]
    require_cuda(name, (torch.bfloat16,), x, res, ln_scale, adaln, w_in, wout, kv)
    h = torch.empty_like(x)
    out = torch.empty_like(x)
    a_buf = torch.empty_like(x)
    attn_buf = torch.empty((b, s, inner), dtype=x.dtype, device=x.device)
    proj_buf = torch.empty((b, s, n_in), dtype=x.dtype, device=x.device)
    length = 0 if kv is None else kv.shape[1]
    check(library().muse_attn_sublayer(
        _ptr(x), _ptr(res), _ptr(ln_scale), _ptr(adaln), _ptr(w_in), _ptr(wout), _ptr(kv),
        _ptr(h), _ptr(a_buf), _ptr(proj_buf), _ptr(attn_buf), _ptr(out),
        b, s, d, num_heads, length, length, eps, stream_handle(x)), name)
    return out, h


def _launch_bwd(name, x, res, ln_scale, adaln, w_in, wout, kv, g_out, g_res, num_heads, eps):
    """Returns (dx, dln, dadaln, a, dproj, attn, dkv) from the kernel chain."""
    b, s, d = x.shape
    n_in, inner = w_in.shape[0], wout.shape[1]
    require_cuda(name, (torch.bfloat16,), x, res, ln_scale, adaln, w_in, wout, kv, g_out, g_res)
    new = lambda *shape, dtype=x.dtype: torch.empty(shape, dtype=dtype, device=x.device)  # noqa: E731
    dx, a, attn = new(b, s, d), new(b, s, d), new(b, s, inner)
    dadaln, dln, dproj = new(b, 2 * d), new(d), new(b, s, n_in)
    dkv = None if kv is None else torch.empty_like(kv)
    # dattn (B, S, I), then da (B, S, D) in the same buffer
    h, proj, dattn = new(b, s, d), new(b, s, n_in), new(b, s, max(d, inner))
    rstd = new(b * s, dtype=torch.float32)
    partial = new(b * -(-s // CHUNK_ROWS) * 3 * d, dtype=torch.float32)
    length = 0 if kv is None else kv.shape[1]
    stats = None  # the long route's row statistics, through device memory
    if not bwd_one_block(s, length or s):
        stats = new(*bwd_stats_shape(b, num_heads, s), dtype=torch.float32)
        attn_sublayer_bwd_long.launches += 1
    check(library().muse_attn_sublayer_bwd(
        _ptr(x), _ptr(res), _ptr(ln_scale), _ptr(adaln), _ptr(w_in), _ptr(wout), _ptr(kv),
        _ptr(g_out), _ptr(g_res), _ptr(dx), _ptr(dadaln), _ptr(dln), _ptr(a), _ptr(dproj),
        _ptr(attn), _ptr(dkv), _ptr(h), _ptr(proj), _ptr(dattn), _ptr(stats), _ptr(rstd),
        _ptr(partial), b, s, d, num_heads, length, length, eps, stream_handle(x)), name)
    return dx, dln, dadaln, a, dproj, attn, dkv


# -- backward wrappers ----------------------------------------------------------

def attn_sublayer_self_bwd(x, res, ln_scale, adaln, wqkv, wout, g_out, g_res,
                           num_heads: int, eps: float = 1e-6):
    """Backward of `attn_sublayer_self` given the gradients of (out, h):
    (dx, dres, dln, dadaln, dwqkv, dwout); ``res`` may be None (zeros)."""
    _check("attn_sublayer_self_bwd", x, res, ln_scale, adaln, wqkv, 3, wout, num_heads,
           grads=(g_out, g_res))
    if on_cpu(x, res, ln_scale, adaln, wqkv, wout, g_out, g_res):
        res = torch.zeros_like(x) if res is None else res
        return attn_sublayer_self_bwd_plain(x, res, ln_scale, adaln, wqkv, wout, g_out, g_res,
                                            num_heads, eps)
    dx, dln, dadaln, a, dqkv, attn, _ = _launch_bwd(
        "attn_sublayer_self_bwd", x, res, ln_scale, adaln, wqkv, wout, None, g_out, g_res,
        num_heads, eps)
    attn_sublayer_self_bwd.launches += 1
    return dx, dx, dln, dadaln, _weight_grad(dqkv, a), _weight_grad(g_out, attn)


def attn_sublayer_cross_bwd(x, res, ln_scale, adaln, wq, wout, kv, g_out, g_res,
                            num_heads: int, eps: float = 1e-6):
    """Backward of `attn_sublayer_cross`: (dx, dres, dln, dadaln, dwq, dwout,
    dkv).  Keys are not padded: the kernels mask past the key length."""
    _check("attn_sublayer_cross_bwd", x, res, ln_scale, adaln, wq, 1, wout, num_heads, kv=kv,
           grads=(g_out, g_res))
    if on_cpu(x, res, ln_scale, adaln, wq, wout, kv, g_out, g_res):
        res = torch.zeros_like(x) if res is None else res
        return attn_sublayer_cross_bwd_plain(x, res, ln_scale, adaln, wq, wout, kv, g_out,
                                             g_res, num_heads, eps)
    dx, dln, dadaln, a, dq, attn, dkv = _launch_bwd(
        "attn_sublayer_cross_bwd", x, res, ln_scale, adaln, wq, wout, kv, g_out, g_res,
        num_heads, eps)
    attn_sublayer_cross_bwd.launches += 1
    return dx, dx, dln, dadaln, _weight_grad(dq, a), _weight_grad(g_out, attn), dkv


# -- forward wrappers (autograd Functions) ---------------------------------------

def _self_forward(x, res, ln_scale, adaln, wqkv, wout, num_heads, eps):
    if on_cpu(x, res, ln_scale, adaln, wqkv, wout):
        res = torch.zeros_like(x) if res is None else res
        return attn_sublayer_self_plain(x, res, ln_scale, adaln, wqkv, wout, num_heads, eps)
    result = _launch("attn_sublayer_self", x, res, ln_scale, adaln, wqkv, wout, None,
                     num_heads, eps)
    attn_sublayer_self.launches += 1
    _count_two_pass(x.shape[1])
    return result


def _cross_forward(x, res, ln_scale, adaln, wq, wout, kv, num_heads, eps):
    if on_cpu(x, res, ln_scale, adaln, wq, wout, kv):
        res = torch.zeros_like(x) if res is None else res
        return attn_sublayer_cross_plain(x, res, ln_scale, adaln, wq, wout, kv, num_heads, eps)
    result = _launch("attn_sublayer_cross", x, res, ln_scale, adaln, wq, wout, kv, num_heads,
                     eps)
    attn_sublayer_cross.launches += 1
    _count_two_pass(kv.shape[1])
    return result


def _count_two_pass(keys):
    if takes_two_pass(keys):
        attn_sublayer_two_pass.launches += 1


def _tp_forward(out, tp):
    """On a head shard the out projection is this rank's partial sum: the
    whole output is the sum over the tp ranks."""
    if tp is not None:
        tp.all_reduce_([out])
    return out


def _tp_backward(g_res, tp):
    """The residual-gradient rule of a head shard (trap 1 of the
    tensor-parallel port).  The backward's dx is d(norm path) + g_res: the
    norm path's part is this rank's partial sum, g_res is already whole on
    every rank, and so are d(ln) and d(adaln) partial.  The rank of tp index
    0 alone adds g_res, the others 0, so that summing dx, d(ln) and d(adaln)
    over the ranks (``_tp_sum``) counts g_res once."""
    if tp is None or tp.rank == 0:
        return g_res
    return torch.zeros_like(g_res)


def _tp_sum(tp, *grads):
    if tp is not None:
        tp.all_reduce_(list(grads))
    return grads


class _SelfSublayer(torch.autograd.Function):
    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, x, res, ln_scale, adaln, wqkv, wout, num_heads, eps, tp):
        ctx.num_heads, ctx.eps, ctx.has_res, ctx.tp = num_heads, eps, res is not None, tp
        ctx.save_for_backward(x, res, ln_scale, adaln, wqkv, wout)
        out, h = _self_forward(x, res, ln_scale, adaln, wqkv, wout, num_heads, eps)
        return _tp_forward(out, tp), h

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g_out, g_res):
        x, res, ln_scale, adaln, wqkv, wout = ctx.saved_tensors
        dx, dres, dln, dadaln, dwqkv, dwout = attn_sublayer_self_bwd(
            x, res, ln_scale, adaln, wqkv, wout, g_out.contiguous(),
            _tp_backward(g_res.contiguous(), ctx.tp), ctx.num_heads, ctx.eps)
        dx, dln, dadaln = _tp_sum(ctx.tp, dx, dln, dadaln)
        return (dx, dx if ctx.has_res else None, dln, dadaln, dwqkv, dwout, None, None, None)


class _CrossSublayer(torch.autograd.Function):
    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, x, res, ln_scale, adaln, wq, wout, kv, num_heads, eps, tp):
        ctx.num_heads, ctx.eps, ctx.has_res, ctx.tp = num_heads, eps, res is not None, tp
        ctx.save_for_backward(x, res, ln_scale, adaln, wq, wout, kv)
        out, h = _cross_forward(x, res, ln_scale, adaln, wq, wout, kv, num_heads, eps)
        return _tp_forward(out, tp), h

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g_out, g_res):
        x, res, ln_scale, adaln, wq, wout, kv = ctx.saved_tensors
        dx, dres, dln, dadaln, dwq, dwout, dkv = attn_sublayer_cross_bwd(
            x, res, ln_scale, adaln, wq, wout, kv, g_out.contiguous(),
            _tp_backward(g_res.contiguous(), ctx.tp), ctx.num_heads, ctx.eps)
        dx, dln, dadaln = _tp_sum(ctx.tp, dx, dln, dadaln)
        return (dx, dx if ctx.has_res else None, dln, dadaln, dwq, dwout, dkv, None, None,
                None)


def attn_sublayer_self(x, res, ln_scale, adaln, wqkv, wout, num_heads: int,
                       eps: float = 1e-6, tp=None):
    """x, res (B, S, D); ln_scale (D,); adaln (B, 2D) mapped scale|shift;
    wqkv (3I, D); wout (D, I), I = 64 ``num_heads``.  Returns (attention
    output, prenorm residual); ``res`` may be None (first trunk layer).
    Differentiable.  ``tp`` (``parallel.tensor_parallel.TensorParallel``):
    the weights are this rank's head shard; the output is summed over the
    ranks, and so are the backward's dx, d(ln) and d(adaln)."""
    _check("attn_sublayer_self", x, res, ln_scale, adaln, wqkv, 3, wout, num_heads)
    return _SelfSublayer.apply(x, res, ln_scale, adaln, wqkv, wout, num_heads, eps, tp)


def attn_sublayer_cross(x, res, ln_scale, adaln, wq, wout, kv, num_heads: int,
                        eps: float = 1e-6, tp=None):
    """Cross-attention variant: ``wq`` (I, D); ``kv`` is the (B, L, 2I) [k|v]
    projection of the text context.  Differentiable, also in ``kv``; ``tp``
    as in ``attn_sublayer_self`` (``kv`` is then this rank's heads')."""
    _check("attn_sublayer_cross", x, res, ln_scale, adaln, wq, 1, wout, num_heads, kv=kv)
    return _CrossSublayer.apply(x, res, ln_scale, adaln, wq, wout, kv, num_heads, eps, tp)


attn_sublayer_self.launches = 0
attn_sublayer_cross.launches = 0
attn_sublayer_self_bwd.launches = 0
attn_sublayer_cross_bwd.launches = 0
