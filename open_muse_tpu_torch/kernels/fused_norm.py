"""Residual add + RMSNorm / LayerNorm in one pass (csrc/fused_norm.cu).

Counterparts of ``open_muse_tpu/ops/pallas/fused_norm.py``
``fused_residual_rmsnorm`` and ``fused_residual_layernorm``: ``(x, residual
| None, scale, [bias,] eps) -> (normed, prenorm)`` over the last axis, any
width.  The sum, the moments and the affine are fp32 and the output is cast
once, as in the TPU kernels' ``_rms_kernel`` / ``_ln_kernel``.  Without a
residual the prenorm output is ``x`` itself, not a copy.

Both wrappers are ``torch.autograd.Function``s:
  * CPU tensors: the plain version;
  * CUDA tensors: the kernel (x, residual, scale and bias bf16, contiguous,
    16-byte aligned; under CUDA autocast they are cast to bf16 first), or a
    raise.
The TPU kernels have no VJP (JAX enables them for inference only,
``ops/layers.py:30-37``), so neither has a backward kernel: the backward
recomputes the plain version from the saved inputs and takes its gradient.
"""

from __future__ import annotations

import torch

from . import at_least_fp32, on_cpu, plain_vjp, require_cuda, stream_handle
from ._build import check, library

__all__ = ["fused_residual_rmsnorm", "fused_residual_rmsnorm_plain",
           "fused_residual_layernorm", "fused_residual_layernorm_plain"]


def _prenorm(x, residual):
    """(fp32 sum, prenorm output): x itself without a residual."""
    h = at_least_fp32(x)
    if residual is None:
        return h, x
    h = h + at_least_fp32(residual)
    return h, h.to(x.dtype)


def _affine(y, scale, bias, dtype):
    if scale is not None:
        y = y * at_least_fp32(scale)
    if bias is not None:
        y = y + at_least_fp32(bias)
    return y.to(dtype)


def fused_residual_rmsnorm_plain(x, residual, scale, eps: float = 1e-6):
    h, prenorm = _prenorm(x, residual)
    var = h.square().mean(-1, keepdim=True)
    return _affine(h * torch.rsqrt(var + eps), scale, None, x.dtype), prenorm


def fused_residual_layernorm_plain(x, residual, scale, bias, eps: float = 1e-5):
    h, prenorm = _prenorm(x, residual)
    centred = h - h.mean(-1, keepdim=True)
    var = centred.square().mean(-1, keepdim=True)
    return _affine(centred * torch.rsqrt(var + eps), scale, bias, x.dtype), prenorm


def _plain(layer_norm: bool, eps: float, x, residual, scale, bias):
    """The plain version as the Function returns it: normed, and the prenorm
    sum only with a residual."""
    if layer_norm:
        out, prenorm = fused_residual_layernorm_plain(x, residual, scale, bias, eps)
    else:
        out, prenorm = fused_residual_rmsnorm_plain(x, residual, scale, eps)
    return out if residual is None else (out, prenorm)


def _forward(layer_norm: bool, eps: float, x, residual, scale, bias):
    if on_cpu(x, residual, scale, bias):
        return _plain(layer_norm, eps, x, residual, scale, bias)
    wrapper = fused_residual_layernorm if layer_norm else fused_residual_rmsnorm
    name = wrapper.__name__
    require_cuda(name, (torch.bfloat16,), x, residual, scale, bias)
    d = x.shape[-1]
    out = torch.empty_like(x)
    prenorm = None if residual is None else torch.empty_like(x)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    check(library().muse_fused_norm(
        x.data_ptr(), ptr(residual), ptr(scale), ptr(bias), out.data_ptr(), ptr(prenorm),
        x.numel() // d, d, float(eps), int(layer_norm), stream_handle(x)), name)
    wrapper.launches += 1
    return out if residual is None else (out, prenorm)


class _FusedNorm(torch.autograd.Function):
    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, layer_norm, eps, x, residual, scale, bias):
        ctx.layer_norm, ctx.eps = layer_norm, eps
        ctx.save_for_backward(x, residual, scale, bias)
        return _forward(layer_norm, eps, x, residual, scale, bias)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, *grads):
        plain = lambda *t: _plain(ctx.layer_norm, ctx.eps, *t)  # noqa: E731
        return (None, None,
                *plain_vjp(plain, ctx.saved_tensors, grads, ctx.needs_input_grad[2:]))


def _run(wrapper, layer_norm: bool, x, residual, scale, bias, eps):
    d = x.shape[-1]
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"{wrapper.__name__}: residual {tuple(residual.shape)} vs x "
                         f"{tuple(x.shape)}")
    for p in (scale, bias):
        if p is not None and tuple(p.shape) != (d,):
            raise ValueError(f"{wrapper.__name__}: scale / bias {tuple(p.shape)} vs width {d}")
    result = _FusedNorm.apply(layer_norm, eps, x, residual, scale, bias)
    return (result, x) if residual is None else result


def fused_residual_rmsnorm(x, residual, scale, eps: float = 1e-6):
    """x (..., D), residual like x or None, scale (D,) or None ->
    (normed, prenorm) in x's dtype.  Differentiable."""
    return _run(fused_residual_rmsnorm, False, x, residual, scale, None, eps)


def fused_residual_layernorm(x, residual, scale, bias, eps: float = 1e-5):
    """x (..., D), residual like x or None, scale and bias (D,) or None ->
    (normed, prenorm) in x's dtype.  Differentiable."""
    return _run(fused_residual_layernorm, True, x, residual, scale, bias, eps)


fused_residual_rmsnorm.launches = 0
fused_residual_layernorm.launches = 0
