"""GLU activation fused into the FFN down-projection, forward and backward
(csrc/glu_matmul.cu).

Counterpart of ``open_muse_tpu/ops/pallas/glu_matmul.py glu_down_matmul``
and of its backward kernel ``_bwd_pallas``.  Weights follow torch's
``nn.Linear`` layout: ``wo`` is (N, K), and so is its gradient.
``glu_down_matmul`` is a ``torch.autograd.Function``: on the CPU both
directions run the plain versions, on the card both run the kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import at_least_fp32, on_cpu, require_cuda, stream_handle
from ._build import check, library

__all__ = ["glu_down_matmul", "glu_down_matmul_plain", "glu_down_matmul_bwd",
           "glu_down_matmul_bwd_plain"]


def glu_down_matmul_plain(a, b, wo):
    """``(gelu_erf(a) * b) @ wo.T``: the GLU product in fp32, cast to wo's
    dtype, then a matmul cast to a's dtype."""
    hidden = (F.gelu(at_least_fp32(a), approximate="none") * at_least_fp32(b)).to(wo.dtype)
    return F.linear(hidden, wo).to(a.dtype)


def glu_down_matmul_bwd_plain(a, b, wo, g):
    """(da, db, dwo) as JAX's plain backward expression returns them
    (glu_matmul.py:253-264), dwo in nn.Linear layout (N, K)."""
    af, bf = at_least_fp32(a), at_least_fp32(b)
    gelu_a = F.gelu(af, approximate="none")
    hidden = (gelu_a * bf).to(wo.dtype)
    dwo = (g.to(wo.dtype).t() @ hidden).to(wo.dtype)
    dh = at_least_fp32(g @ wo)
    # d/dx gelu(x) = Phi(x) + x * phi(x)
    dgelu = (0.5 * (1.0 + torch.erf(af * 0.7071067811865476))
             + af * torch.exp(-0.5 * af * af) * 0.3989422804014327)
    return (dh * bf * dgelu).to(a.dtype), (dh * gelu_a).to(b.dtype), dwo


def _check(a, b, wo, g=None):
    m, k = a.shape
    n = wo.shape[0]
    if b.shape != a.shape or wo.shape[1] != k or (g is not None and g.shape != (m, n)):
        raise ValueError(f"shape mismatch: a{tuple(a.shape)} b{tuple(b.shape)} "
                         f"wo{tuple(wo.shape)}" + ("" if g is None else f" g{tuple(g.shape)}"))


def glu_down_matmul_bwd(a, b, wo, g):
    """Backward of `glu_down_matmul` given the output gradient g (M, N):
    (da, db, dwo)."""
    _check(a, b, wo, g)
    if on_cpu(a, b, wo, g):
        return glu_down_matmul_bwd_plain(a, b, wo, g)
    require_cuda("glu_down_matmul_bwd", (torch.bfloat16,), a, b, wo, g)
    m, k = a.shape
    n = wo.shape[0]
    if k % 8 or n % 8:
        raise ValueError(f"glu_down_matmul_bwd: K={k} and N={n} must be multiples of 8")
    da, db, dwo = torch.empty_like(a), torch.empty_like(b), torch.empty_like(wo)
    hidden = torch.empty_like(a)  # bf16(gelu(a) * b): the dh launch writes it, dwo's reads it
    check(library().muse_glu_down_bwd(a.data_ptr(), b.data_ptr(), wo.data_ptr(), g.data_ptr(),
                                      da.data_ptr(), db.data_ptr(), dwo.data_ptr(),
                                      hidden.data_ptr(), m, n, k, stream_handle(a)),
          "glu_down_matmul_bwd")
    glu_down_matmul_bwd.launches += 1
    return da, db, dwo


def _forward(a, b, wo):
    if on_cpu(a, b, wo):
        return glu_down_matmul_plain(a, b, wo)
    require_cuda("glu_down_matmul", (torch.bfloat16,), a, b, wo)
    m, k = a.shape
    n = wo.shape[0]
    if k % 8 or n % 2:
        raise ValueError(f"glu_down_matmul: K={k} must be a multiple of 8 and N={n} even")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    hidden = torch.empty_like(a)  # the kernel's scratch for bf16(gelu(a) * b)
    check(library().muse_glu_down(a.data_ptr(), b.data_ptr(), wo.data_ptr(), hidden.data_ptr(),
                                  out.data_ptr(), m, n, k, stream_handle(a)),
          "glu_down_matmul")
    glu_down_matmul.launches += 1
    return out


class _GluDown(torch.autograd.Function):
    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, a, b, wo):
        ctx.save_for_backward(a, b, wo)
        return _forward(a, b, wo)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        return glu_down_matmul_bwd(*ctx.saved_tensors, g.contiguous())


def glu_down_matmul(a, b, wo):
    """a, b (M, K), wo (N, K) -> (M, N) in a's dtype.  Differentiable."""
    _check(a, b, wo)
    return _GluDown.apply(a, b, wo)


glu_down_matmul.launches = 0
glu_down_matmul_bwd.launches = 0
