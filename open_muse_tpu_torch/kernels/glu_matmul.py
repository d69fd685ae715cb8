"""GLU activation fused into the FFN down-projection (csrc/glu_matmul.cu).

Counterpart of ``open_muse_tpu/ops/pallas/glu_matmul.py glu_down_matmul``.
Weights follow torch's ``nn.Linear`` layout: ``wo`` is (N, K).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import on_cpu, require_cuda, stream_handle
from ._build import check, library

__all__ = ["glu_down_matmul", "glu_down_matmul_plain"]


def glu_down_matmul_plain(a, b, wo):
    """``(gelu_erf(a) * b) @ wo.T``: the GLU product in fp32, cast to wo's
    dtype, then a matmul cast to a's dtype."""
    hidden = (F.gelu(a.float(), approximate="none") * b.float()).to(wo.dtype)
    return F.linear(hidden, wo).to(a.dtype)


def glu_down_matmul(a, b, wo):
    """a, b (M, K), wo (N, K) -> (M, N) in a's dtype."""
    m, k = a.shape
    n = wo.shape[0]
    if b.shape != a.shape or wo.shape[1] != k:
        raise ValueError(f"shape mismatch: a{tuple(a.shape)} b{tuple(b.shape)} "
                         f"wo{tuple(wo.shape)}")
    if on_cpu(a, b, wo):
        return glu_down_matmul_plain(a, b, wo)
    require_cuda("glu_down_matmul", (torch.bfloat16,), a, b, wo)
    if k % 8 or n % 2:
        raise ValueError(f"glu_down_matmul: K={k} must be a multiple of 8 and N={n} even")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    check(library().muse_glu_down(a.data_ptr(), b.data_ptr(), wo.data_ptr(),
                                  out.data_ptr(), m, n, k, stream_handle(a)),
          "glu_down_matmul")
    glu_down_matmul.launches += 1
    return out


glu_down_matmul.launches = 0
