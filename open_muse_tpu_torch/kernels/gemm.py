"""The Hopper GEMM (csrc/gemm_sm90.cuh) alone: ``a @ w.T`` in bf16 with an
fp32 sum, through the TMA + ``wgmma`` mainloop that ``glu_down_matmul`` and
``attn_sublayer_self`` run inside their kernels.

It is no port of a TPU kernel and no path calls it: the CUDA tests hold the
mainloop against ``F.linear`` at ragged shapes, every tile width and K split,
and ``chip_smoke.py`` times it beside cuBLAS on the same operands.  On the
CPU it is ``F.linear``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import on_cpu, require_cuda, stream_handle
from ._build import check, library

__all__ = ["linear_tn", "linear_tn_plain", "TILE_WIDTHS", "SPLITS"]

TILE_WIDTHS = (64, 128, 256)
SPLITS = (1, 2, 4)


def linear_tn_plain(a, w):
    return F.linear(a, w)


def linear_tn(a, w, tile_width: int = 0, split: int = 0):
    """a (M, K), w (N, K) -> (M, N) in a's dtype.  ``tile_width`` (64, 128,
    256) and ``split`` (1, 2, 4) pick the kernel's variant; both 0 take the
    rule the kernels use."""
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1]:
        raise ValueError(f"linear_tn: a{tuple(a.shape)} w{tuple(w.shape)}")
    if (tile_width not in (0, *TILE_WIDTHS) or split not in (0, *SPLITS)
            or (tile_width == 0) != (split == 0)):
        raise ValueError(f"linear_tn: tile_width {tile_width}, split {split}")
    if on_cpu(a, w):
        return linear_tn_plain(a, w)
    require_cuda("linear_tn", (torch.bfloat16,), a, w)
    (m, k), n = a.shape, w.shape[0]
    if k % 8 or n % 2:
        raise ValueError(f"linear_tn: K={k} must be a multiple of 8 and N={n} even")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    check(library().muse_gemm_tn(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, tile_width,
                                 split, stream_handle(a)), "linear_tn")
    return out
