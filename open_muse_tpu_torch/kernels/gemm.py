"""The Hopper GEMM (csrc/gemm_sm90.cuh) alone: ``a @ w.T`` or ``a @ w`` in
bf16 with an fp32 sum, through the TMA + ``wgmma`` mainloop that
``glu_down_matmul``, the attention sublayers and the self sublayer's
backward run inside their kernels; ``w`` is read as it lies, K-major for
``a @ w.T`` and MN-major for ``a @ w``.

It is no port of a TPU kernel and no path calls it: the CUDA tests hold the
mainloop against an fp32 product at ragged shapes, every tile width and K
split, and ``chip_smoke.py`` times it beside cuBLAS on the same operands.
On the CPU it is ``F.linear`` / ``torch.matmul``.  ``null_launch`` launches
an empty kernel, the floor under every launch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import on_cpu, require_cuda, stream_handle
from ._build import check, library

__all__ = ["linear_tn", "linear_nn", "linear_tn_plain", "linear_nn_plain", "null_launch",
           "TILE_WIDTHS", "SPLITS"]

TILE_WIDTHS = (64, 128, 256)
SPLITS = (1, 2, 4)


def linear_tn_plain(a, w):
    return F.linear(a, w)


def linear_nn_plain(a, w):
    return a @ w


def _gemm(name, a, w, tile_width, split, kn):
    k = a.shape[1] if a.dim() == 2 else -1
    if a.dim() != 2 or w.dim() != 2 or k != w.shape[0 if kn else 1]:
        raise ValueError(f"{name}: a{tuple(a.shape)} w{tuple(w.shape)}")
    if (tile_width not in (0, *TILE_WIDTHS) or split not in (0, *SPLITS)
            or (tile_width == 0) != (split == 0)):
        raise ValueError(f"{name}: tile_width {tile_width}, split {split}")
    if on_cpu(a, w):
        return linear_nn_plain(a, w) if kn else linear_tn_plain(a, w)
    require_cuda(name, (torch.bfloat16,), a, w)
    m, n = a.shape[0], w.shape[1 if kn else 0]
    if k % 8 or n % (8 if kn else 2):
        raise ValueError(f"{name}: K={k} must be a multiple of 8 and N={n} "
                         f"{'a multiple of 8' if kn else 'even'}")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    check(library().muse_gemm(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, tile_width,
                              split, int(kn), stream_handle(a)), name)
    return out


def linear_tn(a, w, tile_width: int = 0, split: int = 0):
    """a (M, K), w (N, K) -> a @ w.T (M, N) in a's dtype.  ``tile_width``
    (64, 128, 256) and ``split`` (1, 2, 4) pick the kernel's variant; both 0
    take the rule the kernels use."""
    return _gemm("linear_tn", a, w, tile_width, split, False)


def linear_nn(a, w, tile_width: int = 0, split: int = 0):
    """a (M, K), w (K, N) -> a @ w (M, N), w read MN-major (an nn.Linear
    weight (out, in) with K = out); variants as ``linear_tn``'s."""
    return _gemm("linear_nn", a, w, tile_width, split, True)


def null_launch(device, blocks: int = 1) -> None:
    """One launch of an empty kernel of ``blocks`` blocks on ``device``'s
    current stream."""
    check(library().muse_null(blocks, torch.cuda.current_stream(device).cuda_stream),
          "null_launch")
