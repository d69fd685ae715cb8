"""The Hopper GEMM (csrc/gemm_sm90.cuh) alone: ``a @ w.T``, ``a @ w`` or
``a_t.T @ w`` in bf16 with an fp32 sum, through the TMA + ``wgmma`` mainloop
that the GLU down-projection, the attention sublayers and their backwards
run inside their kernels; both operands are read as they lie, ``w``
K-major for ``a @ w.T`` and MN-major for the other two, ``a_t`` MN-major
(the ``g`` of a weight gradient ``g.T @ h``).

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

__all__ = ["linear_tn", "linear_nn", "linear_tnn", "linear_tn_plain", "linear_nn_plain",
           "linear_tnn_plain", "null_launch", "TILE_WIDTHS", "SPLITS"]

TILE_WIDTHS = (64, 128, 256)
SPLITS = (1, 2, 4)


def linear_tn_plain(a, w):
    return F.linear(a, w)


def linear_nn_plain(a, w):
    return a @ w


def linear_tnn_plain(a_t, w):
    return a_t.t() @ w


# the layouts as csrc/gemm_sm90.cu numbers them, and their plain versions
_TN, _NN, _TNN = 0, 1, 2
_PLAIN = {_TN: linear_tn_plain, _NN: linear_nn_plain, _TNN: linear_tnn_plain}


def _gemm(name, a, w, tile_width, split, layout):
    if a.dim() != 2 or w.dim() != 2 or a.shape[layout != _TNN] != w.shape[layout == _TN]:
        raise ValueError(f"{name}: a{tuple(a.shape)} w{tuple(w.shape)}")
    if (tile_width not in (0, *TILE_WIDTHS) or split not in (0, *SPLITS)
            or (tile_width == 0) != (split == 0)):
        raise ValueError(f"{name}: tile_width {tile_width}, split {split}")
    if on_cpu(a, w):
        return _PLAIN[layout](a, w)
    require_cuda(name, (torch.bfloat16,), a, w)
    m, k = (a.shape[1], a.shape[0]) if layout == _TNN else a.shape
    n = w.shape[0 if layout == _TN else 1]
    # each operand's row pitch a multiple of 16 bytes (its tensor map), N even
    pitches = {_TN: (k, k), _NN: (k, n), _TNN: (m, n)}[layout]
    if any(p % 8 for p in pitches) or n % 2:
        raise ValueError(f"{name}: (M, N, K) = ({m}, {n}, {k}) needs the row lengths "
                         f"{pitches} of its operands multiples of 8 and N even")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    check(library().muse_gemm(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, tile_width,
                              split, layout, stream_handle(a)), name)
    return out


def linear_tn(a, w, tile_width: int = 0, split: int = 0):
    """a (M, K), w (N, K) -> a @ w.T (M, N) in a's dtype.  ``tile_width``
    (64, 128, 256) and ``split`` (1, 2, 4) pick the kernel's variant; both 0
    take the rule the kernels use."""
    return _gemm("linear_tn", a, w, tile_width, split, _TN)


def linear_nn(a, w, tile_width: int = 0, split: int = 0):
    """a (M, K), w (K, N) -> a @ w (M, N), w read MN-major (an nn.Linear
    weight (out, in) with K = out); variants as ``linear_tn``'s."""
    return _gemm("linear_nn", a, w, tile_width, split, _NN)


def linear_tnn(a_t, w, tile_width: int = 0, split: int = 0):
    """a_t (K, M), w (K, N) -> a_t.T @ w (M, N), both read MN-major (a
    weight gradient summed over the rows of both); variants as
    ``linear_tn``'s."""
    return _gemm("linear_tnn", a_t, w, tile_width, split, _TNN)


def null_launch(device, blocks: int = 1) -> None:
    """One launch of an empty kernel of ``blocks`` blocks on ``device``'s
    current stream."""
    check(library().muse_null(blocks, torch.cuda.current_stream(device).cuda_stream),
          "null_launch")
