"""Nearest codebook entry for each latent row (csrc/vq_argmin.cu).

Counterpart of ``open_muse_tpu/ops/pallas/vq_argmin.py vq_argmin``: for z
(N, C) and a codebook (K, C), ``argmin_k (|e_k|^2 - 2 z . e_k)`` in fp32 (the
row norm |z|^2 does not change the argmin and is dropped), the earliest
index on ties.  Any N, C and K.
"""

from __future__ import annotations

import torch

from . import on_cpu, require_cuda, stream_handle
from ._build import check, library

__all__ = ["vq_argmin", "vq_argmin_plain", "vq_scores", "vq_near_ties"]


def vq_scores(z, codebook):
    """The (N, K) fp32 scores |e_k|^2 - 2 z . e_k whose row argmin is the
    nearest code."""
    cb = codebook.float()
    e_sq = cb.square().sum(1)
    return e_sq[None] - 2 * (z.float() @ cb.t())


def vq_argmin_plain(z, codebook):
    """torch.argmin returns the first minimum on ties."""
    return torch.argmin(vq_scores(z, codebook), dim=1).to(torch.int32)


def vq_near_ties(ids, z, codebook, rtol: float = 1e-5):
    """For holding ids against the plain version's, where summation order
    may swap near-tied codes.  Per row, with the tolerance ``rtol * (|z|^2 +
    max_k |e_k|^2)`` (the scale of the squared distances the scores stand
    for): whether the two best plain scores lie within it, their gap in
    units of that scale, and how far the plain score at ``ids`` lies above
    the minimum beyond the tolerance, in units of the scale (<= 0 where
    within it).  Needs K >= 2."""
    scores = vq_scores(z, codebook)
    scale = z.float().square().sum(1) + codebook.float().square().sum(1).max()
    top2 = torch.topk(scores, 2, dim=1, largest=False).values
    gap = (top2[:, 1] - top2[:, 0]) / scale
    picked = scores.gather(1, ids.long()[:, None])[:, 0]
    return gap <= rtol, gap, (picked - top2[:, 0]) / scale - rtol


def vq_argmin(z, codebook):
    """z (N, C), codebook (K, C), any float type -> (N,) int32 code ids.
    The kernel reads fp32: other types are cast first, as the TPU kernel
    casts both operands."""
    if z.dim() != 2 or codebook.dim() != 2 or z.shape[1] != codebook.shape[1]:
        raise ValueError(f"vq_argmin: z {tuple(z.shape)} vs codebook {tuple(codebook.shape)}")
    if on_cpu(z, codebook):
        return vq_argmin_plain(z, codebook)
    z = z.float().contiguous()
    codebook = codebook.float().contiguous()
    require_cuda("vq_argmin", (torch.float32,), z, codebook)
    n, c = z.shape
    k = codebook.shape[0]
    e_sq = codebook.square().sum(1)
    ids = torch.empty(n, dtype=torch.int32, device=z.device)
    best = torch.empty(n, dtype=torch.int64, device=z.device)  # packed (score, id) scratch
    sms = torch.cuda.get_device_properties(z.device).multi_processor_count
    check(library().muse_vq_argmin(z.data_ptr(), codebook.data_ptr(), e_sq.data_ptr(), n, c,
                                   k, sms, best.data_ptr(), ids.data_ptr(), stream_handle(z)),
          "vq_argmin")
    vq_argmin.launches += 1
    return ids


vq_argmin.launches = 0
