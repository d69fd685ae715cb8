"""Nearest codebook entry for each latent row (csrc/vq_argmin.cu).

Counterpart of ``open_muse_tpu/ops/pallas/vq_argmin.py vq_argmin``: for z
(N, C) and a codebook (K, C), ``argmin_k (|e_k|^2 - 2 z . e_k)`` in fp32 (the
row norm |z|^2 does not change the argmin and is dropped), the earliest
index on ties.  Any N, C and K.

On the card the products run on the bf16 tensor cores with fp32's accuracy:
a split pass writes each operand as three bf16 parts side by side
(``vq_split_plain`` is its plain twin), and one GEMM sums the six part
products that carry fp32's bits (``vq_split_scores_plain``), its epilogue
taking the row minima.
"""

from __future__ import annotations

import torch

from . import on_cpu, require_cuda, stream_handle
from ._build import check, library

__all__ = ["vq_argmin", "vq_argmin_plain", "vq_scores", "vq_near_ties", "vq_split",
           "vq_split_plain", "vq_split_scores_plain", "SPLIT_PRODUCTS"]

# the (z part, codebook part) pairs the product sums, 0 hi, 1 mid, 2 lo:
# hi.hi, hi.mid, mid.hi, hi.lo, mid.mid, lo.hi
SPLIT_PRODUCTS = ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))


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


def _split_parts(x):
    """(hi, mid, lo) bf16 with hi + mid + lo = x to about 2^-24 of x: each
    subtraction is exact in fp32."""
    hi = x.to(torch.bfloat16)
    r1 = x - hi.float()
    mid = r1.to(torch.bfloat16)
    return hi, mid, (r1 - mid.float()).to(torch.bfloat16)


def _split_shapes(c, k):
    """(Cp, Kp): C rounded up to a multiple of 64 (a part spans whole k steps
    of the GEMM), K up to even (its even N)."""
    return -(-c // 64) * 64, -(-k // 2) * 2


def vq_split_plain(z, codebook):
    """The split pass: z (N, C), codebook (K, C) -> z' (N, 3 Cp) and cb'
    (Kp, 3 Cp) bf16, the parts [hi | mid | lo] of -2 z and of the codebook;
    zeros past C and past K."""
    n, c = z.shape
    k = codebook.shape[0]
    cp, kp = _split_shapes(c, k)
    out = []
    for x, rows in ((-2 * z.float(), n), (codebook.float(), kp)):
        padded = torch.zeros(rows, cp, dtype=torch.float32, device=x.device)
        padded[:x.shape[0], :c] = x
        out.append(torch.cat(_split_parts(padded), dim=1))
    return tuple(out)


def vq_split_scores_plain(z, codebook):
    """The (N, K) scores of the kernel's route in fp32: e_sq plus -2 z . e
    summed over the six part products (bf16 x bf16 products are exact in
    fp32; the sum's order is not the GEMM's)."""
    zp, cbp = vq_split_plain(z, codebook)
    cp, k = zp.shape[1] // 3, codebook.shape[0]
    part = lambda t, p: t[:, p * cp:(p + 1) * cp].float()  # noqa: E731
    dots = sum(part(zp, a) @ part(cbp, b).t() for a, b in SPLIT_PRODUCTS)
    return codebook.float().square().sum(1)[None] + dots[:, :k]


def vq_split(z, codebook):
    """The split pass alone, as ``vq_argmin`` runs it on the card (for the
    tests; no path calls it): ``vq_split_plain`` for CPU tensors."""
    if on_cpu(z, codebook):
        return vq_split_plain(z, codebook)
    z = z.float().contiguous()
    codebook = codebook.float().contiguous()
    require_cuda("vq_split", (torch.float32,), z, codebook)
    (n, c), k = z.shape, codebook.shape[0]
    cp, kp = _split_shapes(c, k)
    zp = torch.empty(n, 3 * cp, dtype=torch.bfloat16, device=z.device)
    cbp = torch.empty(kp, 3 * cp, dtype=torch.bfloat16, device=z.device)
    check(library().muse_vq_split(z.data_ptr(), codebook.data_ptr(), n, c, k, zp.data_ptr(),
                                  cbp.data_ptr(), stream_handle(z)), "vq_split")
    return zp, cbp


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
    (n, c), k = z.shape, codebook.shape[0]
    cp, kp = _split_shapes(c, k)
    e_sq = codebook.square().sum(1)
    ids = torch.empty(n, dtype=torch.int32, device=z.device)
    best = torch.empty(n, dtype=torch.int64, device=z.device)  # packed (score, id) scratch
    zp = torch.empty(n, 3 * cp, dtype=torch.bfloat16, device=z.device)  # the split operands
    cbp = torch.empty(kp, 3 * cp, dtype=torch.bfloat16, device=z.device)
    check(library().muse_vq_argmin(z.data_ptr(), codebook.data_ptr(), e_sq.data_ptr(), n, c,
                                   k, zp.data_ptr(), cbp.data_ptr(), best.data_ptr(),
                                   ids.data_ptr(), stream_handle(z)),
          "vq_argmin")
    vq_argmin.launches += 1
    return ids


vq_argmin.launches = 0
