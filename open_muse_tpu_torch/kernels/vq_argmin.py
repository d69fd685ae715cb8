"""Nearest codebook entry for each latent row (csrc/vq_argmin.cu).

Counterpart of ``open_muse_tpu/ops/pallas/vq_argmin.py vq_argmin``: for z
(N, C) and a codebook (K, C), ``argmin_k (|e_k|^2 - 2 z . e_k)`` in fp32 (the
row norm |z|^2 does not change the argmin and is dropped), the earliest
index on ties.  Any N, C and K.

On the card the products run on the bf16 tensor cores with fp32's accuracy,
by one of two routes that the C source chooses on C alone (``vq_route``
reads the rule and the route's scratch from the built library):

- the split route (C above ``NARROW_MAX_C``): a split pass writes each
  operand as three bf16 parts side by side (``vq_split_plain`` is its plain
  twin), and one GEMM sums the six part products that carry fp32's bits
  (``vq_split_scores_plain``), its epilogue taking the row minima;
- the narrow route (C 1 - ``NARROW_MAX_C``: the MOVQ and Paella latents'
  4): the six part spans side by side along one K of ``packed_width(C)``
  (32 at C 4), e_sq folded in as three more columns
  (``vq_pack_plain``, ``vq_packed_scores_plain``), the row minima taken from
  the accumulators in registers.  ``vq_argmin_narrow`` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import LaunchCounter, on_cpu, require_cuda, stream_handle
from ._build import check, library

__all__ = ["vq_argmin", "vq_argmin_plain", "vq_scores", "vq_near_ties", "vq_split",
           "vq_split_plain", "vq_split_scores_plain", "SPLIT_PRODUCTS", "NARROW_MAX_C",
           "packed_width", "vq_pack", "vq_pack_plain", "vq_packed_scores_plain", "vq_route",
           "vq_argmin_narrow"]

# the (z part, codebook part) pairs the product sums, 0 hi, 1 mid, 2 lo:
# hi.hi, hi.mid, mid.hi, hi.lo, mid.mid, lo.hi
SPLIT_PRODUCTS = ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))
# the widest latents the narrow route takes (csrc/vq_argmin.cu narrow::kMaxC)
NARROW_MAX_C = 10
# the vq_argmin launches that take the narrow route
vq_argmin_narrow = LaunchCounter("vq_argmin_narrow")


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


def packed_width(c: int) -> int:
    """The narrow route's K: six C-wide spans and e_sq's three parts,
    rounded up to 32 (csrc/vq_argmin.cu narrow::width)."""
    return -(-(6 * c + 3) // 32) * 32


def _pack_codebook(codebook):
    """B of ``vq_pack_plain``: the codebook's spans, then e_sq's parts."""
    k, c = codebook.shape
    if not 1 <= c <= NARROW_MAX_C:
        raise ValueError(f"vq_pack: C {c} outside the narrow route's 1 - {NARROW_MAX_C}")
    cb = codebook.float()
    e_sq = torch.zeros(k, dtype=torch.float32, device=cb.device)
    for j in range(c):  # each product and sum rounded to fp32, as the kernel sums
        e_sq = e_sq + cb[:, j] * cb[:, j]
    parts = _split_parts(cb)
    b = torch.zeros(k, packed_width(c), dtype=torch.bfloat16, device=cb.device)
    for s, (_, pb) in enumerate(SPLIT_PRODUCTS):
        b[:, s * c:(s + 1) * c] = parts[pb]
    b[:, 6 * c:6 * c + 3] = torch.stack(_split_parts(e_sq), dim=1)
    return b


def vq_pack_plain(z, codebook):
    """The narrow route's operands: z (N, C), codebook (K, C) -> A (N, W)
    and B (K, W) bf16, W = packed_width(C).  Span s (C columns) of A holds
    part SPLIT_PRODUCTS[s][0] of -2 z and of B part SPLIT_PRODUCTS[s][1] of
    the codebook; then A (1, 1, 1) against B's three parts of e_sq (|e|^2
    summed in fp32 in column order); zeros after.  The card builds B in its
    pack pass and A in registers."""
    b = _pack_codebook(codebook)
    n, c = z.shape
    parts = _split_parts(-2 * z.float())
    a = torch.zeros(n, b.shape[1], dtype=torch.bfloat16, device=z.device)
    for s, (pa, _) in enumerate(SPLIT_PRODUCTS):
        a[:, s * c:(s + 1) * c] = parts[pa]
    a[:, 6 * c:6 * c + 3] = 1
    return a, b


def vq_packed_scores_plain(z, codebook):
    """The (N, K) scores of the narrow route in fp32: A B^T of the packed
    operands, e_sq included (bf16 x bf16 products are exact in fp32; the
    sum's order is not the tensor cores')."""
    a, b = vq_pack_plain(z, codebook)
    return a.float() @ b.float().t()


def vq_route(n: int, c: int, k: int):
    """(narrow, scratch) for a search of (N, C) latents over K codes, by the
    rule in csrc/vq_argmin.cu (read from the built library: the rule lives
    in C alone); scratch: the element counts of z' and cb' (bf16) and of
    best (int64) that the route takes."""
    counts = (ctypes.c_int64 * 3)()
    route = library().muse_vq_route(n, c, k, counts)
    if route < 0:
        raise ValueError(f"vq_argmin: empty shape N {n}, C {c}, K {k}")
    return bool(route), tuple(counts)


def vq_pack(codebook):
    """The narrow route's pack pass alone, as ``vq_argmin`` runs it on the
    card (for the tests; no path calls it): B of ``vq_pack_plain`` for CPU
    tensors."""
    if on_cpu(codebook):
        return _pack_codebook(codebook)
    codebook = codebook.float().contiguous()
    require_cuda("vq_pack", (torch.float32,), codebook)
    k, c = codebook.shape
    if not 1 <= c <= NARROW_MAX_C:
        raise ValueError(f"vq_pack: C {c} outside the narrow route's 1 - {NARROW_MAX_C}")
    out = torch.empty(k, packed_width(c), dtype=torch.bfloat16, device=codebook.device)
    check(library().muse_vq_pack(codebook.data_ptr(), k, c, out.data_ptr(),
                                 stream_handle(codebook)), "vq_pack")
    return out


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
    narrow, (zp_n, cbp_n, best_n) = vq_route(n, c, k)
    e_sq = None if narrow else codebook.square().sum(1)  # the narrow route packs its own
    ids = torch.empty(n, dtype=torch.int32, device=z.device)
    best = torch.empty(best_n, dtype=torch.int64, device=z.device)  # packed (score, id) scratch
    zp = torch.empty(zp_n, dtype=torch.bfloat16, device=z.device)  # the split operands
    cbp = torch.empty(cbp_n, dtype=torch.bfloat16, device=z.device)
    check(library().muse_vq_argmin(z.data_ptr(), codebook.data_ptr(),
                                   None if e_sq is None else e_sq.data_ptr(), n, c, k,
                                   zp.data_ptr(), cbp.data_ptr(), best.data_ptr(),
                                   ids.data_ptr(), stream_handle(z)),
          "vq_argmin")
    vq_argmin.launches += 1
    vq_argmin_narrow.launches += int(narrow)
    return ids


vq_argmin.launches = 0
