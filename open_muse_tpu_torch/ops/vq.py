"""Vector-quantizer codebook: nearest-code search and lookup
(``open_muse_tpu/ops/vq.py``).

The search is the ``vq_argmin`` kernel (``kernels/vq_argmin.py``) for every
codebook size: the metric does not change the argmin, and the kernel takes
any K.  ``return_loss`` and ``get_soft_code`` belong to VQGAN training and
are not ported.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels.vq_argmin import vq_argmin

__all__ = ["VectorQuantizer", "compute_distances", "get_codebook_entry",
           "nearest_codebook_indices"]


def compute_distances(flat_states, codebook, metric: str = "sq_l2"):
    """(N, C) latents x (K, C) codebook -> (N, K) fp32 distances:
    ``z^2 + e^2 - 2 z.e`` ("sq_l2", maskgit / taming) or its square root
    clamped at 0 ("l2", as ``torch.cdist``, movq / paella)."""
    flat32, cb32 = flat_states.float(), codebook.float()
    z_sq = flat32.square().sum(1, keepdim=True)
    e_sq = cb32.square().sum(1)[None]
    d = z_sq + e_sq - 2.0 * (flat32 @ cb32.t())
    if metric == "l2":
        d = torch.sqrt(torch.clamp(d, min=0.0))
    return d


def nearest_codebook_indices(flat_states, codebook, metric: str = "sq_l2"):
    """(N,) int64 ids of the nearest codes; ``metric`` does not change the
    argmin."""
    if metric not in ("sq_l2", "l2"):
        raise ValueError(f"unknown metric {metric!r}")
    return vq_argmin(flat_states, codebook).long()


def get_codebook_entry(codebook: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """(B, N) token ids -> (B, sqrt(N), sqrt(N), C) NHWC latents."""
    batch, num_tokens = indices.shape
    side = math.isqrt(num_tokens)
    return codebook[indices].reshape(batch, side, side, -1)


class VectorQuantizer(nn.Module):
    """Holds the codebook as ``<embedding_name>.weight`` (K, C), as the
    reference does: ``embedding`` (MaskGIT, taming, MOVQ) or ``codebook``
    (Paella)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 embedding_name: str = "embedding"):
        super().__init__()
        self.embedding_name = embedding_name
        table = nn.Embedding(num_embeddings, embedding_dim)
        nn.init.uniform_(table.weight, -1.0 / num_embeddings, 1.0 / num_embeddings)
        self.add_module(embedding_name, table)

    @property
    def weight(self) -> torch.Tensor:
        """The (K, C) codebook."""
        return getattr(self, self.embedding_name).weight

    def get_code(self, hidden_states):
        """NHWC latents (B, H, W, C) -> (B, H*W) int64 code ids."""
        b, h, w, c = hidden_states.shape
        flat = hidden_states.reshape(-1, c)
        return vq_argmin(flat, self.weight).long().reshape(b, h * w)

    def forward(self, hidden_states):
        """NHWC latents -> (z_q NHWC in their dtype, ids (B, H*W))."""
        b, h, w, _ = hidden_states.shape
        indices = self.get_code(hidden_states)
        z_q = self.weight[indices].reshape(b, h, w, -1).to(hidden_states.dtype)
        return z_q, indices

    def get_codebook_entry(self, indices):
        return get_codebook_entry(self.weight, indices)
