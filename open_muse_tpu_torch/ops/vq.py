"""Vector-quantizer codebook, decode side (``open_muse_tpu/ops/vq.py``).

Only the codebook lookup is on the serving path; the nearest-code search of
the encode side comes with a later slice.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["VectorQuantizer", "get_codebook_entry"]


def get_codebook_entry(codebook: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """(B, N) token ids -> (B, sqrt(N), sqrt(N), C) NHWC latents."""
    batch, num_tokens = indices.shape
    side = math.isqrt(num_tokens)
    return codebook[indices].reshape(batch, side, side, -1)


class VectorQuantizer(nn.Module):
    """Holds the codebook as ``embedding.weight`` (K, C), as the reference
    does."""

    def __init__(self, num_embeddings: int, embedding_dim: int):
        super().__init__()
        self.embedding = nn.Embedding(num_embeddings, embedding_dim)
        nn.init.uniform_(self.embedding.weight, -1.0 / num_embeddings, 1.0 / num_embeddings)

    def get_codebook_entry(self, indices):
        return get_codebook_entry(self.embedding.weight, indices)
