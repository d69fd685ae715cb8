"""Vector-quantizer codebook: nearest-code search and lookup
(``open_muse_tpu/ops/vq.py``).

The search is the ``vq_argmin`` kernel (``kernels/vq_argmin.py``) for every
codebook size: the metric does not change the argmin, and the kernel takes
any K.  VQGAN training takes ``forward(..., return_loss=True)`` (the VQ-VAE
losses and the straight-through estimator around the kernel's ids); the
soft targets of the MUSE trainer take ``get_soft_code``, a softmax over the
metric's distances, whose hard code is ``torch.argmin`` over the same
distances, as the JAX package's ``jnp.argmin``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.vq_argmin import vq_argmin

__all__ = ["VQModelMixin", "VectorQuantizer", "compute_distances", "get_codebook_entry",
           "gumbel_noise", "nearest_codebook_indices"]


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


def gumbel_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` drawn from ``generator`` on
    its device, ``u`` kept above the smallest normal fp32, as
    ``jax.random.gumbel`` keeps it."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


class VectorQuantizer(nn.Module):
    """Holds the codebook as ``<embedding_name>.weight`` (K, C), as the
    reference does: ``embedding`` (MaskGIT, taming, MOVQ) or ``codebook``
    (Paella).  ``metric``: "sq_l2" (MaskGIT, taming) or "l2" (MOVQ, Paella),
    the distances of ``get_soft_code``."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 embedding_name: str = "embedding", commitment_cost: float = 0.25,
                 metric: str = "sq_l2"):
        super().__init__()
        if metric not in ("sq_l2", "l2"):
            raise ValueError(f"unknown metric {metric!r}")
        self.embedding_name = embedding_name
        self.commitment_cost = commitment_cost
        self.metric = metric
        table = nn.Embedding(num_embeddings, embedding_dim)
        nn.init.uniform_(table.weight, -1.0 / num_embeddings, 1.0 / num_embeddings)
        self.add_module(embedding_name, table)

    @property
    def weight(self) -> torch.Tensor:
        """The (K, C) codebook."""
        return getattr(self, self.embedding_name).weight

    def get_code(self, hidden_states):
        """NHWC latents (B, H, W, C) -> (B, H*W) int64 code ids.  The ids
        carry no gradient: the kernel sees detached tensors."""
        b, h, w, c = hidden_states.shape
        flat = hidden_states.detach().reshape(-1, c)
        return vq_argmin(flat, self.weight.detach()).long().reshape(b, h * w)

    def forward(self, hidden_states, return_loss: bool = False):
        """NHWC latents -> (z_q NHWC in their dtype, ids (B, H*W)); with
        ``return_loss`` (VQGAN training) -> (z_q, ids, loss): the VQ-VAE
        losses ``mean((sg(z_q) - h)^2) + commitment_cost * mean((z_q -
        sg(h))^2)`` and z_q passed straight through, ``h + sg(z_q - h)``."""
        b, h, w, _ = hidden_states.shape
        indices = self.get_code(hidden_states)
        # F.embedding: its CUDA backward is deterministic, an index's is not
        z_q = F.embedding(indices, self.weight).reshape(b, h, w, -1).to(hidden_states.dtype)
        if not return_loss:
            return z_q, indices
        loss = (hidden_states - z_q.detach()).square().mean() \
            + self.commitment_cost * (z_q - hidden_states.detach()).square().mean()
        return hidden_states + (z_q - hidden_states).detach(), indices, loss

    def get_soft_code(self, hidden_states, temp: float = 1.0, stochastic: bool = False,
                      gumbel=None, generator=None):
        """NHWC latents -> (soft codes (B, H*W, K) fp32, codes (B, H*W)
        int64): ``softmax(-d / temp)`` over the metric's distances d, and
        ``argmin d``, or with ``stochastic`` a sample of ``-d / temp``
        (``argmax(-d / temp + gumbel)``, the Gumbel-max form of
        ``jax.random.categorical``) from the given (N, K) ``gumbel`` noise,
        else from noise drawn from ``generator``."""
        b, h, w, c = hidden_states.shape
        distances = compute_distances(hidden_states.reshape(-1, c), self.weight, self.metric)
        logits = -distances / temp
        soft_code = torch.softmax(logits, dim=-1)
        if stochastic:
            if gumbel is None:
                if generator is None:
                    raise ValueError("stochastic soft codes need gumbel noise or a generator")
                gumbel = gumbel_noise(logits.shape, generator)
            code = torch.argmax(logits + gumbel, dim=-1)
        else:
            code = torch.argmin(distances, dim=-1)
        return soft_code.reshape(b, h * w, -1), code.reshape(b, h * w)

    def get_codebook_entry(self, indices):
        return get_codebook_entry(self.weight, indices)


class VQModelMixin:
    """``forward`` and ``get_soft_code`` of the four tokenizers, from their
    ``encode(pixel_values, return_loss)``, ``decode`` and ``_latents`` (NHWC
    latents before quantization) and the quantizer named
    ``_quantizer_name``."""

    _quantizer_name = "quantize"

    def forward(self, pixel_values, return_loss: bool = False):
        """Images in [0, 1], NHWC or NCHW -> (reconstruction NHWC, z_q NHWC,
        ids (B, N), the VQ loss or None), as the JAX models' ``__call__``."""
        z_q, indices, *loss = self.encode(pixel_values, return_loss)
        return self.decode(z_q), z_q, indices, loss[0] if loss else None

    def get_soft_code(self, pixel_values, temp: float = 1.0, stochastic: bool = False,
                      gumbel=None, generator=None):
        """Images -> (soft codes (B, N, K), codes (B, N)):
        ``VectorQuantizer.get_soft_code`` of the image's latents."""
        return getattr(self, self._quantizer_name).get_soft_code(
            self._latents(pixel_values), temp, stochastic, gumbel, generator)
