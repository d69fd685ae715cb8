"""Paella's VQ tokenizer in PyTorch.

Counterpart of ``open_muse_tpu/models/paella_vq.py``: PixelUnshuffle(2) and
a 1x1 conv, gamma-gated ResBlocks with a stride-2 conv between levels, a
bias-free 1x1 conv and an inference BatchNorm on the encode side, then the
nearest-code search (the ``vq_argmin`` kernel; the reference's ``l2``
metric has the same argmin); on the decode side a 1x1 conv, the bottleneck
and level ResBlocks with a stride-2 ConvTranspose between levels, a 1x1
conv and PixelShuffle(2).  Computes in NCHW inside and takes and returns
NHWC tensors (``encode`` / ``get_code`` take NCHW too).  The model stays
fp32 and is plain PyTorch: JAX runs it outside any Pallas kernel.  The
module names are the reference's (``in_block.1``, ``down_blocks.N``,
``up_blocks.N``, ``out_block.0``, ``vquantizer.codebook``).

Reproduced reference behaviour:
  * the model is inference-only: the BatchNorm applies its running
    statistics, which are parameters, as in the JAX tree, so VQGAN training
    moves them by their gradients as the JAX trainer does;
  * ``encode`` divides ``z_q`` by ``scale_factor`` and ``decode`` multiplies
    by it, but ``decode_code`` does not rescale.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..core.configuration import BaseConfig
from ..core.modeling import ModelMixin
from ..ops.vq import VectorQuantizer, VQModelMixin
from .taming_vqgan import to_nhwc

__all__ = ["PaellaVQModel", "PaellaVQConfig"]


@dataclasses.dataclass(frozen=True)
class PaellaVQConfig(BaseConfig):
    # Paella's published widths
    levels: int = 2
    bottleneck_blocks: int = 12
    c_hidden: int = 384
    c_latent: int = 4
    codebook_size: int = 8192
    scale_factor: float = 0.3764


def _channel_norm(x):
    """LayerNorm over the channels of an NCHW map, no affine, eps 1e-6, fp32
    statistics."""
    h = x.float().permute(0, 2, 3, 1)
    return F.layer_norm(h, h.shape[-1:], eps=1e-6).permute(0, 3, 1, 2).to(x.dtype)


class ResBlock(nn.Module):
    """x + g2 * depthwise(norm(x) * (1 + g0) + g1), then + g5 * channelwise
    MLP (exact-erf GELU) of norm(x) * (1 + g3) + g4; the depthwise 3x3
    conv pads by replication."""

    def __init__(self, c: int, c_hidden: int):
        super().__init__()
        self.depthwise = nn.Sequential(nn.ReplicationPad2d(1), nn.Conv2d(c, c, 3, groups=c))
        self.channelwise = nn.Sequential(nn.Linear(c, c_hidden), nn.GELU(),
                                         nn.Linear(c_hidden, c))
        self.gammas = nn.Parameter(torch.zeros(6))

    def forward(self, x):
        g = self.gammas
        x = x + self.depthwise(_channel_norm(x) * (1 + g[0]) + g[1]) * g[2]
        h = (_channel_norm(x) * (1 + g[3]) + g[4]).permute(0, 2, 3, 1)
        return x + self.channelwise(h).permute(0, 3, 1, 2) * g[5]


class BatchNorm2dInference(nn.Module):
    """``(x - running_mean) * rsqrt(running_var + eps) * weight + bias`` over
    the channels of an NCHW map, in training mode too: the reference model
    is inference-only.  The statistics are parameters, as in the JAX tree,
    and the normalisation is written out so that autograd reaches them
    (``F.batch_norm`` in eval mode gives them no gradient).  The state-dict
    names are ``nn.BatchNorm2d``'s but for its bookkeeping
    ``num_batches_tracked``, which has no JAX leaf and is never read (a
    checkpoint that carries it loads: ``from_pretrained`` ignores unknown
    keys)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.running_mean = nn.Parameter(torch.zeros(channels))
        self.running_var = nn.Parameter(torch.ones(channels))

    def forward(self, x):
        def per_channel(v):
            return v[:, None, None]

        inv = torch.rsqrt(per_channel(self.running_var) + self.eps)
        return (x - per_channel(self.running_mean)) * inv * per_channel(self.weight) \
            + per_channel(self.bias)


class PaellaVQModel(VQModelMixin, ModelMixin, nn.Module):
    """``get_code(images)`` -> ids (B, N); ``encode(images)`` -> (z_q / scale
    NHWC, ids); ``decode_code(ids (B, N))`` -> NHWC images; ``decode(x
    NHWC)`` -> NHWC images of ``x * scale``."""

    config_class = PaellaVQConfig
    _class_name = "PaellaVQModel"
    _quantizer_name = "vquantizer"

    def __init__(self, config: PaellaVQConfig | None = None, **kwargs):
        super().__init__()
        cfg = config if config is not None else self.config_from_dict(kwargs)
        self.config = cfg
        c_levels = [cfg.c_hidden // 2 ** i for i in reversed(range(cfg.levels))]
        self.in_block = nn.Sequential(nn.PixelUnshuffle(2), nn.Conv2d(3 * 4, c_levels[0], 1))
        down = []
        for i in range(cfg.levels):
            if i > 0:
                down.append(nn.Conv2d(c_levels[i - 1], c_levels[i], 4, stride=2, padding=1))
            down.append(ResBlock(c_levels[i], c_levels[i] * 4))
        down.append(nn.Sequential(nn.Conv2d(c_levels[-1], cfg.c_latent, 1, bias=False),
                                  BatchNorm2dInference(cfg.c_latent)))
        self.down_blocks = nn.Sequential(*down)
        up = [nn.Sequential(nn.Conv2d(cfg.c_latent, c_levels[-1], 1))]
        for i in range(cfg.levels):
            c = c_levels[cfg.levels - 1 - i]
            up += [ResBlock(c, c * 4) for _ in range(cfg.bottleneck_blocks if i == 0 else 1)]
            if i < cfg.levels - 1:
                up.append(nn.ConvTranspose2d(c, c_levels[cfg.levels - 2 - i], 4, stride=2,
                                             padding=1))
                # built in flax with transpose_kernel=True: the kernel (kh,
                # kw, O, I) is torch's weight transposed, with no flip
                up[-1].flax_transpose_kernel = True
        self.up_blocks = nn.Sequential(*up)
        self.out_block = nn.Sequential(nn.Conv2d(c_levels[0], 3 * 4, 1), nn.PixelShuffle(2))
        self.vquantizer = VectorQuantizer(cfg.codebook_size, cfg.c_latent, "codebook",
                                          metric="l2")

    def _latents(self, pixel_values):
        """NHWC or NCHW images -> NHWC latents before quantization."""
        h = self.in_block(to_nhwc(pixel_values).permute(0, 3, 1, 2))
        return self.down_blocks(h).permute(0, 2, 3, 1)

    def _decode_latents(self, x):
        """NHWC latents -> NHWC images."""
        return self.out_block(self.up_blocks(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)

    def encode(self, pixel_values, return_loss: bool = False):
        """Images in [0, 1] -> (z_q / scale_factor NHWC, code ids (B, H*W)),
        and the VQ loss (of the unscaled z_q) with ``return_loss``."""
        z_q, *rest = self.vquantizer(self._latents(pixel_values), return_loss)
        return (z_q / self.config.scale_factor, *rest)

    def get_code(self, pixel_values):
        """Images in [0, 1] -> code ids (B, H*W) int64."""
        return self.vquantizer.get_code(self._latents(pixel_values))

    def decode(self, x):
        return self._decode_latents(x * self.config.scale_factor)

    def decode_code(self, codebook_indices):
        """Code ids -> NHWC images, with no rescaling (as the reference)."""
        return self._decode_latents(self.vquantizer.get_codebook_entry(codebook_indices))
