"""MaskGIT's VQGAN tokenizer (f16, 1024 codes) in PyTorch.

Counterpart of ``open_muse_tpu/models/maskgit_vqgan.py``: Encoder (conv_in
-> down blocks with 2 x 2 average pooling -> mid res blocks -> GroupNorm ->
SiLU -> 1 x 1 conv_out) -> the squared-L2 quantizer, whose nearest-code
search is the ``vq_argmin`` kernel (K 1024, C 256 at the defaults); and
codebook lookup -> Decoder (conv_in -> mid res blocks -> up blocks with
nearest-x2 upsampling -> GroupNorm -> SiLU -> conv_out).  Computes in NCHW
inside and takes and returns NHWC tensors (``encode`` / ``get_code`` also
take NCHW images), as the JAX package does.  The model stays fp32 and its
convolutions are plain PyTorch: JAX runs them outside any Pallas kernel.

Reproduced reference quirk: a ResnetBlock whose width changes applies its
1x1 ``nin_shortcut`` to conv2's output, not to the block's input.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch.nn.functional as F
from torch import nn

from ..core.configuration import BaseConfig
from ..core.modeling import ModelMixin
from ..ops.vq import VectorQuantizer, VQModelMixin
from .taming_vqgan import to_nhwc

__all__ = ["MaskGitVQGAN", "MaskGitVQGANConfig"]


@dataclasses.dataclass(frozen=True)
class MaskGitVQGANConfig(BaseConfig):
    resolution: int = 256
    num_channels: int = 3
    hidden_channels: int = 128
    channel_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    z_channels: int = 256
    num_embeddings: int = 1024
    quantized_embed_dim: int = 256
    dropout: float = 0.0
    resample_with_conv: bool = True
    commitment_cost: float = 0.25

    @property
    def num_resolutions(self) -> int:
        return len(self.channel_mult)


def _group_norm(channels):
    return nn.GroupNorm(32, channels, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = _group_norm(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.norm2 = _group_norm(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        self.nin_shortcut = (nn.Conv2d(out_channels, out_channels, 1, bias=False)
                             if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return h + (x if self.nin_shortcut is None else self.nin_shortcut(h))


class DownsamplingBlock(nn.Module):
    """num_res_blocks ResnetBlocks, then (except at the last level) 2 x 2
    average pooling."""

    def __init__(self, cfg: MaskGitVQGANConfig, block_idx: int):
        super().__init__()
        in_mult = (1,) + tuple(cfg.channel_mult)
        block_in = cfg.hidden_channels * in_mult[block_idx]
        block_out = cfg.hidden_channels * cfg.channel_mult[block_idx]
        self.block = nn.ModuleList([ResnetBlock(block_in if j == 0 else block_out, block_out)
                                    for j in range(cfg.num_res_blocks)])
        self.pool = block_idx != cfg.num_resolutions - 1

    def forward(self, h):
        for block in self.block:
            h = block(h)
        return F.avg_pool2d(h, 2, 2) if self.pool else h


class UpsamplingBlock(nn.Module):
    """num_res_blocks ResnetBlocks, then (except at level 0) nearest x2 and
    a 3x3 conv."""

    def __init__(self, cfg: MaskGitVQGANConfig, block_idx: int):
        super().__init__()
        last = cfg.num_resolutions - 1
        block_in = cfg.hidden_channels * cfg.channel_mult[min(block_idx + 1, last)]
        block_out = cfg.hidden_channels * cfg.channel_mult[block_idx]
        self.block = nn.ModuleList([ResnetBlock(block_in if j == 0 else block_out, block_out)
                                    for j in range(cfg.num_res_blocks)])
        self.upsample_conv = (nn.Conv2d(block_out, block_out, 3, padding=1)
                              if block_idx != 0 else None)

    def forward(self, h):
        for block in self.block:
            h = block(h)
        if self.upsample_conv is not None:
            h = self.upsample_conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return h


class Encoder(nn.Module):
    def __init__(self, cfg: MaskGitVQGANConfig):
        super().__init__()
        self.conv_in = nn.Conv2d(cfg.num_channels, cfg.hidden_channels, 3, padding=1,
                                 bias=False)
        self.down = nn.ModuleList([DownsamplingBlock(cfg, i)
                                   for i in range(cfg.num_resolutions)])
        mid = cfg.hidden_channels * cfg.channel_mult[-1]
        self.mid = nn.ModuleList([ResnetBlock(mid, mid) for _ in range(cfg.num_res_blocks)])
        self.norm_out = _group_norm(mid)
        self.conv_out = nn.Conv2d(mid, cfg.z_channels, 1)

    def forward(self, pixel_values):
        h = self.conv_in(pixel_values)
        for block in self.down:
            h = block(h)
        for block in self.mid:
            h = block(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: MaskGitVQGANConfig):
        super().__init__()
        block_in = cfg.hidden_channels * cfg.channel_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = nn.ModuleList([ResnetBlock(block_in, block_in)
                                  for _ in range(cfg.num_res_blocks)])
        self.up = nn.ModuleList([UpsamplingBlock(cfg, i) for i in range(cfg.num_resolutions)])
        out = cfg.hidden_channels * cfg.channel_mult[0]
        self.norm_out = _group_norm(out)
        self.conv_out = nn.Conv2d(out, cfg.num_channels, 3, padding=1)

    def forward(self, z):
        h = self.conv_in(z)
        for block in self.mid:
            h = block(h)
        for block in reversed(self.up):
            h = block(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class MaskGitVQGAN(VQModelMixin, ModelMixin, nn.Module):
    """``get_code(images)`` -> ids (B, N); ``encode(images)`` -> (z_q NHWC,
    ids); ``decode_code(ids (B, N))`` -> NHWC images (B, R, R, 3);
    ``decode(z_q NHWC)`` -> NHWC images."""

    config_class = MaskGitVQGANConfig
    _class_name = "MaskGitVQGAN"

    def __init__(self, config: MaskGitVQGANConfig | None = None, **kwargs):
        super().__init__()
        cfg = config if config is not None else self.config_from_dict(kwargs)
        self.config = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quantize = VectorQuantizer(cfg.num_embeddings, cfg.quantized_embed_dim,
                                        commitment_cost=cfg.commitment_cost, metric="sq_l2")

    def _latents(self, pixel_values):
        """NHWC or NCHW images -> NHWC latents before quantization."""
        return self.encoder(to_nhwc(pixel_values).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def encode(self, pixel_values, return_loss: bool = False):
        """Images in [0, 1] -> (z_q NHWC, code ids (B, H*W) int64), and the
        VQ loss with ``return_loss``."""
        return self.quantize(self._latents(pixel_values), return_loss)

    def get_code(self, pixel_values):
        """Images in [0, 1] -> code ids (B, H*W) int64."""
        return self.quantize.get_code(self._latents(pixel_values))

    def decode(self, quantized_states):
        return self.decoder(quantized_states.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def decode_code(self, codebook_indices):
        return self.decode(self.quantize.get_codebook_entry(codebook_indices))
