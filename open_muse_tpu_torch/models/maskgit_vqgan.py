"""MaskGIT's VQGAN tokenizer (f16, 1024 codes) in PyTorch: the decode side.

Counterpart of ``open_muse_tpu/models/maskgit_vqgan.py``: codebook lookup ->
Decoder (conv_in -> mid res blocks -> up blocks with nearest-x2 upsampling
-> GroupNorm -> SiLU -> conv_out).  Computes in NCHW inside and takes and
returns NHWC tensors, as the JAX package does.  The model stays fp32 and its
convolutions are plain PyTorch: JAX runs them outside any Pallas kernel.
The encoder (and so ``encode`` / ``get_code``) is not ported yet; a JAX
checkpoint's encoder leaves are left unused by the converter.

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
from ..ops.vq import VectorQuantizer

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


class MaskGitVQGAN(ModelMixin, nn.Module):
    """``decode_code(ids (B, N))`` -> NHWC images (B, R, R, 3);
    ``decode(z_q NHWC)`` -> NHWC images."""

    config_class = MaskGitVQGANConfig
    _class_name = "MaskGitVQGAN"

    def __init__(self, config: MaskGitVQGANConfig | None = None, **kwargs):
        super().__init__()
        cfg = config if config is not None else self.config_from_dict(kwargs)
        self.config = cfg
        self.decoder = Decoder(cfg)
        self.quantize = VectorQuantizer(cfg.num_embeddings, cfg.quantized_embed_dim)

    def decode(self, quantized_states):
        return self.decoder(quantized_states.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def decode_code(self, codebook_indices):
        return self.decode(self.quantize.get_codebook_entry(codebook_indices))
