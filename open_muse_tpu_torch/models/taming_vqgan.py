"""Taming-transformers VQGAN in PyTorch: the encode and the decode side.

Counterpart of ``open_muse_tpu/models/taming_vqgan.py``: Encoder ->
quant_conv -> nearest-code search (the ``vq_argmin`` kernel) on the encode
side, codebook lookup -> post_quant_conv -> Decoder on the decode side.
Computes in NCHW inside and takes and returns NHWC tensors, as the JAX
package does (``encode`` / ``get_code`` take NCHW too).  The convolutions
are plain PyTorch in fp32: JAX runs them outside any Pallas kernel.

Reproduced reference quirks:
  * a block applies its attention only when it has more than one
    (``len(attn) > 1``), though a down block with one still holds its
    parameters;
  * Downsample pads (0, 1, 0, 1), then runs a VALID stride-2 conv.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.configuration import BaseConfig
from ..core.modeling import ModelMixin
from ..ops.layers import dot_product_attention
from ..ops.vq import VectorQuantizer, VQModelMixin

__all__ = ["VQGANConfig", "VQGANModel", "to_nhwc"]


@dataclasses.dataclass(frozen=True)
class VQGANConfig(BaseConfig):
    resolution: int = 256
    num_channels: int = 3
    hidden_channels: int = 128
    channel_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    no_attn_mid_block: bool = False
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
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = _group_norm(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.nin_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                             if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return h + (x if self.nin_shortcut is None else self.nin_shortcut(x))


class AttnBlock(nn.Module):
    """Single-head self-attention over the spatial map with 1x1-conv q/k/v."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = _group_norm(channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        h = self.norm(x)
        b, c, hh, ww = x.shape
        tokens = lambda t: t.reshape(b, c, 1, hh * ww).permute(0, 3, 2, 1)  # noqa: E731 (B, HW, 1, C)
        # one head over all channels, fp32: its own einsums in JAX, never
        # the attention kernel
        out = dot_product_attention(tokens(self.q(h)), tokens(self.k(h)), tokens(self.v(h)),
                                    use_kernels=False)
        out = out.permute(0, 3, 2, 1).reshape(b, c, hh, ww)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    def __init__(self, channels: int, with_conv: bool):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2) if with_conv else None

    def forward(self, x):
        if self.conv is None:
            return F.avg_pool2d(x, 2, 2)
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class DownsamplingBlock(nn.Module):
    """num_res_blocks ResnetBlocks (+ attention at attn_resolutions)."""

    def __init__(self, cfg: VQGANConfig, curr_res: int, block_idx: int):
        super().__init__()
        block_in = cfg.hidden_channels * ((1,) + tuple(cfg.channel_mult))[block_idx]
        block_out = cfg.hidden_channels * cfg.channel_mult[block_idx]
        n = cfg.num_res_blocks
        self.block = nn.ModuleList(
            [ResnetBlock(block_in if j == 0 else block_out, block_out) for j in range(n)])
        self.attn = nn.ModuleList(
            [AttnBlock(block_out) for _ in range(n)] if curr_res in cfg.attn_resolutions else [])
        last = block_idx == cfg.num_resolutions - 1
        self.downsample = None if last else Downsample(block_out, cfg.resample_with_conv)

    def forward(self, h):
        for j, block in enumerate(self.block):
            h = block(h)
            if len(self.attn) > 1:
                h = self.attn[j](h)
        return h if self.downsample is None else self.downsample(h)


class Upsample(nn.Module):
    def __init__(self, channels: int, with_conv: bool):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1) if with_conv else None

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return x if self.conv is None else self.conv(x)


class UpsamplingBlock(nn.Module):
    """num_res_blocks + 1 ResnetBlocks (+ attention at attn_resolutions)."""

    def __init__(self, cfg: VQGANConfig, curr_res: int, block_idx: int):
        super().__init__()
        last = cfg.num_resolutions - 1
        block_in = cfg.hidden_channels * cfg.channel_mult[min(block_idx + 1, last)]
        block_out = cfg.hidden_channels * cfg.channel_mult[block_idx]
        n = cfg.num_res_blocks + 1
        self.block = nn.ModuleList(
            [ResnetBlock(block_in if j == 0 else block_out, block_out) for j in range(n)])
        self.attn = nn.ModuleList(
            [AttnBlock(block_out) for _ in range(n)] if curr_res in cfg.attn_resolutions else [])
        self.upsample = Upsample(block_out, cfg.resample_with_conv) if block_idx != 0 else None

    def forward(self, h):
        for j, block in enumerate(self.block):
            h = block(h)
            if len(self.attn) > 1:
                h = self.attn[j](h)
        return h if self.upsample is None else self.upsample(h)


class MidBlock(nn.Module):
    def __init__(self, cfg: VQGANConfig, channels: int):
        super().__init__()
        self.block_1 = ResnetBlock(channels, channels)
        self.attn_1 = None if cfg.no_attn_mid_block else AttnBlock(channels)
        self.block_2 = ResnetBlock(channels, channels)

    def forward(self, h):
        h = self.block_1(h)
        if self.attn_1 is not None:
            h = self.attn_1(h)
        return self.block_2(h)


class Encoder(nn.Module):
    def __init__(self, cfg: VQGANConfig):
        super().__init__()
        self.conv_in = nn.Conv2d(cfg.num_channels, cfg.hidden_channels, 3, padding=1)
        self.down = nn.ModuleList(
            [DownsamplingBlock(cfg, cfg.resolution // 2 ** i, i)
             for i in range(cfg.num_resolutions)])
        mid_channels = cfg.hidden_channels * cfg.channel_mult[-1]
        self.mid = MidBlock(cfg, mid_channels)
        self.norm_out = _group_norm(mid_channels)
        self.conv_out = nn.Conv2d(mid_channels, cfg.z_channels, 3, padding=1)

    def forward(self, pixel_values):
        h = self.conv_in(pixel_values)
        for block in self.down:
            h = block(h)
        return self.conv_out(F.silu(self.norm_out(self.mid(h))))


class Decoder(nn.Module):
    def __init__(self, cfg: VQGANConfig):
        super().__init__()
        block_in = cfg.hidden_channels * cfg.channel_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = MidBlock(cfg, block_in)
        lowest = cfg.resolution // 2 ** (cfg.num_resolutions - 1)
        self.up = nn.ModuleList(
            [UpsamplingBlock(cfg, lowest * 2 ** (cfg.num_resolutions - 1 - i), i)
             for i in range(cfg.num_resolutions)])
        self.norm_out = _group_norm(cfg.hidden_channels * cfg.channel_mult[0])
        self.conv_out = nn.Conv2d(cfg.hidden_channels * cfg.channel_mult[0], cfg.num_channels,
                                  3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for block in reversed(self.up):
            h = block(h)
        return self.conv_out(F.silu(self.norm_out(h)))


def to_nhwc(pixel_values):
    """Accept NCHW (the reference layout) or NHWC images; return NHWC."""
    if pixel_values.dim() == 4 and pixel_values.shape[1] == 3 and pixel_values.shape[-1] != 3:
        return pixel_values.permute(0, 2, 3, 1)
    return pixel_values


class VQGANModel(VQModelMixin, ModelMixin, nn.Module):
    """The taming VQGAN: ``get_code(images)`` -> ids (B, N), ``encode`` ->
    (z_q NHWC, ids), ``decode_code(ids (B, N))`` -> NHWC images
    (B, R, R, 3)."""

    config_class = VQGANConfig
    _class_name = "VQGANModel"

    def __init__(self, config: VQGANConfig | None = None, **kwargs):
        super().__init__()
        cfg = config if config is not None else self.config_from_dict(kwargs)
        self.config = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quantize = VectorQuantizer(cfg.num_embeddings, cfg.quantized_embed_dim,
                                        commitment_cost=cfg.commitment_cost, metric="sq_l2")
        self.quant_conv = nn.Conv2d(cfg.z_channels, cfg.quantized_embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(cfg.quantized_embed_dim, cfg.z_channels, 1)

    def _latents(self, pixel_values):
        """NHWC or NCHW images -> NHWC latents before quantization."""
        h = to_nhwc(pixel_values).permute(0, 3, 1, 2)
        return self.quant_conv(self.encoder(h)).permute(0, 2, 3, 1)

    def encode(self, pixel_values, return_loss: bool = False):
        """Images in [0, 1] -> (z_q NHWC, code ids (B, H*W) int64), and the
        VQ loss with ``return_loss``."""
        return self.quantize(self._latents(pixel_values), return_loss)

    def get_code(self, pixel_values):
        """Images in [0, 1] -> code ids (B, H*W) int64."""
        return self.quantize.get_code(self._latents(pixel_values))

    def decode(self, quantized_states):
        """NHWC latents -> NHWC images."""
        z = quantized_states.permute(0, 3, 1, 2)
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)

    def decode_code(self, codebook_indices):
        return self.decode(self.quantize.get_codebook_entry(codebook_indices))
