"""MOVQ tokenizer (Kandinsky 2.1's VQGAN) in PyTorch.

Counterpart of ``open_muse_tpu/models/movq.py``: Encoder -> quant_conv ->
nearest-code search (the ``vq_argmin`` kernel; the reference's ``l2``
metric has the same argmin) on the encode side; codebook lookup ->
post_quant_conv -> a decoder whose every norm is a ``SpatialNorm``
modulated by the quantized latent itself on the decode side.  Computes in
NCHW inside and takes and returns NHWC tensors, as the JAX package does
(``encode`` / ``get_code`` take NCHW too).  The model stays fp32 and its
convolutions and single-head attention are plain PyTorch: JAX runs them
outside any Pallas kernel, and the attention's head (the block's channels,
512 at the published widths) is not one of the attention kernel's.

Reproduced reference quirks:
  * an encoder down block applies its attention only when it has more than
    one (``num_res_blocks > 1``), though a block with one still holds its
    parameters;
  * Downsample pads (0, 1, 0, 1), then runs a VALID stride-2 conv;
  * the decoder reads ``post_quant_conv(quant)`` and, in every SpatialNorm,
    the raw ``quant``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch.nn.functional as F
from torch import nn

from ..core.configuration import BaseConfig
from ..core.modeling import ModelMixin
from ..ops.vq import VectorQuantizer, VQModelMixin
from .taming_vqgan import Downsample, Upsample, to_nhwc

__all__ = ["MOVQ", "MOVQConfig"]


@dataclasses.dataclass(frozen=True)
class MOVQConfig(BaseConfig):
    # Kandinsky 2.1's published widths
    resolution: int = 256
    num_channels: int = 3
    out_channels: int = 3
    hidden_channels: int = 128
    channel_mult: Tuple[int, ...] = (1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (32,)
    z_channels: int = 4
    double_z: bool = False
    num_embeddings: int = 16384
    quantized_embed_dim: int = 4
    dropout: float = 0.0
    resample_with_conv: bool = True
    commitment_cost: float = 0.25

    @property
    def num_resolutions(self) -> int:
        return len(self.channel_mult)


def _group_norm(channels):
    return nn.GroupNorm(32, channels, eps=1e-6)


class SpatialNorm(nn.Module):
    """GroupNorm of f, scaled and shifted by 1x1 convs of zq resized
    (nearest) to f's size."""

    def __init__(self, f_channels: int, zq_channels: int):
        super().__init__()
        self.norm_layer = _group_norm(f_channels)
        self.conv_y = nn.Conv2d(zq_channels, f_channels, 1)
        self.conv_b = nn.Conv2d(zq_channels, f_channels, 1)

    def forward(self, f, zq):
        zq = F.interpolate(zq, size=f.shape[-2:], mode="nearest")
        return self.norm_layer(f) * self.conv_y(zq) + self.conv_b(zq)


def _norm(channels: int, zq_channels):
    """A SpatialNorm where the block is conditioned on zq, else a GroupNorm."""
    return _group_norm(channels) if zq_channels is None else SpatialNorm(channels, zq_channels)


def _apply(norm, h, zq):
    return norm(h) if zq is None else norm(h, zq)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, zq_channels=None):
        super().__init__()
        self.norm1 = _norm(in_channels, zq_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = _norm(out_channels, zq_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.nin_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                             if in_channels != out_channels else None)

    def forward(self, x, zq=None):
        h = self.conv1(F.silu(_apply(self.norm1, x, zq)))
        h = self.conv2(F.silu(_apply(self.norm2, h, zq)))
        return h + (x if self.nin_shortcut is None else self.nin_shortcut(x))


class AttnBlock(nn.Module):
    """Single-head attention over the spatial map with linear q / k / v and
    an fp32 softmax."""

    def __init__(self, channels: int, zq_channels=None):
        super().__init__()
        self.norm = _norm(channels, zq_channels)
        self.q = nn.Linear(channels, channels)
        self.k = nn.Linear(channels, channels)
        self.v = nn.Linear(channels, channels)
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x, zq=None):
        b, c, hh, ww = x.shape
        h = _apply(self.norm, x, zq).flatten(2).transpose(1, 2)  # (B, HW, C)
        q, k, v = self.q(h), self.k(h), self.v(h)
        logits = (q.float() @ k.float().transpose(1, 2)) * c ** -0.5
        h = self.proj_out(logits.softmax(-1).to(v.dtype) @ v)
        return x + h.transpose(1, 2).reshape(b, c, hh, ww)


class DownsamplingBlock(nn.Module):
    """num_res_blocks ResnetBlocks (+ attention at attn_resolutions, applied
    only when there is more than one)."""

    def __init__(self, cfg: MOVQConfig, curr_res: int, block_idx: int):
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


class UpsamplingBlock(nn.Module):
    """num_res_blocks + 1 zq-conditioned ResnetBlocks (+ attention at
    attn_resolutions), then (except at level 0) nearest x2 and a conv."""

    def __init__(self, cfg: MOVQConfig, curr_res: int, block_idx: int):
        super().__init__()
        last, zq = cfg.num_resolutions - 1, cfg.quantized_embed_dim
        block_in = cfg.hidden_channels * cfg.channel_mult[min(block_idx + 1, last)]
        block_out = cfg.hidden_channels * cfg.channel_mult[block_idx]
        n = cfg.num_res_blocks + 1
        self.block = nn.ModuleList([ResnetBlock(block_in if j == 0 else block_out, block_out, zq)
                                    for j in range(n)])
        self.attn = nn.ModuleList([AttnBlock(block_out, zq) for _ in range(n)]
                                  if curr_res in cfg.attn_resolutions else [])
        self.upsample = Upsample(block_out, cfg.resample_with_conv) if block_idx != 0 else None

    def forward(self, h, zq):
        for j, block in enumerate(self.block):
            h = block(h, zq)
            if len(self.attn) > 1:
                h = self.attn[j](h, zq)
        return h if self.upsample is None else self.upsample(h)


class MidBlock(nn.Module):
    def __init__(self, channels: int, zq_channels=None):
        super().__init__()
        self.block_1 = ResnetBlock(channels, channels, zq_channels)
        self.attn_1 = AttnBlock(channels, zq_channels)
        self.block_2 = ResnetBlock(channels, channels, zq_channels)

    def forward(self, h, zq=None):
        return self.block_2(self.attn_1(self.block_1(h, zq), zq), zq)


class Encoder(nn.Module):
    def __init__(self, cfg: MOVQConfig):
        super().__init__()
        self.conv_in = nn.Conv2d(cfg.num_channels, cfg.hidden_channels, 3, padding=1)
        self.down = nn.ModuleList(
            [DownsamplingBlock(cfg, cfg.resolution // 2 ** i, i)
             for i in range(cfg.num_resolutions)])
        mid_channels = cfg.hidden_channels * cfg.channel_mult[-1]
        self.mid = MidBlock(mid_channels)
        self.norm_out = _group_norm(mid_channels)
        self.conv_out = nn.Conv2d(mid_channels, cfg.z_channels, 3, padding=1)

    def forward(self, pixel_values):
        h = self.conv_in(pixel_values)
        for block in self.down:
            h = block(h)
        return self.conv_out(F.silu(self.norm_out(self.mid(h))))


class MoVQDecoder(nn.Module):
    def __init__(self, cfg: MOVQConfig):
        super().__init__()
        block_in = cfg.hidden_channels * cfg.channel_mult[-1]
        zq = cfg.quantized_embed_dim
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = MidBlock(block_in, zq)
        lowest = cfg.resolution // 2 ** (cfg.num_resolutions - 1)
        self.up = nn.ModuleList(
            [UpsamplingBlock(cfg, lowest * 2 ** (cfg.num_resolutions - 1 - i), i)
             for i in range(cfg.num_resolutions)])
        out = cfg.hidden_channels * cfg.channel_mult[0]
        self.norm_out = SpatialNorm(out, zq)
        self.conv_out = nn.Conv2d(out, cfg.num_channels, 3, padding=1)

    def forward(self, z, zq):
        h = self.mid(self.conv_in(z), zq)
        for block in reversed(self.up):
            h = block(h, zq)
        return self.conv_out(F.silu(self.norm_out(h, zq)))


class MOVQ(VQModelMixin, ModelMixin, nn.Module):
    """``get_code(images)`` -> ids (B, N); ``encode(images)`` -> (z_q NHWC,
    ids); ``decode_code(ids (B, N))`` -> NHWC images (B, R, R, 3);
    ``decode(z_q NHWC)`` -> NHWC images."""

    config_class = MOVQConfig
    _class_name = "MOVQ"

    def __init__(self, config: MOVQConfig | None = None, **kwargs):
        super().__init__()
        cfg = config if config is not None else self.config_from_dict(kwargs)
        self.config = cfg
        self.encoder = Encoder(cfg)
        self.decoder = MoVQDecoder(cfg)
        self.quantize = VectorQuantizer(cfg.num_embeddings, cfg.quantized_embed_dim,
                                        commitment_cost=cfg.commitment_cost, metric="l2")
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
        quant = quantized_states.permute(0, 3, 1, 2)
        return self.decoder(self.post_quant_conv(quant), quant).permute(0, 2, 3, 1)

    def decode_code(self, codebook_indices):
        return self.decode(self.quantize.get_codebook_entry(codebook_indices))
