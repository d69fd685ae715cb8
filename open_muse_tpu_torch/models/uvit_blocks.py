"""v1 U-ViT building blocks over NHWC maps.

Counterpart of ``open_muse_tpu/models/uvit_blocks.py`` (the reference's
generic U-ViT toolbox in muse/modeling_transformer.py: AttentionBlock2D,
Norm2D, ResBlock with skip and AdaLN, Downsample/UpsampleBlock and the
VQGAN-style "vanilla" variants), with the JAX modules' parameter names, so
``core.convert.jax_params_to_state_dict`` carries their weights.  Norms and
attention go through ``ops.layers``, so through the fused-norm kernels and
``flash_attention`` on the card (``use_kernels=False`` takes the plain
code); ``UpsampleBlock``'s transposed convolution is a torch
``ConvTranspose2d``, whose kernel the converter flips.  Every block takes
and returns NHWC maps, as the JAX blocks do.
"""

from __future__ import annotations

import types
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layers import AdaLNModulation, Attention, GlobalResponseNorm, Norm
from . import transformer_v2

__all__ = [
    "Norm2D",
    "AttentionBlock2D",
    "ResBlock",
    "DownsampleBlock",
    "UpsampleBlock",
    "ResnetBlockVanilla",
    "DownsampleBlockVanilla",
    "UpsampleBlockVanilla",
]


def _nhwc(conv: nn.Module, x):
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Norm2D(transformer_v2.Norm2D):
    """The v2 model's channels-last norm (inner module ``norm``), built from
    the JAX block's arguments."""

    def __init__(self, dim: int, norm_type: str = "layernorm", eps: float = 1e-5,
                 use_bias: bool = False, elementwise_affine: bool = True):
        super().__init__(types.SimpleNamespace(norm_type=norm_type, layer_norm_eps=eps,
                                               use_bias=use_bias,
                                               ln_elementwise_affine=elementwise_affine), dim)


class AttentionBlock2D(nn.Module):
    """Two attention sublayers over a flattened NHWC map, both over the
    (mapped) text states, each after its norm and with its residual."""

    def __init__(self, hidden_size: int, num_heads: int, encoder_hidden_size: int,
                 norm_type: str = "layernorm", eps: float = 1e-6, use_bias: bool = False):
        super().__init__()
        self.kv_mapper = (nn.Linear(encoder_hidden_size, hidden_size, bias=use_bias)
                          if encoder_hidden_size != hidden_size else None)
        self.attn_layer_norm = Norm(hidden_size, norm_type, eps, use_bias)
        self.attention = Attention(hidden_size, num_heads, hidden_size, use_bias)
        self.crossattn_layer_norm = Norm(hidden_size, norm_type, eps, use_bias)
        self.crossattention = Attention(hidden_size, num_heads, hidden_size, use_bias)

    def forward(self, x, encoder_hidden_states, use_kernels: bool = True):
        b, h, w, c = x.shape
        hidden = x.reshape(b, h * w, c)
        if self.kv_mapper is not None:
            encoder_hidden_states = self.kv_mapper(F.silu(encoder_hidden_states))
        for norm, attention in ((self.attn_layer_norm, self.attention),
                                (self.crossattn_layer_norm, self.crossattention)):
            out = attention(norm(hidden, use_kernels=use_kernels), encoder_hidden_states,
                            use_kernels=use_kernels)
            hidden = out + hidden
        return hidden.reshape(b, h, w, c)


class ResBlock(nn.Module):
    """Depthwise conv (over [x | skip] when ``skip_channels``), norm, GRN
    channel MLP, the residual, then AdaLN when both ``cond_embed_dim`` and
    the call's ``cond_embeds`` are given."""

    def __init__(self, in_channels: int, skip_channels: int = 0, kernel_size: int = 3,
                 norm_type: str = "layernorm", cond_embed_dim: Optional[int] = None,
                 res_ffn_factor: int = 4, use_bias: bool = False):
        super().__init__()
        inner = int(in_channels * res_ffn_factor)
        self.depthwise = nn.Conv2d(in_channels + skip_channels, in_channels, kernel_size,
                                   padding=kernel_size // 2, groups=in_channels, bias=use_bias)
        self.norm = Norm2D(in_channels, norm_type, eps=1e-6, use_bias=use_bias)
        # indices as the JAX names: channelwise_0, _2, _4
        self.channelwise = nn.Sequential(
            nn.Linear(in_channels, inner, bias=use_bias), nn.GELU(), GlobalResponseNorm(inner),
            nn.Identity(), nn.Linear(inner, in_channels, bias=use_bias))
        self.adaLN_modulation = (AdaLNModulation(cond_embed_dim, in_channels, use_bias)
                                 if cond_embed_dim is not None else None)

    def forward(self, x, x_skip=None, cond_embeds=None, use_kernels: bool = True):
        h = x if x_skip is None else torch.cat([x, x_skip], dim=-1)
        h = self.norm(_nhwc(self.depthwise, h), use_kernels)
        h = self.channelwise(h) + x
        if cond_embeds is not None and self.adaLN_modulation is not None:
            h = self.adaLN_modulation(h, cond_embeds)
        return h


def _res_attn(channels, skip_channels, num_res_blocks, num_heads, encoder_hidden_size,
              cond_embed_dim, has_attention, norm_type, use_bias, first_skip_only):
    res = nn.ModuleList(
        ResBlock(channels, skip_channels=skip_channels if i == 0 or not first_skip_only else 0,
                 norm_type=norm_type, cond_embed_dim=cond_embed_dim, use_bias=use_bias)
        for i in range(num_res_blocks))
    attn = nn.ModuleList(
        AttentionBlock2D(channels, num_heads, encoder_hidden_size or channels,
                         norm_type=norm_type, use_bias=use_bias)
        for _ in range(num_res_blocks)) if has_attention else None
    return res, attn


class DownsampleBlock(nn.Module):
    """(norm + stride-2 conv to ``output_channels``) then ``num_res_blocks``
    x [ResBlock (each over [x | skip]) (+ AttentionBlock2D)]; returns (x,
    every ResBlock / attention output)."""

    def __init__(self, input_channels: int, output_channels: Optional[int] = None,
                 skip_channels: int = 0, num_res_blocks: int = 4, num_heads: Optional[int] = None,
                 encoder_hidden_size: Optional[int] = None, cond_embed_dim: Optional[int] = None,
                 add_downsample: bool = True, has_attention: bool = False,
                 norm_type: str = "layernorm", use_bias: bool = False):
        super().__init__()
        channels = output_channels or input_channels
        self.downsample = nn.Sequential(
            Norm2D(input_channels, norm_type, eps=1e-6, use_bias=use_bias),
            nn.Conv2d(input_channels, channels, 2, stride=2, bias=use_bias)
        ) if add_downsample else None
        self.res_blocks, self.attention_blocks = _res_attn(
            channels, skip_channels, num_res_blocks, num_heads, encoder_hidden_size,
            cond_embed_dim, has_attention, norm_type, use_bias, first_skip_only=False)

    def forward(self, x, x_skip=None, cond_embeds=None, encoder_hidden_states=None,
                use_kernels: bool = True):
        if self.downsample is not None:
            x = _nhwc(self.downsample[1], self.downsample[0](x, use_kernels))
        output_states = ()
        for i, res in enumerate(self.res_blocks):
            x = res(x, x_skip, cond_embeds, use_kernels)
            if self.attention_blocks is not None:
                x = self.attention_blocks[i](x, encoder_hidden_states, use_kernels)
            output_states += (x,)
        return x, output_states


class UpsampleBlock(nn.Module):
    """``num_res_blocks`` x [ResBlock (the first over [x | x_skip[0]]) (+
    AttentionBlock2D)] then (norm + stride-2 transposed conv to
    ``output_channels``)."""

    def __init__(self, input_channels: int, output_channels: Optional[int] = None,
                 skip_channels: int = 0, num_res_blocks: int = 4, num_heads: Optional[int] = None,
                 encoder_hidden_size: Optional[int] = None, cond_embed_dim: Optional[int] = None,
                 add_upsample: bool = True, has_attention: bool = False,
                 norm_type: str = "layernorm", use_bias: bool = False):
        super().__init__()
        self.res_blocks, self.attention_blocks = _res_attn(
            input_channels, skip_channels, num_res_blocks, num_heads, encoder_hidden_size,
            cond_embed_dim, has_attention, norm_type, use_bias, first_skip_only=True)
        self.upsample = nn.Sequential(
            Norm2D(input_channels, norm_type, eps=1e-6, use_bias=use_bias),
            nn.ConvTranspose2d(input_channels, output_channels or input_channels, 2, stride=2,
                               bias=use_bias)
        ) if add_upsample else None

    def forward(self, x, x_skip=None, cond_embeds=None, encoder_hidden_states=None,
                use_kernels: bool = True):
        for i, res in enumerate(self.res_blocks):
            skip = x_skip[0] if i == 0 and x_skip is not None else None
            x = res(x, skip, cond_embeds, use_kernels)
            if self.attention_blocks is not None:
                x = self.attention_blocks[i](x, encoder_hidden_states, use_kernels)
        if self.upsample is not None:
            x = _nhwc(self.upsample[1], self.upsample[0](x, use_kernels))
        return x


class ResnetBlockVanilla(nn.Module):
    """VQGAN-style res block: GroupNorm(32) + silu + 3x3 conv twice, and a
    3x3 (``use_conv_shortcut``) or 1x1 shortcut when the width changes."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 use_conv_shortcut: bool = False, use_bias: bool = False):
        super().__init__()
        out_ch = out_channels or in_channels
        self.norm1 = nn.GroupNorm(32, in_channels, eps=1e-6)
        self.conv1 = nn.Conv2d(in_channels, out_ch, 3, padding=1, bias=use_bias)
        self.norm2 = nn.GroupNorm(32, out_ch, eps=1e-6)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=use_bias)
        if in_channels != out_ch:
            k = 3 if use_conv_shortcut else 1
            shortcut = nn.Conv2d(in_channels, out_ch, k, padding=k // 2, bias=use_bias)
            setattr(self, "conv_shortcut" if use_conv_shortcut else "nin_shortcut", shortcut)
        self.shortcut_name = ("conv_shortcut" if use_conv_shortcut else "nin_shortcut") \
            if in_channels != out_ch else None

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        residual = x if self.shortcut_name is None else getattr(self, self.shortcut_name)(x)
        return (residual + h).permute(0, 2, 3, 1)


class DownsampleBlockVanilla(nn.Module):
    """``num_res_blocks`` ResnetBlockVanilla, then (pad right and bottom by
    one, 3x3 stride-2 conv); returns (x, every block's output and the
    downsampled map)."""

    def __init__(self, input_channels: int, output_channels: int, num_res_blocks: int = 4,
                 add_downsample: bool = True, use_bias: bool = False):
        super().__init__()
        self.res_blocks = nn.ModuleList(
            ResnetBlockVanilla(input_channels if i == 0 else output_channels, output_channels,
                               use_bias=use_bias) for i in range(num_res_blocks))
        self.downsample_conv = (nn.Conv2d(output_channels, output_channels, 3, stride=2,
                                          bias=use_bias) if add_downsample else None)

    def forward(self, x) -> Tuple[torch.Tensor, tuple]:
        output_states = ()
        for res in self.res_blocks:
            x = res(x)
            output_states += (x,)
        if self.downsample_conv is not None:
            x = _nhwc(self.downsample_conv, F.pad(x, (0, 0, 0, 1, 0, 1)))
            output_states += (x,)
        return x, output_states


class UpsampleBlockVanilla(nn.Module):
    """``num_res_blocks`` x [concat the last skip left, ResnetBlockVanilla],
    each skip of ``skip_channels``, then (nearest 2x, 3x3 conv with a
    bias)."""

    def __init__(self, input_channels: int, output_channels: int, skip_channels: int,
                 num_res_blocks: int = 4, add_upsample: bool = True, use_bias: bool = False):
        super().__init__()
        self.res_blocks = nn.ModuleList(
            ResnetBlockVanilla((input_channels if i == 0 else output_channels) + skip_channels,
                               output_channels, use_bias=use_bias)
            for i in range(num_res_blocks))
        self.upsample_conv = (nn.Conv2d(output_channels, output_channels, 3, padding=1)
                              if add_upsample else None)

    def forward(self, x, x_skip: Tuple):
        skips = list(x_skip)
        for res in self.res_blocks:
            x = res(torch.cat([x, skips.pop()], dim=-1))
        if self.upsample_conv is not None:
            x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
            x = self.upsample_conv(x).permute(0, 2, 3, 1)
        return x
