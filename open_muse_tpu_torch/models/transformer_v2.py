"""MaskGiTUViT_v2, the research U-ViT masked-token model, in PyTorch.

Counterpart of ``open_muse_tpu/models/transformer_v2.py``: the same blocks,
the same open-muse parameter names, NHWC activations, and the MaskGIT CFG
decode loop.  Both trunk attention sublayers run through the fused CUDA
kernels (``kernels.attn_sublayer``) when the config and shapes allow, the
FFN down-projection through ``kernels.glu_matmul`` and the CFG sampling tail
through ``kernels.fused_sample``; ``forward(..., use_kernels=False)`` runs
the plain PyTorch path on the same weights.  With ``labels`` the forward also
returns the masked-token loss, and ``set_gradient_checkpointing(True)``
recomputes each trunk layer in the backward, as JAX's ``remat`` does
(``'dots'``: only what is not a matmul, as ``remat='dots'``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from ..core.captured import captured
from ..core.configuration import BaseConfig
from ..core.modeling import ModelMixin
from ..kernels.attn_sublayer import (attn_sublayer_cross, attn_sublayer_self,
                                     sublayer_shapes_supported)
from ..kernels.fused_sample import draw_seed, fused_categorical, fused_categorical_cfg
from ..kernels.fused_sample import sample_gumbel as gumbel_noise
from ..kernels.glu_matmul import glu_down_matmul, glu_down_matmul_plain
from ..ops import sampling
from ..ops.losses import cross_entropy_loss, weighted_cross_entropy_loss
from ..ops.layers import (AdaLNModulation, Attention, GlobalResponseNorm, LayerNorm, Norm,
                          column_linear, sinusoidal_encode)
from ..parallel.tensor_parallel import copy_to_tp, gather_from_tp, reduce_from_tp, scatter_to_tp

__all__ = ["MaskGiTUViT_v2", "MaskGiTUViT_v2Config", "decode_schedules", "decode_noise",
           "captured_decode", "parallel_decode_loop", "decode_step"]


@dataclasses.dataclass(frozen=True)
class MaskGiTUViT_v2Config(BaseConfig):
    hidden_size: int = 1024
    use_bias: bool = False
    hidden_dropout: float = 0.0

    cond_embed_dim: int = 768
    micro_cond_encode_dim: int = 256
    micro_cond_embed_dim: int = 1280
    encoder_hidden_size: int = 768

    vocab_size: int = 8256  # codebook + 1 mask token, rounded up
    mask_token_id: int = 8255
    codebook_size: int = 8192

    in_channels: int = 768
    block_out_channels: Tuple[int, ...] = (768,)
    num_res_blocks: int = 3
    force_down_up_sample: bool = False
    block_num_heads: int = 12

    num_hidden_layers: int = 22
    num_attention_heads: int = 16

    attention_dropout: float = 0.0

    intermediate_size: int = 2816
    use_fused_mlp: bool = False

    norm_type: str = "rmsnorm"
    layer_norm_eps: float = 1e-6
    ln_elementwise_affine: bool = True
    use_fused_residual_norm: bool = False

    add_cond_embeds: bool = True
    add_micro_cond_embeds: bool = True


def _norm(cfg, dim):
    return Norm(dim, cfg.norm_type, cfg.layer_norm_eps, cfg.use_bias, cfg.ln_elementwise_affine)


def _use_fused_attn_sublayer(cfg, tp=None) -> bool:
    """The fused sublayer kernels take the research shapes: rmsnorm with an
    affine scale, no bias, head_dim 64 in an even number of heads (of this
    rank's heads under tensor-parallel weights ``tp``)."""
    return (cfg.norm_type == "rmsnorm" and not cfg.use_bias and cfg.ln_elementwise_affine
            and sublayer_shapes_supported(cfg.hidden_size, cfg.num_attention_heads,
                                          1 if tp is None else tp.size))


def _nhwc_conv(conv: nn.Module, x):
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _conv1x1(conv: nn.Conv2d, x):
    """A 1x1 conv on NHWC maps as a matmul over the channel axis."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


def _split_conv1x1(conv: nn.Conv2d, x, tp):
    """``_conv1x1`` of a conv holding this rank's output channels."""
    return F.linear(x, conv.weight.flatten(1),
                    None if conv.bias is None else scatter_to_tp(conv.bias, tp))


class Norm2D(nn.Module):
    """Channels-last norm over NHWC maps; the inner module is named ``norm``
    as in the reference parameter tree."""

    def __init__(self, cfg, dim):
        super().__init__()
        self.norm = _norm(cfg, dim)

    def forward(self, x, use_kernels: bool = True):
        return self.norm(x, use_kernels=use_kernels)


class ConvEmbed(nn.Module):
    """token embedding -> norm -> 1x1 conv, NHWC out."""

    def __init__(self, cfg):
        super().__init__()
        self.embeddings = nn.Embedding(cfg.vocab_size, cfg.in_channels)
        self.layer_norm = _norm(cfg, cfg.in_channels)
        self.conv = nn.Conv2d(cfg.in_channels, cfg.block_out_channels[0], 1, bias=cfg.use_bias)

    def forward(self, input_ids, use_kernels: bool = True):
        batch, seq_len = input_ids.shape
        side = math.isqrt(seq_len)
        x = self.embeddings(input_ids).reshape(batch, side, side, -1)
        return _conv1x1(self.conv, self.layer_norm(x, use_kernels=use_kernels))


class ResBlock(nn.Module):
    """depthwise 3x3 conv + GRN channel MLP + AdaLN over NHWC maps."""

    def __init__(self, cfg, channels, res_ffn_factor: int = 4):
        super().__init__()
        inner = channels * res_ffn_factor
        self.depthwise = nn.Conv2d(channels, channels, 3, padding=1, groups=channels,
                                   bias=cfg.use_bias)
        self.norm = Norm2D(cfg, channels)
        self.channelwise = nn.Sequential(
            nn.Linear(channels, inner, bias=cfg.use_bias), nn.GELU(),
            GlobalResponseNorm(inner), nn.Dropout(cfg.hidden_dropout),
            nn.Linear(inner, channels, bias=cfg.use_bias))
        self.adaLN_modulation = AdaLNModulation(cfg.hidden_size, channels, cfg.use_bias)

    def forward(self, x, cond_embeds, adaln_cache=None, use_kernels: bool = True):
        h = self.channelwise(self.norm(_nhwc_conv(self.depthwise, x), use_kernels))
        return self.adaLN_modulation(h + x, cond_embeds, cached=adaln_cache)


class AttentionBlock2D(nn.Module):
    """Two cross-attention sublayers over flattened NHWC maps (the first is
    named ``attention`` as in the reference)."""

    def __init__(self, cfg, channels):
        super().__init__()
        self.attn_layer_norm = _norm(cfg, channels)
        self.attention = Attention(channels, cfg.block_num_heads, channels, cfg.use_bias)
        self.crossattn_layer_norm = _norm(cfg, channels)
        self.crossattention = Attention(channels, cfg.block_num_heads, channels, cfg.use_bias)
        self.kv_mapper = (nn.Linear(cfg.hidden_size, channels, bias=cfg.use_bias)
                          if cfg.hidden_size != channels else None)

    def precompute(self, encoder_hidden_states):
        mapped = encoder_hidden_states
        if self.kv_mapper is not None:
            mapped = self.kv_mapper(F.silu(mapped))
        return {"kv1": self.attention.precompute_kv(mapped),
                "kv2": self.crossattention.precompute_kv(mapped)}

    def forward(self, x, encoder_hidden_states, ctx=None, use_kernels: bool = True):
        ctx = ctx if ctx is not None else self.precompute(encoder_hidden_states)
        b, hh, ww, c = x.shape
        h = x.reshape(b, hh * ww, c)
        h1, residual = self.attn_layer_norm(h, return_residual=True, use_kernels=use_kernels)
        h1 = self.attention(h1, cached_kv=ctx["kv1"], use_kernels=use_kernels)
        h2, residual = self.crossattn_layer_norm(h1, residual, use_kernels=use_kernels)
        h2 = self.crossattention(h2, cached_kv=ctx["kv2"], use_kernels=use_kernels)
        return (h2 + residual).reshape(b, hh, ww, c)


class _ResAttnStack(nn.Module):
    """N x [ResBlock + AttentionBlock2D], shared by the down and up blocks."""

    def __init__(self, cfg, channels):
        super().__init__()
        self.res_blocks = nn.ModuleList(
            [ResBlock(cfg, channels) for _ in range(cfg.num_res_blocks)])
        self.attention_blocks = nn.ModuleList(
            [AttentionBlock2D(cfg, channels) for _ in range(cfg.num_res_blocks)])

    def precompute(self, cond_embeds, encoder_hidden_states):
        return [{"adaln": rb.adaLN_modulation.precompute(cond_embeds),
                 "attn": ab.precompute(encoder_hidden_states)}
                for rb, ab in zip(self.res_blocks, self.attention_blocks)]

    def _stack(self, x, cond_embeds, encoder_hidden_states, ctx, use_kernels):
        for i, (rb, ab) in enumerate(zip(self.res_blocks, self.attention_blocks)):
            x = rb(x, cond_embeds, None if ctx is None else ctx[i]["adaln"], use_kernels)
            x = ab(x, encoder_hidden_states, None if ctx is None else ctx[i]["attn"], use_kernels)
        return x


class DownsampleBlock(_ResAttnStack):
    """(optional norm + stride-2 conv) + N x [ResBlock + AttentionBlock2D]."""

    def __init__(self, cfg, channels):
        super().__init__(cfg, channels)
        self.downsample = (nn.Sequential(Norm2D(cfg, channels),
                                         nn.Conv2d(channels, channels, 2, stride=2,
                                                   bias=cfg.use_bias))
                           if cfg.force_down_up_sample else None)

    def forward(self, x, cond_embeds, encoder_hidden_states, ctx=None, use_kernels: bool = True):
        if self.downsample is not None:
            x = _nhwc_conv(self.downsample[1], self.downsample[0](x, use_kernels))
        return self._stack(x, cond_embeds, encoder_hidden_states, ctx, use_kernels)


class UpsampleBlock(_ResAttnStack):
    """N x [ResBlock + AttentionBlock2D] + (optional norm + stride-2
    transposed conv)."""

    def __init__(self, cfg, channels):
        super().__init__(cfg, channels)
        self.upsample = (nn.Sequential(Norm2D(cfg, channels),
                                       nn.ConvTranspose2d(channels, channels, 2, stride=2,
                                                          bias=cfg.use_bias))
                         if cfg.force_down_up_sample else None)

    def forward(self, x, cond_embeds, encoder_hidden_states, ctx=None, use_kernels: bool = True):
        x = self._stack(x, cond_embeds, encoder_hidden_states, ctx, use_kernels)
        if self.upsample is not None:
            x = _nhwc_conv(self.upsample[1], self.upsample[0](x, use_kernels))
        return x


class GLUFeedForward(nn.Module):
    """GLU FFN with the fused-residual prenorm.  The pre-MLP norm is a
    LayerNorm even under ``norm_type="rmsnorm"``, as in the reference.
    Under tensor-parallel weights (``tp``) ``wi_0`` / ``wi_1`` hold this
    rank's columns and ``wo`` their rows: the norm and AdaLN stay whole
    outside the split, the normed input enters it through ``copy_to_tp``,
    the GLU kernel runs on the rank's K columns, and its partial output is
    summed over the ranks."""

    tp_leaves = ("wi_0.weight", "wi_1.weight", "wo.weight")
    tp = None

    def __init__(self, cfg):
        super().__init__()
        self.pre_mlp_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.use_bias,
                                            cfg.ln_elementwise_affine)
        self.adaLN_modulation = AdaLNModulation(cfg.hidden_size, cfg.hidden_size, cfg.use_bias)
        self.wi_0 = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=cfg.use_bias)
        self.wi_1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=cfg.use_bias)
        self.wo = nn.Linear(cfg.intermediate_size, cfg.hidden_size, bias=cfg.use_bias)

    def forward(self, x, cond_embeds, residual=None, adaln_cache=None, use_kernels=True):
        x, residual = self.pre_mlp_layer_norm(x, residual, return_residual=True,
                                              use_kernels=use_kernels)
        x = copy_to_tp(self.adaLN_modulation(x, cond_embeds, cached=adaln_cache), self.tp)
        a, b = column_linear(x, self.wi_0, self.tp), column_linear(x, self.wi_1, self.tp)
        k = a.shape[-1]
        glu = glu_down_matmul if use_kernels and k % 8 == 0 else glu_down_matmul_plain
        out = glu(a.reshape(-1, k), b.reshape(-1, k), self.wo.weight)
        out = reduce_from_tp(out.reshape(*a.shape[:-1], -1), self.tp)
        return (out if self.wo.bias is None else out + self.wo.bias), residual


class TransformerLayer(nn.Module):
    """self-attn + cross-attn + GLU FFN, each with AdaLN and the
    fused-residual prenorm."""

    def __init__(self, cfg):
        super().__init__()
        self.config = cfg
        d, heads = cfg.hidden_size, cfg.num_attention_heads
        self.attn_layer_norm = _norm(cfg, d)
        self.self_attn_adaLN_modulation = AdaLNModulation(d, d, cfg.use_bias)
        self.attention = Attention(d, heads, use_bias=cfg.use_bias)
        self.crossattn_layer_norm = _norm(cfg, d)
        self.cross_attn_adaLN_modulation = AdaLNModulation(d, d, cfg.use_bias)
        self.crossattention = Attention(d, heads, d, cfg.use_bias)
        if _use_fused_attn_sublayer(cfg):
            # the fused kernels take an even head count: a tp that would give
            # a rank an odd one leaves both attentions whole (sharding.py)
            self.attention.head_multiple = self.crossattention.head_multiple = 2
        self.ffn = GLUFeedForward(cfg)

    def precompute(self, encoder_hidden_states, cond_embeds):
        """Tensors constant across decode steps: the AdaLN mapper outputs, the
        cross-attention [k|v] and the concatenated self-attention weights."""
        return {
            "self_adaln": self.self_attn_adaLN_modulation.precompute(cond_embeds),
            "cross_adaln": self.cross_attn_adaLN_modulation.precompute(cond_embeds),
            "cross_kv": self.crossattention.precompute_kv(encoder_hidden_states),
            "ffn_adaln": self.ffn.adaLN_modulation.precompute(cond_embeds),
            "wqkv": self.attention.qkv_weight(),
        }

    def forward(self, x, encoder_hidden_states, cond_embeds, residual=None, ctx=None,
                use_kernels=True):
        cfg = self.config
        if ctx is None:
            ctx = self.precompute(encoder_hidden_states, cond_embeds)
        tp = self.attention.tp
        if use_kernels and _use_fused_attn_sublayer(cfg, tp):
            # under tp: this rank's heads, the sums over the ranks inside the
            # Functions (kernels.attn_sublayer: the residual-gradient rule)
            x, residual = attn_sublayer_self(
                x, residual, self.attn_layer_norm.weight, ctx["self_adaln"], ctx["wqkv"][0],
                self.attention.out.weight, self.attention.local_heads, cfg.layer_norm_eps, tp)
            x, residual = attn_sublayer_cross(
                x, residual, self.crossattn_layer_norm.weight, ctx["cross_adaln"],
                self.crossattention.query.weight, self.crossattention.out.weight,
                ctx["cross_kv"], self.crossattention.local_heads, cfg.layer_norm_eps,
                self.crossattention.tp)
        else:
            x, residual = self.attn_layer_norm(x, residual, return_residual=True,
                                               use_kernels=use_kernels)
            x = self.self_attn_adaLN_modulation(x, cond_embeds, cached=ctx["self_adaln"])
            x = self.attention(x, qkv_weight=ctx["wqkv"], use_kernels=use_kernels)
            x, residual = self.crossattn_layer_norm(x, residual, use_kernels=use_kernels)
            x = self.cross_attn_adaLN_modulation(x, cond_embeds, cached=ctx["cross_adaln"])
            x = self.crossattention(x, cached_kv=ctx["cross_kv"], use_kernels=use_kernels)
        return self.ffn(x, cond_embeds, residual, ctx["ffn_adaln"], use_kernels)


class ConvMlmLayer(nn.Module):
    """1x1 conv -> Norm2D -> 1x1 conv to codebook logits.  Under
    tensor-parallel weights (``tp``) ``conv2`` holds this rank's part of the
    vocabulary: its logits are gathered whole on every rank (trap 3 of the
    tensor-parallel port), so the loss, label smoothing, soft targets and
    the bucket diagnostics read the whole rows."""

    tp_leaves = ("conv2.weight",)
    tp = None

    def __init__(self, cfg):
        super().__init__()
        self.conv1 = nn.Conv2d(cfg.block_out_channels[0], cfg.in_channels, 1, bias=cfg.use_bias)
        self.layer_norm = Norm2D(cfg, cfg.in_channels)
        self.conv2 = nn.Conv2d(cfg.in_channels, cfg.codebook_size, 1, bias=cfg.use_bias)

    def forward(self, x, use_kernels: bool = True):
        h = self.layer_norm(_conv1x1(self.conv1, x), use_kernels)
        if self.tp is None:
            return _conv1x1(self.conv2, h)
        return gather_from_tp(_split_conv1x1(self.conv2, copy_to_tp(h, self.tp), self.tp),
                              self.tp)


class MaskGiTUViT_v2(ModelMixin, nn.Module):
    """The U-ViT: ``forward(input_ids (B, S), encoder_hidden_states (B, L, E),
    cond_embeds (B, C), micro_conds (B, 5))`` -> logits (B, S, codebook),
    or (logits, loss) when ``labels`` are given.

    ``forward(..., use_kernels=False)`` runs the plain PyTorch path instead
    of the CUDA kernels; on CPU tensors both compute the plain versions."""

    config_class = MaskGiTUViT_v2Config
    _class_name = "MaskGiTUViT_v2"

    def __init__(self, config: MaskGiTUViT_v2Config | None = None, **kwargs):
        super().__init__()
        if config is None:
            config = self.config_from_dict(kwargs)
        # the reference re-registers mask_token_id as vocab_size - 1
        cfg = config.replace(mask_token_id=config.vocab_size - 1)
        self.config = cfg
        d, c = cfg.hidden_size, cfg.block_out_channels[0]
        self.encoder_proj = nn.Linear(cfg.encoder_hidden_size, d, bias=cfg.use_bias)
        self.encoder_proj_layer_norm = _norm(cfg, d)
        self.cond_embed = nn.Sequential(
            nn.Linear(cfg.cond_embed_dim + cfg.micro_cond_embed_dim, d, bias=cfg.use_bias),
            nn.SiLU(), nn.Linear(d, d, bias=cfg.use_bias))
        self.embed = ConvEmbed(cfg)
        self.down_blocks = nn.ModuleList([DownsampleBlock(cfg, c)])
        self.project_to_hidden_norm = _norm(cfg, cfg.block_out_channels[-1])
        self.project_to_hidden = nn.Linear(cfg.block_out_channels[-1], d, bias=cfg.use_bias)
        self.transformer_layers = nn.ModuleList(
            [TransformerLayer(cfg) for _ in range(cfg.num_hidden_layers)])
        self.project_from_hidden_norm = _norm(cfg, d)
        self.project_from_hidden = nn.Linear(d, cfg.block_out_channels[-1], bias=cfg.use_bias)
        self.up_blocks = nn.ModuleList([UpsampleBlock(cfg, c)])
        self.mlm_layer = ConvMlmLayer(cfg)
        self.gradient_checkpointing = False

    @property
    def dtype(self) -> torch.dtype:
        return self.encoder_proj.weight.dtype

    def set_gradient_checkpointing(self, mode) -> None:
        """``True`` recomputes each trunk layer in the backward (JAX's full
        ``remat``, ``torch.utils.checkpoint``), ``'dots'`` keeps the layer's
        matmul outputs and recomputes the rest, ``False`` keeps every
        activation."""
        if isinstance(mode, str) and mode != "dots":
            raise ValueError(f"gradient_checkpointing={mode!r}: true, false or 'dots'")
        self.gradient_checkpointing = mode if isinstance(mode, str) else bool(mode)

    def conditioning(self, encoder_hidden_states, cond_embeds, micro_conds,
                     use_kernels: bool = True):
        """(projected text states, conditioning vector)."""
        cfg, dtype = self.config, self.dtype
        ehs = self.encoder_proj_layer_norm(self.encoder_proj(encoder_hidden_states.to(dtype)),
                                           use_kernels=use_kernels)
        micro = sinusoidal_encode(micro_conds.reshape(-1), cfg.micro_cond_encode_dim)
        micro = micro.reshape(micro_conds.shape[0], -1)
        cond = torch.cat([cond_embeds.float(), micro.float()], dim=1).to(dtype)
        return ehs, self.cond_embed(cond)

    def step_context(self, encoder_hidden_states, cond_embeds, micro_conds):
        """Every tensor derived only from the text and conditioning inputs,
        constant across MaskGIT decode steps."""
        ehs, cond = self.conditioning(encoder_hidden_states, cond_embeds, micro_conds)
        return {
            "ehs": ehs,
            "cond": cond,
            "down": self.down_blocks[0].precompute(cond, ehs),
            "layers": [layer.precompute(ehs, cond) for layer in self.transformer_layers],
            "up": self.up_blocks[0].precompute(cond, ehs),
        }

    def forward(self, input_ids, encoder_hidden_states=None, cond_embeds=None,
                micro_conds=None, labels=None, loss_weight=None, label_smoothing: float = 0.0,
                step_ctx=None, use_kernels: bool = True):
        """Without ``step_ctx`` (training) every text- and cond-derived tensor
        is computed inside its own block, in the autograd graph and, under
        gradient checkpointing, inside the recomputed layer."""
        if step_ctx is None:
            ehs, cond = self.conditioning(encoder_hidden_states, cond_embeds, micro_conds,
                                          use_kernels)
            ctx_down = ctx_up = None
            ctx_layers = [None] * len(self.transformer_layers)
        else:
            ehs, cond = step_ctx["ehs"], step_ctx["cond"]
            ctx_down, ctx_layers, ctx_up = step_ctx["down"], step_ctx["layers"], step_ctx["up"]
        x = self.embed(input_ids, use_kernels)
        x = self.down_blocks[0](x, cond, ehs, ctx_down, use_kernels)
        batch, height, width, channels = x.shape
        x = x.reshape(batch, height * width, channels)
        x = self.project_to_hidden(self.project_to_hidden_norm(x, use_kernels=use_kernels))
        residual = None
        remat = self.gradient_checkpointing and step_ctx is None and torch.is_grad_enabled()
        context_fn = _save_dots if self.gradient_checkpointing == "dots" else noop_context_fn
        for layer, ctx in zip(self.transformer_layers, ctx_layers):
            if remat:
                # v2 has no dropout (hidden_dropout 0): the recompute draws
                # nothing, so the RNG state is neither saved nor restored,
                # which a CUDA graph capture could not do
                x, residual = checkpoint(layer, x, ehs, cond, residual, None, use_kernels,
                                         use_reentrant=False, preserve_rng_state=False,
                                         context_fn=context_fn)
            else:
                x, residual = layer(x, ehs, cond, residual, ctx, use_kernels)
        x = x + residual
        x = self.project_from_hidden(self.project_from_hidden_norm(x, use_kernels=use_kernels))
        x = self.up_blocks[0](x.reshape(batch, height, width, channels), cond, ehs, ctx_up,
                              use_kernels)
        batch, height, width, channels = x.shape
        logits = self.mlm_layer(x, use_kernels).reshape(batch, height * width, -1)
        if labels is None:
            return logits
        if loss_weight is not None:
            return logits, weighted_cross_entropy_loss(logits, labels, loss_weight,
                                                       label_smoothing)
        return logits, cross_entropy_loss(logits, labels, label_smoothing)

    @torch.no_grad()
    def generate2(self, encoder_hidden_states, cond_embeds, micro_conds, empty_embeds=None,
                  empty_cond_embeds=None, input_ids=None, negative_embeds=None,
                  negative_cond_embeds=None, temperature=1.0, timesteps: int = 18,
                  guidance_scale: float = 0.0, guidance_schedule: Optional[str] = None,
                  noise_schedule=sampling.cosine_schedule, generator=None, noise=None,
                  seq_len: Optional[int] = None, return_intermediate: bool = False):
        """MaskGIT parallel decode with CFG -> token ids (B, S), and with
        ``return_intermediate`` also each step's raw samples (T, B, S), as
        the JAX ``generate2`` returns them.  Noise comes from the CPU
        ``generator`` or is passed as ``noise=(sample_gumbel (T, B, S, V),
        mask_gumbel (T, B, S))``; either way it is drawn before the loop
        (``decode_noise``).  On the card the loop is one captured CUDA graph,
        cached under the JAX jit's key plus the baked-in guidance scales."""
        cfg = self.config
        batch = encoder_hidden_states.shape[0]
        seq_len = 256 if seq_len is None else seq_len
        device = encoder_hidden_states.device
        if input_ids is None:
            input_ids = torch.full((batch, seq_len), cfg.mask_token_id, dtype=torch.long,
                                   device=device)
        temperatures, guidance_scales, mask_ratios = decode_schedules(
            timesteps, temperature, guidance_scale, guidance_schedule, noise_schedule)
        if micro_conds.shape[0] == 1:
            micro_conds = micro_conds.expand(batch, *micro_conds.shape[1:])
        use_cfg = guidance_scale > 0
        if use_cfg:
            uncond = negative_embeds if negative_embeds is not None else empty_embeds
            uncond_cond = (negative_cond_embeds if negative_cond_embeds is not None
                           else empty_cond_embeds)
            ehs = torch.cat([encoder_hidden_states,
                             uncond.to(encoder_hidden_states.dtype).expand(
                                 encoder_hidden_states.shape)], dim=0)
            conds = torch.cat([cond_embeds, uncond_cond.to(cond_embeds.dtype).expand(
                cond_embeds.shape)], dim=0)
            micros = torch.cat([micro_conds, micro_conds], dim=0)
        else:
            ehs, conds, micros = encoder_hidden_states, cond_embeds, micro_conds
        drawn = decode_noise(generator, noise, timesteps=timesteps, batch=batch, seq_len=seq_len,
                             vocab=cfg.codebook_size, device=device)
        return captured_decode(
            self, input_ids.long(), ehs, conds, micros.to(device, torch.float32),
            torch.stack([temperatures, mask_ratios]).to(device), drawn,
            guidance_scales=tuple(guidance_scales.tolist()) if use_cfg else None,
            seq_len=seq_len, timesteps=timesteps, return_intermediate=return_intermediate)


# JAX's jax.checkpoint_policies.dots_with_no_batch_dims_saveable: the outputs of
# 2-D matmuls are kept, everything else (a batched matmul too) is recomputed.
# The CUDA kernels are ctypes launches, not aten ops, so they are recomputed,
# as JAX recomputes its pallas_calls under the same policy (they are not dots).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


_save_dots = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


def decode_noise(generator=None, noise=None, *, timesteps: int, batch: int, seq_len: int,
                 vocab: int, device):
    """All of a decode's noise on ``device``, drawn before the loop, for
    the v1 and v2 decodes: (kind, the sampler's noise, mask_gumbel (T, B, S)
    fp32), the sampler's noise being ``"seeds"`` (T,) int64, its Philox
    seeds (on the card, from a generator), or ``"sample_gumbel"`` (T, B, S,
    V') fp32 (on the CPU from a generator, or the given
    ``noise=(sample_gumbel, mask_gumbel)``; padded on the card to V' % 4 ==
    0, so that every step's slice stays 16-byte aligned).  A CPU
    ``generator`` is drawn from in the order the step-by-step loop drew:
    step t's sampler noise (its seed on the card, a (B, S, vocab) Gumbel
    draw on the CPU), then step t's mask noise."""
    if (generator is None) == (noise is None):
        raise ValueError("pass exactly one of generator= and noise=")
    device = torch.device(device)
    if noise is not None:
        sample, mask = (torch.as_tensor(n, dtype=torch.float32).to(device) for n in noise)
        if device.type == "cuda" and sample.shape[-1] % 4:
            sample = F.pad(sample, (0, -sample.shape[-1] % 4))
        return "sample_gumbel", sample, mask
    samples, masks = [], []
    for _ in range(timesteps):
        if device.type == "cuda":
            samples.append(torch.tensor(draw_seed(generator), dtype=torch.int64))
        else:
            samples.append(gumbel_noise((batch, seq_len, vocab), generator))
        masks.append(gumbel_noise((batch, seq_len), generator))
    return ("seeds" if device.type == "cuda" else "sample_gumbel",
            torch.stack(samples).to(device), torch.stack(masks).to(device))


def captured_decode(model, input_ids, ehs, conds, micros, schedules, noise, *,
                    guidance_scales, seq_len: int, timesteps: int,
                    return_intermediate: bool = False):
    """``parallel_decode_loop`` through ``core.captured``: eagerly on the
    CPU, one replayed CUDA graph on the card (the step context inside it).
    ``schedules`` (2, T) fp32 holds the temperatures and mask ratios on the
    device, ``noise`` is ``decode_noise``'s; ``guidance_scales`` (T floats,
    None without CFG) is baked into the graph and so into its key, as are
    the shapes and the noise's kind."""
    kind, sample_noise, mask_gumbel = noise

    def loop(input_ids, ehs, conds, micros, schedules, sample_noise, mask_gumbel):
        return parallel_decode_loop(
            model, input_ids, ehs, conds, micros, schedules[0], guidance_scales, schedules[1],
            use_cfg=guidance_scales is not None, seq_len=seq_len, timesteps=timesteps,
            mask_gumbel=mask_gumbel, return_intermediate=return_intermediate,
            **{kind: sample_noise})

    key = ("generate2", timesteps, return_intermediate, seq_len, guidance_scales, kind)
    return captured(model, key, loop, input_ids, ehs, conds, micros, schedules, sample_noise,
                    mask_gumbel, modules=(model,))


def decode_schedules(timesteps: int, temperature=1.0, guidance_scale: float = 0.0,
                     guidance_schedule: Optional[str] = None,
                     noise_schedule=sampling.cosine_schedule):
    """Per-step (temperatures, guidance scales, mask ratios), fp32 CPU
    tensors, computed as the JAX ``decode_schedules`` does."""
    if isinstance(temperature, (tuple, list)):
        temperatures = np.linspace(temperature[0], temperature[1], timesteps)
    else:
        temperatures = np.linspace(temperature, 0.01, timesteps)
    if guidance_schedule == "linear":
        guidance_scales = np.linspace(0, guidance_scale, timesteps)
    elif guidance_schedule == "cosine":
        ratios = (np.arange(timesteps) + 1) / timesteps
        guidance_scales = np.floor(np.cos((1 - ratios) * np.pi * 0.5) * guidance_scale)
    else:
        guidance_scales = np.full(timesteps, guidance_scale)
    ratios = (np.arange(timesteps, dtype=np.float64) + 1) / timesteps
    mask_ratios = noise_schedule(torch.tensor(ratios, dtype=torch.float32))
    return (torch.tensor(temperatures, dtype=torch.float32),
            torch.tensor(guidance_scales, dtype=torch.float32),
            mask_ratios.to(torch.float32))


@torch.no_grad()
def parallel_decode_loop(model, input_ids, ehs, conds, micros, temperatures,
                         guidance_scales, mask_ratios, *, use_cfg: bool, seq_len: int,
                         timesteps: int, mask_gumbel, seeds=None, sample_gumbel=None,
                         return_intermediate: bool = False, return_trajectory: bool = False,
                         row0: int = 0):
    """The MaskGIT decode: ``timesteps`` forwards of ``model`` with the
    text-derived tensors computed once (``model.step_context``), each
    followed by sampling and confidence re-masking.  Returns the token ids
    committed at the last step (B, S) int64, and with
    ``return_intermediate`` also each step's raw samples (T, B, S).  With
    ``return_trajectory`` it returns ``(final, states, sampled)``, the JAX
    distillation teacher's contract: ``states[t]`` (T, B, S) the carry-in ids
    of step t (``states[0]`` all masks), ``sampled[t]`` the committed grid
    after step t.

    No host work inside, so that one CUDA graph can hold it: the
    ``temperatures`` and ``mask_ratios`` (T,) and all noise lie on the
    device -- ``mask_gumbel`` (T, B, S) and either ``seeds`` (T,) int64,
    the sampling kernel's Philox seeds, or ``sample_gumbel`` (T, B, S, >=
    codebook) (``decode_noise`` draws them) -- and ``guidance_scales`` (T
    host floats, read without CFG never) is what a graph bakes in.  ``row0``:
    the first image's row in the seeds' Philox stream (a rank's share of a
    sharded batch)."""
    if (seeds is None) == (sample_gumbel is None):
        raise ValueError("pass exactly one of seeds= and sample_gumbel=")
    cfg = model.config
    if input_ids.shape[1] != seq_len:
        raise ValueError(f"input_ids {tuple(input_ids.shape)} vs seq_len {seq_len}")
    step_ctx = model.step_context(ehs, conds, micros)
    ids = input_ids.long()
    sampled, raws, states, committed = ids, [], [], []
    for step in range(timesteps):
        states.append(ids)
        model_input = torch.cat([ids, ids], dim=0) if use_cfg else ids
        raw = model(model_input, step_ctx=step_ctx)
        ids, sampled, raw_ids = decode_step(
            raw, ids, mask_token_id=cfg.mask_token_id, codebook_size=cfg.codebook_size,
            guidance_scale=float(guidance_scales[step]) if use_cfg else None,
            mask_ratio=mask_ratios[step], temperature=temperatures[step],
            mask_gumbel=mask_gumbel[step], seed=None if seeds is None else seeds[step:step + 1],
            sample_gumbel=None if sample_gumbel is None else sample_gumbel[step], row0=row0)
        raws.append(raw_ids)
        committed.append(sampled)
    if return_trajectory:
        return sampled, torch.stack(states), torch.stack(committed)
    return (sampled, torch.stack(raws)) if return_intermediate else sampled


def decode_step(raw, ids, *, mask_token_id: int, codebook_size: int, guidance_scale,
                mask_ratio, temperature, mask_gumbel, seed=None, sample_gumbel=None,
                row0: int = 0):
    """One MaskGIT step after the forward, shared by the v1 and v2 decodes:
    sample every position from the raw logits (B, S, >= codebook) (CFG
    halves, cond first, when ``guidance_scale`` is not None), keep the
    known tokens, and re-mask the ``floor(S * mask_ratio)`` least confident
    of the unknown ones (at least 1, at most all but one).  Returns (ids for
    the next step, the committed samples, the raw samples).  Noise: the
    sampler's ``seed`` (one int64 on the device) or ``sample_gumbel`` (B, S,
    >= codebook), and ``mask_gumbel`` (B, S); ``mask_ratio`` and
    ``temperature`` are 0-d device tensors (or floats); ``row0`` as in
    ``parallel_decode_loop``."""
    batch, seq_len = ids.shape
    if guidance_scale is not None:
        raw_ids, sel = fused_categorical_cfg(raw, guidance_scale, codebook_size,
                                             gumbel=sample_gumbel, seed=seed, row0=row0)
    else:
        raw_ids, sel = fused_categorical(raw, codebook_size, gumbel=sample_gumbel, seed=seed,
                                         row0=row0)
    raw_ids = raw_ids.long()
    unknown = ids == mask_token_id
    sampled = torch.where(unknown, raw_ids, ids)
    mask_len = torch.floor(seq_len * mask_ratio)
    mask_len = torch.clamp(torch.minimum(unknown.sum(-1, keepdim=True).float() - 1.0, mask_len),
                           min=1.0)
    # the sampler's confidence is taken at the raw samples; known positions
    # are pinned to fp32 max so they are never re-masked
    selected = torch.where(unknown, sel, torch.finfo(torch.float32).max)
    masking = sampling.mask_by_random_topk(mask_len, selected, temperature, mask_gumbel)
    return torch.where(masking, mask_token_id, sampled), sampled, raw_ids
