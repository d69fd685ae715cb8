"""MaskGitTransformer (v1), the BERT-style masked-token model, in PyTorch.

Counterpart of ``open_muse_tpu/models/transformer_v1.py``: the same blocks,
the same open-muse parameter names, and the original-MaskGIT decode
(``generate2``), class-conditional (the class id shifted past the codebook
and prepended) or text-conditional.  Every norm goes to the fused-norm
kernel and every unmasked attention to ``flash_attention`` (the wrappers in
``ops.layers``); the sampling tail is ``fused_categorical``.
``forward(..., use_kernels=False)`` runs the plain PyTorch path on the same
weights.  The lucidrains-style ``generate`` (top-k filter, Gumbel sample,
score re-masking) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.configuration import BaseConfig
from ..core.modeling import ModelMixin
from ..ops import sampling
from ..ops.layers import Attention, LayerNorm, Norm
from ..ops.losses import cross_entropy_loss
from .transformer_v2 import _conv1x1, decode_step

__all__ = ["MaskGitTransformer", "MaskGitTransformerConfig", "v1_schedules"]


@dataclasses.dataclass(frozen=True)
class MaskGitTransformerConfig(BaseConfig):
    vocab_size: int = 2025  # codebook + classes + mask
    hidden_size: int = 768
    embedding_size: Optional[int] = None
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    max_position_embeddings: int = 256
    add_cross_attention: bool = False
    encoder_hidden_size: int = 1024
    project_encoder_hidden_states: bool = False
    initializer_range: float = 0.02
    norm_type: str = "layernorm"
    layer_norm_eps: float = 1e-5
    use_normformer: bool = True
    use_encoder_layernorm: bool = True
    use_mlm_layer: bool = True
    use_mlm_layernorm: bool = True
    use_bias: bool = False
    codebook_size: int = 1024
    num_vq_tokens: int = 256
    num_classes: Optional[int] = None
    use_codebook_size_for_output: bool = False
    use_conv_in_out: bool = False
    patch_size: int = 1

    @property
    def mask_token_id(self) -> int:
        return self.vocab_size - 1

    @property
    def output_size(self) -> int:
        return self.codebook_size if self.use_codebook_size_for_output else self.vocab_size


def _norm(cfg, dim):
    return Norm(dim, cfg.norm_type, cfg.layer_norm_eps, cfg.use_bias)


class Embed(nn.Module):
    """word + learned position embeddings."""

    def __init__(self, cfg):
        super().__init__()
        emb = cfg.embedding_size or cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, emb)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, emb)

    def forward(self, input_ids, use_kernels: bool = True):
        positions = torch.arange(input_ids.shape[-1], device=input_ids.device)
        return self.word_embeddings(input_ids) + self.position_embeddings(positions)[None]


class ConvEmbed(nn.Module):
    """token embedding -> norm -> pixel-unshuffle -> 1x1 conv -> + positions.
    The position table always has 256 rows: the reference never forwards
    ``max_position_embeddings`` to it."""

    def __init__(self, cfg):
        super().__init__()
        emb, p = cfg.embedding_size or cfg.hidden_size, cfg.patch_size
        self.patch_size = p
        self.embeddings = nn.Embedding(cfg.vocab_size, emb)
        self.layer_norm = _norm(cfg, emb)
        self.conv = nn.Conv2d(emb * p * p, cfg.hidden_size, 1, bias=cfg.use_bias)
        self.position_embeddings = nn.Embedding(256, cfg.hidden_size)

    def forward(self, input_ids, use_kernels: bool = True):
        batch, seq_len = input_ids.shape
        side, p = math.isqrt(seq_len), self.patch_size
        x = self.layer_norm(self.embeddings(input_ids.reshape(batch, side, side)),
                            use_kernels=use_kernels)
        if p > 1:  # NHWC pixel-unshuffle with torch's channel order (C, u, v)
            b, h, w, c = x.shape
            x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
            x = x.reshape(b, h // p, w // p, c * p * p)
        x = _conv1x1(self.conv, x).reshape(batch, -1, self.conv.out_channels)
        positions = torch.arange(x.shape[1], device=x.device)
        return x + self.position_embeddings(positions)[None]


class MlmLayer(nn.Module):
    """dense -> gelu -> norm -> logits."""

    def __init__(self, cfg):
        super().__init__()
        self.mlm_dense = nn.Linear(cfg.hidden_size, cfg.hidden_size, bias=cfg.use_bias)
        self.mlm_ln = _norm(cfg, cfg.hidden_size) if cfg.use_mlm_layernorm else None
        self.to_logits = nn.Linear(cfg.hidden_size, cfg.output_size, bias=cfg.use_bias)

    def forward(self, x, use_kernels: bool = True):
        x = F.gelu(self.mlm_dense(x))
        if self.mlm_ln is not None:
            x = self.mlm_ln(x, use_kernels=use_kernels)
        return self.to_logits(x)


class Norm2D(nn.Module):
    """Channels-last norm over NHWC maps; the inner module is named ``norm``
    as in the reference parameter tree."""

    def __init__(self, cfg, dim):
        super().__init__()
        self.norm = _norm(cfg, dim)

    def forward(self, x, use_kernels: bool = True):
        return self.norm(x, use_kernels=use_kernels)


class ConvMlmLayer(nn.Module):
    """1x1 conv -> pixel-shuffle -> Norm2D -> 1x1 conv to logits."""

    def __init__(self, cfg):
        super().__init__()
        emb, p = cfg.embedding_size or cfg.hidden_size, cfg.patch_size
        self.patch_size = p
        self.conv1 = nn.Conv2d(cfg.hidden_size, emb * p * p, 1, bias=cfg.use_bias)
        self.layer_norm = Norm2D(cfg, emb)
        self.conv2 = nn.Conv2d(emb, cfg.output_size, 1, bias=cfg.use_bias)

    def forward(self, x, use_kernels: bool = True):
        batch, seq_len, hidden = x.shape
        side, p = math.isqrt(seq_len), self.patch_size
        x = _conv1x1(self.conv1, x.reshape(batch, side, side, hidden))
        if p > 1:
            b, h, w, _ = x.shape
            x = x.reshape(b, h, w, -1, p, p).permute(0, 1, 4, 2, 5, 3).reshape(b, h * p, w * p, -1)
        logits = _conv1x1(self.conv2, self.layer_norm(x, use_kernels))
        return logits.reshape(batch, -1, logits.shape[-1])


class FeedForward(nn.Module):
    """Normformer GLU FFN.  The pre-MLP norm is a LayerNorm whatever
    ``norm_type`` says, as in the reference."""

    def __init__(self, cfg):
        super().__init__()
        d, inner = cfg.hidden_size, cfg.intermediate_size
        self.pre_mlp_layer_norm = LayerNorm(d, cfg.layer_norm_eps, cfg.use_bias)
        self.wi_0 = nn.Linear(d, inner, bias=cfg.use_bias)
        self.wi_1 = nn.Linear(d, inner, bias=cfg.use_bias)
        self.mid_mlp_layer_norm = _norm(cfg, inner) if cfg.use_normformer else None
        self.wo = nn.Linear(inner, d, bias=cfg.use_bias)

    def forward(self, x, use_kernels: bool = True):
        x = self.pre_mlp_layer_norm(x, use_kernels=use_kernels)
        x = F.gelu(self.wi_0(x)) * self.wi_1(x)
        if self.mid_mlp_layer_norm is not None:
            x = self.mid_mlp_layer_norm(x, use_kernels=use_kernels)
        return self.wo(x)


class TransformerLayer(nn.Module):
    """Pre-norm self-attention (+ cross-attention) + FFN, with Normformer's
    post-attention norms."""

    def __init__(self, cfg):
        super().__init__()
        d, heads = cfg.hidden_size, cfg.num_attention_heads
        post = (lambda: _norm(cfg, d)) if cfg.use_normformer else (lambda: None)
        self.attn_layer_norm = _norm(cfg, d)
        self.attention = Attention(d, heads, use_bias=cfg.use_bias)
        self.post_attn_layer_norm = post()
        if cfg.add_cross_attention:
            context = d if cfg.project_encoder_hidden_states else cfg.encoder_hidden_size
            self.crossattn_layer_norm = _norm(cfg, d)
            self.crossattention = Attention(d, heads, context, cfg.use_bias)
            self.post_crossattn_layer_norm = post()
        self.ffn = FeedForward(cfg)

    def precompute(self, encoder_hidden_states=None):
        """Tensors constant across decode steps: the concatenated
        self-attention weights and the cross-attention [k|v]."""
        ctx = {"wqkv": self.attention.qkv_weight()}
        if encoder_hidden_states is not None:
            ctx["cross_kv"] = self.crossattention.precompute_kv(encoder_hidden_states)
        return ctx

    @staticmethod
    def _post(norm, h, use_kernels):
        return h if norm is None else norm(h, use_kernels=use_kernels)

    def forward(self, x, encoder_hidden_states=None, encoder_attention_mask=None, ctx=None,
                use_kernels: bool = True):
        ctx = ctx if ctx is not None else self.precompute(encoder_hidden_states)
        h = self.attn_layer_norm(x, use_kernels=use_kernels)
        h = self.attention(h, qkv_weight=ctx["wqkv"], use_kernels=use_kernels)
        x = x + self._post(self.post_attn_layer_norm, h, use_kernels)
        if encoder_hidden_states is not None:
            # (B, 1, 1, K) True where a key is masked out
            mask = (None if encoder_attention_mask is None
                    else (encoder_attention_mask == 0)[:, None, None, :])
            h = self.crossattn_layer_norm(x, use_kernels=use_kernels)
            h = self.crossattention(h, cached_kv=ctx["cross_kv"], attention_mask=mask,
                                    use_kernels=use_kernels)
            x = x + self._post(self.post_crossattn_layer_norm, h, use_kernels)
        return x + self.ffn(x, use_kernels)


class MaskGitTransformer(ModelMixin, nn.Module):
    """``forward(input_ids (B, S))`` -> logits (B, S, output_size), with
    ``encoder_hidden_states`` (B, L, E) when the config adds
    cross-attention, or (logits, loss) when ``labels`` are given.  A
    class-conditional model takes the shifted class id as token 0."""

    config_class = MaskGitTransformerConfig
    _class_name = "MaskGitTransformer"

    def __init__(self, config: MaskGitTransformerConfig | None = None, **kwargs):
        super().__init__()
        cfg = config if config is not None else self.config_from_dict(kwargs)
        self.config = cfg
        d = cfg.hidden_size
        if cfg.add_cross_attention and cfg.project_encoder_hidden_states:
            self.encoder_proj = nn.Linear(cfg.encoder_hidden_size, d, bias=cfg.use_bias)
            self.encoder_proj_layer_norm = _norm(cfg, d)
        self.embed = ConvEmbed(cfg) if cfg.use_conv_in_out else Embed(cfg)
        self.transformer_layers = nn.ModuleList(
            [TransformerLayer(cfg) for _ in range(cfg.num_hidden_layers)])
        self.encoder_layer_norm = _norm(cfg, d) if cfg.use_encoder_layernorm else None
        if not cfg.use_mlm_layer:
            self.to_logits = nn.Linear(d, cfg.output_size, bias=cfg.use_bias)
        elif cfg.use_conv_in_out:
            self.mlm_layer = ConvMlmLayer(cfg)
        else:
            self.mlm_layer = MlmLayer(cfg)

    @property
    def dtype(self) -> torch.dtype:
        return self.transformer_layers[0].attention.query.weight.dtype

    def project_context(self, encoder_hidden_states, use_kernels: bool = True):
        """The text states the cross-attention reads (projected and normed
        when the config says so); None stays None."""
        if encoder_hidden_states is None:
            return None
        ehs = encoder_hidden_states.to(self.dtype)
        if hasattr(self, "encoder_proj"):
            ehs = self.encoder_proj_layer_norm(self.encoder_proj(ehs), use_kernels=use_kernels)
        return ehs

    def step_context(self, encoder_hidden_states=None):
        """Every tensor constant across MaskGIT decode steps."""
        ehs = self.project_context(encoder_hidden_states)
        return {"ehs": ehs, "layers": [layer.precompute(ehs) for layer in self.transformer_layers]}

    def forward(self, input_ids, encoder_hidden_states=None, encoder_attention_mask=None,
                labels=None, label_smoothing: float = 0.0, step_ctx=None,
                use_kernels: bool = True):
        cfg = self.config
        if step_ctx is None:
            ehs = self.project_context(encoder_hidden_states, use_kernels)
            layer_ctx = [None] * cfg.num_hidden_layers
        else:
            ehs, layer_ctx = step_ctx["ehs"], step_ctx["layers"]
        x = self.embed(input_ids, use_kernels)
        for layer, ctx in zip(self.transformer_layers, layer_ctx):
            x = layer(x, ehs, encoder_attention_mask, ctx, use_kernels)
        if self.encoder_layer_norm is not None:
            x = self.encoder_layer_norm(x, use_kernels=use_kernels)
        logits = (self.mlm_layer(x, use_kernels) if cfg.use_mlm_layer else self.to_logits(x))
        if labels is None:
            return logits
        return logits, cross_entropy_loss(logits, labels, label_smoothing)

    @torch.no_grad()
    def generate2(self, input_ids=None, class_ids=None, encoder_hidden_states=None,
                  negative_embeds=None, temperature=1.0, timesteps: int = 18,
                  guidance_scale: float = 0.0, noise_schedule=sampling.cosine_schedule,
                  generator=None, noise=None):
        """Original-MaskGIT parallel decode -> the token ids (B, S) committed
        at the last step.  ``class_ids`` (B,) are shifted past the codebook
        and prepended at every step; text states take CFG when
        ``guidance_scale > 0`` (none for class ids).  Noise comes from the
        CPU ``generator`` or is ``noise=(sample_gumbel (T, B, S, >= codebook),
        mask_gumbel (T, B, S))``, as the JAX loop draws them from its key
        chain."""
        cfg = self.config
        device = self.transformer_layers[0].attention.query.weight.device
        if class_ids is not None:
            class_ids = torch.as_tensor(class_ids, device=device).long().reshape(-1)
            class_ids = class_ids + cfg.codebook_size
            batch = class_ids.shape[0]
        elif encoder_hidden_states is not None:
            batch = encoder_hidden_states.shape[0]
        elif input_ids is not None:
            batch = input_ids.shape[0]
        else:
            raise ValueError("provide class_ids, encoder_hidden_states or input_ids")
        if input_ids is None:
            input_ids = torch.full((batch, cfg.num_vq_tokens), cfg.mask_token_id,
                                   dtype=torch.long, device=device)
        use_cfg = encoder_hidden_states is not None and guidance_scale > 0
        condition = encoder_hidden_states
        if use_cfg:
            uncond = (torch.zeros_like(encoder_hidden_states) if negative_embeds is None
                      else negative_embeds.to(encoder_hidden_states))
            condition = torch.cat([encoder_hidden_states, uncond], dim=0)
        temperatures, mask_ratios = v1_schedules(timesteps, temperature, noise_schedule)
        sample_gumbel, mask_gumbel = (None, None) if noise is None else noise
        step_ctx = self.step_context(condition)
        ids = input_ids.long()
        sampled = ids
        for step in range(timesteps):
            model_ids = ids if class_ids is None else torch.cat([class_ids[:, None], ids], dim=1)
            if use_cfg:
                model_ids = torch.cat([model_ids, model_ids], dim=0)
            raw = self(model_ids, step_ctx=step_ctx)
            if class_ids is not None:
                raw = raw[:, 1:].contiguous()
            ids, sampled = decode_step(
                raw, ids, step, mask_token_id=cfg.mask_token_id, codebook_size=cfg.codebook_size,
                guidance_scale=guidance_scale if use_cfg else None,
                mask_ratio=mask_ratios[step], temperature=float(temperatures[step]),
                generator=generator, sample_gumbel=sample_gumbel, mask_gumbel=mask_gumbel)
        return sampled


def v1_schedules(timesteps: int, temperature=1.0, noise_schedule=sampling.cosine_schedule):
    """Per-step (temperatures, mask ratios), fp32 CPU tensors, as the JAX
    ``generate2`` computes them: a scalar temperature anneals as
    ``temperature * cumprod(1 - ratios)`` (the reference rebinds it every
    step), a (start, end) pair linearly, by ``jnp.linspace``'s fp32 formula
    ``start (1 - t) + end t``."""
    ratios = (torch.arange(timesteps, dtype=torch.float32) + 1) / timesteps
    if isinstance(temperature, (tuple, list)):
        start, end = (float(t) for t in temperature)
        if timesteps > 1:
            t = torch.arange(timesteps - 1, dtype=torch.float32) * torch.tensor(
                1.0 / (timesteps - 1), dtype=torch.float32)
            temperatures = torch.cat([start * (1 - t) + end * t, torch.tensor([end])])
        else:
            temperatures = torch.tensor([start])
    else:
        temperatures = temperature * torch.cumprod(1.0 - ratios, dim=0)
    return temperatures.to(torch.float32), noise_schedule(ratios).to(torch.float32)
