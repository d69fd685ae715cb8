"""MaskGitTransformer (v1), the BERT-style masked-token model, in PyTorch.

Counterpart of ``open_muse_tpu/models/transformer_v1.py``: the same blocks,
the same open-muse parameter names, and the original-MaskGIT decode
(``generate2``) and the lucidrains-style one (``generate``: top-k filter,
Gumbel sample, score re-masking), class-conditional (the class id shifted
past the codebook and prepended) or text-conditional.  Every norm goes to
the fused-norm kernel and every unmasked attention to ``flash_attention``
(the wrappers in ``ops.layers``); ``generate2``'s sampling tail is
``fused_categorical``.  On the card each decode is one captured CUDA graph
(``core.captured``), as each is one jitted program in JAX.
``forward(..., use_kernels=False)`` runs the plain PyTorch path on the same
weights.  For training, ``forward`` takes the JAX module's
``cond_dropout_mask`` and, as its ``deterministic=False``, a ``dropout``
source of keep masks (``KeepMasks``) for the two ``hidden_dropout`` sites.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.captured import captured
from ..core.configuration import BaseConfig
from ..core.modeling import ModelMixin
from ..kernels.fused_sample import sample_gumbel
from ..ops import sampling
from ..ops.layers import Attention, LayerNorm, Norm, column_linear, row_linear
from ..ops.losses import cross_entropy_loss
from ..parallel.tensor_parallel import copy_to_tp, gather_from_tp, scatter_to_tp
from .transformer_v2 import _conv1x1, _split_conv1x1, decode_noise, decode_step

__all__ = ["MaskGitTransformer", "MaskGitTransformerConfig", "KeepMasks", "v1_schedules",
           "v1_decode_loop", "v1_generate_loop", "masked_counts"]


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


class KeepMasks:
    """The v1 forward's dropout draws: ``masks(shape, keep_prob, device)`` ->
    a bool keep mask, uniforms from ``generator`` below ``keep_prob``, as
    flax's ``nn.Dropout`` draws its Bernoulli mask.  Inside a captured train
    step the generator is registered with the graph, so every replay draws
    fresh masks on the device.  Any callable of this signature can stand in
    for it (the tests hand over the JAX module's masks).  ``share``: (this
    rank, the rank count) of a batch split over ranks
    (``parallel.mesh.DataParallel.share``): a rank draws the global batch's
    masks (dim 0 the batch) and keeps its rows; the ranks of a tp group
    share a batch share and a generator, so they draw the same masks (trap 4
    of the tensor-parallel port)."""

    def __init__(self, generator: torch.Generator, share=(0, 1)):
        self.generator = generator
        self.share = share

    def __call__(self, shape, keep_prob: float, device) -> torch.Tensor:
        rank, world = self.share
        if world == 1:
            return torch.rand(shape, generator=self.generator, device=device) < keep_prob
        n = shape[0]
        draw = torch.rand((world * n, *shape[1:]), generator=self.generator, device=device)
        return draw[rank * n:(rank + 1) * n] < keep_prob


def _dropout(x, rate: float, masks, tp=None):
    """flax ``nn.Dropout(rate)`` at ``deterministic=False`` with keep masks
    from ``masks``: kept values scaled by 1 / (1 - rate), the rest zero.
    ``x`` itself when ``masks`` is None (``deterministic=True``) or the rate
    is 0, so nothing is drawn or launched.  ``tp``: ``x``'s last dim is this
    rank's part of a tp-split dim; the mask is drawn whole and sliced, so a
    tp run draws the masks one process draws."""
    if masks is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    if tp is None:
        keep = masks(x.shape, keep_prob, x.device)
    else:
        keep = tp.shard_last(masks((*x.shape[:-1], tp.size * x.shape[-1]), keep_prob, x.device))
    return torch.where(keep, x / keep_prob, 0.0)


class Embed(nn.Module):
    """word + learned position embeddings."""

    def __init__(self, cfg):
        super().__init__()
        emb = cfg.embedding_size or cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, emb)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, emb)
        self.hidden_dropout = cfg.hidden_dropout

    def forward(self, input_ids, use_kernels: bool = True, masks=None):
        positions = torch.arange(input_ids.shape[-1], device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.position_embeddings(positions)[None]
        return _dropout(x, self.hidden_dropout, masks)


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

    def forward(self, input_ids, use_kernels: bool = True, masks=None):
        """No dropout here (``masks`` is ignored), as in the JAX module."""
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
    """1x1 conv -> pixel-shuffle -> Norm2D -> 1x1 conv to logits; under
    tensor-parallel weights (``tp``) ``conv2`` holds this rank's part of the
    logits, gathered whole on every rank (as the v2 head's)."""

    tp_leaves = ("conv2.weight",)
    tp = None

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
        x = self.layer_norm(x, use_kernels)
        if self.tp is None:
            logits = _conv1x1(self.conv2, x)
        else:
            logits = gather_from_tp(_split_conv1x1(self.conv2, copy_to_tp(x, self.tp), self.tp),
                                    self.tp)
        return logits.reshape(batch, -1, logits.shape[-1])


class FeedForward(nn.Module):
    """Normformer GLU FFN, dropout before ``wo``.  The pre-MLP norm is a
    LayerNorm whatever ``norm_type`` says, as in the reference.  Under
    tensor-parallel weights (``tp``) ``wi_0`` / ``wi_1`` hold this rank's
    columns and ``wo`` their rows; the mid-MLP norm, which normalises the
    split width, runs on the whole row (trap 2 of the tensor-parallel port:
    the row is gathered around the norm kernel and sliced back), and the
    dropout mask over the split width is drawn whole and sliced."""

    tp_leaves = ("wi_0.weight", "wi_1.weight", "wo.weight")
    tp = None

    def __init__(self, cfg):
        super().__init__()
        d, inner = cfg.hidden_size, cfg.intermediate_size
        self.pre_mlp_layer_norm = LayerNorm(d, cfg.layer_norm_eps, cfg.use_bias)
        self.wi_0 = nn.Linear(d, inner, bias=cfg.use_bias)
        self.wi_1 = nn.Linear(d, inner, bias=cfg.use_bias)
        self.mid_mlp_layer_norm = _norm(cfg, inner) if cfg.use_normformer else None
        self.wo = nn.Linear(inner, d, bias=cfg.use_bias)
        self.hidden_dropout = cfg.hidden_dropout

    def forward(self, x, use_kernels: bool = True, masks=None):
        tp = self.tp
        x = copy_to_tp(self.pre_mlp_layer_norm(x, use_kernels=use_kernels), tp)
        x = F.gelu(column_linear(x, self.wi_0, tp)) * column_linear(x, self.wi_1, tp)
        if self.mid_mlp_layer_norm is not None:
            x = scatter_to_tp(self.mid_mlp_layer_norm(gather_from_tp(x, tp),
                                                      use_kernels=use_kernels), tp)
        return row_linear(_dropout(x, self.hidden_dropout, masks, tp), self.wo, tp)


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
                use_kernels: bool = True, masks=None):
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
        return x + self.ffn(x, use_kernels, masks)


class MaskGitTransformer(ModelMixin, nn.Module):
    """``forward(input_ids (B, S))`` -> logits (B, S, output_size), with
    ``encoder_hidden_states`` (B, L, E) when the config adds
    cross-attention, or (logits, loss) when ``labels`` are given.  A
    class-conditional model takes the shifted class id as token 0.
    Training passes ``cond_dropout_mask`` (B, 1, 1), multiplied into the
    text states after their projection and norm (CFG cond dropout), and
    ``dropout`` keep masks (``KeepMasks``) for ``hidden_dropout`` after the
    embeddings and before each FFN's ``wo``; there is no attention
    dropout, as in the JAX module."""

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
                use_kernels: bool = True, cond_dropout_mask=None, dropout=None):
        cfg = self.config
        if step_ctx is None:
            ehs = self.project_context(encoder_hidden_states, use_kernels)
            if ehs is not None and cond_dropout_mask is not None:
                ehs = ehs * cond_dropout_mask.to(ehs.dtype)
            layer_ctx = [None] * cfg.num_hidden_layers
        else:
            ehs, layer_ctx = step_ctx["ehs"], step_ctx["layers"]
        x = self.embed(input_ids, use_kernels, dropout)
        for layer, ctx in zip(self.transformer_layers, layer_ctx):
            x = layer(x, ehs, encoder_attention_mask, ctx, use_kernels, dropout)
        if self.encoder_layer_norm is not None:
            x = self.encoder_layer_norm(x, use_kernels=use_kernels)
        logits = (self.mlm_layer(x, use_kernels) if cfg.use_mlm_layer else self.to_logits(x))
        if labels is None:
            return logits
        return logits, cross_entropy_loss(logits, labels, label_smoothing)

    def _decode_inputs(self, input_ids, class_ids, encoder_hidden_states, negative_embeds,
                       guidance_scale):
        """(start ids, shifted class ids or None, the cross-attention
        condition or None, use_cfg), as both JAX decodes prepare them."""
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
        return input_ids.long().to(device), class_ids, condition, use_cfg

    def _captured(self, key, fn, input_ids, class_ids, condition, *tensors):
        """``fn(input_ids, class_ids, condition, *tensors)`` through
        ``core.captured``, the optional inputs left out of the graph's."""
        flags = (class_ids is not None, condition is not None)
        optional = [t for t in (class_ids, condition) if t is not None]

        def body(input_ids, *rest):
            rest = list(rest)
            cls = rest.pop(0) if flags[0] else None
            cond = rest.pop(0) if flags[1] else None
            return fn(input_ids, cls, cond, *rest)

        return captured(self, key + flags, body, input_ids, *optional, *tensors, modules=(self,))

    @torch.no_grad()
    def generate2(self, input_ids=None, class_ids=None, encoder_hidden_states=None,
                  negative_embeds=None, temperature=1.0, timesteps: int = 18,
                  guidance_scale: float = 0.0, noise_schedule=sampling.cosine_schedule,
                  generator=None, noise=None, **unused_kwargs):
        """Original-MaskGIT parallel decode -> the token ids (B, S) committed
        at the last step.  ``class_ids`` (B,) are shifted past the codebook
        and prepended at every step; text states take CFG when
        ``guidance_scale > 0`` (none for class ids).  Noise comes from the
        CPU ``generator`` or is ``noise=(sample_gumbel (T, B, S, >=
        codebook), mask_gumbel (T, B, S))``, as the JAX loop draws them from
        its key chain; either way it is drawn before the loop
        (``decode_noise``).  On the card the loop is one captured CUDA graph.
        The v2-only inputs a text pipeline passes (``cond_embeds``,
        ``empty_embeds``, ...) are ignored, as in the JAX model."""
        cfg = self.config
        input_ids, class_ids, condition, use_cfg = self._decode_inputs(
            input_ids, class_ids, encoder_hidden_states, negative_embeds, guidance_scale)
        temperatures, mask_ratios = v1_schedules(timesteps, temperature, noise_schedule)
        kind, sample_noise, mask_gumbel = decode_noise(
            generator, noise, timesteps=timesteps, batch=input_ids.shape[0],
            seq_len=input_ids.shape[1], vocab=cfg.codebook_size, device=input_ids.device)
        guidance = float(guidance_scale) if use_cfg else None

        def loop(input_ids, class_ids, condition, schedules, sample_noise, mask_gumbel):
            return v1_decode_loop(self, input_ids, class_ids, condition, schedules[0],
                                  schedules[1], guidance_scale=guidance, timesteps=timesteps,
                                  mask_gumbel=mask_gumbel, **{kind: sample_noise})

        schedules = torch.stack([temperatures, mask_ratios]).to(input_ids.device)
        return self._captured(("generate2", timesteps, guidance, kind), loop, input_ids,
                              class_ids, condition, schedules, sample_noise, mask_gumbel)

    @torch.no_grad()
    def generate(self, input_ids=None, class_ids=None, encoder_hidden_states=None,
                 temperature: float = 1.0, topk_filter_thres: float = 0.9,
                 timesteps: int = 18, guidance_scale: float = 3.0,
                 noise_schedule=sampling.cosine_schedule, generator=None, noise=None,
                 **unused_kwargs):
        """The lucidrains-style decode (``open_muse_tpu`` ``generate``): at
        each step re-mask the highest-scoring positions (a count fixed by
        the schedule), keep the top ``1 - topk_filter_thres`` of the
        codebook logits, Gumbel-sample at an annealed temperature, fill the
        masked positions and score every one by 1 - p(sample).  Noise is
        ``noise`` (T, B, S, codebook) Gumbel, as the JAX loop draws it from
        its key chain, or one (B, S, codebook) draw a step from the CPU
        ``generator``.  On the card the decode is one captured CUDA graph,
        keyed on what it bakes in: the guidance, threshold, temperature and
        the per-step masked counts."""
        cfg = self.config
        input_ids, class_ids, condition, use_cfg = self._decode_inputs(
            input_ids, class_ids, encoder_hidden_states, None, guidance_scale)
        batch, seq_len = input_ids.shape
        if (generator is None) == (noise is None):
            raise ValueError("pass exactly one of generator= and noise=")
        if noise is None:
            noise = torch.stack([sample_gumbel((batch, seq_len, cfg.codebook_size), generator)
                                 for _ in range(timesteps)])
        noise = torch.as_tensor(noise, dtype=torch.float32).to(input_ids.device)
        counts = masked_counts(timesteps, seq_len, noise_schedule)
        guidance = float(guidance_scale) if use_cfg else None

        def loop(input_ids, class_ids, condition, gumbel):
            return v1_generate_loop(self, input_ids, class_ids, condition, gumbel,
                                    guidance_scale=guidance, topk_filter_thres=topk_filter_thres,
                                    temperature=float(temperature), counts=counts)

        return self._captured(("generate", guidance, float(topk_filter_thres),
                               float(temperature), counts), loop, input_ids, class_ids,
                              condition, noise)


@torch.no_grad()
def v1_decode_loop(model, input_ids, class_ids, condition, temperatures, mask_ratios, *,
                   guidance_scale, timesteps: int, mask_gumbel, seeds=None,
                   sample_gumbel=None):
    """``generate2``'s loop with no host work inside (the v2
    ``parallel_decode_loop``'s contract): ``class_ids`` (B,) already shifted
    or None, ``condition`` the (CFG-doubled) text states or None,
    ``temperatures`` / ``mask_ratios`` (T,) and the noise on the device,
    ``guidance_scale`` a float with CFG, else None."""
    if (seeds is None) == (sample_gumbel is None):
        raise ValueError("pass exactly one of seeds= and sample_gumbel=")
    cfg = model.config
    step_ctx = model.step_context(condition)
    ids = input_ids.long()
    sampled = ids
    for step in range(timesteps):
        model_ids = ids if class_ids is None else torch.cat([class_ids[:, None], ids], dim=1)
        if guidance_scale is not None:
            model_ids = torch.cat([model_ids, model_ids], dim=0)
        raw = model(model_ids, step_ctx=step_ctx)
        if class_ids is not None:
            raw = raw[:, 1:].contiguous()
        ids, sampled, _ = decode_step(
            raw, ids, mask_token_id=cfg.mask_token_id, codebook_size=cfg.codebook_size,
            guidance_scale=guidance_scale, mask_ratio=mask_ratios[step],
            temperature=temperatures[step], mask_gumbel=mask_gumbel[step],
            seed=None if seeds is None else seeds[step:step + 1],
            sample_gumbel=None if sample_gumbel is None else sample_gumbel[step])
    return sampled


def masked_counts(timesteps: int, seq_len: int, noise_schedule=sampling.cosine_schedule):
    """The positions ``generate`` re-masks at each step, as the JAX loop
    fixes them at trace time: max(int(schedule(t) * S), 1) at t =
    linspace(0, 1, T), the cosine in float64, other schedules in fp32."""
    counts = []
    for timestep in np.linspace(0.0, 1.0, timesteps):
        if noise_schedule is sampling.cosine_schedule:
            prob = float(np.cos(timestep * np.pi * 0.5))
        else:
            prob = float(noise_schedule(torch.tensor(timestep, dtype=torch.float32)))
        counts.append(max(int(prob * seq_len), 1))
    return tuple(counts)


@torch.no_grad()
def v1_generate_loop(model, input_ids, class_ids, condition, gumbel, *, guidance_scale,
                     topk_filter_thres: float, temperature: float, counts):
    """``generate``'s loop, ``counts[t]`` positions re-masked at step t,
    ``gumbel`` (T, B, S, codebook) on the device."""
    cfg = model.config
    cb, timesteps = cfg.codebook_size, len(counts)
    step_ctx = model.step_context(condition)
    ids = input_ids.long()
    scores = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
    for step, count in enumerate(counts):
        # the highest scores, ties to the lower index (as lax.top_k)
        top = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :count]
        ids = ids.scatter(1, top, cfg.mask_token_id)
        model_ids = ids if class_ids is None else torch.cat([class_ids[:, None], ids], dim=1)
        if guidance_scale is not None:
            cond, uncond = model(torch.cat([model_ids, model_ids], dim=0),
                                 step_ctx=step_ctx)[..., :cb].chunk(2)
            logits = uncond + guidance_scale * (cond - uncond)
        else:
            logits = model(model_ids, step_ctx=step_ctx)[..., :cb]
        if class_ids is not None:
            logits = logits[:, 1:]
        filtered = sampling.top_k(logits, topk_filter_thres)
        step_temp = temperature * ((timesteps - 1 - step) / timesteps)
        pred_ids = sampling.gumbel_sample(filtered, step_temp, gumbel[step])
        ids = torch.where(ids == cfg.mask_token_id, pred_ids, ids)
        logits32 = logits.float()
        sel_logit = torch.gather(logits32, -1, pred_ids[..., None])[..., 0]
        scores = 1.0 - torch.exp(sel_logit - torch.logsumexp(logits32, dim=-1))
    return ids


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
