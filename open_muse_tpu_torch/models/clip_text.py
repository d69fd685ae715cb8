"""CLIP text encoder with projection, in PyTorch, with the HF parameter names.

Counterpart of ``open_muse_tpu/models/clip_text.py``: causal attention with
fp32 logits and softmax, every layer's hidden state returned, EOS-argmax
pooling and the projection.  Plain PyTorch: JAX runs it outside any Pallas
kernel.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.configuration import BaseConfig
from ..core.modeling import ModelMixin
from ..ops.layers import dot_product_attention

__all__ = ["CLIPTextConfig", "CLIPTextEncoder", "SimpleTokenizer"]


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig(BaseConfig):
    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: int = 512
    eos_token_id: int = 49407


def _act(name):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name in ("gelu", "gelu_new"):
        return lambda x: F.gelu(x, approximate="tanh" if name == "gelu_new" else "none")
    raise ValueError(f"unknown activation {name}")


class _LayerNorm(nn.Module):
    """LayerNorm computed in fp32 and cast back to the input dtype."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + self.eps)
        return (out * self.weight.float() + self.bias.float()).to(x.dtype)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.heads = cfg.num_attention_heads
        d = cfg.hidden_size
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x, causal_mask):
        b, t, d = x.shape
        hd = d // self.heads
        split = lambda y: y.reshape(b, t, self.heads, hd)  # noqa: E731
        out = dot_product_attention(split(self.q_proj(x)), split(self.k_proj(x)),
                                    split(self.v_proj(x)), scale=hd ** -0.5, mask=causal_mask)
        return self.out_proj(out.reshape(b, t, d))


class _MLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.act = _act(cfg.hidden_act)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = _LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = _MLP(cfg)
        self.layer_norm2 = _LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x, causal_mask):
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = _LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


class CLIPTextEncoder(ModelMixin, nn.Module):
    """``forward(input_ids (B, T))`` -> (hidden_states tuple of (B, T, D):
    embeddings then every layer, last_hidden_state, text_embeds (B, P))."""

    config_class = CLIPTextConfig
    _class_name = "CLIPTextModelWithProjection"

    def __init__(self, config: CLIPTextConfig | None = None, **kwargs):
        super().__init__()
        self.config = config if config is not None else self.config_from_dict(kwargs)
        self.text_model = _TextTransformer(self.config)
        self.text_projection = nn.Linear(self.config.hidden_size, self.config.projection_dim,
                                         bias=False)

    @classmethod
    def config_from_dict(cls, config_dict):
        if "text_config" in config_dict:
            # a full CLIPModel config: the top-level projection_dim governs
            proj = config_dict.get("projection_dim")
            config_dict = dict(config_dict["text_config"])
            if proj is not None:
                config_dict["projection_dim"] = proj
        return super().config_from_dict(config_dict)

    @staticmethod
    def _flax_key(key: str):
        """HF torch key -> the JAX module path (``None`` for buffers)."""
        if key.endswith("position_ids"):
            return None
        key = key.removeprefix("text_model.").replace("embeddings.", "")
        return key.replace("encoder.layers.", "layers.").replace(".mlp.", ".")

    def forward(self, input_ids):
        tm = self.text_model
        b, t = input_ids.shape
        positions = torch.arange(t, device=input_ids.device)
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding(positions)[None]
        causal = torch.ones(t, t, dtype=torch.bool, device=input_ids.device).triu(1)
        hidden_states = (x,)
        for layer in tm.encoder.layers:
            x = layer(x, causal)
            hidden_states += (x,)
        last = tm.final_layer_norm(x)
        # pooled at the first EOS: with CLIP's vocab the EOS / pad id is the max id
        pooled = last[torch.arange(b, device=input_ids.device), input_ids.argmax(-1)]
        return hidden_states, last, self.text_projection(pooled)


class SimpleTokenizer:
    """Deterministic hash tokenizer for offline and smoke runs, the same as
    ``open_muse_tpu.models.clip_text.SimpleTokenizer``: BOS 1, words hashed
    to stable ids, EOS / pad = vocab_size - 1.  Not a BPE."""

    def __init__(self, vocab_size: int = 49408, model_max_length: int = 77):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length

    def __call__(self, texts, padding=None, truncation=None, max_length=None,
                 return_tensors=None):
        max_length = max_length or self.model_max_length
        eos = self.vocab_size - 1
        batch = []
        for text in texts:
            ids = [1]
            for word in str(text).lower().split():
                h = int(hashlib.md5(word.encode()).hexdigest(), 16)
                ids.append(2 + h % (self.vocab_size - 3))
            ids = ids[: max_length - 1] + [eos]
            batch.append(ids + [eos] * (max_length - len(ids)))
        return {"input_ids": np.asarray(batch, dtype=np.int32)}
