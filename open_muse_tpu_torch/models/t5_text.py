"""The T5 v1.1 encoder in PyTorch, with the HF ``T5EncoderModel`` names.

Counterpart of ``open_muse_tpu/models/t5_text.py``: token embeddings
(``shared``), pre-norm blocks of self-attention with a relative position
bias and a feed-forward layer (``relu``, or ``gated-gelu`` with the tanh
GELU), and a final norm.  Plain PyTorch: JAX runs it outside any Pallas
kernel (the attention has a position bias and no 1/sqrt(d) scaling, and
the gated FFN's GELU is not the exact-erf one of the GLU kernel).

As in the JAX module:
  * the norm is T5's: x * rsqrt(mean(x^2) in fp32 + eps), no mean, no bias;
  * block 0 buckets the relative positions (bidirectional) and computes the
    bias once, in fp32; every later block adds the same bias;
  * the logits are fp32, a masked key gets the fp32 minimum;
  * ``forward`` returns ``((last,), last, None)``, the text-encoder triple
    of ``CLIPTextEncoder``: T5 has no pooled output.

The state_dict has ``shared.weight`` and no ``encoder.embed_tokens``
(tied to ``shared`` in HF, which ties it again on load).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.configuration import BaseConfig
from ..core.modeling import ModelMixin

__all__ = ["T5Config", "T5TextEncoder", "relative_position_bucket"]


@dataclasses.dataclass(frozen=True)
class T5Config(BaseConfig):
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"  # "relu" | "gated-gelu"

    @property
    def is_gated(self) -> bool:
        return self.feed_forward_proj.startswith("gated")


class T5LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        var = x.float().square().mean(-1, keepdim=True)
        out = x * torch.rsqrt(var + self.eps).to(x.dtype)
        return out * self.weight.to(out.dtype)


def relative_position_bucket(relative_position, num_buckets: int = 32, max_distance: int = 128):
    """T5's bidirectional bucket of (memory - query) positions."""
    num_buckets //= 2
    ret = (relative_position > 0).long() * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(n.float() / max_exact + 1e-6)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).long()
    large = torch.clamp(large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        self.relative_attention_bias = (nn.Embedding(cfg.relative_attention_num_buckets,
                                                     cfg.num_heads)
                                        if has_relative_bias else None)

    def position_bias(self, t: int, device):
        """(1, H, T, T) fp32 bias of memory - query positions."""
        pos = torch.arange(t, device=device)
        buckets = relative_position_bucket(pos[None] - pos[:, None],
                                           self.cfg.relative_attention_num_buckets,
                                           self.cfg.relative_attention_max_distance)
        return self.relative_attention_bias.weight.float()[buckets].permute(2, 0, 1)[None]

    def forward(self, x, position_bias, attention_mask):
        cfg = self.cfg
        b, t, _ = x.shape
        split = lambda y: y.reshape(b, t, cfg.num_heads, cfg.d_kv).transpose(1, 2)  # noqa: E731
        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        if position_bias is None:
            position_bias = self.position_bias(t, x.device)
        logits = q.float() @ k.float().transpose(-1, -2) + position_bias  # no 1/sqrt(d)
        if attention_mask is not None:
            logits = logits.masked_fill(attention_mask[:, None, None, :] == 0,
                                        torch.finfo(torch.float32).min)
        out = logits.softmax(-1).to(v.dtype) @ v
        return self.o(out.transpose(1, 2).reshape(b, t, -1)), position_bias


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x, position_bias, attention_mask):
        h, position_bias = self.SelfAttention(self.layer_norm(x), position_bias, attention_mask)
        return x + h, position_bias


class T5DenseReluDense(nn.Module):
    """relu(wi x) or, gated, gelu_tanh(wi_0 x) * wi_1 x; then wo."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.gated = cfg.is_gated
        if self.gated:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, h):
        if self.gated:
            return self.wo(F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h))
        return self.wo(F.relu(self.wi(h)))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseReluDense(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_relative_bias),
                                    T5LayerFF(cfg)])

    def forward(self, x, position_bias, attention_mask):
        x, position_bias = self.layer[0](x, position_bias, attention_mask)
        return self.layer[1](x), position_bias


class _T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, i == 0) for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5TextEncoder(ModelMixin, nn.Module):
    """``forward(input_ids (B, T), attention_mask=None)`` -> ((last,), last
    (B, T, d_model), None)."""

    config_class = T5Config
    _class_name = "T5EncoderModel"
    # what HF and the JAX pipeline read to tell a T5 directory from a CLIP one
    _extra_config = {"architectures": ["T5EncoderModel"], "model_type": "t5"}

    def __init__(self, config: T5Config | None = None, **kwargs):
        super().__init__()
        self.config = config if config is not None else self.config_from_dict(kwargs)
        self.shared = nn.Embedding(self.config.vocab_size, self.config.d_model)
        self.encoder = _T5Stack(self.config)

    @staticmethod
    def _flax_key(key: str):
        """HF torch key -> the JAX module path."""
        key = key.removeprefix("encoder.")
        key = key.replace(".layer.0.", ".layer_0_").replace(".layer.1.", ".layer_1_")
        return key.replace("DenseReluDense.", "DenseReluDense_")

    def forward(self, input_ids, attention_mask=None):
        x = self.shared(input_ids)
        position_bias = None
        for block in self.encoder.block:
            x, position_bias = block(x, position_bias, attention_mask)
        last = self.encoder.final_layer_norm(x)
        return (last,), last, None
