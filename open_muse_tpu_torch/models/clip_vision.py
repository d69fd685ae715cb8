"""CLIP vision tower with projection and the image-text scorer, in PyTorch.

Counterpart of ``open_muse_tpu/models/clip_vision.py``: a ViT with the
parameter names of HF ``CLIPVisionModelWithProjection`` (so a published
state dict loads with no key map; ``pre_layrnorm`` keeps the upstream
typo), the OpenAI preprocessing, and ``CLIPScorer``, which pairs the tower
with ``clip_text.CLIPTextEncoder`` to give HF ``CLIPModel``'s
``logits_per_image``.

The tower reuses the text tower's ``CLIPEncoderLayer`` without a mask: its
attention is unmasked at the default scale, so it goes to
``flash_attention`` (kernel 5; at ViT-L/14, (B, 257, 16, 64), the one-pass
variant).  The JAX ``CLIPAttention`` computes the same function without a
Pallas kernel (``open_muse_tpu/models/clip_text.py:68-79``).  The kernel
takes bf16: on the card the tower is held in bf16, as the serving text
tower is; on the CPU it stays fp32.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch
from torch import nn

from ..core.configuration import CONFIG_NAME, BaseConfig
from ..core.modeling import WEIGHTS_NAMES, ModelMixin, load_state_file, resolve_device
from .clip_text import CLIPEncoderLayer, CLIPTextEncoder, SimpleTokenizer, _LayerNorm

__all__ = ["CLIPVisionConfig", "CLIPVisionEncoder", "CLIPScorer", "clip_preprocess_images",
           "default_dtype"]

# OpenAI CLIP normalization constants (transformers CLIPImageProcessor)
CLIP_IMAGE_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig(BaseConfig):
    # ViT-L/14 (openai/clip-vit-large-patch14)
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    num_channels: int = 3
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: int = 768


def default_dtype(device) -> torch.dtype:
    """bf16 on the card (the attention kernel's type), fp32 on the CPU."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def clip_preprocess_images(images, image_size: int = 224) -> np.ndarray:
    """PIL images / uint8 or float HWC arrays -> CLIP-normalized NHWC float32,
    as transformers' CLIPImageProcessor: the shorter side resized to
    ``image_size`` (bicubic; the longer side truncated), a centre crop,
    [0, 1], the OpenAI mean and std."""
    from PIL import Image

    out = []
    for img in images:
        if isinstance(img, np.ndarray):
            arr = img
            if arr.dtype != np.uint8:
                arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
            img = Image.fromarray(arr)
        w, h = img.size
        long_side = int(image_size * max(w, h) / min(w, h))
        new_w, new_h = (image_size, long_side) if w <= h else (long_side, image_size)
        img = img.resize((new_w, new_h), Image.BICUBIC)
        w2, h2 = img.size
        left, top = (w2 - image_size) // 2, (h2 - image_size) // 2
        img = img.crop((left, top, left + image_size, top + image_size))
        arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
        out.append((arr - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD)
    return np.stack(out)


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        n = (cfg.image_size // cfg.patch_size) ** 2
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(cfg.num_channels, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(n + 1, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.pre_layrnorm = _LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = _LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


class CLIPVisionEncoder(ModelMixin, nn.Module):
    """``forward(pixel_values (B, H, W, C) NHWC, CLIP-normalized)`` ->
    (hidden_states: the embeddings then every layer, pooled: the CLS token
    after ``post_layernorm``, image_embeds (B, P)).  Reads
    ``CLIPVisionModelWithProjection`` directories and the vision half of
    full ``CLIPModel`` ones."""

    config_class = CLIPVisionConfig
    _class_name = "CLIPVisionModelWithProjection"

    def __init__(self, config: CLIPVisionConfig | None = None, **kwargs):
        super().__init__()
        self.config = config if config is not None else self.config_from_dict(kwargs)
        self.vision_model = _VisionTransformer(self.config)
        self.visual_projection = nn.Linear(self.config.hidden_size, self.config.projection_dim,
                                           bias=False)

    @classmethod
    def config_from_dict(cls, config_dict):
        if "vision_config" in config_dict:
            # a full CLIPModel config: its top-level projection_dim governs
            # visual_projection (the nested one is an unused default)
            proj = config_dict.get("projection_dim")
            config_dict = dict(config_dict["vision_config"])
            if proj is not None:
                config_dict["projection_dim"] = proj
        return super().config_from_dict(config_dict)

    @staticmethod
    def _flax_key(key: str):
        """HF torch key -> the JAX module path (``None`` for buffers)."""
        if key.endswith("position_ids"):
            return None
        key = key.removeprefix("vision_model.").replace("embeddings.", "")
        return key.replace("encoder.layers.", "layers.").replace(".mlp.", ".")

    def forward(self, pixel_values, use_kernels: bool = True):
        """``use_kernels=False`` takes the attention's plain path (the same
        function, for checks against the kernel)."""
        vm = self.vision_model
        emb = vm.embeddings
        x = pixel_values.to(emb.patch_embedding.weight.dtype)
        patches = emb.patch_embedding(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = emb.class_embedding.to(patches.dtype).expand(patches.shape[0], 1, -1)
        x = torch.cat([cls, patches], dim=1) + emb.position_embedding.weight[None]
        x = vm.pre_layrnorm(x)
        hidden_states = (x,)
        for layer in vm.encoder.layers:
            x = layer(x, use_kernels=use_kernels)  # no mask: bidirectional attention
            hidden_states += (x,)
        pooled = vm.post_layernorm(x[:, 0])
        return hidden_states, pooled, self.visual_projection(pooled)

    @torch.no_grad()
    def embed(self, pixel_values):
        """L2-normalized projected image embeddings, fp32."""
        embeds = self(pixel_values)[2].float()
        return embeds / embeds.norm(dim=-1, keepdim=True)


class CLIPScorer:
    """Image-text scoring: ``score(images, texts)`` -> (n_images, n_texts)
    ``logit_scale * cos(image_embeds, text_embeds)``, HF ``CLIPModel``'s
    ``logits_per_image``."""

    def __init__(self, vision_encoder: CLIPVisionEncoder, text_encoder: CLIPTextEncoder,
                 tokenizer, logit_scale: float = 100.0):
        self.vision = vision_encoder
        self.text = text_encoder
        self.tokenizer = tokenizer
        self.logit_scale = float(logit_scale)

    @classmethod
    def from_pretrained(cls, path: str, tokenizer=None, device="cuda", dtype=None):
        """Both towers from one full ``CLIPModel`` directory, or from its
        ``vision_encoder/`` and ``text_encoder/`` subfolders, on ``device``
        in ``dtype`` (``default_dtype``); the logit scale is
        ``exp(logit_scale)`` of the directory's own weights, else 100."""
        device = resolve_device(device)
        dtype = dtype or default_dtype(device)
        split = os.path.isdir(os.path.join(path, "vision_encoder"))
        vision = CLIPVisionEncoder.from_pretrained(
            path, "vision_encoder" if split else None, device=device)
        text = CLIPTextEncoder.from_pretrained(path, "text_encoder" if split else None,
                                               device=device)
        logit_scale = 100.0
        for name in WEIGHTS_NAMES:
            weights = os.path.join(path, name)
            if os.path.isfile(weights):
                state = load_state_file(weights)
                if "logit_scale" in state:
                    logit_scale = float(np.exp(state["logit_scale"].float().numpy()))
                break
        if tokenizer is None:
            tokenizer = SimpleTokenizer(vocab_size=text.config.vocab_size)
        return cls(vision.to(dtype).eval(), text.to(dtype).eval(), tokenizer, logit_scale)

    def save_pretrained(self, path: str) -> None:
        """One full ``CLIPModel`` directory: ``config.json`` with
        ``text_config``, ``vision_config`` and the shared ``projection_dim``,
        and ``model.safetensors`` with both towers' HF keys and
        ``logit_scale`` (its log)."""
        from safetensors.torch import save_file

        proj = self.vision.config.projection_dim
        if self.text.config.projection_dim != proj:
            raise ValueError(f"towers project to {proj} and {self.text.config.projection_dim}")
        os.makedirs(path, exist_ok=True)
        config = {"architectures": ["CLIPModel"], "model_type": "clip", "projection_dim": proj,
                  "logit_scale_init_value": float(np.log(self.logit_scale)),
                  "text_config": dataclasses.asdict(self.text.config),
                  "vision_config": dataclasses.asdict(self.vision.config)}
        with open(os.path.join(path, CONFIG_NAME), "w", encoding="utf-8") as f:
            json.dump(config, f, indent=2, sort_keys=True)
        state = {**self.text.state_dict(), **self.vision.state_dict(),
                 "logit_scale": torch.tensor(np.log(self.logit_scale), dtype=torch.float32)}
        save_file({k: v.detach().float().cpu().contiguous() for k, v in state.items()},
                  os.path.join(path, WEIGHTS_NAMES[0]))

    @property
    def device(self) -> torch.device:
        return next(self.vision.parameters()).device

    @torch.no_grad()
    def embed_images(self, images) -> torch.Tensor:
        """PIL / array images -> L2-normalized image embeddings (N, P) fp32."""
        pixels = clip_preprocess_images(images, self.vision.config.image_size)
        return self.vision.embed(torch.from_numpy(pixels).to(self.device))

    @torch.no_grad()
    def embed_texts(self, texts) -> torch.Tensor:
        ids = self.tokenizer(list(texts), padding="max_length", truncation=True,
                             max_length=self.text.config.max_position_embeddings,
                             return_tensors="np")["input_ids"]
        embeds = self.text(torch.as_tensor(np.asarray(ids), dtype=torch.long,
                                           device=self.device))[2].float()
        return embeds / embeds.norm(dim=-1, keepdim=True)

    def score(self, images, texts) -> np.ndarray:
        """(n_images, n_texts) logits_per_image."""
        img, txt = self.embed_images(images), self.embed_texts(texts)
        return (self.logit_scale * img @ txt.T).cpu().numpy()

    def best_of(self, images, text) -> int:
        """Index of the image that best matches ``text`` (best-of-N candidate
        selection)."""
        return int(np.argmax(self.score(images, [text])[:, 0]))
