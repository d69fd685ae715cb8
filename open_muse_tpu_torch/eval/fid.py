"""Fréchet distance over image features, the counterpart of
``open_muse_tpu/eval/fid.py``.

Per-set feature statistics (mean, covariance) and the Fréchet distance
between the two Gaussians, pytorch-fid's and cleanfid's math: FID = |mu1 -
mu2|^2 + tr(S1 + S2 - 2 sqrtm(S1 S2)), ``sqrtm`` by scipy with a jittered
retry for near-singular covariances.  Features come from any object with
``extract(images) -> (N, D)``: ``CLIPFeatureExtractor`` (projected CLIP
image embeddings, the CLIP-FID protocol) or
``inception.InceptionFeatureExtractor``.  With seeded weights the number is
a deterministic regression metric, not a published one, and callers label
it so.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional

import numpy as np
import torch

__all__ = ["frechet_distance", "compute_statistics", "CLIPFeatureExtractor",
           "fid_between_dirs", "fid_between_image_sets", "load_image_dir", "seeded_init_"]


def compute_statistics(features: np.ndarray):
    """Feature matrix (N, D) -> (mean (D,), covariance (D, D)), float64."""
    features = np.asarray(features, dtype=np.float64)
    if features.ndim != 2:
        raise ValueError(f"expected (N, D) features, got {features.shape}")
    return features.mean(axis=0), np.atleast_2d(np.cov(features, rowvar=False))


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * np.trace(covmean))


class CLIPFeatureExtractor:
    """Projected CLIP image embeddings (not normalized) of PIL images or HWC
    arrays, ``batch_size`` at a time: the CLIP-FID feature space."""

    def __init__(self, vision_encoder, batch_size: int = 32):
        self.vision = vision_encoder
        self.batch_size = batch_size

    @classmethod
    def seeded(cls, seed: int = 0, device="cuda", **config):
        """A tiny tower with seeded weights, for regression numbers (not a
        published metric: label its FIDs ``fid_clipfeat_seeded``); drawn as
        flax initialises the JAX ``CLIPFeatureExtractor.seeded``'s (the same
        laws, not the same bits: ``seeded_init_``)."""
        from ..core.modeling import resolve_device
        from ..models.clip_vision import CLIPVisionEncoder, default_dtype

        device = resolve_device(device)
        config = {**dict(hidden_size=64, intermediate_size=128, num_hidden_layers=4,
                         num_attention_heads=4, image_size=64, patch_size=8,
                         projection_dim=64), **config}
        vision = CLIPVisionEncoder(**config)
        seeded_init_(vision, seed)
        return cls(vision.to(device, default_dtype(device)).eval())

    @torch.no_grad()
    def extract(self, images) -> np.ndarray:
        from ..models.clip_vision import clip_preprocess_images

        device = next(self.vision.parameters()).device
        feats: List[np.ndarray] = []
        images = list(images)
        for start in range(0, len(images), self.batch_size):
            px = clip_preprocess_images(images[start:start + self.batch_size],
                                        self.vision.config.image_size)
            embeds = self.vision(torch.from_numpy(px).to(device))[2]
            feats.append(embeds.double().cpu().numpy())
        return np.concatenate(feats, axis=0)


@torch.no_grad()
def seeded_init_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """flax's default laws from a CPU generator seeded with ``seed``: linear
    and conv weights ~ N(0, 1 / fan_in) (lecun normal), biases 0, norms (1,
    0), embedding tables ~ N(0, 1 / width), a ``class_embedding`` ~ N(0,
    0.02)."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("class_embedding"):
            std = 0.02
        elif leaf == "bias":
            std = 0.0
        elif p.dim() == 1:  # norm scales
            p.fill_(1.0)
            continue
        elif "embedding.weight" in name and p.dim() == 2 and "patch" not in name:
            std = p.shape[1] ** -0.5
        else:
            std = p[0].numel() ** -0.5
        p.copy_(torch.randn(p.shape, generator=gen) * std)
    return model


def load_image_dir(path: str, limit: Optional[int] = None):
    """Every image in a directory as PIL, sorted by name."""
    from PIL import Image

    names = sorted(n for n in os.listdir(path)
                   if n.lower().endswith((".png", ".jpg", ".jpeg", ".webp")))
    if limit:
        names = names[:limit]
    return [Image.open(os.path.join(path, n)).convert("RGB") for n in names]


def fid_between_image_sets(real_images: Iterable, fake_images: Iterable, extractor) -> float:
    real_feats = extractor.extract(real_images)
    fake_feats = extractor.extract(fake_images)
    if len(real_feats) < 2 or len(fake_feats) < 2:
        raise ValueError("need >= 2 images per set for covariance")
    return frechet_distance(*compute_statistics(real_feats), *compute_statistics(fake_feats))


def fid_between_dirs(real_dir: str, fake_dir: str, extractor,
                     limit: Optional[int] = None) -> float:
    """The in-repo counterpart of cleanfid's ``compute_fid(real_dir, fake_dir)``."""
    return fid_between_image_sets(load_image_dir(real_dir, limit),
                                  load_image_dir(fake_dir, limit), extractor)
