"""The conv-feature perceptual loss of VQGAN training (an LPIPS analog).

Counterpart of ``open_muse_tpu/ops/perceptual.py``: a VGG16-shaped pyramid
(three stages of 3 x 3 convolutions and ReLUs, 2 x 2 max-pooling between
them) over images less the ImageNet channel means; the loss is the mean
squared difference of the two images' channel-normalised features at each
stage, averaged over the stages.  The extractor is fixed: its parameters
take no gradient.  No VGG16 checkpoint is available offline, so the default
pyramid is seeded random weights, drawn by the port's own generator (the
JAX package's seeded draws cannot be reproduced here; tests carry its
parameters across instead); ``load_vgg16_features`` maps a torchvision
VGG16 ``features.*`` state_dict onto the pyramid.  Takes NHWC (or NCHW)
images and computes in NCHW.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn

from ..models.taming_vqgan import to_nhwc

__all__ = ["PerceptualFeatures", "make_perceptual_loss_fn", "load_vgg16_features"]

# (channels, convolutions before the pool) a stage: VGG16's first three
STAGES = ((64, 2), (128, 2), (256, 3))
IMAGENET_MEAN = (0.485, 0.456, 0.406)


class PerceptualFeatures(nn.Module):
    """The pyramid: ``forward(images)`` -> the feature map of each stage
    (NCHW), convolutions named ``stage{s}_conv{c}`` as in the JAX module."""

    def __init__(self):
        super().__init__()
        channels = 3
        for si, (out, n_convs) in enumerate(STAGES):
            for ci in range(n_convs):
                self.add_module(f"stage{si}_conv{ci}", nn.Conv2d(channels, out, 3, padding=1))
                channels = out
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN)[None, :, None, None],
                             persistent=False)

    def forward(self, images):
        h = to_nhwc(images).permute(0, 3, 1, 2) - self.mean
        feats = []
        for si, (_, n_convs) in enumerate(STAGES):
            if si:
                h = torch.nn.functional.max_pool2d(h, 2, 2)
            for ci in range(n_convs):
                h = torch.relu(getattr(self, f"stage{si}_conv{ci}")(h))
            feats.append(h)
        return feats


def _normalize(feat, eps: float = 1e-8):
    """Unit norm over the channels (LPIPS's ``normalize_tensor``)."""
    return feat / (feat.square().sum(1, keepdim=True).sqrt() + eps)


@torch.no_grad()
def _seeded_(module: PerceptualFeatures, seed: int) -> None:
    """flax's default initialisation, from a torch generator of ``seed``:
    kernels truncated normal at 2 standard deviations with variance
    1 / fan_in, biases zero."""
    gen = torch.Generator(device=module.mean.device).manual_seed(seed)
    for conv in module.children():
        std = math.sqrt(1.0 / conv.weight[0].numel()) / 0.87962566103423978
        nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std, b=2 * std, generator=gen)
        nn.init.zeros_(conv.bias)


def make_perceptual_loss_fn(seed: int = 0, state_dict: Optional[Mapping] = None) -> Callable:
    """``loss(x, y)`` -> the scalar perceptual distance of two image batches
    in [0, 1]; the pyramid (``loss.features``, built on the default device:
    ``torch.device`` as a context picks it) takes its weights from
    ``state_dict`` (its own keys, or ``load_vgg16_features``'s), else
    seeded from ``seed``."""
    module = PerceptualFeatures()
    if state_dict is None:
        _seeded_(module, seed)
    else:
        module.load_state_dict(state_dict)
    module.eval().requires_grad_(False)

    def loss(x, y):
        per_stage = [(_normalize(a) - _normalize(b)).square().mean()
                     for a, b in zip(module(x), module(y))]
        return torch.stack(per_stage).mean()

    loss.features = module
    return loss


def load_vgg16_features(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A torchvision VGG16 ``features.*`` state_dict -> ``PerceptualFeatures``'
    state_dict (both OIHW); only the first three stages are read."""
    out, tv_index = {}, 0
    for si, (_, n_convs) in enumerate(STAGES):
        for ci in range(n_convs):
            for leaf in ("weight", "bias"):
                out[f"stage{si}_conv{ci}.{leaf}"] = torch.as_tensor(
                    state_dict[f"features.{tv_index}.{leaf}"])
            tv_index += 2  # a conv, then its ReLU
        tv_index += 1  # the pool
    return out
