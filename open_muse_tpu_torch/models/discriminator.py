"""The PatchGAN discriminator and the GAN loss heads of VQGAN training.

Counterpart of ``open_muse_tpu/models/discriminator.py``: taming's NLayer
PatchGAN with GroupNorm in place of BatchNorm (no running statistics, so a
train step stays one graph), its hinge and vanilla discriminator losses, the
generator loss and taming's adaptive generator weight, measured at the
decoder's last convolution (``last_decoder_conv``).  The JAX layers' traits
are kept: images in [0, 1] mapped to [-1, 1], 4 x 4 kernels with padding 1,
``leaky_relu(0.2)``, no bias on the normed convolutions, GroupNorm over
``min(32, channels)`` groups with flax's epsilon 1e-6.  Takes NHWC (or
NCHW) images and returns NHWC logit maps, computing in NCHW inside.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..core.configuration import BaseConfig
from ..core.modeling import ModelMixin
from .taming_vqgan import to_nhwc

__all__ = ["PatchDiscriminator", "PatchDiscriminatorConfig", "hinge_d_loss", "vanilla_d_loss",
           "generator_loss", "adaptive_disc_weight", "last_decoder_conv"]


@dataclasses.dataclass(frozen=True)
class PatchDiscriminatorConfig(BaseConfig):
    base_channels: int = 64
    n_layers: int = 3


class PatchDiscriminator(ModelMixin, nn.Module):
    """A 4 x 4 / stride-2 conv ladder doubling the channels (at most 8x),
    stride 1 at its last rung, then a 1-channel logit map: each logit
    judges one receptive-field patch (70 x 70 at ``n_layers`` 3)."""

    config_class = PatchDiscriminatorConfig
    _class_name = "PatchDiscriminator"

    def __init__(self, config: PatchDiscriminatorConfig | None = None, **kwargs):
        super().__init__()
        cfg = config if config is not None else self.config_from_dict(kwargs)
        self.config = cfg
        base = cfg.base_channels
        self.conv_in = nn.Conv2d(3, base, 4, stride=2, padding=1)
        channels = base
        for n in range(1, cfg.n_layers + 1):
            out = base * min(2 ** n, 8)
            stride = 2 if n < cfg.n_layers else 1
            self.add_module(f"conv_{n}", nn.Conv2d(channels, out, 4, stride=stride, padding=1,
                                                   bias=False))
            self.add_module(f"norm_{n}", nn.GroupNorm(min(32, out), out, eps=1e-6))
            channels = out
        self.conv_out = nn.Conv2d(channels, 1, 4, stride=1, padding=1)

    def forward(self, images):
        """Images in [0, 1] (B, H, W, 3) or (B, 3, H, W) -> logits NHWC."""
        h = to_nhwc(images).permute(0, 3, 1, 2) * 2.0 - 1.0
        h = F.leaky_relu(self.conv_in(h), 0.2)
        for n in range(1, self.config.n_layers + 1):
            h = getattr(self, f"norm_{n}")(getattr(self, f"conv_{n}")(h))
            h = F.leaky_relu(h, 0.2)
        return self.conv_out(h).permute(0, 2, 3, 1)


def hinge_d_loss(logits_real, logits_fake):
    """taming's hinge loss: 0.5 (E[relu(1 - D(x))] + E[relu(1 + D(G))])."""
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real, logits_fake):
    """The non-saturating BCE-with-logits pair (taming's vanilla loss)."""
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def generator_loss(logits_fake, kind: str = "hinge"):
    if kind == "hinge":
        return -logits_fake.mean()
    return F.softplus(-logits_fake).mean()


def adaptive_disc_weight(rec_grad, gan_grad, disc_weight: float = 1.0, eps: float = 1e-4,
                         max_weight: float = 1e4):
    """taming's adaptive weight from the two losses' gradients at one
    weight: ``clip(|rec_grad| / (|gan_grad| + eps), 0, max_weight) *
    disc_weight``, detached.  Frobenius norms, so the weight's layout (OIHW
    here, HWIO in JAX) does not change it."""
    w = torch.linalg.vector_norm(rec_grad) / (torch.linalg.vector_norm(gan_grad) + eps)
    return torch.clamp(w, 0.0, max_weight).detach() * disc_weight


def last_decoder_conv(model: nn.Module) -> nn.Conv2d:
    """The decoder's final convolution (``decoder.conv_out``, descending into
    a module that wraps one), where the adaptive weight is measured: the
    weight JAX's ``last_decoder_kernel_path`` finds."""
    decoder = getattr(model, "decoder", None)
    node = getattr(decoder, "conv_out", None)
    while node is not None and not isinstance(node, nn.Conv2d):
        children = list(node.children())
        node = children[0] if children else None
    if node is None:
        raise ValueError(f"{type(model).__name__} has no decoder.conv_out convolution for the "
                         f"adaptive disc weight")
    return node
