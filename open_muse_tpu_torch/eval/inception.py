"""InceptionV3 for the FID and Inception Score protocols, NCHW, with
torchvision's module names, the counterpart of ``open_muse_tpu/eval/inception.py``.

torchvision's ``inception_v3`` evaluation graph (no auxiliary head), which
is also the graph behind pytorch-fid's ``pt_inception-2015-12-05`` weights,
written out here (torchvision is not a dependency).  Its state dict keys are
torchvision's (``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch1x1.bn.
running_mean``, ``fc.weight``), so either published checkpoint loads with
``load_state_dict`` (``InceptionFeatureExtractor.from_torch_checkpoint``;
the JAX package needs ``convert_torch_inception_state_dict`` for that).

Two graph variants, picked from the checkpoint (``detect_variant``):

* ``"torchvision"``: the 3x3 stride-1 average pools inside Mixed_5*/6*/7*
  count the zero padding (``count_include_pad=True``); a 1000-class head.
* ``"fid"``: pytorch-fid's patches (FIDInceptionA/C/E_1/E_2): those pools
  use ``count_include_pad=False``, and the last block (Mixed_7c) takes a max
  pool in its branch pool; a 1008-class head.

``pool3`` (the 2048-wide mean after Mixed_7c) is the FID feature space, the
head's logits the Inception Score's.  Batch norm runs on the stored
statistics (eps 1e-3).  Plain PyTorch: the JAX module has no Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["InceptionV3", "InceptionFeatureExtractor", "detect_variant", "inception_preprocess"]

BN_EPS = 1e-3  # torchvision's BatchNorm2d(eps=0.001) in inception_v3


class BasicConv2d(nn.Module):
    """Conv (no bias), eval-mode BatchNorm, ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride, padding=padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=BN_EPS)

    def forward(self, x):
        bn = self.bn
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         training=False, eps=BN_EPS)
        return F.relu(x)


def _avg_pool_3x3(x, include_pad: bool):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=include_pad)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int, include_pad: bool):
        super().__init__()
        self.include_pad = include_pad
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x):
        return torch.cat([
            self.branch1x1(x),
            self.branch5x5_2(self.branch5x5_1(x)),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            self.branch_pool(_avg_pool_3x3(x, self.include_pad))], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        return torch.cat([
            self.branch3x3(x),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int, include_pad: bool):
        super().__init__()
        self.include_pad = include_pad
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        bd = x
        for conv in (self.branch7x7dbl_1, self.branch7x7dbl_2, self.branch7x7dbl_3,
                     self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([
            self.branch1x1(x),
            self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x))),
            bd,
            self.branch_pool(_avg_pool_3x3(x, self.include_pad))], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for conv in (self.branch7x7x3_1, self.branch7x7x3_2, self.branch7x7x3_3,
                     self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """``pool_mode``: "avg_true" (stock), "avg_excl" (FIDInceptionE_1) or
    "max" (FIDInceptionE_2)."""

    def __init__(self, in_ch: int, pool_mode: str):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool_mode == "max":
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg_pool_3x3(x, self.pool_mode == "avg_true")
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3(nn.Module):
    """``forward(x (B, 3, H, W) in [-1, 1])`` -> pool3 (B, 2048), and with
    ``return_logits`` (pool3, logits).  ``variant`` "fid" (1008 classes by
    default) or "torchvision" (1000)."""

    def __init__(self, variant: str = "fid", num_classes: Optional[int] = None):
        super().__init__()
        if variant not in ("fid", "torchvision"):
            raise ValueError(f"unknown variant {variant!r}")
        self.variant = variant
        fid = variant == "fid"
        pad = not fid
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, pad)
        self.Mixed_5c = InceptionA(256, 64, pad)
        self.Mixed_5d = InceptionA(288, 64, pad)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, pad)
        self.Mixed_6c = InceptionC(768, 160, pad)
        self.Mixed_6d = InceptionC(768, 160, pad)
        self.Mixed_6e = InceptionC(768, 192, pad)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg_excl" if fid else "avg_true")
        self.Mixed_7c = InceptionE(2048, "max" if fid else "avg_true")
        self.fc = nn.Linear(2048, num_classes or (1008 if fid else 1000))

    def forward(self, x, return_logits: bool = False):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                      self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        pool3 = x.mean(dim=(2, 3))
        return (pool3, self.fc(pool3)) if return_logits else pool3


def detect_variant(state_dict) -> str:
    """pytorch-fid's FID weights carry a 1008-class fc, torchvision's
    ``inception_v3_google`` 1000 (and an AuxLogits head)."""
    fc = state_dict.get("fc.weight")
    return "fid" if fc is not None and fc.shape[0] == 1008 else "torchvision"


def inception_preprocess(images, size: int = 299, device="cpu") -> torch.Tensor:
    """PIL images / HWC uint8 or float arrays -> (B, 3, size, size) float32
    in [-1, 1] on ``device``: the pytorch-fid protocol ([0, 1], a bilinear
    resize to ``size`` that antialiases when it shrinks, as
    ``jax.image.resize`` does, then x * 2 - 1)."""
    arrs = []
    for im in images:
        a = np.asarray(im)
        if a.dtype != np.uint8 and a.max() <= 1.0 + 1e-6:
            a = (np.clip(a, 0, 1) * 255).astype(np.uint8)
        if a.ndim == 2:
            a = np.stack([a] * 3, axis=-1)
        arrs.append(a.astype(np.float32) / 255.0)
    batch = torch.from_numpy(np.stack(arrs)).to(device).permute(0, 3, 1, 2)
    if batch.shape[2] != size or batch.shape[3] != size:
        batch = F.interpolate(batch, size=(size, size), mode="bilinear", align_corners=False,
                              antialias=True)
    return batch * 2.0 - 1.0


@torch.no_grad()
def _he_init_(model: InceptionV3, seed: int) -> InceptionV3:
    """The JAX ``seeded`` graph's laws from a CPU generator: conv and fc
    weights ~ N(0, 2 / fan_in) (lecun normal x sqrt 2, so that the ~20 ReLUs
    of the trunk keep the features' variance), biases 0, batch norm (1, 0)
    with running statistics (0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                           * (2.0 / m.weight[0].numel()) ** 0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model


class InceptionFeatureExtractor:
    """``extract(images) -> (B, 2048)`` pool3 features (the contract of
    ``eval.fid``) and ``predict_proba(images)``, the head's softmax, for the
    Inception Score; ``batch_size`` images at a time, fp32."""

    def __init__(self, model: InceptionV3, batch_size: int = 32, label: str = "inception_v3"):
        self.model = model.eval()
        self.batch_size = batch_size
        self.label = label

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @classmethod
    def from_torch_checkpoint(cls, path: str, batch_size: int = 32, device="cuda"):
        """A torchvision ``inception_v3_google-*.pth`` or pytorch-fid
        ``pt_inception-2015-12-05-*.pth`` file (the variant detected).  The
        auxiliary head is dropped; any other key the graph lacks raises."""
        from ..core.modeling import resolve_device

        state_dict = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(state_dict, "state_dict"):
            state_dict = state_dict.state_dict()
        variant = detect_variant(state_dict)
        model = InceptionV3(variant, num_classes=state_dict["fc.weight"].shape[0])
        state = {k: v for k, v in state_dict.items() if not k.startswith("AuxLogits.")}
        missing, unexpected = model.load_state_dict(state, strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if missing or unexpected:
            raise ValueError(f"unrecognized inception checkpoint: missing {missing[:8]}, "
                             f"unexpected {unexpected[:8]}")
        return cls(model.to(resolve_device(device)), batch_size=batch_size,
                   label=f"inception_v3({variant})")

    @classmethod
    def seeded(cls, seed: int = 0, batch_size: int = 32, device="cuda"):
        """A random-weight "fid" graph for regression numbers (not a published
        metric; callers label it)."""
        from ..core.modeling import resolve_device

        model = _he_init_(InceptionV3("fid"), seed)
        return cls(model.to(resolve_device(device)), batch_size=batch_size,
                   label=f"inception_v3_seeded(seed={seed})")

    def _batches(self, images):
        images = list(images)
        for start in range(0, len(images), self.batch_size):
            yield inception_preprocess(images[start:start + self.batch_size],
                                       device=self.device)

    @torch.no_grad()
    def extract(self, images) -> np.ndarray:
        return np.concatenate([self.model(px).double().cpu().numpy()
                               for px in self._batches(images)], axis=0)

    @torch.no_grad()
    def predict_proba(self, images) -> np.ndarray:
        """Class probabilities (the head's softmax), float64."""
        return np.concatenate([self.model(px, return_logits=True)[1].double().softmax(-1)
                               .cpu().numpy() for px in self._batches(images)], axis=0)
