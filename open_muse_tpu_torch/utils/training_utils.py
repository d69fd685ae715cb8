"""Seeding, running averages and the masked-bucket diagnostics of the
trainers.

Counterpart of ``set_seed``, ``AverageMeter`` and the four bucket metrics
(pixel entropy, image entropy, cross entropy and the deciles of the top
token probability, each by the decile of masked tokens an image) in
``open_muse_tpu/utils/training_utils.py``, which imports jax.  The metrics
are device-only work, so a captured train step holds them; sums by bucket
go through a one-hot product instead of a scatter, so two runs give the same
bits.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from ..ops.losses import _per_token_ce

__all__ = ["set_seed", "AverageMeter", "TOTAL_BUCKETS", "input_ids_to_masked_buckets",
           "average_by_buckets", "pixel_entropy_per_percent_masked_bucket",
           "image_entropy_per_percent_masked_bucket", "cross_entropy_per_percent_masked_bucket",
           "token_prob_deciles_per_percent_masked_bucket"]

TOTAL_BUCKETS = 10


def set_seed(seed: int) -> None:
    """Seed python, numpy and torch (every device)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


class AverageMeter:
    """Running average (reference train_muse.py:229-246)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def input_ids_to_masked_buckets(input_ids, mask_id: int):
    """The decile of masked tokens of each image: bucket b covers (b/10,
    (b+1)/10]."""
    masked_percent = (input_ids == mask_id).sum(-1) / input_ids.shape[-1]
    buckets = torch.ceil(masked_percent * 10).long() - 1
    return buckets.clamp(0, TOTAL_BUCKETS - 1)


def average_by_buckets(values, buckets):
    """Mean of ``values`` (B,) by bucket (B,) -> (10,) fp32, 0 where empty."""
    one_hot = (buckets[:, None] == torch.arange(TOTAL_BUCKETS, device=buckets.device)).float()
    total = (one_hot * values.float()[:, None]).sum(0)
    return total / one_hot.sum(0).clamp(min=1)


def pixel_entropy_per_percent_masked_bucket(logits, input_ids, mask_id: int):
    """Mean predictive entropy over an image's masked tokens, by bucket."""
    masked = input_ids == mask_id
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    entropy = -(log_probs.exp() * log_probs).sum(-1)
    entropy = torch.where(masked, entropy, torch.zeros_like(entropy))
    per_image = entropy.sum(-1) / masked.sum(-1).clamp(min=1)
    return average_by_buckets(per_image, input_ids_to_masked_buckets(input_ids, mask_id))


def image_entropy_per_percent_masked_bucket(logits, input_ids, mask_id: int):
    """Entropy of the distribution averaged over an image's masked tokens,
    by bucket."""
    masked = input_ids == mask_id
    probs = torch.softmax(logits.float(), dim=-1)
    probs = torch.where(masked[..., None], probs, torch.zeros_like(probs))
    image_probs = probs.sum(-2) / masked.sum(-1, keepdim=True).clamp(min=1)
    entropy = -(image_probs * torch.log(image_probs.clamp(min=1e-20))).sum(-1)
    return average_by_buckets(entropy, input_ids_to_masked_buckets(input_ids, mask_id))


def cross_entropy_per_percent_masked_bucket(logits, labels, input_ids, mask_id: int,
                                            label_smoothing: float = 0.0):
    """An image's CE over its labelled tokens, by bucket."""
    nll, valid = _per_token_ce(logits, labels, label_smoothing)
    per_image = nll.sum(-1) / valid.sum(-1).clamp(min=1)
    return average_by_buckets(per_image, input_ids_to_masked_buckets(input_ids, mask_id))


def token_prob_deciles_per_percent_masked_bucket(logits, input_ids, mask_id: int):
    """(10, 11): the 11 quantiles (0, 0.1, ..., 1; linear interpolation) of
    the top token probability over the masked tokens of each bucket's
    images, NaN for a bucket without one.  The quantiles are taken from one
    sort on the device (NaNs sort last), without ``nanquantile``'s checks."""
    p_max = torch.softmax(logits.float(), dim=-1).amax(-1)  # (B, S)
    masked = input_ids == mask_id
    buckets = input_ids_to_masked_buckets(input_ids, mask_id)
    in_bucket = (buckets[None, :, None] == torch.arange(TOTAL_BUCKETS, device=logits.device)
                 [:, None, None]) & masked[None]  # (10, B, S)
    values = torch.where(in_bucket, p_max[None], torch.full_like(p_max[None], float("nan")))
    values = values.flatten(1).sort(-1).values
    count = in_bucket.flatten(1).sum(-1, keepdim=True).float()  # (10, 1)
    rank = torch.linspace(0.0, 1.0, 11, device=logits.device)[None] * (count - 1).clamp(min=0)
    low, high = rank.floor(), rank.ceil()
    weight = rank - low
    pick = lambda r: values.gather(-1, r.long())  # noqa: E731
    out = pick(low) * (1 - weight) + pick(high) * weight
    return torch.where(count > 0, out, torch.full_like(out, float("nan")))
