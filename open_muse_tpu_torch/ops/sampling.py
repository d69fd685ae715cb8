"""Mask schedules and MaskGIT re-masking, the counterparts of
``open_muse_tpu/ops/sampling.py``.  Noise is passed in, never drawn here."""

from __future__ import annotations

import math
from functools import partial

import torch

__all__ = ["log", "gumbel_sample", "top_k", "mask_by_random_topk", "cosine_schedule",
           "linear_schedule", "pow_schedule", "sigmoid_schedule", "get_mask_schedule"]


def log(t, eps: float = 1e-20):
    return torch.log(t.clamp_min(eps))


def gumbel_sample(t, temperature: float, gumbel, dim: int = -1):
    """argmax(t / max(temperature, 1e-10) + gumbel), the noise taken in
    ``t``'s type as JAX draws it (first index on ties)."""
    return torch.argmax(t / max(temperature, 1e-10) + gumbel.to(t.dtype), dim=dim)


def top_k(logits, thres: float = 0.9):
    """Keep the top ceil((1 - thres) V) logits, -inf elsewhere (every logit
    equal to the k-th largest stays, as the JAX threshold keeps it)."""
    k = math.ceil((1 - thres) * logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, float("-inf"), logits)


def mask_by_random_topk(mask_len, probs, temperature, gumbel):
    """(B, S) bool mask of the ``mask_len`` lowest-confidence positions per
    row, with confidence = log(p) + temperature * gumbel.

    mask_len: (B, 1) counts; probs: (B, S) fp32; gumbel: (B, S) fp32."""
    confidence = log(probs) + temperature * gumbel
    sorted_confidence = torch.sort(confidence, dim=-1).values
    cut_off = torch.gather(sorted_confidence, -1, mask_len.long())
    return confidence < cut_off


def cosine_schedule(t):
    return torch.cos(t * math.pi * 0.5)


def linear_schedule(t):
    return torch.clamp(1 - t, 1e-6, 1.0)


def pow_schedule(t, method: str = "pow2"):
    exponent = float(method.replace("pow", ""))
    return torch.clamp(1.0 - t ** exponent, 1e-6, 1.0)


def sigmoid_schedule(t, start=-3, end=3, tau=1.0, clip_min=1e-6):
    v_start = torch.sigmoid(torch.tensor(start / tau, dtype=torch.float32))
    v_end = torch.sigmoid(torch.tensor(end / tau, dtype=torch.float32))
    output = torch.sigmoid((t * (end - start) + start) / tau)
    output = (v_end - output) / (v_end - v_start)
    return torch.clamp(output, clip_min, 1.0)


def get_mask_schedule(method: str, **schedule_kwargs):
    if method == "cosine":
        return cosine_schedule
    if method == "linear":
        return linear_schedule
    if "pow" in method:
        return partial(pow_schedule, method=method)
    if method == "sigmoid":
        return partial(sigmoid_schedule, **schedule_kwargs)
    raise ValueError(f"Unknown schedule method: {method}")
