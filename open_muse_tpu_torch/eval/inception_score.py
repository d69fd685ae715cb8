"""Inception Score, exp(E_x[KL(p(y|x) || p(y))]), the counterpart of
``open_muse_tpu/eval/inception_score.py``.  Any ``classify(images) -> (N,
C) logits`` works; InceptionV3's head gives the published protocol."""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

__all__ = ["inception_score", "inception_score_from_logits"]


def inception_score_from_logits(logits: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """(mean, std) of the score over ``splits`` chunks (Salimans et al.
    2016, the split scheme of cleanfid and torchmetrics)."""
    logits = np.asarray(logits, dtype=np.float64)
    if logits.ndim != 2:
        raise ValueError(f"expected (N, C) logits, got {logits.shape}")
    logits = logits - logits.max(axis=1, keepdims=True)
    probs = np.exp(logits)
    probs /= probs.sum(axis=1, keepdims=True)
    splits = max(1, min(splits, len(probs)))
    scores = []
    for chunk in np.array_split(probs, splits):
        marginal = chunk.mean(axis=0, keepdims=True)
        kl = (chunk * (np.log(chunk + 1e-12) - np.log(marginal + 1e-12))).sum(1)
        scores.append(float(np.exp(kl.mean())))
    return float(np.mean(scores)), float(np.std(scores))


def inception_score(images: Iterable, classify, splits: int = 10,
                    batch_size: int = 32) -> Tuple[float, float]:
    """Score an image set with ``classify(images) -> (B, C) logits``."""
    images = list(images)
    logits = [np.asarray(classify(images[start:start + batch_size]))
              for start in range(0, len(images), batch_size)]
    return inception_score_from_logits(np.concatenate(logits, axis=0), splits=splits)
