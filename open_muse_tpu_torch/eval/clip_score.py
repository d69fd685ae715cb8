"""CLIP score of a generated set, the counterpart of
``open_muse_tpu/eval/clip_score.py``: torchmetrics' CLIPScore,
``mean(max(100 * cos(image_embed, text_embed), 0))`` over (image, caption)
pairs, at the fixed scale 100, not the model's learned logit scale."""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

__all__ = ["clip_score"]


def clip_score(scorer, images: Iterable, captions: Sequence[str], batch_size: int = 32) -> float:
    """Mean CLIP score over paired image and caption lists; ``scorer`` is a
    ``models.clip_vision.CLIPScorer`` (its towers only)."""
    images = list(images)
    if len(images) != len(captions):
        raise ValueError(f"{len(images)} images vs {len(captions)} captions")
    scores = []
    for start in range(0, len(images), batch_size):
        img = scorer.embed_images(images[start:start + batch_size]).double().cpu().numpy()
        txt = scorer.embed_texts(captions[start:start + batch_size]).double().cpu().numpy()
        scores.append(np.maximum(100.0 * np.sum(img * txt, axis=-1), 0.0))
    return float(np.concatenate(scores).mean())
