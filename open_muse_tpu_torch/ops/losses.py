"""Loss functions for masked-token training.

Counterpart of ``open_muse_tpu/ops/losses.py``: torch ``cross_entropy``
semantics with ``ignore_index=-100`` and label smoothing, the reference v2
loss weighting, and the soft-target cross entropy, all staged in fp32.
Each loss is a ratio, ``ratio(total, count, min_count)``: a plain division
by default; a data-parallel train step passes its
``parallel.mesh.DataParallel.ratio``, whose denominator is the global
batch's, as the JAX step takes it over the whole sharded batch.
"""

from __future__ import annotations

import torch

__all__ = ["IGNORE_INDEX", "cross_entropy_loss", "weighted_cross_entropy_loss",
           "soft_target_cross_entropy"]

IGNORE_INDEX = -100


def _per_token_ce(logits, labels, label_smoothing: float = 0.0):
    """Per-token CE in fp32; tokens labelled -100 give 0 and are flagged
    invalid in the returned mask."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    nll = -torch.gather(log_probs, -1, safe[..., None])[..., 0]
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll + label_smoothing * -log_probs.mean(-1)
    return torch.where(valid, nll, torch.zeros_like(nll)), valid


def _divide(total, count, min_count=None):
    return total / (count if min_count is None else count.clamp(min=min_count))


def cross_entropy_loss(logits, labels, label_smoothing: float = 0.0, ratio=_divide):
    """Mean CE over the tokens not labelled -100."""
    nll, valid = _per_token_ce(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                               label_smoothing)
    return ratio(nll.sum(), valid.sum(), min_count=1)


def weighted_cross_entropy_loss(logits, labels, loss_weight, label_smoothing: float = 0.0,
                                ratio=_divide):
    """Per-token CE times its weight over the weight sum, across the whole
    batch (reference modeling_transformer_v2.py:305-317)."""
    nll, _ = _per_token_ce(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                           label_smoothing)
    w = loss_weight.reshape(-1).float()
    return ratio((nll * w).sum(), w.sum())


def soft_target_cross_entropy(logits, targets, soft_targets, drop_first: bool = True,
                              ratio=_divide):
    """Soft-target CE for soft VQ codes; ``drop_first`` drops a leading
    class token as the reference does unconditionally."""
    if drop_first:
        logits, targets = logits[:, 1:], targets[:, 1:]
    log_probs = torch.log_softmax(logits[..., :soft_targets.shape[-1]].float(), dim=-1)
    padding = targets == IGNORE_INDEX
    loss = (-soft_targets * log_probs).sum(-1)
    loss = torch.where(padding, torch.zeros_like(loss), loss)
    return ratio(loss.sum(), padding.numel() - padding.sum())
