"""Masking for masked-token training.

Counterpart of ``open_muse_tpu/training/masking.py``.  JAX draws its noise
from a PRNG key inside the function; PyTorch cannot reproduce those bits, so
here the draws come in as a ``MaskingNoise`` (made by ``draw_masking_noise``
from a ``torch.Generator`` in training, or handed over from JAX in the
tests).  Given the same draws, both packages mask the same positions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

__all__ = ["MaskingNoise", "draw_masking_noise", "get_loss_weight",
           "mask_or_random_replace_tokens", "cond_keep_mask", "prepend_class_token"]


@dataclasses.dataclass
class MaskingNoise:
    """The random draws of one masking call, on the tokens' device.

    timesteps (B,) and permutation (B, S) are uniform in [0, 1); rect (3, B)
    holds the uniforms for the rectangle's height, first row and first
    column, and use_rect () the one that picks the rectangle over random
    positions; random_tokens (B, S) are the ``random_replace`` tokens;
    eval_index (B,) picks an entry of ``eval_mask_ratios`` (an eval step
    reads it and the permutation alone); cond_dropout (B,) uniform in [0, 1)
    is the train step's CFG cond-dropout draw.

    The JAX steps split their key as: v2 ``mask, drop = split(key)``; the v1
    text step ``mask, drop, dropout = split(key, 3)``; the class step
    ``mask, dropout = split(key)``.  ``mask`` feeds these draws, ``drop``
    the cond-dropout uniform, and ``dropout`` the v1 model's ``nn.Dropout``
    masks, which the port draws inside the step
    (``models.transformer_v1.KeepMasks``)."""

    timesteps: Optional[torch.Tensor]
    permutation: torch.Tensor
    rect: Optional[torch.Tensor]
    use_rect: Optional[torch.Tensor]
    random_tokens: Optional[torch.Tensor]
    eval_index: Optional[torch.Tensor] = None
    cond_dropout: Optional[torch.Tensor] = None

    def rows(self, sl: slice) -> "MaskingNoise":
        """The draws of the batch rows ``sl`` (a rank's share of noise drawn
        for the global batch); ``use_rect`` is the batch's one draw."""
        def take(t, dim=0):
            return None if t is None else t[(slice(None),) * dim + (sl,)]
        return MaskingNoise(take(self.timesteps), take(self.permutation), take(self.rect, 1),
                            self.use_rect, take(self.random_tokens), take(self.eval_index),
                            take(self.cond_dropout))


def draw_masking_noise(batch_size: int, seq_len: int, generator: torch.Generator,
                       codebook_size: int, num_eval_ratios: Optional[int] = None,
                       cond_dropout: bool = False) -> MaskingNoise:
    """Every draw of one masking call from ``generator``, on its device,
    and after them, with ``cond_dropout``, the cond-dropout uniforms."""
    kw = dict(generator=generator, device=generator.device)
    noise = MaskingNoise(
        timesteps=torch.rand(batch_size, **kw),
        permutation=torch.rand(batch_size, seq_len, **kw),
        rect=torch.rand(3, batch_size, **kw),
        use_rect=torch.rand((), **kw),
        random_tokens=torch.randint(0, codebook_size, (batch_size, seq_len), **kw),
        eval_index=None if num_eval_ratios is None
        else torch.randint(0, num_eval_ratios, (batch_size,), **kw))
    if cond_dropout:
        noise.cond_dropout = torch.rand(batch_size, **kw)
    return noise


def get_loss_weight(t, mask, min_val: float = 0.3):
    # reference train_muse.py:145-146
    return 1 - (1 - mask) * ((1 - t) * (1 - min_val))[:, None]


def mask_or_random_replace_tokens(
    image_tokens,
    mask_id: int,
    mask_schedule,
    noise: MaskingNoise,
    *,
    min_masking_rate: float = 0.0,
    noise_type: str = "mask",
    codebook_size: Optional[int] = None,
    predict_all_tokens: bool = False,
    mask_contiguous_region_prob: Optional[float] = None,
    eval_mask_ratios: Optional[Sequence[float]] = None,
    is_train: bool = True,
):
    """Returns (input_ids, labels, loss_weight, mask_prob), as the JAX
    function does for the same draws: the timesteps run through the mask
    schedule (clipped at ``min_masking_rate``), the positions of lowest rank
    in the permutation are masked (or a rectangle of as many tokens), and
    labels are -100 outside the mask unless ``predict_all_tokens``."""
    batch_size, seq_len = image_tokens.shape
    device = image_tokens.device
    if not is_train and eval_mask_ratios is not None:
        ratios = torch.as_tensor(eval_mask_ratios, dtype=torch.float32, device=device)
        mask_prob = ratios[noise.eval_index]
    else:
        mask_prob = mask_schedule(noise.timesteps.float()).clamp(min=min_masking_rate)
    num_token_masked = torch.round(seq_len * mask_prob).clamp(min=1).to(torch.int32)

    # the rank of each position in a uniform permutation; the lowest
    # num_token_masked ranks are masked (reference batch_randperm trick)
    randperm = torch.argsort(noise.permutation, dim=-1, stable=True)
    rank = torch.argsort(randperm, dim=-1, stable=True)
    random_mask = rank < num_token_masked[:, None]

    if mask_contiguous_region_prob:
        res = math.isqrt(seq_len)
        n = num_token_masked
        lo = torch.ceil(n / res).to(torch.int32)
        hi = torch.clamp(n, max=res).to(torch.int32)
        h = (lo + torch.floor(noise.rect[0] * (hi - lo + 1))).to(torch.int32).clamp(1, res)
        w = torch.ceil(n / h).to(torch.int32).clamp(1, res)
        sh = torch.floor(noise.rect[1] * (res - h + 1)).to(torch.int32)
        sw = torch.floor(noise.rect[2] * (res - w + 1)).to(torch.int32)
        rows = torch.arange(res, device=device)[None, :, None]
        cols = torch.arange(res, device=device)[None, None, :]
        rect = ((rows >= sh[:, None, None]) & (rows < (sh + h)[:, None, None])
                & (cols >= sw[:, None, None]) & (cols < (sw + w)[:, None, None]))
        mask = torch.where(noise.use_rect < mask_contiguous_region_prob,
                           rect.reshape(batch_size, seq_len), random_mask)
    else:
        mask = random_mask

    if noise_type == "mask":
        input_ids = torch.where(mask, mask_id, image_tokens)
    elif noise_type == "random_replace":
        if codebook_size is None:
            raise ValueError("random_replace needs codebook_size")
        input_ids = torch.where(mask, noise.random_tokens.to(image_tokens.dtype), image_tokens)
    else:
        raise ValueError(f"noise_type {noise_type} not supported")

    if predict_all_tokens or noise_type == "random_replace":
        labels = image_tokens
        loss_weight = get_loss_weight(mask_prob, mask.float())
    else:
        labels = torch.where(mask, image_tokens, -100)
        loss_weight = None
    return input_ids, labels, loss_weight, mask_prob


def cond_keep_mask(uniforms, cond_dropout_prob: float, dtype):
    """The v1 text step's CFG cond-dropout mask (B, 1, 1): 1 where an image
    keeps its text (``uniforms >= cond_dropout_prob``), else 0, in
    ``dtype``; the model multiplies it into the text states."""
    return (uniforms >= cond_dropout_prob).to(dtype)[:, None, None]


def prepend_class_token(input_ids, labels, class_ids, codebook_size: int):
    """The class step's class token: ``class_ids + codebook_size`` at
    position 0 of the (masked) ids, label -100 there."""
    class_tok = (class_ids.to(input_ids.dtype) + codebook_size)[:, None]
    return (torch.cat([class_tok, input_ids], dim=1),
            torch.cat([torch.full_like(class_tok, -100), labels], dim=1))
