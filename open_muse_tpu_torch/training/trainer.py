"""The MaskGiTUViT_v2 train and eval steps, and checkpoints.

Counterpart of ``open_muse_tpu/training/trainer.py`` (``make_uvit_train_step``,
``make_uvit_eval_step``, ``save_checkpoint``, ``find_latest_checkpoint``,
``load_checkpoint``).  The JAX step is one jitted program over an immutable
state; here the step updates the model, optimizer and EMA of a ``TrainState``
in place and returns its metrics as device tensors, so nothing waits for the
device until a caller reads them.  Masking noise comes in as an argument
(``masking.MaskingNoise``) because JAX's PRNG bits cannot be reproduced.

A checkpoint is ``checkpoint-{step}/`` with ``metadata.json``,
``unwrapped_model/`` and ``ema_model/`` (``config.json`` + ``pytorch_model.bin``)
and ``training_state.pt`` (step, optimizer).  The JAX package's Orbax
checkpoints are not read.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ..core.modeling import WEIGHTS_NAMES
from .ema import EMA
from .masking import MaskingNoise, mask_or_random_replace_tokens
from .optimizers import Optimizer, global_norm

__all__ = ["TrainState", "make_uvit_train_step", "make_uvit_eval_step", "save_checkpoint",
           "find_latest_checkpoint", "load_checkpoint"]


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    ema: Optional[EMA] = None
    step: int = 0


def make_uvit_train_step(
    mask_schedule,
    mask_id: int,
    *,
    codebook_size: int,
    min_masking_rate: float = 0.0,
    noise_type: str = "mask",
    predict_all_tokens: bool = False,
    mask_contiguous_region_prob: Optional[float] = None,
    label_smoothing: float = 0.0,
    autocast_dtype: Optional[torch.dtype] = None,
) -> Callable:
    """``train_step(state, batch, noise) -> metrics``.

    batch: image_tokens (B, S) int, encoder_hidden_states (B, L, E),
    cond_embeds (B, C), micro_conds (B, 5).  One call masks, runs the
    forward with the loss (under autocast to ``autocast_dtype`` when given)
    and the backward, takes the global grad norm, updates the optimizer
    (which clips by that norm when it has ``max_grad_norm``) and then the
    EMA, and increments ``state.step``.  Metrics: loss, grad_norm (before
    clipping), avg_masking_rate.  CFG cond dropout, which needs the empty
    prompt's embeddings from a text tower, is not ported."""

    def train_step(state: TrainState, batch: Dict[str, Any],
                   noise: MaskingNoise) -> Dict[str, torch.Tensor]:
        model = state.model
        input_ids, labels, loss_weight, mask_prob = mask_or_random_replace_tokens(
            batch["image_tokens"], mask_id, mask_schedule, noise,
            min_masking_rate=min_masking_rate, noise_type=noise_type,
            codebook_size=codebook_size, predict_all_tokens=predict_all_tokens,
            mask_contiguous_region_prob=mask_contiguous_region_prob)
        device_type = batch["image_tokens"].device.type
        with torch.autocast(device_type, dtype=autocast_dtype or torch.bfloat16,
                            enabled=autocast_dtype is not None):
            _, loss = model(input_ids, batch["encoder_hidden_states"], batch["cond_embeds"],
                            batch["micro_conds"], labels=labels, loss_weight=loss_weight,
                            label_smoothing=label_smoothing)
        state.optimizer.zero_grad()
        loss.backward()
        grad_norm = global_norm([p.grad for p in model.parameters() if p.grad is not None])
        state.optimizer.step(grad_norm)
        if state.ema is not None:
            state.ema.update(model, state.step)
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm,
                "avg_masking_rate": mask_prob.mean()}

    return train_step


def make_uvit_eval_step(mask_schedule, mask_id: int, *,
                        eval_mask_ratios=(0.1, 0.3, 0.5, 0.7, 0.9),
                        label_smoothing: float = 0.0) -> Callable:
    """``eval_step(model, batch, noise) -> loss`` at fixed mask ratios
    (``noise.eval_index`` picks one per image)."""

    @torch.no_grad()
    def eval_step(model, batch, noise: MaskingNoise):
        input_ids, labels, _, _ = mask_or_random_replace_tokens(
            batch["image_tokens"], mask_id, mask_schedule, noise,
            eval_mask_ratios=list(eval_mask_ratios), is_train=False)
        _, loss = model(input_ids, batch["encoder_hidden_states"], batch["cond_embeds"],
                        batch["micro_conds"], labels=labels, label_smoothing=label_smoothing)
        return loss

    return eval_step


# -- checkpoints (reference train_muse.py:571-610, 1265-1306) ------------------

_STATE_FILE = "training_state.pt"


def _save_model(path: str, config, state_dict) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(config), f, indent=2)
    torch.save(state_dict, os.path.join(path, WEIGHTS_NAMES[1]))


def save_checkpoint(output_dir: str, state: TrainState,
                    checkpoints_total_limit: Optional[int] = None) -> str:
    """Write ``output_dir/checkpoint-{step}/``, first removing the oldest
    checkpoints beyond ``checkpoints_total_limit``."""
    path = os.path.join(output_dir, f"checkpoint-{state.step}")
    os.makedirs(path, exist_ok=True)
    if checkpoints_total_limit is not None:
        existing = sorted((d for d in os.listdir(output_dir)
                           if d.startswith("checkpoint-") and d != os.path.basename(path)),
                          key=lambda d: int(d.split("-")[1]))
        while len(existing) >= checkpoints_total_limit:
            shutil.rmtree(os.path.join(output_dir, existing.pop(0)))
    config = state.model.config
    _save_model(os.path.join(path, "unwrapped_model"), config, state.model.state_dict())
    if state.ema is not None:
        _save_model(os.path.join(path, "ema_model"), config, state.ema.shadow)
    torch.save({"step": state.step, "optimizer": state.optimizer.state_dict()},
               os.path.join(path, _STATE_FILE))
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump({"global_step": state.step}, f)
    return path


def find_latest_checkpoint(output_dir: str) -> Optional[str]:
    # reference "latest" scan (train_muse.py:574-585)
    if not os.path.isdir(output_dir):
        return None
    dirs = [d for d in os.listdir(output_dir) if d.startswith("checkpoint-")]
    if not dirs:
        return None
    return os.path.join(output_dir, max(dirs, key=lambda d: int(d.split("-")[1])))


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore model, optimizer, EMA and step from ``path`` into ``state``."""
    device = next(state.model.parameters()).device

    def weights(sub):
        return torch.load(os.path.join(path, sub, WEIGHTS_NAMES[1]), map_location=device,
                          weights_only=True)

    state.model.load_state_dict(weights("unwrapped_model"))
    if state.ema is not None:
        state.ema.load_state_dict({"decay": state.ema.decay, "shadow": weights("ema_model")})
    saved = torch.load(os.path.join(path, _STATE_FILE), map_location=device, weights_only=True)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return state
