"""Text-to-image trainer CLI for MaskGiTUViT_v2 on pre-encoded shards.

Run:  python -m open_muse_tpu_torch.training.train_muse config=configs/xxx.yaml a.b=1

Counterpart of ``open_muse_tpu/training/train_muse.py`` ``main`` for its
``training.pre_encode: true`` branch: image tokens and CLIP embeddings come
from pre-encoded shards, so neither the text tower nor the VQ model is
built.  Flow: config (``utils/config.py``, yaml only) -> model on the card
(the override ``device=cpu`` runs it on the CPU; CUDA asked for and absent
raises) -> optimizer, schedule, EMA -> resume -> loop
{ batch, masking noise, train step, metrics.jsonl, checkpoint }.
``mixed_precision: bf16`` keeps fp32 weights and runs the step under bf16
autocast.  Evaluation, generation, inpainting panels, wandb and multi-host
runs are not ported.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

import numpy as np
import torch

from ..core.modeling import resolve_device
from ..models.transformer_v2 import MaskGiTUViT_v2
from ..ops.sampling import get_mask_schedule
from ..utils.config import load_config
from ..utils.training_utils import AverageMeter, set_seed
from . import trainer as T
from .data import PreEncodedDataset, WebdatasetSelect
from .ema import EMA
from .lr_schedules import get_scheduler
from .masking import draw_masking_noise
from .optimizers import get_optimizer

__all__ = ["MetricsTracker", "main"]

logger = logging.getLogger(__name__)


class MetricsTracker:
    """Appends one JSON line per ``log`` call to ``output_dir/metrics.jsonl``."""

    def __init__(self, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")

    def log(self, values: dict, step: int) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, **values}) + "\n")


def _first_of(batch, *names):
    return next((batch[n] for n in names if n in batch), None)


def prepare_batch(batch, config, cond_embed_dim: int, device) -> dict:
    """A collated pre-encoded batch -> the train step's tensors on
    ``device`` (the shard dialects of the JAX ``prepare_batch``: members
    named ``vq_f16.npy`` / ``clip_penultimate.npy`` / ``clip_pooled.npy``).
    Pre-encoded shards carry no image sizes, crops or aesthetic scores, so
    the micro-conditioning is the JAX defaults (512, 512, 0, 0, 6.0)."""
    vq_key = config.training.get("pre_encode_vq", "f16")
    tokens = _first_of(batch, "image_tokens", "image_input_ids", f"vq_{vq_key}.npy",
                       "vq_f16.npy", "vq_f8.npy")
    ehs = _first_of(batch, "encoder_hidden_states", "clip_penultimate.npy")
    if tokens is None or ehs is None:
        raise KeyError(f"pre-encoded batch lacks image tokens / text embeds; members present: "
                       f"{sorted(batch)}")
    n = len(tokens)
    pooled = _first_of(batch, "cond_embeds", "clip_pooled.npy")
    if pooled is None:
        pooled = np.zeros((n, cond_embed_dim), dtype=np.float32)
    micro = np.tile(np.asarray([[512.0, 512.0, 0.0, 0.0, 6.0]], dtype=np.float32), (n, 1))
    as_tensor = lambda a, dtype: torch.as_tensor(np.asarray(a), dtype=dtype).to(device)  # noqa: E731
    return {"image_tokens": as_tensor(tokens, torch.long),
            "encoder_hidden_states": as_tensor(ehs, torch.float32),
            "cond_embeds": as_tensor(pooled, torch.float32),
            "micro_conds": as_tensor(micro, torch.float32)}


def build_state(config, device) -> T.TrainState:
    """Model, optimizer (with the lr schedule) and EMA from ``config``."""
    tcfg = config.model.transformer.to_dict()
    if config.model.get("architecture", "uvit") != "uvit":
        raise NotImplementedError("the port trains MaskGiTUViT_v2 (model.architecture: uvit)")
    with torch.device(device):
        model = MaskGiTUViT_v2(MaskGiTUViT_v2.config_from_dict(tcfg))
    model.set_gradient_checkpointing(config.model.get("gradient_checkpointing", False))
    opt_cfg = config.optimizer.params
    lr = float(opt_cfg.learning_rate)  # yaml reads 1e-4 as a string
    if opt_cfg.get("scale_lr", False):
        lr = lr * config.training.batch_size
    schedule = get_scheduler(
        config.lr_scheduler.scheduler, base_lr=lr,
        num_warmup_steps=config.lr_scheduler.params.get("warmup_steps", 500),
        num_training_steps=config.training.get("max_train_steps", 1000000))
    optimizer = get_optimizer(
        config.optimizer.get("name", "adamw"), model, schedule,
        beta1=opt_cfg.get("beta1", 0.9), beta2=opt_cfg.get("beta2", 0.999),
        weight_decay=opt_cfg.get("weight_decay", 0.01), epsilon=opt_cfg.get("epsilon", 1e-8),
        max_grad_norm=config.training.get("max_grad_norm"))
    ema = EMA(model) if config.training.get("use_ema", False) else None
    return T.TrainState(model=model, optimizer=optimizer, ema=ema)


def main(argv=None) -> T.TrainState:
    """Train from ``argv`` (``config=path.yaml`` and ``a.b=value``
    overrides) on the override ``device=``, else ``cuda``."""
    config = load_config(argv if argv is not None else sys.argv[1:])
    device = resolve_device(config.get("device", "cuda"))
    seed = config.training.get("seed", 42)
    set_seed(seed)
    if not config.training.get("pre_encode", False):
        raise NotImplementedError("the port trains from pre-encoded shards only "
                                  "(training.pre_encode=true)")
    if config.training.get("gradient_accumulation_steps", 1) != 1:
        raise NotImplementedError("gradient_accumulation_steps > 1 is not ported")

    output_dir = config.experiment.output_dir
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "config.yaml"), "w") as f:
        import yaml

        yaml.safe_dump(config.to_dict(), f)
    tracker = MetricsTracker(output_dir)

    state = build_state(config, device)
    model = state.model
    logger.info("transformer params: %.1fM", sum(p.numel() for p in model.parameters()) / 1e6)
    autocast_dtype = torch.bfloat16 if config.training.get("mixed_precision") == "bf16" else None
    mask_id, codebook_size = model.config.mask_token_id, model.config.codebook_size
    train_step = T.make_uvit_train_step(
        get_mask_schedule(config.training.get("mask_schedule", "cosine")), mask_id,
        codebook_size=codebook_size,
        min_masking_rate=config.training.get("min_masking_rate", 0.0),
        noise_type=config.training.get("noise_type", "mask"),
        predict_all_tokens=config.training.get("predict_all_tokens", False),
        mask_contiguous_region_prob=config.training.get("mask_contiguous_region_prob"),
        label_smoothing=config.training.get("label_smoothing", 0.0),
        autocast_dtype=autocast_dtype)

    resume = config.experiment.get("resume_from_checkpoint")
    if resume:
        path = T.find_latest_checkpoint(output_dir) if resume == "latest" else resume
        if path:
            T.load_checkpoint(path, state)
            logger.info("resumed from %s at step %d", path, state.step)

    ds_params = config.dataset.params
    select = None
    if config.dataset.get("quality_filter"):
        select = WebdatasetSelect(**config.dataset.quality_filter.to_dict())
    batch_size = config.training.batch_size
    dataset = PreEncodedDataset(ds_params.train_shards_path_or_url, batch_size,
                                shuffle_buffer_size=ds_params.get("shuffle_buffer_size", 1000),
                                select=select, seed=seed)
    # the pre-encode branch has no text tower, hence no empty-prompt
    # embeddings: CFG cond dropout does not run, as in the JAX trainer
    generator = torch.Generator(device).manual_seed(seed)

    max_steps = config.training.max_train_steps
    log_every = config.experiment.get("log_every", 50)
    save_every = config.experiment.get("save_every", 1000)
    overfit = config.training.get("overfit_one_batch", False)
    batch_time, data_time = AverageMeter(), AverageMeter()
    data_iter = iter(dataset)
    cached = None
    end = time.time()
    while state.step < max_steps:
        if not (overfit and cached is not None):
            cached = prepare_batch(next(data_iter), config, model.config.cond_embed_dim, device)
        batch = cached
        seq_len = batch["image_tokens"].shape[1]
        data_time.update(time.time() - end)
        noise = draw_masking_noise(batch_size, seq_len, generator, codebook_size)
        metrics = train_step(state, batch, noise)
        if state.step % log_every == 0:
            values = {k: float(v) for k, v in metrics.items()}  # waits for the step
            batch_time.update(time.time() - end)
            values.update({"lr": state.optimizer.schedule(state.step),
                           "samples/sec": batch_size / max(batch_time.avg, 1e-9),
                           "step_time": batch_time.val, "data_time": data_time.avg,
                           "batch_time": batch_time.avg})
            tracker.log(values, state.step)
            logger.info("step %d: loss=%.4f (%.1f samples/s)", state.step, values["loss"],
                        values["samples/sec"])
        if state.step % save_every == 0:
            T.save_checkpoint(output_dir, state,
                              checkpoints_total_limit=config.experiment.get(
                                  "checkpoints_total_limit"))
        end = time.time()
    if not os.path.isdir(os.path.join(output_dir, f"checkpoint-{state.step}")):
        T.save_checkpoint(output_dir, state)
    logger.info("training done at step %d", state.step)
    return state


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
