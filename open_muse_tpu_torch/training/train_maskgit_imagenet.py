"""Class-conditional ImageNet MaskGIT trainer CLI (the v1 MaskGitTransformer).

Run:  python -m open_muse_tpu_torch.training.train_maskgit_imagenet config=configs/imagenet.yaml

Counterpart of ``open_muse_tpu/training/train_maskgit_imagenet.py`` ``main``,
in the order it runs: config (the override ``device=cpu`` runs on the CPU;
CUDA asked for and absent raises) -> the VQ model (``vq_model.pretrained``
directory, else ``vq_model.params``; fp32, TF32 off) -> the model -> AdamW
with the schedule, ``weight_decay`` and ``max_grad_norm`` (betas and epsilon
at their defaults, as the JAX file builds it) -> EMA under ``use_ema`` ->
resume -> ``ClassificationDataset`` with the JAX file's arguments (no
``center_crop``: the config's is not read there either) -> loop { batch,
``get_code`` (one replayed CUDA graph on the card), the masking noise, the
train step (``make_maskgit_train_step``: one replayed CUDA graph on the card),
metrics.jsonl, the sample panel, checkpoint }.  There is no eval.

Two traits of the JAX trainer stay: the step never updates the EMA, so the
panel of a ``use_ema`` run samples the initial weights (ROADMAP fault
3.10), and ``model.gradient_checkpointing`` is not read.  Where the JAX
trainer builds its model in fp32 whatever ``training.mixed_precision`` says,
the port reads it (``bf16``: fp32 weights, the step under bf16 autocast, as
``train_muse`` runs): the card's norm and attention kernels take bf16.

Under a launcher the batch is split over every rank (dp, as the JAX file's
mesh), as ``train_muse`` splits it: each rank reads its shards at its share
of ``training.batch_size``, keeps its rows of the global masking noise and
averages the gradients in its step; rank 0 writes metrics, panels and
checkpoints.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from ..core.modeling import resolve_device
from ..models.transformer_v1 import KeepMasks, MaskGitTransformer
from ..ops.sampling import get_mask_schedule
from ..parallel.mesh import (barrier, data_parallel, init_training, local_batch_slice,
                             rank_and_world)
from ..scripts.pre_encode import to_device
from ..utils import logging as mlog
from ..utils.config import load_config
from ..utils.training_utils import AverageMeter, set_seed
from . import trainer as T
from .data import ClassificationDataset
from .ema import EMA
from .lr_schedules import get_scheduler
from .masking import draw_masking_noise
from .optimizers import get_optimizer
from .train_muse import (MetricsTracker, SamplePanel, get_code, load_vq_model, log_step, resume,
                         save)

__all__ = ["IMAGENET_CLASS_IDS", "class_panel", "main"]

logger = mlog.get_logger(__name__)

# the sample panel's classes (the first 8)
IMAGENET_CLASS_IDS = [1, 7, 282, 604, 724, 179, 751, 404, 850, 283, 128, 204,
                      760, 611, 539, 319]


def class_panel(model, batch, generator):
    """8 samples of ``IMAGENET_CLASS_IDS`` (modulo ``num_classes``): v1
    ``generate2``, 8 steps, no guidance."""
    n_classes = model.config.num_classes or 1
    class_ids = [c % n_classes for c in IMAGENET_CLASS_IDS[:8]]
    return model.generate2(class_ids=class_ids, timesteps=8, generator=generator)


def main(argv=None) -> T.TrainState:
    """Train from ``argv`` (``config=path.yaml`` and ``a.b=value``
    overrides) on the override ``device=``, else ``cuda``."""
    config = load_config(argv if argv is not None else sys.argv[1:])
    device = resolve_device(config.get("device", "cuda"))
    batch_size = config.training.batch_size
    dp = data_parallel(init_training(device, batch_size))
    mlog.set_verbosity_for_process()
    is_main = rank_and_world()[0] == 0
    rows = local_batch_slice(batch_size)
    seed = config.training.get("seed", 42)
    set_seed(seed)
    if device.type == "cuda":  # the frozen fp32 VQ model as serving runs it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    output_dir = config.experiment.output_dir
    os.makedirs(output_dir, exist_ok=True)
    tracker = MetricsTracker(output_dir) if is_main else None
    vq_model = load_vq_model(config, device)
    with torch.device(device):
        model = MaskGitTransformer(MaskGitTransformer.config_from_dict(
            config.model.transformer.to_dict()))
    logger.info("transformer params: %.1fM", sum(p.numel() for p in model.parameters()) / 1e6)
    mask_id, codebook_size = model.config.mask_token_id, model.config.codebook_size

    schedule = get_scheduler(
        config.lr_scheduler.scheduler, base_lr=float(config.optimizer.params.learning_rate),
        num_warmup_steps=config.lr_scheduler.params.get("warmup_steps", 500),
        num_training_steps=config.training.max_train_steps)
    optimizer = get_optimizer(config.optimizer.get("name", "adamw"), model, schedule,
                              weight_decay=config.optimizer.params.get("weight_decay", 0.01),
                              max_grad_norm=config.training.get("max_grad_norm"))
    state = T.TrainState(model=model, optimizer=optimizer,
                         ema=EMA(model) if config.training.get("use_ema", False) else None)
    autocast_dtype = torch.bfloat16 if config.training.get("mixed_precision") == "bf16" else None
    dropout = None
    if model.config.hidden_dropout > 0.0:
        dropout = KeepMasks(torch.Generator(device).manual_seed(seed + 1), dp.share)
    train_step = T.make_maskgit_train_step(
        get_mask_schedule(config.training.get("mask_schedule", "cosine")), mask_id,
        codebook_size=codebook_size, min_masking_rate=config.training.get("min_masking_rate", 0.0),
        label_smoothing=config.training.get("label_smoothing", 0.0),
        autocast_dtype=autocast_dtype, dropout=dropout, data_parallel=dp)
    resume(config, state, output_dir)

    dataset = ClassificationDataset(
        config.dataset.params.train_shards_path_or_url, rows.stop - rows.start,
        resolution=config.dataset.params.get("resolution", 256),
        shuffle_buffer_size=config.dataset.params.get("shuffle_buffer_size", 1000), seed=seed)
    generator = torch.Generator(device).manual_seed(seed)
    panel = SamplePanel(state, vq_model, autocast_dtype or torch.float32, seed, class_panel)

    max_steps = config.training.max_train_steps
    log_every = config.experiment.get("log_every", 50)
    save_every = config.experiment.get("save_every", 1000)
    generate_every = config.experiment.get("generate_every", 1000)
    batch_time, data_time = AverageMeter(), AverageMeter()
    data_iter = iter(dataset)
    end = time.time()
    while state.step < max_steps:
        raw = next(data_iter)
        data_time.update(time.time() - end)
        batch = {"image_tokens": get_code(vq_model, to_device(raw["pixel_values"], device)).long(),
                 "class_ids": to_device(raw["class_ids"], device).long()}
        noise = draw_masking_noise(batch_size, batch["image_tokens"].shape[1], generator,
                                   codebook_size).rows(rows)
        capture = train_step.last_capture
        metrics = train_step(state, batch, noise)
        step = state.step
        if step % log_every == 0 and is_main:
            log_step(tracker, train_step, capture, metrics, state, batch_size, end, batch_time,
                     data_time)
        if generate_every and step % generate_every == 0 and is_main:
            panel(batch, step, os.path.join(output_dir, f"samples-{step}.png"))
        if step % save_every == 0:
            save(output_dir, state, is_main,
                 checkpoints_total_limit=config.experiment.get("checkpoints_total_limit"))
        end = time.time()
    barrier()  # every rank looks before any writes the last checkpoint
    if not os.path.isdir(os.path.join(output_dir, f"checkpoint-{state.step}")):
        save(output_dir, state, is_main)
    logger.info("training done at step %d", state.step)
    return state


if __name__ == "__main__":
    main()
