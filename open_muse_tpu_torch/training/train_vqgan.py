"""VQGAN tokenizer trainer CLI.

Run:  python -m open_muse_tpu_torch.training.train_vqgan config=configs/vqgan_gan.yaml a.b=1

Counterpart of ``open_muse_tpu/training/train_vqgan.py`` ``main``, the
taming-transformers recipe: reconstruction (L2 + L1) and the VQ codebook /
commitment losses through the straight-through estimator, the optional
perceptual term (``training.perceptual_weight``; ``ops/perceptual.py``, its
pyramid seeded from ``training.seed``) and the optional PatchGAN term
(``training.disc_weight``; ``models/discriminator.py``) with taming's
adaptive weight at the decoder's last convolution, the hinge or vanilla
loss and the ``disc_start`` gate.  In the order it runs: config -> the VQ
model (``model.vq_model_type`` built from ``model.vq_model.params``) on the
card (the override ``device=cpu`` runs it on the CPU; CUDA asked for and
absent raises), fp32 with TF32 off -> AdamW with the lr schedule, and the
discriminator with its own AdamW on the same schedule -> loop { batch
(``Text2ImageDataset(require_text=False)``), the two-player step (one
replayed CUDA graph on the card, ``trainer.make_vqgan_train_step``),
metrics.jsonl every ``log_every``, ``recon-{step}.png`` of the last batch's
first 8 images every ``generate_every``, checkpoints every ``save_every`` and
at the end: ``checkpoint-{step}/unwrapped_model/`` the VQ model's
``save_pretrained`` directory, the discriminator's under
``discriminator/`` }.  No resume, as in the JAX trainer.

Under a launcher the batch is split over the ranks as ``train_muse`` splits
it: each rank reads its shards at its share of ``training.batch_size`` and
the step averages both players' gradients (and the adaptive weight's two
gradients) over the ranks in its graph.  Neither player keeps batch
statistics (the PatchGAN uses GroupNorm, the tokenizers none in training),
so nothing else is reduced.  Rank 0 writes metrics, panels and checkpoints.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from ..core.modeling import resolve_device
from ..models.discriminator import PatchDiscriminator, last_decoder_conv
from ..ops.perceptual import make_perceptual_loss_fn
from ..parallel.mesh import (barrier, data_parallel, init_training, local_batch_slice,
                             rank_and_world)
from ..scripts.pre_encode import to_device
from ..utils import logging as mlog
from ..utils.config import load_config
from ..utils.training_utils import AverageMeter, set_seed
from . import trainer as T
from .data import Text2ImageDataset
from .lr_schedules import get_scheduler
from .optimizers import get_optimizer
from .train_muse import VQ_CLASSES, MetricsTracker, log_step, save_image_grid

__all__ = ["main"]

logger = mlog.get_logger(__name__)


def main(argv=None):
    """Train from ``argv`` (``config=path.yaml`` and ``a.b=value``
    overrides) on the override ``device=``, else ``cuda``; returns the
    players, (generator,) or (generator, discriminator), as ``TrainState``s."""
    config = load_config(argv if argv is not None else sys.argv[1:])
    device = resolve_device(config.get("device", "cuda"))
    tcfg = config.training
    dp = data_parallel(init_training(device, tcfg.batch_size))
    mlog.set_verbosity_for_process()
    is_main = rank_and_world()[0] == 0
    rows = local_batch_slice(tcfg.batch_size)
    seed = tcfg.get("seed", 42)
    set_seed(seed)
    if device.type == "cuda":  # fp32 throughout, as the port's VQ code runs
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    output_dir = config.experiment.output_dir
    tracker = MetricsTracker(output_dir) if is_main else None

    vq_type = config.model.get("vq_model_type", "maskgit_vqgan")
    if vq_type not in VQ_CLASSES:
        raise ValueError(f"model.vq_model_type {vq_type!r}: one of {sorted(VQ_CLASSES)}")
    params = config.model.vq_model.get("params")
    with torch.device(device):
        model = VQ_CLASSES[vq_type](**(params.to_dict() if params is not None else {}))
    logger.info("vq params: %.1fM", sum(p.numel() for p in model.parameters()) / 1e6)

    max_steps = tcfg.max_train_steps
    schedule = get_scheduler(
        config.lr_scheduler.scheduler, base_lr=float(config.optimizer.params.learning_rate),
        num_warmup_steps=config.lr_scheduler.params.get("warmup_steps", 100),
        num_training_steps=max_steps)

    def adamw(module):
        return get_optimizer(config.optimizer.get("name", "adamw"), module, schedule,
                             weight_decay=config.optimizer.params.get("weight_decay", 1e-4),
                             max_grad_norm=tcfg.get("max_grad_norm"))

    players = (T.TrainState(model=model, optimizer=adamw(model)),)
    resolution = config.dataset.params.get("resolution", 256)
    perceptual_weight = tcfg.get("perceptual_weight", 0.0)
    perceptual = None
    if perceptual_weight > 0.0:
        with torch.device(device):
            perceptual = make_perceptual_loss_fn(seed=seed)
    disc_weight = tcfg.get("disc_weight", 0.0)
    if disc_weight > 0.0:
        last_decoder_conv(model)  # raises for a model without one, as JAX does
        torch.manual_seed(seed + 1)
        with torch.device(device):
            disc = PatchDiscriminator(base_channels=tcfg.get("disc_channels", 64),
                                      n_layers=tcfg.get("disc_layers", 3))
        players += (T.TrainState(model=disc, optimizer=adamw(disc)),)
    train_step = T.make_vqgan_train_step(
        l1_weight=tcfg.get("l1_weight", 1.0), l2_weight=tcfg.get("l2_weight", 1.0),
        codebook_weight=tcfg.get("codebook_weight", 1.0), perceptual_weight=perceptual_weight,
        perceptual=perceptual, disc_weight=disc_weight, disc_start=tcfg.get("disc_start", 0),
        disc_loss=tcfg.get("disc_loss", "hinge"), data_parallel=dp)

    dataset = Text2ImageDataset(
        config.dataset.params.train_shards_path_or_url, rows.stop - rows.start,
        resolution=resolution,
        shuffle_buffer_size=config.dataset.params.get("shuffle_buffer_size", 1000),
        require_text=False, seed=seed)
    log_every = config.experiment.get("log_every", 50)
    save_every = config.experiment.get("save_every", 1000)
    generate_every = config.experiment.get("generate_every", 1000)
    total_limit = config.experiment.get("checkpoints_total_limit")

    gen = players[0]

    def save(limit=None):
        if is_main:
            T.save_checkpoint(output_dir, gen, checkpoints_total_limit=limit, pretrained=True)
            if len(players) > 1:
                T.save_checkpoint(os.path.join(output_dir, "discriminator"), players[1])
        barrier()

    batch_time, data_time = AverageMeter(), AverageMeter()
    data_iter = iter(dataset)
    end = time.time()
    while gen.step < max_steps:
        try:
            raw = next(data_iter)
        except StopIteration:
            data_iter = iter(dataset)
            raw = next(data_iter)
        data_time.update(time.time() - end)
        pixels = to_device(raw["pixel_values"], device)
        capture = train_step.last_capture
        metrics = train_step(players, {"pixel_values": pixels})
        step = gen.step
        if step % log_every == 0 and is_main:
            log_step(tracker, train_step, capture, metrics, gen, tcfg.batch_size, end,
                     batch_time, data_time)
        if step % generate_every == 0 and is_main:
            with torch.no_grad():
                recon = model(pixels[:8])[0]
            save_image_grid(recon.float().cpu().numpy(),
                            os.path.join(output_dir, f"recon-{step}.png"))
        if step % save_every == 0:
            save(total_limit)
        end = time.time()
    barrier()  # every rank looks before any writes the last checkpoint
    if not os.path.isdir(os.path.join(output_dir, f"checkpoint-{gen.step}")):
        save()
    logger.info("training done at step %d", gen.step)
    return players


if __name__ == "__main__":
    main()
