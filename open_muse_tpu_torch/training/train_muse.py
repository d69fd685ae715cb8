"""Text-to-image trainer CLI for MaskGiTUViT_v2 and the v1 MaskGitTransformer.

Run:  python -m open_muse_tpu_torch.training.train_muse config=configs/xxx.yaml a.b=1

Counterpart of ``open_muse_tpu/training/train_muse.py`` ``main`` for the U-ViT
(``model.architecture: uvit``) and the v1 transformer (``transformer``: the
text through cross-attention alone, no pooled or micro-conds, CFG cond
dropout as a mask on the text states with or without a text tower, the
model's dropout, no eval), in the order it runs: config
(``utils/config.py``, yaml only) -> the frozen encoders, unless
``training.pre_encode`` (the CLIP or T5 text tower and the VQ model, fp32,
``eval()``, TF32 off) -> model on the card (the override ``device=cpu`` runs
it on the CPU; CUDA asked for and absent raises) -> optimizer (wrapped as
``optax.MultiSteps`` is under ``gradient_accumulation_steps``), schedule,
EMA -> resume -> the empty prompt's embeddings (for CFG cond dropout) ->
loop { batch, encode (raw images: ``get_code`` and the text tower, each one
replayed CUDA graph on the card), masking and cond-dropout noise, the train
step (one replayed CUDA graph on the card), metrics.jsonl, per-parameter
grad norms, eval, the sample panel, checkpoint, a ``torch.profiler`` window }.
``mixed_precision: bf16`` keeps fp32 weights and runs the step under bf16
autocast.  ``training.use_soft_code_target`` (the raw branch only) takes the
image tokens and the v2 step's soft targets from the VQ model's
``get_soft_code`` (``soft_code_temp``; ``use_stochastic_code`` samples the
codes with Gumbel noise from the trainer's generator).
``experiment.inpainting_validation_dir`` (the raw v2 branch) adds an
inpainting panel beside each sample panel.  Raw shards may name a
``dataset.params.dataset_map`` dialect; pre-encoded ones may carry members
named after ``vae_checkpoint`` / ``text_encoder_checkpoint``.  wandb is not
ported.

Multi-process runs (``scripts/launch.py``, or ``torch.distributed.run``
directly; ``parallel.mesh.init_training``): ``training.batch_size`` is the
global batch, split over the dp x fsdp coordinates, which must divide it;
each rank reads its shards (split by that coordinate) at its share of the
batch, draws the masking noise for the global batch and keeps its rows;
the train step averages the gradients inside its graph
(``training/trainer.py``); the lr scales by the world size under
``scale_lr``; the ranks agree on the eval batch count before the eval's
collectives; rank 0 alone writes metrics, panels and checkpoints while the
others wait.  ``training.fsdp`` shards the model with FSDP2 and
``training.tp`` splits its weights over tp ranks (``parallel.sharding``,
``parallel.tensor_parallel``): the ranks of one tp group read the same
rows, draw the same noise and dropout masks, and run the kernels on their
own heads and columns; a sharded model's checkpoint holds whole weights.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core.captured import captured
from ..core.modeling import resolve_device
from ..models.clip_text import CLIPTextEncoder
from ..models.maskgit_vqgan import MaskGitVQGAN
from ..models.movq import MOVQ
from ..models.paella_vq import PaellaVQModel
from ..models.t5_text import T5TextEncoder
from ..models.taming_vqgan import VQGANModel
from ..models.transformer_v1 import KeepMasks, MaskGitTransformer
from ..models.transformer_v2 import MaskGiTUViT_v2
from ..ops.sampling import get_mask_schedule
from ..ops.vq import gumbel_noise
from ..parallel.mesh import (MeshAxes, all_reduce_min, barrier, batch_share, data_parallel,
                             init_training, local_batch_slice, rank_and_world)
from ..parallel.sharding import shard_params
from ..scripts.pre_encode import has_tokenizer_files, load_tokenizer, to_device
from ..utils import logging as mlog
from ..utils.config import load_config
from ..utils.training_utils import AverageMeter, set_seed
from . import trainer as T
from .data import PreEncodedDataset, Text2ImageDataset, WebdatasetSelect
from .ema import EMA
from .lr_schedules import get_scheduler
from .masking import draw_masking_noise
from .optimizers import get_optimizer

__all__ = ["MetricsTracker", "FrozenEncoders", "load_vq_model", "get_code", "save_image_grid",
           "prepare_batch", "SamplePanel", "load_inpainting_validation_data",
           "generate_inpainting_images", "log_step", "main"]

logger = mlog.get_logger(__name__)

VQ_CLASSES = {"vqgan": VQGANModel, "maskgit_vqgan": MaskGitVQGAN, "movq": MOVQ,
              "paella_vq": PaellaVQModel}
TEXT_ENCODERS = {"clip": CLIPTextEncoder, "t5": T5TextEncoder}


class MetricsTracker:
    """Appends one JSON line per ``log`` call to ``output_dir/metrics.jsonl``."""

    def __init__(self, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")

    def log(self, values: dict, step: int) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, **values}) + "\n")


def save_image_grid(images, path: str) -> None:
    """NHWC float images -> one PNG grid."""
    from PIL import Image

    images = np.clip(np.asarray(images, dtype=np.float32), 0, 1)
    n, h, w, c = images.shape
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    grid = np.zeros((rows * h, cols * w, c), dtype=np.float32)
    for i, img in enumerate(images):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = img
    Image.fromarray((grid * 255).astype(np.uint8)).save(path)


def _first_of(batch, *names):
    return next((batch[n] for n in names if n in batch), None)


def micro_conds(batch, n: int) -> np.ndarray:
    """(n, 5): original size, crop (top, left) and aesthetic score from the
    batch, the JAX defaults (512, 512, 0, 0, 6.0) where a member is missing."""
    aes = batch.get("aesthetic_scores")
    return np.concatenate([
        batch.get("orig_sizes", np.full((n, 2), 512.0)),
        batch.get("crop_coords", np.zeros((n, 2))),
        np.full((n, 1), 6.0) if aes is None else np.asarray(aes, np.float32).reshape(n, 1),
    ], axis=1).astype(np.float32)


def prepare_batch(batch, config, cond_embed_dim: Optional[int], device) -> dict:
    """A collated pre-encoded batch -> the train step's tensors on
    ``device`` (the shard dialects of the JAX ``prepare_batch``: members
    named ``vq_f16.npy`` / ``clip_penultimate.npy`` / ``clip_pooled.npy``).
    Pre-encoded shards carry no image sizes, crops or aesthetic scores, so
    the micro-conditioning is the JAX defaults (512, 512, 0, 0, 6.0).
    ``cond_embed_dim`` None (the v1 model): the image tokens and text states
    alone."""
    vq_key = config.training.get("pre_encode_vq", "f16")
    tokens = _first_of(batch, "image_tokens", "image_input_ids", f"vq_{vq_key}.npy",
                       "vq_f16.npy", "vq_f8.npy")
    ehs = _first_of(batch, "encoder_hidden_states", "clip_penultimate.npy")
    if tokens is None or ehs is None:
        raise KeyError(f"pre-encoded batch lacks image tokens / text embeds; members present: "
                       f"{sorted(batch)}")
    out = {"image_tokens": to_device(np.asarray(tokens, np.int64), device),
           "encoder_hidden_states": to_device(np.asarray(ehs, np.float32), device)}
    if cond_embed_dim is None:
        return out
    n = len(tokens)
    pooled = _first_of(batch, "cond_embeds", "clip_pooled.npy")
    if pooled is None:
        pooled = np.zeros((n, cond_embed_dim), dtype=np.float32)
    return {**out, "cond_embeds": to_device(np.asarray(pooled, np.float32), device),
            "micro_conds": to_device(micro_conds({}, n), device)}


def load_vq_model(config, device):
    """``model.vq_model_type``'s model from the ``model.vq_model.pretrained``
    directory, else built from ``model.vq_model.params``: fp32, ``eval()``,
    frozen."""
    vq_type = config.model.get("vq_model_type", "maskgit_vqgan")
    if vq_type not in VQ_CLASSES:
        raise ValueError(f"model.vq_model_type {vq_type!r}: one of {sorted(VQ_CLASSES)}")
    vq_cls = VQ_CLASSES[vq_type]
    vq_cfg = config.model.get("vq_model")
    vq_path = vq_cfg.get("pretrained") if vq_cfg is not None else None
    if vq_path and os.path.isdir(vq_path):
        vq_model = vq_cls.from_pretrained(vq_path, device=device)
    else:
        params = vq_cfg.get("params") if vq_cfg is not None else None
        with torch.device(device):
            vq_model = vq_cls(**(params.to_dict() if params is not None else {}))
    return vq_model.eval().requires_grad_(False)


def get_code(vq_model, pixels):
    """``vq_model.get_code(pixels)`` through ``core.captured`` (one replayed
    CUDA graph on the card, as the JAX package jits it)."""
    return captured(vq_model, ("get_code",), torch.no_grad()(vq_model.get_code), pixels,
                    modules=(vq_model,))


class FrozenEncoders:
    """The raw-image branch's frozen models: the text tower (CLIP: the
    penultimate hidden state and the pooled output; T5: the last hidden
    state and no pooled output, for which a v2 model gets zeros of
    ``cond_embed_dim``) and the VQ model's ``get_code``, or with
    ``soft_code`` (temp, stochastic) its ``get_soft_code``, each run through
    ``core.captured`` (the JAX package's separately jitted encoders), fp32
    and ``eval()``."""

    def __init__(self, text_encoder, tokenizer, vq_model, device, cond_embed_dim=None,
                 soft_code=None):
        self.text_encoder = text_encoder.eval().requires_grad_(False)
        self.tokenizer = tokenizer
        self.vq_model = vq_model.eval().requires_grad_(False)
        self.device = device
        self.cond_embed_dim = cond_embed_dim
        self.soft_code = soft_code

    @classmethod
    def from_config(cls, config, device) -> "FrozenEncoders":
        te_cfg = config.model.get("text_encoder")
        te_type = te_cfg.get("type", "clip") if te_cfg is not None else "clip"
        if te_type not in TEXT_ENCODERS:
            raise ValueError(f"model.text_encoder.type {te_type!r}: one of "
                             f"{sorted(TEXT_ENCODERS)}")
        te_cls = TEXT_ENCODERS[te_type]
        te_path = te_cfg.get("pretrained") if te_cfg is not None else None
        if te_path and os.path.isdir(te_path):
            text_encoder = te_cls.from_pretrained(te_path, device=device)
        elif te_cfg is not None and te_cfg.get("params") is not None:
            with torch.device(device):
                text_encoder = te_cls(**te_cfg.params.to_dict())
        else:
            raise ValueError("the raw-image branch needs model.text_encoder.pretrained (a "
                             "directory) or model.text_encoder.params")
        if te_cls is T5TextEncoder and not has_tokenizer_files(te_path or ""):
            # the JAX trainer's fallback reads max_position_embeddings, which
            # T5Config lacks: it raises AttributeError (ROADMAP fault 3.11)
            raise ValueError(f"a T5 text tower needs tokenizer files beside it (at "
                             f"{te_path!r}): the JAX trainer has no length for its hash "
                             f"tokenizer fallback (ROADMAP fault 3.11)")
        cond_embed_dim = None
        if config.model.get("architecture", "uvit") == "uvit":
            cond_embed_dim = MaskGiTUViT_v2.config_from_dict(
                config.model.transformer.to_dict()).cond_embed_dim
        soft_code = None
        if config.training.get("use_soft_code_target", False):
            soft_code = (float(config.training.get("soft_code_temp", 1.0)),
                         bool(config.training.get("use_stochastic_code", False)))
        return cls(text_encoder, load_tokenizer(te_path or "", text_encoder),
                   load_vq_model(config, device), device, cond_embed_dim, soft_code)

    @torch.no_grad()
    def _text(self, ids):
        hidden_states, _, pooled = self.text_encoder(ids)
        if pooled is None and self.cond_embed_dim is not None:
            pooled = hidden_states[-1].new_zeros(ids.shape[0], self.cond_embed_dim)
        return hidden_states[-2] if len(hidden_states) >= 2 else hidden_states[-1], pooled

    def encode_text(self, texts):
        """(text states (B, T, D), pooled (B, P) or None) fp32: CLIP's
        penultimate hidden state, T5's last."""
        ids = self.tokenizer(texts, padding="max_length", truncation=True,
                             max_length=self.tokenizer.model_max_length,
                             return_tensors="np")["input_ids"]
        return captured(self.text_encoder, ("encode",), self._text,
                        to_device(np.asarray(ids, np.int64), self.device),
                        modules=(self.text_encoder,))

    def get_code(self, pixels):
        return get_code(self.vq_model, pixels)

    def get_soft_code(self, pixels, generator=None):
        """(soft codes (B, N, K) fp32, codes (B, N)) at ``self.soft_code``'s
        temperature: the latents, then the soft code, each one replayed
        CUDA graph on the card; stochastic codes take Gumbel noise drawn
        from ``generator`` between the two, an input of the second."""
        temp, stochastic = self.soft_code
        vq = self.vq_model
        latents = captured(vq, ("latents",), torch.no_grad()(vq._latents), pixels,
                           modules=(vq,))
        quantizer = getattr(vq, vq._quantizer_name)
        noise = ()
        if stochastic:
            noise = (gumbel_noise((latents[..., 0].numel(), quantizer.weight.shape[0]),
                                  generator),)
        return captured(vq, ("soft_code", temp, stochastic),
                        torch.no_grad()(lambda z, *g: quantizer.get_soft_code(z, temp, stochastic,
                                                                              *g)),
                        latents, *noise, modules=(vq,))

    def empty_embeds(self) -> dict:
        """The empty prompt's embeddings, the CFG cond-dropout replacement."""
        ehs, pooled = self.encode_text([""])
        return {"empty_embeds": ehs, "empty_cond_embeds": pooled}

    def prepare_batch(self, batch, generator=None) -> dict:
        """A collated raw batch (``Text2ImageDataset``) -> the train step's
        tensors: the image tokens, the text states and the micro-conds, and
        with ``soft_code`` the soft targets (the tokens then the soft code's
        codes, as in JAX; stochastic ones drawn from ``generator``)."""
        pixels = to_device(batch["pixel_values"], self.device)
        out = {}
        if self.soft_code is None:
            tokens = self.get_code(pixels)
        else:
            out["soft_targets"], tokens = self.get_soft_code(pixels, generator)
        ehs, pooled = self.encode_text(batch["input_text"])
        return {**out, "image_tokens": tokens.long(), "encoder_hidden_states": ehs,
                "cond_embeds": pooled,
                "micro_conds": to_device(micro_conds(batch, len(tokens)), self.device)}


ARCHITECTURES = {"uvit": MaskGiTUViT_v2, "transformer": MaskGitTransformer}


def build_state(config, device, world_size: int = 1, mesh=None) -> T.TrainState:
    """Model (``model.architecture``), optimizer (with the lr schedule and
    gradient accumulation) and EMA from ``config``.  The v1 model takes no
    ``gradient_checkpointing``: the JAX package builds it without remat.
    ``scale_lr`` multiplies the lr by the global batch and the world size,
    as the JAX trainer does.  On a ``mesh`` with fsdp or tp > 1 the model
    is sharded before the optimizer sees it (``shard_model``)."""
    tcfg = config.model.transformer.to_dict()
    architecture = config.model.get("architecture", "uvit")
    if architecture not in ARCHITECTURES:
        raise ValueError(f"model.architecture {architecture!r}: one of {sorted(ARCHITECTURES)}")
    model_cls = ARCHITECTURES[architecture]
    with torch.device(device):
        model = model_cls(model_cls.config_from_dict(tcfg))
    if model_cls is MaskGiTUViT_v2:
        model.set_gradient_checkpointing(config.model.get("gradient_checkpointing", False))
    shard_model(model, mesh)
    opt_cfg = config.optimizer.params
    lr = float(opt_cfg.learning_rate)  # yaml reads 1e-4 as a string
    if opt_cfg.get("scale_lr", False):
        lr = lr * config.training.batch_size * world_size
    schedule = get_scheduler(
        config.lr_scheduler.scheduler, base_lr=lr,
        num_warmup_steps=config.lr_scheduler.params.get("warmup_steps", 500),
        num_training_steps=config.training.get("max_train_steps", 1000000))
    # yaml reads 1e-8 (research_run_512.yaml's epsilon) as a string too
    optimizer = get_optimizer(
        config.optimizer.get("name", "adamw"), model, schedule,
        beta1=float(opt_cfg.get("beta1", 0.9)), beta2=float(opt_cfg.get("beta2", 0.999)),
        weight_decay=float(opt_cfg.get("weight_decay", 0.01)),
        epsilon=float(opt_cfg.get("epsilon", 1e-8)),
        max_grad_norm=config.training.get("max_grad_norm"),
        accumulation_steps=config.training.get("gradient_accumulation_steps", 1))
    ema = EMA(model) if config.training.get("use_ema", False) else None
    return T.TrainState(model=model, optimizer=optimizer, ema=ema)


def shard_model(model, mesh) -> None:
    """With fsdp or tp > 1 on ``mesh``: the model's parameters sharded by the
    partition rules (``shard_params``): tp splits the weights over the tp
    ranks (DTensors), fsdp shards them with FSDP2 on top, so that its steps'
    gradients are averaged over dp alone (``data_parallel(mesh,
    fsdp_applied=True)``) and the step runs eagerly (``TrainStep``).
    Nothing otherwise."""
    fsdp, tp = (1, 1) if mesh is None else (mesh.size(MeshAxes.index(a)) for a in ("fsdp", "tp"))
    if fsdp * tp == 1:
        return
    shard_params(model, mesh)
    logger.info("fsdp=%d, tp=%d: the model's parameters are DTensor shards", fsdp, tp)


def _loggable(value):
    value = value.float().cpu()
    return value.tolist() if value.dim() else float(value)


class SamplePanel:
    """``generate_every``: ``generate(model, batch, generator)`` -> token ids
    from the EMA weights (else the model's), copied into one sample model in
    the trunk's compute type (so its captured decode replays), then
    ``decode_code`` -> ``samples-{step}.png``; the generator is the CPU one
    of ``seed + step``.  Every rank calls it: the weights of an
    FSDP2-sharded model are gathered from every rank (a collective), and
    rank 0 (``is_main``) alone samples and writes; it returns whether it
    did."""

    def __init__(self, state, vq_model, dtype, seed: int, generate: Callable,
                 is_main: bool = True):
        self.state, self.vq_model, self.generate = state, vq_model, generate
        self.dtype, self.seed, self.is_main = dtype, seed, is_main
        self.model = None

    @torch.no_grad()
    def __call__(self, batch, step: int, path: str) -> bool:
        source = self.state.model
        weights = self.state.ema.shadow if self.state.ema is not None else source.state_dict()
        if T.is_sharded(source):
            weights = T.full_tensors(weights)
        if not self.is_main:
            return False
        if self.model is None:
            with torch.device(next(source.parameters()).device):
                self.model = T.model_class(source)(source.config).to(self.dtype).eval()
        self.model.load_state_dict(weights)
        tokens = self.generate(self.model, batch, torch.Generator().manual_seed(self.seed + step))
        save_image_grid(self.vq_model.decode_code(tokens).float().cpu().numpy(), path)
        return True


def uvit_panel(empty) -> Callable:
    """4 samples of the batch's prompts: v2 ``generate2``, 12 steps, CFG 8
    against the empty prompt."""
    def generate(model, batch, generator):
        n = min(4, len(batch["image_tokens"]))
        return model.generate2(
            batch["encoder_hidden_states"][:n], batch["cond_embeds"][:n],
            batch["micro_conds"][:n], empty_embeds=empty["empty_embeds"],
            empty_cond_embeds=empty["empty_cond_embeds"], timesteps=12, guidance_scale=8.0,
            generator=generator, seq_len=batch["image_tokens"].shape[1])
    return generate


def v1_text_panel(model, batch, generator):
    """4 samples of the batch's prompts: v1 ``generate2``, 12 steps, CFG 8
    against zero text states (the JAX trainer passes no negative embeds)."""
    n = min(4, len(batch["image_tokens"]))
    return model.generate2(encoder_hidden_states=batch["encoder_hidden_states"][:n],
                           timesteps=12, guidance_scale=8.0, generator=generator)


def load_inpainting_validation_data(directory: str, image_size: int, latent_side: int):
    """Folders of an image and a mask, the folder's name the prompt
    (underscores as spaces): [{"prompt", "image" (R, R, 3) float in [0, 1],
    "mask" (latent_side, latent_side) bool, True where repainted}], sorted
    by folder."""
    from PIL import Image

    entries = []
    for prompt_dir in sorted(os.listdir(directory)):
        full = os.path.join(directory, prompt_dir)
        if not os.path.isdir(full):
            continue
        files = os.listdir(full)
        img_file = next((f for f in files if "mask" not in f.lower()
                         and f.lower().endswith((".png", ".jpg", ".jpeg"))), None)
        mask_file = next((f for f in files if "mask" in f.lower()), None)
        if not img_file or not mask_file:
            continue
        image = Image.open(os.path.join(full, img_file)).convert("RGB") \
            .resize((image_size, image_size))
        mask = Image.open(os.path.join(full, mask_file)).convert("L") \
            .resize((latent_side, latent_side))
        entries.append({"prompt": prompt_dir.replace("_", " "),
                        "image": np.asarray(image, dtype=np.float32) / 255.0,
                        "mask": np.asarray(mask) > 127})
    return entries


@torch.no_grad()
def generate_inpainting_images(model, vq_model, entries, encode_text, mask_id: int,
                               micro_conds, empty_embeds, empty_cond_embeds, out_path,
                               noise_for: Callable[[int], dict]):
    """The inpainting panel: each entry's image encoded (``get_code``, one
    replayed CUDA graph on the card), its masked tokens set to ``mask_id``,
    then ``generate2`` from them (8 steps, CFG 8 against the empty prompt;
    ``noise_for(i)``: the entry's ``generator=`` or ``noise=``) and
    ``decode_code``; the images as one grid at ``out_path`` (None: none
    written).  Returns each entry's generated token ids (1, N)."""
    device = next(model.parameters()).device
    panels, generated = [], []
    for i, entry in enumerate(entries):
        pixels = torch.from_numpy(entry["image"])[None].to(device)
        mask = torch.from_numpy(entry["mask"].reshape(1, -1)).to(device)
        tokens = torch.where(mask, mask_id, get_code(vq_model, pixels).long())
        ehs, pooled = encode_text([entry["prompt"]])
        ids = model.generate2(ehs, pooled, micro_conds, empty_embeds=empty_embeds,
                              empty_cond_embeds=empty_cond_embeds, input_ids=tokens,
                              timesteps=8, guidance_scale=8.0, seq_len=tokens.shape[1],
                              **noise_for(i))
        generated.append(ids)
        panels.append(vq_model.decode_code(ids)[0].float().cpu().numpy())
    if panels and out_path is not None:
        save_image_grid(np.stack(panels), out_path)
    return generated


def log_step(tracker, train_step, capture, metrics, state, batch_size: int, end: float,
             batch_time: AverageMeter, data_time: AverageMeter) -> dict:
    """One metrics line: the step's metrics (a device read, so it waits for
    the step; ``param_grad_norms`` have lines of their own), the lr, the
    samples/s and step / data / batch times, and ``capture_s`` when this
    step warmed up and captured a graph (``train_step.last_capture`` is not
    ``capture``, the one before it)."""
    values = {k: _loggable(v) for k, v in metrics.items() if k != "param_grad_norms"}
    batch_time.update(time.time() - end)
    values.update({"lr": state.optimizer.schedule(state.step),
                   "samples/sec": batch_size / max(batch_time.avg, 1e-9),
                   "step_time": batch_time.val, "data_time": data_time.avg,
                   "batch_time": batch_time.avg})
    if train_step.last_capture is not capture:
        values["capture_s"] = train_step.last_capture["seconds"]
    tracker.log(values, state.step)
    logger.info("step %d: loss=%.4f (%.1f samples/s)", state.step, values["loss"],
                values["samples/sec"])
    return values


def resume(config, state, output_dir: str) -> None:
    """``experiment.resume_from_checkpoint``: a path, or ``latest`` in
    ``output_dir``; nothing when there is no checkpoint yet."""
    wanted = config.experiment.get("resume_from_checkpoint")
    if wanted:
        path = T.find_latest_checkpoint(output_dir) if wanted == "latest" else wanted
        if path:
            T.load_checkpoint(path, state)
            logger.info("resumed from %s at step %d", path, state.step)


def main(argv=None) -> T.TrainState:
    """Train from ``argv`` (``config=path.yaml`` and ``a.b=value``
    overrides) on the override ``device=``, else ``cuda``; under a launcher,
    as one rank of the job."""
    config = load_config(argv if argv is not None else sys.argv[1:])
    device = resolve_device(config.get("device", "cuda"))
    batch_size = config.training.batch_size
    mesh = init_training(device, batch_size, config.training.get("fsdp", 1),
                         config.training.get("tp", 1))
    mlog.set_verbosity_for_process()
    rank, world = rank_and_world()
    share = batch_share(mesh)  # the ranks of one tp group take the same rows
    rows = local_batch_slice(batch_size, *share)
    is_main = rank == 0
    if mesh is not None:
        logger.info("rank %d of %d: rows %d - %d of the global batch %d", rank, world,
                    rows.start, rows.stop, batch_size)
    seed = config.training.get("seed", 42)
    set_seed(seed)
    if device.type == "cuda":
        # the frozen fp32 encoders as serving runs them; the trunk is bf16
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    output_dir = config.experiment.output_dir
    os.makedirs(output_dir, exist_ok=True)
    if is_main:
        with open(os.path.join(output_dir, "config.yaml"), "w") as f:
            import yaml

            yaml.safe_dump(config.to_dict(), f)
    tracker = MetricsTracker(output_dir) if is_main else None

    pre_encode = config.training.get("pre_encode", False)
    use_soft_targets = bool(config.training.get("use_soft_code_target", False))
    if use_soft_targets and pre_encode:
        # the JAX trainer's pre-encoded batches carry no soft_targets: its
        # step fails on the missing key
        raise ValueError("training.use_soft_code_target needs the raw-image branch (the VQ "
                         "model's get_soft_code); pre-encoded shards carry no soft targets")
    encoders = None if pre_encode else FrozenEncoders.from_config(config, device)
    state = build_state(config, device, world, mesh)
    model = state.model
    dp = data_parallel(mesh, fsdp_applied=T.is_fsdp(model))
    is_v1 = isinstance(model, MaskGitTransformer)
    logger.info("transformer params: %.1fM", sum(p.numel() for p in model.parameters()) / 1e6)
    autocast_dtype = torch.bfloat16 if config.training.get("mixed_precision") == "bf16" else None
    mask_id, codebook_size = model.config.mask_token_id, model.config.codebook_size
    mask_schedule = get_mask_schedule(config.training.get("mask_schedule", "cosine"))
    label_smoothing = config.training.get("label_smoothing", 0.0)
    min_masking_rate = config.training.get("min_masking_rate", 0.0)
    cond_dropout_prob = config.training.get("cond_dropout_prob", 0.0)
    log_grad_norm_every = config.experiment.get("log_grad_norm_every")
    eval_ratios = tuple(config.training.get("eval_mask_ratios", (0.1, 0.3, 0.5, 0.7, 0.9)))
    if is_v1:
        dropout = None
        if model.config.hidden_dropout > 0.0:
            dropout = KeepMasks(torch.Generator(device).manual_seed(seed + 1), dp.share)
        train_step = T.make_v1_text2image_train_step(
            mask_schedule, mask_id, codebook_size=codebook_size,
            min_masking_rate=min_masking_rate, label_smoothing=label_smoothing,
            cond_dropout_prob=cond_dropout_prob, autocast_dtype=autocast_dtype, dropout=dropout,
            data_parallel=dp)
        eval_step = None  # the JAX trainer has no v1 eval step
    else:
        train_step = T.make_uvit_train_step(
            mask_schedule, mask_id, codebook_size=codebook_size,
            min_masking_rate=min_masking_rate,
            noise_type=config.training.get("noise_type", "mask"),
            predict_all_tokens=config.training.get("predict_all_tokens", False),
            mask_contiguous_region_prob=config.training.get("mask_contiguous_region_prob"),
            label_smoothing=label_smoothing, cond_dropout_prob=cond_dropout_prob,
            autocast_dtype=autocast_dtype,
            with_diagnostics=bool(config.experiment.get("log_entropy_buckets", False)),
            with_param_grad_norms=bool(log_grad_norm_every), use_soft_targets=use_soft_targets,
            data_parallel=dp)
        eval_step = T.make_uvit_eval_step(mask_schedule, mask_id, eval_mask_ratios=eval_ratios,
                                          label_smoothing=label_smoothing,
                                          autocast_dtype=autocast_dtype, data_parallel=dp)
    grad_norm_names = T.grad_norm_param_names(model)
    resume(config, state, output_dir)

    # v2: the pre-encode branch has no text tower, hence no empty-prompt
    # embeddings, so CFG cond dropout does not run there, as in the JAX
    # trainer; v1 drops the text by a mask and runs it in both branches
    empty = None if encoders is None or is_v1 else encoders.empty_embeds()
    cond_dropout = cond_dropout_prob > 0.0 and (is_v1 or empty is not None)

    def prepare(raw, generator):
        if encoders is None:
            return prepare_batch(raw, config, None if is_v1 else model.config.cond_embed_dim,
                                 device)
        batch = encoders.prepare_batch(raw, generator)
        if is_v1:  # v1 conditions through cross-attention alone (no soft targets either)
            return {k: batch[k] for k in ("image_tokens", "encoder_hidden_states")}
        return {**batch, **empty}

    ds_params = config.dataset.params
    select = None
    if config.dataset.get("quality_filter"):
        select = WebdatasetSelect(**config.dataset.quality_filter.to_dict())
    local_batch = rows.stop - rows.start
    resolution = ds_params.get("resolution", 256)
    preprocessing = config.dataset.get("preprocessing") or {}

    def dataset(urls, center_crop: bool, **kw):
        kw.update(process_index=share[0], process_count=share[1])
        if pre_encode:
            return PreEncodedDataset(
                urls, local_batch, vae_checkpoint=ds_params.get("vae_checkpoint"),
                text_encoder_checkpoint=ds_params.get("text_encoder_checkpoint"), **kw)
        return Text2ImageDataset(urls, local_batch, resolution=resolution,
                                 center_crop=center_crop,
                                 dataset_map=ds_params.get("dataset_map"), **kw)

    train_data = dataset(ds_params.train_shards_path_or_url,
                         bool(preprocessing.get("center_crop", False)),
                         shuffle_buffer_size=ds_params.get("shuffle_buffer_size", 1000),
                         select=select, seed=seed)
    eval_shards = ds_params.get("eval_shards_path_or_url")
    eval_data = None
    if eval_shards:
        eval_data = dataset(eval_shards, True, shuffle_buffer_size=64, resample=False,
                            seed=seed + 7)
    generator = torch.Generator(device).manual_seed(seed)
    panel = None if encoders is None else SamplePanel(
        state, encoders.vq_model, autocast_dtype or torch.float32, seed,
        v1_text_panel if is_v1 else uvit_panel(empty), is_main)
    inpaint_dir = config.experiment.get("inpainting_validation_dir")
    inpaint_entries = None  # read at the first panel, at the batch's token grid

    max_steps = config.training.max_train_steps
    log_every = config.experiment.get("log_every", 50)
    save_every = config.experiment.get("save_every", 1000)
    eval_every = config.experiment.get("eval_every")
    generate_every = config.experiment.get("generate_every", 1000)
    profile_steps = config.experiment.get("profile_steps")
    overfit = config.training.get("overfit_one_batch", False)
    batch_time, data_time = AverageMeter(), AverageMeter()
    data_iter = iter(train_data)
    cached = None
    profiler = None
    end = time.time()
    while state.step < max_steps:
        if not (overfit and cached is not None):
            cached = next(data_iter)
        data_time.update(time.time() - end)
        if profile_steps and state.step + 1 == int(profile_steps[0]):
            from torch.profiler import ProfilerActivity, profile

            profiler = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else []))
            profiler.start()
        batch = prepare(cached, generator)
        noise = draw_masking_noise(batch_size, batch["image_tokens"].shape[1], generator,
                                   codebook_size, cond_dropout=cond_dropout).rows(rows)
        capture = train_step.last_capture
        metrics = train_step(state, batch, noise)
        step = state.step
        if profiler is not None and step == int(profile_steps[1]):
            if device.type == "cuda":
                torch.cuda.synchronize()
            profiler.stop()
            os.makedirs(os.path.join(output_dir, "profile"), exist_ok=True)
            if is_main:
                profiler.export_chrome_trace(os.path.join(output_dir, "profile", "trace.json"))
            profiler = None
            logger.info("wrote the profiler trace to %s/profile", output_dir)
        if step % log_every == 0 and is_main:
            log_step(tracker, train_step, capture, metrics, state, batch_size, end, batch_time,
                     data_time)
        if log_grad_norm_every and step % log_grad_norm_every == 0 and is_main and \
                "param_grad_norms" in metrics:
            norms = metrics["param_grad_norms"].float().cpu().tolist()
            tracker.log({f"grad_norm/{n}": v for n, v in zip(grad_norm_names, norms)}, step)
        if eval_every and eval_step is not None and eval_data is not None and \
                step % eval_every == 0:
            eval_gen = torch.Generator(device).manual_seed(seed + 999 + step)
            # the ranks agree on a common count before the eval's collectives,
            # since uneven eval shards would leave some ranks waiting
            buffered = []
            for raw in eval_data:
                if len(buffered) >= config.experiment.get("max_eval_batches", 8):
                    break
                buffered.append(raw)
            losses = []
            for raw in buffered[:all_reduce_min(len(buffered), device)]:
                eb = prepare(raw, eval_gen)
                eval_noise = draw_masking_noise(batch_size, eb["image_tokens"].shape[1],
                                                eval_gen, codebook_size,
                                                len(eval_ratios)).rows(rows)
                losses.append(float(eval_step(model, eb, eval_noise)))
            if losses and is_main:
                tracker.log({"eval_loss": float(np.mean(losses))}, step)
                logger.info("step %d: eval_loss=%.4f", step, np.mean(losses))
        if panel is not None and generate_every and step % generate_every == 0:
            sampled = panel(batch, step, os.path.join(output_dir, f"samples-{step}.png"))
            if sampled and inpaint_dir and not is_v1:
                if inpaint_entries is None:
                    inpaint_entries = load_inpainting_validation_data(
                        inpaint_dir, resolution, int(batch["image_tokens"].shape[1] ** 0.5))
                generate_inpainting_images(
                    panel.model, encoders.vq_model, inpaint_entries, encoders.encode_text,
                    mask_id, batch["micro_conds"][:1], empty["empty_embeds"],
                    empty["empty_cond_embeds"],
                    os.path.join(output_dir, f"inpainting-{step}.png"),
                    lambda i: {"generator": torch.Generator().manual_seed(seed + 1000 * step + i)})
        if step % save_every == 0:
            save(output_dir, state, is_main,
                 checkpoints_total_limit=config.experiment.get("checkpoints_total_limit"))
        end = time.time()
    barrier()  # every rank looks before any writes the last checkpoint
    if not os.path.isdir(os.path.join(output_dir, f"checkpoint-{state.step}")):
        save(output_dir, state, is_main)
    logger.info("training done at step %d", state.step)
    return state


def save(output_dir: str, state, is_main: bool, **kwargs) -> None:
    """``save_checkpoint`` on every rank (rank 0 writes the checkpoint; an
    FSDP2-sharded state is gathered first and each rank writes its optimizer
    shard), then a barrier."""
    T.save_checkpoint(output_dir, state, is_main=is_main, **kwargs)
    barrier()


if __name__ == "__main__":
    main()
