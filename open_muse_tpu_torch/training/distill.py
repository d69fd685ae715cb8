"""Step and guidance distillation of MaskGiTUViT_v2's MaskGIT decode.

Counterpart of ``open_muse_tpu/training/distill.py``.  A student learns to
predict, from the teacher's carry-in state at step ``t`` of a
``teacher_timesteps`` CFG decode, the tokens the teacher commits over the
next ``step_ratio`` steps, with a condition-only forward: served at
``teacher_timesteps // step_ratio`` steps and no CFG
(``distilled_generate``), it folds both the steps and the guidance into its
weights.  No images are read: the teacher makes its own targets from
prompts.

One step (``make_distill_step``: ``TrainStep`` around
``distill_train_body``, one replayed CUDA graph on the card) holds, in
order: the teacher's CFG decode of ``teacher_timesteps`` under no grad
(``parallel_decode_loop(return_trajectory=True)``), the per-example pair
``(states[t_in], sampled[t_in + step_ratio - 1])`` at ``t_in = pair *
step_ratio``, with ``soft_weight > 0`` the teacher's forward at the pair's
state and its CFG mix at ``guidance_scales[t_in]`` (the soft target), the
student's forward and backward (CE at the still-masked positions plus
``soft_weight`` KL(teacher || student) there), the clip ``min(1,
max_grad_norm / (norm + 1e-6))`` (the JAX step's own, not the optimizer's),
the optimizer's update and the EMA.

The teacher is a frozen copy with storage of its own (self-distillation:
never the student's parameters), held in the step's autocast dtype.  All
noise is an input drawn before each replay (``draw_distill_noise``): the
mask Gumbel (T, B, S), the sampler's Philox seeds (T,) on the card or its
Gumbel noise (T, B, S, codebook) on the CPU, and the pair index (B,).
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import os
import sys
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.modeling import resolve_device
from ..models.clip_text import CLIPTextEncoder, SimpleTokenizer
from ..models.transformer_v2 import (MaskGiTUViT_v2, decode_noise, decode_schedules,
                                     parallel_decode_loop)
from ..ops import sampling
from ..scripts.pre_encode import load_tokenizer, to_device
from ..utils.config import load_config
from ..utils.training_utils import set_seed
from . import trainer as T
from .ema import EMA
from .lr_schedules import get_scheduler
from .optimizers import get_optimizer
from .train_muse import MetricsTracker

__all__ = ["DistillNoise", "DistillSpec", "draw_distill_noise", "teacher_targets",
           "distill_train_body", "make_distill_step", "distilled_generate", "main"]

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class DistillNoise:
    """One distill step's noise: ``mask_gumbel`` (T, B, S) fp32, the
    sampler's ``seeds`` (T,) int64 or ``sample_gumbel`` (T, B, S, >=
    codebook) fp32, and ``pair`` (B,) int64 in [0, T / step_ratio)."""

    mask_gumbel: torch.Tensor
    pair: torch.Tensor
    seeds: Optional[torch.Tensor] = None
    sample_gumbel: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class DistillSpec:
    """What a distill step closes over (a captured step's graph bakes it
    in): the frozen teacher, the decode's static schedules and the loss."""

    teacher: torch.nn.Module
    mask_token_id: int
    codebook_size: int
    teacher_timesteps: int
    step_ratio: int
    schedules: Tuple[Tuple[float, ...], ...]  # temperatures, guidance scales, mask ratios
    use_cfg: bool
    seq_len: int
    label_smoothing: float = 0.0
    max_grad_norm: Optional[float] = None
    soft_weight: float = 0.0
    autocast_dtype: Optional[torch.dtype] = None

    def step_inputs(self, step: int, device) -> Dict[str, torch.Tensor]:
        """The decode's schedules (3, T) as a device input: temperatures,
        guidance scales, mask ratios."""
        return {"schedules": torch.tensor(self.schedules, dtype=torch.float32).to(device)}


def draw_distill_noise(generator: torch.Generator, *, timesteps: int, step_ratio: int,
                       batch: int, seq_len: int, codebook_size: int, device) -> DistillNoise:
    """A step's noise on ``device`` from the CPU ``generator``: the
    decode's (``decode_noise``: Philox seeds for the card, Gumbel noise for
    the CPU), then the pair index."""
    kind, sample, mask = decode_noise(generator, timesteps=timesteps, batch=batch,
                                      seq_len=seq_len, vocab=codebook_size, device=device)
    pair = torch.randint(0, timesteps // step_ratio, (batch,), generator=generator).to(device)
    return DistillNoise(mask_gumbel=mask, pair=pair, **{kind: sample})


def _teacher_conditioning(spec: DistillSpec, batch):
    """The teacher's (text states, pooled, micro-conds): the empty prompt's
    appended under CFG, in the teacher's dtype."""
    ehs, cond, micro = batch["encoder_hidden_states"], batch["cond_embeds"], batch["micro_conds"]
    if spec.use_cfg:
        ehs = torch.cat([ehs, batch["empty_embeds"].to(ehs.dtype).expand(ehs.shape)])
        cond = torch.cat([cond, batch["empty_cond_embeds"].to(cond.dtype).expand(cond.shape)])
        micro = torch.cat([micro, micro])
    dtype = next(spec.teacher.parameters()).dtype
    return ehs.to(dtype), cond.to(dtype), micro


@torch.no_grad()
def teacher_targets(spec: DistillSpec, batch, noise: DistillNoise):
    """The teacher's half of a step -> (state_in (B, S), target (B, S), soft
    logits (B, S, codebook) fp32 or None, t_in (B,)): its decode's
    trajectory, each example's pair and, with ``soft_weight``, its guided
    distribution at the pair's state."""
    teacher = spec.teacher
    ehs, cond, micro = _teacher_conditioning(spec, batch)
    schedules = batch["schedules"]
    bsz = batch["encoder_hidden_states"].shape[0]
    ids = torch.full((bsz, spec.seq_len), spec.mask_token_id, dtype=torch.long, device=ehs.device)
    _, states, sampled = parallel_decode_loop(
        teacher, ids, ehs, cond, micro, schedules[0],
        spec.schedules[1] if spec.use_cfg else None, schedules[2], use_cfg=spec.use_cfg,
        seq_len=spec.seq_len, timesteps=spec.teacher_timesteps, mask_gumbel=noise.mask_gumbel,
        seeds=noise.seeds, sample_gumbel=noise.sample_gumbel, return_trajectory=True)
    t_in = noise.pair * spec.step_ratio
    rows = torch.arange(bsz, device=t_in.device)
    state_in, target = states[t_in, rows], sampled[t_in + spec.step_ratio - 1, rows]
    soft = None
    if spec.soft_weight > 0.0:
        t_input = torch.cat([state_in, state_in]) if spec.use_cfg else state_in
        soft = teacher(t_input, ehs, cond, micro)[..., :spec.codebook_size].float()
        if spec.use_cfg:
            c_logits, u_logits = soft.chunk(2)
            scale = schedules[1][t_in][:, None, None]
            soft = u_logits + scale * (c_logits - u_logits)
    return state_in, target, soft, t_in


def _soft_kl(logits, soft, masked):
    """KL(teacher || student) over the codebook, averaged over the masked
    positions (at least one)."""
    logp_s = F.log_softmax(logits[..., :soft.shape[-1]].float(), dim=-1)
    kl = (F.softmax(soft, dim=-1) * (F.log_softmax(soft, dim=-1) - logp_s)).sum(-1)
    mask = masked.float()
    return (kl * mask).sum() / mask.sum().clamp_min(1.0)


def distill_train_body(state: T.TrainState, spec: DistillSpec, batch: Dict[str, torch.Tensor],
                       noise: DistillNoise, emit: bool = True) -> Dict[str, torch.Tensor]:
    """One distill step's device work, with no host reads (what a graph
    holds): ``teacher_targets``, the student's condition-only forward with
    CE at the still-masked positions (labels: the teacher's committed ids)
    plus ``soft_weight`` x the KL, the backward, the global grad norm, the
    clip, the optimizer's update and the EMA.  batch: encoder_hidden_states
    (B, L, E), cond_embeds (B, C), micro_conds (B, 5), schedules (3, T) and,
    under CFG, empty_embeds (1, L, E) and empty_cond_embeds (1, C).
    Metrics: loss, grad_norm (before the clip), avg_masked_frac,
    avg_pair_step and, with ``soft_weight``, soft_kl."""
    state_in, target, soft, t_in = teacher_targets(spec, batch, noise)
    masked = state_in == spec.mask_token_id
    labels = torch.where(masked, target, -100)
    with T.autocast(spec, state_in.device):
        logits, loss = state.model(state_in, batch["encoder_hidden_states"],
                                   batch["cond_embeds"], batch["micro_conds"], labels=labels,
                                   label_smoothing=spec.label_smoothing)
    metrics = {"avg_masked_frac": masked.float().mean(), "avg_pair_step": t_in.float().mean()}
    if soft is not None:
        soft_kl = _soft_kl(logits, soft, masked)
        loss = loss + spec.soft_weight * soft_kl
        metrics["soft_kl"] = soft_kl.detach()
    grads, grad_norm = T.backward(state, loss)
    if spec.max_grad_norm is not None:
        torch._foreach_mul_(grads, torch.clamp(spec.max_grad_norm / (grad_norm + 1e-6), max=1.0))
    state.optimizer.update(grad_norm, emit)
    if state.ema is not None:
        state.ema.update(state.model)
    return {"loss": loss.detach(), "grad_norm": grad_norm, **metrics}


def make_distill_step(teacher: torch.nn.Module, *, mask_token_id: int,
                      teacher_timesteps: int = 12, step_ratio: int = 2, temperature: Any = 1.0,
                      guidance_scale: float = 0.0, guidance_schedule: Optional[str] = None,
                      noise_schedule=sampling.cosine_schedule, seq_len: int = 256,
                      label_smoothing: float = 0.0, max_grad_norm: Optional[float] = None,
                      soft_weight: float = 0.0,
                      autocast_dtype: Optional[torch.dtype] = None) -> T.TrainStep:
    """``step(state, batch, noise) -> metrics`` (``TrainStep`` around
    ``distill_train_body``).  ``teacher`` is the frozen model whose decode
    makes the targets; the state's model is the student, with its optimizer
    (built without ``max_grad_norm``: the step clips) and EMA.  The decode's
    schedules are ``decode_schedules``', shared with ``generate2``, so the
    student's K-step mask ratios are the teacher's at every
    ``step_ratio``-th step."""
    if teacher_timesteps % step_ratio:
        raise ValueError(f"teacher_timesteps ({teacher_timesteps}) must be a multiple of "
                         f"step_ratio ({step_ratio})")
    schedules = decode_schedules(teacher_timesteps, temperature, guidance_scale,
                                 guidance_schedule, noise_schedule)
    cfg = teacher.config
    return T.TrainStep(distill_train_body, DistillSpec(
        teacher, mask_token_id, cfg.codebook_size, teacher_timesteps, step_ratio,
        tuple(tuple(s.tolist()) for s in schedules), guidance_scale > 0, seq_len,
        label_smoothing, max_grad_norm, soft_weight, autocast_dtype))


def frozen_teacher(model: torch.nn.Module, dtype: Optional[torch.dtype] = None):
    """A frozen copy of ``model`` with storage of its own, in ``dtype``."""
    teacher = copy.deepcopy(model).eval().requires_grad_(False)
    return teacher.to(dtype) if dtype is not None else teacher


def distilled_generate(model, encoder_hidden_states, cond_embeds, micro_conds, *,
                       teacher_timesteps: int = 12, step_ratio: int = 2,
                       temperature: Any = 1.0, seq_len: int = 256, **kwargs):
    """Decode with a distilled student: ``teacher_timesteps // step_ratio``
    steps and no CFG, through ``generate2`` (one replayed CUDA graph on the
    card)."""
    return model.generate2(encoder_hidden_states, cond_embeds, micro_conds,
                           timesteps=teacher_timesteps // step_ratio, guidance_scale=0.0,
                           temperature=temperature, seq_len=seq_len, **kwargs)


@torch.no_grad()
def encode_prompts(text_encoder, tokenizer, prompts, device, chunk: int = 256):
    """(text states (N, T, D), pooled (N, P)) fp32 of every prompt, ``chunk``
    at a time: the penultimate hidden state and the pooled output (CLIP)."""
    ehs, pooled = [], []
    for start in range(0, len(prompts), chunk):
        ids = tokenizer(prompts[start:start + chunk], padding="max_length", truncation=True,
                        max_length=tokenizer.model_max_length, return_tensors="np")["input_ids"]
        hidden_states, _, out = text_encoder(to_device(np.asarray(ids, np.int64), device))
        ehs.append(hidden_states[-2] if len(hidden_states) >= 2 else hidden_states[-1])
        pooled.append(out)
    return torch.cat(ehs).float(), torch.cat(pooled).float()


def _text_tower(config, device):
    """``model.text_encoder``: a ``pretrained`` directory (its tokenizer
    files, else the hash tokenizer at the tower's sizes) or ``params``."""
    te_cfg = config.model.text_encoder
    path = te_cfg.get("pretrained")
    if path and os.path.isdir(path):
        text_encoder = CLIPTextEncoder.from_pretrained(path, device=device)
        tokenizer = load_tokenizer(path, text_encoder)
        if isinstance(tokenizer, SimpleTokenizer):
            logger.warning("no tokenizer files at %s: prompts hash-tokenized (SimpleTokenizer)",
                           path)
    elif te_cfg.get("params") is not None:
        with torch.device(device):
            text_encoder = CLIPTextEncoder(**te_cfg.params.to_dict())
        tokenizer = SimpleTokenizer(text_encoder.config.vocab_size,
                                    text_encoder.config.max_position_embeddings)
    else:
        raise ValueError("model.text_encoder needs pretrained (a directory) or params")
    return text_encoder.float().eval().requires_grad_(False), tokenizer


def main(argv=None) -> T.TrainState:
    """Distill from ``argv`` (``config=configs/distill.yaml`` and ``a.b=value``
    overrides) on the override ``device=``, else ``cuda``: the student is
    ``distill.teacher_checkpoint`` (a ``save_pretrained`` directory) and the
    teacher a frozen copy of it; every prompt of ``distill.prompts_file``
    is encoded once; a step's prompts are drawn as the JAX trainer draws
    them (``RandomState(seed).randint``) and its noise from a generator
    seeded by the step, so a resume (``experiment.resume_from_checkpoint``)
    continues as the run would have.  ``training.mixed_precision: bf16``
    runs the student under bf16 autocast and holds the teacher in bf16."""
    config = load_config(argv if argv is not None else sys.argv[1:])
    device = resolve_device(config.get("device", "cuda"))
    seed = config.training.get("seed", 42)
    set_seed(seed)
    if device.type == "cuda":  # the fp32 text tower as serving runs it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    output_dir = config.experiment.output_dir
    os.makedirs(output_dir, exist_ok=True)
    tracker = MetricsTracker(output_dir)
    autocast_dtype = torch.bfloat16 if config.training.get("mixed_precision") == "bf16" else None

    dcfg = config.distill
    model = MaskGiTUViT_v2.from_pretrained(dcfg.teacher_checkpoint, device=device).float()
    teacher = frozen_teacher(model, autocast_dtype)
    model.train()
    logger.info("student (= teacher init) params: %.1fM",
                sum(p.numel() for p in model.parameters()) / 1e6)
    text_encoder, tokenizer = _text_tower(config, device)
    with open(dcfg.prompts_file) as f:
        prompts = [line.strip() for line in f if line.strip()]
    logger.info("%d distillation prompts from %s", len(prompts), dcfg.prompts_file)
    empty_embeds, empty_cond = encode_prompts(text_encoder, tokenizer, [""], device)
    all_ehs, all_pooled = encode_prompts(text_encoder, tokenizer, prompts, device)
    del text_encoder

    resolution = int(dcfg.get("resolution", 256))
    seq_len = int(dcfg.get("seq_len", (resolution // 16) ** 2))
    batch_size = int(config.training.batch_size)
    micro = torch.tensor([[resolution, resolution, 0, 0, 6.0]] * batch_size, device=device)
    opt_cfg = config.optimizer.params
    schedule = get_scheduler(
        config.lr_scheduler.scheduler, base_lr=float(opt_cfg.learning_rate),
        num_warmup_steps=config.lr_scheduler.params.get("warmup_steps", 100),
        num_training_steps=config.training.max_train_steps)
    optimizer = get_optimizer(
        config.optimizer.get("name", "adamw"), model, schedule,
        beta1=opt_cfg.get("beta1", 0.9), beta2=opt_cfg.get("beta2", 0.999),
        weight_decay=opt_cfg.get("weight_decay", 0.01), epsilon=opt_cfg.get("epsilon", 1e-8))
    state = T.TrainState(model=model, optimizer=optimizer,
                         ema=EMA(model) if dcfg.get("use_ema", True) else None)
    timesteps, step_ratio = int(dcfg.get("teacher_timesteps", 12)), int(dcfg.get("step_ratio", 2))
    temperature = dcfg.get("temperature", 1.0)
    distill_step = make_distill_step(
        teacher, mask_token_id=model.config.mask_token_id, teacher_timesteps=timesteps,
        step_ratio=step_ratio,
        temperature=tuple(temperature) if isinstance(temperature, list) else temperature,
        guidance_scale=float(dcfg.get("guidance_scale", 8.0)),
        guidance_schedule=dcfg.get("guidance_schedule"), seq_len=seq_len,
        label_smoothing=float(config.training.get("label_smoothing", 0.0)),
        max_grad_norm=config.training.get("max_grad_norm"),
        soft_weight=float(dcfg.get("soft_weight", 0.0)), autocast_dtype=autocast_dtype)
    wanted = config.experiment.get("resume_from_checkpoint")
    if wanted:
        path = T.find_latest_checkpoint(output_dir) if wanted == "latest" else wanted
        if path:
            T.load_checkpoint(path, state)
            logger.info("resumed from %s at step %d", path, state.step)

    max_steps = int(config.training.max_train_steps)
    save_every = int(config.experiment.get("save_every", 1000))
    log_every = int(config.experiment.get("log_every", 50))
    rs = np.random.RandomState(seed)
    for _ in range(state.step):  # the prompt draws of the steps already taken
        rs.randint(0, len(prompts), size=batch_size)
    empty = {"empty_embeds": empty_embeds, "empty_cond_embeds": empty_cond}
    t0, first = time.time(), state.step
    end = t0
    while state.step < max_steps:
        idx = torch.from_numpy(rs.randint(0, len(prompts), size=batch_size)).to(device)
        batch = {"encoder_hidden_states": all_ehs[idx], "cond_embeds": all_pooled[idx],
                 "micro_conds": micro, **empty}
        generator = torch.Generator().manual_seed(seed + 1 + state.step)
        noise = draw_distill_noise(generator, timesteps=timesteps, step_ratio=step_ratio,
                                   batch=batch_size, seq_len=seq_len,
                                   codebook_size=model.config.codebook_size, device=device)
        capture = distill_step.last_capture
        metrics = distill_step(state, batch, noise)
        step = state.step
        if step % log_every == 0:
            values = {k: float(v) for k, v in metrics.items()}  # waits for the step
            now = time.time()
            values.update(lr=optimizer.schedule(optimizer.count - 1), step_time=now - end,
                          steps_per_sec=(step - first) / max(now - t0, 1e-9))
            if distill_step.last_capture is not capture:
                values["capture_s"] = distill_step.last_capture["seconds"]
            tracker.log(values, step)
            logger.info("step %d: loss=%.4f (%.2f it/s)", step, values["loss"],
                        values["steps_per_sec"])
        if step % save_every == 0 or step == max_steps:
            T.save_checkpoint(output_dir, state)
        end = time.time()
    logger.info("distillation done at step %d", state.step)
    return state


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
