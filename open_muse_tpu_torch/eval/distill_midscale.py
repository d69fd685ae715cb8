"""The mid-scale distillation protocol, the counterpart of
``open_muse_tpu/eval/distill_midscale.py``.

Does a distilled student beat simply cutting the teacher's steps?  The
world is a 64 px canvas holding one solid square of a named colour at a
random place and size on a light background: the square's extent must be
coherent across tokens, so a MaskGIT decode that commits many tokens in
parallel in too few steps draws ragged edges and stray patches, and the
step count measurably matters.  A reduction-4 MaskGIT VQGAN gives 16 x 16 =
256 tokens; the teacher is an 8-layer, hidden-256 v2 trunk (head dim 64,
~13M parameters) trained through the port's train step.  The student is
its self-distillation (``training.distill.make_distill_step``: the
``teacher_timesteps``-step CFG decode folded into ``teacher_timesteps //
step_ratio`` CFG-free steps, soft KL and an EMA student).

Against one held-out real set, FID over a seeded CLIP tower's features
(deterministic, not published) scores teacher_full (N steps with CFG),
teacher_k (the undistilled step-cut control at K = N / ratio) and student_k
(K steps, no CFG); the protocol passes when teacher_k is worse than
student_k by more than the split-half floor (two real sets against each
other).  ``main`` runs it from the command line and prints the metrics as
JSON:

    python -m open_muse_tpu_torch.eval.distill_midscale --train-steps 6000 \\
        --distill-steps 2000 [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import time
from typing import Dict, List

import numpy as np
import torch

from .quality_regression import (encode_texts, is_cuda, resolve_fp32_device, sample, sampler_copy,
                                 seeded_modules, token_count, train_state, train_vq)

__all__ = ["run_distill_midscale", "make_scene_images", "MID_COLORS", "scene_color_accuracy",
           "main"]

MID_COLORS = {
    "red": (0.85, 0.10, 0.10),
    "green": (0.10, 0.80, 0.15),
    "blue": (0.10, 0.15, 0.85),
    "yellow": (0.85, 0.80, 0.10),
    "cyan": (0.10, 0.80, 0.85),
    "magenta": (0.85, 0.10, 0.80),
}
CANVAS = 64
BACKGROUND = 0.92


def make_scene_images(colors: List[str], rs: np.random.RandomState,
                      noise: float = 0.015) -> np.ndarray:
    """One solid square an image at a place and size drawn from ``rs``, on a
    light background."""
    out = []
    for c in colors:
        img = np.full((CANVAS, CANVAS, 3), BACKGROUND, np.float32)
        size = int(rs.randint(20, 45))
        y0 = int(rs.randint(0, CANVAS - size + 1))
        x0 = int(rs.randint(0, CANVAS - size + 1))
        img[y0:y0 + size, x0:x0 + size] = np.asarray(MID_COLORS[c], np.float32)
        img += rs.randn(CANVAS, CANVAS, 3).astype(np.float32) * noise
        out.append(np.clip(img, 0.0, 1.0))
    return np.stack(out)


def scene_color_accuracy(images: List[np.ndarray], prompts: List[str]) -> float:
    """Share of images whose saturated pixels (channel spread > 0.25: the
    square, not the grey background) are nearest the prompted colour."""
    palette = {c: np.asarray(v, np.float32) for c, v in MID_COLORS.items()}
    correct = 0
    for img, prompt in zip(images, prompts):
        want = next(c for c in MID_COLORS if c in prompt)
        px = np.asarray(img, np.float32).reshape(-1, 3)
        colored = px[px.max(axis=1) - px.min(axis=1) > 0.25]
        if len(colored) == 0:
            continue
        mean = colored.mean(axis=0)
        got = min(palette, key=lambda c: float(np.sum((palette[c] - mean) ** 2)))
        correct += int(got == want)
    return correct / max(len(images), 1)


def _build_midscale_stack(seed: int, hidden: int, layers: int, device):
    from ..models.clip_text import CLIPTextEncoder, SimpleTokenizer
    from ..models.maskgit_vqgan import MaskGitVQGAN
    from ..models.transformer_v2 import MaskGiTUViT_v2

    vq, text_encoder, model = seeded_modules(seed, device, lambda: (
        # reduction 4 (two downsamples): (64 / 4)^2 = 256 tokens
        MaskGitVQGAN(resolution=CANVAS, hidden_channels=32, channel_mult=(1, 2, 2),
                     num_res_blocks=1, z_channels=32, num_embeddings=256,
                     quantized_embed_dim=32),
        CLIPTextEncoder(vocab_size=64, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=8,
                        projection_dim=48),
        MaskGiTUViT_v2(
            hidden_size=hidden, cond_embed_dim=48, micro_cond_encode_dim=8,
            micro_cond_embed_dim=40, encoder_hidden_size=64, vocab_size=256 + 4,
            mask_token_id=256 + 3, codebook_size=256, in_channels=64, block_out_channels=(64,),
            num_res_blocks=1, block_num_heads=2, num_hidden_layers=layers,
            num_attention_heads=hidden // 64, intermediate_size=hidden * 4)))
    return vq, text_encoder.eval(), SimpleTokenizer(64, 8), model


def warmup_cosine(peak: float, warmup: int, total: int, end: float):
    """optax's ``warmup_cosine_decay_schedule(0, peak, warmup, total, end)``."""
    def fn(step):
        if step < warmup:
            return peak * step / warmup
        progress = min(max(step - warmup, 0) / max(total - warmup, 1), 1.0)
        return end + (peak - end) * 0.5 * (1.0 + math.cos(math.pi * progress))

    return fn


def run_distill_midscale(train_steps: int = 6000, vq_steps: int = 600, distill_steps: int = 700,
                         n_eval: int = 240, seed: int = 0, teacher_timesteps: int = 12,
                         step_ratio: int = 2, guidance_scale: float = 2.0, hidden: int = 256,
                         layers: int = 8, batch: int = 16, distill_lr: float = 3e-4,
                         min_masking_rate: float = 0.3, lr: float = 2e-3,
                         warmup_steps: int = 200, probe_every: int = 0,
                         soft_weight: float = 0.5, distill_eval_every: int = 0,
                         device="cuda", log=print) -> Dict[str, float]:
    """Train the teacher, self-distill it to K = N / step_ratio CFG-free
    steps, and score teacher_full / teacher_k / student_k against one
    held-out real set, with the split-half floor.  ``min_masking_rate`` 0.3
    and cond dropout 0.1 make the teacher use its text (with the plain
    cosine draw the square's colour is inferable from visible tokens, and
    the unconditional branch CFG mixes in would be untrained).
    ``probe_every`` logs the teacher's colour accuracy at cfg 0 and 2 while
    it trains; ``distill_eval_every`` scores the EMA student while it
    distills."""
    from ..ops.sampling import cosine_schedule
    from ..training import trainer as T
    from ..training.distill import draw_distill_noise, frozen_teacher, make_distill_step
    from ..training.masking import draw_masking_noise
    from .fid import CLIPFeatureExtractor, fid_between_image_sets

    device = resolve_fp32_device(device)
    cuda = is_cuda(device)
    autocast_dtype = torch.bfloat16 if cuda else None
    rs = np.random.RandomState(seed)
    vq, text_encoder, tokenizer, model = _build_midscale_stack(seed, hidden, layers, device)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"midscale stack: {layers} layers, hidden {hidden}, "
        f"{n_params / 1e6:.1f}M transformer params, 256 tokens")
    names = list(MID_COLORS)
    seq_len = token_count(vq, CANVAS)

    log("stage 1: training VQ tokenizer")
    recon = train_vq(vq, lambda i: make_scene_images(
        [names[(i + j) % len(names)] for j in range(batch)], rs), vq_steps, 2e-3)
    log(f"  recon_loss={recon:.4f}")

    ehs_e, pooled_e = encode_texts(text_encoder, tokenizer, [""])
    # the colour rotation has period len(names): its text batches, encoded once
    text_cache = [encode_texts(text_encoder, tokenizer,
                               [f"a {names[(r + j) % len(names)]} square" for j in range(batch)])
                  for r in range(len(names))]
    micro = torch.tensor([[CANVAS, CANVAS, 0, 0, 6.0]] * batch, device=device)
    chunk_tokens: Dict[int, torch.Tensor] = {}
    chunk = 8  # steps of fresh images tokenized by one get_code

    def batch_for(i):
        if i not in chunk_tokens:
            chunk_tokens.clear()
            pixels = np.concatenate([make_scene_images(
                [names[(k + j) % len(names)] for j in range(batch)], rs)
                for k in range(i, i + chunk)])
            with torch.no_grad():
                tokens = vq.get_code(torch.from_numpy(pixels).to(device))
            for o in range(chunk):
                chunk_tokens[i + o] = tokens[o * batch:(o + 1) * batch]
        hs, pooled = text_cache[i % len(names)]
        return {"image_tokens": chunk_tokens[i], "encoder_hidden_states": hs,
                "cond_embeds": pooled, "micro_conds": micro,
                "empty_embeds": ehs_e, "empty_cond_embeds": pooled_e}

    def probe(step):
        decoder = sampler_copy(model)
        prompts = [f"a {names[k % len(names)]} square" for k in range(48)]
        accs = {cfg: scene_color_accuracy(sample(
            decoder, vq, text_encoder, tokenizer, prompts, 9999, timesteps=teacher_timesteps,
            guidance_scale=cfg, resolution=CANVAS), prompts) for cfg in (0.0, 2.0)}
        log(f"  probe@{step}: acc(cfg=0)={accs[0.0]:.3f} acc(cfg=2)={accs[2.0]:.3f} "
            f"(chance {1 / len(names):.3f})")

    log("stage 2: training teacher")
    t0 = time.perf_counter()
    warmup = min(warmup_steps, max(train_steps // 10, 1))
    state = train_state(model, warmup_cosine(lr, warmup, train_steps, lr * 0.05))
    step_fn = T.make_uvit_train_step(cosine_schedule, model.config.mask_token_id,
                                     codebook_size=256, min_masking_rate=min_masking_rate,
                                     cond_dropout_prob=0.1, autocast_dtype=autocast_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    first_loss = last_loss = None
    for i in range(train_steps):
        noise = draw_masking_noise(batch, seq_len, gen, 256, cond_dropout=True)
        loss = step_fn(state, batch_for(i), noise)["loss"]
        if i == 0:
            first_loss = float(loss)
        if (i + 1) % 500 == 0 or i + 1 == train_steps:
            last_loss = float(loss)
            log(f"  step {i + 1}: loss={last_loss:.4f}")
        if probe_every and (i + 1) % probe_every == 0:
            probe(i + 1)
    model.eval()
    teacher_s = time.perf_counter() - t0
    log(f"  teacher loss {first_loss:.4f} -> {last_loss:.4f} ({teacher_s:.1f} s)")

    k_steps = teacher_timesteps // step_ratio
    eval_colors = [names[i % len(names)] for i in range(n_eval)]
    prompts = [f"a {c} square" for c in eval_colors]
    real_images = list(make_scene_images(eval_colors, np.random.RandomState(seed + 1)))
    real_b = list(make_scene_images(eval_colors, np.random.RandomState(seed + 7)))
    extractor = CLIPFeatureExtractor.seeded(seed=1234, device=device, image_size=CANVAS,
                                            patch_size=8)
    fid_floor = fid_between_image_sets(real_images, real_b, extractor)

    def score(decoder, timesteps, cfg, tag):
        images = sample(decoder, vq, text_encoder, tokenizer, prompts, seed + 2,
                        timesteps=timesteps, guidance_scale=cfg, resolution=CANVAS)
        fid = fid_between_image_sets(real_images, images, extractor)
        acc = scene_color_accuracy(images, prompts)
        log(f"  {tag}: steps={timesteps} cfg={cfg} fid={fid:.3f} acc={acc:.2f}")
        return fid, acc

    log(f"stage 3: self-distilling {teacher_timesteps}-step cfg={guidance_scale} teacher -> "
        f"{k_steps}-step no-cfg student (soft_weight={soft_weight}, EMA student)")
    t0 = time.perf_counter()
    student = copy.deepcopy(model)
    dwarmup = min(100, max(distill_steps // 10, 1))
    dstate = train_state(student, warmup_cosine(distill_lr, dwarmup, distill_steps,
                                                distill_lr * 0.05),
                         max_grad_norm=None, ema_decay=0.999)
    dstep = make_distill_step(
        frozen_teacher(model, autocast_dtype), mask_token_id=model.config.mask_token_id,
        teacher_timesteps=teacher_timesteps, step_ratio=step_ratio,
        guidance_scale=guidance_scale, temperature=(1.0, 0.0), seq_len=seq_len,
        max_grad_norm=1.0, soft_weight=soft_weight, autocast_dtype=autocast_dtype)
    dgen = torch.Generator().manual_seed(seed + 3)
    dfirst = dlast = None
    for i in range(distill_steps):
        hs, pooled = text_cache[i % len(names)]
        dbatch = {"encoder_hidden_states": hs, "cond_embeds": pooled, "micro_conds": micro,
                  "empty_embeds": ehs_e, "empty_cond_embeds": pooled_e}
        noise = draw_distill_noise(dgen, timesteps=teacher_timesteps, step_ratio=step_ratio,
                                   batch=batch, seq_len=seq_len, codebook_size=256,
                                   device=device)
        loss = dstep(dstate, dbatch, noise)["loss"]
        if i == 0:
            dfirst = float(loss)
        if distill_eval_every and (i + 1) % distill_eval_every == 0 and i + 1 < distill_steps:
            score(sampler_copy(student, dstate.ema.shadow), k_steps, 0.0,
                  f"student_k(ema)@{i + 1}")
        if i + 1 == distill_steps:
            dlast = float(loss)
    distill_s = time.perf_counter() - t0
    log(f"  distill loss {dfirst:.4f} -> {dlast:.4f} ({distill_s:.1f} s)")

    log("stage 4: scoring teacher_full / teacher_k / student_k")
    teacher = sampler_copy(model)
    fid_tf, acc_tf = score(teacher, teacher_timesteps, guidance_scale, "teacher_full")
    fid_tk, acc_tk = score(teacher, k_steps, 0.0, "teacher_k (step-cut control)")
    score(sampler_copy(student), k_steps, 0.0, "student_k (raw, diagnostic)")
    fid_sk, acc_sk = score(sampler_copy(student, dstate.ema.shadow), k_steps, 0.0, "student_k")

    return {
        "n_params_m": n_params / 1e6,
        "hidden": float(hidden), "layers": float(layers),
        "teacher_timesteps": float(teacher_timesteps),
        "student_timesteps": float(k_steps),
        "guidance_scale": float(guidance_scale),
        "vq_recon_loss": recon,
        "train_loss_first": first_loss, "train_loss_last": last_loss,
        "distill_loss_first": dfirst, "distill_loss_last": dlast,
        "fid_split_half_floor": fid_floor,
        "fid_teacher_full": fid_tf, "color_accuracy_teacher_full": acc_tf,
        "fid_teacher_k": fid_tk, "color_accuracy_teacher_k": acc_tk,
        "fid_student_k": fid_sk, "color_accuracy_student_k": acc_sk,
        "n_eval": float(n_eval),
        "train_steps": float(train_steps),
        "distill_steps": float(distill_steps),
        "teacher_train_s": teacher_s, "distill_s": distill_s,
    }


def main(argv=None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(description="the mid-scale distillation protocol")
    parser.add_argument("--train-steps", type=int, default=6000)
    parser.add_argument("--vq-steps", type=int, default=600)
    parser.add_argument("--distill-steps", type=int, default=2000)
    parser.add_argument("--n-eval", type=int, default=240)
    parser.add_argument("--guidance-scale", type=float, default=2.0)
    parser.add_argument("--soft-weight", type=float, default=0.5)
    parser.add_argument("--hidden", type=int, default=256)
    parser.add_argument("--layers", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    metrics = run_distill_midscale(
        train_steps=args.train_steps, vq_steps=args.vq_steps, distill_steps=args.distill_steps,
        n_eval=args.n_eval, guidance_scale=args.guidance_scale, soft_weight=args.soft_weight,
        hidden=args.hidden, layers=args.layers, seed=args.seed, device=args.device)
    metrics["seconds"] = time.perf_counter() - t0
    metrics["margin"] = metrics["fid_teacher_k"] - metrics["fid_student_k"]
    metrics["passes"] = float(metrics["margin"] > metrics["fid_split_half_floor"])
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
