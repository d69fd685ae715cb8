"""A quality regression: train a tiny MUSE stack from scratch on a
synthetic prompt -> image world, generate, and score the result.  The
counterpart of ``open_muse_tpu/eval/quality_regression.py``.

Coloured squares ("a red square" -> a 16 px red image): the VQ model is
trained first, then a v2 transformer through the port's train step
(``training.trainer.make_uvit_train_step``; one replayed CUDA graph a step
on the card), then both the trained and the untrained transformer decode
the same prompts (``generate2`` at guidance 0) and are scored against a
held-out real set.  If any piece of the stack is wrong, the trained model's
FID does not beat the untrained one's and its colour accuracy stays at
chance.  Metrics (all measured, none published: the towers are seeded):

  fid_clipfeat_seeded_*  Fréchet distance over a seeded CLIP tower's features
  color_accuracy_*       share of images whose dominant channel is the prompt's
  clip_score_seeded_*    the CLIP score through seeded towers
  fid_inception_seeded_* / isc_seeded_*  (``inception=True``) the seeded
                         InceptionV3 graph's FID and Inception Score

``run_distill_regression`` distills the trained teacher
(``training.distill.make_distill_step``) and scores teacher_full,
teacher_k (the step-cut control) and student_k.  Entry points run on the
card unless ``device="cpu"``; on the card the transformers train under bf16
autocast and decode from bf16 copies (the attention kernel takes bf16), the
VQ model and the text tower stay fp32.  Every draw comes from an explicit
``torch.Generator`` or ``numpy.random.RandomState``.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.modeling import resolve_device

__all__ = ["run_quality_regression", "run_distill_regression", "COLORS", "color_accuracy",
           "make_square_images"]

COLORS = {
    "red": (0.9, 0.1, 0.1),
    "green": (0.1, 0.9, 0.1),
    "blue": (0.1, 0.1, 0.9),
}
RESOLUTION = 16


def make_square_images(colors: List[str], rs: np.random.RandomState,
                       noise: float = 0.02) -> np.ndarray:
    out = []
    for c in colors:
        img = np.ones((RESOLUTION, RESOLUTION, 3), np.float32) * np.asarray(COLORS[c], np.float32)
        img += rs.randn(RESOLUTION, RESOLUTION, 3).astype(np.float32) * noise
        out.append(np.clip(img, 0.0, 1.0))
    return np.stack(out)


def color_accuracy(images: List[np.ndarray], prompts: List[str]) -> float:
    """Share of images whose dominant channel is the prompted colour's."""
    correct = 0
    for img, prompt in zip(images, prompts):
        color = next(c for c in COLORS if c in prompt)
        expected = int(np.argmax(COLORS[color]))
        got = int(np.argmax(np.asarray(img, np.float32).reshape(-1, 3).mean(0)))
        correct += int(got == expected)
    return correct / max(len(images), 1)


def seeded_modules(seed: int, device, build: Callable):
    """``build()``'s modules with torch's default initialisation drawn on the
    CPU after ``torch.manual_seed(seed)`` (the global generator left as it
    was), then moved to ``device``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return [m.to(device) for m in build()]


def _build_stack(seed: int, device):
    from ..models.clip_text import CLIPTextEncoder, SimpleTokenizer
    from ..models.maskgit_vqgan import MaskGitVQGAN
    from ..models.transformer_v2 import MaskGiTUViT_v2

    vq, text_encoder, model = seeded_modules(seed, device, lambda: (
        MaskGitVQGAN(resolution=RESOLUTION, hidden_channels=32, channel_mult=(1, 2),
                     num_res_blocks=1, z_channels=16, num_embeddings=64, quantized_embed_dim=16),
        CLIPTextEncoder(vocab_size=64, hidden_size=32, intermediate_size=64,
                        num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=8,
                        projection_dim=24),
        MaskGiTUViT_v2(
            hidden_size=64, cond_embed_dim=24, micro_cond_encode_dim=8, micro_cond_embed_dim=40,
            encoder_hidden_size=32, vocab_size=68, codebook_size=64, in_channels=32,
            block_out_channels=(32,), num_res_blocks=1, block_num_heads=2, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=96)))
    return vq, text_encoder.eval(), SimpleTokenizer(64, 8), model


def token_count(vq, resolution: int) -> int:
    """Image tokens of a ``resolution`` px image: one a reduction_factor^2 patch."""
    return (resolution // 2 ** (vq.config.num_resolutions - 1)) ** 2


def is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def resolve_fp32_device(device) -> torch.device:
    """``resolve_device``, with TF32 off for matmuls and cuDNN on the card,
    as the port's trainers set it: the regressions' fp32 parts (the VQ
    model, the text tower, the scorers) compute in fp32, as JAX does."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def train_vq(vq, next_pixels: Callable[[int], np.ndarray], steps: int, lr: float) -> float:
    """``steps`` AdamW steps of MSE + the VQ loss on ``next_pixels(i)``
    (NHWC in [0, 1]), eagerly; returns the last loss."""
    from ..training.optimizers import get_optimizer, global_norm

    device = next(vq.parameters()).device
    vq.train()
    opt = get_optimizer("adamw", vq, lr)
    loss = torch.zeros(())
    for i in range(steps):
        pixels = torch.from_numpy(next_pixels(i)).to(device)
        opt.begin_step()
        recon, _, _, vq_loss = vq(pixels, return_loss=True)
        loss = torch.mean(torch.square(recon - pixels)) + vq_loss
        loss.backward()
        opt.update(global_norm([p.grad for p in vq.parameters()]))
        opt.end_step(True)
        opt.zero_grad()
    vq.eval()
    return float(loss.detach())


@torch.no_grad()
def encode_texts(text_encoder, tokenizer, texts):
    """(penultimate hidden state, pooled) fp32 of ``texts``."""
    device = next(text_encoder.parameters()).device
    ids = torch.as_tensor(np.asarray(tokenizer(list(texts))["input_ids"]), dtype=torch.long,
                          device=device)
    hidden_states, _, pooled = text_encoder(ids)
    return hidden_states[-2].float(), pooled.float()


def train_state(model, lr, *, max_grad_norm: Optional[float] = 1.0, ema_decay=None):
    from ..training import trainer as T
    from ..training.ema import EMA
    from ..training.optimizers import get_optimizer

    model.train()
    return T.TrainState(model=model, optimizer=get_optimizer("adamw", model, lr,
                                                             max_grad_norm=max_grad_norm),
                        ema=None if ema_decay is None else EMA(model, decay=ema_decay))


def sampler_copy(model, params: Optional[Dict[str, torch.Tensor]] = None):
    """An eval copy of ``model`` (with ``params`` loaded, e.g. an EMA
    shadow) in the decode's type: bf16 on the card, fp32 on the CPU."""
    out = copy.deepcopy(model).eval()
    if params is not None:
        out.load_state_dict(params, strict=False)
    device = next(out.parameters()).device
    return out.to(torch.bfloat16) if is_cuda(device) else out


@torch.no_grad()
def sample(model, vq, text_encoder, tokenizer, prompts, seed: int, *, timesteps: int,
           guidance_scale: float = 0.0, resolution: int = RESOLUTION,
           batch_size: int = 16) -> List[np.ndarray]:
    """``generate2`` over ``prompts`` in fixed batches (the tail padded and
    cropped: one captured decode a shape) with ``temperature=(1, 0)``, each
    batch's noise from ``torch.Generator().manual_seed(seed + start)``, then
    ``decode_code``; NHWC float32 images.  ``model`` is decoded as given
    (``sampler_copy``)."""
    dtype = next(model.parameters()).dtype
    seq_len = token_count(vq, resolution)
    empty = None
    if guidance_scale > 0:
        empty = encode_texts(text_encoder, tokenizer, [""] * batch_size)
    images: List[np.ndarray] = []
    for start in range(0, len(prompts), batch_size):
        chunk = list(prompts[start:start + batch_size])
        n = len(chunk)
        hs, pooled = encode_texts(text_encoder, tokenizer, chunk + [chunk[-1]] * (batch_size - n))
        ehs, epooled = empty if empty is not None else (hs, pooled)
        micro = torch.tensor([[resolution, resolution, 0, 0, 6.0]] * batch_size,
                             device=hs.device)
        tokens = model.generate2(
            hs.to(dtype), pooled.to(dtype), micro, empty_embeds=ehs.to(dtype),
            empty_cond_embeds=epooled.to(dtype), timesteps=timesteps,
            guidance_scale=guidance_scale, temperature=(1.0, 0.0), seq_len=seq_len,
            generator=torch.Generator().manual_seed(seed + start))
        images.extend(vq.decode_code(tokens).float().cpu().numpy()[:n])
    return images


def _make_batch_fn(vq, text_encoder, tokenizer, rs):
    """batch_for(colors) -> a train batch: the squares' tokens and their
    prompts' encodings."""

    def batch_for(colors):
        device = next(vq.parameters()).device
        pixels = torch.from_numpy(make_square_images(colors, rs)).to(device)
        with torch.no_grad():
            tokens = vq.get_code(pixels)
        hs, pooled = encode_texts(text_encoder, tokenizer, [f"a {c} square" for c in colors])
        return {"image_tokens": tokens, "encoder_hidden_states": hs, "cond_embeds": pooled,
                "micro_conds": torch.tensor([[RESOLUTION, RESOLUTION, 0, 0, 6.0]] * len(colors),
                                            device=device)}

    return batch_for


def _train_transformer(model, batch_for, train_steps: int, seed: int, lr=4e-3):
    """Stage 2, masked-token training -> (first loss, last loss)."""
    from ..ops.sampling import cosine_schedule
    from ..training import trainer as T
    from ..training.masking import draw_masking_noise

    device = next(model.parameters()).device
    state = train_state(model, lr)
    step = T.make_uvit_train_step(cosine_schedule, model.config.mask_token_id, codebook_size=64,
                                  autocast_dtype=torch.bfloat16 if is_cuda(device) else None)
    gen = torch.Generator(device=device).manual_seed(seed)
    names = list(COLORS)
    first = last = None
    for i in range(train_steps):
        batch = batch_for([names[j % 3] for j in range(i, i + 6)])
        noise = draw_masking_noise(6, batch["image_tokens"].shape[1], gen, 64)
        loss = float(step(state, batch, noise)["loss"])
        first = loss if i == 0 else first
        last = loss
    model.eval()
    return first, last


def seeded_scorer(device):
    """The regression's CLIP scorer: seeded towers (ViT 64 x 4, 32 px, patch
    8; text 32 x 2), logit scale 100."""
    from ..models.clip_text import CLIPTextEncoder, SimpleTokenizer
    from ..models.clip_vision import CLIPScorer, CLIPVisionEncoder, default_dtype
    from .fid import seeded_init_

    vision = seeded_init_(CLIPVisionEncoder(
        hidden_size=64, intermediate_size=128, num_hidden_layers=4, num_attention_heads=4,
        image_size=32, patch_size=8, projection_dim=64), 1234)
    text = seeded_init_(CLIPTextEncoder(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=8, projection_dim=64,
        eos_token_id=63), 1234)
    dtype = default_dtype(device)
    return CLIPScorer(vision.to(device, dtype).eval(), text.to(device, dtype).eval(),
                      SimpleTokenizer(64, 8))


def run_quality_regression(train_steps: int = 200, vq_steps: int = 150, n_eval: int = 30,
                           seed: int = 0, inception: bool = False, device="cuda",
                           log=print) -> Dict[str, float]:
    """Train the tiny stack, generate, score; returns the measured metrics."""
    from .clip_score import clip_score
    from .fid import CLIPFeatureExtractor, fid_between_image_sets

    device = resolve_fp32_device(device)
    rs = np.random.RandomState(seed)
    vq, text_encoder, tokenizer, model = _build_stack(seed, device)
    names = list(COLORS)

    log("stage 1: training VQ tokenizer")
    recon_loss = train_vq(vq, lambda i: make_square_images(
        [names[j % 3] for j in range(i, i + 6)], rs), vq_steps, 3e-3)
    log(f"  recon_loss={recon_loss:.4f}")

    log("stage 2: training transformer")
    untrained = sampler_copy(model)
    batch_for = _make_batch_fn(vq, text_encoder, tokenizer, rs)
    first_loss, last_loss = _train_transformer(model, batch_for, train_steps, seed)
    log(f"  loss {first_loss:.4f} -> {last_loss:.4f}")

    eval_colors = [names[i % 3] for i in range(n_eval)]
    prompts = [f"a {c} square" for c in eval_colors]
    real_images = list(make_square_images(eval_colors, np.random.RandomState(seed + 1)))

    log("stage 3: generating trained + untrained sets")
    kw = dict(timesteps=6)
    trained_images = sample(sampler_copy(model), vq, text_encoder, tokenizer, prompts,
                            seed + 2, **kw)
    untrained_images = sample(untrained, vq, text_encoder, tokenizer, prompts, seed + 2, **kw)

    log("stage 4: scoring (FID over seeded CLIP features + CLIP score)")
    extractor = CLIPFeatureExtractor.seeded(seed=1234, device=device, image_size=32,
                                            patch_size=8)
    fid_trained = fid_between_image_sets(real_images, trained_images, extractor)
    fid_untrained = fid_between_image_sets(real_images, untrained_images, extractor)
    cs_trained = clip_score(seeded_scorer(device), trained_images, prompts)

    inception_metrics: Dict[str, float] = {}
    if inception:
        log("stage 5: inception-graph scoring (seeded)")
        from .inception import InceptionFeatureExtractor
        from .inception_score import inception_score_from_logits

        inc = InceptionFeatureExtractor.seeded(seed=1234, batch_size=64, device=device)
        inception_metrics["fid_inception_seeded_trained"] = fid_between_image_sets(
            real_images, trained_images, inc)
        inception_metrics["fid_inception_seeded_untrained"] = fid_between_image_sets(
            real_images, untrained_images, inc)
        isc_mean, isc_std = inception_score_from_logits(
            np.log(inc.predict_proba(trained_images) + 1e-20))
        inception_metrics["isc_seeded_trained"] = isc_mean
        inception_metrics["isc_seeded_trained_std"] = isc_std

    return {
        **inception_metrics,
        "vq_recon_loss": recon_loss,
        "train_loss_first": first_loss,
        "train_loss_last": last_loss,
        "fid_clipfeat_seeded_trained": fid_trained,
        "fid_clipfeat_seeded_untrained": fid_untrained,
        "color_accuracy_trained": color_accuracy(trained_images, prompts),
        "color_accuracy_untrained": color_accuracy(untrained_images, prompts),
        "clip_score_seeded_trained": cs_trained,
        "n_eval": float(n_eval),
        "train_steps": float(train_steps),
    }


def run_distill_regression(train_steps: int = 200, vq_steps: int = 150,
                           distill_steps: int = 120, n_eval: int = 30, seed: int = 0,
                           teacher_timesteps: int = 6, step_ratio: int = 2,
                           guidance_scale: float = 2.0, distill_lr: float = 5e-4,
                           device="cuda", log=print) -> Dict[str, float]:
    """Train the tiny teacher, distill its ``teacher_timesteps``-step CFG
    decode into a ``teacher_timesteps // step_ratio``-step CFG-free student,
    and score three decodes against one held-out real set: teacher_full
    (the target), teacher_k (the teacher cut to the student's steps: the
    control) and student_k."""
    from ..training.distill import draw_distill_noise, frozen_teacher, make_distill_step
    from .fid import CLIPFeatureExtractor, fid_between_image_sets

    device = resolve_fp32_device(device)
    rs = np.random.RandomState(seed)
    vq, text_encoder, tokenizer, model = _build_stack(seed, device)
    names = list(COLORS)

    log("stage 1: training VQ tokenizer")
    train_vq(vq, lambda i: make_square_images([names[j % 3] for j in range(i, i + 6)], rs),
             vq_steps, 3e-3)

    log("stage 2: training teacher")
    batch_for = _make_batch_fn(vq, text_encoder, tokenizer, rs)
    first_loss, last_loss = _train_transformer(model, batch_for, train_steps, seed)
    log(f"  teacher loss {first_loss:.4f} -> {last_loss:.4f}")

    log(f"stage 3: self-distilling {teacher_timesteps}-step cfg={guidance_scale} "
        f"teacher -> {teacher_timesteps // step_ratio}-step no-cfg student")
    cuda = is_cuda(device)
    seq_len = token_count(vq, RESOLUTION)
    student = copy.deepcopy(model)
    dstate = train_state(student, distill_lr, max_grad_norm=None)
    dstep = make_distill_step(
        frozen_teacher(model, torch.bfloat16 if cuda else None),
        mask_token_id=model.config.mask_token_id, teacher_timesteps=teacher_timesteps,
        step_ratio=step_ratio, guidance_scale=guidance_scale, temperature=(1.0, 0.0),
        seq_len=seq_len, max_grad_norm=1.0, autocast_dtype=torch.bfloat16 if cuda else None)
    ehs_e, pooled_e = encode_texts(text_encoder, tokenizer, [""])
    gen = torch.Generator().manual_seed(seed + 3)
    dfirst = dlast = None
    for i in range(distill_steps):
        hs, pooled = encode_texts(text_encoder, tokenizer,
                                  [f"a {names[j % 3]} square" for j in range(i, i + 6)])
        batch = {"encoder_hidden_states": hs, "cond_embeds": pooled,
                 "micro_conds": torch.tensor([[RESOLUTION, RESOLUTION, 0, 0, 6.0]] * 6,
                                             device=device),
                 "empty_embeds": ehs_e, "empty_cond_embeds": pooled_e}
        noise = draw_distill_noise(gen, timesteps=teacher_timesteps, step_ratio=step_ratio,
                                   batch=6, seq_len=seq_len, codebook_size=64, device=device)
        loss = float(dstep(dstate, batch, noise)["loss"])
        dfirst = loss if i == 0 else dfirst
        dlast = loss
    log(f"  distill loss {dfirst:.4f} -> {dlast:.4f}")

    log("stage 4: scoring teacher_full / teacher_k / student_k")
    eval_colors = [names[i % 3] for i in range(n_eval)]
    prompts = [f"a {c} square" for c in eval_colors]
    real_images = list(make_square_images(eval_colors, np.random.RandomState(seed + 1)))
    k_steps = teacher_timesteps // step_ratio
    extractor = CLIPFeatureExtractor.seeded(seed=1234, device=device, image_size=32,
                                            patch_size=8)

    def score(decoder, timesteps, tag):
        images = sample(decoder, vq, text_encoder, tokenizer, prompts, seed + 2,
                        timesteps=timesteps)
        fid = fid_between_image_sets(real_images, images, extractor)
        acc = color_accuracy(images, prompts)
        log(f"  {tag}: steps={timesteps} fid={fid:.2f} acc={acc:.2f}")
        return fid, acc

    teacher = sampler_copy(model)
    fid_tf, acc_tf = score(teacher, teacher_timesteps, "teacher_full")
    fid_tk, acc_tk = score(teacher, k_steps, "teacher_k")
    fid_sk, acc_sk = score(sampler_copy(student), k_steps, "student_k")

    return {
        "teacher_timesteps": float(teacher_timesteps),
        "student_timesteps": float(k_steps),
        "guidance_scale": float(guidance_scale),
        "distill_loss_first": dfirst,
        "distill_loss_last": dlast,
        "fid_teacher_full": fid_tf, "color_accuracy_teacher_full": acc_tf,
        "fid_teacher_k": fid_tk, "color_accuracy_teacher_k": acc_tk,
        "fid_student_k": fid_sk, "color_accuracy_student_k": acc_sk,
        "n_eval": float(n_eval),
        "train_steps": float(train_steps),
        "distill_steps": float(distill_steps),
    }
