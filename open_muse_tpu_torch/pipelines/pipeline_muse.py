"""Text -> image pipeline, the counterpart of
``open_muse_tpu/pipelines/pipeline_muse.py`` for text prompts with CFG.

Flow: tokenize -> CLIP encode (penultimate hidden state + projected pooled
embedding) -> empty-prompt embeddings for CFG -> micro-conds ->
``MaskGiTUViT_v2.generate2`` -> VQGAN ``decode_code`` -> NHWC float images.
The transformer may run in bf16 while the VQGAN stays fp32.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..models.transformer_v2 import decode_schedules, parallel_decode_loop
from ..ops.sampling import get_mask_schedule

__all__ = ["PipelineMuse"]


class PipelineMuse:
    def __init__(self, vae, transformer, text_encoder, tokenizer):
        self.vae = vae
        self.transformer = transformer
        self.text_encoder = text_encoder
        self.tokenizer = tokenizer

    @property
    def device(self) -> torch.device:
        return self.transformer.encoder_proj.weight.device

    def _tokenize(self, texts: List[str]) -> torch.Tensor:
        out = self.tokenizer(texts, padding="max_length", truncation=True,
                             max_length=self.tokenizer.model_max_length, return_tensors="np")
        return torch.as_tensor(np.asarray(out["input_ids"]), dtype=torch.long,
                               device=self.device)

    def _encode_text(self, input_ids, clip_skip: Optional[int] = None):
        hidden_states, last, text_embeds = self.text_encoder(input_ids)
        if getattr(self.transformer.config, "add_cond_embeds", False):
            layer = -(clip_skip + 1) if clip_skip is not None else -2
            return hidden_states[layer], text_embeds
        return last, None

    @torch.no_grad()
    def __call__(self, text: Union[str, List[str]], negative_text: Optional[Union[str, List[str]]] = "",
                 timesteps: int = 16, noise_schedule: str = "cosine",
                 guidance_scale: float = 10.0, guidance_schedule=None,
                 temperature: Union[float, Tuple[float, float]] = (2, 0),
                 num_images_per_prompt: int = 1, generator: torch.Generator | None = None,
                 orig_size=(512, 512), crop_coords=(0, 0),
                 aesthetic_score: float = 6.0, transformer_seq_len: Optional[int] = None,
                 clip_skip: Optional[int] = None, return_pil: bool = True):
        """Text prompts -> images (PIL, or an NHWC float tensor with
        ``return_pil=False``); noise comes from the CPU ``generator``."""
        if isinstance(text, str):
            text = [text]
        ehs, pooled = self._encode_text(self._tokenize(text), clip_skip)
        inputs = {}
        if negative_text is not None:
            if isinstance(negative_text, str):
                negative_text = [negative_text] * len(text)
            neg_ehs, neg_pooled = self._encode_text(self._tokenize(negative_text))
            inputs["negative_embeds"] = neg_ehs.repeat_interleave(num_images_per_prompt, 0)
            if neg_pooled is not None:
                inputs["negative_cond_embeds"] = neg_pooled.repeat_interleave(
                    num_images_per_prompt, 0)
        else:
            empty, empty_pooled = self._encode_text(self._tokenize([""]))
            inputs["empty_embeds"], inputs["empty_cond_embeds"] = empty, empty_pooled
        ehs = ehs.repeat_interleave(num_images_per_prompt, 0)
        if pooled is not None:
            pooled = pooled.repeat_interleave(num_images_per_prompt, 0)
        micro_conds = torch.tensor([list(orig_size) + list(crop_coords) + [aesthetic_score]],
                                   dtype=torch.float32, device=self.device)
        tokens = self.transformer.generate2(
            encoder_hidden_states=ehs, cond_embeds=pooled, micro_conds=micro_conds,
            timesteps=timesteps, guidance_scale=guidance_scale,
            guidance_schedule=guidance_schedule, temperature=temperature,
            noise_schedule=get_mask_schedule(noise_schedule), generator=generator,
            seq_len=transformer_seq_len, **inputs)
        images = self.vae.decode_code(tokens)
        if not return_pil:
            return images
        return [self.to_pil_image(img) for img in images.float().cpu().numpy()]

    @staticmethod
    def to_pil_image(image):
        """NHWC float image in [0, 1] -> PIL."""
        from PIL import Image

        image = np.clip(np.asarray(image, dtype=np.float32), 0.0, 1.0)
        return Image.fromarray((255 * image).astype(np.uint8)).convert("RGB")

    @torch.no_grad()
    def text2image(self, input_ids, micro_conds, generator_or_noise, timesteps: int = 12,
                   guidance_scale: float = 8.0, temperature=(2, 0), seq_len: int = 256,
                   noise_schedule: str = "cosine"):
        """Tokenized text -> images, the serving entry point (counterpart of
        ``compile_text2image``): input_ids (B, T) and micro_conds (B, 5) ->
        NHWC float images.  ``generator_or_noise`` is a CPU
        ``torch.Generator`` or ``(sample_gumbel (T, B, S, V), mask_gumbel
        (T, B, S))``.  The prompt and the empty prompt are encoded in one
        batch when ``guidance_scale > 0``."""
        tcfg = self.transformer.config
        tdtype = self.transformer.dtype
        batch = input_ids.shape[0]
        use_cfg = guidance_scale > 0
        temperatures, guidance_scales, mask_ratios = decode_schedules(
            timesteps, temperature, guidance_scale, None, get_mask_schedule(noise_schedule))
        input_ids = input_ids.to(self.device)
        micro_conds = micro_conds.to(self.device, torch.float32)
        if use_cfg:
            empty = self._tokenize([""]).expand(batch, -1)
            both = torch.cat([input_ids.long(), empty], dim=0)
            micros = torch.cat([micro_conds, micro_conds], dim=0)
        else:
            both, micros = input_ids.long(), micro_conds
        hidden_states, _, pooled = self.text_encoder(both)
        start_ids = torch.full((batch, seq_len), tcfg.mask_token_id, dtype=torch.long,
                               device=self.device)
        if isinstance(generator_or_noise, torch.Generator):
            noise = dict(generator=generator_or_noise)
        else:
            sample_gumbel, mask_gumbel = generator_or_noise
            noise = dict(sample_gumbel=sample_gumbel, mask_gumbel=mask_gumbel)
        tokens = parallel_decode_loop(
            self.transformer, start_ids, hidden_states[-2].to(tdtype), pooled.to(tdtype),
            micros, temperatures, guidance_scales, mask_ratios, use_cfg=use_cfg,
            seq_len=seq_len, timesteps=timesteps, **noise)
        return self.vae.decode_code(tokens)
