"""Text -> image, class -> image and inpainting pipelines, the counterparts
of ``open_muse_tpu/pipelines/pipeline_muse.py`` ``PipelineMuse`` (text
prompts, or ImageNet class ids with ``is_class_conditioned=True``) and
``PipelineMuseInpainting``.

Flow: tokenize -> CLIP encode (penultimate hidden state + projected pooled
embedding) -> empty-prompt embeddings for CFG -> micro-conds ->
``MaskGiTUViT_v2.generate2`` -> VQGAN ``decode_code`` -> NHWC float images.
Inpainting first encodes the image to VQGAN tokens (``get_code``, the
``vq_argmin`` kernel) and starts the decode from them with the masked
tokens set to the mask token.  The class-conditional flow has no text
tower: class ids -> ``MaskGitTransformer.generate2(class_ids=...)`` ->
``MaskGitVQGAN.decode_code``.  The transformer may run in bf16 while the
VQGAN stays fp32.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..models.transformer_v2 import MaskGiTUViT_v2, decode_schedules, parallel_decode_loop
from ..ops.sampling import get_mask_schedule

__all__ = ["PipelineMuse", "PipelineMuseInpainting"]


class PipelineMuse:
    def __init__(self, vae, transformer, is_class_conditioned: bool = False, text_encoder=None,
                 tokenizer=None):
        self.vae = vae
        self.transformer = transformer
        self.is_class_conditioned = is_class_conditioned
        self.text_encoder = text_encoder
        self.tokenizer = tokenizer

    @property
    def device(self) -> torch.device:
        return next(self.transformer.parameters()).device

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
    def __call__(self, text: Optional[Union[str, List[str]]] = None,
                 negative_text: Optional[Union[str, List[str]]] = "",
                 class_ids: Optional[Union[int, List[int]]] = None,
                 timesteps: int = 16, noise_schedule: str = "cosine",
                 guidance_scale: float = 10.0, guidance_schedule=None,
                 temperature: Union[float, Tuple[float, float]] = (2, 0),
                 num_images_per_prompt: int = 1, generator: torch.Generator | None = None,
                 noise=None, orig_size=(512, 512), crop_coords=(0, 0),
                 aesthetic_score: float = 6.0, transformer_seq_len: Optional[int] = None,
                 clip_skip: Optional[int] = None, return_pil: bool = True):
        """Text prompts or class ids -> images (PIL, or an NHWC float tensor
        with ``return_pil=False``).  Noise comes from the CPU ``generator`` or
        is ``noise=(sample_gumbel (T, B, S, V), mask_gumbel (T, B, S))``.
        Text serves a v2 ``MaskGiTUViT_v2`` and a v1 ``MaskGitTransformer``
        (its ``generate2``, the reference's ``use_maskgit_generate=True``):
        ``guidance_schedule`` and ``transformer_seq_len`` reach v2 only, and
        the micro-conditioning only a config with ``add_micro_cond_embeds``."""
        if (text is None) == (class_ids is None):
            raise ValueError("pass exactly one of text and class_ids")
        if class_ids is not None:
            class_ids = np.repeat(np.asarray(class_ids).reshape(-1), num_images_per_prompt)
            tokens = self.transformer.generate2(
                class_ids=torch.as_tensor(class_ids, device=self.device), timesteps=timesteps,
                guidance_scale=guidance_scale, temperature=temperature,
                noise_schedule=get_mask_schedule(noise_schedule), generator=generator,
                noise=noise)
            return self._images(tokens, return_pil)
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
        config = self.transformer.config
        if getattr(config, "add_micro_cond_embeds", False):
            inputs["micro_conds"] = torch.tensor(
                [list(orig_size) + list(crop_coords) + [aesthetic_score]], dtype=torch.float32,
                device=self.device)
        if isinstance(self.transformer, MaskGiTUViT_v2):
            inputs.update(guidance_schedule=guidance_schedule, seq_len=transformer_seq_len)
        tokens = self.transformer.generate2(
            encoder_hidden_states=ehs, cond_embeds=pooled, timesteps=timesteps,
            guidance_scale=guidance_scale, temperature=temperature,
            noise_schedule=get_mask_schedule(noise_schedule), generator=generator, noise=noise,
            **inputs)
        return self._images(tokens, return_pil)

    def _images(self, tokens, return_pil: bool):
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
        start_ids = torch.full((input_ids.shape[0], seq_len),
                               self.transformer.config.mask_token_id, dtype=torch.long,
                               device=self.device)
        return self.vae.decode_code(self._decode(
            start_ids, input_ids, micro_conds, generator_or_noise, timesteps, guidance_scale,
            temperature, noise_schedule))

    def _decode(self, start_ids, input_ids, micro_conds, generator_or_noise, timesteps: int,
                guidance_scale: float, temperature, noise_schedule: str):
        """Tokenized text -> the decode loop from ``start_ids`` (B, S) -> token
        ids (B, S)."""
        tdtype = self.transformer.dtype
        seq_len = start_ids.shape[1]
        use_cfg = guidance_scale > 0
        temperatures, guidance_scales, mask_ratios = decode_schedules(
            timesteps, temperature, guidance_scale, None, get_mask_schedule(noise_schedule))
        input_ids = input_ids.to(self.device)
        micro_conds = micro_conds.to(self.device, torch.float32)
        if use_cfg:
            empty = self._tokenize([""]).expand(input_ids.shape[0], -1)
            both = torch.cat([input_ids.long(), empty], dim=0)
            micros = torch.cat([micro_conds, micro_conds], dim=0)
        else:
            both, micros = input_ids.long(), micro_conds
        hidden_states, _, pooled = self.text_encoder(both)
        if isinstance(generator_or_noise, torch.Generator):
            noise = dict(generator=generator_or_noise)
        else:
            sample_gumbel, mask_gumbel = generator_or_noise
            noise = dict(sample_gumbel=sample_gumbel, mask_gumbel=mask_gumbel)
        return parallel_decode_loop(
            self.transformer, start_ids, hidden_states[-2].to(tdtype), pooled.to(tdtype),
            micros, temperatures, guidance_scales, mask_ratios, use_cfg=use_cfg,
            seq_len=seq_len, timesteps=timesteps, **noise)


class PipelineMuseInpainting(PipelineMuse):
    """Inpainting: encode the image to tokens, set the masked tokens to the
    mask token, and decode from there."""

    def _start_ids(self, pixel_values, mask, batch: int):
        """VQGAN tokens of the images with the masked ones (``mask`` True, one
        flag per token, (S,) or (B, S)) set to the mask token."""
        tokens = self.vae.get_code(pixel_values.to(self.device, torch.float32))
        mask = torch.as_tensor(mask).to(tokens.device, torch.bool).reshape(-1, tokens.shape[1])
        tokens = torch.where(mask, self.transformer.config.mask_token_id, tokens)
        return tokens.expand(batch, -1) if tokens.shape[0] == 1 else tokens

    @torch.no_grad()
    def __call__(self, image, mask, text: Union[str, List[str]],
                 negative_text: Optional[Union[str, List[str]]] = None, timesteps: int = 8,
                 guidance_scale: float = 8.0, guidance_schedule=None,
                 temperature: Union[float, Tuple[float, float]] = 1.0,
                 num_images_per_prompt: int = 1, generator: torch.Generator | None = None,
                 noise=None, image_size: int = 256, orig_size=(256, 256), crop_coords=(0, 0),
                 aesthetic_score: float = 6.0, return_pil: bool = True):
        """A PIL image (or an NHWC float array in [0, 1]), a token mask and
        prompts -> images.  Noise comes from the CPU ``generator`` or is
        ``noise=(sample_gumbel (T, B, S, V), mask_gumbel (T, B, S))``."""
        if isinstance(text, str):
            text = [text]
        pixel_values = self._preprocess_image(image, image_size)
        start_ids = self._start_ids(pixel_values, mask, 1).repeat_interleave(
            num_images_per_prompt, 0)
        ehs, pooled = self._encode_text(self._tokenize(text))
        inputs = {}
        if negative_text is not None:
            if isinstance(negative_text, str):
                negative_text = [negative_text]
            neg_ehs, neg_pooled = self._encode_text(self._tokenize(negative_text))
            inputs["negative_embeds"] = neg_ehs.repeat_interleave(num_images_per_prompt, 0)
            if neg_pooled is not None:
                inputs["negative_cond_embeds"] = neg_pooled.repeat_interleave(
                    num_images_per_prompt, 0)
        inputs["empty_embeds"], inputs["empty_cond_embeds"] = self._encode_text(
            self._tokenize([""]))
        if pooled is not None:
            pooled = pooled.repeat_interleave(num_images_per_prompt, 0)
        micro_conds = torch.tensor([list(orig_size) + list(crop_coords) + [aesthetic_score]],
                                   dtype=torch.float32, device=self.device)
        tokens = self.transformer.generate2(
            encoder_hidden_states=ehs.repeat_interleave(num_images_per_prompt, 0),
            cond_embeds=pooled, micro_conds=micro_conds, input_ids=start_ids,
            timesteps=timesteps, guidance_scale=guidance_scale,
            guidance_schedule=guidance_schedule, temperature=temperature, generator=generator,
            noise=noise, seq_len=start_ids.shape[1], **inputs)
        return self._images(tokens, return_pil)

    @staticmethod
    def _preprocess_image(image, image_size: int) -> torch.Tensor:
        """PIL -> resized (shorter side, bilinear) and centre-cropped (1, R, R,
        3) float tensor in [0, 1]; an array is taken as it is."""
        from PIL import Image

        if isinstance(image, Image.Image):
            w, h = image.size
            scale = image_size / min(w, h)
            image = image.resize((round(w * scale), round(h * scale)), Image.BILINEAR)
            w, h = image.size
            left, top = (w - image_size) // 2, (h - image_size) // 2
            image = image.crop((left, top, left + image_size, top + image_size))
            arr = np.asarray(image.convert("RGB"), dtype=np.float32) / 255.0
        else:
            arr = np.asarray(image, dtype=np.float32)
        return torch.from_numpy(np.ascontiguousarray(arr))[None]

    @torch.no_grad()
    def inpaint(self, pixel_values, mask, input_ids, micro_conds, generator_or_noise,
                timesteps: int = 12, guidance_scale: float = 8.0, temperature=(2, 0),
                noise_schedule: str = "cosine"):
        """The inpainting serving entry point, shaped like ``text2image``:
        pixel_values (B, R, R, 3) (or NCHW) float in [0, 1], mask (S,) or
        (B, S) bool (True = repaint the token), input_ids (B, T), micro_conds
        (B, 5) -> NHWC float images."""
        start_ids = self._start_ids(pixel_values, mask, input_ids.shape[0])
        return self.vae.decode_code(self._decode(
            start_ids, input_ids, micro_conds, generator_or_noise, timesteps, guidance_scale,
            temperature, noise_schedule))
