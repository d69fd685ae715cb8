"""Text -> image, class -> image and inpainting pipelines, the counterparts
of ``open_muse_tpu/pipelines/pipeline_muse.py`` ``PipelineMuse`` (text
prompts or their embeddings, or ImageNet class ids with
``is_class_conditioned=True``) and ``PipelineMuseInpainting``.

Flow: tokenize -> CLIP encode (penultimate hidden state + projected pooled
embedding; a T5 tower gives its last hidden state and no pooled one) ->
empty-prompt embeddings for CFG -> micro-conds -> ``MaskGiTUViT_v2.generate2``
(or a v1 ``MaskGitTransformer``'s ``generate2`` / ``generate``) -> the VQ
model's ``decode_code`` (a taming or MaskGIT VQGAN, MOVQ or Paella) -> NHWC
float images.  Inpainting first encodes the image to VQGAN tokens (``get_code``,
the ``vq_argmin`` kernel) and starts the decode from them with the masked
tokens set to the mask token.  The class-conditional flow has no text
tower.  The transformer may run in bf16 while the VQGAN stays fp32.

The serving entry points run one captured CUDA graph a request on the card
(``core.captured``), as the JAX package runs one XLA program:
``compile_text2image`` returns ``fn(input_ids, micro_conds,
generator_or_noise)`` whose graph holds the CLIP encode, the decode and
``decode_code``; ``text2image`` calls it through a cache keyed on its
arguments; ``compile_inpaint`` / ``inpaint`` do the same with ``get_code``
first.  ``__call__`` captures the decode (``generate2`` / ``generate``).
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.captured import captured
from ..core.configuration import load_config_dict
from ..core.modeling import resolve_device
from ..models.clip_text import CLIPTextEncoder, SimpleTokenizer
from ..models.maskgit_vqgan import MaskGitVQGAN
from ..models.movq import MOVQ
from ..models.paella_vq import PaellaVQModel
from ..models.t5_text import T5TextEncoder
from ..models.taming_vqgan import VQGANModel, to_nhwc
from ..models.transformer_v1 import MaskGitTransformer
from ..models.transformer_v2 import (MaskGiTUViT_v2, decode_noise, decode_schedules,
                                     parallel_decode_loop)
from ..ops.sampling import get_mask_schedule

__all__ = ["PipelineMuse", "PipelineMuseInpainting"]

logger = logging.getLogger(__name__)

_VAE_CLASSES = {"VQGANModel": VQGANModel, "MaskGitVQGAN": MaskGitVQGAN, "MOVQ": MOVQ,
                "PaellaVQModel": PaellaVQModel}
_TRANSFORMER_CLASSES = {"MaskGitTransformer": MaskGitTransformer,
                        "MaskGiTUViT": MaskGiTUViT_v2, "MaskGiTUViT_v2": MaskGiTUViT_v2}


def _class_of(path: str, classes: dict, kind: str):
    name = load_config_dict(path).get("_class_name")
    if name not in classes:
        raise ValueError(f"Unknown {kind} class: {name}")
    return classes[name]


def _text_encoder_class(path: str):
    """CLIP or T5 by the directory's config.json: its HF ``architectures``
    and ``model_type``, or the JAX package's ``_class_name``."""
    config = load_config_dict(path)
    names = " ".join(config.get("architectures", [])) + config.get("model_type", "") + \
        config.get("_class_name", "")
    return T5TextEncoder if "t5" in names.lower() else CLIPTextEncoder


def _repeat(x, times: int):
    return x if x is None or times == 1 else x.repeat_interleave(times, 0)


def _hashable(value):
    return tuple(value) if isinstance(value, (tuple, list)) else value


class PipelineMuse:
    def __init__(self, vae, transformer, is_class_conditioned: bool = False, text_encoder=None,
                 tokenizer=None):
        self.vae = vae
        self.transformer = transformer
        self.is_class_conditioned = is_class_conditioned
        self.text_encoder = text_encoder
        self.tokenizer = tokenizer
        self._compiled = {}  # the serving entry points' request functions, by arguments

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

    def _micro_conds(self, orig_size, crop_coords, aesthetic_score):
        """{"micro_conds": (1, 5)} where the transformer takes them, else {}."""
        if not getattr(self.transformer.config, "add_micro_cond_embeds", False):
            return {}
        return {"micro_conds": torch.tensor(
            [list(orig_size) + list(crop_coords) + [aesthetic_score]], dtype=torch.float32,
            device=self.device)}

    def _on_device(self, x):
        return None if x is None else torch.as_tensor(x).to(self.device)

    @torch.no_grad()
    def __call__(self, text: Optional[Union[str, List[str]]] = None,
                 negative_text: Optional[Union[str, List[str]]] = "",
                 prompt_embeds=None, pooled_embeds=None, negative_prompt_embeds=None,
                 negative_pooled_embeds=None,
                 class_ids: Optional[Union[int, List[int]]] = None,
                 timesteps: int = 16, noise_schedule: str = "cosine",
                 guidance_scale: float = 10.0, guidance_schedule=None,
                 temperature: Union[float, Tuple[float, float]] = (2, 0),
                 topk_filter_thres: float = 0.9, num_images_per_prompt: int = 1,
                 use_maskgit_generate: bool = True, generator: torch.Generator | None = None,
                 noise=None, orig_size=(512, 512), crop_coords=(0, 0),
                 aesthetic_score: float = 6.0, return_intermediate: bool = False,
                 transformer_seq_len: Optional[int] = None, clip_skip: Optional[int] = None,
                 return_pil: bool = True):
        """Text prompts (or their embeddings: ``prompt_embeds`` /
        ``pooled_embeds``, ``negative_prompt_embeds`` /
        ``negative_pooled_embeds`` with ``negative_text=None``) or class ids
        -> images (PIL, or an NHWC float tensor with ``return_pil=False``).
        Noise comes from the CPU ``generator`` or is ``noise=(sample_gumbel
        (T, B, S, V), mask_gumbel (T, B, S))`` (v1 ``generate``: one (T, B,
        S, codebook) Gumbel tensor).  A v1 ``MaskGitTransformer`` decodes
        with ``generate2`` or, with ``use_maskgit_generate=False``, the top-k
        ``generate``; ``guidance_schedule`` and ``transformer_seq_len`` reach
        v2 only, the micro-conditioning only a config with
        ``add_micro_cond_embeds``.  ``return_intermediate`` (PIL only, as in
        JAX) also returns each step's raw samples decoded (v2), or the final
        images again (v1)."""
        if (text is None) == (class_ids is None):
            raise ValueError("pass exactly one of text and class_ids")
        if class_ids is not None:
            class_ids = np.repeat(np.asarray(class_ids).reshape(-1), num_images_per_prompt)
            inputs = {"class_ids": torch.as_tensor(class_ids, device=self.device)}
        else:
            if isinstance(text, str):
                text = [text]
            if prompt_embeds is not None:
                ehs, pooled = self._on_device(prompt_embeds), self._on_device(pooled_embeds)
            else:
                ehs, pooled = self._encode_text(self._tokenize(text), clip_skip)
            if negative_text is not None:
                if isinstance(negative_text, str):
                    negative_text = [negative_text] * len(text)
                neg_ehs, neg_pooled = self._encode_text(self._tokenize(negative_text))
            else:
                neg_ehs = self._on_device(negative_prompt_embeds)
                neg_pooled = self._on_device(negative_pooled_embeds)
            n = num_images_per_prompt
            inputs = {"encoder_hidden_states": _repeat(ehs, n), "cond_embeds": _repeat(pooled, n),
                      "negative_embeds": _repeat(neg_ehs, n),
                      "negative_cond_embeds": _repeat(neg_pooled, n)}
            if neg_ehs is None:
                inputs["empty_embeds"], inputs["empty_cond_embeds"] = self._encode_text(
                    self._tokenize([""]))
        inputs.update(self._micro_conds(orig_size, crop_coords, aesthetic_score))
        kwargs = dict(timesteps=timesteps, guidance_scale=guidance_scale, temperature=temperature,
                      noise_schedule=get_mask_schedule(noise_schedule), generator=generator,
                      noise=noise)
        if isinstance(self.transformer, MaskGiTUViT_v2):
            out = self.transformer.generate2(
                **inputs, **kwargs, guidance_schedule=guidance_schedule,
                seq_len=transformer_seq_len, return_intermediate=return_intermediate)
            tokens, intermediate = out if return_intermediate else (out, None)
        else:
            if use_maskgit_generate:
                tokens = self.transformer.generate2(**inputs, **kwargs)
            else:
                tokens = self.transformer.generate(**inputs, **kwargs,
                                                   topk_filter_thres=topk_filter_thres)
            intermediate = [tokens]
        images = self.vae.decode_code(tokens)
        if not return_pil:
            return images
        pil = self._pil(images)
        if return_intermediate:
            return pil, [self._pil(self.vae.decode_code(t)) for t in intermediate]
        return pil

    def _pil(self, images):
        return [self.to_pil_image(img) for img in images.float().cpu().numpy()]

    @staticmethod
    def to_pil_image(image):
        """NHWC float image in [0, 1] -> PIL."""
        from PIL import Image

        image = np.clip(np.asarray(image, dtype=np.float32), 0.0, 1.0)
        return Image.fromarray((255 * image).astype(np.uint8)).convert("RGB")

    # -- the serving entry points: one captured graph a request ---------------

    def _text_decode(self, start_ids, input_ids, micro_conds, empty_ids, schedules, noise, *,
                     guidance, timesteps: int, row0: int = 0):
        """Tokenized text -> the v2 decode from ``start_ids`` (B, S): the
        prompt and the empty prompt are encoded in one batch under CFG."""
        tdtype = self.transformer.dtype
        if guidance is not None:
            both = torch.cat([input_ids, empty_ids.expand(input_ids.shape[0], -1)], dim=0)
            micros = torch.cat([micro_conds, micro_conds], dim=0)
        else:
            both, micros = input_ids, micro_conds
        hidden_states, _, pooled = self.text_encoder(both)
        return parallel_decode_loop(
            self.transformer, start_ids, hidden_states[-2].to(tdtype), pooled.to(tdtype), micros,
            schedules[0], guidance, schedules[1], use_cfg=guidance is not None,
            seq_len=start_ids.shape[1], timesteps=timesteps, row0=row0, **noise)

    def _request_fn(self, name: str, start, seq_len_of, n_image: int, batch_size: int,
                    timesteps: int, guidance_scale: float, temperature, noise_schedule: str,
                    row0: int = 0):
        """The request function of ``compile_text2image`` / ``compile_inpaint``:
        ``fn(*image_inputs, input_ids, micro_conds, generator_or_noise,
        return_tokens=False)``, ``start(*image_inputs)`` giving the start
        ids inside the graph and ``seq_len_of(*image_inputs)`` their
        length.  ``generator_or_noise`` may also be noise ``decode_noise``
        drew, (kind, sampler noise, mask_gumbel).  The schedules go to the
        card and the empty prompt is tokenized once, here; ``fn.eager`` runs
        the same body without the graph (for comparisons).  ``row0``: the
        first image's row in the Philox stream (a rank's share of a sharded
        batch)."""
        if not isinstance(self.transformer, MaskGiTUViT_v2):
            raise TypeError(f"{name} serves MaskGiTUViT_v2, not {type(self.transformer).__name__}")
        device = self.device
        temperatures, guidance_scales, mask_ratios = decode_schedules(
            timesteps, temperature, guidance_scale, None, get_mask_schedule(noise_schedule))
        schedules = torch.stack([temperatures, mask_ratios]).to(device)
        guidance = tuple(guidance_scales.tolist()) if guidance_scale > 0 else None
        empty_ids = self._tokenize([""])
        codebook = self.transformer.config.codebook_size

        def body(kind, *tensors):
            *image_inputs, input_ids, micro_conds, empty, sched, sample_noise, mask_gumbel = tensors
            tokens = self._text_decode(start(*image_inputs), input_ids, micro_conds, empty, sched,
                                       {kind: sample_noise, "mask_gumbel": mask_gumbel},
                                       guidance=guidance, timesteps=timesteps, row0=row0)
            return self.vae.decode_code(tokens), tokens

        @torch.no_grad()
        def run(graph: bool, *args, return_tokens: bool = False):
            if len(args) != n_image + 3:
                raise TypeError(f"{name}: expected {n_image + 3} arguments, got {len(args)}")
            *image_inputs, input_ids, micro_conds, generator_or_noise = args
            if input_ids.shape[0] != batch_size:
                raise ValueError(f"{name} was built for batch {batch_size}, got "
                                 f"{tuple(input_ids.shape)}")
            image_inputs = [torch.as_tensor(x).to(device) for x in image_inputs]
            seq_len = seq_len_of(*image_inputs)
            if isinstance(generator_or_noise, tuple) and len(generator_or_noise) == 3:
                kind, sample_noise, mask_gumbel = generator_or_noise  # drawn already
            else:
                generator, noise = ((generator_or_noise, None)
                                    if isinstance(generator_or_noise, torch.Generator)
                                    else (None, generator_or_noise))
                kind, sample_noise, mask_gumbel = decode_noise(
                    generator, noise, timesteps=timesteps, batch=batch_size, seq_len=seq_len,
                    vocab=codebook, device=device)
            tensors = (*image_inputs, input_ids.to(device).long(),
                       micro_conds.to(device, torch.float32), empty_ids, schedules, sample_noise,
                       mask_gumbel)
            if graph:
                key = (name, batch_size, timesteps, guidance, seq_len, kind, row0)
                images, tokens = captured(self, key, lambda *t: body(kind, *t), *tensors,
                                          modules=(self.transformer, self.text_encoder,
                                                   self.vae))
            else:
                images, tokens = body(kind, *tensors)
            return (images, tokens) if return_tokens else images

        fn = lambda *args, **kwargs: run(True, *args, **kwargs)  # noqa: E731
        fn.eager = lambda *args, **kwargs: run(False, *args, **kwargs)
        return fn

    def compile_text2image(self, batch_size: int = 1, timesteps: int = 12,
                           guidance_scale: float = 8.0, temperature=(2, 0), seq_len: int = 256,
                           noise_schedule: str = "cosine", mesh=None):
        """Tokenized text -> images as ONE captured CUDA graph a request (on
        the CPU, eagerly): the CLIP encode (prompt and empty prompt batched
        under CFG; batch B at guidance 0), the MaskGIT decode and the fp32
        ``decode_code``.  Returns ``fn(input_ids (B, T), micro_conds (B, 5),
        generator_or_noise, return_tokens=False)`` -> NHWC float images (and
        the token ids with ``return_tokens``); ``generator_or_noise`` is a
        CPU ``torch.Generator`` or ``(sample_gumbel (T, B, S, V), mask_gumbel
        (T, B, S))``.  The graph is cached on the pipeline under (batch,
        timesteps, guidance, seq_len, noise kind); the temperature and mask
        schedules are its inputs.

        ``mesh`` (``parallel.mesh.create_mesh``, over every rank of the
        group): sharded serving.  Every rank holds whole weights and answers
        the same call with the whole batch: it draws the noise for the
        global batch, runs its rows (ceil(B / ranks), the last rank's padded
        with copies of a row) through its own captured graph, its sampler
        drawing those rows' Philox noise, and all-gathers the images (and
        token ids), dropping the pad rows, so every rank returns what the
        unsharded call returns."""
        mask_token_id = self.transformer.config.mask_token_id

        def local_fn(rows: int, row0: int = 0):
            def start():
                return torch.full((rows, seq_len), mask_token_id, dtype=torch.long,
                                  device=self.device)

            return self._request_fn("text2image", start, lambda: seq_len, 0, rows, timesteps,
                                    guidance_scale, temperature, noise_schedule, row0)

        if mesh is None:
            return local_fn(batch_size)
        return self._sharded(mesh, batch_size, local_fn, timesteps, seq_len)

    def _sharded(self, mesh, batch_size: int, local_fn, timesteps: int, seq_len: int):
        """``compile_text2image``'s sharded request function (see there)."""
        from ..parallel.mesh import all_gather_rows, rank_and_world

        rank, world = rank_and_world()
        if mesh.size() != world:
            raise ValueError(f"sharded serving splits the batch over every rank: the mesh has "
                             f"{mesh.size()} of {world}")
        rows = -(-batch_size // world)
        lo, hi = min(rank * rows, batch_size), min((rank + 1) * rows, batch_size)
        inner = local_fn(rows, rank * rows)
        codebook = self.transformer.config.codebook_size

        def take(x, dim=0):
            """Rows lo:hi of ``x`` along ``dim``, padded to ``rows`` with copies
            of the last (of row 0 where the rank has none)."""
            x = x.movedim(dim, 0)
            part = x[lo:hi] if hi > lo else x[:1]
            pad = rows - part.shape[0]
            if pad:
                part = torch.cat([part, part[-1:].expand(pad, *part.shape[1:])])
            return part.movedim(0, dim)

        @torch.no_grad()
        def run(graph: bool, input_ids, micro_conds, generator_or_noise,
                return_tokens: bool = False):
            if input_ids.shape[0] != batch_size:
                raise ValueError(f"text2image was built for batch {batch_size}, got "
                                 f"{tuple(input_ids.shape)}")
            generator, noise = ((generator_or_noise, None)
                                if isinstance(generator_or_noise, torch.Generator)
                                else (None, generator_or_noise))
            kind, sample_noise, mask_gumbel = decode_noise(
                generator, noise, timesteps=timesteps, batch=batch_size, seq_len=seq_len,
                vocab=codebook, device=self.device)
            if kind == "sample_gumbel":
                sample_noise = take(sample_noise, 1)
            drawn = (kind, sample_noise, take(mask_gumbel, 1))
            call = inner if graph else inner.eager
            images, tokens = call(take(input_ids.to(self.device)),
                                  take(micro_conds.to(self.device)), drawn, return_tokens=True)
            images = all_gather_rows(images)[:batch_size]
            tokens = all_gather_rows(tokens)[:batch_size]
            return (images, tokens) if return_tokens else images

        fn = lambda *args, **kwargs: run(True, *args, **kwargs)  # noqa: E731
        fn.eager = lambda *args, **kwargs: run(False, *args, **kwargs)
        return fn

    def _cached(self, name: str, compile_fn, batch_size: int, *args):
        key = (name, batch_size, *map(_hashable, args))
        if key not in self._compiled:
            self._compiled[key] = compile_fn(batch_size, *args)
        return self._compiled[key]

    @torch.no_grad()
    def text2image(self, input_ids, micro_conds, generator_or_noise, timesteps: int = 12,
                   guidance_scale: float = 8.0, temperature=(2, 0), seq_len: int = 256,
                   noise_schedule: str = "cosine", return_tokens: bool = False, mesh=None):
        """Tokenized text -> images, the serving entry point: input_ids (B,
        T) and micro_conds (B, 5) -> NHWC float images, through the
        ``compile_text2image`` function of these arguments (built once;
        ``mesh``: sharded over its ranks)."""
        fn = self._cached("text2image", self.compile_text2image, input_ids.shape[0], timesteps,
                          guidance_scale, temperature, seq_len, noise_schedule, mesh)
        return fn(input_ids, micro_conds, generator_or_noise, return_tokens=return_tokens)

    # -- serialization ----------------------------------------------------------

    @classmethod
    def from_pretrained(cls, model_name_or_path: Optional[str] = None,
                        text_encoder_path: Optional[str] = None, vae_path: Optional[str] = None,
                        transformer_path: Optional[str] = None, vae=None, text_encoder=None,
                        transformer=None, is_class_conditioned: bool = False,
                        transformer_dtype=torch.float32, device="cuda"):
        """A pipeline from a local directory (``text_encoder/``, ``vae/``,
        ``transformer/``, each a ``save_pretrained`` directory) or from
        explicit component paths or models, on ``device`` (the card unless
        the caller asks for the CPU).  No hub ids: there is no network.
        The text tower is CLIP or T5 by its config (``_text_encoder_class``).
        Tokenizer files that ``transformers`` cannot load give the port's
        ``SimpleTokenizer``, with a warning: the CLIP tower's
        ``max_position_embeddings`` tokens, 77 for T5."""
        if model_name_or_path is None:
            if (transformer is None and transformer_path is None) or (
                    vae is None and vae_path is None):
                raise ValueError("Provide model_name_or_path or explicit component paths.")
        else:
            if not os.path.isdir(model_name_or_path):
                raise ValueError(f"{model_name_or_path!r} is not a local directory; the port "
                                 f"loads local save_pretrained directories only")
            text_encoder_path = text_encoder_path or os.path.join(model_name_or_path,
                                                                  "text_encoder")
            vae_path = vae_path or os.path.join(model_name_or_path, "vae")
            transformer_path = transformer_path or os.path.join(model_name_or_path,
                                                                "transformer")
        device = resolve_device(device)
        tokenizer = None
        if not is_class_conditioned:
            if text_encoder is None:
                text_encoder = _text_encoder_class(text_encoder_path).from_pretrained(
                    text_encoder_path, device=device)
            tokenizer = cls._load_tokenizer(text_encoder_path, text_encoder)
        if transformer is None:
            tcls = _class_of(transformer_path, _TRANSFORMER_CLASSES, "Transformer")
            transformer = tcls.from_pretrained(transformer_path, device=device).to(
                transformer_dtype)
        if vae is None:
            vae = _class_of(vae_path, _VAE_CLASSES, "VAE").from_pretrained(vae_path,
                                                                           device=device)
        if is_class_conditioned:
            return cls(vae=vae, transformer=transformer, is_class_conditioned=True)
        return cls(vae=vae, transformer=transformer, text_encoder=text_encoder,
                   tokenizer=tokenizer)

    @staticmethod
    def _load_tokenizer(path, text_encoder):
        try:
            from transformers import AutoTokenizer

            return AutoTokenizer.from_pretrained(path, local_files_only=True)
        except Exception:  # no transformers, or no tokenizer files at path
            logger.warning(f"no tokenizer files at {path}; falling back to the hash-based "
                           f"SimpleTokenizer -- generated images will NOT match "
                           f"real-checkpoint quality")
            config = text_encoder.config
            return SimpleTokenizer(vocab_size=config.vocab_size,
                                   model_max_length=getattr(config, "max_position_embeddings",
                                                            77))

    def save_pretrained(self, save_directory: str) -> None:
        """``text_encoder/`` (and the tokenizer, where it can save itself),
        ``vae/`` and ``transformer/``, each a ``save_pretrained`` directory
        that the JAX package's ``PipelineMuse.from_pretrained`` reads too."""
        if not self.is_class_conditioned:
            self.text_encoder.save_pretrained(os.path.join(save_directory, "text_encoder"))
            if hasattr(self.tokenizer, "save_pretrained"):
                self.tokenizer.save_pretrained(os.path.join(save_directory, "text_encoder"))
        self.vae.save_pretrained(os.path.join(save_directory, "vae"))
        self.transformer.save_pretrained(os.path.join(save_directory, "transformer"))


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
    def __call__(self, image, mask, text: Optional[Union[str, List[str]]] = None,
                 negative_text: Optional[Union[str, List[str]]] = None,
                 class_ids: Optional[Union[int, List[int]]] = None, timesteps: int = 8,
                 guidance_scale: float = 8.0, guidance_schedule=None,
                 temperature: Union[float, Tuple[float, float]] = 1.0,
                 num_images_per_prompt: int = 1, generator: torch.Generator | None = None,
                 noise=None, image_size: int = 256, orig_size=(256, 256), crop_coords=(0, 0),
                 aesthetic_score: float = 6.0, return_pil: bool = True):
        """A PIL image (or an NHWC float array in [0, 1]), a token mask and
        prompts or class ids (with a v1 ``MaskGitTransformer``) -> images.
        Noise comes from the CPU ``generator`` or is ``noise=(sample_gumbel
        (T, B, S, V), mask_gumbel (T, B, S))``.  The micro-conditioning
        reaches a config with ``add_micro_cond_embeds`` only."""
        if (text is None) == (class_ids is None):
            raise ValueError("pass exactly one of text and class_ids")
        pixel_values = self._preprocess_image(image, image_size)
        start_ids = self._start_ids(pixel_values, mask, 1).repeat_interleave(
            num_images_per_prompt, 0)
        n = num_images_per_prompt
        if class_ids is not None:
            class_ids = np.repeat(np.asarray(class_ids).reshape(-1), n)
            inputs = {"class_ids": torch.as_tensor(class_ids, device=self.device)}
        else:
            if isinstance(text, str):
                text = [text]
            ehs, pooled = self._encode_text(self._tokenize(text))
            neg_ehs = neg_pooled = None
            if negative_text is not None:
                if isinstance(negative_text, str):
                    negative_text = [negative_text]
                neg_ehs, neg_pooled = self._encode_text(self._tokenize(negative_text))
            inputs = {"encoder_hidden_states": _repeat(ehs, n), "cond_embeds": _repeat(pooled, n),
                      "negative_embeds": _repeat(neg_ehs, n),
                      "negative_cond_embeds": _repeat(neg_pooled, n)}
            inputs["empty_embeds"], inputs["empty_cond_embeds"] = self._encode_text(
                self._tokenize([""]))
        inputs.update(self._micro_conds(orig_size, crop_coords, aesthetic_score))
        if isinstance(self.transformer, MaskGiTUViT_v2):
            inputs.update(guidance_schedule=guidance_schedule, seq_len=start_ids.shape[1])
        tokens = self.transformer.generate2(
            input_ids=start_ids, timesteps=timesteps, guidance_scale=guidance_scale,
            temperature=temperature, generator=generator, noise=noise, **inputs)
        images = self.vae.decode_code(tokens)
        return images if not return_pil else self._pil(images)

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

    def compile_inpaint(self, batch_size: int = 1, timesteps: int = 12,
                        guidance_scale: float = 8.0, temperature=(2, 0),
                        noise_schedule: str = "cosine"):
        """``compile_text2image`` for inpainting: ``fn(pixel_values (B, R,
        R, 3) or NCHW float in [0, 1], mask (S,) or (B, S) bool (True =
        repaint the token), input_ids (B, T), micro_conds (B, 5),
        generator_or_noise, return_tokens=False)`` -> NHWC float images, one
        captured graph a request: ``get_code``, the decode from the masked
        tokens, ``decode_code``."""

        def start(pixel_values, mask):
            return self._start_ids(pixel_values, mask, batch_size)

        def seq_len(pixel_values, mask):  # the VQGAN's tokens: (R / 2^(levels - 1))^2
            side = to_nhwc(pixel_values).shape[1] >> (len(self.vae.config.channel_mult) - 1)
            return side * side

        return self._request_fn("inpaint", start, seq_len, 2, batch_size, timesteps,
                                guidance_scale, temperature, noise_schedule)

    @torch.no_grad()
    def inpaint(self, pixel_values, mask, input_ids, micro_conds, generator_or_noise,
                timesteps: int = 12, guidance_scale: float = 8.0, temperature=(2, 0),
                noise_schedule: str = "cosine", return_tokens: bool = False):
        """The inpainting serving entry point, shaped like ``text2image``,
        through the ``compile_inpaint`` function of these arguments."""
        fn = self._cached("inpaint", self.compile_inpaint, input_ids.shape[0], timesteps,
                          guidance_scale, temperature, noise_schedule)
        return fn(pixel_values, mask, input_ids, micro_conds, generator_or_noise,
                  return_tokens=return_tokens)
