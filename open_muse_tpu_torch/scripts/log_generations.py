"""Sample grids from a pipeline checkpoint for fixed prompt lists.

Counterpart of the JAX package's ``scripts/log_generations.py``: generates
images for a prompt file (one prompt a line, e.g. ``validation_prompts/``)
in chunks of ``--batch-size`` and writes each chunk as one PNG grid, and,
with ``--inpainting-dir`` (the ``inpainting_validation/`` layout: folders
of an image and a mask, the folder's name the prompt), one inpainted image
a folder.  wandb is not ported: the PNGs are the record.  Noise comes from
a CPU generator of ``--seed``; the transformer is bf16 on the card (the
kernels' type), fp32 on the CPU.

    python -m open_muse_tpu_torch.scripts.log_generations --model path/to/pipeline \\
        --prompts validation_prompts/dalle_mini_prompts.txt --output-dir gens/ \\
        [--inpainting-dir inpainting_validation/] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..models.clip_vision import default_dtype
from ..pipelines.pipeline_muse import PipelineMuse, PipelineMuseInpainting
from ..training.train_muse import save_image_grid

__all__ = ["main"]


def _array(images):
    return np.stack([np.asarray(img, dtype=np.float32) / 255 for img in images])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", required=True, help="a save_pretrained pipeline directory")
    parser.add_argument("--prompts", default=None, help="txt file of prompts")
    parser.add_argument("--inpainting-dir", default=None,
                        help="dirs of image.png + mask.png; dir name = prompt")
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--timesteps", type=int, default=12)
    parser.add_argument("--guidance-scale", type=float, default=8.0)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--latent-side", type=int, default=16,
                        help="the token grid's side the masks are resized to")
    parser.add_argument("--image-size", type=int, default=256,
                        help="the inpainting images' side (the VQ model's resolution)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    generator = torch.Generator().manual_seed(args.seed)
    written = []

    if args.prompts:
        pipe = PipelineMuse.from_pretrained(args.model, device=args.device,
                                            transformer_dtype=default_dtype(args.device))
        with open(args.prompts) as f:
            prompts = [line.strip() for line in f if line.strip()]
        for start in range(0, len(prompts), args.batch_size):
            chunk = prompts[start:start + args.batch_size]
            images = pipe(chunk, timesteps=args.timesteps, guidance_scale=args.guidance_scale,
                          generator=generator)
            out = os.path.join(args.output_dir, f"generations-{start:04d}.png")
            save_image_grid(_array(images), out)
            written.append(out)
            print(f"wrote {out}")

    if args.inpainting_dir:
        from PIL import Image

        pipe = PipelineMuseInpainting.from_pretrained(
            args.model, device=args.device, transformer_dtype=default_dtype(args.device))
        for prompt_dir in sorted(os.listdir(args.inpainting_dir)):
            full = os.path.join(args.inpainting_dir, prompt_dir)
            if not os.path.isdir(full):
                continue
            files = os.listdir(full)
            img_file = next((f for f in files if "mask" not in f.lower()
                             and f.lower().endswith((".png", ".jpg"))), None)
            mask_file = next((f for f in files if "mask" in f.lower()), None)
            if not img_file or not mask_file:
                continue
            image = Image.open(os.path.join(full, img_file)).convert("RGB")
            mask_img = Image.open(os.path.join(full, mask_file)).convert("L")
            mask = np.asarray(mask_img.resize((args.latent_side, args.latent_side))) > 127
            images = pipe(image=image, mask=mask, text=prompt_dir.replace("_", " "),
                          timesteps=args.timesteps, guidance_scale=args.guidance_scale,
                          image_size=args.image_size, generator=generator)
            out = os.path.join(args.output_dir, f"inpaint-{prompt_dir}.png")
            images[0].save(out)
            written.append(out)
            print(f"wrote {out}")
    return written


if __name__ == "__main__":
    main()
