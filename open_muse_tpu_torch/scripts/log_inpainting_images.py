"""Inpainting logger: one image, a rectangular latent mask, N generations.

Counterpart of the JAX package's ``scripts/log_inpainting_images.py``: takes
an input image and a mask rectangle in latent coordinates (``image_size //
vae_scaling_factor`` a side), runs ``PipelineMuseInpainting`` (text- or
class-conditioned) and writes

  output_dir/segmented.jpg              the input with the masked pixels zeroed
  output_dir/output[_{class}]_{i}.jpg   each generation
  output_dir/output_grid.png            one PNG grid of them (the reference's
                                        wandb panel)

or, with ``--validation-dir`` (the ``inpainting_validation/`` layout), one
grid a folder.  Noise comes from a CPU generator of ``--seed``; the
transformer is bf16 on the card (the kernels' type), fp32 on the CPU.

    python -m open_muse_tpu_torch.scripts.log_inpainting_images --model PATH \\
        --input-image cat.png --text "a photo of a dog" --mask-start-x 4 --mask-end-x 12 \\
        --mask-start-y 4 --mask-end-y 12 --output-dir generated/ [--device cpu]
    python -m open_muse_tpu_torch.scripts.log_inpainting_images --model PATH \\
        --validation-dir inpainting_validation/ --output-dir generated/
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..models.clip_vision import default_dtype
from ..pipelines.pipeline_muse import PipelineMuseInpainting
from ..training.train_muse import load_inpainting_validation_data, save_image_grid

__all__ = ["build_parser", "main"]


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", required=True, help="a save_pretrained pipeline directory")
    parser.add_argument("--is-class-conditioned", action="store_true")
    parser.add_argument("--imagenet-class-id", type=int, default=248)
    parser.add_argument("--text", type=str, default="a picture of a dog")
    parser.add_argument("--input-image", type=str, default=None)
    parser.add_argument("--validation-dir", type=str, default=None,
                        help="inpainting_validation/-layout folder; overrides --input-image")
    parser.add_argument("--image-size", type=int, default=256)
    parser.add_argument("--vae-scaling-factor", type=int, default=16,
                        help="pixel -> latent downsample (f16 VQ)")
    parser.add_argument("--mask-start-x", type=int, default=4)
    parser.add_argument("--mask-start-y", type=int, default=4)
    parser.add_argument("--mask-end-x", type=int, default=12)
    parser.add_argument("--mask-end-y", type=int, default=12)
    parser.add_argument("--timesteps", type=int, default=18)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--guidance-scale", type=float, default=2.0)
    parser.add_argument("--num-generations", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output-dir", type=str, default="generated")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def _save_outputs(images, output_dir, prefix, class_id=None):
    tag = f"_{class_id}" if class_id is not None else ""
    for i, image in enumerate(images):
        image.save(os.path.join(output_dir, f"{prefix}{tag}_{i}.jpg"))
    grid_path = os.path.join(output_dir, f"{prefix}_grid.png")
    save_image_grid(np.stack([np.asarray(img, dtype=np.float32) / 255 for img in images]),
                    grid_path)
    return grid_path


def main(argv=None, pipe=None):
    args = build_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    from PIL import Image

    if pipe is None:
        pipe = PipelineMuseInpainting.from_pretrained(
            args.model, is_class_conditioned=args.is_class_conditioned, device=args.device,
            transformer_dtype=default_dtype(args.device))
    generator = torch.Generator().manual_seed(args.seed)
    latent_side = args.image_size // args.vae_scaling_factor
    common = dict(timesteps=args.timesteps, guidance_scale=args.guidance_scale,
                  temperature=args.temperature, num_images_per_prompt=args.num_generations,
                  image_size=args.image_size, generator=generator)

    if args.validation_dir:
        for entry in load_inpainting_validation_data(args.validation_dir, args.image_size,
                                                     latent_side):
            images = pipe(image=entry["image"], mask=np.asarray(entry["mask"]),
                          text=entry["prompt"], **common)
            slug = entry["prompt"].replace(" ", "_")[:60]
            print(f"wrote {_save_outputs(images, args.output_dir, f'inpaint-{slug}')}")
        return 0

    if not args.input_image:
        raise SystemExit("--input-image or --validation-dir is required")
    # x indexes rows and y columns, as the reference's numpy slicing does
    mask = np.zeros((latent_side, latent_side), dtype=bool)
    mask[args.mask_start_x:args.mask_end_x, args.mask_start_y:args.mask_end_y] = True
    image = Image.open(args.input_image).convert("RGB").resize((args.image_size,
                                                                args.image_size))
    f = args.vae_scaling_factor
    masked_pixels = np.array(image)
    masked_pixels[args.mask_start_x * f:args.mask_end_x * f,
                  args.mask_start_y * f:args.mask_end_y * f] = 0
    Image.fromarray(masked_pixels).save(os.path.join(args.output_dir, "segmented.jpg"))
    cond = ({"class_ids": args.imagenet_class_id} if args.is_class_conditioned
            else {"text": args.text})
    images = pipe(image=image, mask=mask, **cond, **common)
    class_id = args.imagenet_class_id if args.is_class_conditioned else None
    grid = _save_outputs(images, args.output_dir, "output", class_id=class_id)
    print(f"wrote {len(images)} generations + {grid}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
