"""Generate a synthetic training set: N CLIP-scored candidates a prompt.

Counterpart of ``scripts/gen_synthetic_dataset.py``: a port pipeline
(``PipelineMuse``, the transformer in bf16 on the card) draws
``--candidates`` images a prompt, ``--clip-model`` scores them
(``models.clip_vision.CLIPScorer``, ``logits_per_image``) and all of them
go into tar shards, the best picked at training time by
``training.data.sdxl_synthetic_dataset_map``:

  {key}.{i}.png ........... candidate images
  {key}.txt ............... the prompt
  {key}.clip_scores.txt ... comma-separated logits_per_image

With ``--candidates 1`` a flat schema is written instead ({key}.jpg / .txt /
.json).

    python -m open_muse_tpu_torch.scripts.gen_synthetic_dataset --model path/to/pipeline \\
        --prompts prompts.txt --output shards/syn-%05d.tar --candidates 4 \\
        --clip-model path/to/clip [--samples-per-shard 1000] [--device cpu]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import tarfile

import torch

from ..core.modeling import resolve_device
from ..models.clip_vision import default_dtype

__all__ = ["main"]


def main(argv=None) -> int:
    """Returns the number of shards written."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", required=True)
    parser.add_argument("--prompts", required=True)
    parser.add_argument("--output", required=True, help="tar pattern with %%05d")
    parser.add_argument("--candidates", type=int, default=4)
    parser.add_argument("--clip-model", default=None,
                        help="CLIP checkpoint dir (full CLIPModel or vision_encoder/ and "
                             "text_encoder/ subfolders) that scores the candidates")
    parser.add_argument("--samples-per-shard", type=int, default=1000)
    parser.add_argument("--timesteps", type=int, default=12)
    parser.add_argument("--guidance-scale", type=float, default=8.0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from ..models.clip_vision import CLIPScorer
    from ..pipelines.pipeline_muse import PipelineMuse

    device = resolve_device(args.device)
    scorer = None
    if args.clip_model:
        scorer = CLIPScorer.from_pretrained(args.clip_model, device=device)
    elif args.candidates > 1:
        # the candidates are there to be CLIP-scored: without a scorer all
        # but one would be wasted compute
        parser.error("--candidates > 1 requires --clip-model")

    pipe = PipelineMuse.from_pretrained(args.model, device=device,
                                        transformer_dtype=default_dtype(device))
    with open(args.prompts) as f:
        prompts = [line.strip() for line in f if line.strip()]

    generator = torch.Generator().manual_seed(0)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    shard_idx, in_shard, tf = 0, 0, None

    def add(name, data):
        info = tarfile.TarInfo(name)
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))

    for p_idx, prompt in enumerate(prompts):
        candidates = pipe(prompt, num_images_per_prompt=args.candidates,
                          timesteps=args.timesteps, guidance_scale=args.guidance_scale,
                          generator=generator)
        if tf is None:
            tf = tarfile.open(args.output % shard_idx, "w")
        key = f"{p_idx:08d}"
        if scorer is not None and args.candidates > 1:
            scores = scorer.score(candidates, [prompt])[:, 0]
            for i, img in enumerate(candidates):
                buf = io.BytesIO()
                img.save(buf, format="PNG")
                add(f"{key}.{i}.png", buf.getvalue())
            add(f"{key}.txt", prompt.encode())
            add(f"{key}.clip_scores.txt", ",".join(str(float(s)) for s in scores).encode())
        else:
            best = candidates[0] if scorer is None else candidates[scorer.best_of(candidates,
                                                                                   prompt)]
            buf = io.BytesIO()
            best.save(buf, format="JPEG", quality=95)
            add(f"{key}.jpg", buf.getvalue())
            add(f"{key}.txt", prompt.encode())
            add(f"{key}.json", json.dumps({"width": best.size[0], "height": best.size[1],
                                           "synthetic": True}).encode())
        in_shard += 1
        if in_shard >= args.samples_per_shard:
            tf.close()
            tf, in_shard = None, 0
            shard_idx += 1
    if tf is not None:
        tf.close()
        shard_idx += 1
    print(f"generated {len(prompts)} samples into {shard_idx} shards")
    return shard_idx


if __name__ == "__main__":
    main()
