"""FID evaluation: generate images from a caption file and score them.

Counterpart of ``scripts/calculate_fid.py``.  Generation goes through the
port's ``PipelineMuse`` (the transformer in bf16 on the card), sharded by
``--task-id`` / ``--num-tasks``; every image is named by its caption's
index in the unsharded list, so the tasks can share one output directory.
With ``--real-dir`` (and one task) the set is scored: by ``cleanfid`` when
it is importable (InceptionV3, the published protocol), else by CLIP-FID
over ``--clip-model``'s vision tower, else by a seeded CLIP tower (a
deterministic regression number, not a published metric).
``--clip-score`` also prints the mean CLIP score against the captions.

    python -m open_muse_tpu_torch.scripts.calculate_fid --model path/to/pipeline \\
        --captions captions.txt --output-dir fid_out/ --num-images 1000 \\
        [--timesteps 12 --guidance-scale 8] [--real-dir real/] \\
        [--clip-model path/to/clip --clip-score] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..core.modeling import resolve_device
from ..models.clip_vision import default_dtype

__all__ = ["generate_and_save_images", "compute_fid", "compute_clip_score", "main"]


def generate_and_save_images(pipe, captions, output_dir, batch_size, timesteps, guidance_scale,
                             seed: int = 0, global_indices=None) -> float:
    """Generate ``captions`` in batches and save ``{global index:06d}.png``;
    the noise comes from one CPU generator seeded with ``seed``.  Returns
    images a second."""
    if global_indices is None:
        global_indices = list(range(len(captions)))
    os.makedirs(output_dir, exist_ok=True)
    generator = torch.Generator().manual_seed(seed)
    t0 = time.time()
    for start in range(0, len(captions), batch_size):
        images = pipe(list(captions[start:start + batch_size]), timesteps=timesteps,
                      guidance_scale=guidance_scale, generator=generator)
        for i, img in enumerate(images):
            img.save(os.path.join(output_dir, f"{global_indices[start + i]:06d}.png"))
    dt = time.time() - t0
    rate = len(captions) / max(dt, 1e-9)
    print(f"generated {len(captions)} images in {dt:.1f}s ({rate:.2f} img/s)")
    return rate


def compute_fid(real_dir: str, fake_dir: str, clip_model: str = None, device="cuda"):
    """(FID of ``fake_dir`` against ``real_dir``, the backend's name)."""
    try:
        from cleanfid import fid

        score = fid.compute_fid(real_dir, fake_dir)
        print(json.dumps({"fid": score, "backend": "cleanfid"}))
        return score, "cleanfid"
    except ImportError:
        pass
    from ..eval.fid import CLIPFeatureExtractor, fid_between_dirs

    device = resolve_device(device)
    if clip_model:
        from ..models.clip_vision import CLIPVisionEncoder

        vision = CLIPVisionEncoder.from_pretrained(clip_model, device=device)
        extractor = CLIPFeatureExtractor(vision.to(default_dtype(device)).eval())
        backend = f"clip_fid({clip_model})"
    else:
        extractor = CLIPFeatureExtractor.seeded(seed=1234, device=device)
        backend = "clipfeat_seeded(NOT a published metric; deterministic)"
        print("cleanfid not installed and no --clip-model given; scoring with a seeded "
              "extractor -- regression number only", file=sys.stderr)
    score = fid_between_dirs(real_dir, fake_dir, extractor)
    print(json.dumps({"fid": score, "backend": backend}))
    return score, backend


def compute_clip_score(fake_dir: str, captions, clip_model: str, device="cuda") -> float:
    """Mean CLIP score of the generated images against their captions."""
    from ..eval.clip_score import clip_score
    from ..eval.fid import load_image_dir
    from ..models.clip_vision import CLIPScorer

    scorer = CLIPScorer.from_pretrained(clip_model, device=device)
    images = load_image_dir(fake_dir, limit=len(captions))
    score = clip_score(scorer, images, captions[:len(images)])
    print(json.dumps({"clip_score": score, "n_images": len(images)}))
    return score


def main(argv=None) -> dict:
    """Returns what it printed: ``images_per_s``, ``fid`` and ``backend``,
    ``clip_score`` (those it computed)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", required=True, help="pipeline dir")
    parser.add_argument("--captions", required=True,
                        help="txt file, one caption per line (or COCO json)")
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--real-dir", default=None)
    parser.add_argument("--num-images", type=int, default=1000)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--timesteps", type=int, default=12)
    parser.add_argument("--guidance-scale", type=float, default=8.0)
    parser.add_argument("--task-id", type=int, default=0)
    parser.add_argument("--num-tasks", type=int, default=1)
    parser.add_argument("--clip-model", default=None,
                        help="CLIP checkpoint dir: CLIP-FID without cleanfid, and --clip-score")
    parser.add_argument("--clip-score", action="store_true",
                        help="also report the mean CLIP score against the captions")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.clip_score and not args.clip_model:
        parser.error("--clip-score needs --clip-model")

    from ..pipelines.pipeline_muse import PipelineMuse

    device = resolve_device(args.device)
    if args.captions.endswith(".json"):
        with open(args.captions) as f:
            captions = [a["caption"] for a in json.load(f).get("annotations", [])]
    else:
        with open(args.captions) as f:
            captions = [line.strip() for line in f if line.strip()]
    all_captions = captions[:args.num_images]
    global_indices = list(range(len(all_captions)))[args.task_id::args.num_tasks]
    captions = all_captions[args.task_id::args.num_tasks]

    out = {}
    if captions:
        pipe = PipelineMuse.from_pretrained(args.model, device=device,
                                            transformer_dtype=default_dtype(device))
        out["images_per_s"] = generate_and_save_images(
            pipe, captions, args.output_dir, args.batch_size, args.timesteps,
            args.guidance_scale, seed=args.task_id, global_indices=global_indices)
    if args.real_dir and args.num_tasks == 1:
        out["fid"], out["backend"] = compute_fid(args.real_dir, args.output_dir,
                                                 clip_model=args.clip_model, device=device)
    if args.clip_score:
        out["clip_score"] = compute_clip_score(args.output_dir, all_captions, args.clip_model,
                                               device=device)
    return out


if __name__ == "__main__":
    main()
