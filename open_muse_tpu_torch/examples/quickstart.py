"""Quickstart: train a tiny text-to-image stack on synthetic data, then sample.

Counterpart of the JAX package's ``examples/quickstart.py``, offline, a
minute or two on the CPU or seconds on one GPU:

    python -m open_muse_tpu_torch.examples.quickstart [--device cpu] [--workdir DIR]

It (1) writes a synthetic webdataset shard of coloured squares with
captions, (2) saves a seeded tiny MaskGIT VQGAN and CLIP text tower with
``save_pretrained``, (3) trains a tiny ``MaskGiTUViT_v2`` over them for
``--steps`` steps through the trainer CLI (``training.train_muse.main``,
checkpoints at the half and the end; on the card the step runs under bf16
autocast, the kernels' type), and (4)
reloads the checkpoint with the two towers through
``PipelineMuse.from_pretrained`` and samples a prompt into ``sample.png``.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import tarfile
import tempfile

import numpy as np
import torch
import yaml

__all__ = ["VQ_PARAMS", "CLIP_PARAMS", "TRANSFORMER", "make_synthetic_shard", "main"]

VQ_PARAMS = {"resolution": 32, "hidden_channels": 32, "channel_mult": [1, 2],
             "num_res_blocks": 1, "z_channels": 16, "num_embeddings": 64,
             "quantized_embed_dim": 16}
CLIP_PARAMS = {"vocab_size": 256, "hidden_size": 32, "intermediate_size": 64,
               "num_hidden_layers": 2, "num_attention_heads": 4,
               "max_position_embeddings": 16, "projection_dim": 24}
TRANSFORMER = {"hidden_size": 64, "cond_embed_dim": 24, "micro_cond_encode_dim": 8,
               "micro_cond_embed_dim": 40, "encoder_hidden_size": 32, "vocab_size": 68,
               "codebook_size": 64, "in_channels": 32, "block_out_channels": [32],
               "num_res_blocks": 1, "block_num_heads": 2, "num_hidden_layers": 2,
               "num_attention_heads": 4, "intermediate_size": 96}
COLORS = {"red": (200, 40, 40), "green": (40, 200, 40), "blue": (40, 40, 200),
          "yellow": (220, 220, 40)}


def make_synthetic_shard(path: str, n: int = 24) -> None:
    """``n`` 32px JPEGs of noisy coloured squares, each with its caption."""
    from PIL import Image

    names = list(COLORS)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            color = names[i % len(names)]
            arr = np.zeros((32, 32, 3), np.uint8)
            arr[:] = COLORS[color]
            arr += np.random.RandomState(i).randint(0, 30, arr.shape).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG")
            for ext, data in [("jpg", buf.getvalue()), ("txt", f"a {color} square".encode()),
                              ("json", json.dumps({"width": 32, "height": 32}).encode())]:
                info = tarfile.TarInfo(f"{i:05d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--workdir", default=None, help="default: a new temporary directory")
    parser.add_argument("--steps", type=int, default=20)
    args = parser.parse_args(argv)

    from ..core.modeling import resolve_device
    from ..models.clip_text import CLIPTextEncoder
    from ..models.maskgit_vqgan import MaskGitVQGAN
    from ..pipelines.pipeline_muse import PipelineMuse
    from ..training.train_muse import main as train_main

    device = resolve_device(args.device)
    workdir = args.workdir or tempfile.mkdtemp(prefix="muse_quickstart_")
    os.makedirs(workdir, exist_ok=True)
    shard = os.path.join(workdir, "data-000.tar")
    make_synthetic_shard(shard)
    vq_dir, clip_dir = os.path.join(workdir, "vae"), os.path.join(workdir, "text_encoder")
    torch.manual_seed(0)
    MaskGitVQGAN(**VQ_PARAMS).save_pretrained(vq_dir)
    CLIPTextEncoder(**CLIP_PARAMS).save_pretrained(clip_dir)
    out_dir = os.path.join(workdir, "run")
    config = {
        "experiment": {"name": "quickstart", "output_dir": out_dir,
                       "save_every": max(1, args.steps // 2),
                       "generate_every": args.steps, "log_every": 5,
                       "resume_from_checkpoint": None},
        "model": {"vq_model_type": "maskgit_vqgan",
                  "vq_model": {"pretrained": vq_dir},
                  "text_encoder": {"pretrained": clip_dir},
                  "transformer": TRANSFORMER},
        "dataset": {"params": {"train_shards_path_or_url": shard, "shuffle_buffer_size": 16,
                               "resolution": 32}},
        "optimizer": {"name": "adamw", "params": {"learning_rate": 3e-4}},
        "lr_scheduler": {"scheduler": "constant_with_warmup", "params": {"warmup_steps": 5}},
        "training": {"batch_size": 4, "max_train_steps": args.steps, "seed": 0,
                     "use_ema": False, "cond_dropout_prob": 0.1,
                     "mixed_precision": "bf16" if device.type == "cuda" else "no"},
        "device": device.type,
    }
    cfg_path = os.path.join(workdir, "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config, f)

    print(f">> training {args.steps} steps in {out_dir}", flush=True)
    train_main([f"config={cfg_path}"])

    print(">> sampling from the checkpoint", flush=True)
    pipe = PipelineMuse.from_pretrained(
        text_encoder_path=clip_dir, vae_path=vq_dir,
        transformer_path=os.path.join(out_dir, f"checkpoint-{args.steps}", "unwrapped_model"),
        transformer_dtype=torch.bfloat16 if device.type == "cuda" else torch.float32,
        device=device)
    images = pipe("a red square", timesteps=4, guidance_scale=2.0,
                  generator=torch.Generator().manual_seed(0))
    out_png = os.path.join(workdir, "sample.png")
    images[0].save(out_png)
    print(f">> wrote {out_png}", flush=True)
    return out_png


if __name__ == "__main__":
    main()
