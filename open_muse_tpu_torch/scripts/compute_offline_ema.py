"""Reconstruct an EMA model after the fact from a series of checkpoints.

Counterpart of the JAX package's ``scripts/compute_offline_ema.py``: walks
``checkpoint-*/`` in step order, reads each ``unwrapped_model/`` through the
model class's ``from_pretrained``, folds it into ``training.ema.EMA`` (the
first checkpoint starts the shadow; the k-th later one moves it with the
decay at optimization step k, ``ema_decay``), and writes the shadow as a
``save_pretrained`` directory whose ``config.json`` also holds the EMA's
settings, as the JAX ``EMAModel.save_pretrained`` writes them.

    python -m open_muse_tpu_torch.scripts.compute_offline_ema \\
        --checkpoints-dir runs/exp1 --output runs/exp1/offline_ema [--decay 0.9999] \\
        [--model-class MaskGiTUViT_v2] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..models.maskgit_vqgan import MaskGitVQGAN
from ..models.movq import MOVQ
from ..models.paella_vq import PaellaVQModel
from ..models.taming_vqgan import VQGANModel
from ..models.transformer_v1 import MaskGitTransformer
from ..models.transformer_v2 import MaskGiTUViT_v2
from ..training.ema import EMA, ema_decay

__all__ = ["MODEL_CLASSES", "main"]

MODEL_CLASSES = {cls.__name__: cls for cls in (MaskGiTUViT_v2, MaskGitTransformer, MaskGitVQGAN,
                                               VQGANModel, MOVQ, PaellaVQModel)}


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoints-dir", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--decay", type=float, default=0.9999)
    parser.add_argument("--model-class", default="MaskGiTUViT_v2", choices=sorted(MODEL_CLASSES))
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    model_cls = MODEL_CLASSES[args.model_class]

    dirs = sorted((d for d in os.listdir(args.checkpoints_dir) if d.startswith("checkpoint-")),
                  key=lambda d: int(d.split("-")[1]))
    ema = model = None
    step = 0
    for d in dirs:
        path = os.path.join(args.checkpoints_dir, d, "unwrapped_model")
        if not os.path.isdir(path):
            continue
        model = model_cls.from_pretrained(path, device=args.device)
        if ema is None:
            ema = EMA(model, decay=args.decay)
        else:
            step += 1
            ema.set_step(step)
            ema.update(model)
        print(f"folded {d} (decay now {ema_decay(step, args.decay):.6f})")
    if ema is None:
        raise SystemExit(f"no checkpoint-*/unwrapped_model in {args.checkpoints_dir}")

    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(ema.shadow[name])
    model.save_pretrained(args.output)
    cfg_path = os.path.join(args.output, "config.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg.update({"decay": args.decay, "min_decay": 0.0, "optimization_step": step,
                "update_after_step": 0, "update_every": 1, "use_ema_warmup": False,
                "inv_gamma": 1.0, "power": 2 / 3})
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=2, sort_keys=True)
    print(f"saved offline EMA to {args.output}")
    return args.output


if __name__ == "__main__":
    main()
