"""Micro-benchmark of ``MaskGiTUViT_v2.generate2`` at bf16 and fp32.

Counterpart of the JAX package's ``scripts/benchmark_models.py``: the v2
model at its research defaults (or ``--model-config`` overrides, a JSON
object), seeded weights, text states (B, 77, encoder_hidden_size), 12-step
CFG 8 decodes through ``generate2`` (one replayed CUDA graph a call on the
card), one JSON line a setting: ``{"setting", "timesteps", "batch_size",
"median_ms"}`` (host clock around a synchronised call, the median of
``--iters`` after a warm-up call that captures the graph).  The card's
norm and attention kernels take bf16, so on the card the fp32 setting holds
fp32 weights and decodes under bf16 autocast, as the trainers' mixed
precision runs (its line says ``"compute": "bf16 autocast"``); the CPU
computes it in fp32.  A user's script: it times one model, not the
system.

    python -m open_muse_tpu_torch.scripts.benchmark_models [--timesteps 12] [--batch-size 1] \\
        [--iters 6] [--device cpu] [--model-config '{"num_hidden_layers": 2}']
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from ..core.modeling import resolve_device
from ..models.transformer_v2 import MaskGiTUViT_v2

__all__ = ["bench_generate", "main"]

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def bench_generate(dtype_name: str, timesteps: int, batch_size: int, iters: int = 6,
                   device="cuda", model_config=None) -> float:
    """Median ms of ``iters`` seeded ``generate2`` calls after a warm-up."""
    device = resolve_device(device)
    dtype = DTYPES[dtype_name]
    torch.manual_seed(0)
    with torch.device(device):
        model = MaskGiTUViT_v2(MaskGiTUViT_v2.config_from_dict(model_config or {}))
    model = model.to(dtype).eval()
    cfg = model.config
    gen = torch.Generator(device).manual_seed(0)
    ehs = torch.randn(batch_size, 77, cfg.encoder_hidden_size, generator=gen, device=device,
                      dtype=dtype)
    pooled = torch.randn(batch_size, cfg.cond_embed_dim, generator=gen, device=device,
                         dtype=dtype)
    micro = torch.tensor([[512, 512, 0, 0, 6.0]] * batch_size, device=device)
    side = 16
    autocast = torch.autocast("cuda", dtype=torch.bfloat16,
                              enabled=device.type == "cuda" and dtype == torch.float32)

    def call(seed):
        with autocast:
            out = model.generate2(ehs, pooled, micro, empty_embeds=ehs[:1],
                                  empty_cond_embeds=pooled[:1], timesteps=timesteps,
                                  guidance_scale=8.0, seq_len=side * side,
                                  generator=torch.Generator().manual_seed(seed))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    call(0)  # builds the kernels and captures the graph
    times = []
    for i in range(iters):
        t0 = time.perf_counter()
        call(i + 1)
        times.append((time.perf_counter() - t0) * 1000)
    return statistics.median(times)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--timesteps", type=int, default=12)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--iters", type=int, default=6)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--model-config", default=None,
                        help="JSON overrides of MaskGiTUViT_v2's research defaults")
    args = parser.parse_args(argv)
    overrides = json.loads(args.model_config) if args.model_config else None
    lines = []
    for dtype_name in ("bf16", "fp32"):
        ms = bench_generate(dtype_name, args.timesteps, args.batch_size, args.iters,
                            args.device, overrides)
        lines.append({"setting": dtype_name, "timesteps": args.timesteps,
                      "batch_size": args.batch_size, "median_ms": round(ms, 2)})
        if dtype_name == "fp32" and resolve_device(args.device).type == "cuda":
            lines[-1]["compute"] = "bf16 autocast"
        print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
