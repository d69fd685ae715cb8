"""Micro-batched serving loop over a pipeline checkpoint.

Counterpart of the JAX package's ``examples/serving.py``:

* the whole text-to-image request (CLIP encode, 12-step CFG decode, VQ
  decode) is one replayed CUDA graph at a fixed batch size
  (``PipelineMuse.compile_text2image``), captured once;
* prompts are micro-batched up to ``--batch-size`` (a short batch is padded
  with empty prompts, so the graph is never captured again);
* each batch reports its latency and images/s (host clock around the
  synchronised call).

    python -m open_muse_tpu_torch.examples.serving --checkpoint PIPELINE_DIR [--batch-size 4]
    echo "a cat in a spacesuit" | python -m open_muse_tpu_torch.examples.serving --checkpoint DIR
    python -m open_muse_tpu_torch.examples.serving --checkpoint DIR --prompts prompts.txt

``--checkpoint`` is a ``save_pretrained`` pipeline directory (``text_encoder/``,
``vae/``, ``transformer/``); ``--device cpu`` serves on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

__all__ = ["main"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--timesteps", type=int, default=12)
    p.add_argument("--guidance-scale", type=float, default=8.0)
    p.add_argument("--seq-len", type=int, default=256, help="the transformer's token count")
    p.add_argument("--prompts", default=None, help="one prompt a line (default: stdin)")
    p.add_argument("--resolution", type=int, default=None,
                   help="the micro-conds' image size (default sqrt(seq_len) * 16, the f16 VQ's)")
    p.add_argument("--out-dir", default="serve_out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="bfloat16", help="the transformer's dtype")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..core.modeling import resolve_device
    from ..pipelines.pipeline_muse import PipelineMuse

    device = resolve_device(args.device)
    pipe = PipelineMuse.from_pretrained(args.checkpoint, device=device,
                                        transformer_dtype=getattr(torch, args.dtype))
    fused = pipe.compile_text2image(batch_size=args.batch_size, timesteps=args.timesteps,
                                    guidance_scale=args.guidance_scale, seq_len=args.seq_len)
    res = args.resolution or int(args.seq_len ** 0.5) * 16
    micro = torch.tensor([[res, res, 0, 0, 6.0]] * args.batch_size, dtype=torch.float32)
    generator = torch.Generator().manual_seed(args.seed)

    def synced(fn):
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    print(f"capturing the request graph (batch={args.batch_size}, {args.timesteps} steps)...",
          flush=True)
    t0 = time.perf_counter()
    synced(lambda: fused(pipe._tokenize([""] * args.batch_size), micro, generator))
    print(f"captured in {time.perf_counter() - t0:.1f}s; serving", flush=True)

    os.makedirs(args.out_dir, exist_ok=True)
    src = open(args.prompts) if args.prompts else sys.stdin
    stats = []

    def flush(pending):
        real = len(pending)
        batch = pending + [""] * (args.batch_size - real)  # padded: the same graph
        ids = pipe._tokenize(batch)
        t0 = time.perf_counter()
        pixels = synced(lambda: fused(ids, micro, generator))
        dt = time.perf_counter() - t0
        pixels = pixels.float().cpu().numpy()
        served = sum(s["images"] for s in stats)
        for i in range(real):
            PipelineMuse.to_pil_image(pixels[i]).save(
                os.path.join(args.out_dir, f"{served + i:05d}.png"))
        stats.append({"images": real, "ms": dt * 1e3, "images_per_s": real / dt})
        print(f"batch of {real}: {dt * 1e3:.1f} ms ({real / dt:.2f} img/s) -> {args.out_dir}",
              flush=True)

    pending = []
    for line in src:
        prompt = line.strip()
        if not prompt:
            continue
        pending.append(prompt)
        if len(pending) == args.batch_size:
            flush(pending)
            pending = []
    if pending:
        flush(pending)
    if src is not sys.stdin:
        src.close()
    print(f"served {sum(s['images'] for s in stats)} images")
    return stats


if __name__ == "__main__":
    main()
