"""Smoke run of the PyTorch port on one NVIDIA GPU.

Builds the port's CUDA kernels from ``open_muse_tpu_torch/csrc``, holds each
forward and backward kernel against its plain PyTorch version at the shapes
of its path (each timed, with its plain version, by replaying calls from a
CUDA graph: device time without the host's enqueue), then drives the port's
paths at full width with seeded random weights.  Every request path answers
through its captured entry point (one replayed CUDA graph a request,
``core.captured``) and, on the same three seeds, with its decode loop called
directly (eager); the token ids of the two must be equal:

- serving: three 256px / batch-1 / 12-step CFG text-to-image requests through
  ``PipelineMuse.text2image`` (one graph: text tower, decode, VQGAN decode);
- serving_nocfg: three such requests at guidance 0 (the CFG-free sampler);
- inpainting: three 256px / batch-1 / 12-step CFG requests through
  ``PipelineMuseInpainting.inpaint`` (one graph: the VQGAN encoder and
  ``vq_argmin``, the decode, the VQGAN decode);
- pre_encode: ``scripts.pre_encode.main`` over a synthetic shard of 1024
  seeded 256px images with captions, models loaded by ``from_pretrained``;
- class_conditional: three 256px / batch-1 / 8-step ImageNet class-id
  requests through ``PipelineMuse(is_class_conditioned=True)`` with the v1
  ``MaskGitTransformer`` of ``configs/imagenet.yaml`` and the MaskGIT VQGAN
  (the decode one graph);
- class_inpainting: three such requests through
  ``PipelineMuseInpainting(image, mask, class_ids=...)``, the MaskGIT VQGAN
  encoder's ``vq_argmin`` at K 1024;
- movq_class: three 256px / batch-1 / 8-step class-id requests with the v1
  transformer of ``configs/imagenet_movq.yaml`` (1025 tokens: kernel 5's
  two-pass variant) and a MOVQ at its published widths, then a MOVQ
  ``get_code`` round trip (``vq_argmin`` at C 4, K 16384);
- movq_text: three 256px / batch-1 / 12-step CFG text requests with the v1
  transformer of ``configs/cc12m_movq.yaml``, a T5 tower at
  google/t5-v1_1-large's widths (bf16 against fp32 first) and the MOVQ;
- paella: ``scripts.pre_encode.main`` over the pre-encode phase's 1024
  images with the taming f16 VQGAN and ``--vae-f8`` a full-width Paella
  VQ, then Paella ``decode_code`` of one batch of the written ids;
- training: ``training.train_muse.main`` on ``configs/laiona6plus_uvit_clip.yaml``
  at batch 16 on a seeded synthetic pre-encoded shard (one repeated batch),
  one replayed CUDA graph a step, then a resume from its checkpoint; before
  it, one forward and backward with the kernels against one with the plain
  versions;
- train_eq: the captured train step against its eager body on one seeded
  full-width state, 4 steps, without and with gradient accumulation 2;
  dots: one step each of no, full and 'dots' checkpointing;
- train_raw: ``train_muse.main`` on the same config's raw-image branch (the
  CLIP-L tower and f16 VQGAN encode every batch, ``vq_argmin`` once a batch,
  CFG cond dropout) with eval, the sample panel, the grad-norm lines, the
  bucket diagnostics and a profiler window, then a resume;
- train_class: ``training.train_maskgit_imagenet.main`` on
  ``configs/imagenet.yaml`` (the v1 model, 24 x 768) at batch 64 over seeded
  256px PNGs with class ids, the MaskGIT VQGAN encoding every batch
  (``vq_argmin`` at K 1024), the class-id sample panel twice, then a resume;
  the encode and the step timed apart; ``[train_eq]`` for the class step and
  ``[v1_dropout]`` (one captured class step at dropout 0.1: the masks drawn
  in the graph, fresh at every replay);
- train_v1_text: ``train_muse.main`` on ``configs/cc12m.yaml`` (the v1 model
  with cross-attention, 24 x 1024, ``architecture: transformer``) on a seeded
  pre-encoded shard at batch 64 with CFG cond dropout, then a resume and
  ``[train_eq]`` for the v1 text step;
- train_vqgan: ``training.train_vqgan.main`` on ``configs/vqgan_gan.yaml``
  (the MaskGIT VQGAN, the perceptual term, the hinge PatchGAN) at batch 8
  over 1024 seeded PNGs, 8 steps, disc_start 4: one replayed CUDA graph a
  step holding both players and ``vq_argmin``; the recon panel and both
  checkpoints, the saved VQ reloaded; ``[train_eq]`` for the VQGAN step;
- train_soft: ``train_muse.main`` on the flagship config's raw branch with
  ``use_soft_code_target`` (soft targets (16, 256, 8192) from the f16 VQGAN's
  ``get_soft_code``), 8 steps; ``[train_eq]`` for the soft-target step;
- train_opt: the training phase's step with ``8bit_adamw``, ``bf16_adamw``
  and ``lion`` (AdamW timed beside them): captured against eager, the loss
  falling, step time, peak memory, the optimizer state's bytes, a resume;
- train_movq_class: ``train_maskgit_imagenet.main`` on
  ``configs/imagenet_movq.yaml`` (1025 tokens: kernel 5's two-pass variant
  in training; a MOVQ: ``vq_argmin`` at C 4), 8 steps;
- distill: ``training.distill.main`` on ``configs/distill.yaml`` at batch 64
  (a 12-step CFG teacher at 128 rows a step, the flagship model seeded and
  saved as its checkpoint), 8 steps, the checkpoint reloaded; the captured
  step against its eager body, the teacher's and the student's shares of a
  step; then distilled: three 6-step CFG-free requests of the student
  through ``distilled_generate``.  The kernel checks also time kernels 4,
  7, 9 and 10 at the teacher's shapes, and train_raw runs the inpainting
  panel.  distill's checkpoint (unwrapped_model/ and ema_model/) is read by
  ``PipelineMuse.from_pretrained`` and answers a request from each;
- eval: a seeded CLIP ViT-L/14 + CLIP-L scorer saved as a full CLIPModel
  directory and read back by ``CLIPScorer.from_pretrained`` (the tower's
  kernels against its plain attention, 24 kernel-5 launches a forward,
  images/s, a profiled forward); ``scripts.calculate_fid.main`` over the
  serving pipeline saved by ``save_pretrained``: 64 captions, CLIP-FID
  against 64 seeded PNGs and the CLIP score; the seeded InceptionV3's FID
  and Inception Score at 299 px on both sets;
- gen_synthetic: ``scripts.gen_synthetic_dataset.main``, 8 prompts x 4
  candidates, read back through ``sdxl_synthetic_dataset_map``;
- quality: ``eval.quality_regression.run_quality_regression`` at its
  defaults with the Inception graph (trained beats untrained);
- distill_midscale: ``eval.distill_midscale.run_distill_midscale`` at
  ``MIDSCALE_CUT``.  Every eval number comes from seeded weights: a
  regression number, not a published metric.  The kernel checks hold
  kernel 5 at the eval stacks' head dims 16 and 32 and at ViT-L/14's
  shapes too (``EVAL_FLASH_SHAPES``).

Each path runs with the launch counters set to 0 just before it and read
just after; the run fails unless every kernel of the path launched exactly
as often as the path needs.  Exits non-zero on any failure or without a GPU.

    python3 chip_smoke.py                 # one GPU; a few minutes on an H100
    python3 chip_smoke.py --gemm-sweep    # only the Hopper GEMM's variants, vq_argmin's widths

The second-to-last line is the kernel report as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

SOURCES = {
    "attn_sublayer_self": ("open_muse_tpu_torch/csrc/attn_sublayer.cu",
                           "open_muse_tpu/ops/pallas/attn_sublayer.py:806"),
    "attn_sublayer_cross": ("open_muse_tpu_torch/csrc/attn_sublayer.cu",
                            "open_muse_tpu/ops/pallas/attn_sublayer.py:846"),
    "glu_down_matmul": ("open_muse_tpu_torch/csrc/glu_matmul.cu",
                        "open_muse_tpu/ops/pallas/glu_matmul.py:275"),
    "fused_categorical_cfg": ("open_muse_tpu_torch/csrc/fused_sample.cu",
                              "open_muse_tpu/ops/pallas/fused_sample.py:302"),
    "attn_sublayer_self_bwd": ("open_muse_tpu_torch/csrc/attn_sublayer.cu",
                               "open_muse_tpu/ops/pallas/attn_sublayer.py:599"),
    "attn_sublayer_cross_bwd": ("open_muse_tpu_torch/csrc/attn_sublayer.cu",
                                "open_muse_tpu/ops/pallas/attn_sublayer.py:637"),
    "glu_down_matmul_bwd": ("open_muse_tpu_torch/csrc/glu_matmul.cu",
                            "open_muse_tpu/ops/pallas/glu_matmul.py:189"),
    "fused_categorical": ("open_muse_tpu_torch/csrc/fused_sample.cu",
                          "open_muse_tpu/ops/pallas/fused_sample.py:119"),
    "vq_argmin": ("open_muse_tpu_torch/csrc/vq_argmin.cu",
                  "open_muse_tpu/ops/pallas/vq_argmin.py:66"),
    "fused_residual_rmsnorm": ("open_muse_tpu_torch/csrc/fused_norm.cu",
                               "open_muse_tpu/ops/pallas/fused_norm.py:105"),
    "fused_residual_layernorm": ("open_muse_tpu_torch/csrc/fused_norm.cu",
                                 "open_muse_tpu/ops/pallas/fused_norm.py:112"),
    "flash_attention": ("open_muse_tpu_torch/csrc/flash_attention.cu",
                        "open_muse_tpu/ops/pallas/flash_attention.py:60"),
}

# the least time the card could take for a kernel's work (H100 SXM datasheet
# rates at 700 W): bytes moved over the memory rate, operations over the peak
# rate of their type; the larger of the two
HBM_BYTES_PER_S = 3.35e12
# int32: not on the data sheet; one integer pipe's lanes, 132 SMs x 64 an SM
# (the Hopper architecture white paper: 16 INT32 lanes a sub-partition; the
# CUDA C++ Programming Guide's throughput table: 64 results a clock an SM on
# compute capability 9.0 for 32-bit integer multiply-add and for bitwise
# operations) x the 1.98 GHz boost clock
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12, "int32": 132 * 64 * 1.98e9}
BOUNDS = {}  # kernel -> (bytes, operations, type), from the timed inputs
# kernel -> ms of one PyTorch call computing the same function on the timed
# inputs (a yardstick only: the port never calls it)
LIBRARY_MS = {}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_of(moved, ops, kind):
    """(ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[kind] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bound_ms(name):
    return bound_of(*BOUNDS[name])


def zero_counts() -> dict:
    """Every launch counter at 0: the 12 kernels' wrappers and kernel 5's
    two-pass variant, counted apart."""
    from open_muse_tpu_torch import kernels

    return {name: 0 for name in kernels.launch_counts()}


def log(msg: str) -> None:
    print(msg, flush=True)


@functools.lru_cache(maxsize=None)
def _warm_up_stream() -> torch.cuda.Stream:
    """One side stream for every graph warm-up: cuBLAS keeps a workspace
    for each stream it has run on."""
    return torch.cuda.Stream()


def graph_ms(fn, reps: int = 20, trials: int = 7) -> float:
    """Device time of one call: median over ``trials`` of the mean of
    ``reps`` calls replayed from one captured CUDA graph, by CUDA events.
    The replay has no host enqueue in it, so a call of a few microseconds
    is timed as the device runs it, launch gaps included."""
    stream = _warm_up_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm-up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def errors(got, ref):
    diff = (got.float() - ref.float()).abs()
    max_abs = diff.max().item()
    return max_abs, max_abs / max(ref.float().abs().max().item(), 1e-30)


# -- phase 3: each kernel against its plain version -------------------------

def launch_split(fn, calls: int = 10):
    """Device time of each kernel one call of ``fn`` launches, in launch
    order: (name, median microseconds) from a torch.profiler trace of
    ``calls`` eager calls.  Kernel time only, without the gaps between
    launches that a graph replay also counts.  Run it after the graph
    timings: once the profiler has run, a graph replay in the same process
    reads 0.3 - 0.6 us slower a launch."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.name.startswith(("Memcpy", "Memset"))),
                     key=lambda e: e.time_range.start)
    # the trace may miss the window's first event: whole calls from the end
    per = round(len(kernels) / calls)
    groups = ([kernels[i:i + per] for i in range(len(kernels) % per, len(kernels), per)]
              if per else [])
    if not groups or any([e.name for e in g] != [e.name for e in groups[0]] for g in groups):
        log(f"[split] {len(kernels)} kernel events for {calls} calls do not split into calls")
        return []

    def short(raw):  # "void muse::sm90::wgmma_gemm_kernel<64, ...>(...)" -> "wgmma_gemm_kernel<64>"
        name = raw.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
        base, _, args = name.partition("<")
        # the Hopper GEMM reading its weight MN-major (a @ w), and A too (a.T @ w)
        a_mn = "ALayout)1" in raw or "::kKM" in raw
        w_mn = "WLayout)1" in raw or "::kKN" in raw
        return (base.split("::")[-1] + (f"<{args.split(',')[0].rstrip('>')}>" if args else "")
                + (" a.T@w" if a_mn else " a@w" if w_mn else ""))

    return [(short(groups[0][i].name),
             statistics.median(g[i].time_range.elapsed_us() for g in groups)) for i in range(per)]


def log_split(label, fn):
    split = launch_split(fn)
    parts = ", ".join(f"{name} {us:.2f}" for name, us in split) or "not measured"
    log(f"[split] {label}, device us a launch (torch.profiler, median of ~10 calls): {parts}; "
        f"sum {sum(us for _, us in split):.2f}")


def _gemm_pair(layout, a, w):
    """(the Hopper GEMM's call, cuBLAS's call) of one layout on a and w."""
    from open_muse_tpu_torch.kernels.gemm import linear_nn, linear_tn, linear_tnn

    return {"a @ w.T": (lambda *v: linear_tn(a, w, *v), lambda: a @ w.t()),
            "a @ w": (lambda *v: linear_nn(a, w, *v), lambda: a @ w),
            "a.T @ w": (lambda *v: linear_tnn(a, w, *v), lambda: a.t() @ w)}[layout]


def log_product_alone(label, a, w, layout="a @ w.T"):
    """The bare product inside a kernel, ``a @ w.T``, ``a @ w`` (the weight
    read MN-major) or ``a.T @ w`` (both read MN-major) on the same bf16
    operands: the port's Hopper GEMM alone beside cuBLAS (graph replay).
    Not a library_ms: no single call computes a kernel's whole function."""
    ours, cublas = _gemm_pair(layout, a, w)
    ours, cublas = graph_ms(ours), graph_ms(cublas)
    log(f"[product] {label} {layout}, a {tuple(a.shape)} w {tuple(w.shape)}, the product "
        f"alone: Hopper GEMM {ours:.4f} ms, cuBLAS torch.matmul {cublas:.4f} ms "
        f"(CUDA graph replay)")
    return ours, cublas


def log_floor(device):
    """What one launch costs by itself: an empty kernel of 1 and of 132
    blocks, by graph replay (20 launches a replay)."""
    from open_muse_tpu_torch.kernels.gemm import null_launch

    one = graph_ms(lambda: null_launch(device, 1))
    full = graph_ms(lambda: null_launch(device, 132))
    log(f"[floor] an empty kernel, device us a launch (CUDA graph replay): 1 block "
        f"{one * 1e3:.3f}, 132 blocks {full * 1e3:.3f}")


def check_glu(device, gen, m, timed=True, splits=None):
    """m rows: 512 when serving (2 x 256 tokens), 4096 when training; other
    row counts check the ragged edge (``timed=False``).  Appends the
    kernel's (label, call) to ``splits`` for a launch split."""
    from open_muse_tpu_torch.kernels.glu_matmul import glu_down_matmul, glu_down_matmul_plain

    k, n = 2816, 1024  # intermediate 2816, hidden 1024
    bf = torch.bfloat16
    a = torch.randn(m, k, generator=gen).to(device, bf)
    b = torch.randn(m, k, generator=gen).to(device, bf)
    wo = (torch.randn(n, k, generator=gen) * k ** -0.5).to(device, bf)
    got, ref = glu_down_matmul(a, b, wo), glu_down_matmul_plain(a, b, wo)
    max_abs, rel = errors(got, ref)
    twice = torch.equal(got, glu_down_matmul(a, b, wo))
    # both against an fp32 product of the same bf16 GLU operand
    hidden = (torch.nn.functional.gelu(a.float()) * b.float()).to(bf)
    exact = hidden.float() @ wo.float().t()
    tol = 2e-2
    ok = rel <= tol and twice and bool(torch.isfinite(got).all())
    log(f"[kernel] glu_down_matmul a,b {tuple(a.shape)} wo {tuple(wo.shape)} bf16: "
        f"max_abs {max_abs:.3e} rel {rel:.3e} (tol rel {tol}: bf16 output rounding and "
        f"sum order); vs fp32 product: kernel {errors(got, exact)[0]:.3e}, plain "
        f"{errors(ref, exact)[0]:.3e}; two calls bit-equal {twice} {'ok' if ok else 'FAIL'}")
    if not timed:
        return ok, max_abs, None
    timing = (graph_ms(lambda: glu_down_matmul(a, b, wo)),
              graph_ms(lambda: glu_down_matmul_plain(a, b, wo)))
    if splits is not None:
        splits.append((f"glu_down_matmul a,b {tuple(a.shape)}", lambda: glu_down_matmul(a, b, wo)))
    log_product_alone("glu_down_matmul", hidden, wo)
    BOUNDS.setdefault("glu_down_matmul", (nbytes(a, b, wo, got), 2 * m * k * n, "bf16"))
    return ok, max_abs, timing


def _sublayer_inputs(device, gen, b=2, s=256, d=1024):
    bf = torch.bfloat16
    rand = lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen) * scale).to(device, bf)  # noqa: E731
    return dict(x=rand(b, s, d), res=rand(b, s, d), ln_scale=1 + rand(d, scale=0.1),
                adaln=rand(b, 2 * d, scale=0.1), wout=rand(d, d, scale=d ** -0.5))


def check_sublayers(device, gen, b, s=256, timed=True, splits=None):
    """b batch rows of s tokens: 2 x 256 when serving (CFG at bs1), 16 x 256
    when training; other token counts check the ragged edge
    (``timed=False``).  Appends both sublayers' (label, call) to ``splits``
    for a launch split."""
    from open_muse_tpu_torch.kernels import attn_sublayer as A

    d, heads, bf = 1024, 16, torch.bfloat16
    results = {}
    inp = _sublayer_inputs(device, gen, b=b, s=s)
    wqkv = (torch.randn(3 * d, d, generator=gen) * d ** -0.5).to(device, bf)
    wq = (torch.randn(d, d, generator=gen) * d ** -0.5).to(device, bf)
    kv = torch.randn(b, 77, 2 * d, generator=gen).to(device, bf)
    cases = {
        "attn_sublayer_self": (
            lambda res: A.attn_sublayer_self(inp["x"], res, inp["ln_scale"], inp["adaln"],
                                             wqkv, inp["wout"], heads),
            lambda res: A.attn_sublayer_self_plain(inp["x"], res, inp["ln_scale"],
                                                   inp["adaln"], wqkv, inp["wout"], heads)),
        "attn_sublayer_cross": (
            lambda res: A.attn_sublayer_cross(inp["x"], res, inp["ln_scale"], inp["adaln"],
                                              wq, inp["wout"], kv, heads),
            lambda res: A.attn_sublayer_cross_plain(inp["x"], res, inp["ln_scale"],
                                                    inp["adaln"], wq, inp["wout"], kv, heads)),
    }
    tol = 3e-2
    for name, (kern, plain) in cases.items():
        ok = True
        worst = 0.0
        for res in (inp["res"], None):
            out, h = kern(res)
            ref, ref_h = plain(torch.zeros_like(inp["x"]) if res is None else res)
            max_abs, rel = errors(out, ref)
            h_equal = torch.equal(h, ref_h)
            again = kern(res)
            twice = torch.equal(out, again[0]) and torch.equal(h, again[1])
            case_ok = rel <= tol and h_equal and twice and bool(torch.isfinite(out).all())
            ok &= case_ok
            worst = max(worst, max_abs)
            log(f"[kernel] {name} x {tuple(inp['x'].shape)} res={'given' if res is not None else 'None'}"
                f"{f' kv {tuple(kv.shape)}' if 'cross' in name else ''} bf16: max_abs {max_abs:.3e} "
                f"rel {rel:.3e} (tol rel {tol}: bf16 roundings of qkv / probs / output), "
                f"residual bit-equal {h_equal}, two calls bit-equal {twice} "
                f"{'ok' if case_ok else 'FAIL'}")
        if not timed:
            results[name] = (ok, worst, None)
            continue
        timing = (graph_ms(lambda: kern(inp["res"])),
                  graph_ms(lambda: plain(inp["res"])))
        results[name] = (ok, worst, timing)
        if splits is not None:
            splits.append((f"{name} x {tuple(inp['x'].shape)}"
                           f"{f' kv {tuple(kv.shape)}' if 'cross' in name else ''}",
                           functools.partial(kern, inp["res"])))
        acts = torch.randn(b, s, d, generator=gen).to(device, bf).reshape(b * s, d)
        w_in = wqkv if "self" in name else wq
        in_ms = log_product_alone(f"{name} {'qkv' if 'self' in name else 'q'} projection", acts,
                                  w_in)
        out_ms = log_product_alone(f"{name} out projection", acts, inp["wout"])
        log(f"[product] {name} both projections, the products alone: Hopper GEMM "
            f"{in_ms[0] + out_ms[0]:.4f} ms, cuBLAS {in_ms[1] + out_ms[1]:.4f} ms")
        # the q(kv) and output projections, and QK^T and PV over the keys
        keys, proj = (s, 4 * d * d) if "self" in name else (77, 2 * d * d)
        ops = 2 * b * s * proj + 4 * b * heads * s * keys * (d // heads)
        moved = nbytes(inp["x"], inp["res"], inp["ln_scale"], inp["adaln"], *kern(inp["res"]),
                       *((wqkv,) if "self" in name else (wq, kv)), inp["wout"])
        BOUNDS.setdefault(name, (moved, ops, "bf16"))
    return results


# Philox calls in the body of the sampler's bf16 Philox instantiation: four
# chunks of eight columns a thread, two calls a chunk (csrc/fused_sample.cu)
PHILOX_CALLS_IN_BODY = 8
_PHILOX_MULTIPLIERS = re.compile(r"0xd2511f53|0xcd9e8d57|-0x2daee0ad|-0x326172a9")
_SASS_REGISTER = re.compile(r"U?R(\d+|Z)$")


@functools.lru_cache(maxsize=None)
def _library_sass() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    from open_muse_tpu_torch.kernels import _build

    lib = _build.library()._name
    out = subprocess.run([os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump"),
                          "-sass", lib], capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise SystemExit(f"chip_smoke: cuobjdump -sass {lib} failed: {out.stderr.strip()[:300]}")
    return out.stdout


@functools.lru_cache(maxsize=None)
def philox_call_instructions(cfg: bool):
    """Per-lane SASS instructions of one Philox4x32-10 call in the timed
    kernel itself, ``sample_kernel<bf16, cfg, true>`` (``cuobjdump -sass``),
    by the pipe they issue on: the FMA pipe's IMAD that multiply by the
    Philox constants, and the ALU pipe's three- and two-input xors (LOP3 0x96
    / 0x3c on registers) and the adds that stand for a product where the
    counter is one more (IADD3, VIADD with a constant).  Uniform-datapath
    instructions (the key schedule, the row's half of the first rounds; once
    a warp), indexing, moves and the Gumbel arithmetic are left out.  The
    explicit-noise instantiations count none of these."""
    mangled = f"sample_kernelI13__nv_bfloat16Lb{int(cfg)}ELb1EE"
    bodies = [part for part in re.split(r"\n\s*Function : ", _library_sass())
              if part.split("\n", 1)[0].find(mangled) >= 0]
    if len(bodies) != 1:
        raise SystemExit(f"chip_smoke: {len(bodies)} SASS functions match {mangled}")
    ops = [m.group(1).strip() for m in
           re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][^;]*);", bodies[0])]
    fma = alu = 0
    for ins in ops:
        op, _, rest = ins.partition(" ")
        args = [a.strip() for a in rest.split(",")]
        if op.startswith("U"):
            continue
        if _PHILOX_MULTIPLIERS.search(rest):
            fma += op.startswith("IMAD")
            alu += not op.startswith("IMAD")
        elif (op == "LOP3.LUT" and len(args) >= 6 and args[4] in ("0x96", "0x3c")
              and all(_SASS_REGISTER.match(a) for a in args[1:4])):
            alu += 1
    per_call = fma / PHILOX_CALLS_IN_BODY, alu / PHILOX_CALLS_IN_BODY
    log(f"[sass] sample_kernel<bf16, {'cfg' if cfg else 'no cfg'}, Philox>: {len(ops)} "
        f"instructions; one Philox4x32-10 call {per_call[0]:.3f} FMA-pipe (IMAD) + "
        f"{per_call[1]:.3f} ALU-pipe (LOP3 xors, IADD3 / VIADD) lane instructions "
        f"({fma} + {alu} over the body's {PHILOX_CALLS_IN_BODY} calls; uniform-datapath work "
        f"left out)")
    if not 15 <= sum(per_call) <= 45:  # 10 rounds of two products and two xors: ~40
        raise SystemExit(f"chip_smoke: {sum(per_call)} Philox instructions a call in {mangled}")
    return per_call


def check_philox_route(name, kern, plain, logits, x, v, device, row=True):
    """The route every decode runs: the kernel's ids with its seed read from
    an int64 device tensor against the plain version fed
    ``philox_gumbel_plain`` for that seed: equal wherever the top-2 gap of x
    + noise exceeds 1e-3 (the two sides' logs may differ by an ulp), sel to
    rel 1e-4.  Then the route's time (the kernel, and the plain version with
    its noise drawn on the card) and its bound: the logits read once, and
    the integer work of one Philox call per four columns.  ``row``: these
    inputs give the kernel's row of the report (its BOUNDS entry)."""
    from open_muse_tpu_torch.kernels.fused_sample import draw_seed, philox_gumbel_plain

    rows = x.shape[0] * x.shape[1]
    seed = draw_seed(torch.Generator().manual_seed(77))
    seed_buffer = torch.tensor([seed], device=device)
    ids, sel = kern(seed=seed_buffer)
    noise = philox_gumbel_plain(seed, rows, v, device=device).reshape(x.shape)
    ref_ids, ref_sel = plain(noise)
    top2 = torch.topk(x + noise, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-3
    ids_ok = bool(((ids == ref_ids) | ~clear).all())
    max_abs, rel = errors(sel, ref_sel)
    ok = ids_ok and rel <= 1e-4
    log(f"[kernel] {name} Philox route logits {tuple(logits.shape)} bf16 against the plain "
        f"version on philox_gumbel_plain: ids equal where the top-2 gap > 1e-3: {ids_ok} "
        f"({int(clear.sum())}/{clear.numel()} rows clear, {int((ids == ref_ids).sum())} equal); "
        f"sel max_abs {max_abs:.3e} rel {rel:.3e} (tol rel 1e-4) {'ok' if ok else 'FAIL'}")
    timing = (graph_ms(lambda: kern(seed=seed_buffer)),
              graph_ms(lambda: plain(philox_gumbel_plain(seed, rows, v, device=device)
                                     .reshape(x.shape))))
    # the two pipes run side by side: the busier one bounds the integer work
    calls = rows * -(-v // 4)
    busier = max(philox_call_instructions(name.endswith("_cfg")))
    work = (nbytes(logits[..., :v], ids, sel), calls * busier, "int32")
    if row:
        BOUNDS[name] = work
    bound, by = bound_of(*work)
    log(f"[time] {name} Philox route{' (the row)' if row else ''} logits "
        f"{tuple(logits.shape)} cropped to {v}: kernel {timing[0]:.4f} ms, plain (noise drawn "
        f"on the card) {timing[1]:.4f} ms (CUDA graph replay); bound {bound:.4f} ms ({by}: "
        f"{work[0] / 1e6:.2f} MB of logits; {calls} Philox calls x {busier:.3f} "
        f"instructions on the busier pipe, {calls * busier / PEAK_OPS_PER_S['int32'] * 1e3:.4f} "
        f"ms)")
    return ok, max_abs, timing


def chi_square(name, kern, v_raw, v_lim, cfg, device):
    """The Philox route's empirical distribution over 2^16 rows of one
    small-vocab row (cropped from v_raw to v_lim columns; 40-byte bf16 rows,
    not 16-byte aligned) against softmax, by chi-square."""
    from scipy.stats import chi2

    rows = 1 << 16
    row = torch.linspace(-2.0, 1.0, v_raw)
    small = row.expand(2 if cfg else 1, rows, v_raw).contiguous().to(device, torch.bfloat16)
    ids_p, sel_p = kern(small, v_lim, torch.Generator().manual_seed(1234 if cfg else 4321))
    probs = torch.softmax(small[0, 0, :v_lim].float(), -1).cpu()
    counts = torch.bincount(ids_p.flatten().long().cpu(), minlength=v_lim).double()
    expected = probs.double() * rows
    stat = float(((counts - expected) ** 2 / expected).sum())
    p_value = float(chi2.sf(stat, v_lim - 1))
    sel_match = torch.allclose(sel_p.flatten().cpu(), probs[ids_p.flatten().long().cpu()],
                               rtol=1e-5, atol=0)
    in_range = bool((ids_p < v_lim).all())
    ok = p_value > 1e-6 and sel_match and in_range
    log(f"[kernel] {name} Philox: {rows} draws over {v_lim} of {v_raw} columns: "
        f"chi2 {stat:.2f} df {v_lim - 1} p {p_value:.3g} (bound p > 1e-6), ids < vocab_limit "
        f"{in_range}, sel == softmax[id] (rtol 1e-5) {sel_match} {'ok' if ok else 'FAIL'}")
    return ok


def check_sampler(device, gen):
    """The CFG sampler at the serving shape, bf16 logits (2, 256, 8192):
    explicit noise (ids equal where the top-2 gap > 1e-3, sel rel 1e-4; its
    own time and bound), the Philox route (the row), the chi-square check."""
    from open_muse_tpu_torch.kernels.fused_sample import (fused_categorical_cfg,
                                                          fused_categorical_cfg_plain)

    b, s, v, guidance = 1, 256, 8192, 8.0
    logits = (torch.randn(2 * b, s, v, generator=gen) * 2).to(device, torch.bfloat16)
    gumbel = -torch.log(-torch.log(torch.rand(b, s, v, generator=gen).clamp_min(1e-30)))
    gumbel = gumbel.to(device)
    ids, sel = fused_categorical_cfg(logits, guidance, v, gumbel=gumbel)
    ref_ids, ref_sel = fused_categorical_cfg_plain(logits, guidance, v, gumbel)
    x = logits.float()
    x = x[b:] + guidance * (x[:b] - x[b:])
    top2 = torch.topk(x + gumbel, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-3
    ids_ok = bool(((ids == ref_ids) | ~clear).all())
    max_abs, rel = errors(sel, ref_sel)
    sel_ok = rel <= 1e-4
    log(f"[kernel] fused_categorical_cfg logits {tuple(logits.shape)} bf16, explicit gumbel: "
        f"ids equal where the top-2 gap > 1e-3: {ids_ok} ({int(clear.sum())}/{clear.numel()} "
        f"rows clear, {int((ids == ref_ids).sum())} equal); sel max_abs {max_abs:.3e} "
        f"rel {rel:.3e} (tol rel 1e-4) {'ok' if ids_ok and sel_ok else 'FAIL'}")
    explicit = (graph_ms(lambda: fused_categorical_cfg(logits, guidance, v, gumbel=gumbel)),
                graph_ms(lambda: fused_categorical_cfg_plain(logits, guidance, v, gumbel)))
    # fp32: the combine (3), x + g (1), the max, the exp and the sum (3)
    moved, ops = nbytes(logits, gumbel, ids, sel), 7 * b * s * v
    log(f"[time] fused_categorical_cfg explicit gumbel: kernel {explicit[0]:.4f} ms, plain "
        f"{explicit[1]:.4f} ms (CUDA graph replay); bound "
        f"{max(moved / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S['fp32']) * 1e3:.4f} ms (the "
        f"logits and the noise read once, {ops} fp32 operations)")
    philox_ok, philox_err, timing = check_philox_route(
        "fused_categorical_cfg",
        lambda seed: fused_categorical_cfg(logits, guidance, v, seed=seed),
        lambda noise: fused_categorical_cfg_plain(logits, guidance, v, noise), logits, x, v,
        device)
    chi_ok = chi_square("fused_categorical_cfg",
                        lambda lg, lim, g: fused_categorical_cfg(lg, guidance, lim, generator=g),
                        20, 16, True, device)
    return ids_ok and sel_ok and philox_ok and chi_ok, max(max_abs, philox_err), timing


def check_categorical(device, gen):
    """The CFG-free sampler at the serving shape, raw bf16 logits (1, 256,
    8256) cropped to the 8192 codes: explicit noise (ids exactly equal, sel
    rel 1e-5; its own time and bound), the Philox route (the row), the
    chi-square check."""
    from open_muse_tpu_torch.kernels.fused_sample import (fused_categorical,
                                                          fused_categorical_plain)

    b, s, v_raw, v = 1, 256, 8256, 8192
    logits = (torch.randn(b, s, v_raw, generator=gen) * 2).to(device, torch.bfloat16)
    gumbel = -torch.log(-torch.log(torch.rand(b, s, v, generator=gen).clamp_min(1e-30)))
    gumbel = gumbel.to(device)
    ids, sel = fused_categorical(logits, v, gumbel=gumbel)
    ref_ids, ref_sel = fused_categorical_plain(logits, v, gumbel)
    ids_ok = torch.equal(ids, ref_ids)
    max_abs, rel = errors(sel, ref_sel)
    sel_ok = rel <= 1e-5
    log(f"[kernel] fused_categorical logits {tuple(logits.shape)} bf16 cropped to {v}, explicit "
        f"gumbel: ids exactly equal {ids_ok} ({int((ids == ref_ids).sum())}/{ids.numel()}); sel "
        f"max_abs {max_abs:.3e} rel {rel:.3e} (tol rel 1e-5: logsumexp order) "
        f"{'ok' if ids_ok and sel_ok else 'FAIL'}")
    explicit = (graph_ms(lambda: fused_categorical(logits, v, gumbel=gumbel)),
                graph_ms(lambda: fused_categorical_plain(logits, v, gumbel)))
    # fp32: x + g (1), the max, the exp and the sum (3); the cropped columns
    moved, ops = nbytes(logits[..., :v], gumbel, ids, sel), 4 * b * s * v
    log(f"[time] fused_categorical explicit gumbel: kernel {explicit[0]:.4f} ms, plain "
        f"{explicit[1]:.4f} ms (CUDA graph replay); bound "
        f"{max(moved / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S['fp32']) * 1e3:.4f} ms (the "
        f"cropped logits and the noise read once, {ops} fp32 operations)")
    philox_ok, philox_err, timing = check_philox_route(
        "fused_categorical", lambda seed: fused_categorical(logits, v, seed=seed),
        lambda noise: fused_categorical_plain(logits, v, noise), logits,
        logits[..., :v].float(), v, device)
    chi_ok = chi_square("fused_categorical",
                        lambda lg, lim, g: fused_categorical(lg, lim, generator=g), 20, 16, False,
                        device)
    return ids_ok and sel_ok and philox_ok and chi_ok, max(max_abs, philox_err), timing


def check_samplers_movq(device, gen):
    """Kernels 3 and 4's Philox route at the MOVQ paths' shapes: 1024 rows
    an image over 16384 codes (two 8192-column segments a row), the class
    model's (1, 1024, 17408) logits and the text model's CFG pair (2, 1024,
    16448), each cropped to the codebook.  {name: (ok, max_abs)}."""
    from open_muse_tpu_torch.kernels.fused_sample import (fused_categorical,
                                                          fused_categorical_cfg,
                                                          fused_categorical_cfg_plain,
                                                          fused_categorical_plain)

    v, out = 16384, {}
    logits = (torch.randn(1, 1024, 17408, generator=gen) * 2).to(device, torch.bfloat16)
    ok, err, _ = check_philox_route(
        "fused_categorical", lambda seed: fused_categorical(logits, v, seed=seed),
        lambda noise: fused_categorical_plain(logits, v, noise), logits,
        logits[..., :v].float(), v, device, row=False)
    out["fused_categorical"] = (ok, err)
    logits = (torch.randn(2, 1024, 16448, generator=gen) * 2).to(device, torch.bfloat16)
    cond, uncond = logits[:1, :, :v].float(), logits[1:, :, :v].float()
    x = uncond + GUIDANCE * (cond - uncond)
    ok, err, _ = check_philox_route(
        "fused_categorical_cfg",
        lambda seed: fused_categorical_cfg(logits, GUIDANCE, v, seed=seed),
        lambda noise: fused_categorical_cfg_plain(logits, GUIDANCE, v, noise), logits, x, v,
        device, row=False)
    out["fused_categorical_cfg"] = (ok, err)
    return out


# the VQ search shapes: a pre-encode batch of 64 images (64 x 256 latent
# rows) and one 256px inpainting request, against the taming VQGAN's
# 8192-code codebook; one 256px class-id inpainting request against the
# MaskGIT VQGAN's 1024 codes, and the class trainer's batch of 64 against
# them; at C 4 (padded to 64 in the split): the MOVQ round trip of 4 images
# (32 x 32 latents) against its 16384 codes, and the Paella's (64 x 64
# latents) of a pre-encode batch of 64 against its 8192; the VQGAN trainer's
# batch of 8 (16 x 16 latents) against configs/vqgan_gan.yaml's 1024 codes
VQ_SHAPES = {"pre_encode": (64 * 256, 256, 8192), "inpainting": (256, 256, 8192),
             "class_inpainting": (256, 256, 1024), "train_raw": (16 * 256, 256, 8192),
             "train_class": (64 * 256, 256, 1024), "movq_class": (4 * 1024, 4, 16384),
             "paella": (64 * 4096, 4, 8192), "vqgan_train": (8 * 256, 256, 1024)}
VQ_RTOL = 1e-5


def check_vq(device, gen, splits=None):
    """vq_argmin against vq_argmin_plain in fp32, TF32 off, at both path
    shapes: ids equal except at rows whose two best plain scores lie within
    VQ_RTOL of the squared distances' scale, where the kernel's pick is
    within that of the minimum; two calls bit-equal.  Appends both calls to
    ``splits`` (the split pass, the GEMM, the unpack by launch); at the
    pre-encode shape, the products alone beside cuBLAS."""
    from open_muse_tpu_torch.kernels.vq_argmin import (SPLIT_PRODUCTS, vq_argmin, vq_argmin_plain,
                                                       vq_near_ties, vq_split)

    ok, timing, worst = True, None, 0.0
    for path, (n, c, k) in VQ_SHAPES.items():
        # latents and codes of one scale, as an encoder's quant_conv output
        # and its codebook are
        z = torch.randn(n, c, generator=gen).to(device)
        cb = torch.randn(k, c, generator=gen).to(device)
        ids = vq_argmin(z, cb)
        again = vq_argmin(z, cb)
        ref = vq_argmin_plain(z, cb)
        near, gap, over = vq_near_ties(ids, z, cb, VQ_RTOL)
        differ = ids != ref
        case_ok = (torch.equal(ids, again) and bool((~differ | near).all())
                   and bool((over[differ] <= 0).all()) and bool(((ids >= 0) & (ids < k)).all()))
        ok &= case_ok
        picked = max(over.max().item() + VQ_RTOL, 0.0)  # the kernel's pick above the minimum
        worst = max(worst, picked)
        log(f"[kernel] vq_argmin z ({n}, {c}) codebook ({k}, {c}) fp32 ({path}): "
            f"{int(differ.sum())} of {n} ids differ from plain, all at near-ties "
            f"{bool((~differ | near).all())}; {int(near.sum())} rows whose best two plain scores "
            f"lie within {VQ_RTOL} of the scale (|z|^2 + max |e|^2), smallest gap "
            f"{gap.min().item():.3e}; the kernel's pick above the plain minimum by at most "
            f"{picked:.3e} of the scale (bound {VQ_RTOL}); two calls bit-equal "
            f"{torch.equal(ids, again)} {'ok' if case_ok else 'FAIL'}")
        ms = (graph_ms(lambda: vq_argmin(z, cb), reps=10, trials=5),
              graph_ms(lambda: vq_argmin_plain(z, cb), reps=10, trials=5))
        split_ops = 12 * n * k * c  # the six bf16 products
        log(f"[time] vq_argmin ({path}, N {n}): kernel {ms[0]:.4f} ms, plain {ms[1]:.4f} ms "
            f"(median, CUDA graph replay); bound {split_ops / PEAK_OPS_PER_S['bf16'] * 1e3:.4f} "
            f"ms (the split route: 12NKC bf16 operations), "
            f"{2 * n * k * c / PEAK_OPS_PER_S['fp32'] * 1e3:.4f} ms for fp32 FMA (2NKC)")
        if splits is not None:
            splits.append((f"vq_argmin z ({n}, {c}) codebook ({k}, {c}) ({path})",
                           functools.partial(vq_argmin, z, cb)))
        if timing is None:  # the pre-encode shape is the kernel's row in the report
            timing = ms
            BOUNDS["vq_argmin"] = (nbytes(z, cb, ids), split_ops, "bf16")
            fp32_ms = graph_ms(lambda: z @ cb.t(), reps=10, trials=5)
            log(f"[product] vq_argmin z @ cb.T fp32 (TF32 off), z {tuple(z.shape)} cb "
                f"{tuple(cb.shape)}, the product alone: cuBLAS torch.matmul {fp32_ms:.4f} ms "
                f"(CUDA graph replay)")
            # the six part products as one K-major product (K = 6 x 256)
            zp, cbp = vq_split(z, cb)
            za, cba = (t.reshape(t.shape[0], 3, -1) for t in (zp, cbp))
            za = torch.cat([za[:, a] for a, _ in SPLIT_PRODUCTS], dim=1)
            cba = torch.cat([cba[:, b] for _, b in SPLIT_PRODUCTS], dim=1)
            log_product_alone("vq_argmin the six split products", za, cba)
            del zp, cbp, za, cba
        del z, cb, ref
    # the report's error column: the worst pick's score gap in units of the scale
    return ok, worst, timing


# the norms' path shapes: v1's 257 tokens (class + 256) and v2's CFG batch of
# 2 x 256 at width 768 with a residual, v2's trunk pre-MLP LayerNorm at 1024
# with one, the v1 trainers' norms at batch 64 (the class model's 768 and
# 3072, the text model's 1024: no residual), v1's 3072-wide mid-MLP norm
# without; the report's row is the last, residual-free shape, where one
# PyTorch call (F.rms_norm / F.layer_norm) computes the same function
NORM_SHAPES = (((1, 257, 768), True), ((2, 256, 768), True), ((2, 256, 1024), True),
               ((64, 257, 768), False), ((64, 257, 3072), False), ((64, 256, 1024), False),
               ((1, 257, 3072), False))
NORM_EPS, NORM_TOL = 1e-6, 1e-2


def check_norms(device, gen):
    """Both fused norms in both stagings against their plain versions in
    bf16 (no bias, as on the paths): out to NORM_TOL (the Pallas staging:
    fp32 arithmetic with one cast at the end; the model staging: the same
    roundings op for op; either way the moments are summed in another order,
    so at most about one bf16 rounding apart), the prenorm sum bit-equal (x
    itself without a residual), two calls bit-equal.  The report's row is the
    model staging, the one the paths run."""
    from torch.nn import functional as F

    from open_muse_tpu_torch.kernels import fused_norm as N

    bf = torch.bfloat16
    cases = {
        "fused_residual_rmsnorm": (
            lambda x, r, w, st: N.fused_residual_rmsnorm(x, r, w, NORM_EPS, staging=st),
            {"pallas": lambda x, r, w: N.fused_residual_rmsnorm_plain(x, r, w, NORM_EPS),
             "model": lambda x, r, w: N.fused_residual_rmsnorm_model_plain(x, r, w, NORM_EPS)},
            lambda x, w: F.rms_norm(x, (x.shape[-1],), w, NORM_EPS), 5),
        "fused_residual_layernorm": (
            lambda x, r, w, st: N.fused_residual_layernorm(x, r, w, None, NORM_EPS, staging=st),
            {"pallas": lambda x, r, w: N.fused_residual_layernorm_plain(x, r, w, None, NORM_EPS),
             "model": lambda x, r, w: N.fused_residual_layernorm_model_plain(x, r, w, None,
                                                                            NORM_EPS)},
            lambda x, w: F.layer_norm(x, (x.shape[-1],), w, None, NORM_EPS), 8),
    }
    results = {}
    for name, (kern, plains, lib, flops) in cases.items():
        ok, worst = True, 0.0
        for shape, with_res in NORM_SHAPES:
            x = (torch.randn(*shape, generator=gen) * 2).to(device, bf)
            res = torch.randn(*shape, generator=gen).to(device, bf) if with_res else None
            w = (1 + 0.1 * torch.randn(shape[-1], generator=gen)).to(device, bf)
            for staging in N.STAGINGS:
                plain = plains[staging]
                out, pre = kern(x, res, w, staging)
                ref, ref_pre = plain(x, res, w)
                max_abs, rel = errors(out, ref)
                pre_ok = torch.equal(pre, ref_pre) and ((pre is x) == (res is None))
                twice = torch.equal(out, kern(x, res, w, staging)[0])
                case_ok = (rel <= NORM_TOL and pre_ok and twice
                           and bool(torch.isfinite(out).all()))
                ok &= case_ok
                worst = max(worst, max_abs)
                ms = (graph_ms(lambda: kern(x, res, w, staging)),
                      graph_ms(lambda: plain(x, res, w)))
                # x (and res) read, out (and prenorm) written, the scale read once
                moved = nbytes(x, res, w, out, None if res is None else pre)
                log(f"[kernel] {name} {staging} staging x {shape} res={'given' if with_res else 'None'}"
                    f" bf16: max_abs {max_abs:.3e} rel {rel:.3e} (tol rel {NORM_TOL}: one bf16 "
                    f"rounding), prenorm bit-equal {pre_ok}, two calls bit-equal {twice}; kernel "
                    f"{ms[0]:.4f} ms, plain {ms[1]:.4f} ms (CUDA graph replay), bound "
                    f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes) {'ok' if case_ok else 'FAIL'}")
        # the last shape, residual-free, in the model staging is the report's row
        lib_ms = graph_ms(lambda: lib(x, w))
        lib_err = errors(lib(x, w), ref)[1]
        log(f"[kernel] {name} library call on x {shape}: {lib_ms:.4f} ms (CUDA graph replay; "
            f"rel {lib_err:.3e} vs plain)")
        LIBRARY_MS[name] = lib_ms
        results[name] = (ok, worst, ms)
        # x read and out written once, the scale read once; fp32 operations
        # a row element: the moments and the affine
        BOUNDS[name] = (nbytes(x, w, out), flops * x.numel(), "fp32")
    return results


# flash attention (b, tq, tk, heads, d): v2's block attention (2 x 256
# queries, 12 heads of 64, the 77 text keys as views into the [k | v]
# projection: both attentions of an AttentionBlock2D) when serving and at the
# training batch of 16; 256 keys at head_dim 64, the split one-pass variant
# that v1 takes at 48; above the one-pass capacity of 288 keys (the two-pass
# variant) the MOVQ configs' 1024-token trunks: the class model's 1025
# tokens at batch 1, the text model's 1024 under CFG (batch 2) and its
# cross-attention over 77 T5 keys; the v1 trainers' batch of 64: the class
# model's self-attention, the text model's self-attention and its
# cross-attention over 32 text keys; last v1's self-attention (257 tokens,
# 16 heads of 48, q / k / v views into the fused projection), the report's
# row
FLASH_SHAPES = ((2, 256, 256, 12, 64), (2, 256, 77, 12, 64), (16, 256, 77, 12, 64),
                (1, 1025, 1025, 16, 64), (2, 1024, 1024, 16, 64), (2, 1024, 77, 16, 64),
                (64, 257, 257, 16, 48), (64, 256, 256, 16, 64), (64, 256, 32, 16, 64),
                (1, 257, 257, 16, 48))
ATTN_TOL = 2e-2


def _attention_inputs(device, gen, b, tq, tk, heads, d):
    bf = torch.bfloat16
    if tq == tk:
        qkv = torch.randn(b, tq, 3 * heads * d, generator=gen).to(device, bf)
        return qkv.reshape(b, tq, 3 * heads, d).chunk(3, dim=2)
    q = torch.randn(b, tq, heads, d, generator=gen).to(device, bf)
    kv = torch.randn(b, tk, 2 * heads * d, generator=gen).to(device, bf)
    return (q, *kv.reshape(b, tk, 2 * heads, d).chunk(2, dim=2))


# kernel 5 at the eval stacks' shapes (B, Tq, Tk, H, D): CLIP ViT-L/14's
# vision tower at batch 2 and at the eval batch 32 (the one-pass variant, two
# warps a row group); head dim 16: the seeded CLIP towers of the quality
# regression (32 px, patch 8: 17 tokens) and of the mid-scale protocol (64 px:
# 65 tokens), the quality trunk's 8 x 8 tokens and its 8 text keys at 16 rows;
# head dim 32: the mid-scale trunk's blocks, 16 x 16 tokens and 8 text keys
# at 32 (CFG) rows
EVAL_FLASH_SHAPES = ((2, 257, 257, 16, 64), (32, 257, 257, 16, 64), (30, 17, 17, 4, 16),
                     (32, 65, 65, 4, 16), (16, 64, 64, 4, 16), (16, 64, 8, 4, 16),
                     (32, 256, 256, 2, 32), (32, 256, 8, 2, 32))


def _flash_case(device, gen, b, tq, tk, heads, d):
    """One shape of kernel 5 against its plain version: (ok, max_abs, (kernel
    ms, plain ms), SDPA ms, (bytes, operations, type))."""
    from torch.nn import functional as F

    from open_muse_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    q, k, v = _attention_inputs(device, gen, b, tq, tk, heads, d)
    out, ref = flash_attention(q, k, v), flash_attention_plain(q, k, v)
    max_abs, rel = errors(out, ref)
    twice = torch.equal(out, flash_attention(q, k, v))
    case_ok = rel <= ATTN_TOL and twice and bool(torch.isfinite(out).all())
    ms = (graph_ms(lambda: flash_attention(q, k, v)),
          graph_ms(lambda: flash_attention_plain(q, k, v)))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    lib_ms = graph_ms(sdpa)
    lib_err = errors(sdpa().transpose(1, 2), ref)[1]
    # q, k, v read and o written once; QK^T and PV
    moved = (nbytes(q, k, v, out), 4 * b * heads * tq * tk * d, "bf16")
    log(f"[kernel] flash_attention q {tuple(q.shape)} k,v {tuple(k.shape)} bf16: max_abs "
        f"{max_abs:.3e} rel {rel:.3e} (tol rel {ATTN_TOL}: summation order, bf16 P), two calls "
        f"bit-equal {twice}; kernel {ms[0]:.4f} ms, plain {ms[1]:.4f} ms, SDPA {lib_ms:.4f} ms "
        f"(CUDA graph replay; rel {lib_err:.3e} vs plain), bound "
        f"{bound_of(*moved)[0]:.4f} ms {'ok' if case_ok else 'FAIL'}")
    return case_ok, max_abs, ms, lib_ms, moved


def check_flash(device, gen):
    """flash_attention against flash_attention_plain in bf16: out to ATTN_TOL
    (the kernel rounds P to bf16 as the plain version does, but sums QK^T,
    the softmax and PV in another order), two calls bit-equal; SDPA on the
    same inputs timed as the library call.  The report row is the last of
    FLASH_SHAPES; EVAL_FLASH_SHAPES (head dims 16, 32 and ViT-L's 64) are
    held and timed too."""
    ok, worst, row = True, 0.0, None
    for shape in FLASH_SHAPES + EVAL_FLASH_SHAPES:
        case_ok, max_abs, ms, lib_ms, moved = _flash_case(device, gen, *shape)
        ok &= case_ok
        worst = max(worst, max_abs)
        if shape in FLASH_SHAPES:
            row = (ms, lib_ms, moved)
    ms, LIBRARY_MS["flash_attention"], BOUNDS["flash_attention"] = row
    return ok, worst, ms


def kernel_phase(device, splits):
    """Every forward kernel against its plain version; appends the calls to
    split by launch to ``splits``."""
    from open_muse_tpu_torch import kernels

    gen = torch.Generator().manual_seed(0)
    log_floor(device)
    report = {"glu_down_matmul": check_glu(device, gen, 2 * TRAIN_S, splits=splits)}
    report.update(check_sublayers(device, gen, 2, splits=splits))
    report["fused_categorical_cfg"] = check_sampler(device, gen)
    report["fused_categorical"] = check_categorical(device, gen)
    for name, (ok, err) in check_samplers_movq(device, gen).items():
        row_ok, row_err, timing = report[name]
        report[name] = (row_ok and ok, max(row_err, err), timing)
    report["vq_argmin"] = check_vq(device, gen, splits)
    report.update(check_norms(device, gen))
    report["flash_attention"] = check_flash(device, gen)
    for name, (ok, err, (ms, plain_ms)) in report.items():
        log(f"[time] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median, "
            f"CUDA graph replay)")
    # the training path runs the forward kernels at batch 16 too
    train = {"glu_down_matmul": check_glu(device, gen, TRAIN_B * TRAIN_S, splits=splits)}
    train.update(check_sublayers(device, gen, TRAIN_B, splits=splits))
    for name, (ok, err, (ms, plain_ms)) in train.items():
        log(f"[time] {name} at the training shapes: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            f"(median, CUDA graph replay)")
    # ragged edges: 300 GLU rows (not a multiple of the tiles), 100 tokens
    ragged = {"glu_down_matmul": check_glu(device, gen, 300, timed=False)}
    ragged.update(check_sublayers(device, gen, 2, s=100, timed=False))
    for name, (ok, err, _) in {**train, **ragged}.items():
        serving_ok, serving_err, timing = report[name]
        report[name] = (serving_ok and ok, max(serving_err, err), timing)
    kernels.reset_launch_counts()
    return report


# -- backward kernels against their plain versions --------------------------

# the training shapes: 16 x 256 tokens, hidden 1024, 16 heads, 77 text keys,
# GLU rows 4096 x intermediate 2816
TRAIN_B, TRAIN_S, HIDDEN, HEADS, KV_LEN, INTER = 16, 256, 1024, 16, 77, 2816
# bf16 inputs on both sides; the kernels keep dh, the logits, the softmax
# statistics and D = rowsum(dO * O) in fp32 where the plain versions round
# their einsum outputs to bf16, and sum in another order: max |error| over
# max |reference| per output
BWD_TOL = 5e-2


def _check_outputs(name, names, got, ref, again, shapes):
    worst, ok = 0.0, True
    for out_name, mine, want, twice in zip(names, got, ref, again):
        max_abs, rel = errors(mine, want)
        equal = torch.equal(mine, twice)
        finite = bool(torch.isfinite(mine).all())
        good = rel <= BWD_TOL and equal and finite
        ok &= good
        worst = max(worst, max_abs)
        log(f"[kernel] {name} {shapes} {out_name} {tuple(mine.shape)}: max_abs {max_abs:.3e} "
            f"rel {rel:.3e} (tol rel {BWD_TOL}), two calls bit-equal {equal}, finite {finite} "
            f"{'ok' if good else 'FAIL'}")
    return ok, worst


def check_glu_bwd(device, gen, splits=None):
    """The GLU backward at the training rows; appends its (label, call) to
    ``splits`` and logs its two products alone."""
    from open_muse_tpu_torch.kernels.glu_matmul import (glu_down_matmul_bwd,
                                                        glu_down_matmul_bwd_plain)

    m, bf = TRAIN_B * TRAIN_S, torch.bfloat16
    a = torch.randn(m, INTER, generator=gen).to(device, bf)
    b = torch.randn(m, INTER, generator=gen).to(device, bf)
    wo = (torch.randn(HIDDEN, INTER, generator=gen) * INTER ** -0.5).to(device, bf)
    g = (torch.randn(m, HIDDEN, generator=gen) * m ** -0.5).to(device, bf)
    got, again = glu_down_matmul_bwd(a, b, wo, g), glu_down_matmul_bwd(a, b, wo, g)
    ok, worst = _check_outputs("glu_down_matmul_bwd", ("da", "db", "dwo"), got,
                               glu_down_matmul_bwd_plain(a, b, wo, g), again,
                               f"a,b {tuple(a.shape)} g {tuple(g.shape)} bf16")
    timing = (graph_ms(lambda: glu_down_matmul_bwd(a, b, wo, g)),
              graph_ms(lambda: glu_down_matmul_bwd_plain(a, b, wo, g)))
    if splits is not None:
        splits.append((f"glu_down_matmul_bwd a,b {tuple(a.shape)} g {tuple(g.shape)}",
                       functools.partial(glu_down_matmul_bwd, a, b, wo, g)))
    hidden = (torch.nn.functional.gelu(a.float()) * b.float()).to(bf)
    ms = [log_product_alone("glu_down_matmul_bwd dh = g @ wo", g, wo, "a @ w"),
          log_product_alone("glu_down_matmul_bwd dwo = g.T @ h", g, hidden, "a.T @ w")]
    log(f"[product] glu_down_matmul_bwd its two products, the products alone: Hopper GEMM "
        f"{sum(m[0] for m in ms):.4f} ms, cuBLAS {sum(m[1] for m in ms):.4f} ms")
    # dh = g wo and dwo = h^T g
    BOUNDS["glu_down_matmul_bwd"] = (nbytes(a, b, wo, g, *got), 4 * m * INTER * HIDDEN, "bf16")
    return ok, worst, timing


def check_sublayer_bwd(device, gen, splits=None):
    """Both sublayer backwards at the training shapes; appends their (label,
    call) to ``splits`` for a launch split."""
    from open_muse_tpu_torch.kernels import attn_sublayer as A

    d, bf = HIDDEN, torch.bfloat16
    rand = lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen) * scale).to(device, bf)  # noqa: E731
    inp = _sublayer_inputs(device, gen, b=TRAIN_B, s=TRAIN_S, d=d)
    wqkv, wq = rand(3 * d, d, scale=d ** -0.5), rand(d, d, scale=d ** -0.5)
    kv = rand(TRAIN_B, KV_LEN, 2 * d)
    g_out, g_res = rand(TRAIN_B, TRAIN_S, d, scale=0.01), rand(TRAIN_B, TRAIN_S, d, scale=0.01)
    common = (inp["ln_scale"], inp["adaln"])
    cases = {
        "attn_sublayer_self_bwd": (
            ("dx", "dres", "dln", "dadaln", "dwqkv", "dwout"),
            lambda res: A.attn_sublayer_self_bwd(inp["x"], res, *common, wqkv, inp["wout"],
                                                 g_out, g_res, HEADS),
            lambda res: A.attn_sublayer_self_bwd_plain(inp["x"], res, *common, wqkv,
                                                       inp["wout"], g_out, g_res, HEADS)),
        "attn_sublayer_cross_bwd": (
            ("dx", "dres", "dln", "dadaln", "dwq", "dwout", "dkv"),
            lambda res: A.attn_sublayer_cross_bwd(inp["x"], res, *common, wq, inp["wout"], kv,
                                                  g_out, g_res, HEADS),
            lambda res: A.attn_sublayer_cross_bwd_plain(inp["x"], res, *common, wq, inp["wout"],
                                                        kv, g_out, g_res, HEADS)),
    }
    results = {}
    for name, (names, kern, plain) in cases.items():
        ok, worst = True, 0.0
        for res in (inp["res"], None):
            shapes = (f"x {tuple(inp['x'].shape)} res={'given' if res is not None else 'None'}"
                      f"{f' kv {tuple(kv.shape)}' if 'cross' in name else ''} bf16")
            ref = plain(torch.zeros_like(inp["x"]) if res is None else res)
            case_ok, case_worst = _check_outputs(name, names, kern(res), ref, kern(res), shapes)
            ok &= case_ok
            worst = max(worst, case_worst)
        timing = (graph_ms(lambda: kern(inp["res"])),
                  graph_ms(lambda: plain(inp["res"])))
        results[name] = (ok, worst, timing)
        if splits is not None:
            splits.append((f"{name} x {tuple(inp['x'].shape)}"
                           f"{f' kv {tuple(kv.shape)}' if 'cross' in name else ''}",
                           functools.partial(kern, inp["res"])))
        # the three products of the kernel, alone
        rows, acts = TRAIN_B * TRAIN_S, rand(TRAIN_B * TRAIN_S, d)
        w_in, tag = (wqkv, "qkv") if "self" in name else (wq, "q")
        ms = [log_product_alone(f"{name} {tag} recompute", acts, w_in),
              log_product_alone(f"{name} dattn = g_out @ Wout", acts, inp["wout"], "a @ w"),
              log_product_alone(f"{name} da = d{tag} @ W{tag}", rand(rows, w_in.shape[0]), w_in,
                                "a @ w")]
        log(f"[product] {name} its three products, the products alone: Hopper GEMM "
            f"{sum(m[0] for m in ms):.4f} ms, cuBLAS {sum(m[1] for m in ms):.4f} ms")
        # the products of this backward, forward recompute included: self
        # recomputes qkv and takes dattn, dWout, dWqkv, da (11 d x d
        # products per row), cross recomputes q and takes dattn, dWout, dWq,
        # da (5); attention recomputes S and O and takes dP, dV, dQ, dK (6)
        keys, proj = (TRAIN_S, 11) if "self" in name else (KV_LEN, 5)
        ops = 2 * rows * proj * d * d + 12 * TRAIN_B * HEADS * TRAIN_S * keys * (d // HEADS)
        moved = nbytes(inp["x"], inp["res"], *common, inp["wout"], g_out, g_res,
                       *((wqkv,) if "self" in name else (wq, kv)), *kern(inp["res"]))
        BOUNDS[name] = (moved, ops, "bf16")
    return results


def backward_kernel_phase(device, splits):
    """Every backward kernel against its plain version; appends the GLU and
    sublayer backwards to ``splits``."""
    from open_muse_tpu_torch import kernels

    gen = torch.Generator().manual_seed(1)
    report = {"glu_down_matmul_bwd": check_glu_bwd(device, gen, splits)}
    report.update(check_sublayer_bwd(device, gen, splits))
    for name, (ok, err, (ms, plain_ms)) in report.items():
        log(f"[time] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median, "
            f"CUDA graph replay)")
    kernels.reset_launch_counts()
    return report


# -- phase 4: the serving path at full width -------------------------------

TIMESTEPS, GUIDANCE, TEMPERATURE = 12, 8.0, (2, 0)
PROMPTS = ["a photo of an astronaut riding a horse", "a red cube on a blue sphere",
           "an oil painting of a lighthouse at dusk", "a bowl of ramen, studio lighting"]


@torch.no_grad()
def randomize_(module, seed: int) -> None:
    """Seeded weights with no zeroed layer: matrices and kernels ~
    N(0, 1 / fan_in), norm scales ~ 1 + N(0, 0.1), biases and GRN shifts ~
    N(0, 0.1), GRN gains ~ N(0, 0.5); BatchNorm statistics (parameters)
    keep their initial (0, 1)."""
    gen = torch.Generator(device=next(module.parameters()).device).manual_seed(seed)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("running_mean", "running_var"):  # Paella's BatchNorm statistics stay (0, 1)
            continue
        noise = torch.randn(p.shape, generator=gen, device=p.device)
        if p.dim() >= 2 and leaf == "weight":
            noise /= p[0].numel() ** 0.5
        elif leaf == "weight":
            noise = 1.0 + 0.1 * noise
        else:
            noise *= 0.5 if leaf == "gamma" else 0.1
        p.copy_(noise)


def build_pipeline(device):
    from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder, SimpleTokenizer
    from open_muse_tpu_torch.models.taming_vqgan import VQGANModel
    from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2, MaskGiTUViT_v2Config
    from open_muse_tpu_torch.pipelines.pipeline_muse import PipelineMuseInpainting

    with torch.device(device):
        transformer = MaskGiTUViT_v2(MaskGiTUViT_v2Config())  # research defaults
        text_encoder = CLIPTextEncoder(
            vocab_size=49408, hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
            num_attention_heads=12, max_position_embeddings=77, projection_dim=768)
        vae = VQGANModel(resolution=256, num_embeddings=8192, z_channels=256,
                         quantized_embed_dim=256)
    for seed, module in enumerate((transformer, text_encoder, vae)):
        randomize_(module, seed)
    transformer.to(torch.bfloat16).eval()
    text_encoder.to(torch.bfloat16).eval()
    vae.eval()  # fp32, as the reference keeps its VAE
    counts = {name: sum(p.numel() for p in m.parameters())
              for name, m in (("uvit", transformer), ("clip", text_encoder), ("vqgan", vae))}
    log(f"[model] params {counts}; uvit/clip bf16, vqgan fp32")
    return PipelineMuseInpainting(vae=vae, transformer=transformer, text_encoder=text_encoder,
                                  tokenizer=SimpleTokenizer(49408, 77))


def check_logits(pipe, device):
    """One forward with the kernels against the all-plain forward."""
    t = pipe.transformer
    ids = pipe._tokenize(PROMPTS[:1] + [""])
    hidden_states, _, pooled = pipe.text_encoder(ids)
    micro = torch.tensor([[512, 512, 0, 0, 6.0]] * 2, device=device)
    gen = torch.Generator(device=device).manual_seed(5)
    tokens = torch.randint(0, 8192, (2, 256), generator=gen, device=device)
    tokens[torch.rand(2, 256, generator=gen, device=device) < 0.5] = t.config.mask_token_id
    with torch.no_grad():
        ctx = t.step_context(hidden_states[-2].to(t.dtype), pooled.to(t.dtype), micro)
        fused = t(tokens, step_ctx=ctx, use_kernels=True)
        plain = t(tokens, step_ctx=ctx, use_kernels=False)
    max_abs, rel = errors(fused, plain)
    ok = rel <= 5e-2 and bool(torch.isfinite(fused).all())
    log(f"[logits] full-width forward (2, 256, 8192) bf16, kernels vs all-plain: max_abs "
        f"{max_abs:.3e} rel {rel:.3e} (tol rel 5e-2: bf16 roundings through 22 layers) "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def one_request(pipe, prompt, seed, guidance=GUIDANCE, inpaint=None, eager=False):
    """One 256px / bs1 / 12-step request through ``PipelineMuse.text2image``,
    or through ``PipelineMuseInpainting.inpaint`` with ``inpaint=(pixels,
    mask)``: one replayed CUDA graph holding the text tower, the decode and
    the VQGAN (the graph's second output is the token ids).  ``eager=True``
    runs the same request with the decode loop called directly
    (``compile_*(...).eager``).  Returns (seconds, images, tokens, launch
    deltas)."""
    ids = torch.as_tensor(pipe.tokenizer([prompt])["input_ids"], dtype=torch.long)
    micro = torch.tensor([[512, 512, 0, 0, 6.0]])
    args = dict(timesteps=TIMESTEPS, guidance_scale=guidance, temperature=TEMPERATURE)
    if inpaint is None:
        fn = (eager_request(pipe, "text2image", **args, seq_len=256) if eager else
              functools.partial(pipe.text2image, **args, seq_len=256))
        inputs = (ids, micro)
    else:
        fn = (eager_request(pipe, "inpaint", **args) if eager else
              functools.partial(pipe.inpaint, **args))
        inputs = (*inpaint, ids, micro)
    return timed_call(lambda: fn(*inputs, torch.Generator().manual_seed(seed),
                                 return_tokens=True))


_EAGER = {}


def eager_request(pipe, name, **args):
    """``compile_<name>(**args).eager``, built once a pipeline and arguments."""
    key = (id(pipe), name, tuple(sorted(args.items())))
    if key not in _EAGER:
        _EAGER[key] = getattr(pipe, f"compile_{name}")(**args).eager
    return _EAGER[key]


def timed_call(fn):
    """(host-clock seconds of a synchronised ``fn()``, its images, its
    tokens, the kernel launches it counted)."""
    from open_muse_tpu_torch import kernels

    before = kernels.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images, tokens = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after = kernels.launch_counts()
    return seconds, images, tokens, {k: after[k] - before[k] for k in after}


def expected_request_launches(cfg, sampler, vq=0, steps=TIMESTEPS):
    """Per request of the U-ViT ``cfg``, no backward kernel.  At each of the
    ``steps`` steps: every trunk layer's two sublayers and GLU, its GLU pre-norm (a
    LayerNorm); each of the down and up stacks' num_res_blocks
    AttentionBlock2Ds two flash attentions and two RMSNorms, each ResBlock
    one RMSNorm; the RMSNorms of ConvEmbed, the two projections and the MLM
    head; the sampler once.  Once a request: encoder_proj_layer_norm, in the
    step context."""
    from open_muse_tpu_torch import kernels

    layers, blocks = cfg.num_hidden_layers, 2 * cfg.num_res_blocks
    expected = {name: 0 for name in kernels.launch_counts()}
    expected.update({"attn_sublayer_self": layers * steps,
                     "attn_sublayer_cross": layers * steps,
                     "glu_down_matmul": layers * steps, sampler: steps,
                     "flash_attention": 2 * blocks * steps,
                     "fused_residual_rmsnorm": (3 * blocks + 4) * steps + 1,
                     "fused_residual_layernorm": layers * steps})
    if vq:
        expected["vq_argmin"] = vq
    return expected


IMAGE_SHAPE = (1, 256, 256, 3)  # every request: one 256px image


def run_requests(smi, path, expected, request, label=None, check=None, codebook=8192,
                  steps=TIMESTEPS, guidance=GUIDANCE):
    """A path's three requests, eager then captured, each set with the
    launch counters at 0 just before it and read just after.
    ``request(i, eager)`` -> (seconds, images, tokens, launch deltas).
    Before them one captured request (the capture: a warm-up on a side
    stream, the capture, a replay) and one eager one, uncounted.  Each
    request must give a finite IMAGE_SHAPE image, tokens in [0,
    codebook), the expected launches and pass ``check(tokens)``; the
    captured tokens must equal the eager ones of the same seed, all of them.
    Returns (captured median seconds, the captured run's launch counts)."""
    from open_muse_tpu_torch import kernels
    from open_muse_tpu_torch.core import captured as cap

    label = label or (lambda i: repr(PROMPTS[i]))
    cap.last_capture.clear()
    seconds = request(99, False)[0]
    capture = dict(cap.last_capture)
    if capture:
        log(f"[capture] {path}: first captured request {seconds * 1e3:.1f} ms, of which the "
            f"warm-up and capture {capture['seconds'] * 1e3:.1f} ms; a replay adds "
            f"{sum(capture['launches'].values())} wrapper launches {capture['launches']}; {smi}")
    else:
        log(f"[capture] {path}: first request {seconds * 1e3:.1f} ms, no capture: it replays "
            f"a graph captured earlier under the same key; {smi}")
    log(f"[request] {path} eager warm-up {request(98, True)[0] * 1e3:.1f} ms; {smi}")
    medians, tokens_by_route, counts = {}, {}, {}
    for route in ("eager", "captured"):
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        latencies, tokens_by_route[route] = [], []
        for i in range(3):
            seconds, images, tokens, delta = request(i, route == "eager")
            finite = bool(torch.isfinite(images).all())
            tokens_ok = bool(((tokens >= 0) & (tokens < codebook)).all())
            extra = "" if check is None else check(tokens)
            ok = (tuple(images.shape) == IMAGE_SHAPE and finite and tokens_ok
                  and delta == expected and not extra.endswith("FAIL"))
            log(f"[{path}] {route} {i} on {smi}: {label(i)} seed {i}: {seconds * 1e3:.1f} ms, "
                f"image "
                f"{tuple(images.shape)} finite {finite} range [{images.min().item():.3f}, "
                f"{images.max().item():.3f}], tokens in [0, {codebook}) {tokens_ok} "
                f"({tokens.unique().numel()} distinct){extra}, launches "
                f"{ {k: v for k, v in delta.items() if v} } "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"chip_smoke: {path} {route} request {i} failed (expected "
                                 f"launches {expected})")
            latencies.append(seconds)
            tokens_by_route[route].append(tokens)
        counts[route] = kernels.launch_counts()
        medians[route] = statistics.median(latencies)
        log(f"[memory] {path} {route}: peak {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} "
            f"GiB allocated over its 3 requests (captured graphs' pools included), "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB held after; {smi}")
    equal = [torch.equal(a, b) for a, b in zip(tokens_by_route["eager"],
                                               tokens_by_route["captured"])]
    log(f"[tokens] {path}: captured token ids equal the eager ones of the same seed, all "
        f"{tokens_by_route['eager'][0].numel()} of each request: {equal} "
        f"{'ok' if all(equal) else 'FAIL'} ({smi})")
    if not all(equal):
        raise SystemExit(f"chip_smoke: {path} captured tokens differ from the eager loop's")
    log(f"[latency] {path}: median request eager {medians['eager'] * 1e3:.1f} ms, captured "
        f"{medians['captured'] * 1e3:.1f} ms over the same 3 requests (256px, bs1, {steps} "
        f"steps, guidance {guidance}; host clock, synchronised) on {smi}")
    return medians["captured"], counts["captured"]


def request_phase(pipe, device, smi):
    cfg = pipe.transformer.config
    if not check_logits(pipe, device):
        raise SystemExit("chip_smoke: kernel forward disagrees with the plain forward")
    median, launches = run_requests(
        smi, "serving", expected_request_launches(cfg, "fused_categorical_cfg"),
        lambda i, eager: one_request(pipe, PROMPTS[i % 4], i, eager=eager))
    profiled("request", lambda: one_request(pipe, PROMPTS[3], 3), median,
             "profile_request.txt", rows=18, smi=smi, span=True)
    return launches


def nocfg_phase(pipe, smi):
    """Guidance 0, as a guidance-distilled student serves: batch 1 through
    the trunk and the CFG-free sampler."""
    cfg = pipe.transformer.config
    median, launches = run_requests(
        smi, "serving_nocfg", expected_request_launches(cfg, "fused_categorical"),
        lambda i, eager: one_request(pipe, PROMPTS[i % 4], i, guidance=0.0, eager=eager),
        guidance=0.0)
    LATENCY_MS["serving_nocfg"] = median * 1e3
    profiled("CFG-free request", lambda: one_request(pipe, PROMPTS[3], 3, guidance=0.0), median,
             "profile_request_nocfg.txt", smi=smi, span=True)
    return launches


def centre_mask():
    """The centre 8 x 8 of 16 x 16 tokens."""
    mask = torch.zeros(16, 16, dtype=torch.bool)
    mask[4:12, 4:12] = True
    return mask.reshape(-1)


def kept_tokens(vae, pixels, mask):
    """A check that the tokens outside ``mask`` equal the image's own."""
    with torch.no_grad():
        codes = vae.get_code(pixels)[0].cpu()

    def kept(tokens):
        same = torch.equal(tokens[0].cpu()[~mask], codes[~mask])
        return f", {int((~mask).sum())} tokens outside the mask equal the encoded ones {same}" + (
            "" if same else " FAIL")

    return kept


def inpainting_phase(pipe, device, smi):
    """A seeded 256 x 256 image with the centre 8 x 8 of its 16 x 16 tokens
    repainted under CFG 8.0."""
    cfg = pipe.transformer.config
    pixels = torch.rand(1, 256, 256, 3, generator=torch.Generator().manual_seed(21)).to(device)
    mask = centre_mask()
    log(f"[inpainting] mask {int(mask.sum())} of {mask.numel()} tokens")
    median, launches = run_requests(
        smi, "inpainting", expected_request_launches(cfg, "fused_categorical_cfg", vq=1),
        lambda i, eager: one_request(pipe, PROMPTS[i % 4], i, inpaint=(pixels, mask),
                                     eager=eager),
        check=kept_tokens(pipe.vae, pixels, mask))
    profiled("inpainting request", lambda: one_request(pipe, PROMPTS[3], 3,
                                                       inpaint=(pixels, mask)),
             median, "profile_inpainting.txt", smi=smi, span=True)
    return launches


# -- the class-conditional paths at full width -----------------------------------

# configs/imagenet.yaml: training.generation_timesteps; the pipeline's default
# (2, 0) temperature anneal
CLASS_TIMESTEPS = 8
CLASS_IDS = (207, 360, 970, 88)


def build_class_pipeline(device):
    """MaskGitTransformer at configs/imagenet.yaml's model.transformer (24
    layers, hidden 768) in bf16 and the MaskGIT VQGAN at its defaults (f16,
    1024 codes; encoder and decoder) in fp32, seeded random weights: a
    class-id pipeline and an inpainting one over the same models."""
    from open_muse_tpu_torch.models.maskgit_vqgan import MaskGitVQGAN, MaskGitVQGANConfig
    from open_muse_tpu_torch.models.transformer_v1 import MaskGitTransformer
    from open_muse_tpu_torch.pipelines.pipeline_muse import PipelineMuse, PipelineMuseInpainting
    from open_muse_tpu_torch.utils.config import load_config

    config = load_config(["config=" + os.path.join(HERE, "configs", "imagenet.yaml")])
    tcfg = config.model.transformer.to_dict()
    with torch.device(device):
        transformer = MaskGitTransformer(MaskGitTransformer.config_from_dict(tcfg))
        vae = MaskGitVQGAN(MaskGitVQGANConfig())
    randomize_(transformer, 10)
    randomize_(vae, 11)
    transformer.to(torch.bfloat16).eval()
    vae.eval()
    counts = {name: sum(p.numel() for p in m.parameters())
              for name, m in (("maskgit_v1", transformer), ("maskgit_vqgan", vae),
                              ("of which encoder", vae.encoder))}
    log(f"[class_conditional] params {counts}; v1 bf16, vqgan fp32; transformer config {tcfg}")
    return (PipelineMuse(vae=vae, transformer=transformer, is_class_conditioned=True),
            PipelineMuseInpainting(vae=vae, transformer=transformer, is_class_conditioned=True))


def one_class_request(pipe, class_id, seed, eager=False, inpaint=None):
    """One 256px / bs1 / 8-step class-id request: ``PipelineMuse(class_ids=
    ...)``, or with ``inpaint=(inpainting pipeline, pixels, mask)``
    ``PipelineMuseInpainting(image, mask, class_ids=...)`` (an (R, R, 3)
    array in [0, 1]): the decode one
    replayed CUDA graph (v1 ``generate2``), the MaskGIT VQGAN's encode and
    decode eager around it.  ``eager=True`` calls the decode loop directly
    (``v1_decode_loop``) on noise drawn the same way.  Returns (label,
    seconds, images, tokens, launch deltas)."""
    from open_muse_tpu_torch.models.transformer_v1 import v1_decode_loop, v1_schedules
    from open_muse_tpu_torch.models.transformer_v2 import decode_noise

    t, vae = pipe.transformer, pipe.vae
    cfg = t.config

    def captured():
        tokens = []
        vae.decode_code = lambda ids: (tokens.append(ids), type(vae).decode_code(vae, ids))[1]
        try:
            if inpaint is None:
                images = pipe(class_ids=[class_id], timesteps=CLASS_TIMESTEPS, generator=gen,
                              return_pil=False)
            else:
                images = inpaint[0](inpaint[1], inpaint[2], class_ids=[class_id],
                                    timesteps=CLASS_TIMESTEPS, temperature=(2, 0),
                                    generator=gen, return_pil=False)
        finally:
            del vae.decode_code  # back to the class's method
        return images, tokens[0]

    @torch.no_grad()
    def eager_call():
        if inpaint is None:
            start = torch.full((1, cfg.num_vq_tokens), cfg.mask_token_id, device=device)
        else:
            pixels = inpaint[0]._preprocess_image(inpaint[1], 256)
            start = inpaint[0]._start_ids(pixels, inpaint[2], 1)
        temps, ratios = v1_schedules(CLASS_TIMESTEPS, (2, 0))
        kind, sample, mask = decode_noise(gen, timesteps=CLASS_TIMESTEPS, batch=1,
                                          seq_len=start.shape[1], vocab=cfg.codebook_size,
                                          device=start.device)
        classes = torch.tensor([class_id], device=start.device) + cfg.codebook_size
        tokens = v1_decode_loop(t, start, classes, None, temps.to(start.device),
                                ratios.to(start.device), guidance_scale=None,
                                timesteps=CLASS_TIMESTEPS, mask_gumbel=mask, **{kind: sample})
        return vae.decode_code(tokens), tokens

    device = next(t.parameters()).device
    gen = torch.Generator().manual_seed(seed)
    return (f"class {class_id}", *timed_call(eager_call if eager else captured))


def check_class_logits(pipe, device, ehs=None):
    """One full-width v1 forward (class token + the image tokens, half
    masked; with text states ``ehs`` (B, T, D) no class token, B rows) with
    the kernels against the all-plain forward."""
    t = pipe.transformer
    cfg = t.config
    gen = torch.Generator(device=device).manual_seed(6)
    rows = 1 if ehs is None else ehs.shape[0]
    tokens = torch.randint(0, cfg.codebook_size, (rows, cfg.num_vq_tokens), generator=gen,
                           device=device)
    tokens[torch.rand(tokens.shape, generator=gen, device=device) < 0.5] = cfg.mask_token_id
    ids = tokens if ehs is not None else torch.cat(
        [torch.full((1, 1), cfg.codebook_size + CLASS_IDS[0], device=device), tokens], 1)
    with torch.no_grad():
        ctx = t.step_context(ehs)
        fused = t(ids, step_ctx=ctx, use_kernels=True)
        plain = t(ids, step_ctx=ctx, use_kernels=False)
    max_abs, rel = errors(fused, plain)
    ok = rel <= 5e-2 and bool(torch.isfinite(fused).all())
    log(f"[logits] full-width v1 forward {tuple(fused.shape)} bf16, kernels vs all-plain: "
        f"max_abs {max_abs:.3e} rel {rel:.3e} (tol rel 5e-2: bf16 roundings through "
        f"{cfg.num_hidden_layers} layers) {'ok' if ok else 'FAIL'}")
    return ok


def class_conditional_phase(device, smi):
    """Three ImageNet class-id requests, then three class-id inpainting
    requests (a seeded image, the centre 8 x 8 of its 16 x 16 MaskGIT VQGAN
    tokens repainted).  Per request, at each of the 8 steps: each layer's
    self-attention (flash_attention) and its four LayerNorms (attention,
    post-attention, pre- and mid-MLP), the final and MLM-head LayerNorms,
    the sampler once; inpainting adds the encoder's vq_argmin (K 1024)."""
    from open_muse_tpu_torch import kernels

    pipe, inpainting = build_class_pipeline(device)
    cfg = pipe.transformer.config
    expected = {name: 0 for name in kernels.launch_counts()}
    expected.update({"flash_attention": cfg.num_hidden_layers * CLASS_TIMESTEPS,
                     "fused_residual_layernorm": (4 * cfg.num_hidden_layers + 2) * CLASS_TIMESTEPS,
                     "fused_categorical": CLASS_TIMESTEPS})
    if not check_class_logits(pipe, device):
        raise SystemExit("chip_smoke: v1 kernel forward disagrees with the plain forward")
    class_label = lambda i: f"class {CLASS_IDS[i % 4]}"  # noqa: E731
    median, launches = run_requests(
        smi, "class_conditional", expected,
        lambda i, eager: one_class_request(pipe, CLASS_IDS[i % 4], i, eager)[1:],
        label=class_label, guidance=0.0, codebook=cfg.codebook_size, steps=CLASS_TIMESTEPS)
    profiled("class-conditional request", lambda: one_class_request(pipe, CLASS_IDS[3], 3),
             median, "profile_class_conditional.txt", smi=smi, span=True)
    image = torch.rand(256, 256, 3, generator=torch.Generator().manual_seed(22))
    pixels = image[None].to(device)
    mask = centre_mask()
    job = (inpainting, image.numpy(), mask)
    median, inpaint_launches = run_requests(
        smi, "class_inpainting", {**expected, "vq_argmin": 1},
        lambda i, eager: one_class_request(pipe, CLASS_IDS[i % 4], i, eager, job)[1:],
        label=class_label, check=kept_tokens(pipe.vae, pixels, mask), guidance=0.0,
        codebook=cfg.codebook_size, steps=CLASS_TIMESTEPS)
    profiled("class-id inpainting request",
             lambda: one_class_request(pipe, CLASS_IDS[3], 3, inpaint=job), median,
             "profile_class_inpainting.txt", smi=smi, span=True)
    del pipe, inpainting
    gc.collect()
    torch.cuda.empty_cache()
    return launches, inpaint_launches


# -- the MOVQ paths at full width ------------------------------------------------

# google/t5-v1_1-large's encoder (configs/cc12m_movq.yaml: t5-v1_1-large-enc)
T5_LARGE = dict(vocab_size=32128, d_model=1024, d_kv=64, d_ff=2816, num_layers=24,
                num_heads=16, feed_forward_proj="gated-gelu")
# the T5 tower serves in bf16 unless its output there lies further than this
# from the fp32 tower's (max |error| over max |fp32|), or is not finite
T5_BF16_TOL = 5e-2


def build_movq(device, seed):
    """A MOVQ at Kandinsky 2.1's published widths (the MOVQConfig defaults:
    hidden 128, mult (1, 2, 2, 4), 2 res blocks, attention at 32, z 4, 16384
    x 4 codebook), seeded, fp32 as the reference keeps its VQ models."""
    from open_muse_tpu_torch.models.movq import MOVQ, MOVQConfig

    with torch.device(device):
        vae = MOVQ(MOVQConfig())
    randomize_(vae, seed)
    return vae.eval()


def param_counts(**modules):
    return {name: sum(p.numel() for p in m.parameters()) for name, m in modules.items()}


def build_v1(device, name, seed):
    """The v1 MaskGitTransformer of ``configs/<name>.yaml`` as written,
    seeded, in bf16."""
    from open_muse_tpu_torch.models.transformer_v1 import MaskGitTransformer

    tcfg = v1_config(name)
    with torch.device(device):
        transformer = MaskGitTransformer(MaskGitTransformer.config_from_dict(tcfg))
    randomize_(transformer, seed)
    return transformer.to(torch.bfloat16).eval(), tcfg


@torch.no_grad()
def movq_round_trip(vae, device, smi, n=4):
    """``get_code`` of ``n`` seeded 256px images (one vq_argmin: (n x 1024,
    4) latents against the 16384 x 4 codebook), the ids against the
    all-plain search (equal except at near-ties, where the kernel's pick is
    within VQ_RTOL of the minimum), then ``decode_code``: finite (n, 256,
    256, 3) images.  Returns (ok, its launch counts)."""
    from open_muse_tpu_torch import kernels
    from open_muse_tpu_torch.kernels.vq_argmin import vq_argmin_plain, vq_near_ties

    pixels = torch.rand(n, 256, 256, 3, generator=torch.Generator().manual_seed(23)).to(device)
    kernels.reset_launch_counts()
    ids = vae.get_code(pixels)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    latents = vae._latents(pixels).reshape(-1, vae.config.quantized_embed_dim)
    flat = ids.reshape(-1)
    near, _, over = vq_near_ties(flat, latents, vae.quantize.weight, VQ_RTOL)
    differ = flat != vq_argmin_plain(latents, vae.quantize.weight)
    ids_ok = bool((~differ | near).all()) and bool((over[differ] <= 0).all())
    images = vae.decode_code(ids)
    finite = bool(torch.isfinite(images).all())
    ok = (ids_ok and finite and tuple(images.shape) == (n, 256, 256, 3)
          and launches == {**zero_counts(), "vq_argmin": 1})
    log(f"[movq_class] get_code round trip of {n} seeded 256px images: ids {tuple(ids.shape)}, "
        f"{int(differ.sum())} of {flat.numel()} differ from the all-plain search, all at "
        f"near-ties {ids_ok}; decode_code {tuple(images.shape)} finite {finite}; launches "
        f"{ {k: v for k, v in launches.items() if v} } {'ok' if ok else 'FAIL'} ({smi})")
    return ok, launches


def movq_class_phase(device, smi):
    """configs/imagenet_movq.yaml's transformer (v1, 24 layers of 1024, 16
    heads of 64, RMSNorm, 1025 positions, vocab 17408 over 16384 codes) in
    bf16 and a MOVQ at its published widths (fp32), seeded: the full-width
    kernels-vs-plain logits, three 256px / bs1 / 8-step class-id requests
    (the decode one graph: each step's self-attention over 1025 keys, kernel
    5's two-pass variant, the sampler over 16384 of 17408 logits; the MOVQ
    decode eager), a profiled request, and a MOVQ get_code round trip
    (kernel 6 at C 4).  Returns (ok, launch counts)."""
    from open_muse_tpu_torch.pipelines.pipeline_muse import PipelineMuse

    transformer, tcfg = build_v1(device, "imagenet_movq", 40)
    vae = build_movq(device, 41)
    log(f"[movq_class] params {param_counts(maskgit_v1=transformer, movq=vae)}; v1 bf16, movq "
        f"fp32; transformer config {tcfg}")
    pipe = PipelineMuse(vae=vae, transformer=transformer, is_class_conditioned=True)
    cfg = transformer.config
    if not check_class_logits(pipe, device):
        raise SystemExit("chip_smoke: the MOVQ class model's kernel forward disagrees")
    expected = v1_forward_launches(tcfg, CLASS_TIMESTEPS)
    expected["fused_categorical"] = CLASS_TIMESTEPS
    median, launches = run_requests(
        smi, "movq_class", expected,
        lambda i, eager: one_class_request(pipe, CLASS_IDS[i % 4], i, eager)[1:],
        label=lambda i: f"class {CLASS_IDS[i % 4]}", guidance=0.0, codebook=cfg.codebook_size,
        steps=CLASS_TIMESTEPS)
    profiled("MOVQ class-conditional request", lambda: one_class_request(pipe, CLASS_IDS[3], 3),
             median, "profile_movq_class.txt", smi=smi, span=True)
    ok, round_trip = movq_round_trip(vae, device, smi)
    del pipe, transformer, vae
    gc.collect()
    torch.cuda.empty_cache()
    return ok, {k: launches[k] + round_trip[k] for k in launches}


def one_v1_text_request(pipe, prompt, seed, eager=False):
    """One 256px / bs1 / 12-step CFG text request through
    ``PipelineMuse(text=...)`` with a v1 transformer: the text tower and
    the empty prompt's states eager, the decode one replayed CUDA graph (v1
    ``generate2``, CFG against the empty prompt), ``decode_code`` eager.
    ``eager=True`` calls ``v1_decode_loop`` directly on noise drawn the same
    way.  Returns (seconds, images, tokens, launch deltas)."""
    from open_muse_tpu_torch.models.transformer_v1 import v1_decode_loop, v1_schedules
    from open_muse_tpu_torch.models.transformer_v2 import decode_noise

    t, vae = pipe.transformer, pipe.vae
    cfg = t.config
    gen = torch.Generator().manual_seed(seed)

    def captured():
        tokens = []
        vae.decode_code = lambda ids: (tokens.append(ids), type(vae).decode_code(vae, ids))[1]
        try:
            images = pipe(text=[prompt], timesteps=TIMESTEPS, guidance_scale=GUIDANCE,
                          temperature=TEMPERATURE, generator=gen, return_pil=False)
        finally:
            del vae.decode_code  # back to the class's method
        return images, tokens[0]

    @torch.no_grad()
    def eager_call():
        ehs, _ = pipe._encode_text(pipe._tokenize([prompt]))
        neg, _ = pipe._encode_text(pipe._tokenize([""]))
        device = ehs.device
        start = torch.full((1, cfg.num_vq_tokens), cfg.mask_token_id, device=device)
        temps, ratios = v1_schedules(TIMESTEPS, TEMPERATURE)
        kind, sample, mask = decode_noise(gen, timesteps=TIMESTEPS, batch=1,
                                          seq_len=cfg.num_vq_tokens, vocab=cfg.codebook_size,
                                          device=device)
        tokens = v1_decode_loop(t, start, None, torch.cat([ehs, neg.to(ehs)]), temps.to(device),
                                ratios.to(device), guidance_scale=GUIDANCE, timesteps=TIMESTEPS,
                                mask_gumbel=mask, **{kind: sample})
        return vae.decode_code(tokens), tokens

    return timed_call(eager_call if eager else captured)


def movq_text_phase(device, smi):
    """configs/cc12m_movq.yaml's transformer (v1, 24 layers of 1024, 1024
    tokens, cross-attention to 1024-wide text states, vocab 16448 over 16384
    codes) in bf16, a T5 tower at google/t5-v1_1-large's widths, the
    SimpleTokenizer at 77 tokens and a MOVQ (fp32), seeded: the T5 tower in
    bf16 against fp32 (it serves in bf16 within T5_BF16_TOL, else fp32),
    the full-width kernels-vs-plain logits, three 256px / bs1 / 12-step CFG
    8.0 requests (each step's self-attention over 1024 keys, kernel 5's
    two-pass variant, and its cross-attention over the 77 text keys, the
    one-pass one; the CFG sampler over 16384 of 16448 logits) and a
    profiled request.  Returns (ok, launch counts)."""
    import copy

    from open_muse_tpu_torch.models.clip_text import SimpleTokenizer
    from open_muse_tpu_torch.models.t5_text import T5TextEncoder
    from open_muse_tpu_torch.pipelines.pipeline_muse import PipelineMuse

    transformer, tcfg = build_v1(device, "cc12m_movq", 42)
    with torch.device(device):
        t5 = T5TextEncoder(**T5_LARGE)
    randomize_(t5, 43)
    t5.eval()
    vae = build_movq(device, 44)
    log(f"[movq_text] params {param_counts(maskgit_v1=transformer, t5=t5, movq=vae)}; v1 bf16, "
        f"movq fp32; transformer config {tcfg}; T5 {T5_LARGE}")
    tokenizer = SimpleTokenizer(T5_LARGE["vocab_size"], 77)
    ids = torch.as_tensor(tokenizer(PROMPTS + [""])["input_ids"], dtype=torch.long,
                          device=device)
    with torch.no_grad():
        t5_bf16 = copy.deepcopy(t5).to(torch.bfloat16)
        fp32, bf16 = t5(ids)[1], t5_bf16(ids)[1]
    max_abs, rel = errors(bf16, fp32)
    serve_bf16 = bool(torch.isfinite(bf16).all()) and rel <= T5_BF16_TOL
    log(f"[movq_text] T5 tower on {tuple(ids.shape)} ids, bf16 against fp32: max_abs "
        f"{max_abs:.3e} rel {rel:.3e} (max |fp32| {fp32.abs().max().item():.3e}); serves in "
        f"{'bf16' if serve_bf16 else 'fp32'} (bf16 within rel {T5_BF16_TOL} and finite: "
        f"{serve_bf16}) on {smi}")
    text_encoder = t5_bf16 if serve_bf16 else t5
    del t5, t5_bf16
    pipe = PipelineMuse(vae=vae, transformer=transformer, text_encoder=text_encoder,
                        tokenizer=tokenizer)
    cfg = transformer.config
    ehs, _ = pipe._encode_text(pipe._tokenize(PROMPTS[:1] + [""]))
    if not check_class_logits(pipe, device, ehs):
        raise SystemExit("chip_smoke: the MOVQ text model's kernel forward disagrees")
    expected = v1_forward_launches(tcfg, TIMESTEPS)
    expected["fused_categorical_cfg"] = TIMESTEPS
    median, launches = run_requests(
        smi, "movq_text", expected,
        lambda i, eager: one_v1_text_request(pipe, PROMPTS[i % 4], i, eager),
        codebook=cfg.codebook_size)
    profiled("MOVQ text request (T5, CFG)", lambda: one_v1_text_request(pipe, PROMPTS[3], 3),
             median, "profile_movq_text.txt", smi=smi, span=True)
    del pipe, transformer, text_encoder, vae
    gc.collect()
    torch.cuda.empty_cache()
    return True, launches


def profiled(label, fn, unprofiled_s, filename, rows=16, smi="", span=False):
    """Run ``fn`` once more under the profiler (outside any counted run);
    the table of device time by kernel goes to ``chiprun_out/filename``.
    The busy share is device kernel time over ``unprofiled_s``, the same
    work's host-clock time without the profiler.  The device operations
    counted (kernels, copies, sets: a captured request's graph nodes as they
    ran); with ``span``, first the device span of one more call by CUDA
    events (before the profiler, which slows later graph replays)."""
    from torch.profiler import ProfilerActivity, profile

    if span:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        span_ms = f"; device span of one call (CUDA events) {start.elapsed_time(end):.1f} ms"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    events = prof.key_averages()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in device)
    ops = sum(e.count for e in device)
    table = events.table(sort_by="self_device_time_total", row_limit=50)
    with open(os.path.join(HERE, "chiprun_out", filename), "w") as f:
        f.write(table)
    busy = device_us / 1e6 / unprofiled_s
    log(f"[profile] {label} {seconds * 1e3:.1f} ms under the profiler, device kernel time "
        f"{device_us / 1e3:.1f} ms in {ops} device operations; against the "
        f"{unprofiled_s * 1e3:.1f} ms without it: busy share {busy:.3f}, idle share "
        f"{1 - busy:.3f}{span_ms if span else ''}{'; ' + smi if smi else ''}")
    for line in table.splitlines()[:rows]:
        log(f"[profile] {line}")


# -- the pre-encode path at full width ------------------------------------------

# 16 batches: a steady window of 15 after the first batch's warm-up
PRE_ENCODE_IMAGES, PRE_ENCODE_BATCH = 1024, 64


def write_image_shard(path, samples, seed=0, classes=None):
    """A raw webdataset shard: ``samples`` seeded 256 x 256 PNG images (smooth
    colour fields with noise) with captions and LAION-style metadata, and
    with ``classes`` a ``.cls`` member each (sample i: ``classes[i]``);
    returns the images as uint8 (samples, 256, 256, 3)."""
    import io
    import tarfile

    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:256, 0:256] / 255.0
    images = []
    with tarfile.open(path, "w") as tf:
        for i in range(samples):
            base = rs.rand(3, 3) @ np.stack([yy, xx, np.ones_like(xx)]).reshape(3, -1)
            img = base.T.reshape(256, 256, 3) + 0.1 * rs.randn(256, 256, 3)
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            images.append(img)
            png = io.BytesIO()
            Image.fromarray(img).save(png, format="PNG")
            meta = json.dumps({"width": 256, "height": 256, "aesthetic": 6.0})
            members = [("png", png.getvalue()), ("txt", PROMPTS[i % 4].encode()),
                       ("json", meta.encode())]
            if classes is not None:
                members.append(("cls", str(int(classes[i])).encode()))
            for ext, data in members:
                info = tarfile.TarInfo(f"{i:05d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    return np.stack(images)


def read_members(path):
    """{sample key: {member name: numpy array or bytes}} of a tar shard."""
    import io
    import tarfile

    import numpy as np

    out = {}
    with tarfile.open(path) as tf:
        for m in tf.getmembers():
            key, name = m.name.split(".", 1)
            data = tf.extractfile(m).read()
            out.setdefault(key, {})[name] = np.load(io.BytesIO(data)) if name.endswith(".npy") \
                else data
    return out


def pre_encode_phase(pipe, device, smi):
    """scripts.pre_encode.main on a shard of 1024 seeded images at batch 64,
    with the serving VQGAN (f16, 8192 codes) and text tower written by
    save_pretrained and loaded by from_pretrained(device="cuda") in fp32."""
    import shutil
    import tempfile

    import numpy as np

    from open_muse_tpu_torch import kernels
    from open_muse_tpu_torch.kernels.vq_argmin import vq_argmin_plain
    from open_muse_tpu_torch.scripts import pre_encode
    from open_muse_tpu_torch.training.data import PreEncodedDataset
    from open_muse_tpu_torch.training.train_muse import prepare_batch
    from open_muse_tpu_torch.utils.config import Config

    runs = os.path.join(HERE, "runs")
    os.makedirs(runs, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_pre_encode_", dir=runs)
    try:
        shard = os.path.join(work, "raw-000.tar")
        pixels = write_image_shard(shard, PRE_ENCODE_IMAGES)
        vq_dir, clip_dir = os.path.join(work, "vqgan"), os.path.join(work, "clip")
        pipe.vae.save_pretrained(vq_dir)
        pipe.text_encoder.save_pretrained(clip_dir)
        out = os.path.join(work, "encoded")
        argv = ["--shards", shard, "--output-dir", out, "--vae-f16", vq_dir, "--text-encoder",
                clip_dir, "--batch-size", str(PRE_ENCODE_BATCH), "--resolution", "256",
                "--device", "cuda"]
        log(f"[pre_encode] arguments {' '.join(argv)}")
        expected = {name: 0 for name in kernels.launch_counts()}
        expected["vq_argmin"] = PRE_ENCODE_IMAGES // PRE_ENCODE_BATCH

        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        stats = pre_encode.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()

        members = read_members(os.path.join(out, os.path.basename(shard)))
        want = {"vq_f16.npy": ((256,), np.int32), "clip_penultimate.npy": ((77, 768), np.float16),
                "clip_pooled.npy": ((768,), np.float16)}
        layout_ok = sorted(members) == [f"{i:05d}" for i in range(PRE_ENCODE_IMAGES)] and all(
            sorted(m) == sorted(list(want) + ["json", "txt"])
            and all((m[k].shape, m[k].dtype) == (shape, np.dtype(dt))
                    for k, (shape, dt) in want.items())
            and all(np.isfinite(m[k].astype(np.float32)).all() for k in want)
            for m in members.values())
        tokens = torch.from_numpy(np.stack([members[f"{i:05d}"]["vq_f16.npy"]
                                            for i in range(PRE_ENCODE_IMAGES)]))
        range_ok = bool(((tokens >= 0) & (tokens < 8192)).all())
        # the all-plain get_code on the same pixels (PNG is lossless and a
        # 256 x 256 image passes the resize and crop unchanged)
        vae = pipe.vae
        plain = []
        with torch.no_grad():
            for i in range(0, PRE_ENCODE_IMAGES, PRE_ENCODE_BATCH):
                images = torch.from_numpy(pixels[i:i + PRE_ENCODE_BATCH]).to(device).float() / 255.0
                latents = vae._latents(images)
                plain.append(vq_argmin_plain(latents.reshape(-1, latents.shape[-1]),
                                             vae.quantize.embedding.weight)
                             .reshape(latents.shape[0], -1).cpu())
        agree = (tokens == torch.cat(plain).to(tokens.dtype)).double().mean().item()
        batch = next(iter(PreEncodedDataset(os.path.join(out, os.path.basename(shard)), 16,
                                            shuffle_buffer_size=32)))
        tensors = prepare_batch(batch, Config({"training": {}}), 768, device)
        read_ok = (tuple(tensors["image_tokens"].shape) == (16, 256)
                   and tuple(tensors["encoder_hidden_states"].shape) == (16, 77, 768)
                   and tuple(tensors["cond_embeds"].shape) == (16, 768))
        ok = (launches == expected and layout_ok and range_ok and agree >= 0.999 and read_ok
              and stats["n_samples"] == PRE_ENCODE_IMAGES)
        log(f"[pre_encode] {stats['n_samples']} images in {stats['n_batches']} batches of "
            f"{PRE_ENCODE_BATCH}: members named, shaped and typed as scripts/pre_encode.py "
            f"writes them {layout_ok}; tokens in [0, 8192) {range_ok}; equal to the all-plain "
            f"get_code {agree:.6f} (bound >= 0.999); read back by PreEncodedDataset and "
            f"prepare_batch {read_ok}; launches {launches} (expected {expected}) "
            f"{'ok' if ok else 'FAIL'}")
        log(f"[pre_encode] {stats['imgs_per_sec']:.1f} images/s over the run "
            f"({stats['total_s']:.2f} s, model loading excluded, first batch included), "
            f"{stats.get('steady_imgs_per_sec', float('nan')):.1f} images/s after the first "
            f"batch; {wall:.2f} s with loading (host clock) on {smi}")
        # the whole entry point again, models loading included, into another directory
        again = argv[:argv.index("--output-dir") + 1] + [out + "_profiled"] + \
            argv[argv.index("--output-dir") + 2:]
        profiled("pre-encode run", lambda: pre_encode.main(again), wall,
                 "profile_pre_encode.txt")
        return ok, launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def paella_phase(device, smi):
    """scripts.pre_encode.main over the pre-encode phase's 1024 seeded PNGs
    at batch 64 with ``--vae-f16`` the serving phase's taming f16 VQGAN
    (the same seed) and ``--vae-f8`` a Paella VQ at its published widths
    (the PaellaVQConfig defaults: 2 levels, c_hidden 384, c_latent 4, 8192
    codes, 12 bottleneck blocks), both fp32, written by save_pretrained and
    loaded by from_pretrained(device="cuda"); vq_argmin twice a batch (f16:
    (64 x 256, 256) against 8192 codes; f8: (64 x 4096, 4) against 8192);
    ``vq_f8.npy`` against the all-plain Paella get_code; then Paella
    decode_code of one batch of the written ids, and a profiled run.
    Returns (ok, launch counts)."""
    import shutil
    import tempfile

    import numpy as np

    from open_muse_tpu_torch import kernels
    from open_muse_tpu_torch.kernels.vq_argmin import vq_argmin_plain
    from open_muse_tpu_torch.models.paella_vq import PaellaVQConfig, PaellaVQModel
    from open_muse_tpu_torch.models.taming_vqgan import VQGANModel
    from open_muse_tpu_torch.scripts import pre_encode

    runs = os.path.join(HERE, "runs")
    os.makedirs(runs, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_paella_", dir=runs)
    try:
        shard = os.path.join(work, "raw-000.tar")
        pixels = write_image_shard(shard, PRE_ENCODE_IMAGES)
        with torch.device(device):
            f16 = VQGANModel(resolution=256, num_embeddings=8192, z_channels=256,
                             quantized_embed_dim=256)
            paella = PaellaVQModel(PaellaVQConfig())
        randomize_(f16, 2)  # build_pipeline's VQGAN
        randomize_(paella, 45)
        log(f"[paella] params {param_counts(taming_f16=f16, paella=paella)}; both fp32; "
            f"Paella config {PaellaVQConfig()}")
        f16_dir, f8_dir = os.path.join(work, "vqgan"), os.path.join(work, "paella")
        f16.save_pretrained(f16_dir)
        paella.save_pretrained(f8_dir)
        del f16
        out = os.path.join(work, "encoded")
        argv = ["--shards", shard, "--output-dir", out, "--vae-f16", f16_dir, "--vae-f8", f8_dir,
                "--batch-size", str(PRE_ENCODE_BATCH), "--resolution", "256", "--device", "cuda"]
        log(f"[paella] arguments {' '.join(argv)}")
        expected = {**zero_counts(), "vq_argmin": 2 * PRE_ENCODE_IMAGES // PRE_ENCODE_BATCH}

        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        stats = pre_encode.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()

        members = read_members(os.path.join(out, os.path.basename(shard)))
        want = {"vq_f16.npy": (256,), "vq_f8.npy": (4096,)}
        layout_ok = sorted(members) == [f"{i:05d}" for i in range(PRE_ENCODE_IMAGES)] and all(
            sorted(m) == sorted(list(want) + ["json", "txt"])
            and all((m[k].shape, m[k].dtype) == (shape, np.dtype(np.int32))
                    for k, shape in want.items())
            for m in members.values())
        f8 = torch.from_numpy(np.stack([members[f"{i:05d}"]["vq_f8.npy"]
                                        for i in range(PRE_ENCODE_IMAGES)]))
        range_ok = bool(((f8 >= 0) & (f8 < 8192)).all())
        plain = []
        with torch.no_grad():
            for i in range(0, PRE_ENCODE_IMAGES, 16):
                images = torch.from_numpy(pixels[i:i + 16]).to(device).float() / 255.0
                latents = paella._latents(images)
                plain.append(vq_argmin_plain(latents.reshape(-1, latents.shape[-1]),
                                             paella.vquantizer.weight)
                             .reshape(latents.shape[0], -1).cpu())
        agree = (f8 == torch.cat(plain).to(f8.dtype)).double().mean().item()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            decoded = paella.decode_code(f8[:PRE_ENCODE_BATCH].to(device).long())
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        decode_ok = (tuple(decoded.shape) == (PRE_ENCODE_BATCH, 256, 256, 3)
                     and bool(torch.isfinite(decoded).all()))
        ok = (launches == expected and layout_ok and range_ok and agree >= 0.999 and decode_ok
              and stats["n_samples"] == PRE_ENCODE_IMAGES)
        log(f"[paella] {stats['n_samples']} images in {stats['n_batches']} batches of "
            f"{PRE_ENCODE_BATCH}: members vq_f16.npy (256,) and vq_f8.npy (4096,) int32, .txt, "
            f".json {layout_ok}; vq_f8 in [0, 8192) {range_ok}; equal to the all-plain Paella "
            f"get_code {agree:.6f} (bound >= 0.999); Paella decode_code of {PRE_ENCODE_BATCH} "
            f"images' ids {tuple(decoded.shape)} finite {decode_ok} in {decode_s * 1e3:.1f} ms "
            f"(host clock, synchronised); launches {launches} (expected {expected}) "
            f"{'ok' if ok else 'FAIL'}")
        log(f"[paella] {stats['imgs_per_sec']:.1f} images/s over the run "
            f"({stats['total_s']:.2f} s, model loading excluded, first batch included), "
            f"{stats.get('steady_imgs_per_sec', float('nan')):.1f} images/s after the first "
            f"batch; {wall:.2f} s with loading (host clock) on {smi}")
        del decoded, paella
        again = argv[:argv.index("--output-dir") + 1] + [out + "_profiled"] + \
            argv[argv.index("--output-dir") + 2:]
        profiled("pre-encode run, taming f16 and Paella f8", lambda: pre_encode.main(again), wall,
                 "profile_paella.txt")
        return ok, launches
    finally:
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# -- the training path at full width ------------------------------------------

TRAIN_STEPS, CODES_PER_IMAGE = 8, 16
# the train step under the config's per-layer gradient checkpointing: each
# trunk layer's forward (its sublayers, GLU and GLU pre-norm) runs once and
# again in the backward, its backward once; the down and up stacks' 2 x 3
# ResBlock + AttentionBlock2D pairs once (one RMSNorm a ResBlock, two
# RMSNorms and two attentions an AttentionBlock2D), and the RMSNorms of the
# text projection, ConvEmbed, the two projections and the MLM head once.
# The norms and attention have no backward kernel (the plain versions'
# gradients).
LAYERS, BLOCKS = 22, 2 * 3


def forward_launches(calls=1):
    """One forward of the research model with labels and no recompute (an
    eval step): each trunk layer's sublayers, GLU and GLU pre-norm once, the
    blocks' attentions and RMSNorms, and the five RMSNorms outside them."""
    return {"attn_sublayer_self": LAYERS * calls, "attn_sublayer_cross": LAYERS * calls,
            "glu_down_matmul": LAYERS * calls, "fused_residual_layernorm": LAYERS * calls,
            "flash_attention": 2 * BLOCKS * calls, "fused_residual_rmsnorm": (3 * BLOCKS + 5) * calls}


def train_launches(steps):
    """``steps`` train steps: the forward, the trunk's recompute, the
    backward kernels once a layer."""
    expected = zero_counts()
    expected.update(forward_launches(steps))
    for name in ("attn_sublayer_self", "attn_sublayer_cross", "glu_down_matmul",
                 "fused_residual_layernorm"):
        expected[name] += LAYERS * steps
    for name in ("attn_sublayer_self_bwd", "attn_sublayer_cross_bwd", "glu_down_matmul_bwd"):
        expected[name] = LAYERS * steps
    return expected


EXPECTED_TRAIN_LAUNCHES = train_launches(TRAIN_STEPS)
# bounds of the full-width gradient check, kernels vs plain versions, both in
# bf16 autocast through 22 layers: per trunk tensor
GRAD_REL_TOL, GRAD_COS_MIN = 0.1, 0.99


def train_batch(device):
    gen = torch.Generator(device=device).manual_seed(11)
    return {"image_tokens": torch.randint(0, 8192, (TRAIN_B, TRAIN_S), generator=gen,
                                          device=device),
            "encoder_hidden_states": torch.randn(TRAIN_B, KV_LEN, 768, generator=gen,
                                                 device=device),
            "cond_embeds": torch.randn(TRAIN_B, 768, generator=gen, device=device),
            "micro_conds": torch.tensor([[512.0, 512.0, 0.0, 0.0, 6.0]] * TRAIN_B, device=device)}


def gradient_check(device):
    """One forward + backward of the research-default model at batch 16 with
    the kernels and one with the plain versions, on the same weights, batch
    and masking noise (bf16 autocast, fp32 weights, per-layer checkpointing,
    as the trainer runs)."""
    from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2, MaskGiTUViT_v2Config
    from open_muse_tpu_torch.ops.sampling import get_mask_schedule
    from open_muse_tpu_torch.training.masking import draw_masking_noise, mask_or_random_replace_tokens

    torch.manual_seed(0)
    with torch.device(device):
        model = MaskGiTUViT_v2(MaskGiTUViT_v2Config())
    model.set_gradient_checkpointing(True)
    batch = train_batch(device)
    noise = draw_masking_noise(TRAIN_B, TRAIN_S, torch.Generator(device=device).manual_seed(3),
                               8192)
    input_ids, labels, _, _ = mask_or_random_replace_tokens(
        batch["image_tokens"], model.config.mask_token_id, get_mask_schedule("cosine"), noise)
    grads, losses = {}, {}
    for use_kernels in (True, False):
        model.zero_grad(set_to_none=True)
        with torch.autocast("cuda", torch.bfloat16):
            _, loss = model(input_ids, batch["encoder_hidden_states"], batch["cond_embeds"],
                            batch["micro_conds"], labels=labels, use_kernels=use_kernels)
        loss.backward()
        losses[use_kernels] = loss.item()
        grads[use_kernels] = {n: p.grad.clone() for n, p in model.named_parameters()
                              if p.grad is not None}
    names = [n for n, _ in model.named_parameters()]
    missing = [n for n in names if n not in grads[True]]
    bad = [n for n, g in grads[True].items()
           if not bool(torch.isfinite(g).all()) or not bool(g.abs().sum() > 0)]
    worst_rel, worst_cos = (0.0, ""), (1.0, "")
    for n in names:
        if not n.startswith("transformer_layers."):
            continue
        got, ref = grads[True][n].double().flatten(), grads[False][n].double().flatten()
        rel = ((got - ref).norm() / ref.norm()).item()
        cos = torch.nn.functional.cosine_similarity(got, ref, dim=0).item()
        worst_rel = max(worst_rel, (rel, n))
        worst_cos = min(worst_cos, (cos, n))
    trunk = sum(n.startswith("transformer_layers.") for n in names)
    ok = (not missing and not bad and worst_rel[0] <= GRAD_REL_TOL and worst_cos[0] >= GRAD_COS_MIN
          and all(torch.isfinite(torch.tensor(v)) for v in losses.values()))
    log(f"[grad] full-width model ({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
        f"params) at batch {TRAIN_B}: loss kernels {losses[True]:.6f} plain {losses[False]:.6f} "
        f"(diff {abs(losses[True] - losses[False]):.3e}); {len(names)} parameters, "
        f"missing grads {missing[:4]}, zero or non-finite {bad[:4]}")
    log(f"[grad] {trunk} trunk tensors, kernels vs plain: worst relative error "
        f"{worst_rel[0]:.3e} ({worst_rel[1]}; bound {GRAD_REL_TOL}), worst cosine "
        f"{worst_cos[0]:.6f} ({worst_cos[1]}; bound {GRAD_COS_MIN}) {'ok' if ok else 'FAIL'}")
    del model, grads
    torch.cuda.empty_cache()
    return ok


def write_shard(path, samples=32, seed=0, text=(KV_LEN, 768), pooled=True):
    """A seeded pre-encoded shard in the dialect of scripts/pre_encode.py at
    the config's shapes: tokens (256,) in [0, 8192) (each image uses 16
    codes, so a repeated batch is learnable), the text states ``text``
    (CLIP penultimate (77, 768) by default) fp16 in the member the script
    writes them to, pooled (768,) fp16 where ``pooled``, and LAION metadata
    that passes the flagship config's quality filter."""
    import io
    import tarfile

    import numpy as np

    def npy(arr):
        buf = io.BytesIO()
        np.save(buf, arr)
        return buf.getvalue()

    rs = np.random.RandomState(seed)
    meta = json.dumps({"width": 512, "height": 512, "pwatermark": 0.1, "aesthetic": 6.5})
    with tarfile.open(path, "w") as tf:
        for i in range(samples):
            codes = rs.choice(8192, CODES_PER_IMAGE, replace=False)
            members = [("vq_f16.npy", npy(rs.choice(codes, TRAIN_S).astype(np.int32))),
                       ("clip_penultimate.npy", npy(rs.randn(*text).astype(np.float16))),
                       ("json", meta.encode())]
            if pooled:
                members.append(("clip_pooled.npy", npy(rs.randn(768).astype(np.float16))))
            for ext, data in members:
                info = tarfile.TarInfo(f"{i:05d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def _research_step(**kwargs):
    """The flagship config's train step (bf16 autocast) at the research
    model's mask id and codebook."""
    from open_muse_tpu_torch.ops.sampling import get_mask_schedule
    from open_muse_tpu_torch.training import trainer as T

    return T.make_uvit_train_step(get_mask_schedule("cosine"), 8255, codebook_size=8192,
                                  autocast_dtype=torch.bfloat16, **kwargs)


def profile_train_step(state, device, median_s, label="train step (one replayed graph)",
                       filename="profile_train_step.txt", prepare=None, **kwargs):
    """Device time by kernel for one more captured train step (outside the
    counted run; its graph warmed up, captured and replayed once first),
    against the unprofiled median step time.  With ``prepare`` (the raw
    branch), each profiled step first encodes its batch, as the trainer
    does."""
    from open_muse_tpu_torch.training.masking import draw_masking_noise

    step = _research_step(**kwargs)
    gen = torch.Generator(device=device).manual_seed(4)
    batch = train_batch(device) if prepare is None else None

    def one():
        b = batch if prepare is None else prepare()
        noise = draw_masking_noise(TRAIN_B, TRAIN_S, gen, 8192,
                                   cond_dropout="empty_embeds" in b)
        return float(step(state, b, noise)["loss"])

    one()  # the warm-up step and the capture
    one()  # a first replay
    profiled(label, one, median_s, filename)


def _logged(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _step_lines(tag, logged):
    """Per-step lines and (median of steps 2 on, first step's capture s)."""
    steps = [m for m in logged if "loss" in m]
    for m in steps:
        log(f"[{tag}] step {m['step']}: loss {m['loss']:.4f} grad_norm {m['grad_norm']:.4f} "
            f"masking {m['avg_masking_rate']:.3f} lr {m['lr']:.2e} "
            f"step_time {m['step_time'] * 1e3:.1f} ms"
            + (f" (eager warm-up step + capture; the capture alone {m['capture_s']:.2f} s)"
               if "capture_s" in m else ""))
    return statistics.median(m["step_time"] for m in steps[1:]), steps


def _resume_check(tag, entry, argv, state, out, steps):
    """``entry.main`` again with resume_from_checkpoint=latest: step and
    every tensor as saved (the EMA where the run has one)."""
    resumed = entry.main(argv + ["experiment.resume_from_checkpoint=latest"])
    mine = dict(state.model.named_parameters())
    params_equal = all(torch.equal(p, mine[n]) for n, p in resumed.model.named_parameters())
    ema_equal = ((resumed.ema is None) == (state.ema is None)) and (state.ema is None or all(
        torch.equal(v, state.ema.shadow[n]) for n, v in resumed.ema.shadow.items()))
    opt_equal = resumed.optimizer.count == state.optimizer.count == steps
    moments_equal = all(
        torch.equal(v, state.optimizer.torch_optimizer.state[mine[n]][k])
        for n, p in resumed.model.named_parameters()
        for k, v in resumed.optimizer.torch_optimizer.state[p].items())
    ok = (resumed.step == state.step == steps and params_equal and ema_equal and opt_equal
          and moments_equal)
    log(f"[{tag}] resumed from {sorted(d for d in os.listdir(out) if d.startswith('checkpoint'))}: "
        f"step {resumed.step}, params equal {params_equal}, EMA equal {ema_equal}, AdamW "
        f"moments equal {moments_equal}, optimizer count {resumed.optimizer.count} "
        f"{'ok' if ok else 'FAIL'}")
    del resumed
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def training_phase(device, smi):
    """train_muse.main on the research config at batch 16 on pre-encoded
    shards (the captured step), then main again resuming from its
    checkpoint; returns the launch counts of the first."""
    import shutil
    import tempfile

    from open_muse_tpu_torch import kernels
    from open_muse_tpu_torch.training import train_muse

    runs = os.path.join(HERE, "runs")
    os.makedirs(runs, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=runs)
    try:
        shard = os.path.join(work, "synthetic-000.tar")
        write_shard(shard)
        out = os.path.join(work, "out")
        overrides = [f"dataset.params.train_shards_path_or_url={shard}",
                     "dataset.params.shuffle_buffer_size=16", f"experiment.output_dir={out}",
                     "experiment.log_every=1", f"experiment.save_every={TRAIN_STEPS}",
                     f"training.batch_size={TRAIN_B}", "training.pre_encode=true",
                     "training.overfit_one_batch=true", "lr_scheduler.params.warmup_steps=0",
                     f"training.max_train_steps={TRAIN_STEPS}"]
        argv = ["config=" + os.path.join(HERE, "configs", "laiona6plus_uvit_clip.yaml")] + overrides
        for arg in argv:
            log(f"[train] argument {arg}")

        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state = train_muse.main(argv)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        median, logged = _step_lines("train", _logged(out))
        losses = [m["loss"] for m in logged]
        finite = all(v == v and abs(v) != float("inf") for v in losses)
        falling = losses[-1] < losses[0]
        steps_ok = [m["step"] for m in logged] == list(range(1, TRAIN_STEPS + 1))
        counts_ok = launches == EXPECTED_TRAIN_LAUNCHES
        log(f"[train] {TRAIN_STEPS} captured steps in {wall:.1f} s (model build and checkpoint "
            f"included): losses finite {finite}, last {losses[-1]:.4f} < first {losses[0]:.4f} "
            f"{falling}, launches {launches} (expected {EXPECTED_TRAIN_LAUNCHES}: step 1 eager, "
            f"steps 2 - {TRAIN_STEPS} replays adding the capture's counts) "
            f"{'ok' if counts_ok else 'FAIL'}")
        STEP_MS["training"] = median * 1e3
        log(f"[train] median step {median * 1e3:.1f} ms over steps 2-{TRAIN_STEPS} (host clock, "
            f"synchronised), {TRAIN_B * TRAIN_S / median:.0f} tokens/s, "
            f"{TRAIN_B / median:.2f} images/s, peak memory {peak / 2 ** 30:.2f} GiB "
            f"(max_memory_allocated) on {smi}")
        resume_ok = _resume_check("train", train_muse, argv, state, out, TRAIN_STEPS)
        profile_train_step(state, device, median)
        ok = finite and falling and steps_ok and counts_ok and resume_ok
        del state
        gc.collect()
        torch.cuda.empty_cache()
        return ok, launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


TRAIN_EQ_STEPS = 4


def _seeded_train_state(device, accumulation_steps=1, optimizer="adamw"):
    """The research-default model (per-layer checkpointing, fp32 weights),
    ``optimizer`` (AdamW) at the flagship config's lr and decay, and an EMA,
    from one seed."""
    from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2, MaskGiTUViT_v2Config
    from open_muse_tpu_torch.training.ema import EMA
    from open_muse_tpu_torch.training.optimizers import get_optimizer
    from open_muse_tpu_torch.training.trainer import TrainState

    torch.manual_seed(0)
    with torch.device(device):
        model = MaskGiTUViT_v2(MaskGiTUViT_v2Config())
    model.set_gradient_checkpointing(True)
    return TrainState(model=model, optimizer=get_optimizer(
        optimizer, model, lambda count: 1e-4, weight_decay=0.01,
        accumulation_steps=accumulation_steps), ema=EMA(model))


def _state_tensors(state):
    """(kind, tensor) of every parameter, AdamW moment, EMA shadow (where
    the state has an EMA) and accumulator of ``state``."""
    out = []
    for name, p in state.model.named_parameters():
        out.append(("params", p))
        if state.ema is not None:
            out.append(("EMA", state.ema.shadow[name]))
        for key, value in state.optimizer.torch_optimizer.state[p].items():
            out.append((f"AdamW {key}", value))
    out += [("accumulators", a) for a in state.optimizer.acc]
    return out


def _worst_diffs(a, b):
    worst = {}
    for (kind, x), (_, y) in zip(_state_tensors(a), _state_tensors(b)):
        worst[kind] = max(worst.get(kind, 0.0), (x.float() - y.float()).abs().max().item())
    return worst


def train_eq_phase(device, soft_targets=False):
    """The captured step against the eager body on one seeded full-width
    state (batch 16, cond dropout 0.1 with empty-prompt embeddings, the
    bucket diagnostics and per-parameter norms on, cuDNN deterministic):
    TRAIN_EQ_STEPS steps each, the noise from generators of one seed; the
    losses, grad norms and the worst absolute difference of every
    parameter, AdamW moment and EMA shadow (and accumulator); without and
    with gradient accumulation 2; with ``soft_targets``, the soft-target
    step (seeded soft targets (16, 256, 8192)) without accumulation.  Gate:
    bit-equal.  Where not, a second eager state tells whether eager is
    itself nondeterministic."""
    from open_muse_tpu_torch.training.masking import draw_masking_noise

    torch.backends.cudnn.deterministic = True
    gen = torch.Generator(device=device).manual_seed(12)
    batch = {**train_batch(device),
             "empty_embeds": torch.randn(1, KV_LEN, 768, generator=gen, device=device),
             "empty_cond_embeds": torch.randn(1, 768, generator=gen, device=device)}
    if soft_targets:
        batch["soft_targets"] = torch.softmax(
            4 * torch.randn(TRAIN_B, TRAIN_S, 8192, generator=gen, device=device), -1)
    ok = True
    for accumulation in (1,) if soft_targets else (1, 2):
        step = _research_step(cond_dropout_prob=0.1, with_diagnostics=True,
                              with_param_grad_norms=True, use_soft_targets=soft_targets)
        states = [_seeded_train_state(device, accumulation) for _ in range(2)]
        gens = [torch.Generator(device=device).manual_seed(21) for _ in range(2)]
        rows, metrics_equal = [], True
        for i in range(TRAIN_EQ_STEPS):
            noise = [draw_masking_noise(TRAIN_B, TRAIN_S, g, 8192, cond_dropout=True)
                     for g in gens]
            got = step(states[0], batch, noise[0])
            want = step.eager(states[1], batch, noise[1])
            metrics_equal &= all(torch.equal(got[k].nan_to_num(), want[k].nan_to_num())
                                 for k in want)
            rows.append(f"{float(got['loss']):.6f}/{float(want['loss']):.6f} "
                        f"{float(got['grad_norm']):.6f}/{float(want['grad_norm']):.6f}")
        worst = _worst_diffs(*states)
        equal = metrics_equal and all(v == 0.0 for v in worst.values())
        log(f"[train_eq] {'soft targets, ' if soft_targets else ''}accumulation {accumulation}, "
            f"{TRAIN_EQ_STEPS} steps captured / eager: "
            f"loss and grad_norm per step {'; '.join(rows)}; every metric bit-equal "
            f"{metrics_equal}; worst |captured - eager| "
            + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
            + f"; update count {states[0].optimizer.count} {'ok' if equal else 'FAIL'}")
        if not equal:  # eager twice: is the eager step itself nondeterministic?
            third = _seeded_train_state(device, accumulation)
            g = torch.Generator(device=device).manual_seed(21)
            for i in range(TRAIN_EQ_STEPS):
                step.eager(third, batch, draw_masking_noise(TRAIN_B, TRAIN_S, g, 8192,
                                                            cond_dropout=True))
            again = _worst_diffs(states[1], third)
            log("[train_eq] eager against eager: worst "
                + ", ".join(f"{k} {v:.3e}" for k, v in again.items()))
            del third
        ok &= equal
        del states, step
        gc.collect()
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    return ok


# 'dots' against full checkpointing: the saved matmul outputs are the values
# the recompute would give, so the gradients are expected bit-equal; bound
# on the worst relative error of a parameter's gradient
DOTS_REL_TOL = 1e-3


def dots_phase(device):
    """One forward and backward of the full-width research model at batch
    16 (bf16 autocast) with no checkpointing, full per-layer checkpointing
    and 'dots', on the same weights, batch and masking noise: losses and
    gradients of 'dots' against full, and the peak memory of each above the
    weights (full <= 'dots' <= none)."""
    from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2, MaskGiTUViT_v2Config
    from open_muse_tpu_torch.ops.sampling import get_mask_schedule
    from open_muse_tpu_torch.training.masking import (draw_masking_noise,
                                                       mask_or_random_replace_tokens)

    torch.manual_seed(0)
    with torch.device(device):
        model = MaskGiTUViT_v2(MaskGiTUViT_v2Config())
    batch = train_batch(device)
    noise = draw_masking_noise(TRAIN_B, TRAIN_S, torch.Generator(device=device).manual_seed(3),
                               8192)
    input_ids, labels, _, _ = mask_or_random_replace_tokens(
        batch["image_tokens"], model.config.mask_token_id, get_mask_schedule("cosine"), noise)
    peaks, losses, grads = {}, {}, {}
    for mode in (False, True, "dots"):
        model.set_gradient_checkpointing(mode)
        model.zero_grad(set_to_none=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.autocast("cuda", torch.bfloat16, cache_enabled=False):
            _, loss = model(input_ids, batch["encoder_hidden_states"], batch["cond_embeds"],
                            batch["micro_conds"], labels=labels)
        loss.backward()
        torch.cuda.synchronize()
        peaks[mode] = torch.cuda.max_memory_allocated() - base
        losses[mode] = loss.detach()
        if mode:
            grads[mode] = [p.grad.clone() for p in model.parameters()]
    worst = max(((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30)).item()
                for a, b in zip(grads["dots"], grads[True]))
    bit_equal = all(torch.equal(a, b) for a, b in zip(grads["dots"], grads[True]))
    ordered = peaks[True] <= peaks["dots"] <= peaks[False]
    ok = (torch.equal(losses["dots"], losses[True]) and worst <= DOTS_REL_TOL and ordered)
    log(f"[dots] loss none {float(losses[False]):.6f} full {float(losses[True]):.6f} 'dots' "
        f"{float(losses['dots']):.6f}; 'dots' grads against full: bit-equal {bit_equal}, worst "
        f"relative error {worst:.3e} (bound {DOTS_REL_TOL}); peak memory above the weights "
        f"(max_memory_allocated): none {peaks[False] / 2 ** 30:.2f} GiB, 'dots' "
        f"{peaks['dots'] / 2 ** 30:.2f} GiB, full {peaks[True] / 2 ** 30:.2f} GiB, "
        f"full <= 'dots' <= none {ordered} {'ok' if ok else 'FAIL'}")
    del model, grads
    gc.collect()
    torch.cuda.empty_cache()
    return ok


RAW_IMAGES, RAW_EVAL_IMAGES = 32, 16
STEP_MS = {}  # path -> median step ms (host clock), for the phases that compare


# the in-repo inpainting validation folders (image, mask, the folder's name
# the prompt)
INPAINT_DIR, INPAINT_ENTRIES = os.path.join(HERE, "inpainting_validation"), 5


def raw_launches(steps, eval_batches):
    """The raw run: ``steps`` train steps; each get_code one vq_argmin
    (every step's batch and each eval batch, the first call two: its graph's
    warm-up, then the replay); each eval batch one forward, the first two;
    one sample panel: a 12-step CFG decode of 4 images, twice (its graph's
    warm-up and the replay); one inpainting panel: each of the
    INPAINT_ENTRIES images encoded (one vq_argmin) and an 8-step CFG decode
    from its masked tokens, the first of each twice (a graph's warm-up and
    the replay)."""
    from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2Config

    cfg = MaskGiTUViT_v2Config()
    expected = train_launches(steps)
    for name, n in forward_launches(eval_batches + 1).items():
        expected[name] += n
    for name, n in expected_request_launches(cfg, "fused_categorical_cfg").items():
        expected[name] += 2 * n
    for name, n in expected_request_launches(cfg, "fused_categorical_cfg", steps=8).items():
        expected[name] += (INPAINT_ENTRIES + 1) * n
    expected["vq_argmin"] = steps + eval_batches + 1 + INPAINT_ENTRIES + 1
    return expected


def raw_encoder_dirs(work, device):
    """Seeded full-width CLIP-L text tower and f16 taming VQGAN (8192 codes)
    written by save_pretrained under ``work``: (clip dir, vqgan dir)."""
    from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder
    from open_muse_tpu_torch.models.taming_vqgan import VQGANModel

    clip_dir, vq_dir = os.path.join(work, "clip"), os.path.join(work, "vqgan")
    with torch.device(device):
        text_encoder = CLIPTextEncoder(
            vocab_size=49408, hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
            num_attention_heads=12, max_position_embeddings=77, projection_dim=768)
        vae = VQGANModel(resolution=256, num_embeddings=8192, z_channels=256,
                         quantized_embed_dim=256)
    randomize_(text_encoder, 1)
    randomize_(vae, 2)
    text_encoder.save_pretrained(clip_dir)
    vae.save_pretrained(vq_dir)
    return clip_dir, vq_dir


def train_raw_phase(device, smi):
    """train_muse.main on configs/laiona6plus_uvit_clip.yaml without
    pre-encoding: seeded raw shards (train and eval), seeded full-width CLIP-L
    and f16 taming VQGAN directories; eval, the sample panel, the grad-norm
    lines, the bucket diagnostics, a profiler window and the inpainting
    panel (the in-repo validation folders) each once; then the inpainting
    panel's tokens outside each mask against the encoded image's, a resume
    and a profiled raw step.  Returns (ok, launch counts)."""
    import shutil
    import tempfile

    from open_muse_tpu_torch import kernels
    from open_muse_tpu_torch.training import train_muse
    from open_muse_tpu_torch.training.data import (Text2ImageDataset, WebdatasetSelect,
                                                   decode_sample, tar_samples)
    from open_muse_tpu_torch.training.trainer import grad_norm_param_names
    from open_muse_tpu_torch.utils.config import load_config

    runs = os.path.join(HERE, "runs")
    os.makedirs(runs, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_train_raw_", dir=runs)
    try:
        shard, eval_shard = (os.path.join(work, f"{n}-000.tar") for n in ("raw", "eval"))
        write_image_shard(shard, RAW_IMAGES, seed=3)
        write_image_shard(eval_shard, RAW_EVAL_IMAGES, seed=4)
        clip_dir, vq_dir = raw_encoder_dirs(work, device)
        out = os.path.join(work, "out")
        config_path = os.path.join(HERE, "configs", "laiona6plus_uvit_clip.yaml")
        overrides = [f"dataset.params.train_shards_path_or_url={shard}",
                     f"dataset.params.eval_shards_path_or_url={eval_shard}",
                     "dataset.params.shuffle_buffer_size=16", f"experiment.output_dir={out}",
                     "experiment.log_every=1", f"experiment.save_every={TRAIN_STEPS}",
                     f"experiment.eval_every={TRAIN_STEPS}", "experiment.max_eval_batches=1",
                     f"experiment.generate_every={TRAIN_STEPS}",
                     f"experiment.log_grad_norm_every={TRAIN_STEPS}",
                     "experiment.log_entropy_buckets=true", "experiment.profile_steps=[4,5]",
                     f"experiment.inpainting_validation_dir={INPAINT_DIR}",
                     f"model.text_encoder.pretrained={clip_dir}",
                     f"model.vq_model.pretrained={vq_dir}", f"training.batch_size={TRAIN_B}",
                     "training.overfit_one_batch=true", "lr_scheduler.params.warmup_steps=0",
                     f"training.max_train_steps={TRAIN_STEPS}"]
        argv = ["config=" + config_path] + overrides
        for arg in argv:
            log(f"[train_raw] argument {arg}")
        config = load_config(argv)
        log(f"[train_raw] cuts of the flagship config: batch {512} -> {TRAIN_B}, warmup 5000 -> "
            f"0, {TRAIN_STEPS} steps; raw branch (no training.pre_encode), cond_dropout_prob "
            f"{config.training.cond_dropout_prob}, gradient_checkpointing "
            f"{config.model.gradient_checkpointing}, use_ema {config.training.use_ema}, "
            f"{config.training.mixed_precision}")
        select = WebdatasetSelect(**config.dataset.quality_filter.to_dict())
        kept = [select(decode_sample(raw)) for path in (shard, eval_shard)
                for raw in tar_samples(path)]
        filter_ok = len(kept) == RAW_IMAGES + RAW_EVAL_IMAGES and all(kept)
        log(f"[train_raw] samples passing the config's quality filter "
            f"{config.dataset.quality_filter.to_dict()}: {sum(kept)} of {len(kept)} "
            f"{'ok' if filter_ok else 'FAIL'}")

        expected = raw_launches(TRAIN_STEPS, 1)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state = train_muse.main(argv)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        logged = _logged(out)
        median, steps = _step_lines("train_raw", logged)
        losses = [m["loss"] for m in steps]
        falling = losses[-1] < losses[0] and all(v == v for v in losses)
        evals = [m["eval_loss"] for m in logged if "eval_loss" in m]
        eval_ok = len(evals) == 1 and evals[0] == evals[0]
        panel = os.path.join(out, f"samples-{TRAIN_STEPS}.png")
        panel_ok = os.path.isfile(panel) and os.path.isfile(
            os.path.join(out, f"inpainting-{TRAIN_STEPS}.png"))
        norms = [m for m in logged if any(k.startswith("grad_norm/") for k in m)]
        names = [f"grad_norm/{n}" for n in grad_norm_param_names(state.model)]
        norms_ok = (len(norms) == 1 and [k for k in norms[0] if k != "step"] == names
                    and all(v == v and v >= 0 for k, v in norms[0].items() if k != "step"))
        buckets_ok = all(len(m["pixel_entropy_by_bucket"]) == 10 for m in steps)
        trace = os.path.join(out, "profile", "trace.json")
        trace_ok = os.path.isfile(trace)
        counts_ok = launches == expected
        log(f"[train_raw] {TRAIN_STEPS} steps in {wall:.1f} s (encoder and model build, eval, "
            f"panel and checkpoint included): last loss {losses[-1]:.4f} < first "
            f"{losses[0]:.4f} {falling}; eval_loss {evals} {eval_ok}; {os.path.basename(panel)} "
            f"and inpainting-{TRAIN_STEPS}.png {panel_ok}; grad-norm lines under the {len(names)} flax names {norms_ok}; bucket "
            f"diagnostics every step {buckets_ok}; trace {trace_ok} "
            f"({os.path.getsize(trace) if trace_ok else 0} bytes)")
        log(f"[train_raw] launches {launches} (expected {expected}) "
            f"{'ok' if counts_ok else 'FAIL'}")
        STEP_MS["train_raw"] = median * 1e3
        log(f"[train_raw] median step {median * 1e3:.1f} ms over steps 2-{TRAIN_STEPS} (host "
            f"clock, synchronised; encode and step), {TRAIN_B * TRAIN_S / median:.0f} tokens/s, "
            f"{TRAIN_B / median:.2f} images/s, peak memory {peak / 2 ** 30:.2f} GiB "
            f"(max_memory_allocated) on {smi}")
        resume_ok = _resume_check("train_raw", train_muse, argv, state, out, TRAIN_STEPS)
        encoders = train_muse.FrozenEncoders.from_config(config, device)
        empty = encoders.empty_embeds()
        inpaint_ok = inpainting_panel_check(state, encoders, empty, device, smi)
        raw = next(iter(Text2ImageDataset(shard, TRAIN_B, resolution=256, shuffle_buffer_size=16,
                                          seed=5)))
        profile_train_step(state, device, median, label="raw train step (encode + step)",
                           filename="profile_train_raw_step.txt",
                           prepare=lambda: {**encoders.prepare_batch(raw), **empty},
                           cond_dropout_prob=0.1, with_diagnostics=True,
                           with_param_grad_norms=True)
        ok = (filter_ok and falling and eval_ok and panel_ok and norms_ok and buckets_ok
              and trace_ok and counts_ok and resume_ok and inpaint_ok)
        del state, encoders
        gc.collect()
        torch.cuda.empty_cache()
        return ok, launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


@torch.no_grad()
def inpainting_panel_check(state, encoders, empty, device, smi):
    """``generate_inpainting_images`` as the trainer's panel calls it (the
    EMA weights in bf16, the in-repo folders at 256 px over 16 x 16 tokens):
    every token outside each mask must equal the encoded image's."""
    from open_muse_tpu_torch.training import train_muse

    model = type(state.model)(state.model.config).to(device, torch.bfloat16).eval()
    model.load_state_dict(state.ema.shadow)
    entries = train_muse.load_inpainting_validation_data(INPAINT_DIR, 256, 16)
    micro = torch.tensor([[512.0, 512.0, 0.0, 0.0, 6.0]], device=device)
    generated = train_muse.generate_inpainting_images(
        model, encoders.vq_model, entries, encoders.encode_text, model.config.mask_token_id,
        micro, empty["empty_embeds"], empty["empty_cond_embeds"], None,
        lambda i: {"generator": torch.Generator().manual_seed(i)})
    kept = []
    for entry, ids in zip(entries, generated):
        mask = torch.from_numpy(entry["mask"].reshape(-1)).to(device)
        codes = train_muse.get_code(encoders.vq_model,
                                    torch.from_numpy(entry["image"])[None].to(device))[0]
        kept.append((int((~mask).sum()), bool(torch.equal(ids[0][~mask], codes[~mask].long()))))
    ok = len(kept) == INPAINT_ENTRIES and all(same for _, same in kept)
    log(f"[train_raw] inpainting panel ({len(entries)} folders of {INPAINT_DIR}, 8 steps, CFG "
        f"8): tokens outside each mask equal the encoded image's "
        f"{[f'{n} {same}' for n, same in kept]} {'ok' if ok else 'FAIL'}; {smi}")
    return ok


# -- the v1 trainers at full width --------------------------------------------

V1_STEPS = 8
# train_class: configs/imagenet.yaml's batch 256 cut to 64: 24 layers without
# checkpointing hold ~1.5 GB of activations a layer at 128 x 257 tokens, and
# at batch 128 the step's eager warm-up and its capture ran out of an 80 GB
# H100; 128 seeded images, resampled; the panel every 4 steps (twice);
# train_v1_text: configs/cc12m.yaml at its own batch, the text states of the
# CC12M shards' max_seq_length (configs/cc12m_uvit.yaml: 32)
CLASS_B, CLASS_IMAGES, CLASS_PANEL_EVERY = 64, 128, 4
TEXT_B, TEXT_LEN = 64, 32
V1_DROPOUT_TOL = 0.005


def v1_config(name, **changes):
    """model.transformer of ``configs/<name>.yaml`` as a dict."""
    from open_muse_tpu_torch.utils.config import load_config

    config = load_config(["config=" + os.path.join(HERE, "configs", f"{name}.yaml")])
    return {**config.model.transformer.to_dict(), **changes}


def v1_forward_launches(tcfg, calls=1):
    """Kernel launches of ``calls`` forwards of the v1 model at ``tcfg``
    (no backward kernel: the norms' and attention's gradients are their
    plain versions'): each layer's attention norm, its Normformer post-norm,
    the same two for cross-attention, the pre-MLP norm (a LayerNorm
    whatever ``norm_type`` says) and the mid-MLP Normformer norm; the
    encoder and MLM norms; the projected text's norm; one attention a
    self- and a cross-attention (unmasked), the self-attention over its
    max_position_embeddings keys (the two-pass variant above 288; text keys
    stay below)."""
    from open_muse_tpu_torch.kernels.flash_attention import ONE_PASS_MAX_KEYS
    from open_muse_tpu_torch.models.transformer_v1 import MaskGitTransformerConfig

    cfg = MaskGitTransformerConfig.from_dict(tcfg)[0]
    cross, post = cfg.add_cross_attention, cfg.use_normformer
    per_layer = (1 + post) * (1 + cross) + post
    once = (cfg.use_encoder_layernorm + (cfg.use_mlm_layer and cfg.use_mlm_layernorm)
            + (cross and cfg.project_encoder_hidden_states))
    norm = "fused_residual_rmsnorm" if cfg.norm_type == "rmsnorm" else "fused_residual_layernorm"
    expected = zero_counts()
    expected[norm] += calls * (cfg.num_hidden_layers * per_layer + once)
    expected["fused_residual_layernorm"] += calls * cfg.num_hidden_layers
    expected["flash_attention"] = calls * cfg.num_hidden_layers * (1 + cross)
    if cfg.max_position_embeddings > ONE_PASS_MAX_KEYS:  # the self-attention's keys
        expected["flash_attention_two_pass"] = calls * cfg.num_hidden_layers
    return expected


def class_launches(tcfg, steps, panels, panel_steps=8):
    """train_class: ``steps`` train steps; ``get_code`` once a batch (its
    graph's warm-up one more); ``panels`` sample panels, each an 8-step
    class decode (the first twice: its graph's warm-up and the replay),
    ``fused_categorical`` once a decode step."""
    decodes = (panels + 1) * panel_steps
    expected = v1_forward_launches(tcfg, steps + decodes)
    expected["fused_categorical"] = decodes
    expected["vq_argmin"] = steps + 1
    return expected


def _seeded_v1_state(device, tcfg):
    """The v1 model at ``tcfg`` (fp32 weights) and AdamW at the configs'
    lr and decay, no EMA (both configs: use_ema false), from one seed."""
    from open_muse_tpu_torch.models.transformer_v1 import MaskGitTransformer
    from open_muse_tpu_torch.training.optimizers import get_optimizer
    from open_muse_tpu_torch.training.trainer import TrainState

    torch.manual_seed(0)
    with torch.device(device):
        model = MaskGitTransformer(MaskGitTransformer.config_from_dict(tcfg))
    return TrainState(model=model, optimizer=get_optimizer("adamw", model, lambda count: 1e-4,
                                                           weight_decay=0.01))


def _v1_step(kind, tcfg, **kwargs):
    """The class or v1 text step of ``tcfg`` under bf16 autocast."""
    from open_muse_tpu_torch.ops.sampling import get_mask_schedule
    from open_muse_tpu_torch.training import trainer as T

    make = T.make_maskgit_train_step if kind == "class" else T.make_v1_text2image_train_step
    return make(get_mask_schedule("cosine"), tcfg["vocab_size"] - 1,
                codebook_size=tcfg["codebook_size"], autocast_dtype=torch.bfloat16, **kwargs)


def _v1_batch(kind, device, b, seed=31):
    gen = torch.Generator(device=device).manual_seed(seed)
    codebook = 1024 if kind == "class" else 8192
    batch = {"image_tokens": torch.randint(0, codebook, (b, 256), generator=gen, device=device)}
    if kind == "class":
        batch["class_ids"] = torch.randint(0, 1000, (b,), generator=gen, device=device)
    else:
        batch["encoder_hidden_states"] = torch.randn(b, TEXT_LEN, 1024, generator=gen,
                                                     device=device)
    return batch


def host_median(fn, calls=3):
    """Median host-clock seconds of ``calls`` synchronised ``fn()``."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def v1_train_eq(kind, tcfg, device, b, **step_kwargs):
    """The captured v1 step against its eager body on two copies of one
    seeded full-width state (bf16 autocast, cuDNN deterministic), noise from
    generators of one seed, the model's dropout as configured (0: nothing
    is drawn): TRAIN_EQ_STEPS steps; every metric, parameter and AdamW
    moment bit-equal."""
    from open_muse_tpu_torch.training.masking import draw_masking_noise

    torch.backends.cudnn.deterministic = True
    step = _v1_step(kind, tcfg, **step_kwargs)
    states = [_seeded_v1_state(device, tcfg) for _ in range(2)]
    gens = [torch.Generator(device=device).manual_seed(23) for _ in range(2)]
    batch = _v1_batch(kind, device, b)
    cond = kind == "text"
    rows, metrics_equal = [], True
    for _ in range(TRAIN_EQ_STEPS):
        noise = [draw_masking_noise(b, 256, g, tcfg["codebook_size"], cond_dropout=cond)
                 for g in gens]
        got = step(states[0], batch, noise[0])
        want = step.eager(states[1], batch, noise[1])
        metrics_equal &= all(torch.equal(got[k], want[k]) for k in want)
        rows.append(f"{float(got['loss']):.6f}/{float(want['loss']):.6f} "
                    f"{float(got['grad_norm']):.6f}/{float(want['grad_norm']):.6f}")
    worst = _worst_diffs(*states)
    equal = metrics_equal and all(v == 0.0 for v in worst.values())
    log(f"[train_eq] {kind} step, batch {b}, {TRAIN_EQ_STEPS} steps captured / eager: loss and "
        f"grad_norm per step {'; '.join(rows)}; every metric bit-equal {metrics_equal}; worst "
        f"|captured - eager| " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" {'ok' if equal else 'FAIL'}")
    torch.backends.cudnn.deterministic = False
    del states, step
    gc.collect()
    torch.cuda.empty_cache()
    return equal


def v1_dropout_check(device):
    """One captured class step at ``hidden_dropout`` 0.1 (configs/imagenet.yaml
    otherwise, batch CLASS_B): the keep masks come from ``KeepMasks`` on its
    own CUDA generator, registered with the step's graph; a recording
    subclass copies each site's kept share and first 4096 mask values into
    buffers outside the graph.  Call 1 is the eager warm-up (and the
    capture), calls 2 and 3 replays.  Gates: every site's share of each
    replay within 0.9 +- V1_DROPOUT_TOL, every site's masks differing
    between the two replays and from the warm-up's, the losses finite."""
    from open_muse_tpu_torch.models.transformer_v1 import KeepMasks
    from open_muse_tpu_torch.training.masking import draw_masking_noise

    tcfg = v1_config("imagenet", hidden_dropout=0.1)
    sites = 1 + tcfg["num_hidden_layers"]

    class Recording(KeepMasks):
        def __init__(self, generator):
            super().__init__(generator)
            self.calls = 0
            self.shares = torch.zeros(sites, device=device)
            self.heads = torch.zeros(sites, 4096, dtype=torch.bool, device=device)

        def __call__(self, shape, keep_prob, device):
            keep = super().__call__(shape, keep_prob, device)
            i = self.calls % sites
            self.calls += 1
            self.shares[i].copy_(keep.float().mean())
            self.heads[i].copy_(keep.reshape(-1)[:4096])
            return keep

    masks = Recording(torch.Generator(device=device).manual_seed(17))
    step = _v1_step("class", tcfg, dropout=masks)
    state = _seeded_v1_state(device, tcfg)
    batch = _v1_batch("class", device, CLASS_B)
    gen = torch.Generator(device=device).manual_seed(29)
    shares, heads, losses = [], [], []
    for _ in range(3):
        metrics = step(state, batch, draw_masking_noise(CLASS_B, 256, gen, 1024))
        torch.cuda.synchronize()
        losses.append(float(metrics["loss"]))
        shares.append(masks.shares.clone())
        heads.append(masks.heads.clone())
    worst = max((s - 0.9).abs().max().item() for s in shares[1:])
    fresh = all(bool((heads[a][i] != heads[b][i]).any())
                for a, b in ((1, 2), (0, 1)) for i in range(sites))
    finite = all(math.isfinite(v) for v in losses)
    ok = worst <= V1_DROPOUT_TOL and fresh and finite and masks.calls == 2 * sites
    log(f"[v1_dropout] class step at hidden_dropout 0.1, batch {CLASS_B}, {sites} sites "
        f"(embeddings, 24 FFNs), masks from a CUDA generator registered with the graph: kept "
        f"share by site, replay 1 {[round(v, 4) for v in shares[1].tolist()]}, replay 2 "
        f"{[round(v, 4) for v in shares[2].tolist()]}; worst |share - 0.9| {worst:.5f} (bound "
        f"{V1_DROPOUT_TOL}); masks differ replay 1 / replay 2 and warm-up / replay 1 at every "
        f"site {fresh}; source calls {masks.calls} (warm-up + capture; a replay calls nothing); "
        f"losses {losses} {'ok' if ok else 'FAIL'}")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def _v1_run(tag, entry, argv, out, expected, steps):
    """``entry.main(argv)`` with the counters at 0 just before it: (state,
    launches, median step s, peak bytes, step 1's capture s, ok), and the
    per-step lines."""
    from open_muse_tpu_torch import kernels

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state = entry.main(argv)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    median, logged = _step_lines(tag, _logged(out))
    finite = all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in logged)
    steps_ok = [m["step"] for m in logged] == list(range(1, steps + 1))
    counts_ok = launches == expected
    log(f"[{tag}] {steps} steps in {wall:.1f} s (model build and checkpoint included): losses "
        f"finite {finite}, first {logged[0]['loss']:.4f} last {logged[-1]['loss']:.4f}; "
        f"launches {launches} (expected {expected}) {'ok' if counts_ok else 'FAIL'}")
    capture = [m["capture_s"] for m in logged if "capture_s" in m]
    return state, launches, median, peak, capture, finite and steps_ok and counts_ok


def train_class_phase(device, smi):
    """train_maskgit_imagenet.main on configs/imagenet.yaml at batch CLASS_B
    over a shard of CLASS_IMAGES seeded 256px PNGs with class ids, a seeded
    MaskGIT VQGAN directory; the panel once; then a resume, the encode and
    the step timed apart, one profiled encode + step, ``[train_eq]`` and
    ``[v1_dropout]``.  Returns (ok, launch counts)."""
    import shutil
    import tempfile

    import numpy as np

    from open_muse_tpu_torch.models.maskgit_vqgan import MaskGitVQGAN, MaskGitVQGANConfig
    from open_muse_tpu_torch.training import train_maskgit_imagenet
    from open_muse_tpu_torch.training.data import ClassificationDataset
    from open_muse_tpu_torch.training.masking import draw_masking_noise
    from open_muse_tpu_torch.training.train_muse import get_code, load_vq_model
    from open_muse_tpu_torch.utils.config import load_config

    runs = os.path.join(HERE, "runs")
    os.makedirs(runs, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_train_class_", dir=runs)
    try:
        shard = os.path.join(work, "imagenet-000.tar")
        classes = np.random.RandomState(8).randint(0, 1000, CLASS_IMAGES)
        write_image_shard(shard, CLASS_IMAGES, seed=8, classes=classes)
        vq_dir = os.path.join(work, "maskgit_vqgan")
        with torch.device(device):
            vq = MaskGitVQGAN(MaskGitVQGANConfig())
        randomize_(vq, 12)
        vq.save_pretrained(vq_dir)
        del vq
        out = os.path.join(work, "out")
        argv = ["config=" + os.path.join(HERE, "configs", "imagenet.yaml"),
                f"dataset.params.train_shards_path_or_url={shard}",
                "dataset.params.shuffle_buffer_size=64", f"experiment.output_dir={out}",
                "experiment.log_every=1", f"experiment.save_every={V1_STEPS}",
                f"experiment.generate_every={CLASS_PANEL_EVERY}",
                f"model.vq_model.pretrained={vq_dir}", f"training.batch_size={CLASS_B}",
                "lr_scheduler.params.warmup_steps=0", f"training.max_train_steps={V1_STEPS}"]
        for arg in argv:
            log(f"[train_class] argument {arg}")
        config = load_config(argv)
        tcfg = config.model.transformer.to_dict()
        log(f"[train_class] cuts of configs/imagenet.yaml: batch 256 -> {CLASS_B}, warmup 1000 "
            f"-> 0, {V1_STEPS} steps, generate_every 1000 -> {CLASS_PANEL_EVERY}; a seeded MaskGIT "
            f"VQGAN; {CLASS_IMAGES} seeded 256px PNGs, class ids in [0, 1000); as written: "
            f"{tcfg['num_hidden_layers']} layers, hidden {tcfg['hidden_size']}, "
            f"{tcfg['num_attention_heads']} heads, hidden_dropout {tcfg['hidden_dropout']}, "
            f"use_ema {config.training.use_ema}, {config.training.mixed_precision}")
        expected = class_launches(tcfg, V1_STEPS, V1_STEPS // CLASS_PANEL_EVERY)
        state, launches, median, peak, capture, ok = _v1_run(
            "train_class", train_maskgit_imagenet, argv, out, expected, V1_STEPS)
        panels = [f"samples-{s}.png" for s in range(CLASS_PANEL_EVERY, V1_STEPS + 1,
                                                       CLASS_PANEL_EVERY)]
        panel_ok = all(os.path.isfile(os.path.join(out, name)) for name in panels)
        params = sum(p.numel() for p in state.model.parameters())
        log(f"[train_class] {params / 1e6:.1f} M params; {panels} {panel_ok}; "
            f"median step {median * 1e3:.1f} ms over steps 2-{V1_STEPS} (host clock, "
            f"synchronised; encode and step), {CLASS_B * 256 / median:.0f} image tokens/s, "
            f"{CLASS_B / median:.2f} images/s, peak memory {peak / 2 ** 30:.2f} GiB "
            f"(max_memory_allocated), step 1's capture {capture} s; on {smi}")
        resume_ok = _resume_check("train_class", train_maskgit_imagenet, argv, state, out,
                                  V1_STEPS)

        vq_model = load_vq_model(config, device)
        raw = next(iter(ClassificationDataset(shard, CLASS_B, resolution=256,
                                              shuffle_buffer_size=64, seed=5)))
        pixels = torch.from_numpy(raw["pixel_values"]).to(device)
        class_ids = torch.from_numpy(raw["class_ids"]).to(device).long()
        step = _v1_step("class", tcfg)
        gen = torch.Generator(device=device).manual_seed(4)

        def encode():
            return get_code(vq_model, pixels).long()

        def train(tokens):
            noise = draw_masking_noise(CLASS_B, 256, gen, tcfg["codebook_size"])
            return float(step(state, {"image_tokens": tokens, "class_ids": class_ids},
                              noise)["loss"])

        tokens = encode()
        train(tokens)  # the warm-up step and the capture
        encode_s = host_median(encode)
        step_s = host_median(lambda: train(tokens))
        both_s = host_median(lambda: train(encode()))
        log(f"[train_class] apart (host clock, synchronised, median of 3): the fp32 MaskGIT "
            f"VQGAN encode of {CLASS_B} images {encode_s * 1e3:.1f} ms, the captured step "
            f"{step_s * 1e3:.1f} ms ({CLASS_B * 256 / step_s:.0f} image tokens/s), both "
            f"{both_s * 1e3:.1f} ms; on {smi}")
        profiled("class train step (encode + one replayed graph)", lambda: train(encode()),
                 both_s, "profile_train_class_step.txt", smi=smi)
        del state, step, vq_model
        gc.collect()
        torch.cuda.empty_cache()
        eq_ok = v1_train_eq("class", tcfg, device, CLASS_B)
        dropout_ok = v1_dropout_check(device)
        return ok and panel_ok and resume_ok and eq_ok and dropout_ok, launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def train_v1_text_phase(device, smi):
    """train_muse.main on configs/cc12m.yaml (architecture transformer) with
    training.pre_encode at batch TEXT_B over a seeded pre-encoded shard
    (T5-sized text states), one batch repeated; then a resume, the step
    timed and profiled apart, and ``[train_eq]``.  Returns (ok, launch
    counts)."""
    import shutil
    import tempfile

    from open_muse_tpu_torch.training import train_muse
    from open_muse_tpu_torch.training.masking import draw_masking_noise
    from open_muse_tpu_torch.utils.config import load_config

    runs = os.path.join(HERE, "runs")
    os.makedirs(runs, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_train_v1_text_", dir=runs)
    try:
        shard = os.path.join(work, "cc12m-000.tar")
        write_shard(shard, samples=TEXT_B, seed=9, text=(TEXT_LEN, 1024), pooled=False)
        out = os.path.join(work, "out")
        argv = ["config=" + os.path.join(HERE, "configs", "cc12m.yaml"),
                f"dataset.params.train_shards_path_or_url={shard}",
                "dataset.params.shuffle_buffer_size=16", f"experiment.output_dir={out}",
                "experiment.log_every=1", f"experiment.save_every={V1_STEPS}",
                f"training.batch_size={TEXT_B}", "training.pre_encode=true",
                "training.overfit_one_batch=true", "lr_scheduler.params.warmup_steps=0",
                f"training.max_train_steps={V1_STEPS}"]
        for arg in argv:
            log(f"[train_v1_text] argument {arg}")
        config = load_config(argv)
        tcfg = config.model.transformer.to_dict()
        log(f"[train_v1_text] cuts of configs/cc12m.yaml: warmup 2000 -> 0, {V1_STEPS} steps, "
            f"one synthetic pre-encoded batch repeated (tokens (256,) in [0, 8192), text states "
            f"({TEXT_LEN}, 1024) for the T5 tower's, which pre-encoding leaves out); as written: "
            f"batch {config.training.batch_size}, {tcfg['num_hidden_layers']} layers, hidden "
            f"{tcfg['hidden_size']}, {tcfg['norm_type']}, cond_dropout_prob "
            f"{config.training.cond_dropout_prob}, hidden_dropout {tcfg['hidden_dropout']}, "
            f"use_ema {config.training.use_ema}, {config.training.mixed_precision}")
        expected = v1_forward_launches(tcfg, V1_STEPS)
        state, launches, median, peak, capture, ok = _v1_run(
            "train_v1_text", train_muse, argv, out, expected, V1_STEPS)
        params = sum(p.numel() for p in state.model.parameters())
        log(f"[train_v1_text] {params / 1e6:.1f} M params; median step {median * 1e3:.1f} ms "
            f"over steps 2-{V1_STEPS} (host clock, synchronised), "
            f"{TEXT_B * 256 / median:.0f} image tokens/s, {TEXT_B / median:.2f} images/s, peak "
            f"memory {peak / 2 ** 30:.2f} GiB (max_memory_allocated), step 1's capture "
            f"{capture} s; on {smi}")
        resume_ok = _resume_check("train_v1_text", train_muse, argv, state, out, V1_STEPS)
        step = _v1_step("text", tcfg, cond_dropout_prob=config.training.cond_dropout_prob)
        batch = _v1_batch("text", device, TEXT_B)
        gen = torch.Generator(device=device).manual_seed(4)

        def train():
            noise = draw_masking_noise(TEXT_B, 256, gen, tcfg["codebook_size"],
                                       cond_dropout=True)
            return float(step(state, batch, noise)["loss"])

        train()  # the warm-up step and the capture
        step_s = host_median(train)
        log(f"[train_v1_text] the captured step alone (host clock, synchronised, median of 3) "
            f"{step_s * 1e3:.1f} ms; on {smi}")
        profiled("v1 text train step (one replayed graph)", train, step_s,
                 "profile_train_v1_text_step.txt", smi=smi)
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
        eq_ok = v1_train_eq("text", tcfg, device, TEXT_B,
                            cond_dropout_prob=config.training.cond_dropout_prob)
        return ok and resume_ok and eq_ok, launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


# -- the tokenizer's trainer and soft targets at full width -------------------

# configs/vqgan_gan.yaml at its batch of 8; 8 steps with disc_start 10000 cut
# to 4, so that steps 1 - 4 run gated and 5 - 8 adversarial; 1024 seeded PNGs
VQGAN_STEPS, VQGAN_B, VQGAN_IMAGES, VQGAN_DISC_START = 8, 8, 1024, 4
# [train_eq] for the VQGAN: two full-width states and the graph's pool at
# batch 4, not 8: near the card's memory, a convolution whose cuDNN plan
# cannot get its workspace falls back to another plan, so a graph captured
# while memory was free and an eager step run under pressure differ in the
# last bits (a fragmented allocator showed it; a fresh one is bit-equal)
VQGAN_EQ_STEPS, VQGAN_EQ_B = 3, 4
# kernel 6's ids on a step's latents against the plain search, and the soft
# codes' argmin against kernel 6's: the least share of equal ids
VQ_AGREE_MIN = 0.999


def _vqgan_players(device, config, seed=0):
    """configs/vqgan_gan.yaml's generator and discriminator from one seed,
    each with AdamW at a constant lr of the config (its weight decay and
    clipping), and the step (the seeded perceptual pyramid, the hinge
    PatchGAN) at disc_start 1."""
    from open_muse_tpu_torch.models.discriminator import PatchDiscriminator
    from open_muse_tpu_torch.models.maskgit_vqgan import MaskGitVQGAN
    from open_muse_tpu_torch.ops.perceptual import make_perceptual_loss_fn
    from open_muse_tpu_torch.training.optimizers import get_optimizer
    from open_muse_tpu_torch.training.trainer import TrainState, make_vqgan_train_step

    t, opt = config.training, config.optimizer.params
    torch.manual_seed(seed)
    with torch.device(device):
        models = (MaskGitVQGAN(**config.model.vq_model.params.to_dict()),
                  PatchDiscriminator(base_channels=t.disc_channels, n_layers=t.disc_layers))
        perceptual = make_perceptual_loss_fn(seed)
    players = tuple(TrainState(model=m, optimizer=get_optimizer(
        "adamw", m, lambda count: float(opt.learning_rate), weight_decay=opt.weight_decay,
        max_grad_norm=t.max_grad_norm)) for m in models)
    step = make_vqgan_train_step(perceptual_weight=t.perceptual_weight, perceptual=perceptual,
                                 disc_weight=t.disc_weight, disc_start=1, disc_loss=t.disc_loss)
    return players, step


def _vqgan_state_diffs(a, b):
    """The worst |a - b| of both players' parameters and AdamW moments."""
    worst = {}
    for kind, x, y in zip(("generator", "discriminator"), a, b):
        for p, q in zip(x.model.parameters(), y.model.parameters()):
            pairs = [("params", p, q)] + [
                (f"AdamW {k}", v, y.optimizer.torch_optimizer.state[q][k])
                for k, v in x.optimizer.torch_optimizer.state[p].items()]
            for what, u, v in pairs:
                key = f"{kind} {what}"
                worst[key] = max(worst.get(key, 0.0), (u.float() - v.float()).abs().max().item())
    return worst


def vqgan_train_eq(device, config, pixels):
    """The captured VQGAN step against its eager body on two copies of one
    seeded full-width state at batch VQGAN_EQ_B, cuDNN deterministic:
    VQGAN_EQ_STEPS steps at disc_start 1 (step 1 gated: the warm-up and the
    capture; then adversarial replays of the same graph); every metric and
    both players' parameters and AdamW moments bit-equal, the graph
    launching vq_argmin once.  Where not, a third state run eagerly tells
    whether the eager step is itself nondeterministic."""
    torch.backends.cudnn.deterministic = True
    log(f"[train_eq] vqgan at batch {VQGAN_EQ_B}; the allocator before it: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved")
    try:
        a, step = _vqgan_players(device, config)
        b, _ = _vqgan_players(device, config)
        batch = {"pixel_values": pixels}
        rows, metrics_equal = [], True
        for _ in range(VQGAN_EQ_STEPS):
            got, want = step(a, batch), step.eager(b, batch)
            metrics_equal &= sorted(got) == sorted(want) and all(
                torch.equal(got[k], want[k]) for k in want)
            rows.append(f"{float(got['loss']):.6f}/{float(want['loss']):.6f} d_weight "
                        f"{float(got['d_weight']):.4f}/{float(want['d_weight']):.4f}")
        worst = _vqgan_state_diffs(a, b)
        launches = step.last_capture.get("launches")
        equal = (metrics_equal and all(v == 0.0 for v in worst.values())
                 and launches == {"vq_argmin": 1})
        log(f"[train_eq] vqgan, {VQGAN_EQ_STEPS} steps captured / eager (cuDNN deterministic): "
            f"loss and d_weight per step {'; '.join(rows)}; every metric bit-equal "
            f"{metrics_equal}; worst |captured - eager| "
            + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
            + f"; a replay's launches {launches} {'ok' if equal else 'FAIL'}")
        if not equal:
            c, _ = _vqgan_players(device, config)
            for _ in range(VQGAN_EQ_STEPS):
                step.eager(c, batch)
            log("[train_eq] vqgan eager against eager: worst " + ", ".join(
                f"{k} {v:.3e}" for k, v in _vqgan_state_diffs(b, c).items()))
            del c
        del a, b, step
        return equal
    finally:
        torch.backends.cudnn.deterministic = False
        gc.collect()
        torch.cuda.empty_cache()


def train_vqgan_phase(device, smi):
    """train_vqgan.main on configs/vqgan_gan.yaml as written but for the cuts
    (its own seeded shard, 8 steps, warmup 0, disc_start 4, a checkpoint and
    the recon panel at step 8, log every step, shuffle buffer 64): losses
    finite, d_weight and d_loss exactly 0 through step 4 and finite and
    non-zero after; vq_argmin once a step and once for the panel; the panel
    and both checkpoints written, the VQ directory reloaded by
    from_pretrained with the trained model's ids; kernel 6's ids on a step's
    latents against the plain search; the step time, images/s, peak memory,
    capture time and a profiled step; then [train_eq].  Returns (ok,
    launch counts)."""
    import shutil
    import tempfile

    from open_muse_tpu_torch import kernels
    from open_muse_tpu_torch.kernels.vq_argmin import vq_argmin, vq_argmin_plain
    from open_muse_tpu_torch.models.maskgit_vqgan import MaskGitVQGAN
    from open_muse_tpu_torch.training import train_vqgan
    from open_muse_tpu_torch.utils.config import load_config

    runs = os.path.join(HERE, "runs")
    os.makedirs(runs, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_train_vqgan_", dir=runs)
    try:
        shard = os.path.join(work, "raw-000.tar")
        images = write_image_shard(shard, VQGAN_IMAGES, seed=7)
        out = os.path.join(work, "out")
        config_path = os.path.join(HERE, "configs", "vqgan_gan.yaml")
        argv = ["config=" + config_path, f"dataset.params.train_shards_path_or_url={shard}",
                "dataset.params.shuffle_buffer_size=64", f"experiment.output_dir={out}",
                "experiment.log_every=1", f"experiment.save_every={VQGAN_STEPS}",
                f"experiment.generate_every={VQGAN_STEPS}",
                f"training.max_train_steps={VQGAN_STEPS}", "lr_scheduler.params.warmup_steps=0",
                f"training.disc_start={VQGAN_DISC_START}"]
        for arg in argv:
            log(f"[train_vqgan] argument {arg}")
        config = load_config(argv)
        t = config.training
        log(f"[train_vqgan] cuts of configs/vqgan_gan.yaml: the s3 shards -> {VQGAN_IMAGES} "
            f"seeded 256px PNGs, max_train_steps 500000 -> {VQGAN_STEPS}, warmup 500 -> 0, "
            f"disc_start 10000 -> {VQGAN_DISC_START}, save_every / generate_every -> "
            f"{VQGAN_STEPS}, shuffle buffer 1000 -> 64; as written: batch {t.batch_size}, "
            f"{config.model.vq_model.params.to_dict()}, perceptual_weight "
            f"{t.perceptual_weight}, disc_weight {t.disc_weight} ({t.disc_loss}, "
            f"{t.disc_channels} channels, {t.disc_layers} layers), fp32, TF32 off")
        expected = zero_counts()
        expected["vq_argmin"] = VQGAN_STEPS + 1  # a step each, and the recon panel
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        players = train_vqgan.main(argv)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        steps = [m for m in _logged(out) if "loss" in m]
        keys = ("loss", "grad_norm", "l2", "l1", "perceptual", "vq_loss", "g_loss", "d_loss",
                "d_weight", "logits_real", "logits_fake")
        for m in steps:
            log(f"[train_vqgan] step {m['step']}: " + " ".join(f"{k} {m[k]:.4g}" for k in keys)
                + f" step_time {m['step_time'] * 1e3:.1f} ms"
                + (f" (eager warm-up step + capture; the capture alone {m['capture_s']:.2f} s)"
                   if "capture_s" in m else ""))
        finite = all(math.isfinite(m[k]) for m in steps for k in keys)
        gated = all(m["d_weight"] == 0.0 and m["d_loss"] == 0.0
                    for m in steps if m["step"] <= VQGAN_DISC_START)
        adversarial = all(m["d_weight"] != 0.0 and m["d_loss"] != 0.0
                          for m in steps if m["step"] > VQGAN_DISC_START)
        steps_ok = [m["step"] for m in steps] == list(range(1, VQGAN_STEPS + 1))
        median = statistics.median(m["step_time"] for m in steps[1:])
        STEP_MS["train_vqgan"] = median * 1e3
        counts_ok = launches == expected
        panel = os.path.join(out, f"recon-{VQGAN_STEPS}.png")
        saved = os.path.join(out, f"checkpoint-{VQGAN_STEPS}", "unwrapped_model")
        disc_saved = os.path.join(out, "discriminator", f"checkpoint-{VQGAN_STEPS}")
        files_ok = all(os.path.exists(f) for f in (panel, saved, disc_saved))
        pixels = torch.from_numpy(images[:VQGAN_B].astype("float32") / 255.0).to(device)
        model = players[0].model
        with torch.no_grad():
            latents = model._latents(pixels).reshape(-1, model.config.quantized_embed_dim)
            ids = vq_argmin(latents, model.quantize.weight)
            agree = (ids == vq_argmin_plain(latents, model.quantize.weight)).float().mean()
            reloaded = MaskGitVQGAN.from_pretrained(saved, device=device)
            reload_ok = torch.equal(reloaded.get_code(pixels), model.get_code(pixels))
        agree_ok = float(agree) >= VQ_AGREE_MIN
        log(f"[train_vqgan] {VQGAN_STEPS} steps in {wall:.1f} s (model build, data and "
            f"checkpoints included): losses finite {finite}; d_weight and d_loss 0 through step "
            f"{VQGAN_DISC_START} {gated}, non-zero after {adversarial}; "
            f"{os.path.basename(panel)}, checkpoint-{VQGAN_STEPS}/unwrapped_model and "
            f"discriminator/checkpoint-{VQGAN_STEPS} written {files_ok}; the saved VQ reloaded "
            f"by from_pretrained gives the trained model's ids {reload_ok}")
        log(f"[train_vqgan] launches {launches} (expected {expected}: vq_argmin once a step in "
            f"the graph, once for the panel) {'ok' if counts_ok else 'FAIL'}")
        log(f"[train_vqgan] vq_argmin ids on a step's latents ({tuple(latents.shape)} x "
            f"{tuple(model.quantize.weight.shape)}) equal to vq_argmin_plain: {float(agree):.5f} "
            f"(>= {VQ_AGREE_MIN}) {'ok' if agree_ok else 'FAIL'}")
        log(f"[train_vqgan] median step {median * 1e3:.1f} ms over steps 2-{VQGAN_STEPS} (host "
            f"clock, synchronised; data loading included), {VQGAN_B / median:.2f} images/s, peak "
            f"memory {peak / 2 ** 30:.2f} GiB (max_memory_allocated) on {smi}")
        del players, model, reloaded, latents
        gc.collect()
        torch.cuda.empty_cache()
        # a step on fresh players of the same shapes: its graph, then one profiled replay
        prof_players, prof_step = _vqgan_players(device, config)
        batch = {"pixel_values": pixels}
        prof_step(prof_players, batch)
        prof_step(prof_players, batch)
        profiled("vqgan train step (one replayed graph, both players)",
                 lambda: float(prof_step(prof_players, batch)["loss"]), median,
                 "profile_train_vqgan_step.txt", smi=smi, span=True)
        del prof_players, prof_step
        gc.collect()
        torch.cuda.empty_cache()
        eq_ok = vqgan_train_eq(device, config, pixels[:VQGAN_EQ_B])
        ok = (finite and gated and adversarial and steps_ok and counts_ok and files_ok
              and reload_ok and agree_ok and eq_ok)
        return ok, launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def train_soft_phase(device, smi):
    """train_muse.main on the flagship config's raw branch with
    use_soft_code_target (temp 1, deterministic codes) at batch 16 over the
    seeded f16 VQGAN's 8192 codes, 8 steps on one repeated batch, the step
    as train_raw's (bucket diagnostics and per-parameter norms in it) but
    for its loss and encode, with no eval or panel: losses
    finite and falling, launches exact (the soft code is plain torch: no
    vq_argmin), the soft codes' argmin against kernel 6's ids on the same
    latents, the step time beside train_raw's and a profiled step; then
    [train_eq] for the soft-target step.  Returns (ok, launch counts)."""
    import shutil
    import tempfile

    from open_muse_tpu_torch import kernels
    from open_muse_tpu_torch.kernels.vq_argmin import vq_argmin
    from open_muse_tpu_torch.training import train_muse
    from open_muse_tpu_torch.training.data import Text2ImageDataset
    from open_muse_tpu_torch.utils.config import load_config

    runs = os.path.join(HERE, "runs")
    os.makedirs(runs, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_train_soft_", dir=runs)
    try:
        shard = os.path.join(work, "raw-000.tar")
        write_image_shard(shard, RAW_IMAGES, seed=3)
        clip_dir, vq_dir = raw_encoder_dirs(work, device)
        out = os.path.join(work, "out")
        argv = ["config=" + os.path.join(HERE, "configs", "laiona6plus_uvit_clip.yaml"),
                f"dataset.params.train_shards_path_or_url={shard}",
                "dataset.params.shuffle_buffer_size=16", f"experiment.output_dir={out}",
                "experiment.log_every=1", f"experiment.save_every={TRAIN_STEPS}",
                "experiment.generate_every=1000", "experiment.eval_every=1000",
                f"experiment.log_grad_norm_every={TRAIN_STEPS}",
                "experiment.log_entropy_buckets=true",
                f"model.text_encoder.pretrained={clip_dir}", f"model.vq_model.pretrained={vq_dir}",
                f"training.batch_size={TRAIN_B}", "training.overfit_one_batch=true",
                "lr_scheduler.params.warmup_steps=0", f"training.max_train_steps={TRAIN_STEPS}",
                "training.use_soft_code_target=true"]
        for arg in argv:
            log(f"[train_soft] argument {arg}")
        config = load_config(argv)
        expected = train_launches(TRAIN_STEPS)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state = train_muse.main(argv)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        median, steps = _step_lines("train_soft", _logged(out))
        STEP_MS["train_soft"] = median * 1e3
        losses = [m["loss"] for m in steps]
        finite = all(math.isfinite(v) for v in losses)
        falling = losses[-1] < losses[0]
        counts_ok = launches == expected
        log(f"[train_soft] {TRAIN_STEPS} steps in {wall:.1f} s (encoder and model build and "
            f"checkpoint included): losses finite {finite}, last {losses[-1]:.4f} < first "
            f"{losses[0]:.4f} {falling}")
        log(f"[train_soft] launches {launches} (expected {expected}: the train steps' alone) "
            f"{'ok' if counts_ok else 'FAIL'}")
        log(f"[train_soft] median step {median * 1e3:.1f} ms over steps 2-{TRAIN_STEPS} (host "
            f"clock, synchronised; soft-code encode and step) beside train_raw's "
            f"{STEP_MS.get('train_raw', float('nan')):.1f} ms, {TRAIN_B * TRAIN_S / median:.0f} "
            f"tokens/s, peak memory {peak / 2 ** 30:.2f} GiB (max_memory_allocated) on {smi}")
        encoders = train_muse.FrozenEncoders.from_config(config, device)
        raw = next(iter(Text2ImageDataset(shard, TRAIN_B, resolution=256, shuffle_buffer_size=16,
                                          seed=5)))
        vq = encoders.vq_model
        with torch.no_grad():
            latents = vq._latents(torch.from_numpy(raw["pixel_values"]).to(device))
            _, codes = vq.quantize.get_soft_code(latents, config.training.get("soft_code_temp",
                                                                                 1.0))
            ids = vq_argmin(latents.reshape(-1, latents.shape[-1]), vq.quantize.weight)
        agree = float((codes.reshape(-1) == ids.long()).float().mean())
        agree_ok = agree >= VQ_AGREE_MIN
        log(f"[train_soft] the soft codes' argmin (torch.argmin over the sq_l2 distances) equal to "
            f"vq_argmin's ids on the same latents ({tuple(latents.shape)}): {agree:.5f} (>= "
            f"{VQ_AGREE_MIN}) {'ok' if agree_ok else 'FAIL'}")
        empty = encoders.empty_embeds()
        profile_train_step(state, device, median, label="soft-target raw step (encode + step)",
                           filename="profile_train_soft_step.txt",
                           prepare=lambda: {**encoders.prepare_batch(raw), **empty},
                           cond_dropout_prob=0.1, with_diagnostics=True,
                           with_param_grad_norms=True, use_soft_targets=True)
        del state, encoders
        gc.collect()
        torch.cuda.empty_cache()
        eq_ok = train_eq_phase(device, soft_targets=True)
        return finite and falling and counts_ok and agree_ok and eq_ok, launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


# -- the other optimizers, step + guidance distillation, MOVQ class training --

OPTIMIZER_NAMES = ("8bit_adamw", "bf16_adamw", "lion")
OPT_EQ_STEPS, OPT_TIMED_STEPS = 3, 4


def optimizer_state_bytes(optimizer):
    """Bytes of the optimizer's state tensors (moments or their codes and
    absmax, step counts)."""
    return sum(v.numel() * v.element_size() for s in optimizer.torch_optimizer.state.values()
               for v in s.values() if isinstance(v, torch.Tensor))


def train_opt_phase(device, smi):
    """The training phase's pre-encoded flagship step (batch 16, bf16
    autocast, per-layer checkpointing, EMA) with each of OPTIMIZER_NAMES:
    OPT_EQ_STEPS steps captured against ``step.eager`` on a second seeded
    state (every metric, parameter, state tensor and EMA bit-equal, cuDNN
    deterministic), then OPT_TIMED_STEPS more captured steps with the
    counters at 0 (launches exact, step time, peak memory, the loss falling
    over all steps), step time, peak memory and the optimizer state's bytes
    beside AdamW's, timed first the same way, then ``save_checkpoint`` ->
    ``load_checkpoint`` into a fresh
    state and one more step on both: bit-equal.  Returns (ok, the timed
    steps' launch counts summed over the three)."""
    import shutil
    import tempfile

    from open_muse_tpu_torch import kernels
    from open_muse_tpu_torch.training import trainer as T
    from open_muse_tpu_torch.training.masking import draw_masking_noise

    runs = os.path.join(HERE, "runs")
    os.makedirs(runs, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_train_opt_", dir=runs)
    torch.backends.cudnn.deterministic = True
    batch = train_batch(device)
    launches, ok = zero_counts(), True

    def timed(step, state, gen, losses):
        """OPT_TIMED_STEPS captured steps, the counters at 0 before them:
        (median s, launch counts, peak bytes)."""
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        times = []
        for _ in range(OPT_TIMED_STEPS):
            noise = draw_masking_noise(TRAIN_B, TRAIN_S, gen, 8192)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(state, batch, noise)["loss"]))
            times.append(time.perf_counter() - t0)
        return statistics.median(times), kernels.launch_counts(), torch.cuda.max_memory_allocated()

    try:
        step, state = _research_step(), _seeded_train_state(device)
        gen = torch.Generator(device=device).manual_seed(21)
        step(state, batch, draw_masking_noise(TRAIN_B, TRAIN_S, gen, 8192))  # warm-up, capture
        adamw_s, _, adamw_peak = timed(step, state, gen, [])
        adamw_bytes = optimizer_state_bytes(state.optimizer)
        log(f"[train_opt] adamw (the yardstick): median step {adamw_s * 1e3:.1f} ms over "
            f"{OPT_TIMED_STEPS} captured steps (host clock, synchronised), peak memory "
            f"{adamw_peak / 2 ** 30:.2f} GiB, optimizer state {adamw_bytes / 2 ** 30:.3f} GiB; "
            f"on {smi}")
        del step, state
        gc.collect()
        torch.cuda.empty_cache()
        for name in OPTIMIZER_NAMES:
            step = _research_step()
            states = [_seeded_train_state(device, optimizer=name) for _ in range(2)]
            gens = [torch.Generator(device=device).manual_seed(21) for _ in range(2)]
            losses, metrics_equal = [], True
            for _ in range(OPT_EQ_STEPS):
                noise = [draw_masking_noise(TRAIN_B, TRAIN_S, g, 8192) for g in gens]
                got = step(states[0], batch, noise[0])
                want = step.eager(states[1], batch, noise[1])
                metrics_equal &= all(torch.equal(got[k], want[k]) for k in want)
                losses.append(float(got["loss"]))
            worst = _worst_diffs(*states)
            eq = metrics_equal and all(v == 0.0 for v in worst.values())
            log(f"[train_opt] {name}: {OPT_EQ_STEPS} steps captured / eager, every metric "
                f"bit-equal {metrics_equal}; worst |captured - eager| "
                + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
                + f" {'ok' if eq else 'FAIL'}")
            state = states[0]
            del states
            gc.collect()
            torch.cuda.empty_cache()
            median, counts, peak = timed(step, state, gens[0], losses)
            expected = train_launches(OPT_TIMED_STEPS)
            counts_ok = counts == expected
            for k, v in counts.items():
                launches[k] += v
            finite = all(math.isfinite(v) for v in losses)
            falling = losses[-1] < losses[0]
            n = sum(p.numel() for p in state.model.parameters())
            state_bytes = optimizer_state_bytes(state.optimizer)
            log(f"[train_opt] {name}: {OPT_TIMED_STEPS} captured steps (one replayed graph "
                f"each): losses {' '.join(f'{v:.4f}' for v in losses)} finite {finite}, "
                f"falling {falling}; launches {'ok' if counts_ok else 'FAIL'} "
                f"({ {k: v for k, v in counts.items() if v} }, expected "
                f"{ {k: v for k, v in expected.items() if v} })")
            log(f"[train_opt] {name}: median step {median * 1e3:.1f} ms (host clock, "
                f"synchronised) beside adamw's {adamw_s * 1e3:.1f} ms, "
                f"{TRAIN_B * TRAIN_S / median:.0f} tokens/s, peak memory {peak / 2 ** 30:.2f} GiB "
                f"(max_memory_allocated) beside adamw's {adamw_peak / 2 ** 30:.2f} GiB; optimizer "
                f"state {state_bytes / 2 ** 30:.3f} GiB = {state_bytes / n:.3f} bytes a parameter "
                f"beside adamw's {adamw_bytes / 2 ** 30:.3f} GiB = {adamw_bytes / n:.3f} over "
                f"{n / 1e6:.1f} M parameters; on {smi}")
            path = T.save_checkpoint(work, state)
            resumed = T.load_checkpoint(path, _seeded_train_state(device, optimizer=name))
            gen = [torch.Generator(device=device).manual_seed(33) for _ in range(2)]
            a, b = (step(s, batch, draw_masking_noise(TRAIN_B, TRAIN_S, g, 8192))
                    for s, g in zip((state, resumed), gen))
            resume_worst = _worst_diffs(state, resumed)
            resume_ok = (torch.equal(a["loss"], b["loss"]) and resumed.optimizer.count
                         == state.optimizer.count and all(v == 0.0 for v in resume_worst.values()))
            log(f"[train_opt] {name}: resumed from {os.path.basename(path)} (save_checkpoint, "
                f"load_checkpoint into a fresh state), one more step on both: loss "
                f"{float(a['loss']):.6f}/{float(b['loss']):.6f}, worst |resumed - straight| "
                + ", ".join(f"{k} {v:.3e}" for k, v in resume_worst.items())
                + f" {'ok' if resume_ok else 'FAIL'}")
            ok &= eq and counts_ok and finite and falling and resume_ok
            shutil.rmtree(path, ignore_errors=True)
            del state, resumed, step
            gc.collect()
            torch.cuda.empty_cache()
        return ok, launches
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(work, ignore_errors=True)


# configs/distill.yaml's batch, teacher steps and pairs; 8 steps
DISTILL_B, DISTILL_STEPS, DISTILL_T, DISTILL_RATIO = 64, 8, 12, 2
LATENCY_MS = {}  # request path -> captured median ms, for the paths that compare


def distill_launches(cfg, steps):
    """``steps`` distill steps: the teacher's 12-step CFG decode (as a
    request's, its step context once), its forward at the pair's state
    (the soft target) and the student's forward, each with the
    conditioning's encoder norm, and the student's backward kernels once a
    layer (no recompute: the config asks no checkpointing)."""
    expected = expected_request_launches(cfg, "fused_categorical_cfg", steps=DISTILL_T)
    for name, n in forward_launches(2).items():
        expected[name] += n
    for name in ("attn_sublayer_self_bwd", "attn_sublayer_cross_bwd", "glu_down_matmul_bwd"):
        expected[name] += LAYERS
    return {k: v * steps for k, v in expected.items()}


def _distill_state(device, teacher_dir):
    """The student as ``distill.main`` builds it: the saved teacher in fp32,
    AdamW at the config's lr and decay, an EMA."""
    from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2
    from open_muse_tpu_torch.training.ema import EMA
    from open_muse_tpu_torch.training.optimizers import get_optimizer
    from open_muse_tpu_torch.training.trainer import TrainState

    model = MaskGiTUViT_v2.from_pretrained(teacher_dir, device=device).float().train()
    return TrainState(model=model, optimizer=get_optimizer("adamw", model, lambda count: 5e-5,
                                                           weight_decay=0.01), ema=EMA(model))


def distill_eq(device, teacher_dir, clip_dir, smi, step_median):
    """The captured distill step against ``step.eager`` on two students of
    the saved teacher, 2 steps each on the same prompts and noise (every
    metric, parameter, AdamW moment and EMA bit-equal, cuDNN
    deterministic); the two steps' noise gives the teacher two different
    trajectories; then the teacher's and the student's shares of an eager
    step by CUDA events, a profiled captured step, and the student served
    in bf16.  Returns (ok, the student in bf16)."""
    import copy

    from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder, SimpleTokenizer
    from open_muse_tpu_torch.training import distill

    clip = CLIPTextEncoder.from_pretrained(clip_dir, device=device).float().eval()
    tokenizer = SimpleTokenizer(49408, 77)
    prompts = [PROMPTS[i % 4] for i in range(DISTILL_B)]
    ehs, pooled = distill.encode_prompts(clip, tokenizer, prompts, device)
    empty_ehs, empty_pooled = distill.encode_prompts(clip, tokenizer, [""], device)
    del clip
    batch = {"encoder_hidden_states": ehs, "cond_embeds": pooled,
             "micro_conds": torch.tensor([[256.0, 256.0, 0.0, 0.0, 6.0]] * DISTILL_B,
                                         device=device),
             "empty_embeds": empty_ehs, "empty_cond_embeds": empty_pooled}
    torch.backends.cudnn.deterministic = True
    states = [_distill_state(device, teacher_dir) for _ in range(2)]
    teacher = distill.frozen_teacher(states[0].model, torch.bfloat16)
    step = distill.make_distill_step(
        teacher, mask_token_id=8255, teacher_timesteps=DISTILL_T, step_ratio=DISTILL_RATIO,
        temperature=(2.0, 0.0), guidance_scale=8.0, seq_len=256, max_grad_norm=1.0,
        soft_weight=0.5, autocast_dtype=torch.bfloat16)

    def noise(seed):
        return distill.draw_distill_noise(torch.Generator().manual_seed(seed),
                                          timesteps=DISTILL_T, step_ratio=DISTILL_RATIO,
                                          batch=DISTILL_B, seq_len=256, codebook_size=8192,
                                          device=device)

    metrics_equal, rows, targets = True, [], []
    for seed in (101, 102):
        got = step(states[0], batch, noise(seed))
        want = step.eager(states[1], batch, noise(seed))
        metrics_equal &= all(torch.equal(got[k], want[k]) for k in want)
        rows.append(f"{float(got['loss']):.6f}/{float(want['loss']):.6f}")
        targets.append(distill.teacher_targets(step.spec, {**batch, **step.spec.step_inputs(
            0, device)}, noise(seed))[:2])
    fresh = not torch.equal(targets[0][0], targets[1][0]) and \
        not torch.equal(targets[0][1], targets[1][1])
    worst = _worst_diffs(*states)
    eq = metrics_equal and all(v == 0.0 for v in worst.values())
    log(f"[distill_eq] 2 distill steps captured / eager (batch {DISTILL_B}, the 12-step CFG "
        f"teacher, soft weight 0.5): loss {'; '.join(rows)}; every metric bit-equal "
        f"{metrics_equal}; worst |captured - eager| "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + f" {'ok' if eq else 'FAIL'}")
    log(f"[distill_eq] the two steps' noise gives the teacher different trajectories (the "
        f"pairs' carry-in states and targets differ): {fresh} {'ok' if fresh else 'FAIL'}")
    torch.backends.cudnn.deterministic = False
    state = states[0]
    del states
    gc.collect()
    torch.cuda.empty_cache()

    inputs = {**batch, **step.spec.step_inputs(0, device)}
    shares = []
    for seed in (103, 104, 105):
        n = noise(seed)
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        distill.teacher_targets(step.spec, inputs, n)
        marks[1].record()
        step.eager(state, batch, n)
        marks[2].record()
        marks[2].synchronize()
        shares.append((marks[0].elapsed_time(marks[1]), marks[1].elapsed_time(marks[2])))
    teacher_ms = statistics.median(s[0] for s in shares)
    step_ms = statistics.median(s[1] for s in shares)
    log(f"[distill] shares of an eager step by CUDA events (median of 3): the teacher's half "
        f"(the 12-step CFG decode at {2 * DISTILL_B} rows, the pair pick, the soft-target "
        f"forward) {teacher_ms:.1f} ms of the whole eager step {step_ms:.1f} ms = "
        f"{teacher_ms / step_ms:.3f}; the student's update (forward, backward, clip, AdamW, "
        f"EMA) the rest, {step_ms - teacher_ms:.1f} ms = {1 - teacher_ms / step_ms:.3f}; on {smi}")
    seeds = iter(range(200, 300))
    profiled("distill step (one replayed graph)",
             lambda: float(step(state, batch, noise(next(seeds)))["loss"]), step_median,
             "profile_distill_step.txt", smi=smi)
    student = copy.deepcopy(state.model).to(torch.bfloat16).eval()
    del state, step, teacher
    gc.collect()
    torch.cuda.empty_cache()
    return eq and fresh, student


def distill_phase(device, smi):
    """distill.main on configs/distill.yaml at batch DISTILL_B: the flagship
    MaskGiTUViT_v2 seeded and saved by save_pretrained as the teacher
    checkpoint, a CLIP tower at bench.py's widths saved without tokenizer
    files (SimpleTokenizer), the config's 12-step CFG 8 teacher, temperature
    (2, 0), pairs of 2, soft weight 0.5, EMA and clip 1.0; cut to 8 steps,
    warmup 0, a checkpoint at step 8, a metrics line a step, bf16 autocast.
    Then a reload of the checkpoint (main resumed), ``distill_eq`` and 3
    requests of the distilled student: 6 steps without CFG through
    ``distilled_generate``, captured against the decode loop called
    directly.  Returns (ok, the run's launch counts, the requests')."""
    import shutil
    import tempfile

    from open_muse_tpu_torch import kernels
    from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder
    from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2, MaskGiTUViT_v2Config
    from open_muse_tpu_torch.training import distill

    runs = os.path.join(HERE, "runs")
    os.makedirs(runs, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_distill_", dir=runs)
    try:
        teacher_dir, clip_dir = os.path.join(work, "teacher"), os.path.join(work, "clip")
        with torch.device(device):
            teacher = MaskGiTUViT_v2(MaskGiTUViT_v2Config())
            clip = CLIPTextEncoder(
                vocab_size=49408, hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
                num_attention_heads=12, max_position_embeddings=77, projection_dim=768)
        randomize_(teacher, 0)
        randomize_(clip, 1)
        teacher.save_pretrained(teacher_dir)
        clip.save_pretrained(clip_dir)
        cfg = teacher.config
        del teacher, clip
        out = os.path.join(work, "out")
        argv = ["config=" + os.path.join(HERE, "configs", "distill.yaml"),
                f"experiment.output_dir={out}", f"experiment.save_every={DISTILL_STEPS}",
                "experiment.log_every=1", f"distill.teacher_checkpoint={teacher_dir}",
                f"model.text_encoder.pretrained={clip_dir}",
                f"training.batch_size={DISTILL_B}", "lr_scheduler.params.warmup_steps=0",
                f"training.max_train_steps={DISTILL_STEPS}", "training.mixed_precision=bf16"]
        for arg in argv:
            log(f"[distill] argument {arg}")
        log(f"[distill] cuts of configs/distill.yaml: max_train_steps 20000 -> {DISTILL_STEPS}, "
            f"warmup 200 -> 0, save_every 1000 -> {DISTILL_STEPS}, log_every 50 -> 1; batch "
            f"{DISTILL_B} (the config's); the teacher and student the flagship MaskGiTUViT_v2 "
            f"(22 x 1024) with seeded weights; CLIP at bench.py's widths, seeded, hash-tokenized; "
            f"precision: bf16 autocast, fp32 weights, the teacher held in bf16 (the config sets "
            f"none; the JAX trainer runs fp32)")
        expected = distill_launches(cfg, DISTILL_STEPS)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state = distill.main(argv)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        logged = _logged(out)
        for m in logged:
            log(f"[distill] step {m['step']}: loss {m['loss']:.4f} soft_kl {m['soft_kl']:.4f} "
                f"grad_norm {m['grad_norm']:.4f} masked {m['avg_masked_frac']:.3f} pair step "
                f"{m['avg_pair_step']:.2f} step_time {m['step_time'] * 1e3:.1f} ms"
                + (f" (eager warm-up step + capture; the capture alone {m['capture_s']:.2f} s)"
                   if "capture_s" in m else ""))
        median = statistics.median(m["step_time"] for m in logged[1:])
        finite = all(math.isfinite(m["loss"]) and math.isfinite(m["soft_kl"]) for m in logged)
        steps_ok = [m["step"] for m in logged] == list(range(1, DISTILL_STEPS + 1))
        counts_ok = launches == expected
        log(f"[distill] {DISTILL_STEPS} steps in {wall:.1f} s (teacher load, prompt encoding and "
            f"checkpoint included): losses finite {finite}; launches {launches} (expected "
            f"{expected}: step 1 eager, steps 2 - {DISTILL_STEPS} replays) "
            f"{'ok' if counts_ok else 'FAIL'}")
        log(f"[distill] median step {median * 1e3:.1f} ms over steps 2-{DISTILL_STEPS} (host "
            f"clock, synchronised), {DISTILL_B * 256 / median:.0f} student tokens/s, peak memory "
            f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated), capture "
            f"{[m['capture_s'] for m in logged if 'capture_s' in m]} s; on {smi}")
        resume_ok = _resume_check("distill", distill, argv, state, out, DISTILL_STEPS)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        resume_ok &= checkpoint_requests(device, os.path.join(out, f"checkpoint-{DISTILL_STEPS}"),
                                         clip_dir, smi)
        eq_ok, student = distill_eq(device, teacher_dir, clip_dir, smi, median)
        serve_ok, serve_launches = distilled_requests(device, student, clip_dir, smi)
        ok = finite and steps_ok and counts_ok and resume_ok and eq_ok and serve_ok
        return ok, launches, serve_launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def distilled_requests(device, student, clip_dir, smi):
    """Three 256px / bs1 requests of the distilled student (bf16): the CLIP
    tower, ``distilled_generate`` (6 steps, no CFG) and the taming VQGAN's
    decode_code, three replayed CUDA graphs (``core.captured``); eager: the
    same three called directly, the decode loop on the same seed's noise.
    The latency beside serving_nocfg's 12 steps (one graph for all three)."""
    from open_muse_tpu_torch.core.captured import captured
    from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder, SimpleTokenizer
    from open_muse_tpu_torch.models.taming_vqgan import VQGANModel
    from open_muse_tpu_torch.models.transformer_v2 import (decode_noise, decode_schedules,
                                                           parallel_decode_loop)
    from open_muse_tpu_torch.training import distill

    steps = DISTILL_T // DISTILL_RATIO
    clip = CLIPTextEncoder.from_pretrained(clip_dir, device=device).float().eval()
    tokenizer = SimpleTokenizer(49408, 77)
    with torch.device(device):
        vae = VQGANModel(resolution=256, num_embeddings=8192, z_channels=256,
                         quantized_embed_dim=256)
    randomize_(vae, 2)
    vae.eval()
    micro = torch.tensor([[512.0, 512.0, 0.0, 0.0, 6.0]], device=device)
    temps, _, ratios = decode_schedules(steps, TEMPERATURE, 0.0)

    @torch.no_grad()
    def text(ids):
        hidden_states, _, pooled = clip(ids)
        return hidden_states[-2], pooled

    decode = torch.no_grad()(vae.decode_code)

    @torch.no_grad()
    def request(i, eager):
        ids = torch.as_tensor(tokenizer([PROMPTS[i % 4]], padding="max_length", truncation=True,
                                        max_length=77, return_tensors="np")["input_ids"])

        def run():
            if eager:
                ehs, pooled = text(ids.to(device))
                kind, sample, mask = decode_noise(torch.Generator().manual_seed(i),
                                                  timesteps=steps, batch=1, seq_len=256,
                                                  vocab=8192, device=device)
                masked = torch.full((1, 256), 8255, dtype=torch.long, device=device)
                tokens = parallel_decode_loop(
                    student, masked, ehs, pooled, micro, temps.to(device), None, ratios.to(device),
                    use_cfg=False, seq_len=256, timesteps=steps, mask_gumbel=mask,
                    **{kind: sample})
                return vae.decode_code(tokens), tokens
            ehs, pooled = captured(clip, ("encode",), text, ids.to(device), modules=(clip,))
            tokens = distill.distilled_generate(
                student, ehs, pooled, micro, teacher_timesteps=DISTILL_T,
                step_ratio=DISTILL_RATIO, temperature=TEMPERATURE,
                generator=torch.Generator().manual_seed(i))
            return captured(vae, ("decode_code",), decode, tokens, modules=(vae,)), tokens
        return timed_call(run)

    median, launches = run_requests(
        smi, "distilled", expected_request_launches(student.config, "fused_categorical",
                                                    steps=steps),
        request, steps=steps, guidance=0.0)
    nocfg = LATENCY_MS.get("serving_nocfg", float("nan"))
    log(f"[latency] distilled: the {steps}-step CFG-free student request {median * 1e3:.1f} ms "
        f"(text tower, decode and VQGAN decode, a replayed graph each) beside serving_nocfg's "
        f"12-step request {nocfg:.1f} ms (one graph for all three): {median * 1e3 / nocfg:.3f}; "
        f"on {smi}")
    return True, launches


# configs/imagenet_movq.yaml's batch 256 cut to the largest power of two that
# fits: 24 layers of 1025 tokens without checkpointing, the step's eager
# warm-up and its capture each holding the activations (the plain-VJP
# attention's included); at 32, after the earlier phases and with the
# config's EMA, the capture ran out of an 80 GB H100; 8 steps
MOVQ_CLASS_B, MOVQ_CLASS_IMAGES = 16, 128


def train_movq_class_phase(device, smi):
    """train_maskgit_imagenet.main on configs/imagenet_movq.yaml (the v1
    model, 24 x 1024, 1025 positions: kernel 5's two-pass variant in
    training; a MOVQ at Kandinsky 2.1's widths: vq_argmin at C 4 over 16384
    codes) at batch MOVQ_CLASS_B over seeded 256px PNGs with class ids, 8
    steps, the panel at step 8.  Returns (ok, launch counts)."""
    import shutil
    import tempfile

    import numpy as np

    from open_muse_tpu_torch.training import train_maskgit_imagenet
    from open_muse_tpu_torch.utils.config import load_config

    runs = os.path.join(HERE, "runs")
    os.makedirs(runs, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_train_movq_class_", dir=runs)
    try:
        shard = os.path.join(work, "imagenet-000.tar")
        classes = np.random.RandomState(9).randint(0, 1000, MOVQ_CLASS_IMAGES)
        write_image_shard(shard, MOVQ_CLASS_IMAGES, seed=9, classes=classes)
        vq_dir = os.path.join(work, "movq")
        build_movq(device, 13).save_pretrained(vq_dir)
        out = os.path.join(work, "out")
        argv = ["config=" + os.path.join(HERE, "configs", "imagenet_movq.yaml"),
                f"dataset.params.train_shards_path_or_url={shard}",
                "dataset.params.shuffle_buffer_size=64", f"experiment.output_dir={out}",
                "experiment.log_every=1", f"experiment.save_every={V1_STEPS}",
                f"experiment.generate_every={V1_STEPS}", f"model.vq_model.pretrained={vq_dir}",
                f"training.batch_size={MOVQ_CLASS_B}", "lr_scheduler.params.warmup_steps=0",
                f"training.max_train_steps={V1_STEPS}"]
        for arg in argv:
            log(f"[train_movq_class] argument {arg}")
        config = load_config(argv)
        tcfg = config.model.transformer.to_dict()
        log(f"[train_movq_class] cuts of configs/imagenet_movq.yaml: batch 256 -> {MOVQ_CLASS_B}"
            f" (32 ran out of the card after the earlier phases: activations of 1025 tokens, "
            f"held by the warm-up and the capture), warmup 5000 -> 0, "
            f"{V1_STEPS} steps, generate_every 1000 -> {V1_STEPS}; a seeded MOVQ at Kandinsky "
            f"2.1's widths; {MOVQ_CLASS_IMAGES} seeded 256px PNGs, class ids in [0, 1000); as "
            f"written: {tcfg['num_hidden_layers']} layers, hidden {tcfg['hidden_size']}, "
            f"{tcfg['max_position_embeddings']} positions, codebook {tcfg['codebook_size']}, "
            f"hidden_dropout {tcfg['hidden_dropout']}, use_ema {config.training.use_ema}, "
            f"{config.training.mixed_precision}")
        expected = class_launches(tcfg, V1_STEPS, 1)
        state, launches, median, peak, capture, ok = _v1_run(
            "train_movq_class", train_maskgit_imagenet, argv, out, expected, V1_STEPS)
        panel_ok = os.path.isfile(os.path.join(out, f"samples-{V1_STEPS}.png"))
        tokens = MOVQ_CLASS_B * 1024
        log(f"[train_movq_class] {sum(p.numel() for p in state.model.parameters()) / 1e6:.1f} M "
            f"params; samples-{V1_STEPS}.png {panel_ok}; median step {median * 1e3:.1f} ms over "
            f"steps 2-{V1_STEPS} (host clock, synchronised; the MOVQ encode and the step), "
            f"{tokens / median:.0f} image tokens/s, {MOVQ_CLASS_B / median:.2f} images/s, peak "
            f"memory {peak / 2 ** 30:.2f} GiB (max_memory_allocated), step 1's capture {capture} "
            f"s; on {smi}")
        del state
        gc.collect()
        torch.cuda.empty_cache()
        return ok and panel_ok, launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def teacher_shapes(device):
    """Kernels 4, 7, 9 and 10 at the distillation teacher's shapes (its CFG
    decode of DISTILL_B prompts: 2 x DISTILL_B rows of 256 tokens): each
    against its plain version and timed beside it (CUDA graph replay); no
    one library call computes any of the four.  Returns ok."""
    from open_muse_tpu_torch.kernels.fused_sample import (fused_categorical_cfg,
                                                          fused_categorical_cfg_plain)

    gen = torch.Generator().manual_seed(15)
    rows = 2 * DISTILL_B
    m, d = rows * TRAIN_S, HIDDEN
    # bytes (bf16 inputs, weights and outputs once) and operations, as the
    # report rows count them at the serving shapes
    bounds = {"glu_down_matmul": bound_of(2 * (2 * m * INTER + d * INTER + m * d),
                                          2 * m * INTER * d, "bf16"),
              "attn_sublayer_self": bound_of(2 * (4 * m * d + 4 * d * d),
                                             2 * m * 4 * d * d + 4 * m * TRAIN_S * d, "bf16"),
              "attn_sublayer_cross": bound_of(2 * (4 * m * d + 2 * d * d + rows * KV_LEN * 2 * d),
                                              2 * m * 2 * d * d + 4 * m * KV_LEN * d, "bf16")}
    ok, _, (ms, plain_ms) = check_glu(device, gen, m)
    times = {"glu_down_matmul": (ms, plain_ms)}
    for name, (sub_ok, _, timing) in check_sublayers(device, gen, rows).items():
        ok &= sub_ok
        times[name] = timing
    for name, (ms, plain_ms) in times.items():
        bound, by = bounds[name]
        log(f"[time] {name} at the teacher's shapes: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms (median, CUDA graph replay); bound {bound:.4f} ms ({by})")
    cuda_gen = torch.Generator(device=device).manual_seed(16)
    logits = (torch.randn(rows, 256, 8256, generator=cuda_gen, device=device) * 2).to(
        torch.bfloat16)
    x = logits[..., :8192].float()
    x = x[DISTILL_B:] + GUIDANCE * (x[:DISTILL_B] - x[DISTILL_B:])
    sampler_ok, _, _ = check_philox_route(
        "fused_categorical_cfg", lambda seed: fused_categorical_cfg(logits, GUIDANCE, 8192,
                                                                    seed=seed),
        lambda noise: fused_categorical_cfg_plain(logits, GUIDANCE, 8192, noise), logits, x,
        8192, device, row=False)
    return ok and sampler_ok


# -- the Hopper GEMM's variants ---------------------------------------------

# (m, n, k, layout): the products of kernels 7, 9 and 10 (the GLU
# down-projection, the qkv, q and out projections) at the serving and the
# training rows, and ragged rows; kernels 11's and 12's dattn and da and
# kernel 8's dh (the weight read MN-major); kernel 8's dwo (both operands
# MN-major); kernel 6's six part products at the pre-encode and the
# inpainting rows (its split operands are 3 Cp wide and read twice, the
# product's K is 6 Cp); last a trivial product, what a launch and a cluster
# cost by themselves
SWEEP_SHAPES = ((512, 1024, 2816, "a @ w.T"), (512, 3072, 1024, "a @ w.T"),
                (512, 1024, 1024, "a @ w.T"), (4096, 1024, 2816, "a @ w.T"),
                (4096, 3072, 1024, "a @ w.T"), (4096, 1024, 1024, "a @ w.T"),
                (4096, 1024, 1024, "a @ w"), (4096, 1024, 3072, "a @ w"),
                (4096, 2816, 1024, "a @ w"), (1024, 2816, 4096, "a.T @ w"),
                (300, 1024, 2816, "a @ w.T"), (200, 3072, 1024, "a @ w.T"),
                (16384, 8192, 1536, "a @ w.T"), (256, 8192, 1536, "a @ w.T"),
                (7, 24, 40, "a @ w.T"))


def gemm_sweep(device) -> bool:
    """Every tile width x K split of the Hopper GEMM alone at SWEEP_SHAPES,
    beside cuBLAS and the variant the kernels' rule picks: device us a call
    (graph replay), each variant within 1e-2 rel of an fp32 product and two
    calls bit-equal.  The data behind the rule in csrc/gemm_sm90.cuh."""
    from open_muse_tpu_torch.kernels.gemm import SPLITS, TILE_WIDTHS

    gen, ok = torch.Generator().manual_seed(2), True
    for m, n, k, layout in SWEEP_SHAPES:
        a = torch.randn(m, k, generator=gen).to(device, torch.bfloat16)
        w = (torch.randn(k, n, generator=gen) * k ** -0.5).to(device, torch.bfloat16)
        if layout == "a @ w.T":
            w = w.t().contiguous()  # (n, k)
        elif layout == "a.T @ w":
            a = a.t().contiguous()  # (k, m)
        ours, cublas = _gemm_pair(layout, a, w)
        af, wf = a.float(), w.float()
        exact = (af @ wf.t() if layout == "a @ w.T" else af @ wf if layout == "a @ w"
                 else af.t() @ wf)
        cells = [f"cuBLAS {graph_ms(cublas) * 1e3:.2f}"]
        for tile in (*((t, s) for t in TILE_WIDTHS for s in SPLITS), (0, 0)):
            out = ours(*tile)
            good = errors(out, exact)[1] <= 1e-2 and torch.equal(out, ours(*tile))
            ok &= good
            label = "rule" if tile == (0, 0) else f"{tile[0]}/{tile[1]}"
            cells.append(f"{label} {graph_ms(lambda: ours(*tile)) * 1e3:.2f}"
                         f"{'' if good else ' FAIL'}")
        log(f"[sweep] ({m}, {n}, {k}) {layout} us, tile width / K split: " + ", ".join(cells))
    return ok


# -- main -------------------------------------------------------------------

# the kernels whose ptxas lines the run prints: the Hopper GEMM, the GLU
# product, the register row kernels, the sublayers' backward attention, the
# sampler and the VQ split pass
PTXAS_KERNELS = ("wgmma_gemm_kernel", "glu_product_kernel", "rmsnorm_adaln_rows_kernel",
                 "attn_bwd_q_kernel", "attn_bwd_kv_kernel", "rms_adaln_bwd_rows_kernel",
                 "sample_kernel", "vq_split_kernel")


def ptxas_report(build_log: str, names):
    """One line per compiled entry whose mangled name holds one of ``names``:
    the entry, its stack / spills and its registers / shared memory (once,
    where several sources instantiate one template)."""
    lines, out, seen = build_log.splitlines(), [], set()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and any(n in line for n in names):
            entry = line.split("'")[1] if "'" in line else line
            if entry in seen:
                continue
            seen.add(entry)
            detail = [lines[j].replace("ptxas info    :", "").strip()
                      for j in range(i + 1, min(i + 4, len(lines)))
                      if "spill" in lines[j] or "Used" in lines[j]]
            out.append(f"{entry}: " + "; ".join(detail))
    return out


# -- the eval stack: CLIP and Inception scoring, FID, the regressions ---------

EVAL_IMAGES, EVAL_BATCH = 64, 32
# the eval phases' files: the serving pipeline, the scorer, the image sets
EVAL_WORK = os.path.join(HERE, "runs", "eval")
PIPE_DIR, CLIP_DIR = os.path.join(EVAL_WORK, "pipe"), os.path.join(EVAL_WORK, "clip")
# every number of these phases comes from seeded weights: regression numbers,
# not published metrics
SEEDED = "seeded weights, not a published metric"


def seeded_images(n, seed, size=256):
    """``n`` seeded uint8 images: smooth colour fields with noise."""
    import numpy as np

    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size] / (size - 1.0)
    out = []
    for _ in range(n):
        base = rs.rand(3, 3) @ np.stack([yy, xx, np.ones_like(xx)]).reshape(3, -1)
        img = base.T.reshape(size, size, 3) + 0.1 * rs.randn(size, size, 3)
        out.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return out


def save_scorer(device, path):
    """CLIP ViT-L/14 (24 x 1024, patch 14, 224 px, projection 768) and the
    CLIP-L text tower of bench.py:35-38 (12 x 768), seeded, saved as one
    full CLIPModel directory (logit scale 100)."""
    from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder, SimpleTokenizer
    from open_muse_tpu_torch.models.clip_vision import CLIPScorer, CLIPVisionEncoder

    with torch.device(device):
        vision = CLIPVisionEncoder()  # ViT-L/14 defaults
        text = CLIPTextEncoder(
            vocab_size=49408, hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
            num_attention_heads=12, max_position_embeddings=77, projection_dim=768)
    randomize_(vision, 30)
    randomize_(text, 31)
    log(f"[eval] scorer: CLIP ViT-L/14 {param_counts(vision=vision)['vision'] / 1e6:.1f} M "
        f"parameters, text tower {param_counts(text=text)['text'] / 1e6:.1f} M, seeded; saved "
        f"as a full CLIPModel directory (fp32), served in bf16")
    CLIPScorer(vision, text, SimpleTokenizer(49408, 77)).save_pretrained(path)


def images_per_s(fn, n, calls=5):
    """``n`` / the median host-clock seconds of ``calls`` synchronised calls,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return n / statistics.median(times), statistics.median(times)


def vision_tower_check(scorer, images, smi):
    """The ViT-L/14 tower on a batch of EVAL_BATCH images: the kernels'
    embeddings against the plain attention's (rel tol 5e-2: bf16 roundings
    through 24 layers), exactly 24 launches of kernel 5 a forward, all at
    head dim 64; images/s of ``embed_images`` (host preprocessing included)
    and of the tower alone; one profiled forward."""
    import numpy as np

    from open_muse_tpu_torch import kernels
    from open_muse_tpu_torch.kernels.flash_attention import flash_attention
    from open_muse_tpu_torch.models.clip_vision import clip_preprocess_images

    batch = images[:EVAL_BATCH]
    px = torch.from_numpy(clip_preprocess_images(batch, scorer.vision.config.image_size)).to(
        scorer.device)
    kernels.reset_launch_counts()
    with torch.no_grad():
        fused = scorer.vision(px)[2]
    torch.cuda.synchronize()
    launches, by_dim = kernels.launch_counts(), dict(flash_attention.by_head_dim)
    with torch.no_grad():
        plain = scorer.vision(px, use_kernels=False)[2]
    max_abs, rel = errors(fused, plain)
    expected = {**zero_counts(), "flash_attention": 24}
    ok = (rel <= 5e-2 and bool(torch.isfinite(fused).all()) and launches == expected
          and by_dim == {64: 24})
    log(f"[eval] ViT-L/14 image_embeds {tuple(fused.shape)} bf16, kernels vs plain attention: "
        f"max_abs {max_abs:.3e} rel {rel:.3e} (tol rel 5e-2: bf16 roundings through 24 layers); "
        f"launches a forward { {k: v for k, v in launches.items() if v} } by head dim {by_dim} "
        f"(expected flash_attention 24 at 64) {'ok' if ok else 'FAIL'}")
    rate, _ = images_per_s(lambda: scorer.embed_images(batch), len(batch))

    def tower():
        with torch.no_grad():
            scorer.vision(px)

    tower_rate, tower_s = images_per_s(tower, len(batch))
    log(f"[eval] ViT-L/14 embed_images at batch {len(batch)}: {rate:.1f} images/s (PIL "
        f"preprocessing on the host included); the tower alone {tower_rate:.1f} images/s "
        f"({tower_s * 1e3:.2f} ms a forward; host clock, synchronised) on {smi}")
    profiled(f"CLIP ViT-L/14 forward, batch {len(batch)}", tower, tower_s,
             "profile_clip_vision.txt", smi=smi)
    return ok, np.asarray(fused.float().cpu())


def eval_phase(device, smi):
    """The scorer saved and read back by CLIPScorer.from_pretrained; the
    tower check; calculate_fid.main over the serving pipeline's directory:
    64 captions at batch 8 (12 steps, CFG 8), CLIP-FID by --clip-model
    against 64 seeded 256 px PNGs and --clip-score; the FID of the real set
    against itself; the seeded InceptionV3's FID and Inception Score at 299
    px on both sets.  Returns (ok, the calculate_fid run's launches)."""
    import numpy as np
    from PIL import Image

    from open_muse_tpu_torch import kernels
    from open_muse_tpu_torch.eval.fid import (CLIPFeatureExtractor, compute_statistics,
                                              fid_between_image_sets, frechet_distance,
                                              load_image_dir)
    from open_muse_tpu_torch.eval.inception import (InceptionFeatureExtractor,
                                                    inception_preprocess)
    from open_muse_tpu_torch.eval.inception_score import inception_score_from_logits
    from open_muse_tpu_torch.kernels.flash_attention import flash_attention
    from open_muse_tpu_torch.models.clip_vision import CLIPScorer
    from open_muse_tpu_torch.scripts import calculate_fid

    real_dir, fake_dir = os.path.join(EVAL_WORK, "real"), os.path.join(EVAL_WORK, "fake")
    os.makedirs(real_dir, exist_ok=True)
    t0 = time.perf_counter()
    save_scorer(device, CLIP_DIR)
    scorer = CLIPScorer.from_pretrained(CLIP_DIR, device=device)
    log(f"[eval] scorer seeded, saved and read back by CLIPScorer.from_pretrained in "
        f"{time.perf_counter() - t0:.1f} s")
    real = seeded_images(EVAL_IMAGES, seed=40)
    for i, img in enumerate(real):
        Image.fromarray(img).save(os.path.join(real_dir, f"{i:06d}.png"))
    tower_ok, _ = vision_tower_check(scorer, real, smi)

    captions = os.path.join(EVAL_WORK, "captions.txt")
    with open(captions, "w") as f:
        f.write("\n".join(f"{PROMPTS[i % 4]}, number {i}" for i in range(EVAL_IMAGES)))
    argv = ["--model", PIPE_DIR, "--captions", captions, "--output-dir", fake_dir,
            "--num-images", str(EVAL_IMAGES), "--batch-size", "8", "--real-dir", real_dir,
            "--clip-model", CLIP_DIR, "--clip-score", "--device", device.type]
    log(f"[eval] calculate_fid.main {' '.join(argv)}")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = calculate_fid.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_dim = kernels.launch_counts(), dict(flash_attention.by_head_dim)
    fakes = sorted(os.listdir(fake_dir))
    names_ok = fakes == [f"{i:06d}.png" for i in range(EVAL_IMAGES)]
    # 8 requests of 8 captions: one decode graph, whose first call also runs
    # its warm-up eagerly (9 requests' launches), and 6 tower forwards: real
    # and fake for the FID, fake for the CLIP score
    expected = generation_launches(requests=8, tower_forwards=6)
    launches_ok = launches == expected
    self_fid = fid_between_image_sets(real, real, CLIPFeatureExtractor(scorer.vision))
    fid_ok = (math.isfinite(result["fid"]) and math.isfinite(result["clip_score"])
              and abs(self_fid) <= 1e-4 * result["fid"])
    log(f"[eval] calculate_fid: {EVAL_IMAGES} images named by caption index {names_ok}, "
        f"{result['images_per_s']:.2f} images/s generated (12 steps, CFG 8, batch 8, PNGs "
        f"written), CLIP-FID {result['fid']:.4f} ({result['backend']}), CLIP score "
        f"{result['clip_score']:.4f}, {wall:.1f} s in all; the real set against itself "
        f"{self_fid:.3e} (gate |FID(x, x)| <= 1e-4 x FID) {'ok' if fid_ok else 'FAIL'} "
        f"({SEEDED})")
    log(f"[eval] calculate_fid launches {launches} by head dim {by_dim} (expected {expected}) "
        f"{'ok' if launches_ok else 'FAIL'}")

    inc = InceptionFeatureExtractor.seeded(seed=0, batch_size=EVAL_BATCH, device=device)
    real_imgs, fake_imgs = load_image_dir(real_dir), load_image_dir(fake_dir)
    t0 = time.perf_counter()
    f_real, f_fake = inc.extract(real_imgs), inc.extract(fake_imgs)
    extract_s = time.perf_counter() - t0
    fid_inc = frechet_distance(*compute_statistics(f_real), *compute_statistics(f_fake))
    fid_inc_self = frechet_distance(*compute_statistics(f_real), *compute_statistics(f_real))
    isc = {name: inception_score_from_logits(np.log(inc.predict_proba(imgs) + 1e-20))
           for name, imgs in (("generated", fake_imgs), ("real", real_imgs))}
    inc_ok = (all(math.isfinite(x) for x in (fid_inc, *isc["generated"], *isc["real"]))
              and np.isfinite(f_real).all() and abs(fid_inc_self) <= 1e-4 * fid_inc)
    rate, _ = images_per_s(lambda: inc.extract(real_imgs[:EVAL_BATCH]), EVAL_BATCH)
    px = inception_preprocess(real_imgs[:EVAL_BATCH], device=device)

    def graph_alone():
        with torch.no_grad():
            inc.model(px)

    graph_rate, graph_s = images_per_s(graph_alone, EVAL_BATCH)
    log(f"[eval] InceptionV3 ('fid' graph, 299 px, {SEEDED}): FID generated vs real "
        f"{fid_inc:.4f}, real against itself {fid_inc_self:.3e}; Inception Score generated "
        f"{isc['generated'][0]:.4f} +- {isc['generated'][1]:.4f}, real {isc['real'][0]:.4f} +- "
        f"{isc['real'][1]:.4f}; {2 * EVAL_IMAGES} images extracted in {extract_s:.2f} s "
        f"{'ok' if inc_ok else 'FAIL'}")
    log(f"[eval] InceptionV3 extract at batch {EVAL_BATCH}: {rate:.1f} images/s (host "
        f"preprocessing included); the graph alone {graph_rate:.1f} images/s "
        f"({graph_s * 1e3:.2f} ms a batch, fp32, TF32 off) on {smi}")
    return tower_ok and names_ok and launches_ok and fid_ok and inc_ok, launches


def generation_launches(requests, tower_forwards):
    """The launches of ``requests`` PipelineMuse calls of one shape (12 steps,
    CFG) with the saved pipeline, whose decode graph's first call also runs
    its warm-up eagerly, and of ``tower_forwards`` ViT-L/14 forwards (24
    kernel-5 launches each)."""
    from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2

    with open(os.path.join(PIPE_DIR, "transformer", "config.json")) as f:
        cfg = MaskGiTUViT_v2.config_from_dict(json.load(f))
    per_request = expected_request_launches(cfg, "fused_categorical_cfg")
    expected = {k: (requests + 1) * v for k, v in per_request.items()}
    expected["flash_attention"] += 24 * tower_forwards
    return expected


SYNTHETIC_PROMPTS, SYNTHETIC_CANDIDATES = 8, 4
# the mid-scale protocol as chip_smoke runs it: in full, as the JAX package's
# recorded run (teacher 6000 steps, distill 2000; the rest the defaults: CFG 2,
# soft weight 0.5, n_eval 240, seed 0), ~180 s on the card (PERF.md section 4)
MIDSCALE_CUT = {"train_steps": 6000, "distill_steps": 2000}


def gen_synthetic_phase(device, smi):
    """gen_synthetic_dataset.main: 8 prompts x 4 candidates of the serving
    pipeline (12 steps, CFG 8) scored by the saved scorer, into one shard;
    read back through sdxl_synthetic_dataset_map, which must keep each
    prompt's arg-max candidate."""
    import numpy as np

    from open_muse_tpu_torch import kernels
    from open_muse_tpu_torch.scripts import gen_synthetic_dataset
    from open_muse_tpu_torch.training.data import sdxl_synthetic_dataset_map, tar_samples

    prompts = os.path.join(EVAL_WORK, "prompts.txt")
    with open(prompts, "w") as f:
        f.write("\n".join(f"{PROMPTS[i % 4]}, take {i}" for i in range(SYNTHETIC_PROMPTS)))
    pattern = os.path.join(EVAL_WORK, "syn", "syn-%05d.tar")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    shards = gen_synthetic_dataset.main(
        ["--model", PIPE_DIR, "--prompts", prompts, "--output", pattern,
         "--candidates", str(SYNTHETIC_CANDIDATES), "--clip-model", CLIP_DIR,
         "--samples-per-shard", str(SYNTHETIC_PROMPTS), "--device", device.type])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    samples = list(tar_samples(pattern % 0, handler="raise"))
    # one request and one tower forward a prompt (its candidates are a batch)
    expected = generation_launches(SYNTHETIC_PROMPTS, SYNTHETIC_PROMPTS)
    picks_ok = len(samples) == SYNTHETIC_PROMPTS and shards == 1 and launches == expected
    for sample in samples:
        scores = [float(x) for x in sample["clip_scores.txt"].decode().split(",")]
        best = sdxl_synthetic_dataset_map(dict(sample))
        picks_ok &= (len(scores) == SYNTHETIC_CANDIDATES and all(map(math.isfinite, scores))
                     and best["png"] == sample[f"{int(np.argmax(scores))}.png"])
    log(f"[gen_synthetic] {SYNTHETIC_PROMPTS} prompts x {SYNTHETIC_CANDIDATES} candidates in "
        f"{wall:.1f} s ({shards} shard): every sample read back, sdxl_synthetic_dataset_map "
        f"keeps the arg-max candidate; last scores {scores}; launches "
        f"{ {k: v for k, v in launches.items() if v} } (expected "
        f"{ {k: v for k, v in expected.items() if v} }) ({SEEDED}) on {smi} "
        f"{'ok' if picks_ok else 'FAIL'}")
    return picks_ok, launches


def quality_phase(device, smi):
    """run_quality_regression at its defaults (200 train steps, 150 VQ
    steps, 30 eval prompts) with inception=True, gated as the JAX slow test:
    trained CLIP-FID < 0.5 x untrained, colour accuracy >= 0.9 trained and
    <= 0.67 untrained."""
    from open_muse_tpu_torch import kernels
    from open_muse_tpu_torch.eval.quality_regression import run_quality_regression
    from open_muse_tpu_torch.kernels.flash_attention import flash_attention

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    m = run_quality_regression(inception=True, device=device,
                               log=lambda msg: log(f"[quality] {msg.strip()}"))
    wall = time.perf_counter() - t0
    launches, by_dim = kernels.launch_counts(), dict(flash_attention.by_head_dim)
    finite = all(math.isfinite(v) for v in m.values())
    learned = (m["fid_clipfeat_seeded_trained"] < 0.5 * m["fid_clipfeat_seeded_untrained"]
               and m["color_accuracy_trained"] >= 0.9 and m["color_accuracy_untrained"] <= 0.67)
    ok = finite and learned
    log(f"[quality] {json.dumps(m)}")
    log(f"[quality] trained CLIP-FID {m['fid_clipfeat_seeded_trained']:.4f} vs untrained "
        f"{m['fid_clipfeat_seeded_untrained']:.4f} (gate < 0.5x), colour accuracy trained "
        f"{m['color_accuracy_trained']:.3f} (>= 0.9) untrained {m['color_accuracy_untrained']:.3f} "
        f"(<= 0.67); {wall:.1f} s; launches { {k: v for k, v in launches.items() if v} } by "
        f"head dim {by_dim} ({SEEDED}) on {smi} {'ok' if ok else 'FAIL'}")
    return ok, launches


def distill_midscale_phase(device, smi):
    """run_distill_midscale with MIDSCALE_CUT, gated on finite metrics;
    prints the margin fid_teacher_k - fid_student_k beside the split-half
    floor."""
    from open_muse_tpu_torch import kernels
    from open_muse_tpu_torch.eval.distill_midscale import run_distill_midscale
    from open_muse_tpu_torch.kernels.flash_attention import flash_attention

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    m = run_distill_midscale(device=device, **MIDSCALE_CUT,
                             log=lambda msg: log(f"[distill_midscale] {msg.strip()}"))
    wall = time.perf_counter() - t0
    launches, by_dim = kernels.launch_counts(), dict(flash_attention.by_head_dim)
    ok = all(math.isfinite(v) for v in m.values())
    margin = m["fid_teacher_k"] - m["fid_student_k"]
    log(f"[distill_midscale] {json.dumps(m)}")
    log(f"[distill_midscale] arguments {MIDSCALE_CUT} (the JAX package's recorded run): "
        f"teacher_full "
        f"{m['fid_teacher_full']:.4f}, teacher_k {m['fid_teacher_k']:.4f}, student_k "
        f"{m['fid_student_k']:.4f}; margin teacher_k - student_k {margin:.4f} against the "
        f"split-half floor {m['fid_split_half_floor']:.4f}: the student "
        f"{'beats' if margin > m['fid_split_half_floor'] else 'does not beat'} the step-cut "
        f"control beyond the floor; {wall:.1f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} } by head dim {by_dim} ({SEEDED}) on "
        f"{smi} {'ok' if ok else 'FAIL'}")
    return ok, launches


def checkpoint_requests(device, checkpoint, clip_dir, smi):
    """A trainer checkpoint's ``unwrapped_model/`` and ``ema_model/`` each
    read by PipelineMuse.from_pretrained (the transformer in bf16, a seeded
    f16 taming VQGAN) and answering one 256px 12-step CFG request."""
    from open_muse_tpu_torch.models.taming_vqgan import VQGANModel
    from open_muse_tpu_torch.pipelines.pipeline_muse import PipelineMuse

    vae_dir = os.path.join(checkpoint, "..", "vae")
    with torch.device(device):
        vae = VQGANModel(resolution=256, num_embeddings=8192, z_channels=256,
                         quantized_embed_dim=256)
    randomize_(vae, 2)
    vae.save_pretrained(vae_dir)
    del vae
    ok = True
    for sub in ("unwrapped_model", "ema_model"):
        pipe = PipelineMuse.from_pretrained(
            transformer_path=os.path.join(checkpoint, sub), text_encoder_path=clip_dir,
            vae_path=vae_dir, transformer_dtype=torch.bfloat16, device=device)
        t0 = time.perf_counter()
        images = pipe(PROMPTS[0], timesteps=12, guidance_scale=8.0,
                      generator=torch.Generator().manual_seed(0), return_pil=False)
        torch.cuda.synchronize()
        sub_ok = tuple(images.shape) == IMAGE_SHAPE and bool(torch.isfinite(images).all())
        ok &= sub_ok
        log(f"[distill] fault 3.13: {os.path.basename(checkpoint)}/{sub} read by "
            f"PipelineMuse.from_pretrained ({type(pipe.transformer).__name__}, "
            f"{sum(p.numel() for p in pipe.transformer.parameters()) / 1e6:.1f} M, bf16) answers "
            f"a 12-step CFG request: image {tuple(images.shape)} finite {sub_ok}, "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms (first call: capture included) on "
            f"{smi} {'ok' if sub_ok else 'FAIL'}")
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    return ok


def device_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--gemm-sweep", action="store_true",
                        help="only time every variant of the Hopper GEMM at the paths' shapes")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device = torch.device("cuda", 0)
    smi = device_line()
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log("[device] tf32 off for matmul and cuDNN; bf16 reduced-precision reductions off")

    from open_muse_tpu_torch import kernels
    from open_muse_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"[build] nvcc sm_90a build + load {time.perf_counter() - t0:.1f} s")
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    if _build.build_log:  # empty when the library was already built
        with open(os.path.join(out_dir, "nvcc_build.log"), "w") as f:
            f.write(_build.build_log)
        for line in ptxas_report(_build.build_log, PTXAS_KERNELS):
            log(f"[ptxas] {line}")

    if args.gemm_sweep:
        if not gemm_sweep(device):
            raise SystemExit("chip_smoke: a GEMM variant failed")
        return 0

    phase_t0 = time.perf_counter()
    splits = []  # kernels 7 - 12 by launch, profiled after every graph timing
    report = kernel_phase(device, splits)
    report.update(backward_kernel_phase(device, splits))
    for label, fn in splits:
        log_split(label, fn)
    del splits
    failed = [name for name, (ok, _, _) in report.items() if not ok]
    if not teacher_shapes(device):
        failed.append("kernels 4, 7, 9, 10 at the distillation teacher's shapes")
    kernels.reset_launch_counts()
    log(f"[phase] kernel checks {time.perf_counter() - phase_t0:.1f} s")

    phase_t0 = time.perf_counter()
    pipe = build_pipeline(device)
    paths = {"serving": request_phase(pipe, device, smi)}
    paths["serving_nocfg"] = nocfg_phase(pipe, smi)
    paths["inpainting"] = inpainting_phase(pipe, device, smi)
    pre_ok, paths["pre_encode"] = pre_encode_phase(pipe, device, smi)
    if not pre_ok:
        failed.append("pre_encode phase")
    pipe.save_pretrained(PIPE_DIR)  # served again by the eval phases' scripts
    del pipe
    _EAGER.clear()
    gc.collect()  # the pipeline and its request functions hold each other: free its graphs
    torch.cuda.empty_cache()
    log(f"[phase] serving, serving_nocfg, inpainting, pre_encode {time.perf_counter() - phase_t0:.1f} s")

    phase_t0 = time.perf_counter()
    paths["class_conditional"], paths["class_inpainting"] = class_conditional_phase(device, smi)
    log(f"[phase] class_conditional, class_inpainting {time.perf_counter() - phase_t0:.1f} s")

    for name, phase in (("movq_class", movq_class_phase), ("movq_text", movq_text_phase),
                        ("paella", paella_phase)):
        phase_t0 = time.perf_counter()
        phase_ok, paths[name] = phase(device, smi)
        if not phase_ok:
            failed.append(f"{name} phase")
        log(f"[phase] {name} {time.perf_counter() - phase_t0:.1f} s")

    phase_t0 = time.perf_counter()
    if not gradient_check(device):
        failed.append("full-width gradient check")
    train_ok, paths["training"] = training_phase(device, smi)
    if not train_ok:
        failed.append("training phase")
    log(f"[phase] gradient check and training {time.perf_counter() - phase_t0:.1f} s")

    phase_t0 = time.perf_counter()
    if not train_eq_phase(device):
        failed.append("captured against eager train steps")
    if not dots_phase(device):
        failed.append("'dots' checkpointing")
    log(f"[phase] train_eq and dots {time.perf_counter() - phase_t0:.1f} s")

    phase_t0 = time.perf_counter()
    raw_ok, paths["train_raw"] = train_raw_phase(device, smi)
    if not raw_ok:
        failed.append("raw-branch training phase")
    log(f"[phase] train_raw {time.perf_counter() - phase_t0:.1f} s")

    phase_t0 = time.perf_counter()
    class_ok, paths["train_class"] = train_class_phase(device, smi)
    if not class_ok:
        failed.append("class-conditional training phase")
    log(f"[phase] train_class {time.perf_counter() - phase_t0:.1f} s")

    phase_t0 = time.perf_counter()
    text_ok, paths["train_v1_text"] = train_v1_text_phase(device, smi)
    if not text_ok:
        failed.append("v1 text training phase")
    log(f"[phase] train_v1_text {time.perf_counter() - phase_t0:.1f} s")

    for name, phase in (("train_vqgan", train_vqgan_phase), ("train_soft", train_soft_phase),
                        ("train_opt", train_opt_phase),
                        ("train_movq_class", train_movq_class_phase)):
        phase_t0 = time.perf_counter()
        phase_ok, paths[name] = phase(device, smi)
        if not phase_ok:
            failed.append(f"{name} phase")
        log(f"[phase] {name} {time.perf_counter() - phase_t0:.1f} s")

    phase_t0 = time.perf_counter()
    distill_ok, paths["distill"], paths["distilled"] = distill_phase(device, smi)
    if not distill_ok:
        failed.append("distill phase")
    log(f"[phase] distill and the distilled student's requests "
        f"{time.perf_counter() - phase_t0:.1f} s")

    try:
        for name, phase in (("eval", eval_phase), ("gen_synthetic", gen_synthetic_phase),
                            ("quality", quality_phase),
                            ("distill_midscale", distill_midscale_phase)):
            phase_t0 = time.perf_counter()
            phase_ok, paths[name] = phase(device, smi)
            if not phase_ok:
                failed.append(f"{name} phase")
            gc.collect()
            torch.cuda.empty_cache()
            log(f"[phase] {name} {time.perf_counter() - phase_t0:.1f} s")
    finally:
        import shutil

        shutil.rmtree(EVAL_WORK, ignore_errors=True)

    rows = []
    for name, (ok, err, t) in report.items():
        bound, bound_by = bound_ms(name)
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name][0],
                     "replaces": SOURCES[name][1],
                     "launches": sum(p[name] for p in paths.values()),
                     "launches_by_path": {path: p[name] for path, p in paths.items()},
                     "max_abs_err": err, "ms": t[0], "plain_ms": t[1], "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": LIBRARY_MS.get(name)})
        if name == "flash_attention":  # its variants counted apart
            two_pass = {path: p["flash_attention_two_pass"] for path, p in paths.items()}
            rows[-1]["launches_by_variant"] = {"one_pass": rows[-1]["launches"]
                                               - sum(two_pass.values()),
                                               "two_pass": sum(two_pass.values())}
            rows[-1]["two_pass_launches_by_path"] = two_pass
    missing = [r["name"] for r in rows if r["launches"] == 0]
    missing += [f"{r['name']} ({variant})" for r in rows
                for variant, n in r.get("launches_by_variant", {}).items() if n == 0]
    if missing:
        failed.append(f"kernels never launched on a path: {missing}")
    print(smi)
    print(json.dumps({"kernels": rows}))
    if failed:
        raise SystemExit(f"chip_smoke: checks failed: {failed}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
