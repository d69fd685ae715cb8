"""Smoke run of the PyTorch port on one NVIDIA GPU.

Builds the port's CUDA kernels from ``open_muse_tpu_torch/csrc``, holds each
forward and backward kernel against its plain PyTorch version at the shapes
of its path, then drives the port's paths at full width with seeded random
weights:

- serving: three 256px / batch-1 / 12-step CFG text-to-image requests through
  ``PipelineMuse.text2image``;
- class_conditional: three 256px / batch-1 / 8-step ImageNet class-id
  requests through ``PipelineMuse(is_class_conditioned=True)`` with the v1
  ``MaskGitTransformer`` of ``configs/imagenet.yaml`` and the MaskGIT VQGAN;
- serving_nocfg: three such requests at guidance 0 (the CFG-free sampler);
- inpainting: three 256px / batch-1 / 12-step CFG requests through
  ``PipelineMuseInpainting.inpaint`` (the VQGAN encoder and ``vq_argmin``);
- pre_encode: ``scripts.pre_encode.main`` over a synthetic shard of 1024
  seeded 256px images with captions, models loaded by ``from_pretrained``;
- training: ``training.train_muse.main`` on ``configs/laiona6plus_uvit_clip.yaml``
  at batch 16 on a seeded synthetic pre-encoded shard (one repeated batch),
  then a resume from its checkpoint; before it, one forward and backward
  with the kernels against one with the plain versions.

Each path runs with the launch counters set to 0 just before it and read
just after; the run fails unless every kernel of the path launched exactly
as often as the path needs.  Exits non-zero on any failure or without a GPU.

    python3 chip_smoke.py     # one GPU; a few minutes on an H100

The second-to-last line is the kernel report as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
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
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}
BOUNDS = {}  # kernel -> (bytes, operations, type), from the timed inputs
# kernel -> ms of one PyTorch call computing the same function on the timed
# inputs (a yardstick only: the port never calls it)
LIBRARY_MS = {}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(name):
    moved, ops, kind = BOUNDS[name]
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[kind] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20, trials: int = 7) -> float:
    """Median over ``trials`` of the mean time of ``reps`` back-to-back
    launches, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_ms(fn, reps: int = 20, trials: int = 7) -> float:
    """Device time of one call: median over ``trials`` of the mean of
    ``reps`` calls replayed from one captured CUDA graph, by CUDA events.
    The replay has no host enqueue in it, so a call of a few microseconds
    is timed as the device runs it, launch gaps included."""
    stream = torch.cuda.Stream()
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

def check_glu(device, gen, m):
    """m rows: 512 when serving (2 x 256 tokens), 4096 when training."""
    from open_muse_tpu_torch.kernels.glu_matmul import glu_down_matmul, glu_down_matmul_plain

    k, n = 2816, 1024  # intermediate 2816, hidden 1024
    bf = torch.bfloat16
    a = torch.randn(m, k, generator=gen).to(device, bf)
    b = torch.randn(m, k, generator=gen).to(device, bf)
    wo = (torch.randn(n, k, generator=gen) * k ** -0.5).to(device, bf)
    got, ref = glu_down_matmul(a, b, wo), glu_down_matmul_plain(a, b, wo)
    max_abs, rel = errors(got, ref)
    # both against an fp32 product of the same bf16 GLU operand
    hidden = (torch.nn.functional.gelu(a.float()) * b.float()).to(bf).float()
    exact = hidden @ wo.float().t()
    tol = 2e-2
    ok = rel <= tol
    log(f"[kernel] glu_down_matmul a,b {tuple(a.shape)} wo {tuple(wo.shape)} bf16: "
        f"max_abs {max_abs:.3e} rel {rel:.3e} (tol rel {tol}: bf16 output rounding and "
        f"sum order); vs fp32 product: kernel {errors(got, exact)[0]:.3e}, plain "
        f"{errors(ref, exact)[0]:.3e} {'ok' if ok else 'FAIL'}")
    timing = (time_ms(lambda: glu_down_matmul(a, b, wo)),
              time_ms(lambda: glu_down_matmul_plain(a, b, wo)))
    BOUNDS.setdefault("glu_down_matmul", (nbytes(a, b, wo, got), 2 * m * k * n, "bf16"))
    return ok, max_abs, timing


def _sublayer_inputs(device, gen, b=2, s=256, d=1024):
    bf = torch.bfloat16
    rand = lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen) * scale).to(device, bf)  # noqa: E731
    return dict(x=rand(b, s, d), res=rand(b, s, d), ln_scale=1 + rand(d, scale=0.1),
                adaln=rand(b, 2 * d, scale=0.1), wout=rand(d, d, scale=d ** -0.5))


def check_sublayers(device, gen, b):
    """b batch rows of 256 tokens: 2 when serving (CFG at bs1), 16 when
    training."""
    from open_muse_tpu_torch.kernels import attn_sublayer as A

    d, heads, bf = 1024, 16, torch.bfloat16
    results = {}
    inp = _sublayer_inputs(device, gen, b=b)
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
            ok &= rel <= tol and h_equal
            worst = max(worst, max_abs)
            log(f"[kernel] {name} x {tuple(inp['x'].shape)} res={'given' if res is not None else 'None'}"
                f"{f' kv {tuple(kv.shape)}' if 'cross' in name else ''} bf16: max_abs {max_abs:.3e} "
                f"rel {rel:.3e} (tol rel {tol}: bf16 roundings of qkv / probs / output), "
                f"residual bit-equal {h_equal} {'ok' if rel <= tol and h_equal else 'FAIL'}")
        timing = (time_ms(lambda: kern(inp["res"])), time_ms(lambda: plain(inp["res"])))
        results[name] = (ok, worst, timing)
        # the q(kv) and output projections, and QK^T and PV over the keys
        s = inp["x"].shape[1]
        keys, proj = (s, 4 * d * d) if "self" in name else (77, 2 * d * d)
        ops = 2 * b * s * proj + 4 * b * heads * s * keys * (d // heads)
        moved = nbytes(inp["x"], inp["res"], inp["ln_scale"], inp["adaln"], *kern(inp["res"]),
                       *((wqkv,) if "self" in name else (wq, kv)), inp["wout"])
        BOUNDS.setdefault(name, (moved, ops, "bf16"))
    return results


def check_sampler(device, gen):
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

    # in-kernel Philox stream: empirical distribution of one small-vocab row
    # (cropped from 20 to 16 columns) against softmax, by chi-square
    from scipy.stats import chi2

    rows, v_raw, v_lim = 1 << 16, 20, 16
    row = torch.linspace(-2.0, 1.0, v_raw)
    small = row.expand(2, rows, v_raw).contiguous().to(device, torch.bfloat16)
    ph_gen = torch.Generator().manual_seed(1234)
    ids_p, sel_p = fused_categorical_cfg(small, guidance, v_lim, generator=ph_gen)
    probs = torch.softmax(small[0, 0, :v_lim].float(), -1).cpu()
    counts = torch.bincount(ids_p.flatten().long().cpu(), minlength=v_lim).double()
    expected = probs.double() * rows
    stat = float(((counts - expected) ** 2 / expected).sum())
    p_value = float(chi2.sf(stat, v_lim - 1))
    sel_match = torch.allclose(sel_p.flatten().cpu(), probs[ids_p.flatten().long().cpu()],
                               rtol=1e-5, atol=0)
    in_range = bool((ids_p < v_lim).all())
    philox_ok = p_value > 1e-6 and sel_match and in_range
    log(f"[kernel] fused_categorical_cfg Philox: {rows} draws over {v_lim} of {v_raw} columns: "
        f"chi2 {stat:.2f} df {v_lim - 1} p {p_value:.3g} (bound p > 1e-6), ids < vocab_limit "
        f"{in_range}, sel == softmax[id] (rtol 1e-5) {sel_match} {'ok' if philox_ok else 'FAIL'}")

    timing = (time_ms(lambda: fused_categorical_cfg(logits, guidance, v, gumbel=gumbel)),
              time_ms(lambda: fused_categorical_cfg_plain(logits, guidance, v, gumbel)))
    # fp32: the combine (3), x + g (1), the running max and sum with one exp (3)
    BOUNDS["fused_categorical_cfg"] = (nbytes(logits, gumbel, ids, sel), 7 * b * s * v, "fp32")
    log(f"[kernel] fused_categorical_cfg Philox route: "
        f"{time_ms(lambda: fused_categorical_cfg(logits, guidance, v, generator=ph_gen)):.4f} ms")
    return ids_ok and sel_ok and philox_ok, max_abs, timing


def check_categorical(device, gen):
    """The CFG-free sampler at the serving shape, raw bf16 logits (1, 256,
    8256) cropped to the 8192 codes: explicit noise (ids exactly equal, sel
    rel 1e-5) and the Philox route (chi-square against softmax, as for the
    CFG sampler)."""
    from scipy.stats import chi2

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

    rows, small_v, v_lim = 1 << 16, 20, 16
    row = torch.linspace(-2.0, 1.0, small_v)
    small = row.expand(1, rows, small_v).contiguous().to(device, torch.bfloat16)
    ph_gen = torch.Generator().manual_seed(4321)
    ids_p, sel_p = fused_categorical(small, v_lim, generator=ph_gen)
    probs = torch.softmax(small[0, 0, :v_lim].float(), -1).cpu()
    counts = torch.bincount(ids_p.flatten().long().cpu(), minlength=v_lim).double()
    expected = probs.double() * rows
    stat = float(((counts - expected) ** 2 / expected).sum())
    p_value = float(chi2.sf(stat, v_lim - 1))
    sel_match = torch.allclose(sel_p.flatten().cpu(), probs[ids_p.flatten().long().cpu()],
                               rtol=1e-5, atol=0)
    in_range = bool((ids_p < v_lim).all())
    philox_ok = p_value > 1e-6 and sel_match and in_range
    log(f"[kernel] fused_categorical Philox: {rows} draws over {v_lim} of {small_v} columns: "
        f"chi2 {stat:.2f} df {v_lim - 1} p {p_value:.3g} (bound p > 1e-6), ids < vocab_limit "
        f"{in_range}, sel == softmax[id] (rtol 1e-5) {sel_match} {'ok' if philox_ok else 'FAIL'}")

    timing = (time_ms(lambda: fused_categorical(logits, v, gumbel=gumbel)),
              time_ms(lambda: fused_categorical_plain(logits, v, gumbel)))
    philox_ms = time_ms(lambda: fused_categorical(logits, v, generator=ph_gen))
    philox_bound = nbytes(logits[..., :v], ids, sel) / HBM_BYTES_PER_S * 1e3
    log(f"[kernel] fused_categorical Philox route: {philox_ms:.4f} ms (bound {philox_bound:.4f} "
        f"ms: the cropped logits read once)")
    # fp32: x + g (1), the running max and sum with one exp (3); the cropped
    # columns only
    BOUNDS["fused_categorical"] = (nbytes(logits[..., :v], gumbel, ids, sel), 4 * b * s * v,
                                   "fp32")
    return ids_ok and sel_ok and philox_ok, max_abs, timing


# the VQ search shapes: a pre-encode batch of 64 images (64 x 256 latent
# rows) and one 256px inpainting request, against the 8192-code codebook
VQ_SHAPES = {"pre_encode": (64 * 256, 256, 8192), "inpainting": (256, 256, 8192)}
VQ_RTOL = 1e-5


def check_vq(device, gen):
    """vq_argmin against vq_argmin_plain in fp32, TF32 off, at both path
    shapes: ids equal except at rows whose two best plain scores lie within
    VQ_RTOL of the squared distances' scale, where the kernel's pick is
    within that of the minimum; two calls bit-equal."""
    from open_muse_tpu_torch.kernels.vq_argmin import vq_argmin, vq_argmin_plain, vq_near_ties

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
        ms = (time_ms(lambda: vq_argmin(z, cb), reps=10, trials=5),
              time_ms(lambda: vq_argmin_plain(z, cb), reps=10, trials=5))
        log(f"[time] vq_argmin ({path}, N {n}): kernel {ms[0]:.4f} ms, plain {ms[1]:.4f} ms "
            f"(median, CUDA events); bound {2 * n * k * c / PEAK_OPS_PER_S['fp32'] * 1e3:.4f} ms "
            f"(2NKC fp32 operations)")
        if timing is None:  # the pre-encode shape is the kernel's row in the report
            timing = ms
            BOUNDS["vq_argmin"] = (nbytes(z, cb, ids), 2 * n * k * c, "fp32")
        del z, cb, ref
    # the report's error column: the worst pick's score gap in units of the scale
    return ok, worst, timing


# the rows timed by graph_ms; the others by time_ms
GRAPH_TIMED = ("fused_residual_rmsnorm", "fused_residual_layernorm", "flash_attention")
# the norms' path shapes: v1's 257 tokens (class + 256) and v2's CFG batch of
# 2 x 256 at width 768 with a residual, v1's 3072-wide mid-MLP norm without;
# the report's row is the residual-free shape, where one PyTorch call
# (F.rms_norm / F.layer_norm) computes the same function
NORM_SHAPES = (((1, 257, 768), True), ((2, 256, 768), True), ((1, 257, 3072), False))
NORM_EPS, NORM_TOL = 1e-6, 1e-2


def check_norms(device, gen):
    """Both fused norms against their plain versions in bf16 (no bias, as
    on the paths): out to NORM_TOL (fp32 arithmetic on both sides with one
    cast at the end: at most about one bf16 rounding apart), the prenorm sum
    bit-equal (x itself without a residual), two calls bit-equal."""
    from torch.nn import functional as F

    from open_muse_tpu_torch.kernels.fused_norm import (
        fused_residual_layernorm, fused_residual_layernorm_plain, fused_residual_rmsnorm,
        fused_residual_rmsnorm_plain)

    bf = torch.bfloat16
    cases = {
        "fused_residual_rmsnorm": (
            lambda x, r, w: fused_residual_rmsnorm(x, r, w, NORM_EPS),
            lambda x, r, w: fused_residual_rmsnorm_plain(x, r, w, NORM_EPS),
            lambda x, w: F.rms_norm(x, (x.shape[-1],), w, NORM_EPS), 5),
        "fused_residual_layernorm": (
            lambda x, r, w: fused_residual_layernorm(x, r, w, None, NORM_EPS),
            lambda x, r, w: fused_residual_layernorm_plain(x, r, w, None, NORM_EPS),
            lambda x, w: F.layer_norm(x, (x.shape[-1],), w, None, NORM_EPS), 8),
    }
    results = {}
    for name, (kern, plain, lib, flops) in cases.items():
        ok, worst = True, 0.0
        for shape, with_res in NORM_SHAPES:
            x = (torch.randn(*shape, generator=gen) * 2).to(device, bf)
            res = torch.randn(*shape, generator=gen).to(device, bf) if with_res else None
            w = (1 + 0.1 * torch.randn(shape[-1], generator=gen)).to(device, bf)
            out, pre = kern(x, res, w)
            ref, ref_pre = plain(x, res, w)
            max_abs, rel = errors(out, ref)
            pre_ok = torch.equal(pre, ref_pre) and ((pre is x) == (res is None))
            twice = torch.equal(out, kern(x, res, w)[0])
            case_ok = rel <= NORM_TOL and pre_ok and twice and bool(torch.isfinite(out).all())
            ok &= case_ok
            worst = max(worst, max_abs)
            ms = (graph_ms(lambda: kern(x, res, w)), graph_ms(lambda: plain(x, res, w)))
            log(f"[kernel] {name} x {shape} res={'given' if with_res else 'None'} bf16: max_abs "
                f"{max_abs:.3e} rel {rel:.3e} (tol rel {NORM_TOL}: one bf16 rounding), prenorm "
                f"bit-equal {pre_ok}, two calls bit-equal {twice}; kernel {ms[0]:.4f} ms, plain "
                f"{ms[1]:.4f} ms (CUDA graph replay) {'ok' if case_ok else 'FAIL'}")
        # the last shape, residual-free, is the report's row
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


# flash attention at the paths' shapes: v1's self-attention (257 tokens, 16
# heads of 48, q / k / v views into the fused projection) and v2's block
# cross-attention (2 x 256 queries, 12 heads of 64, 77 text keys as views into
# the [k | v] projection); the report's row is v1's
ATTN_TOL = 2e-2


def _attention_inputs(device, gen, b, tq, tk, heads, d):
    bf = torch.bfloat16
    if tq == tk:
        qkv = torch.randn(b, tq, 3 * heads * d, generator=gen).to(device, bf)
        return qkv.reshape(b, tq, 3 * heads, d).chunk(3, dim=2)
    q = torch.randn(b, tq, heads, d, generator=gen).to(device, bf)
    kv = torch.randn(b, tk, 2 * heads * d, generator=gen).to(device, bf)
    return (q, *kv.reshape(b, tk, 2 * heads, d).chunk(2, dim=2))


def check_flash(device, gen):
    """flash_attention against flash_attention_plain in bf16: out to ATTN_TOL
    (the kernel rounds P to bf16 as the plain version does, but sums QK^T,
    the softmax and PV in another order), two calls bit-equal; SDPA on the
    same inputs timed as the library call."""
    from torch.nn import functional as F

    from open_muse_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    ok, worst, row = True, 0.0, None
    for b, tq, tk, heads, d in ((2, 256, 77, 12, 64), (1, 257, 257, 16, 48)):
        q, k, v = _attention_inputs(device, gen, b, tq, tk, heads, d)
        out, ref = flash_attention(q, k, v), flash_attention_plain(q, k, v)
        max_abs, rel = errors(out, ref)
        twice = torch.equal(out, flash_attention(q, k, v))
        case_ok = rel <= ATTN_TOL and twice and bool(torch.isfinite(out).all())
        ok &= case_ok
        worst = max(worst, max_abs)
        ms = (graph_ms(lambda: flash_attention(q, k, v)),
              graph_ms(lambda: flash_attention_plain(q, k, v)))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        lib_ms = graph_ms(sdpa)
        lib_err = errors(sdpa().transpose(1, 2), ref)[1]
        log(f"[kernel] flash_attention q {tuple(q.shape)} k,v {tuple(k.shape)} bf16: max_abs "
            f"{max_abs:.3e} rel {rel:.3e} (tol rel {ATTN_TOL}: summation order, bf16 P), two calls "
            f"bit-equal {twice}; kernel {ms[0]:.4f} ms, plain {ms[1]:.4f} ms, SDPA {lib_ms:.4f} ms "
            f"(CUDA graph replay; rel {lib_err:.3e} vs plain) {'ok' if case_ok else 'FAIL'}")
        # q, k, v read and o written once; QK^T and PV
        row = (ms, lib_ms, (nbytes(q, k, v, out), 4 * b * heads * tq * tk * d, "bf16"))
    ms, LIBRARY_MS["flash_attention"], BOUNDS["flash_attention"] = row
    return ok, worst, ms


def kernel_phase(device):
    from open_muse_tpu_torch import kernels

    gen = torch.Generator().manual_seed(0)
    report = {"glu_down_matmul": check_glu(device, gen, 2 * TRAIN_S)}
    report.update(check_sublayers(device, gen, 2))
    report["fused_categorical_cfg"] = check_sampler(device, gen)
    report["fused_categorical"] = check_categorical(device, gen)
    report["vq_argmin"] = check_vq(device, gen)
    report.update(check_norms(device, gen))
    report["flash_attention"] = check_flash(device, gen)
    for name, (ok, err, (ms, plain_ms)) in report.items():
        how = "CUDA graph replay" if name in GRAPH_TIMED else "CUDA events"
        log(f"[time] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median, {how})")
    # the training path runs the forward kernels at batch 16 too
    train = {"glu_down_matmul": check_glu(device, gen, TRAIN_B * TRAIN_S)}
    train.update(check_sublayers(device, gen, TRAIN_B))
    for name, (ok, err, (ms, plain_ms)) in train.items():
        log(f"[time] {name} at the training shapes: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            f"(median, CUDA events)")
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


def check_glu_bwd(device, gen):
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
    timing = (time_ms(lambda: glu_down_matmul_bwd(a, b, wo, g)),
              time_ms(lambda: glu_down_matmul_bwd_plain(a, b, wo, g)))
    # dh = g wo and dwo = h^T g
    BOUNDS["glu_down_matmul_bwd"] = (nbytes(a, b, wo, g, *got), 4 * m * INTER * HIDDEN, "bf16")
    return ok, worst, timing


def check_sublayer_bwd(device, gen):
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
        timing = (time_ms(lambda: kern(inp["res"])), time_ms(lambda: plain(inp["res"])))
        results[name] = (ok, worst, timing)
        # the products of this backward, forward recompute included: self
        # recomputes qkv and takes dattn, dWout, dWqkv, da (11 d x d
        # products per row), cross recomputes q and takes dattn, dWout, dWq,
        # da (5); attention recomputes S and O and takes dP, dV, dQ, dK (6)
        keys, proj = (TRAIN_S, 11) if "self" in name else (KV_LEN, 5)
        rows = TRAIN_B * TRAIN_S
        ops = 2 * rows * proj * d * d + 12 * TRAIN_B * HEADS * TRAIN_S * keys * (d // HEADS)
        moved = nbytes(inp["x"], inp["res"], *common, inp["wout"], g_out, g_res,
                       *((wqkv,) if "self" in name else (wq, kv)), *kern(inp["res"]))
        BOUNDS[name] = (moved, ops, "bf16")
    return results


def backward_kernel_phase(device):
    from open_muse_tpu_torch import kernels

    gen = torch.Generator().manual_seed(1)
    report = {"glu_down_matmul_bwd": check_glu_bwd(device, gen)}
    report.update(check_sublayer_bwd(device, gen))
    for name, (ok, err, (ms, plain_ms)) in report.items():
        log(f"[time] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median, CUDA events)")
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
    N(0, 0.1), GRN gains ~ N(0, 0.5)."""
    gen = torch.Generator(device=next(module.parameters()).device).manual_seed(seed)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
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


def one_request(pipe, prompt, seed, guidance=GUIDANCE, inpaint=None):
    """One 256px / bs1 / 12-step request through PipelineMuse.text2image, or
    through PipelineMuseInpainting.inpaint with ``inpaint=(pixels, mask)``;
    returns (seconds, images, tokens, launch deltas)."""
    from open_muse_tpu_torch import kernels

    captured = []
    vae = pipe.vae
    vae.decode_code = lambda tokens: (captured.append(tokens), type(vae).decode_code(vae, tokens))[1]
    ids = torch.as_tensor(pipe.tokenizer([prompt])["input_ids"], dtype=torch.long)
    micro = torch.tensor([[512, 512, 0, 0, 6.0]])
    gen = torch.Generator().manual_seed(seed)
    before = kernels.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        if inpaint is None:
            images = pipe.text2image(ids, micro, gen, timesteps=TIMESTEPS, guidance_scale=guidance,
                                     temperature=TEMPERATURE, seq_len=256)
        else:
            images = pipe.inpaint(*inpaint, ids, micro, gen, timesteps=TIMESTEPS,
                                  guidance_scale=guidance, temperature=TEMPERATURE)
        torch.cuda.synchronize()
    finally:
        del vae.decode_code  # back to the class's method
    seconds = time.perf_counter() - t0
    after = kernels.launch_counts()
    return seconds, images, captured[0], {k: after[k] - before[k] for k in after}


def expected_request_launches(cfg, sampler, vq=0):
    """Per request of the U-ViT ``cfg``, no backward kernel.  At each of the
    12 steps: every trunk layer's two sublayers and GLU, its GLU pre-norm (a
    LayerNorm); each of the down and up stacks' num_res_blocks
    AttentionBlock2Ds two flash attentions and two RMSNorms, each ResBlock
    one RMSNorm; the RMSNorms of ConvEmbed, the two projections and the MLM
    head; the sampler once.  Once a request: encoder_proj_layer_norm, in the
    step context."""
    from open_muse_tpu_torch import kernels

    layers, blocks = cfg.num_hidden_layers, 2 * cfg.num_res_blocks
    expected = {name: 0 for name in kernels.launch_counts()}
    expected.update({"attn_sublayer_self": layers * TIMESTEPS,
                     "attn_sublayer_cross": layers * TIMESTEPS,
                     "glu_down_matmul": layers * TIMESTEPS, sampler: TIMESTEPS,
                     "flash_attention": 2 * blocks * TIMESTEPS,
                     "fused_residual_rmsnorm": (3 * blocks + 4) * TIMESTEPS + 1,
                     "fused_residual_layernorm": layers * TIMESTEPS})
    if vq:
        expected["vq_argmin"] = vq
    return expected


def run_requests(pipe, smi, path, expected, guidance=GUIDANCE, inpaint=None, check=None,
                 request=None, codebook=8192, steps=TIMESTEPS):
    """Three requests with the launch counters set to 0 before them; each
    must give a finite (1, 256, 256, 3) image, tokens in [0, codebook), the
    expected launches and pass ``check(tokens)``.  ``request(i)`` replaces
    the text request (``one_request`` with the i-th prompt).  Returns
    (median seconds, the path's launch counts)."""
    from open_muse_tpu_torch import kernels

    if request is None:
        request = lambda i: (repr(PROMPTS[i]), *one_request(pipe, PROMPTS[i], i, guidance,  # noqa: E731
                                                             inpaint))
    kernels.reset_launch_counts()
    latencies = []
    for i in range(3):
        label, seconds, images, tokens, delta = request(i)
        finite = bool(torch.isfinite(images).all())
        tokens_ok = bool(((tokens >= 0) & (tokens < codebook)).all())
        extra = "" if check is None else check(tokens)
        ok = (tuple(images.shape) == (1, 256, 256, 3) and finite and tokens_ok
              and delta == expected and not extra.endswith("FAIL"))
        log(f"[{path}] {i}: {label} seed {i}: {seconds * 1e3:.1f} ms, image "
            f"{tuple(images.shape)} finite {finite} range [{images.min().item():.3f}, "
            f"{images.max().item():.3f}], tokens in [0, {codebook}) {tokens_ok} "
            f"({tokens.unique().numel()} distinct){extra}, launches {delta} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: {path} request {i} failed (expected launches "
                             f"{expected})")
        latencies.append(seconds)
    launches = kernels.launch_counts()
    median = statistics.median(latencies)
    log(f"[latency] {path}: median request {median * 1e3:.1f} ms over 3 (256px, bs1, "
        f"{steps} steps, guidance {guidance}; host clock, synchronised) on {smi}")
    return median, launches


def request_phase(pipe, device, smi):
    cfg = pipe.transformer.config
    warm, *_ = one_request(pipe, PROMPTS[-1], 99)
    log(f"[request] warm-up {warm * 1e3:.1f} ms")
    if not check_logits(pipe, device):
        raise SystemExit("chip_smoke: kernel forward disagrees with the plain forward")
    median, launches = run_requests(pipe, smi, "serving",
                                    expected_request_launches(cfg, "fused_categorical_cfg"))
    profiled("request", lambda: one_request(pipe, PROMPTS[3], 3), median,
             "profile_request.txt", rows=18)
    return launches


def nocfg_phase(pipe, smi):
    """Guidance 0, as a guidance-distilled student serves: batch 1 through
    the trunk and the CFG-free sampler."""
    cfg = pipe.transformer.config
    warm, *_ = one_request(pipe, PROMPTS[-1], 98, guidance=0.0)
    log(f"[serving_nocfg] warm-up {warm * 1e3:.1f} ms")
    median, launches = run_requests(pipe, smi, "serving_nocfg",
                                    expected_request_launches(cfg, "fused_categorical"),
                                    guidance=0.0)
    profiled("CFG-free request", lambda: one_request(pipe, PROMPTS[3], 3, guidance=0.0), median,
             "profile_request_nocfg.txt")
    return launches


def inpainting_phase(pipe, device, smi):
    """A seeded 256 x 256 image with the centre 8 x 8 of its 16 x 16 tokens
    repainted under CFG 8.0."""
    cfg = pipe.transformer.config
    gen = torch.Generator().manual_seed(21)
    pixels = torch.rand(1, 256, 256, 3, generator=gen).to(device)
    mask = torch.zeros(16, 16, dtype=torch.bool)
    mask[4:12, 4:12] = True
    mask = mask.reshape(-1)
    with torch.no_grad():
        codes = pipe.vae.get_code(pixels)[0].cpu()

    def kept(tokens):
        same = torch.equal(tokens[0].cpu()[~mask], codes[~mask])
        return f", {int((~mask).sum())} tokens outside the mask equal the encoded ones {same}" + (
            "" if same else " FAIL")

    warm, *_ = one_request(pipe, PROMPTS[-1], 97, inpaint=(pixels, mask))
    log(f"[inpainting] warm-up {warm * 1e3:.1f} ms; mask {int(mask.sum())} of {mask.numel()} "
        f"tokens")
    median, launches = run_requests(pipe, smi, "inpainting",
                                    expected_request_launches(cfg, "fused_categorical_cfg", vq=1),
                                    inpaint=(pixels, mask), check=kept)
    profiled("inpainting request", lambda: one_request(pipe, PROMPTS[3], 3,
                                                       inpaint=(pixels, mask)),
             median, "profile_inpainting.txt")
    return launches


# -- the class-conditional path at full width -----------------------------------

# configs/imagenet.yaml: training.generation_timesteps; the pipeline's default
# (2, 0) temperature anneal
CLASS_TIMESTEPS = 8
CLASS_IDS = (207, 360, 970, 88)


def build_class_pipeline(device):
    """MaskGitTransformer at configs/imagenet.yaml's model.transformer (24
    layers, hidden 768) in bf16 and the MaskGIT VQGAN at its defaults (f16,
    1024 codes) in fp32, seeded random weights."""
    from open_muse_tpu_torch.models.maskgit_vqgan import MaskGitVQGAN, MaskGitVQGANConfig
    from open_muse_tpu_torch.models.transformer_v1 import MaskGitTransformer
    from open_muse_tpu_torch.pipelines.pipeline_muse import PipelineMuse
    from open_muse_tpu_torch.utils.config import load_config

    config = load_config(["config=" + os.path.join(HERE, "configs", "imagenet.yaml")])
    # YAML 1.1 reads "1e-6" as a string
    tcfg = {k: float(v) if k == "layer_norm_eps" else v
            for k, v in config.model.transformer.to_dict().items()}
    with torch.device(device):
        transformer = MaskGitTransformer(MaskGitTransformer.config_from_dict(tcfg))
        vae = MaskGitVQGAN(MaskGitVQGANConfig())
    randomize_(transformer, 10)
    randomize_(vae, 11)
    transformer.to(torch.bfloat16).eval()
    vae.eval()
    counts = {name: sum(p.numel() for p in m.parameters())
              for name, m in (("maskgit_v1", transformer), ("maskgit_vqgan", vae))}
    log(f"[class_conditional] params {counts}; v1 bf16, vqgan fp32; transformer config {tcfg}")
    return PipelineMuse(vae=vae, transformer=transformer, is_class_conditioned=True)


def one_class_request(pipe, class_id, seed):
    """One 256px / bs1 / 8-step request through PipelineMuse(class_ids=...);
    returns (label, seconds, images, tokens, launch deltas)."""
    from open_muse_tpu_torch import kernels

    captured = []
    vae = pipe.vae
    vae.decode_code = lambda tokens: (captured.append(tokens), type(vae).decode_code(vae, tokens))[1]
    gen = torch.Generator().manual_seed(seed)
    before = kernels.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        images = pipe(class_ids=[class_id], timesteps=CLASS_TIMESTEPS, generator=gen,
                      return_pil=False)
        torch.cuda.synchronize()
    finally:
        del vae.decode_code
    seconds = time.perf_counter() - t0
    after = kernels.launch_counts()
    return (f"class {class_id}", seconds, images, captured[0],
            {k: after[k] - before[k] for k in after})


def check_class_logits(pipe, device):
    """One full-width v1 forward (class token + 256 tokens, half masked)
    with the kernels against the all-plain forward."""
    t = pipe.transformer
    cfg = t.config
    gen = torch.Generator(device=device).manual_seed(6)
    tokens = torch.randint(0, cfg.codebook_size, (1, cfg.num_vq_tokens), generator=gen,
                           device=device)
    tokens[torch.rand(tokens.shape, generator=gen, device=device) < 0.5] = cfg.mask_token_id
    ids = torch.cat([torch.full((1, 1), cfg.codebook_size + CLASS_IDS[0], device=device), tokens], 1)
    with torch.no_grad():
        ctx = t.step_context()
        fused = t(ids, step_ctx=ctx, use_kernels=True)
        plain = t(ids, step_ctx=ctx, use_kernels=False)
    max_abs, rel = errors(fused, plain)
    ok = rel <= 5e-2 and bool(torch.isfinite(fused).all())
    log(f"[logits] full-width v1 forward {tuple(fused.shape)} bf16, kernels vs all-plain: "
        f"max_abs {max_abs:.3e} rel {rel:.3e} (tol rel 5e-2: bf16 roundings through "
        f"{cfg.num_hidden_layers} layers) {'ok' if ok else 'FAIL'}")
    return ok


def class_conditional_phase(device, smi):
    """Three ImageNet class-id requests.  Per request, at each of the 8
    steps: each layer's self-attention (flash_attention) and its four
    LayerNorms (attention, post-attention, pre- and mid-MLP), the final and
    MLM-head LayerNorms, the sampler once."""
    from open_muse_tpu_torch import kernels

    pipe = build_class_pipeline(device)
    cfg = pipe.transformer.config
    expected = {name: 0 for name in kernels.launch_counts()}
    expected.update({"flash_attention": cfg.num_hidden_layers * CLASS_TIMESTEPS,
                     "fused_residual_layernorm": (4 * cfg.num_hidden_layers + 2) * CLASS_TIMESTEPS,
                     "fused_categorical": CLASS_TIMESTEPS})
    warm = one_class_request(pipe, CLASS_IDS[-1], 96)[1]
    log(f"[class_conditional] warm-up {warm * 1e3:.1f} ms")
    if not check_class_logits(pipe, device):
        raise SystemExit("chip_smoke: v1 kernel forward disagrees with the plain forward")
    median, launches = run_requests(
        pipe, smi, "class_conditional", expected, guidance=0.0, codebook=cfg.codebook_size,
        steps=CLASS_TIMESTEPS, request=lambda i: one_class_request(pipe, CLASS_IDS[i], i))
    profiled("class-conditional request", lambda: one_class_request(pipe, CLASS_IDS[3], 3),
             median, "profile_class_conditional.txt")
    del pipe
    torch.cuda.empty_cache()
    return launches


def profiled(label, fn, unprofiled_s, filename, rows=16):
    """Run ``fn`` once more under the profiler (outside any counted run);
    the table of device time by kernel goes to ``chiprun_out/filename``.
    The busy share is device kernel time over ``unprofiled_s``, the same
    work's host-clock time without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    table = events.table(sort_by="self_device_time_total", row_limit=50)
    with open(os.path.join(HERE, "chiprun_out", filename), "w") as f:
        f.write(table)
    busy = device_us / 1e6 / unprofiled_s
    log(f"[profile] {label} {seconds * 1e3:.1f} ms under the profiler, device kernel time "
        f"{device_us / 1e3:.1f} ms; against the {unprofiled_s * 1e3:.1f} ms without it: busy "
        f"share {busy:.3f}, idle share {1 - busy:.3f}")
    for line in table.splitlines()[:rows]:
        log(f"[profile] {line}")


# -- the pre-encode path at full width ------------------------------------------

# 16 batches: a steady window of 15 after the first batch's warm-up
PRE_ENCODE_IMAGES, PRE_ENCODE_BATCH = 1024, 64


def write_image_shard(path, samples, seed=0):
    """A raw webdataset shard: ``samples`` seeded 256 x 256 PNG images (smooth
    colour fields with noise) with captions and LAION-style metadata;
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
            for ext, data in (("png", png.getvalue()), ("txt", PROMPTS[i % 4].encode()),
                              ("json", meta.encode())):
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
EXPECTED_TRAIN_LAUNCHES = {
    "attn_sublayer_self": 2 * LAYERS * TRAIN_STEPS, "attn_sublayer_cross": 2 * LAYERS * TRAIN_STEPS,
    "glu_down_matmul": 2 * LAYERS * TRAIN_STEPS, "fused_categorical_cfg": 0,
    "attn_sublayer_self_bwd": LAYERS * TRAIN_STEPS, "attn_sublayer_cross_bwd": LAYERS * TRAIN_STEPS,
    "glu_down_matmul_bwd": LAYERS * TRAIN_STEPS, "fused_categorical": 0, "vq_argmin": 0,
    "fused_residual_rmsnorm": (3 * BLOCKS + 5) * TRAIN_STEPS,
    "fused_residual_layernorm": 2 * LAYERS * TRAIN_STEPS,
    "flash_attention": 2 * BLOCKS * TRAIN_STEPS}
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


def write_shard(path, samples=32, seed=0):
    """A seeded pre-encoded shard in the dialect of scripts/pre_encode.py at
    the config's shapes: tokens (256,) in [0, 8192) (each image uses 16
    codes, so a repeated batch is learnable), CLIP penultimate states
    (77, 768) fp16, pooled (768,) fp16, and LAION metadata that passes the
    config's quality filter."""
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
            for ext, data in (
                    ("vq_f16.npy", npy(rs.choice(codes, TRAIN_S).astype(np.int32))),
                    ("clip_penultimate.npy", npy(rs.randn(KV_LEN, 768).astype(np.float16))),
                    ("clip_pooled.npy", npy(rs.randn(768).astype(np.float16))),
                    ("json", meta.encode())):
                info = tarfile.TarInfo(f"{i:05d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def profile_train_step(state, device, median_s):
    """Device time by kernel for one more train step (outside the counted
    run), against the unprofiled median step time."""
    from open_muse_tpu_torch.ops.sampling import get_mask_schedule
    from open_muse_tpu_torch.training import trainer as T
    from open_muse_tpu_torch.training.masking import draw_masking_noise

    step = T.make_uvit_train_step(get_mask_schedule("cosine"), 8255, codebook_size=8192,
                                  autocast_dtype=torch.bfloat16)
    batch = train_batch(device)
    noise = draw_masking_noise(TRAIN_B, TRAIN_S, torch.Generator(device=device).manual_seed(4),
                               8192)
    float(step(state, batch, noise)["loss"])  # warm-up outside the profile
    profiled("train step", lambda: float(step(state, batch, noise)["loss"]), median_s,
             "profile_train_step.txt")


def training_phase(device, smi):
    """train_muse.main on the research config at batch 16, then main again
    resuming from its checkpoint; returns the launch counts of the first."""
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
        with open(os.path.join(out, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        losses = [m["loss"] for m in logged]
        finite = all(v == v and abs(v) != float("inf") for v in losses)
        falling = losses[-1] < losses[0]
        steps_ok = [m["step"] for m in logged] == list(range(1, TRAIN_STEPS + 1))
        counts_ok = launches == EXPECTED_TRAIN_LAUNCHES
        for m in logged:
            log(f"[train] step {m['step']}: loss {m['loss']:.4f} grad_norm {m['grad_norm']:.4f} "
                f"masking {m['avg_masking_rate']:.3f} lr {m['lr']:.2e} "
                f"step_time {m['step_time'] * 1e3:.1f} ms")
        step_times = [m["step_time"] for m in logged[1:]]  # the first step warms up
        median = statistics.median(step_times)
        log(f"[train] {TRAIN_STEPS} steps in {wall:.1f} s (model build and checkpoint "
            f"included): losses finite {finite}, last {losses[-1]:.4f} < first {losses[0]:.4f} "
            f"{falling}, launches {launches} (expected {EXPECTED_TRAIN_LAUNCHES}) "
            f"{'ok' if counts_ok else 'FAIL'}")
        log(f"[train] median step {median * 1e3:.1f} ms over steps 2-{TRAIN_STEPS} (host clock, "
            f"synchronised), {TRAIN_B * TRAIN_S / median:.0f} tokens/s, "
            f"{TRAIN_B / median:.2f} images/s, peak memory {peak / 2 ** 30:.2f} GiB "
            f"(max_memory_allocated) on {smi}")

        # resume "latest": step and every tensor as saved
        resumed = train_muse.main(argv + ["experiment.resume_from_checkpoint=latest"])
        mine = dict(state.model.named_parameters())
        params_equal = all(torch.equal(p, mine[n]) for n, p in resumed.model.named_parameters())
        ema_equal = all(torch.equal(v, state.ema.shadow[n]) for n, v in resumed.ema.shadow.items())
        opt_equal = resumed.optimizer.count == state.optimizer.count == TRAIN_STEPS
        resume_ok = resumed.step == state.step == TRAIN_STEPS and params_equal and ema_equal \
            and opt_equal
        log(f"[train] resumed from {sorted(d for d in os.listdir(out) if d.startswith('checkpoint'))}: "
            f"step {resumed.step}, params equal {params_equal}, EMA equal {ema_equal}, "
            f"optimizer count {resumed.optimizer.count} {'ok' if resume_ok else 'FAIL'}")
        del resumed
        torch.cuda.empty_cache()
        profile_train_step(state, device, median)
        ok = finite and falling and steps_ok and counts_ok and resume_ok
        return ok, launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


# -- main -------------------------------------------------------------------

def device_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()

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

    from open_muse_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"[build] nvcc sm_90a build + load {time.perf_counter() - t0:.1f} s")
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "nvcc_build.log"), "w") as f:
        f.write(_build.build_log)

    phase_t0 = time.perf_counter()
    report = kernel_phase(device)
    report.update(backward_kernel_phase(device))
    failed = [name for name, (ok, _, _) in report.items() if not ok]
    log(f"[phase] kernel checks {time.perf_counter() - phase_t0:.1f} s")

    phase_t0 = time.perf_counter()
    pipe = build_pipeline(device)
    paths = {"serving": request_phase(pipe, device, smi)}
    paths["serving_nocfg"] = nocfg_phase(pipe, smi)
    paths["inpainting"] = inpainting_phase(pipe, device, smi)
    pre_ok, paths["pre_encode"] = pre_encode_phase(pipe, device, smi)
    if not pre_ok:
        failed.append("pre_encode phase")
    del pipe
    torch.cuda.empty_cache()
    log(f"[phase] serving, serving_nocfg, inpainting, pre_encode {time.perf_counter() - phase_t0:.1f} s")

    phase_t0 = time.perf_counter()
    paths["class_conditional"] = class_conditional_phase(device, smi)
    log(f"[phase] class_conditional {time.perf_counter() - phase_t0:.1f} s")

    phase_t0 = time.perf_counter()
    if not gradient_check(device):
        failed.append("full-width gradient check")
    train_ok, paths["training"] = training_phase(device, smi)
    if not train_ok:
        failed.append("training phase")
    log(f"[phase] gradient check and training {time.perf_counter() - phase_t0:.1f} s")

    rows = []
    for name, (ok, err, t) in report.items():
        bound, bound_by = bound_ms(name)
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name][0],
                     "replaces": SOURCES[name][1],
                     "launches": sum(p[name] for p in paths.values()),
                     "launches_by_path": {path: p[name] for path, p in paths.items()},
                     "max_abs_err": err, "ms": t[0], "plain_ms": t[1], "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": LIBRARY_MS.get(name)})
    missing = [r["name"] for r in rows if r["launches"] == 0]
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
