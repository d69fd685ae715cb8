"""Smoke run of the PyTorch port on one NVIDIA GPU.

Builds the port's CUDA kernels from ``open_muse_tpu_torch/csrc``, holds each
forward and backward kernel against its plain PyTorch version at the shapes
of its path, then drives the port's two paths at full width with seeded
random weights:

- serving: three 256px / batch-1 / 12-step CFG text-to-image requests through
  ``PipelineMuse.text2image``;
- training: ``training.train_muse.main`` on ``configs/laiona6plus_uvit_clip.yaml``
  at batch 16 on a seeded synthetic pre-encoded shard (one repeated batch),
  then a resume from its checkpoint; before it, one forward and backward
  with the kernels against one with the plain versions.

Each path runs with the launch counters set to 0 just before it and read
just after; the run fails unless every kernel of the path launched.  Exits
non-zero on any failure or without a GPU.

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
}


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
    log(f"[kernel] fused_categorical_cfg Philox route: "
        f"{time_ms(lambda: fused_categorical_cfg(logits, guidance, v, generator=ph_gen)):.4f} ms")
    return ids_ok and sel_ok and philox_ok, max_abs, timing


def kernel_phase(device):
    from open_muse_tpu_torch import kernels

    gen = torch.Generator().manual_seed(0)
    report = {"glu_down_matmul": check_glu(device, gen, 2 * TRAIN_S)}
    report.update(check_sublayers(device, gen, 2))
    report["fused_categorical_cfg"] = check_sampler(device, gen)
    for name, (ok, err, (ms, plain_ms)) in report.items():
        log(f"[time] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median, CUDA events)")
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
    from open_muse_tpu_torch.pipelines.pipeline_muse import PipelineMuse

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
    return PipelineMuse(vae=vae, transformer=transformer, text_encoder=text_encoder,
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


def one_request(pipe, device, prompt, seed):
    """One 256px / bs1 / 12-step CFG request through PipelineMuse.text2image;
    returns (seconds, images, tokens, launch deltas)."""
    from open_muse_tpu_torch import kernels

    captured = []
    vae = pipe.vae
    vae.decode_code = lambda tokens: (captured.append(tokens), type(vae).decode_code(vae, tokens))[1]
    ids = torch.as_tensor(pipe.tokenizer([prompt])["input_ids"], dtype=torch.long)
    micro = torch.tensor([[512, 512, 0, 0, 6.0]])
    before = kernels.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        images = pipe.text2image(ids, micro, torch.Generator().manual_seed(seed),
                                 timesteps=TIMESTEPS, guidance_scale=GUIDANCE,
                                 temperature=TEMPERATURE, seq_len=256)
        torch.cuda.synchronize()
    finally:
        del vae.decode_code  # back to the class's method
    seconds = time.perf_counter() - t0
    after = kernels.launch_counts()
    return seconds, images, captured[0], {k: after[k] - before[k] for k in after}


def request_phase(device, smi):
    from open_muse_tpu_torch import kernels

    pipe = build_pipeline(device)
    layers = pipe.transformer.config.num_hidden_layers
    expected = {name: 0 for name in kernels.launch_counts()}  # no backward kernel
    expected.update({"attn_sublayer_self": layers * TIMESTEPS,
                     "attn_sublayer_cross": layers * TIMESTEPS,
                     "glu_down_matmul": layers * TIMESTEPS, "fused_categorical_cfg": TIMESTEPS})
    warm, *_ = one_request(pipe, device, PROMPTS[-1], 99)
    log(f"[request] warm-up {warm * 1e3:.1f} ms")
    if not check_logits(pipe, device):
        raise SystemExit("chip_smoke: kernel forward disagrees with the plain forward")

    kernels.reset_launch_counts()
    latencies = []
    for i, prompt in enumerate(PROMPTS[:3]):
        seconds, images, tokens, delta = one_request(pipe, device, prompt, seed=i)
        finite = bool(torch.isfinite(images).all())
        tokens_ok = bool(((tokens >= 0) & (tokens < 8192)).all())
        ok = (tuple(images.shape) == (1, 256, 256, 3) and finite and tokens_ok
              and delta == expected)
        log(f"[request] {i}: {prompt!r} seed {i}: {seconds * 1e3:.1f} ms, image "
            f"{tuple(images.shape)} finite {finite} range [{images.min().item():.3f}, "
            f"{images.max().item():.3f}], tokens in [0, 8192) {tokens_ok} "
            f"({tokens.unique().numel()} distinct), launches {delta} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: request {i} failed (expected launches {expected})")
        latencies.append(seconds)
    log(f"[latency] median request {statistics.median(latencies) * 1e3:.1f} ms over 3 "
        f"(256px, bs1, {TIMESTEPS} steps, CFG {GUIDANCE}; host clock, synchronised) on {smi}")
    launches = kernels.launch_counts()
    profile_request(pipe, device, statistics.median(latencies))
    return launches


def profile_request(pipe, device, median_s):
    """Device time by kernel for one more request (outside the counted run);
    the table goes to chiprun_out/profile_request.txt.  The busy share is
    device kernel time over the unprofiled median latency."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        seconds, *_ = one_request(pipe, device, PROMPTS[3], seed=3)
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    with open(os.path.join(HERE, "chiprun_out", "profile_request.txt"), "w") as f:
        f.write(table)
    busy = device_us / 1e6 / median_s
    log(f"[profile] request {seconds * 1e3:.1f} ms under the profiler, device kernel time "
        f"{device_us / 1e3:.1f} ms; against the {median_s * 1e3:.1f} ms median: busy share "
        f"{busy:.3f}, idle share {1 - busy:.3f}")
    for line in table.splitlines()[:18]:
        log(f"[profile] {line}")


# -- the training path at full width ------------------------------------------

TRAIN_STEPS, CODES_PER_IMAGE = 8, 16
# the train step under the config's per-layer gradient checkpointing: each
# trunk layer's forward runs once and again in the backward, its backward once
LAYERS = 22
EXPECTED_TRAIN_LAUNCHES = {
    "attn_sublayer_self": 2 * LAYERS * TRAIN_STEPS, "attn_sublayer_cross": 2 * LAYERS * TRAIN_STEPS,
    "glu_down_matmul": 2 * LAYERS * TRAIN_STEPS, "fused_categorical_cfg": 0,
    "attn_sublayer_self_bwd": LAYERS * TRAIN_STEPS, "attn_sublayer_cross_bwd": LAYERS * TRAIN_STEPS,
    "glu_down_matmul_bwd": LAYERS * TRAIN_STEPS}
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


def profile_train_step(state, device, median_s, out_dir):
    """Device time by kernel for one more train step (outside the counted
    run); the table goes to ``out_dir/profile_train_step.txt``.  The busy
    share is device kernel time over the unprofiled median step time."""
    from torch.profiler import ProfilerActivity, profile

    from open_muse_tpu_torch.ops.sampling import get_mask_schedule
    from open_muse_tpu_torch.training import trainer as T
    from open_muse_tpu_torch.training.masking import draw_masking_noise

    step = T.make_uvit_train_step(get_mask_schedule("cosine"), 8255, codebook_size=8192,
                                  autocast_dtype=torch.bfloat16)
    batch = train_batch(device)
    noise = draw_masking_noise(TRAIN_B, TRAIN_S, torch.Generator(device=device).manual_seed(4),
                               8192)
    float(step(state, batch, noise)["loss"])  # warm-up outside the profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(state, batch, noise)["loss"])
        seconds = time.perf_counter() - t0
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    table = events.table(sort_by="self_device_time_total", row_limit=50)
    with open(os.path.join(out_dir, "profile_train_step.txt"), "w") as f:
        f.write(table)
    busy = device_us / 1e6 / median_s
    log(f"[profile] train step {seconds * 1e3:.1f} ms under the profiler, device kernel time "
        f"{device_us / 1e3:.1f} ms; against the {median_s * 1e3:.1f} ms median step: busy share "
        f"{busy:.3f}, idle share {1 - busy:.3f}")
    for line in table.splitlines()[:16]:
        log(f"[profile] {line}")


def training_phase(device, smi, out_dir):
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
        profile_train_step(state, device, median, out_dir)
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

    report = kernel_phase(device)
    report.update(backward_kernel_phase(device))
    failed = [name for name, (ok, _, _) in report.items() if not ok]
    paths = {"serving": request_phase(device, smi)}
    if not gradient_check(device):
        failed.append("full-width gradient check")
    train_ok, paths["training"] = training_phase(device, smi, out_dir)
    if not train_ok:
        failed.append("training phase")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": sum(p[name] for p in paths.values()),
         "launches_by_path": {path: p[name] for path, p in paths.items()},
         "max_abs_err": err, "ms": t[0], "plain_ms": t[1]}
        for name, (ok, err, t) in report.items()]}))
    if failed:
        raise SystemExit(f"chip_smoke: checks failed: {failed}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
