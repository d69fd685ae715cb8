"""Measurements beside chip_smoke.py, on one GPU, for the checkout given on
the command line (this one, or a parent commit unpacked with ``git archive``
into a git-ignored directory, so that both run in one chip call):

    python3 tools/chip_measure.py split TREE    # kernels 3, 4, 6, 8 - 12 by launch
    python3 tools/chip_measure.py kernels TREE  # chip_smoke's kernel phases alone
    python3 tools/chip_measure.py host TREE     # host enqueue cost a call
    python3 tools/chip_measure.py serving TREE  # request latency around a profile
    python3 tools/chip_measure.py attn_norm TREE  # kernel 5 and SDPA, kernels 1 / 2 wide
    python3 tools/chip_measure.py vq TREE       # kernel 6 alone, at VQ_SHAPES

``split`` times the samplers (kernels 3 and 4, the Philox route at the
serving shape), ``vq_argmin`` (kernel 6, at the pre-encode and inpainting
shapes), the GLU backward (kernel 8) and the sublayer kernels 10, 11 and 12
by CUDA graph replay and splits each by launch with
``chip_smoke.launch_split`` (the tree's own kernels, this script's shapes:
kernel 8 at a, b (4096, 2816) and g (4096, 1024), kernels 9 and 10 at x (2,
256, 1024) (serving), (128, 256, 1024) (the distillation teacher) and (16,
256, 1024) (training), 10 over 77 text keys: their attention cores' shares,
kernels 11 and 12 at x (16, 256, 1024)), then times cuBLAS alone on kernels
8, 10, 11 and 12's products, then holds kernels 11 and 12 at the 512px
trunk's x (2 | 8, 1024, 1024), kv 77, against their plain versions through
the tree's own ``check_sublayer_bwd`` and splits out their attention core
(its ``attn_bwd*`` launches) beside its bound and SDPA's forward + backward.  ``kernels`` runs the tree's ``chip_smoke.kernel_phase`` and
``backward_kernel_phase`` (every kernel row against its plain version) and
their launch splits.  ``host``
times 200 eager calls of kernels 5, 9, 10 and 11 enqueued without a
synchronise (the host's cost a call, the device running behind), before
and after a torch.profiler run in the same process.  ``serving`` builds
chip_smoke's full-width serving pipeline and times 5 CFG requests (256px,
bs1, 12 steps; eager and captured where the tree's requests replay a CUDA
graph), then one more under torch.profiler, printing the host
(self CPU) time of its top operations: where a host-bound request spends
its time.  ``attn_norm`` times kernel 5 at ATTN_SHAPES (the variant its
rule takes) beside SDPA, with each one's error against the plain version,
its bound (bytes or two products) and its MUFU floor (two exponentials a
score, 16 a clock an SM),
and kernels 1 and 2 at NORM_SHAPES in both stagings beside F.rms_norm /
F.layer_norm.  ``vq`` prints ptxas's report of kernel 6's entries, then
holds kernel 6 at VQ_SHAPES against its plain version (ids equal but at
near-ties, two calls bit-equal), times it by graph replay beside its bound
(12 N K C bf16 operations or bytes, the larger), the floor of its per-score
minimum (N K comparisons, one a lane a clock) and the plain search, and
splits each call by launch.
"""

from __future__ import annotations

import argparse
import functools
import inspect
import os
import sys
import time

import torch


def _load(tree):
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import chip_smoke
    from open_muse_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("chip_measure: no CUDA device")
    print(f"== tree {tree}: {chip_smoke.device_line()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    return tree, chip_smoke


def _sublayer_calls(C, dev, gen, batches=(2, 16), backward=((16, 16),)):
    """(label, call) of kernels 9 and 10 at ``batches``, 11 and 12 at each
    (batch, heads) of ``backward``: the training batch (16, 16), a tp=2
    rank's 8 heads (16, 8), the distillation student's (64, 16)."""
    from open_muse_tpu_torch.kernels import attn_sublayer as A

    bf, d = torch.bfloat16, 1024

    def operands(b, heads):
        inner = 64 * heads
        inp = C._sublayer_inputs(dev, gen, b=b, s=256, d=d, inner=inner)
        wq = (torch.randn(inner, d, generator=gen) * d ** -0.5).to(dev, bf)
        wqkv = (torch.randn(3 * inner, d, generator=gen) * d ** -0.5).to(dev, bf)
        kv = torch.randn(b, 77, 2 * inner, generator=gen).to(dev, bf)
        return (inp["x"], inp["res"], inp["ln_scale"], inp["adaln"]), inp["wout"], wq, wqkv, kv

    calls = {}
    for b in batches:
        common, wout, wq, wqkv, kv = operands(b, 16)
        calls[f"k9 self fwd x ({b}, 256, 1024)"] = functools.partial(
            A.attn_sublayer_self, *common, wqkv, wout, 16)
        calls[f"k10 cross fwd x ({b}, 256, 1024) kv ({b}, 77, 2048)"] = functools.partial(
            A.attn_sublayer_cross, *common, wq, wout, kv, 16)
    for b, heads in backward:
        common, wout, wq, wqkv, kv = operands(b, heads)
        g_out = (torch.randn(b, 256, d, generator=gen) * 0.01).to(dev, bf)
        g_res = (torch.randn(b, 256, d, generator=gen) * 0.01).to(dev, bf)
        calls[f"k11 self bwd x ({b}, 256, 1024) {heads} heads"] = functools.partial(
            A.attn_sublayer_self_bwd, *common, wqkv, wout, g_out, g_res, heads)
        calls[f"k12 cross bwd x ({b}, 256, 1024) kv ({b}, 77, {128 * heads}) {heads} heads"] = (
            functools.partial(A.attn_sublayer_cross_bwd, *common, wq, wout, kv, g_out, g_res,
                              heads))
    return calls


def _glu_bwd_call(dev, gen):
    """(label, call) of kernel 8 at the training rows."""
    from open_muse_tpu_torch.kernels.glu_matmul import glu_down_matmul_bwd

    bf, m, k, n = torch.bfloat16, 4096, 2816, 1024
    a, b = (torch.randn(m, k, generator=gen).to(dev, bf) for _ in range(2))
    wo = (torch.randn(n, k, generator=gen) * k ** -0.5).to(dev, bf)
    g = (torch.randn(m, n, generator=gen) * m ** -0.5).to(dev, bf)
    return (f"k8 glu bwd a,b ({m}, {k}) g ({m}, {n})",
            functools.partial(glu_down_matmul_bwd, a, b, wo, g))


def _sample_vq_calls(C, dev, gen):
    """(label, call) of kernels 3 and 4 on the Philox route (logits (1, 256,
    8256) cropped to 8192, and (2, 256, 8192) at guidance 8) and of kernel 6
    at chip_smoke's VQ shapes."""
    from open_muse_tpu_torch.kernels.fused_sample import fused_categorical, fused_categorical_cfg
    from open_muse_tpu_torch.kernels.vq_argmin import vq_argmin

    bf = torch.bfloat16
    one = (torch.randn(1, 256, 8256, generator=gen) * 2).to(dev, bf)
    two = (torch.randn(2, 256, 8192, generator=gen) * 2).to(dev, bf)
    # the seed on the device, as a captured request passes it (a host
    # generator's seed would be a host-to-device copy inside the capture)
    seed = torch.tensor([7], dtype=torch.int64, device=dev)
    calls = {"k3 fused_categorical Philox (1, 256, 8256 -> 8192)":
             lambda: fused_categorical(one, 8192, seed=seed),
             "k4 fused_categorical_cfg Philox (2, 256, 8192)":
             lambda: fused_categorical_cfg(two, 8.0, 8192, seed=seed)}
    for path, (n, c, k) in C.VQ_SHAPES.items():
        z = torch.randn(n, c, generator=gen).to(dev)
        cb = torch.randn(k, c, generator=gen).to(dev)
        calls[f"k6 vq_argmin ({path}) z ({n}, {c}) cb ({k}, {c})"] = functools.partial(
            vq_argmin, z, cb)
    return calls


def split(tree):
    _, C = _load(tree)
    dev, gen, bf = torch.device("cuda", 0), torch.Generator().manual_seed(0), torch.bfloat16
    calls = _sample_vq_calls(C, dev, gen)
    calls.update([_glu_bwd_call(dev, gen)])
    calls.update(_sublayer_calls(C, dev, gen, batches=(2, 128, 16),
                                backward=((16, 16), (16, 8), (64, 16))))
    for label, fn in calls.items():
        print(f"[time] {label}: {C.graph_ms(fn):.4f} ms (graph replay)", flush=True)
    for label, fn in calls.items():
        C.log_split(label, fn)
    m = torch.randn(4096, 3072, generator=gen).to(dev, bf)
    w1 = (torch.randn(1024, 1024, generator=gen) * 1024 ** -0.5).to(dev, bf)
    w3 = (torch.randn(3072, 1024, generator=gen) * 1024 ** -0.5).to(dev, bf)
    h = torch.randn(4096, 2816, generator=gen).to(dev, bf)
    wo = (torch.randn(1024, 2816, generator=gen) * 2816 ** -0.5).to(dev, bf)
    for label, a, w, nn in (("k10 q / out (512, 1024, 1024) a @ w.T", m[:512, :1024], w1, False),
                            ("k11 qkv (4096, 3072, 1024) a @ w.T", m[:, :1024], w3, False),
                            ("k11 dattn (4096, 1024, 1024) a @ w", m[:, :1024], w1, True),
                            ("k11 da (4096, 1024, 3072) a @ w", m, w3, True),
                            ("k12 q (4096, 1024, 1024) a @ w.T", m[:, :1024], w1, False),
                            ("k8 dh (4096, 2816, 1024) a @ w", m[:, :1024], wo, True),
                            ("k8 dwo (1024, 2816, 4096) a.T @ w", m[:, :1024], h, None)):
        a = a.contiguous()
        f = ((lambda: a.t() @ w) if nn is None  # noqa: B023
             else (lambda: a @ w) if nn else (lambda: a @ w.t()))  # noqa: B023
        print(f"[product] {label}, the product alone: cuBLAS {C.graph_ms(f) * 1e3:.2f} us",
              flush=True)
    wide_cores(C, dev, gen)


def core_bound_us(batch, heads, queries, keys):
    """The attention backward core's bound, as chip_smoke's ``core_bound``
    counts it (a parent tree may not have that function): q, dO, out, dq
    and k, v, dk, dv of 64 bf16 a head each moved once, six products."""
    moved = 2 * 64 * batch * heads * 4 * (queries + keys)
    ops = 6 * 2 * batch * heads * queries * keys * 64
    t_bytes, t_ops = moved / 3.35e12 * 1e6, ops / 989e12 * 1e6
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def wide_cores(C, dev, gen, seq=1024, kv_len=77, heads=16):
    """Kernels 11 / 12 at x (2 | 8, seq, 1024): each output against the
    plain version (the tree's check lines), the rows by graph replay, and
    the attention core alone by launch split."""
    for batch in (2, 8):
        cores = []
        rows = C.check_sublayer_bwd(dev, gen, batch=batch, seq=seq, cores=cores)
        for name, (ok, err, (ms, plain_ms)) in rows.items():
            print(f"[wide] {name} x ({batch}, {seq}, 1024): ok {ok} max_abs {err:.3e} kernel "
                  f"{ms * 1e3:.2f} us plain {plain_ms * 1e3:.2f} us (graph replay)", flush=True)
        for core in cores:  # (name, batch, heads, [seq,] keys, fn, sdpa_ms)
            name, keys, fn, sdpa_ms = core[0], core[-3], core[-2], core[-1]
            split = [(n, us) for n, us in C.launch_split(fn) if n.startswith("attn_bwd")]
            bound, by = core_bound_us(batch, heads, seq, keys)
            total = sum(us for _, us in split)
            print(f"[wide] {name} core x ({batch}, {seq}, 1024) over {keys} keys: "
                  f"{' + '.join(f'{n} {us:.2f}' for n, us in split) or 'not measured'} = "
                  f"{total:.2f} us (torch.profiler); bound {bound:.2f} us ({by}), "
                  f"{total / bound:.2f}x; SDPA forward + backward {sdpa_ms * 1e3:.2f} us, "
                  f"{total / (sdpa_ms * 1e3):.2f}x", flush=True)


def kernels(tree):
    _, C = _load(tree)
    device, splits = torch.device("cuda", 0), []
    report = C.kernel_phase(device, splits)
    if "splits" in inspect.signature(C.backward_kernel_phase).parameters:
        report.update(C.backward_kernel_phase(device, splits))
    else:  # a parent whose backward phase takes no splits
        report.update(C.backward_kernel_phase(device))
    for label, fn in splits:
        C.log_split(label, fn)
    for name, (ok, err, (ms, plain_ms)) in report.items():
        print(f"[row] {name}: ok {ok} max_abs {err:.3e} kernel {ms * 1e3:.2f} us plain "
              f"{plain_ms * 1e3:.2f} us bound {C.bound_ms(name)[0] * 1e3:.2f} us", flush=True)


def host(tree):
    tree, C = _load(tree)
    from open_muse_tpu_torch.kernels.flash_attention import flash_attention

    dev, gen, bf = torch.device("cuda", 0), torch.Generator().manual_seed(0), torch.bfloat16
    calls = {k: v for k, v in _sublayer_calls(C, dev, gen).items() if not k.startswith("k12")}
    q, k, v = C._attention_inputs(dev, gen, 2, 256, 77, 12, 64)
    calls["k5 flash (2, 256, 12, 64) x 77"] = functools.partial(flash_attention, q, k, v)
    x2 = torch.randn(2, 256, 1024, generator=gen).to(dev, bf)
    calls["torch add (2, 256, 1024)"] = lambda: x2 + x2

    def measure(tag, n=200):
        for label, fn in calls.items():
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            print(f"[host] {os.path.basename(tree)} {tag} {label}: enqueue "
                  f"{(t1 - t0) / n * 1e6:.1f} us a call, with the device "
                  f"{(t2 - t0) / n * 1e6:.1f} us", flush=True)

    measure("before any profile")
    C.launch_split(next(v for k, v in calls.items() if k.startswith("k10")))
    measure("after a profile")


def serving(tree):
    import statistics

    tree, C = _load(tree)
    pipe = C.build_pipeline(torch.device("cuda", 0))

    # a tree whose requests replay a captured graph also runs them eagerly
    routes = ((True, False) if "eager" in inspect.signature(C.one_request).parameters
              else (None,))

    def requests(tag):
        for eager in routes:
            kwargs = {} if eager is None else {"eager": eager}
            route = {None: "", True: " eager", False: " captured"}[eager]
            C.one_request(pipe, C.PROMPTS[-1], 99, **kwargs)  # warm-up (and capture)
            ms = [C.one_request(pipe, C.PROMPTS[i % 4], i, **kwargs)[0] * 1e3 for i in range(5)]
            print(f"[serving] {os.path.basename(tree)}{route} {tag}: median "
                  f"{statistics.median(ms):.1f} ms ({', '.join(f'{m:.1f}' for m in ms)})",
                  flush=True)

    requests("before any profile")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        C.one_request(pipe, C.PROMPTS[3], 3)
    events = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in events[:20]:
        print(f"[serving] {os.path.basename(tree)} host: {e.key[:70]}: self CPU "
              f"{e.self_cpu_time_total / 1e3:.2f} ms over {e.count} calls", flush=True)


# kernel 5 (b, tq, tk, heads, d): the MOVQ trunks' 1025 and 1024 keys (the
# 512 px v2's self-attention inside kernel 9 is the second), the v1
# trainers' batch of 64 (head dims 64 and 48) and the text trainer's
# cross-attention over 32 keys, CLIP ViT-L/14 at the eval batch and at 2, v1
# serving's 257, v2's 256 tokens when serving (12 and 16 heads: the latter
# kernel 9's core), at the training batch and at the distillation teacher's
# 128 rows, and its 77 text keys at each (kernel 10's core), the 1024-token
# cross-attention over 77 keys, and the eval stacks' head dims 16 and 32
# below and above 288 keys
ATTN_SHAPES = ((1, 1025, 1025, 16, 64), (2, 1024, 1024, 16, 64), (64, 256, 256, 16, 64),
               (64, 257, 257, 16, 48), (32, 257, 257, 16, 64), (64, 256, 32, 16, 64),
               (2, 257, 257, 16, 64), (1, 257, 257, 16, 48), (2, 256, 256, 12, 64),
               (2, 256, 77, 12, 64), (2, 256, 256, 16, 64), (2, 256, 77, 16, 64),
               (16, 256, 256, 16, 64), (16, 256, 77, 12, 64), (128, 256, 256, 16, 64),
               (128, 256, 77, 16, 64), (2, 1024, 77, 16, 64), (30, 17, 17, 4, 16),
               (32, 65, 65, 4, 16), (16, 64, 64, 4, 16), (16, 64, 8, 4, 16),
               (32, 256, 256, 2, 32), (32, 256, 8, 2, 32), (2, 1024, 1024, 4, 16),
               (2, 300, 300, 2, 32), (2, 289, 289, 16, 48))
# kernels 1 / 2 (shape, residual): v1's 4096-wide mid-MLP norm under CFG and
# at the text trainer's batch, 1280 (the larger Paella-VQ U-ViTs), the class
# trainer's 3072, the 512 px v2's trunk norm at 1024
NORM_SHAPES = (((2, 1024, 4096), False), ((64, 256, 4096), False), ((2, 1024, 4096), True),
               ((2, 1024, 1280), False), ((2, 1024, 1280), True), ((64, 257, 3072), False),
               ((2, 1024, 1024), True))


def attn_norm(tree):
    from torch.nn import functional as F

    tree, C = _load(tree)
    from open_muse_tpu_torch.kernels import flash_attention
    from open_muse_tpu_torch.kernels import fused_norm as N
    from open_muse_tpu_torch.kernels.flash_attention import flash_attention_plain

    # the module (the package's name flash_attention is the wrapper)
    FA = sys.modules["open_muse_tpu_torch.kernels.flash_attention"]

    dev, gen = torch.device("cuda", 0), torch.Generator().manual_seed(0)
    name = os.path.basename(tree)
    for shape in ATTN_SHAPES:
        b, tq, tk, h, d = shape
        q, k, v = C._attention_inputs(dev, gen, *shape)
        ref = flash_attention_plain(q, k, v)
        calls = {"kernel": functools.partial(flash_attention, q, k, v),
                 "sdpa": lambda: F.scaled_dot_product_attention(  # noqa: E731, B023
                     q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)}
        moved = C.nbytes(q, k, v, ref)
        bound, by = C.bound_of(moved, 4 * b * h * tq * tk * d, "bf16")
        mufu = 2 * b * h * tq * tk / C.MUFU_PER_S * 1e6
        # the tree's own rule where it names its variants (a parent may not)
        rule = (FA.variant(tk, d, b * h, tq, torch.cuda.get_device_properties(dev)
                           .multi_processor_count) if hasattr(FA, "variant")
                else "two-pass" if FA.takes_two_pass(tk) else "one-pass")
        three = 6 * b * h * tq * tk * d / C.PEAK_OPS_PER_S["bf16"] * 1e6
        for label, fn in calls.items():
            out = fn()
            rel = C.errors(out, ref)[1]
            twice = torch.equal(out, fn())
            us = C.graph_ms(fn) * 1e3
            print(f"[attn] {name} {shape} {label if label == 'sdpa' else rule}: {us:.2f} us, "
                  f"rel {rel:.3e} (tol "
                  f"{C.ATTN_TOL}), two calls bit-equal {twice}; bound {bound * 1e3:.2f} us "
                  f"({by}), three products {three:.2f} us, MUFU floor {mufu:.2f} us", flush=True)
    for shape, with_res in NORM_SHAPES:
        x = (torch.randn(*shape, generator=gen) * 2).to(dev, torch.bfloat16)
        res = torch.randn(*shape, generator=gen).to(dev, torch.bfloat16) if with_res else None
        w = (1 + 0.1 * torch.randn(shape[-1], generator=gen)).to(dev, torch.bfloat16)
        moved = C.nbytes(x, res, w, x, None if res is None else x)
        cases = {
            "rms": (lambda st: N.fused_residual_rmsnorm(x, res, w, 1e-6, staging=st),
                    {"pallas": lambda: N.fused_residual_rmsnorm_plain(x, res, w, 1e-6),
                     "model": lambda: N.fused_residual_rmsnorm_model_plain(x, res, w, 1e-6)},
                    lambda: F.rms_norm(x, (shape[-1],), w, 1e-6)),
            "ln": (lambda st: N.fused_residual_layernorm(x, res, w, None, 1e-6, staging=st),
                   {"pallas": lambda: N.fused_residual_layernorm_plain(x, res, w, None, 1e-6),
                    "model": lambda: N.fused_residual_layernorm_model_plain(x, res, w, None,
                                                                           1e-6)},
                   lambda: F.layer_norm(x, (shape[-1],), w, None, 1e-6)),
        }
        for kind, (kern, plains, lib) in cases.items():
            for staging, plain in plains.items():
                out, pre = kern(staging)
                ref, ref_pre = plain()
                rel = C.errors(out, ref)[1]
                same = torch.equal(pre, ref_pre) and torch.equal(out, kern(staging)[0])
                us = C.graph_ms(lambda: kern(staging)) * 1e3  # noqa: B023
                print(f"[norm] {name} {kind} {staging} x {shape} res={with_res}: {us:.2f} us, "
                      f"rel {rel:.3e} (tol {C.NORM_TOL}), prenorm and two calls bit-equal "
                      f"{same}; bound {moved / C.HBM_BYTES_PER_S * 1e6:.2f} us (bytes)",
                      flush=True)
            if res is None:
                print(f"[norm] {name} {kind} library call x {shape}: "
                      f"{C.graph_ms(lib) * 1e3:.2f} us", flush=True)


# kernel 6 (N, C, K): chip_smoke.py's VQ_SHAPES, train_movq_class's 16 x
# 1024 MOVQ latents among them, here so that a parent tree is timed at the
# same shapes
VQ_SHAPES = {"pre_encode": (64 * 256, 256, 8192), "inpainting": (256, 256, 8192),
             "class_inpainting": (256, 256, 1024), "train_raw": (16 * 256, 256, 8192),
             "train_class": (64 * 256, 256, 1024), "movq_class": (4 * 1024, 4, 16384),
             "paella": (64 * 4096, 4, 8192), "vqgan_train": (8 * 256, 256, 1024),
             "train_movq_class": (16 * 1024, 4, 16384)}
# one comparison a lane a clock: 132 SMs x 128 fp32 lanes x the 1.98 GHz boost clock
COMPARES_PER_S = 132 * 128 * 1.98e9


def vq(tree):
    tree, C = _load(tree)
    from open_muse_tpu_torch.kernels import _build
    from open_muse_tpu_torch.kernels.vq_argmin import vq_argmin, vq_argmin_plain, vq_near_ties

    name = os.path.basename(tree)
    for line in C.ptxas_report(_build.build_log, ("vq_",)):
        print(f"[ptxas] {name} {line}", flush=True)
    for line in _build.build_log.splitlines():
        if "C75" in line:
            print(f"[ptxas] {name} {line.strip()}", flush=True)
    dev, gen = torch.device("cuda", 0), torch.Generator().manual_seed(0)
    calls = {}
    for path, (n, c, k) in VQ_SHAPES.items():
        z = torch.randn(n, c, generator=gen).to(dev)
        cb = torch.randn(k, c, generator=gen).to(dev)
        ids = vq_argmin(z, cb)
        twice = torch.equal(ids, vq_argmin(z, cb))
        near, _, over = vq_near_ties(ids, z, cb, 1e-5)
        differ = ids != vq_argmin_plain(z, cb)
        ok = twice and bool((~differ | near).all()) and bool((over[differ] <= 0).all())
        fn = functools.partial(vq_argmin, z, cb)
        us = C.graph_ms(fn) * 1e3
        plain_us = C.graph_ms(functools.partial(vq_argmin_plain, z, cb), reps=5, trials=3) * 1e3
        bound, by = C.bound_of(C.nbytes(z, cb, ids), 12 * n * k * c, "bf16")
        print(f"[vq] {name} {path} z ({n}, {c}) cb ({k}, {c}): {us:.2f} us (graph replay), plain "
              f"{plain_us:.2f} us; bound {bound * 1e3:.2f} us ({by}), {us / (bound * 1e3):.1f}x; "
              f"comparison floor {n * k / COMPARES_PER_S * 1e6:.2f} us; {int(differ.sum())} ids "
              f"differ from plain, all at near-ties, two calls bit-equal: {'ok' if ok else 'FAIL'}",
              flush=True)
        calls[f"k6 vq_argmin ({path}) z ({n}, {c}) cb ({k}, {c})"] = fn
        del z, cb, ids, near, over, differ
    for label, fn in calls.items():
        C.log_split(label, fn)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("split", "kernels", "host", "serving", "attn_norm",
                                         "vq"))
    parser.add_argument("tree", help="the checkout whose kernels to measure")
    args = parser.parse_args()
    {"split": split, "kernels": kernels, "host": host, "serving": serving,
     "attn_norm": attn_norm, "vq": vq}[args.what](args.tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())
