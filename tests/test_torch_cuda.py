"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a GPU.  This file imports no jax,
so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import math
import os
import subprocess
import sys

import pytest
import torch

from open_muse_tpu_torch import kernels
from open_muse_tpu_torch.kernels import attn_sublayer as A
from open_muse_tpu_torch.kernels.fused_sample import (draw_seed, fused_categorical_cfg_plain,
                                                      fused_categorical_plain, philox_gumbel_plain)
from open_muse_tpu_torch.kernels.vq_argmin import (vq_argmin_plain, vq_near_ties, vq_split,
                                                   vq_split_plain)
from open_muse_tpu_torch.kernels.glu_matmul import (glu_down_matmul_bwd_plain,
                                                    glu_down_matmul_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, *shape, scale=1.0, device="cuda"):
    return (torch.randn(*shape, generator=gen) * scale).to(device, torch.bfloat16)


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("m,k,n", [(512, 2816, 1024), (4096, 2816, 1024), (300, 2816, 1024),
                                   (100, 96, 130)])
def test_glu_kernel_matches_plain(device, m, k, n):
    """The serving and training rows, ragged M (300 rows: not a multiple of
    the GEMM's tiles) and ragged N and K tiles; rel 2e-2 (bf16 output
    rounding); two calls bit-equal."""
    gen = torch.Generator().manual_seed(m)
    a, b = _rand(gen, m, k), _rand(gen, m, k)
    wo = _rand(gen, n, k, scale=k ** -0.5)
    before = kernels.glu_down_matmul.launches
    got = kernels.glu_down_matmul(a, b, wo)
    assert kernels.glu_down_matmul.launches == before + 1
    assert _rel(got, glu_down_matmul_plain(a, b, wo)) <= 2e-2
    assert torch.equal(got, kernels.glu_down_matmul(a, b, wo))


@pytest.mark.parametrize("b,s,kv_len", [(2, 256, 77), (16, 256, 77), (2, 100, 130)])
def test_sublayer_kernels_match_plain(device, b, s, kv_len):
    """The serving and training batches and ragged query and key tiles; rel
    3e-2 (bf16 roundings of qkv, probs and output); the prenorm residual
    bit-equal; two calls bit-equal."""
    gen = torch.Generator().manual_seed(s)
    d, h = 1024, 16
    x, res = _rand(gen, b, s, d), _rand(gen, b, s, d)
    ln, adaln = 1 + _rand(gen, d, scale=0.1), _rand(gen, b, 2 * d, scale=0.1)
    wqkv, wq = _rand(gen, 3 * d, d, scale=d ** -0.5), _rand(gen, d, d, scale=d ** -0.5)
    wout, kv = _rand(gen, d, d, scale=d ** -0.5), _rand(gen, b, kv_len, 2 * d)
    for r in (res, None):
        rr = torch.zeros_like(x) if r is None else r
        for kern, plain, args in (
                (kernels.attn_sublayer_self, A.attn_sublayer_self_plain, (wqkv, wout)),
                (kernels.attn_sublayer_cross, A.attn_sublayer_cross_plain, (wq, wout, kv))):
            out, hh = kern(x, r, ln, adaln, *args, h)
            ref, ref_h = plain(x, rr, ln, adaln, *args, h)
            assert _rel(out, ref) <= 3e-2 and torch.equal(hh, ref_h), kern.__name__
            again, again_h = kern(x, r, ln, adaln, *args, h)
            assert torch.equal(out, again) and torch.equal(hh, again_h), kern.__name__


@pytest.mark.parametrize("m,n,k", [(512, 1024, 2816), (200, 3072, 1024), (300, 130, 96),
                                   (300, 136, 96), (7, 24, 40), (1024, 2816, 4096),
                                   (304, 136, 96)])
@pytest.mark.parametrize("tile_width,split", [(0, 0), (64, 1), (64, 2), (128, 1), (128, 4),
                                              (256, 1), (256, 2)])
@pytest.mark.parametrize("layout", ["a @ w.T", "a @ w", "a.T @ w"])
def test_hopper_gemm_matches_linear(device, m, n, k, tile_width, split, layout):
    """The mainloop of kernels 7 - 12 alone, the weight read K-major (``a @
    w.T``, w (n, k)) and MN-major (``a @ w``, w (k, n): the backward's data
    gradients), and both operands MN-major (``a.T @ w``, a (k, m), w (k, n):
    the GLU's weight gradient, at its (1024, 2816, 4096)): every tile width,
    K splits over clusters of 2 and 4 (with a share of no k step at (7, 24,
    40)), ragged M, N and K (N 136 and 24: part or all of a 64-column box
    past N; M 200, 300 and 304 past the 128-row tile); within 1e-2 rel of an
    fp32 product of the same bf16 operands (bf16 output rounding, fp32 sums
    in another order); two calls bit-equal.  An MN-major operand takes its
    row (N for w, M for a) a multiple of 8 (the tensor map's row pitch):
    ``a @ w`` refuses N 130, ``a.T @ w`` M 300 and 7."""
    from open_muse_tpu_torch.kernels.gemm import linear_nn, linear_tn, linear_tnn

    gen = torch.Generator().manual_seed(m + n + k)
    a = _rand(gen, m, k)
    if layout == "a.T @ w":
        a_t, w = a.t().contiguous(), _rand(gen, k, n, scale=k ** -0.5)
        if m % 8 or n % 8:
            with pytest.raises(ValueError):
                linear_tnn(a_t, w, tile_width, split)
            return
        run, exact = (lambda: linear_tnn(a_t, w, tile_width, split)), a.float() @ w.float()
    elif layout == "a @ w":
        w = _rand(gen, k, n, scale=k ** -0.5)
        if n % 8:
            with pytest.raises(ValueError):
                linear_nn(a, w, tile_width, split)
            return
        run, exact = (lambda: linear_nn(a, w, tile_width, split)), a.float() @ w.float()
    else:
        w = _rand(gen, n, k, scale=k ** -0.5)
        run, exact = (lambda: linear_tn(a, w, tile_width, split)), a.float() @ w.float().t()
    out = run()
    assert out.shape == (m, n)
    assert _rel(out, exact) <= 1e-2
    assert torch.equal(out, run())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cfg_sampler_kernel_matches_plain(device, dtype):
    """Explicit noise: ids equal where the top-2 scores are more than 1e-3
    apart; sel to rel 1e-4."""
    gen = torch.Generator().manual_seed(0)
    logits = (torch.randn(4, 64, 8256, generator=gen) * 2).to(device, dtype)
    noise = -torch.log(-torch.log(torch.rand(2, 64, 8256, generator=gen).clamp_min(1e-30)))
    noise = noise.to(device)
    ids, sel = kernels.fused_categorical_cfg(logits, 7.5, 8192, gumbel=noise)
    ref_ids, ref_sel = fused_categorical_cfg_plain(logits, 7.5, 8192, noise)
    x = logits[..., :8192].float()
    top2 = torch.topk(x[2:] + 7.5 * (x[:2] - x[2:]) + noise[..., :8192], 2, -1).values
    clear = top2[..., 0] - top2[..., 1] > 1e-3
    assert bool(((ids == ref_ids) | ~clear).all())
    assert _rel(sel, ref_sel) <= 1e-4
    assert bool((ids < 8192).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sampler_kernel_matches_plain(device, dtype):
    """The CFG-free sampler on raw (1, 256, 8256) logits cropped to 8192,
    explicit noise: ids exactly equal (the same fp32 score x + g on both
    sides), sel to rel 1e-5 (logsumexp summation order); the launch
    counted."""
    gen = torch.Generator().manual_seed(1)
    logits = (torch.randn(1, 256, 8256, generator=gen) * 2).to(device, dtype)
    noise = -torch.log(-torch.log(torch.rand(1, 256, 8192, generator=gen).clamp_min(1e-30)))
    noise = noise.to(device)
    before = kernels.fused_categorical.launches
    ids, sel = kernels.fused_categorical(logits, 8192, gumbel=noise)
    assert kernels.fused_categorical.launches == before + 1
    ref_ids, ref_sel = fused_categorical_plain(logits, 8192, noise)
    assert torch.equal(ids, ref_ids)
    assert _rel(sel, ref_sel) <= 1e-5
    seeded = kernels.fused_categorical(logits, 8192, generator=torch.Generator().manual_seed(2))
    again = kernels.fused_categorical(logits, 8192, generator=torch.Generator().manual_seed(2))
    assert torch.equal(seeded[0], again[0]) and bool((seeded[0] < 8192).all())


def _sampler_logits(gen, cfg, rows, v_raw, dtype):
    return (torch.randn(2 * rows if cfg else rows, v_raw, generator=gen) * 2)[None].to(
        "cuda", dtype)


def _check_sampler(logits, cfg, vocab, noise, ids, sel, sel_tol):
    """ids equal to the plain version's on ``noise`` wherever the top-2
    scores are more than 1e-3 apart, sel to rel ``sel_tol``."""
    x = logits[..., :vocab].float()
    if cfg:
        half = x.shape[1] // 2
        ref_ids, ref_sel = fused_categorical_cfg_plain(logits.reshape(2, half, -1), 7.5, vocab,
                                                       noise[None])
        x = x[:, half:] + 7.5 * (x[:, :half] - x[:, half:])
    else:
        ref_ids, ref_sel = fused_categorical_plain(logits, vocab, noise[None])
    top2 = torch.topk(x + noise[None, :, :vocab], 2, -1).values
    clear = top2[..., 0] - top2[..., 1] > 1e-3
    assert bool(((ids.reshape(ref_ids.shape) == ref_ids) | ~clear).all())
    assert _rel(sel.reshape(ref_sel.shape), ref_sel) <= sel_tol
    assert bool((ids < vocab).all())


@pytest.mark.parametrize("cfg", [True, False])
def test_sampler_philox_route_matches_plain_philox(device, cfg):
    """The route the decode runs, at the serving shape ((2 x) 256 rows of
    8256 bf16 logits cropped to 8192): the kernel's ids with a seeded
    generator against the plain version fed ``philox_gumbel_plain`` for the
    seed the wrapper draws from the same generator state -- equal wherever
    the top-2 gap exceeds 1e-3 (the two sides' logs may differ by an ulp);
    sel to rel 1e-4."""
    logits = _sampler_logits(torch.Generator().manual_seed(5), cfg, 256, 8256, torch.bfloat16)
    noise = philox_gumbel_plain(draw_seed(torch.Generator().manual_seed(9)), 256, 8192,
                                device=device)
    gen = torch.Generator().manual_seed(9)
    if cfg:
        ids, sel = kernels.fused_categorical_cfg(logits.reshape(2, 256, -1), 7.5, 8192,
                                                 generator=gen)
    else:
        ids, sel = kernels.fused_categorical(logits, 8192, generator=gen)
    _check_sampler(logits, cfg, 8192, noise, ids, sel, 1e-4)


@pytest.mark.parametrize("cfg,v_raw,vocab,dtype", [(True, 20, 16, torch.bfloat16),
                                                   (False, 20, 16, torch.bfloat16),
                                                   (False, 21, 19, torch.float32)])
def test_sampler_unaligned_rows(device, cfg, v_raw, vocab, dtype):
    """Rows whose pitch is not 16 bytes (the chi-square checks' 20 bf16
    columns, 21 fp32), explicit noise of the same ragged width: ids as the
    plain version's (exactly, CFG-free: the same fp32 score), sel to rel
    1e-5."""
    gen = torch.Generator().manual_seed(v_raw)
    logits = _sampler_logits(gen, cfg, 512, v_raw, dtype)
    noise = -torch.log(-torch.log(torch.rand(512, v_raw, generator=gen).clamp_min(1e-30)))
    noise = noise.to(device)
    if cfg:
        ids, sel = kernels.fused_categorical_cfg(logits.reshape(2, 512, -1), 7.5, vocab,
                                                 gumbel=noise[None])
    else:
        ids, sel = kernels.fused_categorical(logits, vocab, gumbel=noise[None])
        assert torch.equal(ids, fused_categorical_plain(logits, vocab, noise[None])[0])
    _check_sampler(logits, cfg, vocab, noise, ids, sel, 1e-5)


@pytest.mark.parametrize("n,c,k", [(256, 256, 8192), (300, 37, 1001), (5, 7, 131)])
def test_vq_split_kernel_matches_plain(device, n, c, k):
    """The split pass bit-equal to ``vq_split_plain``: round-to-nearest casts
    and exact fp32 subtractions, zeros past C and past K."""
    gen = torch.Generator().manual_seed(n)
    z = torch.randn(n, c, generator=gen).to(device)
    cb = torch.randn(k, c, generator=gen).to(device)
    for got, want in zip(vq_split(z, cb), vq_split_plain(z, cb)):
        assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("n,c,k", [(256, 256, 8192), (1000, 100, 3000), (5, 7, 130),
                                   (512, 256, 8191), (300, 37, 1000), (4096, 4, 16384),
                                   (2000, 4, 8192), (2048, 256, 1024)])
def test_vq_argmin_kernel_matches_plain(device, n, c, k):
    """fp32, TF32 off: ids equal except at rows whose two best plain scores
    lie within 1e-5 of the squared distances' scale (the split product's
    roundings and summation order), where the kernel's pick is within that
    of the minimum; two calls bit-equal; ragged rows, an odd codebook, C
    not a multiple of 8, the MOVQ / Paella latents' C 4, and the VQGAN
    trainer's batch of 8 x 16 x 16 latents against its 1024 codes."""
    gen = torch.Generator().manual_seed(n)
    z = torch.randn(n, c, generator=gen).to(device)
    cb = torch.randn(k, c, generator=gen).to(device)
    before = kernels.vq_argmin.launches
    ids = kernels.vq_argmin(z, cb)
    assert kernels.vq_argmin.launches == before + 1
    assert torch.equal(ids, kernels.vq_argmin(z, cb))
    ref = vq_argmin_plain(z, cb)
    near, _, pick_gap = vq_near_ties(ids, z, cb)
    assert bool(((ids == ref) | near).all())
    assert bool((pick_gap[ids != ref] <= 0).all())


# -- backward kernels ------------------------------------------------------------

def _sublayer_bwd_inputs(gen, b, s, d, kv_len):
    return dict(x=_rand(gen, b, s, d), res=_rand(gen, b, s, d), ln=1 + _rand(gen, d, scale=0.1),
                adaln=_rand(gen, b, 2 * d, scale=0.1), wqkv=_rand(gen, 3 * d, d, scale=d ** -0.5),
                wq=_rand(gen, d, d, scale=d ** -0.5), wout=_rand(gen, d, d, scale=d ** -0.5),
                kv=_rand(gen, b, kv_len, 2 * d), g_out=_rand(gen, b, s, d, scale=0.1),
                g_res=_rand(gen, b, s, d, scale=0.1))


# bf16 on both sides with roundings in different places (the kernel keeps
# dh, logits and softmax statistics in fp32 where the plain version rounds
# its einsum outputs to bf16): max |error| over max |reference|
BWD_TOL = 5e-2


@pytest.mark.parametrize("b,s,kv_len", [(4, 256, 77), (16, 256, 77), (1, 1024, 77),
                                        (2, 100, 130)])
def test_sublayer_backward_kernels_match_plain(device, b, s, kv_len):
    """The training batch (16 x 256), the 512px config's 1024 tokens (over
    the forward attention's one-pass capacity of 288 keys: the backward
    streams its key and query tiles at any length), ragged query and key
    tiles (100 rows, 130 keys); every output against the plain backward, and
    two calls bit-equal."""
    gen = torch.Generator().manual_seed(s)
    d, h = 1024, 16
    p = _sublayer_bwd_inputs(gen, b, s, d, kv_len)
    for res in (p["res"], None):
        rr = torch.zeros_like(p["x"]) if res is None else res
        args = (p["x"], res, p["ln"], p["adaln"], p["wqkv"], p["wout"], p["g_out"], p["g_res"], h)
        before = kernels.attn_sublayer_self_bwd.launches
        got = kernels.attn_sublayer_self_bwd(*args)
        assert kernels.attn_sublayer_self_bwd.launches == before + 1
        again = kernels.attn_sublayer_self_bwd(*args)
        ref = A.attn_sublayer_self_bwd_plain(p["x"], rr, *args[2:])
        for name, mine, want, twice in zip(("dx", "dres", "dln", "dadaln", "dwqkv", "dwout"),
                                           got, ref, again):
            assert _rel(mine, want) <= BWD_TOL, (name, _rel(mine, want))
            assert torch.equal(mine, twice), name
        args = (p["x"], res, p["ln"], p["adaln"], p["wq"], p["wout"], p["kv"], p["g_out"],
                p["g_res"], h)
        got = kernels.attn_sublayer_cross_bwd(*args)
        again = kernels.attn_sublayer_cross_bwd(*args)
        ref = A.attn_sublayer_cross_bwd_plain(p["x"], rr, *args[2:])
        for name, mine, want, twice in zip(("dx", "dres", "dln", "dadaln", "dwq", "dwout", "dkv"),
                                           got, ref, again):
            assert _rel(mine, want) <= BWD_TOL, (name, _rel(mine, want))
            assert torch.equal(mine, twice), name


@pytest.mark.parametrize("m,k,n", [(4096, 2816, 1024), (512, 2816, 1024), (300, 2816, 1024),
                                   (100, 96, 136)])
def test_glu_backward_kernel_matches_plain(device, m, k, n):
    """The training and serving rows, a ragged M (300: not a multiple of the
    GEMMs' 128-row tiles, nor of 8, the sum of the dwo product running over
    a ragged K) and ragged N and K tiles; every output against the plain
    backward, and two calls bit-equal."""
    gen = torch.Generator().manual_seed(m)
    a, b = _rand(gen, m, k), _rand(gen, m, k)
    wo, g = _rand(gen, n, k, scale=k ** -0.5), _rand(gen, m, n, scale=0.1)
    got = kernels.glu_down_matmul_bwd(a, b, wo, g)
    again = kernels.glu_down_matmul_bwd(a, b, wo, g)
    ref = glu_down_matmul_bwd_plain(a, b, wo, g)
    for name, mine, want, twice in zip(("da", "db", "dwo"), got, ref, again):
        assert _rel(mine, want) <= BWD_TOL, (name, _rel(mine, want))
        assert torch.equal(mine, twice), name


def _small_v2(device):
    """Two trunk layers and one down / up block pair, heads of 64 in the
    trunk and in the attention blocks (the sublayer and attention kernels'
    head width), fp32 weights."""
    from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2

    return MaskGiTUViT_v2(hidden_size=128, cond_embed_dim=32, micro_cond_encode_dim=8,
                          micro_cond_embed_dim=40, encoder_hidden_size=48, vocab_size=68,
                          codebook_size=64, in_channels=32, block_out_channels=(128,),
                          num_res_blocks=1, block_num_heads=2, num_hidden_layers=2,
                          num_attention_heads=2, intermediate_size=256).to(device)


def test_training_backward_reaches_every_parameter(device):
    """Regression for the graph cut: a requires_grad forward through the
    kernels under bf16 autocast gives every parameter of a small model a
    finite, non-zero gradient, and runs every backward kernel.  The norm and
    attention kernels launch in the forward (the trunk's GLU pre-norm again
    in the checkpointed recompute) and take the plain versions' gradients."""
    torch.manual_seed(0)
    model = _small_v2(device)
    model.set_gradient_checkpointing(True)
    gen = torch.Generator(device=device).manual_seed(0)
    ids = torch.randint(0, 64, (2, 16), generator=gen, device=device)
    labels = torch.where(torch.rand(2, 16, generator=gen, device=device) < 0.5, ids, -100)
    kernels.reset_launch_counts()
    with torch.autocast("cuda", torch.bfloat16):
        _, loss = model(ids, torch.randn(2, 7, 48, device=device), torch.randn(2, 32, device=device),
                        torch.tensor([[512, 512, 0, 0, 6.0]] * 2, device=device), labels=labels)
    loss.backward()
    counts = kernels.launch_counts()
    for name in ("attn_sublayer_self", "attn_sublayer_cross", "glu_down_matmul"):
        assert counts[name] == 4 and counts[name + "_bwd"] == 2, counts
    # the blocks' two attentions twice, their three RMSNorms twice, the embed,
    # projection, head and text-projection RMSNorms; the GLU pre-norms twice
    assert counts["flash_attention"] == 4, counts
    assert counts["fused_residual_rmsnorm"] == 11, counts
    assert counts["fused_residual_layernorm"] == 4, counts
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()) and bool(p.grad.abs().sum() > 0), name


# -- fused norms and flash attention ------------------------------------------

# bf16 on both sides with the same roundings (one cast at the end of fp32
# arithmetic, or the model staging's op by op): the kernels and the plain
# versions differ by the order of their sums, at most about one bf16
# rounding of the output
NORM_TOL, ATTN_TOL = 1e-2, 2e-2


@pytest.mark.parametrize("staging", ["pallas", "model"])
@pytest.mark.parametrize("shape,with_residual", [((1, 257, 768), True), ((2, 256, 768), True),
                                                 ((2, 256, 1024), True), ((1, 257, 3072), False),
                                                 ((64 * 257, 3072), False), ((3, 37, 100), True)])
def test_fused_norm_kernels_match_plain(device, shape, with_residual, staging):
    """Both kernels in both stagings (the Pallas kernels': fp32 affine, one
    cast; the JAX model's: rounded op for op) at the paths' shapes (widths
    768, 1024, 3072: the row in registers) and at a width of the generic
    variant (100, not a multiple of 8), LayerNorm with and without a bias;
    the class trainer's mid-MLP norm at batch 64 (64 x 257 rows of 3072);
    the prenorm sum bit-equal (x itself without a residual), two calls
    bit-equal, one launch each."""
    from open_muse_tpu_torch.kernels import fused_norm as N

    model = staging == "model"
    rms_plain = N.fused_residual_rmsnorm_model_plain if model else N.fused_residual_rmsnorm_plain
    ln_plain = (N.fused_residual_layernorm_model_plain if model
                else N.fused_residual_layernorm_plain)
    gen = torch.Generator().manual_seed(shape[-1])
    x = _rand(gen, *shape, scale=2.0)
    res = _rand(gen, *shape) if with_residual else None
    scale, bias = 1 + _rand(gen, shape[-1], scale=0.1), _rand(gen, shape[-1], scale=0.1)
    cases = {
        "rms": (lambda: kernels.fused_residual_rmsnorm(x, res, scale, staging=staging),
                lambda: rms_plain(x, res, scale), kernels.fused_residual_rmsnorm),
        "ln": (lambda: kernels.fused_residual_layernorm(x, res, scale, bias, staging=staging),
               lambda: ln_plain(x, res, scale, bias), kernels.fused_residual_layernorm),
        "ln_nobias": (lambda: kernels.fused_residual_layernorm(x, res, scale, None,
                                                               staging=staging),
                      lambda: ln_plain(x, res, scale, None), kernels.fused_residual_layernorm),
    }
    for name, (kern, plain, wrapper) in cases.items():
        before = wrapper.launches
        out, pre = kern()
        assert wrapper.launches == before + 1, name
        ref, ref_pre = plain()
        assert _rel(out, ref) <= NORM_TOL, (name, _rel(out, ref))
        assert torch.equal(pre, ref_pre), name
        assert (pre is x) == (res is None), name
        assert torch.equal(out, kern()[0]), name


@pytest.mark.parametrize("q_shape,kv_len", [((1, 257, 16, 48), 257), ((2, 256, 12, 64), 77),
                                            ((2, 256, 12, 64), 256), ((16, 256, 12, 64), 77),
                                            ((1, 1025, 16, 64), 1025), ((2, 1024, 16, 64), 1024),
                                            ((2, 1024, 16, 64), 77), ((64, 257, 16, 48), 257),
                                            ((64, 256, 16, 64), 256), ((64, 256, 16, 64), 32)])
def test_flash_attention_kernel_matches_plain(device, q_shape, kv_len):
    """v1's self-attention (ragged 257 x 257, head_dim 48: the one-pass
    variant with two warps a row group), v2's block attention over the 77
    text keys (head_dim 64: one warp a row group) when serving and at the
    training batch, 256 keys at head_dim 64 (two warps a row group), and
    1025 and 1024 keys, above the one-pass capacity of 288: the two-pass
    variant (the MOVQ configs' class and CFG text trunks), counted apart;
    the text trunk's cross-attention over 77 T5 keys; the v1 trainers'
    batch 64: the class model's self-attention, the text model's
    self-attention and its cross-attention over 32 text keys.  The inputs
    as views into fused [q | k | v] / [k | v] projections; two calls
    bit-equal."""
    from open_muse_tpu_torch.kernels.flash_attention import flash_attention_plain

    gen = torch.Generator().manual_seed(kv_len)
    b, tq, h, d = q_shape
    if tq == kv_len:
        q, k, v = _rand(gen, b, tq, 3 * h * d).reshape(b, tq, 3 * h, d).chunk(3, dim=2)
    else:
        q = _rand(gen, b, tq, h, d)
        k, v = _rand(gen, b, kv_len, 2 * h * d).reshape(b, kv_len, 2 * h, d).chunk(2, dim=2)
    before = kernels.launch_counts()
    out = kernels.flash_attention(q, k, v)
    after = kernels.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert (after["flash_attention_two_pass"] - before["flash_attention_two_pass"]
            == int(kv_len > 288))
    ref = flash_attention_plain(q, k, v)
    assert out.shape == q_shape and _rel(out, ref) <= ATTN_TOL, _rel(out, ref)
    assert torch.equal(out, kernels.flash_attention(q, k, v))


@pytest.mark.parametrize("q_shape,kv_len", [((2, 257, 16, 64), 257), ((32, 257, 16, 64), 257),
                                            ((30, 17, 4, 16), 17), ((32, 65, 4, 16), 65),
                                            ((16, 64, 4, 16), 64), ((16, 64, 4, 16), 8),
                                            ((32, 256, 2, 32), 256), ((32, 256, 2, 32), 8),
                                            ((2, 1024, 4, 16), 1024), ((2, 300, 2, 32), 300)])
def test_flash_attention_eval_head_dims_match_plain(device, q_shape, kv_len):
    """The eval stacks' shapes: CLIP ViT-L/14's vision tower (257 tokens at
    head dim 64, batch 2 and 32); head dim 16 (one k step in QK^T, two n8
    tiles in PV): the seeded CLIP towers (17 and 65 tokens), the quality
    trunk's self- and cross-attention; head dim 32: the mid-scale trunk's
    blocks; and both at the two-pass variant's key counts.  Each against
    flash_attention_plain (rel ATTN_TOL), one launch counted at its head dim,
    two calls bit-equal."""
    from open_muse_tpu_torch.kernels.flash_attention import flash_attention_plain

    gen = torch.Generator().manual_seed(kv_len + q_shape[-1])
    b, tq, h, d = q_shape
    if tq == kv_len:
        q, k, v = _rand(gen, b, tq, 3 * h * d).reshape(b, tq, 3 * h, d).chunk(3, dim=2)
    else:
        q = _rand(gen, b, tq, h, d)
        k, v = _rand(gen, b, kv_len, 2 * h * d).reshape(b, kv_len, 2 * h, d).chunk(2, dim=2)
    kernels.reset_launch_counts()
    out = kernels.flash_attention(q, k, v)
    assert kernels.flash_attention.launches == 1
    assert dict(kernels.flash_attention.by_head_dim) == {d: 1}
    assert kernels.flash_attention_two_pass.launches == int(kv_len > 288)
    ref = flash_attention_plain(q, k, v)
    assert out.shape == q_shape and _rel(out, ref) <= ATTN_TOL, _rel(out, ref)
    assert torch.equal(out, kernels.flash_attention(q, k, v))


def test_norm_and_attention_wrappers_raise_on_inputs_they_do_not_take(device):
    gen = torch.Generator().manual_seed(3)
    x, scale = _rand(gen, 4, 64), 1 + _rand(gen, 64, scale=0.1)
    with pytest.raises(ValueError):  # not contiguous
        kernels.fused_residual_rmsnorm(x.t().contiguous().t(), None, scale)
    with pytest.raises(TypeError):  # float64
        kernels.fused_residual_layernorm(x.double(), None, scale.double(), None)
    with pytest.raises(TypeError):  # scale of another type than x
        kernels.fused_residual_rmsnorm(x, None, scale.float())
    q = _rand(gen, 1, 8, 2, 48)
    with pytest.raises(TypeError):  # fp32
        kernels.flash_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError):  # heads not D apart
        kernels.flash_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    odd = _rand(gen, 1, 8, 2, 40)
    with pytest.raises(ValueError):  # head_dim not a kernel instantiation
        kernels.flash_attention(odd, odd, odd)


def test_norm_and_attention_kernels_launch_under_autograd(device):
    """Inputs that require grad launch the kernels once each; the backward
    gives the plain versions' gradients (bf16 inputs, fp32 arithmetic on
    both sides: ATTN_TOL)."""
    from open_muse_tpu_torch.kernels.flash_attention import flash_attention_plain
    from open_muse_tpu_torch.kernels.fused_norm import (fused_residual_layernorm_plain,
                                                        fused_residual_rmsnorm_plain)

    gen = torch.Generator().manual_seed(4)
    x0, r0 = _rand(gen, 2, 16, 64), _rand(gen, 2, 16, 64)
    s0, q0 = 1 + _rand(gen, 64, scale=0.1), _rand(gen, 1, 16, 2, 64)

    def run(rms, ln, attn):
        x, r, s, q = (t.clone().requires_grad_() for t in (x0, r0, s0, q0))
        out, _ = rms(x, None, s)
        out2, pre = ln(x, r, s)
        att = attn(q, q, q)
        (out.float().sum() + out2.float().square().sum() + pre.float().sum()
         + att.float().square().sum()).backward()
        return x.grad, r.grad, s.grad, q.grad

    kernels.reset_launch_counts()
    got = run(kernels.fused_residual_rmsnorm,
              lambda x, r, s: kernels.fused_residual_layernorm(x, r, s, None),
              kernels.flash_attention)
    counts = kernels.launch_counts()
    assert {k: n for k, n in counts.items() if n} == {
        "fused_residual_rmsnorm": 1, "fused_residual_layernorm": 1, "flash_attention": 1}
    want = run(fused_residual_rmsnorm_plain,
               lambda x, r, s: fused_residual_layernorm_plain(x, r, s, None),
               flash_attention_plain)
    for name, g, w in zip(("dx", "dres", "dscale", "dq"), got, want):
        assert _rel(g, w) <= ATTN_TOL, (name, _rel(g, w))


def test_v2_forward_under_autocast_runs_every_forward_kernel(device):
    """A no-grad forward of an fp32 model under bf16 autocast: the wrappers
    cast their inputs to bf16 and launch; logits finite and within the
    bf16 forward tolerance of the use_kernels=False forward."""
    torch.manual_seed(1)
    model = _small_v2(device).eval()
    gen = torch.Generator(device=device).manual_seed(1)
    ids = torch.randint(0, 64, (2, 16), generator=gen, device=device)
    args = (ids, torch.randn(2, 7, 48, device=device), torch.randn(2, 32, device=device),
            torch.tensor([[512, 512, 0, 0, 6.0]] * 2, device=device))
    kernels.reset_launch_counts()
    with torch.no_grad(), torch.autocast("cuda", torch.bfloat16):
        fused = model(*args)
        counts = kernels.launch_counts()
        plain = model(*args, use_kernels=False)
    assert counts["flash_attention"] == 4 and counts["fused_residual_rmsnorm"] == 11, counts
    assert counts["fused_residual_layernorm"] == 2 and counts["glu_down_matmul"] == 2, counts
    assert bool(torch.isfinite(fused).all()) and _rel(fused, plain) <= 5e-2


# -- captured CUDA graphs: the decodes and requests, one graph each ----------

def _bf16_v2(device, seed=0):
    torch.manual_seed(seed)
    return _small_v2(device).to(torch.bfloat16).eval()


def _bf16_v1(device, seed=0):
    """Two layers, two heads of 64, 64 codes, 16 image tokens after the
    class token, 4 classes."""
    from open_muse_tpu_torch.models.transformer_v1 import MaskGitTransformer

    torch.manual_seed(seed)
    return MaskGitTransformer(vocab_size=69, hidden_size=128, num_hidden_layers=2,
                              num_attention_heads=2, intermediate_size=256, codebook_size=64,
                              num_vq_tokens=16, max_position_embeddings=17, num_classes=4,
                              hidden_dropout=0.0, attention_dropout=0.0).to(
                                  device, torch.bfloat16).eval()


def _v2_inputs(device, batch=1):
    gen = torch.Generator().manual_seed(3)
    return (torch.randn(batch, 7, 48, generator=gen).to(device, torch.bfloat16),
            torch.randn(batch, 32, generator=gen).to(device, torch.bfloat16),
            torch.tensor([[512, 512, 0, 0, 6.0]] * batch, device=device))


def _counted(fn):
    """(fn()'s result, the wrappers' launch counts it added)."""
    before = kernels.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.parametrize("guidance", [3.0, 0.0])
def test_captured_v2_decode_equals_eager_loop(device, guidance):
    """generate2 through its graph (captured on the first call, replayed
    after) against the decode loop called directly, noise drawn from the
    same generator seed: token ids equal, all of them, for two seeds; each
    replay adds exactly the eager loop's launches."""
    from open_muse_tpu_torch.models.transformer_v2 import (decode_noise, decode_schedules,
                                                            parallel_decode_loop)

    model = _bf16_v2(device)
    ehs, cond, micro = _v2_inputs(device)
    steps, seq = 4, 16
    args = dict(temperature=(2, 0), timesteps=steps, guidance_scale=guidance, seq_len=seq)
    empty = dict(empty_embeds=torch.zeros_like(ehs), empty_cond_embeds=torch.zeros_like(cond))

    def eager(seed):
        temps, scales, ratios = decode_schedules(steps, (2, 0), guidance)
        kind, sample, mask = decode_noise(torch.Generator().manual_seed(seed), timesteps=steps,
                                          batch=1, seq_len=seq, vocab=64, device=device)
        start = torch.full((1, seq), model.config.mask_token_id, device=device)
        if guidance:
            inputs = (torch.cat([ehs, empty["empty_embeds"]]),
                      torch.cat([cond, empty["empty_cond_embeds"]]), torch.cat([micro, micro]))
        else:
            inputs = (ehs, cond, micro)
        return parallel_decode_loop(model, start, *inputs, temps.to(device), scales.tolist(),
                                    ratios.to(device), use_cfg=guidance > 0, seq_len=seq,
                                    timesteps=steps, mask_gumbel=mask, **{kind: sample})

    model.generate2(ehs, cond, micro, generator=torch.Generator().manual_seed(0), **empty,
                    **args)  # the capture
    for seed in (1, 2):
        want, eager_launches = _counted(lambda: eager(seed))
        got, graph_launches = _counted(lambda: model.generate2(
            ehs, cond, micro, generator=torch.Generator().manual_seed(seed), **empty, **args))
        assert torch.equal(got, want), seed
        assert graph_launches == eager_launches and eager_launches, (graph_launches,
                                                                     eager_launches)


def test_captured_v1_decodes_equal_eager_loops(device):
    """v1 generate2 (class ids, the CFG-free sampler) and generate (top-k)
    through their graphs against their loops called directly: token ids
    equal, launches exact after replays."""
    from open_muse_tpu_torch.models.transformer_v1 import (masked_counts, v1_decode_loop,
                                                            v1_generate_loop, v1_schedules)
    from open_muse_tpu_torch.models.transformer_v2 import decode_noise
    from open_muse_tpu_torch.kernels.fused_sample import sample_gumbel

    model = _bf16_v1(device)
    classes = torch.tensor([1, 3], device=device)
    start = torch.full((2, 16), model.config.mask_token_id, device=device)
    temps, ratios = v1_schedules(5, (2, 0))
    for seed in (0, 1, 2):
        kind, sample, mask = decode_noise(torch.Generator().manual_seed(seed), timesteps=5,
                                          batch=2, seq_len=16, vocab=64, device=device)
        want, eager_launches = _counted(lambda: v1_decode_loop(
            model, start, classes + 64, None, temps.to(device), ratios.to(device),
            guidance_scale=None, timesteps=5, mask_gumbel=mask, **{kind: sample}))
        got, graph_launches = _counted(lambda: model.generate2(
            class_ids=classes, temperature=(2, 0), timesteps=5,
            generator=torch.Generator().manual_seed(seed)))
        assert torch.equal(got, want), seed
        if seed:
            assert graph_launches == eager_launches, (graph_launches, eager_launches)
        gen = torch.Generator().manual_seed(seed)
        gumbel = torch.stack([sample_gumbel((2, 16, 64), gen) for _ in range(4)]).to(device)
        want = v1_generate_loop(model, start, classes + 64, None, gumbel, guidance_scale=None,
                                topk_filter_thres=0.9, temperature=4.5,
                                counts=masked_counts(4, 16))
        got = model.generate(class_ids=classes, temperature=4.5, timesteps=4, noise=gumbel)
        assert torch.equal(got, want), seed


@pytest.mark.parametrize("cfg", [True, False])
def test_sampler_seed_from_device_memory(device, cfg):
    """The seed read from an int64 device tensor (the route every decode
    takes): ids as the plain version fed ``philox_gumbel_plain`` for that
    seed where the top-2 gap exceeds 1e-3, sel to rel 1e-4; inside a
    captured graph, a seed buffer refilled before the replay gives the
    second seed's draw, not the first's."""
    logits = _sampler_logits(torch.Generator().manual_seed(5), cfg, 256, 8256, torch.bfloat16)
    x = logits.reshape(2, 256, -1) if cfg else logits
    sample = ((lambda seed: kernels.fused_categorical_cfg(x, 7.5, 8192, seed=seed)) if cfg else
              (lambda seed: kernels.fused_categorical(x, 8192, seed=seed)))
    seeds = [draw_seed(torch.Generator().manual_seed(s)) for s in (9, 10)]
    buffer = torch.tensor([seeds[0]], device=device)
    for s in seeds:
        noise = philox_gumbel_plain(s, 256, 8192, device=device)
        ids, sel = sample(torch.tensor([s], device=device))
        _check_sampler(logits, cfg, 8192, noise, ids, sel, 1e-4)
    sample(buffer)  # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ids, sel = sample(buffer)
    buffer.fill_(seeds[1])
    graph.replay()
    torch.cuda.synchronize()
    want = sample(torch.tensor([seeds[1]], device=device))
    assert torch.equal(ids, want[0]) and torch.equal(sel, want[1])


def test_captured_helper_replays_raises_and_recaptures(device):
    """``core.captured``: outputs are clones (a later replay leaves them
    alone), a moved model captures afresh, and a body that cannot be
    captured (a host read of a device value) raises instead of running
    eagerly in its place."""
    from open_muse_tpu_torch.core.captured import captured, graph_count

    owner = torch.nn.Linear(8, 8).to(device).requires_grad_(False)
    double = lambda x: owner(x) * 2  # noqa: E731
    a = captured(owner, ("double",), double, torch.ones(2, 8, device=device), modules=(owner,))
    b = captured(owner, ("double",), double, torch.zeros(2, 8, device=device), modules=(owner,))
    assert torch.equal(a, owner(torch.ones(2, 8, device=device)) * 2)
    assert torch.equal(b, owner(torch.zeros(2, 8, device=device)) * 2)
    assert graph_count(owner) == 1
    owner.weight = torch.nn.Parameter(owner.weight.clone(), requires_grad=False)  # new pointer
    c = captured(owner, ("double",), double, torch.ones(2, 8, device=device), modules=(owner,))
    assert torch.equal(c, a) and graph_count(owner) == 1
    # a capture that fails leaves torch's CUDA generator in its capture
    # state, so this part runs in a process of its own
    script = ("import torch\n"
              "from open_muse_tpu_torch.core.captured import captured\n"
              "owner = torch.nn.Linear(1, 1)\n"
              "try:\n"
              "    captured(owner, ('host read',), lambda x: x * float(x.sum()),\n"
              "             torch.ones(2, 8, device='cuda'))\n"
              "except RuntimeError as exc:\n"
              "    print('raised', 'capture' in str(exc))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.stdout.strip() == "raised True", (out.stdout, out.stderr[-2000:])


def test_compiled_text2image_replays_equal_fresh_eager_calls(device):
    """One ``compile_text2image`` function called with two prompts in turn
    (a bf16 tiny U-ViT and text tower, an fp32 tiny VQGAN): each reply's
    images and tokens equal the same request run eagerly (``fn.eager``), so
    nothing aliases a static buffer; launch counts exact."""
    from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder, SimpleTokenizer
    from open_muse_tpu_torch.models.taming_vqgan import VQGANModel
    from open_muse_tpu_torch.pipelines.pipeline_muse import PipelineMuse

    torch.manual_seed(4)
    with torch.device(device):
        text = CLIPTextEncoder(vocab_size=100, hidden_size=48, intermediate_size=96,
                               num_hidden_layers=2, num_attention_heads=4,
                               max_position_embeddings=16, projection_dim=32, eos_token_id=99)
        vae = VQGANModel(resolution=32, hidden_channels=32, channel_mult=(1, 2),
                         num_res_blocks=2, attn_resolutions=(16,), z_channels=16,
                         num_embeddings=64, quantized_embed_dim=16)
    pipe = PipelineMuse(vae=vae.eval(), transformer=_bf16_v2(device),
                        text_encoder=text.to(torch.bfloat16).eval(),
                        tokenizer=SimpleTokenizer(100, 16))
    fn = pipe.compile_text2image(batch_size=1, timesteps=3, guidance_scale=2.0, seq_len=16)
    micro = torch.tensor([[512, 512, 0, 0, 6.0]])
    replies = []
    for i, prompt in enumerate(("a red fox", "two cubes", "a red fox")):
        ids = torch.as_tensor(pipe.tokenizer([prompt])["input_ids"]).long()
        got, launches = _counted(lambda: fn(ids, micro, torch.Generator().manual_seed(i),
                                            return_tokens=True))
        replies.append(got)
        want, eager_launches = _counted(lambda: fn.eager(
            ids, micro, torch.Generator().manual_seed(i), return_tokens=True))
        # tokens equal; images to 1e-5 of their range (the same fp32 VQGAN decode,
        # cuDNN free to pick its algorithm in the capture)
        assert torch.equal(got[1], want[1]), i
        assert _rel(got[0], want[0]) <= 1e-5, i
        if i:
            assert launches == eager_launches, (launches, eager_launches)
    assert not torch.equal(replies[0][1], replies[1][1])
    assert replies[0][0].shape == (1, 8, 8, 3)


# -- the captured train step -----------------------------------------------------

def _train_state(device, accumulation_steps=1, optimizer="adamw"):
    """The small U-ViT (per-layer checkpointing) with ``optimizer`` (AdamW;
    clip 1.0, a constant lr) and an EMA, from one seed."""
    from open_muse_tpu_torch.training.ema import EMA
    from open_muse_tpu_torch.training.optimizers import get_optimizer
    from open_muse_tpu_torch.training.trainer import TrainState

    torch.manual_seed(0)
    model = _small_v2(device)
    model.set_gradient_checkpointing(True)
    return TrainState(model=model, optimizer=get_optimizer(
        optimizer, model, lambda count: 1e-3, max_grad_norm=1.0,
        accumulation_steps=accumulation_steps), ema=EMA(model))


def _train_batch(device, b=4):
    gen = torch.Generator(device=device).manual_seed(1)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=device)  # noqa: E731
    return {"image_tokens": torch.randint(0, 64, (b, 16), generator=gen, device=device),
            "encoder_hidden_states": randn(b, 7, 48), "cond_embeds": randn(b, 32),
            "micro_conds": torch.tensor([[512, 512, 0, 0, 6.0]] * b, device=device),
            "empty_embeds": randn(1, 7, 48), "empty_cond_embeds": randn(1, 32)}


def _train_step(autocast_dtype=torch.bfloat16):
    from open_muse_tpu_torch.ops.sampling import get_mask_schedule
    from open_muse_tpu_torch.training.trainer import make_uvit_train_step

    return make_uvit_train_step(get_mask_schedule("cosine"), 67, codebook_size=64,
                                cond_dropout_prob=0.5, autocast_dtype=autocast_dtype,
                                with_diagnostics=True, with_param_grad_norms=True)


def _assert_same_state(a, b):
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(a.ema.shadow[name], b.ema.shadow[name]), name
        for key, value in a.optimizer.torch_optimizer.state[p].items():
            assert torch.equal(value, b.optimizer.torch_optimizer.state[q][key]), (name, key)
    for x, y in zip(a.optimizer.acc, b.optimizer.acc):
        assert torch.equal(x, y)


@pytest.mark.parametrize("accumulation_steps", [1, 2])
def test_captured_train_step_equals_eager(device, accumulation_steps):
    """Two copies of one seeded state, one trained through the step's
    graphs (step 1 the eager warm-up, then a capture; under accumulation
    steps 1 and 2 each warm up one graph) and one through ``step.eager``,
    with noise from generators of one seed (masking and cond dropout): every
    metric (diagnostics and per-parameter norms too), parameter, EMA shadow,
    AdamW moment and accumulator bit-equal after each of 4 steps; each
    replay adds exactly the eager step's launches."""
    from open_muse_tpu_torch.training.masking import draw_masking_noise

    step = _train_step()
    a, b = _train_state(device, accumulation_steps), _train_state(device, accumulation_steps)
    gens = [torch.Generator(device=device).manual_seed(5) for _ in range(2)]
    batch = _train_batch(device)
    for i in range(4):
        noise_a, noise_b = (draw_masking_noise(4, 16, g, 64, cond_dropout=True) for g in gens)
        got, launches = _counted(lambda: step(a, batch, noise_a))
        want, eager_launches = _counted(lambda: step.eager(b, batch, noise_b))
        assert sorted(got) == sorted(want)
        for key in want:
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, equal_nan=True,
                                       msg=f"step {i}: {key}")
        assert launches == eager_launches, (i, launches, eager_launches)
        _assert_same_state(a, b)
    assert a.step == b.step == 4 and a.optimizer.count == 4 // accumulation_steps
    assert step.last_capture["launches"] == eager_launches


@pytest.mark.parametrize("name", ["8bit_adamw", "bf16_adamw", "lion"])
def test_captured_train_step_equals_eager_other_optimizers(device, name):
    """The other optimizers inside the captured step: 3 steps of two copies
    of one seeded state, one through the graph and one through
    ``step.eager``: every metric, parameter, EMA shadow and optimizer state
    tensor (uint8 codes and absmax, the bf16 moment) bit-equal, each replay
    adding the eager step's launches."""
    from open_muse_tpu_torch.training.masking import draw_masking_noise

    step = _train_step()
    a, b = _train_state(device, optimizer=name), _train_state(device, optimizer=name)
    gens = [torch.Generator(device=device).manual_seed(6) for _ in range(2)]
    batch = _train_batch(device)
    for i in range(3):
        noise_a, noise_b = (draw_masking_noise(4, 16, g, 64, cond_dropout=True) for g in gens)
        got, launches = _counted(lambda: step(a, batch, noise_a))
        want, eager_launches = _counted(lambda: step.eager(b, batch, noise_b))
        for key in want:
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, equal_nan=True,
                                       msg=f"step {i}: {key}")
        assert launches == eager_launches, (i, launches, eager_launches)
        _assert_same_state(a, b)
    assert a.optimizer.count == 3


def test_captured_distill_step_equals_eager(device):
    """One distill step graph (a 4-step CFG teacher held in bf16, pairs of
    2, the soft KL, clip 1.0, AdamW, EMA) against ``step.eager`` on two
    copies of one student, 2 steps on the same noise (Philox seeds, mask
    Gumbel, pairs): every metric and state tensor bit-equal, each replay
    adding the eager step's launches, the teacher untouched."""
    from open_muse_tpu_torch.training import distill

    a, b = _train_state(device), _train_state(device)
    teacher = distill.frozen_teacher(a.model, torch.bfloat16)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    step = distill.make_distill_step(teacher, mask_token_id=67, teacher_timesteps=4,
                                     step_ratio=2, temperature=(2.0, 0.0), guidance_scale=3.0,
                                     seq_len=16, max_grad_norm=1.0, soft_weight=0.5,
                                     autocast_dtype=torch.bfloat16)
    batch = {k: v for k, v in _train_batch(device).items() if k != "image_tokens"}
    for i in range(2):
        noise_a, noise_b = (distill.draw_distill_noise(
            torch.Generator().manual_seed(10 + i), timesteps=4, step_ratio=2, batch=4,
            seq_len=16, codebook_size=64, device=device) for _ in range(2))
        got, launches = _counted(lambda: step(a, batch, noise_a))
        want, eager_launches = _counted(lambda: step.eager(b, batch, noise_b))
        for key in want:
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, msg=f"{i}: {key}")
        assert launches == eager_launches and launches["fused_categorical_cfg"] == 4
        _assert_same_state(a, b)
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_captured_train_step_recaptures_after_resume(device, tmp_path):
    """A state trained 2 captured steps, saved, then loaded in place:
    AdamW's state tensors are new ones, so step 3 warms up and captures
    afresh instead of replaying the old pointers, and equals step 3 of a
    fresh state loaded from the same checkpoint and run eagerly."""
    from open_muse_tpu_torch.training.masking import draw_masking_noise
    from open_muse_tpu_torch.training.trainer import load_checkpoint, save_checkpoint

    step = _train_step()
    a = _train_state(device)
    gen = torch.Generator(device=device).manual_seed(6)
    batch = _train_batch(device)
    for _ in range(2):
        step(a, batch, draw_masking_noise(4, 16, gen, 64, cond_dropout=True))
    first = step.last_capture
    path = save_checkpoint(str(tmp_path), a)
    load_checkpoint(path, a)
    b = load_checkpoint(path, _train_state(device))
    noise = draw_masking_noise(4, 16, gen, 64, cond_dropout=True)
    got = step(a, batch, noise)
    assert step.last_capture is not first and step.last_capture["emit"]
    want = step.eager(b, batch, noise)
    for key in ("loss", "grad_norm"):
        assert torch.equal(got[key], want[key]), key
    _assert_same_state(a, b)
    again = draw_masking_noise(4, 16, gen, 64, cond_dropout=True)
    got, want = step(a, batch, again), step.eager(b, batch, again)  # now a replay
    assert torch.equal(got["loss"], want["loss"])
    _assert_same_state(a, b)


def test_cpu_checkpoint_resumes_on_the_card(device, tmp_path):
    """A checkpoint of a CPU run (the plain AdamW: a float lr, step counts
    on the CPU) loads into a state on the card: its AdamW stays capturable
    with its lr tensor, the step counts move onto the card, and the next two
    steps through the graph equal two eager ones from the same checkpoint."""
    from open_muse_tpu_torch.training.masking import draw_masking_noise
    from open_muse_tpu_torch.training.trainer import load_checkpoint, save_checkpoint

    cpu = torch.device("cpu")
    trained = _train_state(cpu)  # the CPU trains in fp32
    _train_step(None)(trained, _train_batch(cpu), draw_masking_noise(
        4, 16, torch.Generator().manual_seed(2), 64, cond_dropout=True))
    step = _train_step()
    path = save_checkpoint(str(tmp_path), trained)
    a, b = (load_checkpoint(path, _train_state(device)) for _ in range(2))
    adamw = a.optimizer.torch_optimizer
    assert all(g["capturable"] and g["lr"] is a.optimizer.lr for g in adamw.param_groups)
    assert all(st["step"].device.type == "cuda" for st in adamw.state.values())
    gens = [torch.Generator(device=device).manual_seed(3) for _ in range(2)]
    batch = _train_batch(device)
    for _ in range(2):
        noise_a, noise_b = (draw_masking_noise(4, 16, g, 64, cond_dropout=True) for g in gens)
        got, want = step(a, batch, noise_a), step.eager(b, batch, noise_b)
        assert torch.equal(got["loss"], want["loss"])
        _assert_same_state(a, b)
    assert a.step == 3 and a.optimizer.count == 3


def test_train_step_capture_failure_raises(device):
    """A train step whose body reads a device value on the host cannot be
    captured: its first call (the eager warm-up) runs, then the capture
    raises, and the eager body does not run in its place.  A failed capture
    leaves torch's CUDA generator in its capture state, so this runs in a
    process of its own."""
    script = ("import torch, sys\n"
              "sys.path.insert(0, 'tests')\n"
              "from test_torch_cuda import _train_state, _train_batch, _train_step\n"
              "from open_muse_tpu_torch.training import trainer as T\n"
              "from open_muse_tpu_torch.training.masking import draw_masking_noise\n"
              "body = T.uvit_train_body\n"
              "T.uvit_train_body = lambda *a: {k: v * float(v.sum()) for k, v in "
              "body(*a).items()}\n"
              "device = torch.device('cuda')\n"
              "state, step = _train_state(device), _train_step()\n"
              "gen = torch.Generator(device=device).manual_seed(0)\n"
              "try:\n"
              "    step(state, _train_batch(device), draw_masking_noise(4, 16, gen, 64, cond_dropout=True))\n"
              "except RuntimeError as exc:\n"
              "    print('raised', 'capture' in str(exc), state.step)\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.stdout.strip() == "raised True 0", (out.stdout, out.stderr[-2000:])


def _small_v1(device, **changes):
    """A two-layer class-conditional v1 model (heads of 48, as the ImageNet
    config's), fp32 weights, with AdamW (a constant lr), no EMA."""
    from open_muse_tpu_torch.models.transformer_v1 import MaskGitTransformer
    from open_muse_tpu_torch.training.optimizers import get_optimizer
    from open_muse_tpu_torch.training.trainer import TrainState

    torch.manual_seed(0)
    with torch.device(device):
        model = MaskGitTransformer(**{**dict(vocab_size=69, hidden_size=96, num_hidden_layers=2,
                                             num_attention_heads=2, intermediate_size=192,
                                             codebook_size=64, num_vq_tokens=16,
                                             max_position_embeddings=17, num_classes=4,
                                             hidden_dropout=0.0), **changes})
    return TrainState(model=model, optimizer=get_optimizer("adamw", model, lambda count: 1e-3))


def test_captured_class_step_equals_eager_and_redraws_dropout(device):
    """The class step at dropout 0: 3 captured steps bit-equal to 3 eager
    ones (metrics, parameters, AdamW moments), each replay adding the eager
    step's launches.  At ``hidden_dropout`` 0.5 with ``KeepMasks`` on a CUDA
    generator registered with the graph: the eager warm-up and each replay
    advance the generator (a replay draws new masks); the losses finite."""
    from open_muse_tpu_torch.models.transformer_v1 import KeepMasks
    from open_muse_tpu_torch.ops.sampling import get_mask_schedule
    from open_muse_tpu_torch.training.masking import draw_masking_noise
    from open_muse_tpu_torch.training.trainer import make_maskgit_train_step

    def step_of(dropout=None):
        return make_maskgit_train_step(get_mask_schedule("cosine"), 68, codebook_size=64,
                                       autocast_dtype=torch.bfloat16, dropout=dropout)

    gen = torch.Generator(device=device).manual_seed(3)
    batch = {"image_tokens": torch.randint(0, 64, (4, 16), generator=gen, device=device),
             "class_ids": torch.randint(0, 4, (4,), generator=gen, device=device)}
    step = step_of()
    a, b = _small_v1(device), _small_v1(device)
    gens = [torch.Generator(device=device).manual_seed(5) for _ in range(2)]
    for i in range(3):
        noise_a, noise_b = (draw_masking_noise(4, 16, g, 64) for g in gens)
        got, launches = _counted(lambda: step(a, batch, noise_a))
        want, eager_launches = _counted(lambda: step.eager(b, batch, noise_b))
        for key in want:
            assert torch.equal(got[key], want[key]), (i, key)
        assert launches == eager_launches and launches["flash_attention"] == 2, launches
        for p, q in zip(a.model.parameters(), b.model.parameters()):
            assert torch.equal(p, q)
            for key, value in a.optimizer.torch_optimizer.state[p].items():
                assert torch.equal(value, b.optimizer.torch_optimizer.state[q][key])

    masks = KeepMasks(torch.Generator(device=device).manual_seed(9))
    step = step_of(masks)
    state = _small_v1(device, hidden_dropout=0.5)
    noise = draw_masking_noise(4, 16, torch.Generator(device=device).manual_seed(1), 64)
    states, losses = [masks.generator.get_state()], []
    for _ in range(3):  # the eager warm-up (and the capture), then two replays
        losses.append(float(step(state, batch, noise)["loss"]))
        states.append(masks.generator.get_state())
    assert all(not torch.equal(x, y) for x, y in zip(states, states[1:]))
    assert all(math.isfinite(v) for v in losses), losses


def test_captured_vqgan_step_equals_eager(device):
    """Two copies of one seeded MaskGIT VQGAN and PatchGAN (32 px, batch 2,
    the perceptual term, hinge loss, disc_start 1), one trained through the
    step's graph (step 1, gated, the eager warm-up and the capture; steps 2
    - 3 adversarial replays) and one through ``step.eager``, cuDNN
    deterministic: every metric, both players' parameters and AdamW
    moments bit-equal after each step; ``vq_argmin`` once a step, in the
    graph too."""
    from open_muse_tpu_torch.models.discriminator import PatchDiscriminator
    from open_muse_tpu_torch.models.maskgit_vqgan import MaskGitVQGAN
    from open_muse_tpu_torch.ops.perceptual import make_perceptual_loss_fn
    from open_muse_tpu_torch.training.optimizers import get_optimizer
    from open_muse_tpu_torch.training.trainer import TrainState, make_vqgan_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True

    def players():
        torch.manual_seed(0)
        with torch.device(device):
            vq = MaskGitVQGAN(resolution=32, hidden_channels=32, channel_mult=(1, 2),
                              num_res_blocks=1, z_channels=16, num_embeddings=64,
                              quantized_embed_dim=16)
            disc = PatchDiscriminator(base_channels=8, n_layers=2)
        return tuple(TrainState(model=m, optimizer=get_optimizer("adamw", m, lambda c: 1e-3,
                                                                 max_grad_norm=1.0))
                     for m in (vq, disc))

    try:
        with torch.device(device):
            perceptual = make_perceptual_loss_fn(0)
        step = make_vqgan_train_step(perceptual_weight=1.0, perceptual=perceptual,
                                     disc_weight=0.75, disc_start=1)
        a, b = players(), players()
        pixels = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1)).to(device)
        for i in range(3):
            got, launches = _counted(lambda: step(a, {"pixel_values": pixels}))
            want, eager_launches = _counted(lambda: step.eager(b, {"pixel_values": pixels}))
            assert sorted(got) == sorted(want)
            for key in want:
                assert torch.equal(got[key], want[key]), (i, key)
            assert launches == eager_launches and launches["vq_argmin"] == 1, launches
            assert (float(got["d_weight"]) == 0.0) == (i == 0)
            for x, y in zip(a, b):
                for p, q in zip(x.model.parameters(), y.model.parameters()):
                    assert torch.equal(p, q), i
                    for key, value in x.optimizer.torch_optimizer.state[p].items():
                        assert torch.equal(value, y.optimizer.torch_optimizer.state[q][key])
        assert step.last_capture["launches"] == {"vq_argmin": 1}
    finally:
        torch.backends.cudnn.deterministic = False
