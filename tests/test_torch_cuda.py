"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a GPU.  This file imports no jax,
so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from open_muse_tpu_torch import kernels
from open_muse_tpu_torch.kernels import attn_sublayer as A
from open_muse_tpu_torch.kernels.fused_sample import (fused_categorical_cfg_plain,
                                                      fused_categorical_plain)
from open_muse_tpu_torch.kernels.vq_argmin import vq_argmin_plain, vq_near_ties
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


@pytest.mark.parametrize("m,k,n", [(512, 2816, 1024), (100, 96, 130)])
def test_glu_kernel_matches_plain(device, m, k, n):
    """Ragged M and N tiles too; rel 2e-2 (bf16 output rounding)."""
    gen = torch.Generator().manual_seed(m)
    a, b = _rand(gen, m, k), _rand(gen, m, k)
    wo = _rand(gen, n, k, scale=k ** -0.5)
    before = kernels.glu_down_matmul.launches
    got = kernels.glu_down_matmul(a, b, wo)
    assert kernels.glu_down_matmul.launches == before + 1
    assert _rel(got, glu_down_matmul_plain(a, b, wo)) <= 2e-2


@pytest.mark.parametrize("s,kv_len", [(256, 77), (100, 130)])
def test_sublayer_kernels_match_plain(device, s, kv_len):
    """Ragged query and key tiles; rel 3e-2 (bf16 roundings of qkv, probs
    and output); the prenorm residual bit-equal."""
    gen = torch.Generator().manual_seed(s)
    b, d, h = 2, 1024, 16
    x, res = _rand(gen, b, s, d), _rand(gen, b, s, d)
    ln, adaln = 1 + _rand(gen, d, scale=0.1), _rand(gen, b, 2 * d, scale=0.1)
    wqkv, wq = _rand(gen, 3 * d, d, scale=d ** -0.5), _rand(gen, d, d, scale=d ** -0.5)
    wout, kv = _rand(gen, d, d, scale=d ** -0.5), _rand(gen, b, kv_len, 2 * d)
    for r in (res, None):
        rr = torch.zeros_like(x) if r is None else r
        out, hh = kernels.attn_sublayer_self(x, r, ln, adaln, wqkv, wout, h)
        ref, ref_h = A.attn_sublayer_self_plain(x, rr, ln, adaln, wqkv, wout, h)
        assert _rel(out, ref) <= 3e-2 and torch.equal(hh, ref_h)
        out, hh = kernels.attn_sublayer_cross(x, r, ln, adaln, wq, wout, kv, h)
        ref, ref_h = A.attn_sublayer_cross_plain(x, rr, ln, adaln, wq, wout, kv, h)
        assert _rel(out, ref) <= 3e-2 and torch.equal(hh, ref_h)


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


@pytest.mark.parametrize("n,c,k", [(256, 256, 8192), (1000, 100, 3000), (5, 7, 130)])
def test_vq_argmin_kernel_matches_plain(device, n, c, k):
    """fp32, TF32 off: ids equal except at rows whose two best plain scores
    lie within 1e-5 of the squared distances' scale (summation order), where
    the kernel's pick is within that of the minimum; two calls bit-equal;
    ragged rows, codes and C."""
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


@pytest.mark.parametrize("b,s,kv_len", [(4, 256, 77), (2, 100, 130)])
def test_sublayer_backward_kernels_match_plain(device, b, s, kv_len):
    """Ragged query and key tiles (100 rows, 130 keys); every output against
    the plain backward, and two calls bit-equal."""
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


@pytest.mark.parametrize("m,k,n", [(4096, 2816, 1024), (100, 96, 136)])
def test_glu_backward_kernel_matches_plain(device, m, k, n):
    gen = torch.Generator().manual_seed(m)
    a, b = _rand(gen, m, k), _rand(gen, m, k)
    wo, g = _rand(gen, n, k, scale=k ** -0.5), _rand(gen, m, n, scale=0.1)
    got = kernels.glu_down_matmul_bwd(a, b, wo, g)
    again = kernels.glu_down_matmul_bwd(a, b, wo, g)
    ref = glu_down_matmul_bwd_plain(a, b, wo, g)
    for name, mine, want, twice in zip(("da", "db", "dwo"), got, ref, again):
        assert _rel(mine, want) <= BWD_TOL, (name, _rel(mine, want))
        assert torch.equal(mine, twice), name


def test_training_backward_reaches_every_parameter(device):
    """Regression for the graph cut: a requires_grad forward through the
    kernels under bf16 autocast gives every parameter of a small model a
    finite, non-zero gradient, and runs every backward kernel."""
    from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2

    torch.manual_seed(0)
    model = MaskGiTUViT_v2(hidden_size=128, cond_embed_dim=32, micro_cond_encode_dim=8,
                           micro_cond_embed_dim=40, encoder_hidden_size=48, vocab_size=68,
                           codebook_size=64, in_channels=32, block_out_channels=(32,),
                           num_res_blocks=1, block_num_heads=2, num_hidden_layers=2,
                           num_attention_heads=2, intermediate_size=256).to(device)
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
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()) and bool(p.grad.abs().sum() > 0), name
