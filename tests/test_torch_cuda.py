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

# bf16 on both sides with one cast at the end of fp32 arithmetic: the kernels
# and the plain versions differ by the order of their sums, at most about one
# bf16 rounding of the output
NORM_TOL, ATTN_TOL = 1e-2, 2e-2


@pytest.mark.parametrize("shape,with_residual", [((1, 257, 768), True), ((2, 256, 768), True),
                                                 ((1, 257, 3072), False)])
def test_fused_norm_kernels_match_plain(device, shape, with_residual):
    """Both kernels at the paths' shapes, LayerNorm with and without a
    bias; the prenorm sum bit-equal (x itself without a residual), two calls
    bit-equal, one launch each."""
    from open_muse_tpu_torch.kernels.fused_norm import (fused_residual_layernorm_plain,
                                                        fused_residual_rmsnorm_plain)

    gen = torch.Generator().manual_seed(shape[-1])
    x = _rand(gen, *shape, scale=2.0)
    res = _rand(gen, *shape) if with_residual else None
    scale, bias = 1 + _rand(gen, shape[-1], scale=0.1), _rand(gen, shape[-1], scale=0.1)
    cases = {
        "rms": (lambda: kernels.fused_residual_rmsnorm(x, res, scale),
                lambda: fused_residual_rmsnorm_plain(x, res, scale), kernels.fused_residual_rmsnorm),
        "ln": (lambda: kernels.fused_residual_layernorm(x, res, scale, bias),
               lambda: fused_residual_layernorm_plain(x, res, scale, bias),
               kernels.fused_residual_layernorm),
        "ln_nobias": (lambda: kernels.fused_residual_layernorm(x, res, scale, None),
                      lambda: fused_residual_layernorm_plain(x, res, scale, None),
                      kernels.fused_residual_layernorm),
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


@pytest.mark.parametrize("q_shape,kv_len", [((1, 257, 16, 48), 257), ((2, 256, 12, 64), 77)])
def test_flash_attention_kernel_matches_plain(device, q_shape, kv_len):
    """v1's self-attention (ragged 257 x 257, head_dim 48) and v2's block
    cross-attention (77 keys, head_dim 64), the inputs as views into fused
    [q | k | v] / [k | v] projections; two calls bit-equal."""
    from open_muse_tpu_torch.kernels.flash_attention import flash_attention_plain

    gen = torch.Generator().manual_seed(kv_len)
    b, tq, h, d = q_shape
    if tq == kv_len:
        q, k, v = _rand(gen, b, tq, 3 * h * d).reshape(b, tq, 3 * h, d).chunk(3, dim=2)
    else:
        q = _rand(gen, b, tq, h, d)
        k, v = _rand(gen, b, kv_len, 2 * h * d).reshape(b, kv_len, 2 * h, d).chunk(2, dim=2)
    before = kernels.flash_attention.launches
    out = kernels.flash_attention(q, k, v)
    assert kernels.flash_attention.launches == before + 1
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
