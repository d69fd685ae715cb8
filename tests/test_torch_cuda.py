"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a GPU.  This file imports no jax,
so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from open_muse_tpu_torch import kernels
from open_muse_tpu_torch.kernels import attn_sublayer as A
from open_muse_tpu_torch.kernels.fused_sample import fused_categorical_cfg_plain
from open_muse_tpu_torch.kernels.glu_matmul import glu_down_matmul_plain

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
