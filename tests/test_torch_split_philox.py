"""The arithmetic of the redesigned ``vq_argmin`` and sampler kernels, on the
CPU: the split-bf16 product of the codebook search against the JAX kernel
(interpret mode), and the Philox4x32-10 stream of the sampler against
Random123's published known answers.

The card's kernels are held against these plain twins in
``tests/test_torch_cuda.py``.
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from open_muse_tpu.ops.pallas.vq_argmin import vq_argmin as jax_vq_argmin
from open_muse_tpu_torch.kernels.fused_sample import (draw_seed, philox4x32_plain,
                                                      philox_gumbel_plain)
from open_muse_tpu_torch.kernels.vq_argmin import (vq_near_ties, vq_split_plain,
                                                   vq_split_scores_plain)


@pytest.fixture(autouse=True)
def _interpret_kernels(monkeypatch):
    monkeypatch.setenv("MUSE_TPU_PALLAS_INTERPRET", "1")


@pytest.fixture
def fp32_products():
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(saved)


def _latents(seed, n, c, k):
    rs = np.random.RandomState(seed)
    return rs.randn(n, c).astype(np.float32), rs.randn(k, c).astype(np.float32)


# -- the split-bf16 product of vq_argmin ---------------------------------------

@pytest.mark.parametrize("n,c,k", [(300, 16, 1024), (5, 7, 131), (64, 256, 8192)])
def test_vq_split_plain_parts(n, c, k):
    """Each operand's three parts [hi | mid | lo], Cp = C rounded up to 64
    wide: hi + mid + lo gives -2 z and the codebook within 2^-23 of each
    value (each subtraction of the split is exact in fp32), hi and mid are
    the bf16 roundings, and the padding past C and past K is zero."""
    z, cb = (torch.from_numpy(a) for a in _latents(n + k, n, c, k))
    zp, cbp = vq_split_plain(z, cb)
    cp, kp = -(-c // 64) * 64, -(-k // 2) * 2
    assert zp.dtype == cbp.dtype == torch.bfloat16
    assert zp.shape == (n, 3 * cp) and cbp.shape == (kp, 3 * cp)
    for x, parts in ((-2 * z, zp), (cb, cbp)):
        hi, mid, lo = (b[:x.shape[0], :c] for b in parts.float().split(cp, dim=1))
        assert torch.equal(hi, x.to(torch.bfloat16).float())
        assert torch.equal(mid, (x - hi).to(torch.bfloat16).float())
        err = ((hi.double() + mid.double() + lo.double()) - x.double()).abs()
        assert bool((err <= 2.0 ** -23 * x.double().abs()).all())
        assert not bool(parts.float()[:, torch.arange(3 * cp) % cp >= c].any())
    assert not bool(cbp.float()[k:].any())


@pytest.mark.parametrize("n,c,k", [(300, 16, 1024), (2048, 32, 2048), (1500, 8, 3072)])
def test_split_route_matches_jax_kernel(fp32_products, n, c, k):
    """The kernel's route on the CPU -- the split parts, their six products
    summed in fp32 (bf16 x bf16 products are exact there), e_sq added, the
    first minimum -- against the JAX kernel in interpret mode at
    test_torch_encode's shapes: ids equal except at rows whose two best
    plain fp32 scores lie within 1e-5 of the squared distances' scale, where
    the pick lies within that of the minimum."""
    z, cb = _latents(n + k, n, c, k)
    want = torch.from_numpy(np.array(jax_vq_argmin(jnp.asarray(z), jnp.asarray(cb),
                                                   interpret=True))).to(torch.int32)
    z, cb = torch.from_numpy(z), torch.from_numpy(cb)
    got = torch.argmin(vq_split_scores_plain(z, cb), dim=1).to(torch.int32)
    near, _, over = vq_near_ties(got, z, cb, 1e-5)
    differ = got != want
    assert bool((~differ | near).all())
    assert bool((over[differ] <= 0).all())


# -- the Philox stream of the sampler ------------------------------------------

@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), 0, (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, 0xffffffffffffffff, (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0x299f31d0 << 32) | 0xa4093822,
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox4x32_known_answers(counter, key, want):
    """Random123's known-answer vectors for philox4x32 with 10 rounds (key
    word 0 in the low 32 bits of the 64-bit key)."""
    got = philox4x32_plain(torch.tensor([counter], dtype=torch.int64), key)
    assert tuple(int(v) for v in got[0]) == want


def test_philox_gumbel_plain_layout():
    """Column col of row r is word col % 4 of the call on counter (col // 4,
    r, 0, 0), its top 24 bits mapped to u in (0, 1), then -log(-log(u)); a
    ragged last call (10 columns) is cropped.  u is rounded to fp32 as the
    kernel rounds it; the logs, taken here in fp64, to rel 1e-6."""
    seed, rows, cols = draw_seed(torch.Generator().manual_seed(3)), 3, 10
    got = philox_gumbel_plain(seed, rows, cols)
    assert got.shape == (rows, cols) and got.dtype == torch.float32
    for r in range(rows):
        for col in range(cols):
            word = int(philox4x32_plain(torch.tensor([[col // 4, r, 0, 0]]), seed)[0, col % 4])
            u = (np.float32(word >> 8) + np.float32(0.5)) * np.float32(2.0 ** -24)  # in fp32
            assert got[r, col].item() == pytest.approx(-math.log(-math.log(u)), rel=1e-6)


def test_philox_gumbel_plain_distribution():
    """2^16 draws: the Gumbel(0, 1) mean (Euler's constant 0.5772) within
    0.01 and every value finite."""
    g = philox_gumbel_plain(draw_seed(torch.Generator().manual_seed(0)), 64, 1024)
    assert bool(torch.isfinite(g).all())
    assert abs(g.double().mean().item() - 0.5772156649) <= 0.01
