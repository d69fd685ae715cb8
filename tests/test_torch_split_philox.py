"""The arithmetic of the redesigned ``vq_argmin`` and sampler kernels, on the
CPU: the split-bf16 product of the codebook search (both routes: the split
GEMM's and the narrow route's K-packed product) against the JAX kernel
(interpret mode), the narrow route's rule against the C source, and the
Philox4x32-10 stream of the sampler against Random123's published known
answers.

The card's kernels are held against these plain twins in
``tests/test_torch_cuda.py``.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from open_muse_tpu.ops.pallas.vq_argmin import vq_argmin as jax_vq_argmin
from open_muse_tpu_torch.kernels.fused_sample import (draw_seed, philox4x32_plain,
                                                      philox_gumbel_plain)
from open_muse_tpu_torch.kernels.vq_argmin import (NARROW_MAX_C, SPLIT_PRODUCTS, packed_width,
                                                   vq_near_ties, vq_pack_plain,
                                                   vq_packed_scores_plain, vq_split_plain,
                                                   vq_split_scores_plain)

CSRC = (Path(__file__).resolve().parent.parent / "open_muse_tpu_torch" / "csrc"
        / "vq_argmin.cu").read_text()


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


@pytest.mark.parametrize("n,c,k", [(300, 16, 1024), (2048, 32, 2048), (1500, 8, 3072),
                                   (512, 4, 2048), (300, 3, 1024), (256, 11, 1024)])
def test_split_route_matches_jax_kernel(fp32_products, n, c, k):
    """The kernel's route on the CPU -- the split parts, their six products
    summed in fp32 (bf16 x bf16 products are exact there), e_sq added (up to
    NARROW_MAX_C channels the narrow route's K-packed product, e_sq folded
    in as three more columns), the first minimum -- against the JAX kernel
    in interpret mode at test_torch_encode's shapes, the MOVQ / Paella
    latents' C 4, C 3 and either side of the narrow route's bound: ids equal
    except at rows whose two best plain fp32 scores lie within 1e-5 of the
    squared distances' scale, where the pick lies within that of the
    minimum."""
    z, cb = _latents(n + k, n, c, k)
    want = torch.from_numpy(np.array(jax_vq_argmin(jnp.asarray(z), jnp.asarray(cb),
                                                   interpret=True))).to(torch.int32)
    z, cb = torch.from_numpy(z), torch.from_numpy(cb)
    twin = vq_packed_scores_plain if c <= NARROW_MAX_C else vq_split_scores_plain
    got = torch.argmin(twin(z, cb), dim=1).to(torch.int32)
    near, _, over = vq_near_ties(got, z, cb, 1e-5)
    differ = got != want
    assert bool((~differ | near).all())
    assert bool((over[differ] <= 0).all())


@pytest.mark.parametrize("n,c,k", [(300, 4, 1024), (5, 3, 131), (64, 10, 257), (7, 1, 10)])
def test_vq_pack_plain_parts(n, c, k):
    """The narrow route's K-packed operands, packed_width(C) wide: span s of
    A and of B is part SPLIT_PRODUCTS[s] of -2 z and of the codebook,
    bit-equal to the split pass's parts; A's next three columns are 1 and
    B's the three parts of e_sq (|e|^2 in fp32 in column order), which carry
    it to 2^-23; zeros after.  So A B^T in fp64 is the six part products'
    sum plus e_sq's parts, exactly."""
    z, cb = (torch.from_numpy(x) for x in _latents(n + k + c, n, c, k))
    a, b = vq_pack_plain(z, cb)
    w = packed_width(c)
    assert a.shape == (n, w) and b.shape == (k, w) and a.dtype == b.dtype == torch.bfloat16
    zp, cbp = vq_split_plain(z, cb)
    cp = zp.shape[1] // 3
    for s, (pa, pb) in enumerate(SPLIT_PRODUCTS):
        assert torch.equal(a[:, s * c:(s + 1) * c], zp[:, pa * cp:pa * cp + c])
        assert torch.equal(b[:, s * c:(s + 1) * c], cbp[:k, pb * cp:pb * cp + c])
    assert bool((a[:, 6 * c:6 * c + 3].float() == 1).all())
    e_sq = torch.zeros(k)
    for j in range(c):
        e_sq = e_sq + cb[:, j] * cb[:, j]
    parts = b[:, 6 * c:6 * c + 3].double()
    assert bool(((parts.sum(1) - e_sq.double()).abs() <= 2.0 ** -23 * e_sq.double()).all())
    assert not bool(a[:, 6 * c + 3:].float().any()) and not bool(b[:, 6 * c + 3:].float().any())
    six = sum(zp[:, pa * cp:pa * cp + c].double() @ cbp[:k, pb * cp:pb * cp + c].double().t()
              for pa, pb in SPLIT_PRODUCTS)
    assert torch.equal(a.double() @ b.double().t(), six + parts.sum(1)[None])


def _narrow_constant(name):
    body = CSRC[CSRC.index("namespace narrow {"):CSRC.index("}  // namespace narrow")]
    return int(re.search(rf"constexpr int {name} = (\d+);", body).group(1))


@pytest.mark.parametrize("c,narrow", [(1, True), (4, True), (5, True), (NARROW_MAX_C, True),
                                      (NARROW_MAX_C + 1, False), (256, False)])
def test_narrow_route_rule_is_the_c_source(c, narrow):
    """The route is the C source's alone (``narrow::takes``, answered by
    ``muse_vq_route`` and taken by ``muse_vq_argmin``): C 1 - kMaxC narrow,
    wider C the split route.  The Python side's bound and packed width are
    the C constants and formula, and the bound is the widest C whose packed
    K fits the one 128-byte TMA row (64 bf16) the kernel reads."""
    assert _narrow_constant("kMaxC") == NARROW_MAX_C == 10
    assert "constexpr bool takes(int C) { return C >= 1 && C <= kMaxC; }" in CSRC
    assert "constexpr int width(int C) { return (6 * C + 3 + 31) / 32 * 32; }" in CSRC
    assert CSRC.count("if (narrow::takes(C))") == 2  # muse_vq_route and muse_vq_argmin
    assert 6 * NARROW_MAX_C + 3 <= 64 < 6 * (NARROW_MAX_C + 1) + 3
    assert (1 <= c <= NARROW_MAX_C) == narrow
    if narrow:
        assert packed_width(c) == (6 * c + 3 + 31) // 32 * 32 == (32 if c <= 4 else 64)


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
