"""Backward of the port's kernels vs the JAX package on the CPU, in fp32.

The plain backward versions (what the CUDA backward kernels compute, and what
the autograd Functions run on CPU tensors) are held against ``jax.vjp`` of
the XLA oracles and against the JAX Pallas backward kernels in interpret
mode, on the same numpy inputs; ``gradcheck`` runs in fp64 through each of
the three Functions.  The CUDA kernels are held against these plain versions
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from open_muse_tpu.ops.pallas import attn_sublayer as A
from open_muse_tpu.ops.pallas import glu_matmul as G
from open_muse_tpu_torch import kernels
from open_muse_tpu_torch.kernels import attn_sublayer as TA
from open_muse_tpu_torch.kernels import glu_matmul as TG

B, S, D, H, EPS = 2, 16, 128, 2, 1e-6  # the JAX backward gate: seq % 8, head_dim 64
KV_LEN, KV_PAD = 77, 128


@pytest.fixture(autouse=True)
def _interpret_kernels(monkeypatch):
    monkeypatch.setenv("MUSE_TPU_PALLAS_INTERPRET", "1")


def _np(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(seed, cross):
    rs = np.random.RandomState(seed)
    n_in = D if cross else 3 * D
    p = dict(x=_np(rs, B, S, D), res=_np(rs, B, S, D), ln=1.0 + _np(rs, D, scale=0.1),
             adaln=_np(rs, B, 2 * D, scale=0.1), w_in=_np(rs, D, n_in, scale=D ** -0.5),
             wout=_np(rs, D, D, scale=D ** -0.5), g_out=_np(rs, B, S, D),
             g_res=_np(rs, B, S, D, scale=0.5))
    if cross:
        p["kv"] = _np(rs, B, KV_LEN, 2 * D)
    return p


def _close(got, want, atol, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


# fp32 on both sides, differing in summation order (and, against the Pallas
# body, in its staged softmax): every gradient here is O(1) - O(10), so an
# absolute 1e-4 plus a relative 1e-4 sits ~10x above the differences seen
SUBLAYER_ATOL = 1e-4


@pytest.mark.parametrize("with_res", [True, False])
def test_self_backward_plain_matches_jax(with_res):
    p = _inputs(0, cross=False)
    res = p["res"] if with_res else np.zeros_like(p["x"])
    j = [jnp.asarray(v) for v in (p["x"], res, p["ln"], p["adaln"], p["w_in"], p["wout"])]
    g = (jnp.asarray(p["g_out"]), jnp.asarray(p["g_res"]))
    _, vjp = jax.vjp(lambda *a: A._xla_ref_self(*a, num_heads=H, eps=EPS), *j)
    oracle = vjp(g)
    pallas = A._self_bwd_pallas(*j, *g, H, EPS, True, H // 2, None)
    got = kernels.attn_sublayer_self_bwd(
        _t(p["x"]), _t(p["res"]) if with_res else None, _t(p["ln"]), _t(p["adaln"]),
        _t(p["w_in"].T), _t(p["wout"].T), _t(p["g_out"]), _t(p["g_res"]), H, EPS)
    for ref in (oracle, pallas):
        dx, dres, dln, dadaln, dwqkv, dwout = ref
        _close(got[0], dx, SUBLAYER_ATOL)
        _close(got[1], dres, SUBLAYER_ATOL)
        _close(got[2], dln, SUBLAYER_ATOL)
        _close(got[3], dadaln, SUBLAYER_ATOL)
        _close(got[4], np.asarray(dwqkv).T, SUBLAYER_ATOL)
        _close(got[5], np.asarray(dwout).T, SUBLAYER_ATOL)


@pytest.mark.parametrize("with_res", [True, False])
def test_cross_backward_plain_matches_jax(with_res):
    """kv_len 77: JAX pads kv to 128 and masks; the port takes it unpadded."""
    p = _inputs(1, cross=True)
    res = p["res"] if with_res else np.zeros_like(p["x"])
    kv_pad = np.pad(p["kv"], ((0, 0), (0, KV_PAD - KV_LEN), (0, 0)))
    j = [jnp.asarray(v) for v in (p["x"], res, p["ln"], p["adaln"], p["w_in"], p["wout"],
                                  kv_pad)]
    g = (jnp.asarray(p["g_out"]), jnp.asarray(p["g_res"]))
    _, vjp = jax.vjp(lambda *a: A._xla_ref_cross(*a, num_heads=H, eps=EPS, kv_len=KV_LEN), *j)
    oracle = vjp(g)
    pallas = A._cross_bwd_pallas(*j, *g, H, EPS, KV_LEN, True, H // 2, None)
    got = kernels.attn_sublayer_cross_bwd(
        _t(p["x"]), _t(p["res"]) if with_res else None, _t(p["ln"]), _t(p["adaln"]),
        _t(p["w_in"].T), _t(p["wout"].T), _t(p["kv"]), _t(p["g_out"]), _t(p["g_res"]), H, EPS)
    for ref in (oracle, pallas):
        dx, dres, dln, dadaln, dwq, dwout, dkv = ref
        for mine, want in zip(got[:4], (dx, dres, dln, dadaln)):
            _close(mine, want, SUBLAYER_ATOL)
        _close(got[4], np.asarray(dwq).T, SUBLAYER_ATOL)
        _close(got[5], np.asarray(dwout).T, SUBLAYER_ATOL)
        _close(got[6], np.asarray(dkv)[:, :KV_LEN], SUBLAYER_ATOL)
        np.testing.assert_array_equal(np.asarray(dkv)[:, KV_LEN:], 0.0)


@pytest.mark.parametrize("m", [100, 512])
def test_glu_backward_plain_matches_jax(monkeypatch, m):
    """Rows not a multiple of the Pallas row tile (padded there) and one that
    is; rtol 2e-5, atol 2e-4 as the forward test (the Pallas erf is a
    polynomial with |err| <= 1.5e-7)."""
    rs = np.random.RandomState(m)
    k, n = 256, 128
    a, b = _np(rs, m, k), _np(rs, m, k)
    wo, g = _np(rs, k, n, scale=0.05), _np(rs, m, n)
    pallas = G._bwd_pallas(jnp.asarray(a), jnp.asarray(b), jnp.asarray(wo), jnp.asarray(g),
                           min(G.BWD_BLOCK_M, m), G.BWD_BLOCK_K, True)
    monkeypatch.setenv("MUSE_TPU_PALLAS_GLU_BWD", "0")
    oracle = G._glu_down_bwd(G.BLOCK_M, G.BLOCK_K, True,
                             (jnp.asarray(a), jnp.asarray(b), jnp.asarray(wo)), jnp.asarray(g))
    da, db, dwo = kernels.glu_down_matmul_bwd(_t(a), _t(b), _t(wo.T), _t(g))
    for ref in (pallas, oracle):
        np.testing.assert_allclose(da.numpy(), np.asarray(ref[0]), rtol=2e-5, atol=2e-4)
        np.testing.assert_allclose(db.numpy(), np.asarray(ref[1]), rtol=2e-5, atol=2e-4)
        np.testing.assert_allclose(dwo.numpy(), np.asarray(ref[2]).T, rtol=2e-5, atol=2e-4)


# -- gradcheck through the autograd Functions (fp64, plain versions) -----------

def _f64(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, dtype=torch.float64) * scale).requires_grad_()


@pytest.mark.parametrize("with_res", [True, False])
def test_self_function_gradcheck(with_res):
    gen = torch.Generator().manual_seed(0)
    s, d = 8, 128
    x, res = _f64(gen, 1, s, d), _f64(gen, 1, s, d) if with_res else None
    ln, adaln = (1 + _f64(gen, d, scale=0.1)).detach().requires_grad_(), _f64(gen, 1, 2 * d, scale=0.1)
    wqkv, wout = _f64(gen, 3 * d, d, scale=d ** -0.5), _f64(gen, d, d, scale=d ** -0.5)
    fn = lambda *a: kernels.attn_sublayer_self(a[0], res, *a[1:], num_heads=2)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (x, ln, adaln, wqkv, wout), fast_mode=True)
    if with_res:
        assert torch.autograd.gradcheck(
            lambda r: kernels.attn_sublayer_self(x, r, ln, adaln, wqkv, wout, num_heads=2),
            (res,), fast_mode=True)


def test_cross_function_gradcheck():
    gen = torch.Generator().manual_seed(1)
    s, d, lk = 8, 128, 5
    x, res = _f64(gen, 1, s, d), _f64(gen, 1, s, d)
    ln, adaln = (1 + _f64(gen, d, scale=0.1)).detach().requires_grad_(), _f64(gen, 1, 2 * d, scale=0.1)
    wq, wout = _f64(gen, d, d, scale=d ** -0.5), _f64(gen, d, d, scale=d ** -0.5)
    kv = _f64(gen, 1, lk, 2 * d)
    assert torch.autograd.gradcheck(
        lambda *a: kernels.attn_sublayer_cross(*a, num_heads=2),
        (x, res, ln, adaln, wq, wout, kv), fast_mode=True)


def test_glu_function_gradcheck():
    gen = torch.Generator().manual_seed(2)
    a, b, wo = _f64(gen, 12, 24), _f64(gen, 12, 24), _f64(gen, 16, 24, scale=0.2)
    assert torch.autograd.gradcheck(kernels.glu_down_matmul, (a, b, wo), fast_mode=True)


def test_first_layer_gives_no_residual_gradient():
    """res=None: the backward returns no residual gradient, and the output
    gradient reaches x, the norm scale, adaln and both weights."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(1, 8, 128, generator=gen, requires_grad=True)
    ln = torch.ones(128, requires_grad=True)
    adaln = torch.zeros(1, 256, requires_grad=True)
    wqkv = (torch.randn(384, 128, generator=gen) * 0.1).requires_grad_()
    wout = (torch.randn(128, 128, generator=gen) * 0.1).requires_grad_()
    out, h = kernels.attn_sublayer_self(x, None, ln, adaln, wqkv, wout, num_heads=2)
    (out.sum() + h.square().sum()).backward()
    for t in (x, ln, adaln, wqkv, wout):
        assert t.grad is not None and bool(t.grad.abs().sum() > 0)
    assert kernels.launch_counts() == {fn.__name__: 0 for fn in kernels.WRAPPERS}


def test_backward_wrappers_check_shapes():
    x = torch.zeros(1, 8, 128)
    with pytest.raises(ValueError):
        TA.attn_sublayer_self_bwd(x, None, torch.ones(128), torch.zeros(1, 256),
                                  torch.zeros(384, 128), torch.zeros(128, 128), x,
                                  torch.zeros(1, 8, 64), 2)
    with pytest.raises(ValueError):
        TG.glu_down_matmul_bwd(torch.zeros(4, 8), torch.zeros(4, 8), torch.zeros(6, 8),
                               torch.zeros(4, 5))
