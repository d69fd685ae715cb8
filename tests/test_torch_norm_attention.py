"""The fused-norm and flash-attention kernels' plain versions against the JAX
package's Pallas kernels in interpret mode, on the CPU in fp32.

``fused_residual_rmsnorm_plain`` / ``fused_residual_layernorm_plain`` and
``flash_attention_plain`` are what the port's wrappers compute for CPU
tensors and what ``chip_smoke.py`` holds the CUDA kernels against.  Inputs
come from numpy seeds; each test states its tolerance.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from open_muse_tpu.ops.pallas.flash_attention import flash_attention as jax_flash_attention
from open_muse_tpu.ops.pallas.fused_norm import (fused_residual_layernorm as jax_layernorm,
                                                 fused_residual_rmsnorm as jax_rmsnorm)
from open_muse_tpu_torch import kernels
from open_muse_tpu_torch.kernels.flash_attention import flash_attention_plain
from open_muse_tpu_torch.kernels.fused_norm import (fused_residual_layernorm_plain,
                                                    fused_residual_rmsnorm_plain)
from open_muse_tpu_torch.ops import layers

# fp32 on both sides: the normed rows to rtol 1e-5 of their scale (the
# moments summed in another order), the prenorm sum exactly (one fp32 add)
NORM_RTOL = 1e-5


def _rows(seed, shape, with_residual):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    res = rs.randn(*shape).astype(np.float32) if with_residual else None
    d = shape[-1]
    return x, res, (1 + 0.1 * rs.randn(d)).astype(np.float32), (0.1 * rs.randn(d)).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("shape", [(2, 37, 96), (3, 768), (1, 5, 3072)])
@pytest.mark.parametrize("with_residual", [True, False])
def test_rmsnorm_plain_matches_jax_kernel(shape, with_residual):
    """Ragged row counts (the JAX kernel pads to its 256-row blocks)."""
    x, res, scale, _ = _rows(sum(shape), shape, with_residual)
    want, want_pre = jax_rmsnorm(_j(x), _j(res), _j(scale), eps=1e-6, interpret=True)
    got, pre = fused_residual_rmsnorm_plain(_t(x), _t(res), _t(scale), 1e-6)
    _close(got, want, NORM_RTOL)
    np.testing.assert_array_equal(pre.numpy(), np.asarray(want_pre))


@pytest.mark.parametrize("shape", [(2, 37, 96), (1, 257, 768), (1, 5, 3072)])
@pytest.mark.parametrize("with_residual,with_bias", [(True, True), (False, True), (True, False)])
def test_layernorm_plain_matches_jax_kernel(shape, with_residual, with_bias):
    x, res, scale, bias = _rows(sum(shape) + 1, shape, with_residual)
    bias = bias if with_bias else None
    want, want_pre = jax_layernorm(_j(x), _j(res), _j(scale), _j(bias), eps=1e-5,
                                   interpret=True)
    got, pre = fused_residual_layernorm_plain(_t(x), _t(res), _t(scale), _t(bias), 1e-5)
    _close(got, want, NORM_RTOL)
    np.testing.assert_array_equal(pre.numpy(), np.asarray(want_pre))


def test_norm_wrappers_on_cpu_return_x_as_prenorm_and_launch_nothing():
    """Without a residual the prenorm output is x itself (no copy); CPU
    tensors take the plain versions."""
    x, _, scale, bias = _rows(0, (4, 64), False)
    xt = torch.from_numpy(x)
    kernels.reset_launch_counts()
    _, pre = kernels.fused_residual_rmsnorm(xt, None, torch.from_numpy(scale))
    assert pre is xt
    _, pre = kernels.fused_residual_layernorm(xt, None, torch.from_numpy(scale),
                                              torch.from_numpy(bias))
    assert pre is xt
    assert kernels.launch_counts() == {fn.__name__: 0 for fn in kernels.WRAPPERS}


def _qkv(seed, b, tq, tk, h, d):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, tq, h, d).astype(np.float32), rs.randn(b, tk, h, d).astype(np.float32),
            rs.randn(b, tk, h, d).astype(np.float32))


# fp32 on both sides: the output to 1e-5 of its scale (the logits, the
# softmax sums and PV summed in another order)
ATTN_RTOL = 1e-5


@pytest.mark.parametrize("b,tq,tk,h,d", [
    (1, 257, 257, 2, 48),  # v1 self-attention: ragged Tq and Tk, head_dim 48
    (2, 64, 77, 3, 16),    # the 77 text keys (the JAX kernel pads K to 128)
    (2, 300, 20, 1, 16),   # Tq past one JAX block of 256
])
def test_flash_attention_plain_matches_jax_kernel(b, tq, tk, h, d):
    q, k, v = _qkv(tq + tk, b, tq, tk, h, d)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    got = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert got.shape == (b, tq, h, d)
    _close(got, want, ATTN_RTOL)


def test_attention_and_norm_layers_route_through_the_wrappers():
    """``use_kernels=True`` sends an unmasked dot_product_attention and the
    norms to the wrappers (plain versions on the CPU): equal to the
    use_kernels=False staging in fp32; a masked call stays plain."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 2, 9, 11, 2, 16))
    torch.testing.assert_close(layers.dot_product_attention(q, k, v),
                               layers.dot_product_attention(q, k, v, use_kernels=False),
                               rtol=0, atol=1e-6)
    mask = torch.zeros(2, 1, 1, 11, dtype=torch.bool)
    mask[1, ..., 7:] = True
    masked = layers.dot_product_attention(q, k, v, mask=mask)
    torch.testing.assert_close(masked[1], layers.dot_product_attention(
        q[1:], k[1:, :7], v[1:, :7], use_kernels=False)[0], rtol=0, atol=1e-6)
    x, res = torch.randn(2, 5, 32), torch.randn(2, 5, 32)
    for norm in (layers.RMSNorm(32), layers.LayerNorm(32, use_bias=True)):
        with torch.no_grad():
            norm.weight.uniform_(0.5, 1.5)
        for use_kernels in (True, False):
            out, pre = norm(x, res, use_kernels=use_kernels)
            ref, ref_pre = norm(x, res, use_kernels=not use_kernels)
            torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
            assert torch.equal(pre, ref_pre)


def _grads(fn, inputs):
    """fn's outputs and the gradients of a fixed random projection of them."""
    leaves = [None if t is None else t.clone().requires_grad_() for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gen = torch.Generator().manual_seed(7)
    loss = sum((o * torch.randn(o.shape, generator=gen, dtype=o.dtype)).sum() for o in outs)
    loss.backward()
    return outs, [None if t is None else t.grad for t in leaves]


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("with_residual", [True, False])
def test_norm_wrappers_differentiate_as_the_plain_versions(kind, with_residual):
    """The wrappers' backward (the plain version recomputed and
    differentiated) equals autograd through the plain version, prenorm
    gradient included, in fp32; gradcheck in float64."""
    x, res, scale, bias = (_t(a) for a in _rows(11, (2, 5, 24), with_residual))
    if kind == "rms":
        wrapper = lambda x, r, s, b: kernels.fused_residual_rmsnorm(x, r, s, 1e-6)  # noqa: E731
        plain = lambda x, r, s, b: fused_residual_rmsnorm_plain(x, r, s, 1e-6)  # noqa: E731
        bias = None
    else:
        wrapper = lambda x, r, s, b: kernels.fused_residual_layernorm(x, r, s, b, 1e-5)  # noqa: E731
        plain = lambda x, r, s, b: fused_residual_layernorm_plain(x, r, s, b, 1e-5)  # noqa: E731
    inputs = (x, res, scale, bias)
    got, got_grads = _grads(wrapper, inputs)
    want, want_grads = _grads(plain, inputs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for g, w in zip(got_grads, want_grads):
        assert (g is None) == (w is None)
        if g is not None:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    wide = tuple(None if t is None else t.double().requires_grad_() for t in inputs)
    assert torch.autograd.gradcheck(wrapper, wide)


def test_flash_attention_wrapper_differentiates_as_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 2, 7, 9, 2, 16))
    got, got_grads = _grads(kernels.flash_attention, (q, k, v))
    want, want_grads = _grads(flash_attention_plain, (q, k, v))
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for g, w in zip(got_grads, want_grads):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    wide = tuple(t.double().requires_grad_() for t in (q, k, v))
    assert torch.autograd.gradcheck(kernels.flash_attention, wide)
