"""Plain PyTorch versions of the port's kernels vs the JAX package on the CPU.

Each port wrapper, given CPU tensors, computes its plain version; it is held
against the JAX Pallas kernel in interpret mode and against the kernel's
XLA oracle, in fp32 with the same numpy inputs.  The CUDA kernels themselves
are held against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from open_muse_tpu.ops.pallas import attn_sublayer as A
from open_muse_tpu.ops.pallas.fused_sample import fused_categorical_cfg as jax_sample_cfg
from open_muse_tpu.ops.pallas.glu_matmul import glu_down_matmul as jax_glu
from open_muse_tpu_torch import kernels


@pytest.fixture(autouse=True)
def _interpret_kernels(monkeypatch):
    monkeypatch.setenv("MUSE_TPU_PALLAS_INTERPRET", "1")


def _np(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _sublayer_inputs(seed, b, s, d):
    rs = np.random.RandomState(seed)
    return dict(x=_np(rs, b, s, d), res=_np(rs, b, s, d), ln=1.0 + _np(rs, d, scale=0.1),
                adaln=_np(rs, b, 2 * d, scale=0.1), w_out=_np(rs, d, d, scale=d ** -0.5), rs=rs)


@pytest.mark.parametrize("with_res", [True, False])
def test_self_sublayer_plain_matches_jax(with_res):
    """b3 s64 d256 h4; tolerance 2e-5 absolute (fp32, summation order)."""
    b, s, d, h = 3, 64, 256, 4
    p = _sublayer_inputs(0, b, s, d)
    wqkv = _np(p["rs"], d, 3 * d, scale=d ** -0.5)
    res = p["res"] if with_res else None
    jres = None if res is None else jnp.asarray(res)
    pallas = A.attn_sublayer_self(jnp.asarray(p["x"]), jres, jnp.asarray(p["ln"]),
                                  jnp.asarray(p["adaln"]), jnp.asarray(wqkv),
                                  jnp.asarray(p["w_out"]), num_heads=h)
    oracle = A._xla_ref_self(jnp.asarray(p["x"]),
                             jnp.zeros((b, s, d)) if res is None else jres,
                             jnp.asarray(p["ln"]), jnp.asarray(p["adaln"]), jnp.asarray(wqkv),
                             jnp.asarray(p["w_out"]), h, 1e-6)
    out, resid = kernels.attn_sublayer_self(
        _t(p["x"]), None if res is None else _t(res), _t(p["ln"]), _t(p["adaln"]),
        _t(wqkv.T), _t(p["w_out"].T), num_heads=h)
    for ref_out, ref_res in (pallas, oracle):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=2e-5, rtol=0)
        np.testing.assert_array_equal(resid.numpy(), np.asarray(ref_res))


@pytest.mark.parametrize("with_res", [True, False])
def test_cross_sublayer_plain_matches_jax(with_res):
    """kv_len 77 (the JAX kernel pads it to 128 and masks); 2e-5 absolute."""
    b, s, d, h, lk = 2, 32, 128, 2, 77
    p = _sublayer_inputs(1, b, s, d)
    wq = _np(p["rs"], d, d, scale=d ** -0.5)
    kv = _np(p["rs"], b, lk, 2 * d)
    res = p["res"] if with_res else None
    jres = None if res is None else jnp.asarray(res)
    args = (jnp.asarray(p["ln"]), jnp.asarray(p["adaln"]), jnp.asarray(wq),
            jnp.asarray(p["w_out"]))
    pallas = A.attn_sublayer_cross(jnp.asarray(p["x"]), jres, *args, jnp.asarray(kv),
                                   num_heads=h)
    kv_pad = jnp.pad(jnp.asarray(kv), ((0, 0), (0, 128 - lk), (0, 0)))
    oracle = A._xla_ref_cross(jnp.asarray(p["x"]),
                              jnp.zeros((b, s, d)) if res is None else jres,
                              *args, kv_pad, h, 1e-6, lk)
    out, resid = kernels.attn_sublayer_cross(
        _t(p["x"]), None if res is None else _t(res), _t(p["ln"]), _t(p["adaln"]),
        _t(wq.T), _t(p["w_out"].T), _t(kv), num_heads=h)
    for ref_out, ref_res in (pallas, oracle):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=2e-5, rtol=0)
        np.testing.assert_array_equal(resid.numpy(), np.asarray(ref_res))


def test_sublayer_rejects_unsupported_heads():
    x = torch.zeros(1, 8, 256)
    with pytest.raises(ValueError):  # head_dim 128
        kernels.attn_sublayer_self(x, None, torch.ones(256), torch.zeros(1, 512),
                                   torch.zeros(768, 256), torch.zeros(256, 256), num_heads=2)
    x = torch.zeros(1, 8, 192)
    with pytest.raises(ValueError):  # three heads of 64: odd head count
        kernels.attn_sublayer_self(x, None, torch.ones(192), torch.zeros(1, 384),
                                   torch.zeros(576, 192), torch.zeros(192, 192), num_heads=3)


@pytest.mark.parametrize("m,block_m", [(100, 64), (1025, 1024)])
def test_glu_plain_matches_jax(m, block_m):
    """Rows that are not a multiple of the Pallas row tile (padded there);
    tolerance rtol 2e-5, atol 2e-4 as the JAX kernel test (its erf is a
    polynomial with |err| <= 1.5e-7)."""
    rs = np.random.RandomState(m)
    k, n = 256, 128
    a, b = _np(rs, m, k), _np(rs, m, k)
    wo = _np(rs, k, n, scale=0.02)
    pallas = jax_glu(jnp.asarray(a), jnp.asarray(b), jnp.asarray(wo), block_m=block_m,
                     interpret=True)
    oracle = (jax.nn.gelu(jnp.asarray(a), approximate=False) * jnp.asarray(b)) @ wo
    got = kernels.glu_down_matmul(_t(a), _t(b), _t(wo.T)).numpy()
    for ref in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("two_b,s,v_raw,v_lim,dtype", [
    (6, 50, 8256, 8192, jnp.bfloat16),   # the research crop 8256 -> 8192, bf16 logits
    (4, 9, 1000, 1000, jnp.float32),     # no crop, vocab not lane-aligned
])
def test_cfg_sampler_plain_matches_jax(two_b, s, v_raw, v_lim, dtype):
    """Explicit Gumbel noise: token ids exactly equal.  sel to rtol 1e-5: each
    side sums the logsumexp over up to 8192 fp32 terms in its own order; the
    two JAX references differ from each other by up to 4e-6 here, and the
    port lies within 8e-6 of each."""
    rs = np.random.RandomState(v_raw)
    logits = jnp.asarray(_np(rs, two_b, s, v_raw, scale=2.0)).astype(dtype)
    noise = jax.random.gumbel(jax.random.PRNGKey(v_raw), (two_b // 2, s, v_raw), jnp.float32)
    guidance = 7.5
    ids, sel = kernels.fused_categorical_cfg(_t(np.asarray(logits.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32), guidance, v_lim,
        gumbel=_t(np.asarray(noise)))
    pallas = jax_sample_cfg(0, logits, guidance, v_lim, interpret=True, gumbel=noise)
    lf = logits.astype(jnp.float32)[..., :v_lim]
    b = two_b // 2
    comb = lf[b:] + guidance * (lf[:b] - lf[b:])
    ref_ids = jnp.argmax(comb + noise[..., :v_lim], -1)
    ref_sel = jnp.take_along_axis(jax.nn.softmax(comb, -1), ref_ids[..., None], -1)[..., 0]
    for want_ids, want_sel in (pallas, (ref_ids, ref_sel)):
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
        np.testing.assert_allclose(sel.numpy(), np.asarray(want_sel), rtol=1e-5, atol=0)


def test_cfg_sampler_needs_one_noise_source():
    logits = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError):
        kernels.fused_categorical_cfg(logits, 1.0, 8)
    with pytest.raises(ValueError):
        kernels.fused_categorical_cfg(logits, 1.0, 8, gumbel=torch.zeros(1, 3, 8),
                                      generator=torch.Generator())


def test_cfg_sampler_generator_path_is_seeded():
    logits = torch.randn(2, 4, 32, generator=torch.Generator().manual_seed(0))
    draw = lambda seed: kernels.fused_categorical_cfg(  # noqa: E731
        logits, 2.0, 32, generator=torch.Generator().manual_seed(seed))
    assert torch.equal(draw(1)[0], draw(1)[0])
    assert draw(1)[0].dtype == torch.int32
