"""The encode side and the CFG-free sampler, port vs JAX, on the CPU in fp32.

The port's ``vq_argmin`` and ``fused_categorical`` wrappers, given CPU
tensors, compute their plain versions; the JAX side runs its Pallas kernels
in interpret mode.  Inputs and weights come from numpy seeds; each test
states its tolerance.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from open_muse_tpu.models.taming_vqgan import VQGANModel as JaxVQGAN
from open_muse_tpu.models.transformer_v2 import MaskGiTUViT_v2 as JaxUViT
from open_muse_tpu.ops import vq as jax_vq
from open_muse_tpu.ops.pallas.fused_sample import fused_categorical as jax_categorical
from open_muse_tpu.ops.pallas.vq_argmin import vq_argmin as jax_vq_argmin
from open_muse_tpu_torch import kernels
from open_muse_tpu_torch.kernels.vq_argmin import vq_argmin_plain
from open_muse_tpu_torch.models.taming_vqgan import VQGANModel
from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2
from open_muse_tpu_torch.ops import vq
from test_torch_models import UVIT_TINY, VQGAN_TINY, port_of, random_params, uvit_inputs

# 1024 codes: the JAX package sends K % 1024 == 0 to its Pallas kernel
VQGAN_KERNEL = {**VQGAN_TINY, "num_embeddings": 1024}


@pytest.fixture(autouse=True)
def _interpret_kernels(monkeypatch):
    monkeypatch.setenv("MUSE_TPU_PALLAS_INTERPRET", "1")


def _latents(seed, n, c, k):
    rs = np.random.RandomState(seed)
    return rs.randn(n, c).astype(np.float32), rs.randn(k, c).astype(np.float32)


@pytest.mark.parametrize("n,c,k", [(300, 16, 1024), (2048, 32, 2048), (1500, 8, 3072)])
def test_vq_argmin_plain_matches_jax_kernel(n, c, k):
    """Ragged rows (the JAX kernel pads N to 1024) and several codebook
    tiles; ids exactly equal."""
    z, cb = _latents(n + k, n, c, k)
    want = np.asarray(jax_vq_argmin(jnp.asarray(z), jnp.asarray(cb), interpret=True))
    got = kernels.vq_argmin(torch.from_numpy(z), torch.from_numpy(cb))
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_vq_argmin_duplicate_code_takes_the_earlier_index():
    """A codebook row repeated later (in another JAX tile): exact ties go to
    the earlier index on both sides."""
    z, cb = _latents(3, 200, 16, 2048)
    cb[1500] = cb[17]
    z[:50] = cb[17] + 1e-3 * z[:50]  # rows whose nearest code is 17 (and 1500)
    want = np.asarray(jax_vq_argmin(jnp.asarray(z), jnp.asarray(cb), interpret=True))
    got = vq_argmin_plain(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:50] == 17).all()


@pytest.mark.parametrize("k", [64, 1024])
@pytest.mark.parametrize("metric", ["sq_l2", "l2"])
def test_nearest_codes_and_distances_match_jax(metric, k):
    """K = 64 takes the JAX distance-matrix argmin, K = 1024 its kernel:
    ids exactly equal; distances to rtol 1e-5 (fp32, summation order), with
    an absolute floor of 1e-5 of their scale for the square root near 0."""
    z, cb = _latents(k, 500, 16, k)
    want_d = np.asarray(jax_vq.compute_distances(jnp.asarray(z), jnp.asarray(cb), metric))
    want_ids = np.asarray(jax_vq.nearest_codebook_indices(jnp.asarray(z), jnp.asarray(cb),
                                                          metric))
    got_d = vq.compute_distances(torch.from_numpy(z), torch.from_numpy(cb), metric).numpy()
    got_ids = vq.nearest_codebook_indices(torch.from_numpy(z), torch.from_numpy(cb), metric)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-5 * np.abs(want_d).max())
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)


@pytest.fixture(scope="module")
def vqgan_pair():
    jm = JaxVQGAN(**VQGAN_KERNEL, _defer_init=True)
    port, unused = port_of(jm, VQGANModel, random_params(jm, 8))
    assert not unused, unused
    return jm, port


def test_vqgan_encode_and_get_code_match_jax(vqgan_pair):
    """Encoder -> quant_conv -> the JAX kernel route: z_q to atol 1e-5 (it is
    a codebook row) and ids exactly equal; NHWC and NCHW inputs."""
    jm, port = vqgan_pair
    x = np.random.RandomState(9).rand(2, 32, 32, 3).astype(np.float32)
    want_zq, want_ids = jm.encode(jnp.asarray(x))
    want_code = np.asarray(jm.get_code(jnp.asarray(x)))
    nhwc = torch.from_numpy(x)
    with torch.no_grad():
        for pixels in (nhwc, nhwc.permute(0, 3, 1, 2)):
            z_q, ids = port.encode(pixels)
            assert z_q.shape == (2, 16, 16, 16) and ids.shape == (2, 256)
            np.testing.assert_allclose(z_q.numpy(), np.asarray(want_zq), rtol=0, atol=1e-5)
            np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
            np.testing.assert_array_equal(port.get_code(pixels).numpy(), want_code)


def test_vqgan_encoder_latents_match_jax(vqgan_pair):
    """The pre-quantization latents (Downsample's (0, 1, 0, 1) pad and VALID
    stride-2 conv, the down blocks' attention) to 1e-4 of their range."""
    jm, port = vqgan_pair
    x = np.random.RandomState(10).rand(1, 32, 32, 3).astype(np.float32)
    module = jm.module
    want = module.apply({"params": jm.params}, jnp.asarray(x),
                        method=lambda m, p: m.quant_conv(m.encoder(p)))
    with torch.no_grad():
        got = port._latents(torch.from_numpy(x)).numpy()
    assert np.abs(got - np.asarray(want)).max() <= 1e-4 * np.abs(np.asarray(want)).max()


@pytest.mark.parametrize("b,s,v_raw,v_lim,dtype", [
    (1, 40, 8256, 8192, torch.bfloat16),  # the research crop, raw bf16 logits
    (3, 9, 1000, 1000, torch.float32),    # no crop, vocab not lane-aligned
])
def test_fused_categorical_plain_matches_jax_kernel(b, s, v_raw, v_lim, dtype):
    """Explicit Gumbel noise: ids exactly equal, sel to rtol 1e-5 (each side
    sums its logsumexp over up to 8192 fp32 terms in its own order).  The
    JAX kernel gets the cropped fp32 logits, as its decode loop crops and
    casts before the call."""
    rs = np.random.RandomState(v_raw)
    raw = torch.from_numpy((rs.randn(b, s, v_raw) * 2).astype(np.float32)).to(dtype)
    noise = np.array(jax.random.gumbel(jax.random.PRNGKey(s), (b, s, v_lim), jnp.float32))
    want_ids, want_sel = jax_categorical(0, jnp.asarray(raw[..., :v_lim].float().numpy()),
                                         interpret=True, gumbel=jnp.asarray(noise))
    ids, sel = kernels.fused_categorical(raw, v_lim, gumbel=torch.from_numpy(noise))
    assert ids.dtype == torch.int32 and ids.shape == (b, s)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(sel.numpy(), np.asarray(want_sel), rtol=1e-5, atol=0)


def test_fused_categorical_noise_sources():
    logits = torch.randn(2, 4, 32, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        kernels.fused_categorical(logits, 32)
    with pytest.raises(ValueError):
        kernels.fused_categorical(logits, 32, gumbel=torch.zeros(2, 4, 32),
                                  generator=torch.Generator())
    draw = lambda seed: kernels.fused_categorical(  # noqa: E731
        logits, 16, generator=torch.Generator().manual_seed(seed))
    assert torch.equal(draw(1)[0], draw(1)[0])
    assert int(draw(2)[0].max()) < 16


def kernel_route_noise(key, timesteps, batch, seq, vocab):
    """The noise of the JAX CFG-free decode on its kernel route in interpret
    mode: per step ``key, sample_key, mask_key = split(key, 3)``; the kernel's
    Gumbel noise is ``gumbel(PRNGKey(randint(sample_key)), (B * S, V))``."""
    sample, mask = [], []
    for _ in range(timesteps):
        key, sample_key, mask_key = jax.random.split(key, 3)
        seed = jax.random.randint(sample_key, (), 0, 2 ** 31 - 1, jnp.int32)
        g = jax.random.gumbel(jax.random.PRNGKey(seed), (batch * seq, vocab), jnp.float32)
        sample.append(g.reshape(batch, seq, vocab))
        mask.append(jax.random.gumbel(mask_key, (batch, seq), jnp.float32))
    return (torch.from_numpy(np.array(jnp.stack(sample))),
            torch.from_numpy(np.array(jnp.stack(mask))))


def test_cfg_free_generate2_matches_jax_kernel_route():
    """guidance_scale 0: the JAX loop takes ``fused_categorical`` (interpret
    mode), the port its wrapper; same noise, token ids exactly equal, and
    no kernel launch on the CPU."""
    jm = JaxUViT(**UVIT_TINY, _defer_init=True)
    port, _ = port_of(jm, MaskGiTUViT_v2, random_params(jm, 12))
    _, ehs, cond, micro = uvit_inputs(13)
    key, timesteps = jax.random.PRNGKey(14), 3
    want = jm.generate2(jnp.asarray(ehs), jnp.asarray(cond), jnp.asarray(micro[:1]),
                        temperature=(2, 0), timesteps=timesteps, guidance_scale=0.0, key=key,
                        seq_len=16)
    noise = kernel_route_noise(key, timesteps, 2, 16, UVIT_TINY["codebook_size"])
    kernels.reset_launch_counts()
    got = port.generate2(torch.from_numpy(ehs), torch.from_numpy(cond),
                         torch.from_numpy(micro[:1]), temperature=(2, 0), timesteps=timesteps,
                         guidance_scale=0.0, noise=noise, seq_len=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert kernels.launch_counts() == {fn.__name__: 0 for fn in kernels.WRAPPERS}
