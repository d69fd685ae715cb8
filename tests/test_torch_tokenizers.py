"""The MOVQ and Paella VQ tokenizers, port vs the JAX package, on the CPU in fp32.

Weights are drawn from a numpy seed into the JAX model and carried into the
port by ``jax_params_to_state_dict``; the same numpy images go through both.
Code ids are compared tie-aware: where the two sides pick different codes,
JAX's own fp32 distances to both picks must be equal (the port's argmin
drops |z|^2, JAX's ``l2`` metric takes a square root).  Decodes within atol
5e-4 / rtol 1e-3, the tolerance of ``tests/test_vq_models.py``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from open_muse_tpu.core.convert import unflatten_dict
from open_muse_tpu.models.movq import MOVQ as JaxMOVQ
from open_muse_tpu.models.paella_vq import PaellaVQModel as JaxPaella
from open_muse_tpu.ops import vq as jax_vq
from open_muse_tpu_torch.models.movq import MOVQ
from open_muse_tpu_torch.models.paella_vq import PaellaVQModel
from test_torch_models import port_of, random_params

MOVQ_TINY = dict(resolution=32, hidden_channels=32, channel_mult=(1, 2), num_res_blocks=2,
                 attn_resolutions=(16,), z_channels=4, num_embeddings=64, quantized_embed_dim=4)
PAELLA_TINY = dict(levels=2, bottleneck_blocks=2, c_hidden=64, c_latent=4, codebook_size=64)
DECODE_TOL = dict(atol=5e-4, rtol=1e-3)


def movq_pair(seed, **overrides):
    jm = JaxMOVQ(**{**MOVQ_TINY, **overrides}, _defer_init=True)
    port, unused = port_of(jm, MOVQ, random_params(jm, seed))
    assert not unused, unused
    return jm, port


def paella_pair(seed):
    """Seeded weights with BatchNorm statistics away from (0, 1): the
    running mean in [-0.5, 0.5), the running variance in [0.5, 1.5)."""
    jm = JaxPaella(**PAELLA_TINY, _defer_init=True)
    flat = random_params(jm, seed)
    rs = np.random.RandomState(seed + 1)
    for key in flat:
        if key.endswith("running_mean"):
            flat[key] = rs.uniform(-0.5, 0.5, flat[key].shape).astype(np.float32)
        elif key.endswith("running_var"):
            flat[key] = rs.uniform(0.5, 1.5, flat[key].shape).astype(np.float32)
    jm.params = jax.tree_util.tree_map(jnp.asarray, unflatten_dict(flat))
    port, unused = port_of(jm, PaellaVQModel, flat)
    assert not unused, unused
    return jm, port


def assert_ids_match(got, want, latents, codebook):
    """``got`` equal to ``want`` except where JAX's fp32 distances from the
    latent to both codes are equal."""
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    rows = np.nonzero(got != want)[0]
    if len(rows):
        d = np.asarray(jax_vq.compute_distances(jnp.asarray(latents), jnp.asarray(codebook),
                                                "l2"))
        np.testing.assert_array_equal(d[rows, got[rows]], d[rows, want[rows]])
    assert len(rows) <= 2, rows


def _images(seed, batch, res):
    return np.random.RandomState(seed).rand(batch, res, res, 3).astype(np.float32)


@pytest.mark.parametrize("num_res_blocks", [1, 2])
def test_movq_matches_jax(num_res_blocks):
    """``get_code`` (NHWC and NCHW) ids, ``decode_code`` of JAX's ids and
    ``decode(encode(x))``; one res block leaves the encoder's attention
    built but unused, as the reference does."""
    jm, port = movq_pair(70 + num_res_blocks, num_res_blocks=num_res_blocks)
    x = _images(72, 2, 32)
    want_ids = np.asarray(jm.get_code(jnp.asarray(x)))
    latents = jm.module.apply({"params": jm.params}, jnp.asarray(x),
                              method=lambda m, p: m.quant_conv(m.encoder(p)))
    codebook = jm.params["quantize"]["embedding"]["embedding"]
    with torch.no_grad():
        for pixels in (torch.from_numpy(x), torch.from_numpy(x).permute(0, 3, 1, 2)):
            got_ids = port.get_code(pixels)
            assert got_ids.shape == (2, 256) and got_ids.dtype == torch.int64
            assert_ids_match(got_ids, want_ids, latents.reshape(-1, 4), codebook)
        got = port.decode_code(torch.from_numpy(want_ids.astype(np.int64)))
        want = np.asarray(jm.decode_code(jnp.asarray(want_ids)))
        assert got.shape == (2, 32, 32, 3)
        np.testing.assert_allclose(got.numpy(), want, **DECODE_TOL)
        z_q, ids = port.encode(torch.from_numpy(x))
        want_zq, want_enc_ids = jm.encode(jnp.asarray(x))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_enc_ids))
        np.testing.assert_allclose(port.decode(z_q).numpy(), np.asarray(jm.decode(want_zq)),
                                   **DECODE_TOL)
    attn = port.encoder.down[1].attn
    assert len(attn) == num_res_blocks  # built either way; applied only with two


def test_paella_matches_jax():
    """``get_code`` ids tie-aware, ``decode_code`` (no rescaling) of JAX's
    ids and ``decode(encode(x))`` (z_q / scale_factor, then * scale_factor)
    through the BatchNorm's statistics and the stride-2 ConvTranspose."""
    jm, port = paella_pair(80)
    x = _images(81, 2, 32)
    want_ids = np.asarray(jm.get_code(jnp.asarray(x)))
    latents = jm.module.apply({"params": jm.params}, jnp.asarray(x),
                              method=lambda m, p: m._encode_latent(p))
    codebook = jm.params["vquantizer"]["codebook"]["embedding"]
    with torch.no_grad():
        got_ids = port.get_code(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert got_ids.shape == (2, 64)  # 32 px: PixelUnshuffle 2, one stride-2 level
        assert_ids_match(got_ids, want_ids, latents.reshape(-1, 4), codebook)
        got = port.decode_code(torch.from_numpy(want_ids.astype(np.int64)))
        want = np.asarray(jm.decode_code(jnp.asarray(want_ids)))
        assert got.shape == (2, 32, 32, 3)
        np.testing.assert_allclose(got.numpy(), want, **DECODE_TOL)
        z_q, ids = port.encode(torch.from_numpy(x))
        want_zq, want_enc_ids = jm.encode(jnp.asarray(x))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_enc_ids))
        np.testing.assert_allclose(z_q.numpy(), np.asarray(want_zq), rtol=0, atol=1e-5)
        np.testing.assert_allclose(port.decode(z_q).numpy(), np.asarray(jm.decode(want_zq)),
                                   **DECODE_TOL)
    bn = port.down_blocks[-1][1]
    assert not torch.equal(bn.running_mean, torch.zeros(4))
    port.train()  # inference-only: training mode still reads the running statistics
    with torch.no_grad():
        np.testing.assert_array_equal(port.get_code(torch.from_numpy(x)).numpy(),
                                      got_ids.numpy())


def test_paella_conv_transpose_is_not_flipped():
    """The stride-2 ConvTranspose is built in flax with
    ``transpose_kernel=True``: its kernel maps to torch's weight transposed
    and not flipped in space.  The flipped mapping (the converter's rule for
    v2's ``upsample_1``) gives a different decode, so the decode test above
    decides between the two."""
    jm, port = paella_pair(82)
    ids = torch.from_numpy(np.random.RandomState(83).randint(0, 64, (1, 64)))
    convt, = [m for m in port.up_blocks if isinstance(m, torch.nn.ConvTranspose2d)]
    assert convt.flax_transpose_kernel
    with torch.no_grad():
        good = port.decode_code(ids)
        convt.weight.copy_(convt.weight.flip(2, 3))
        flipped = port.decode_code(ids)
    want = np.asarray(jm.decode_code(jnp.asarray(ids.numpy())))
    np.testing.assert_allclose(good.numpy(), want, **DECODE_TOL)
    assert np.abs(flipped.numpy() - want).max() > 100 * DECODE_TOL["atol"]
