"""PyTorch port vs the JAX package, model by model, on the CPU in fp32.

Weights are drawn from a numpy seed (no zeroed layers), loaded into the JAX
model and mapped into the port with ``jax_params_to_state_dict``; the same
numpy inputs go through both.  Tolerances are stated per test: fp32 on both
sides, differing only in summation order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from open_muse_tpu.core.convert import flatten_dict, unflatten_dict
from open_muse_tpu.models.clip_text import CLIPTextEncoder as JaxCLIP
from open_muse_tpu.models.taming_vqgan import VQGANModel as JaxVQGAN
from open_muse_tpu.models.transformer_v2 import MaskGiTUViT_v2 as JaxUViT
from open_muse_tpu_torch.core.convert import jax_params_to_state_dict
from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder
from open_muse_tpu_torch.models.taming_vqgan import VQGANModel
from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2

# head_dim 64 in an even number of heads, so the port takes its fused-kernel
# path (plain versions on the CPU); tiny everything else
UVIT_TINY = dict(
    hidden_size=128, cond_embed_dim=32, micro_cond_encode_dim=8,
    micro_cond_embed_dim=40, encoder_hidden_size=48, vocab_size=68,
    mask_token_id=67, codebook_size=64, in_channels=32,
    block_out_channels=(32,), num_res_blocks=1, block_num_heads=2,
    num_hidden_layers=2, num_attention_heads=2, intermediate_size=256)
CLIP_TINY = dict(vocab_size=100, hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                 num_attention_heads=4, max_position_embeddings=16, projection_dim=32,
                 eos_token_id=99)
VQGAN_TINY = dict(resolution=32, hidden_channels=32, channel_mult=(1, 2), num_res_blocks=2,
                  attn_resolutions=(16,), z_channels=16, num_embeddings=64,
                  quantized_embed_dim=16)


def random_params(jax_model, seed):
    """Give the JAX model (built with ``_defer_init=True``) params of seeded
    noise at a sensible scale; return them as a flat numpy tree."""
    rs = np.random.RandomState(seed)
    flat = {}
    for key, leaf in flatten_dict(jax_model.params_shapes()).items():
        shape, name = np.shape(leaf), key.rsplit(".", 1)[-1]
        noise = rs.randn(*shape).astype(np.float32)
        if name == "kernel":
            noise /= np.sqrt(max(1, int(np.prod(shape[:-1]))))
        elif name == "scale":
            noise = 1.0 + 0.1 * noise
        elif name != "embedding":
            noise *= 0.1 if name in ("bias", "beta") else 0.5
        flat[key] = noise
    jax_model.params = jax.tree_util.tree_map(jnp.asarray, unflatten_dict(flat))
    return flat


def port_of(jax_model, port_cls, flat):
    """The port model with the JAX model's config and weights."""
    port = port_cls(port_cls.config_from_dict(jax_model.config.to_dict()))
    state, unused = jax_params_to_state_dict(flat, port)
    port.load_state_dict(state)
    return port.eval(), unused


def uvit_pair(seed=0, **overrides):
    jm = JaxUViT(**{**UVIT_TINY, **overrides}, _defer_init=True)
    flat = random_params(jm, seed)
    port, unused = port_of(jm, MaskGiTUViT_v2, flat)
    assert not unused, unused
    return jm, port


def uvit_inputs(seed, batch=2, seq=16):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 68, size=(batch, seq)).astype(np.int32),
            rs.randn(batch, 7, 48).astype(np.float32),
            rs.randn(batch, 32).astype(np.float32),
            np.asarray([[512, 512, 0, 0, 6.0]] * batch, np.float32))


def assert_close(got, ref, rel):
    """max |got - ref| <= rel * max |ref|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def test_uvit_forward_matches_jax_both_port_paths():
    jm, port = uvit_pair()
    ids, ehs, cond, micro = uvit_inputs(1)
    ref = jm(jnp.asarray(ids), jnp.asarray(ehs), jnp.asarray(cond), jnp.asarray(micro))
    args = (torch.from_numpy(ids).long(), torch.from_numpy(ehs), torch.from_numpy(cond),
            torch.from_numpy(micro))
    with torch.no_grad():
        for use_kernels in (True, False):
            assert_close(port(*args, use_kernels=use_kernels), ref, 1e-4)


# bf16 on both sides: max |error| <= BF16_REL x max |reference|.  The norms
# round where the JAX layers round (the model staging), but the bf16 matmuls,
# convolutions, gelu and softmax of XLA's CPU fusions round at other places
# than torch's kernels, so a few bf16 ulps build up over the layers (2.5% of
# the logits' range at most for UVIT_TINY, 1.7% for the v1 cases).
BF16_REL = 4e-2


def assert_bf16_paths_agree_and_match(port, ref, *args, **kwargs):
    """The port in bf16 on both of its paths: the kernel wrappers (plain
    versions on the CPU) and ``use_kernels=False`` give the same bits -- the
    norm wrappers' model staging is the unfused layers' staging -- and both
    are within BF16_REL of the JAX model's bf16 output."""
    with torch.no_grad():
        routed = port(*args, **kwargs)
        plain = port(*args, use_kernels=False, **kwargs)
    assert routed.dtype == torch.bfloat16 and torch.equal(routed, plain)
    assert_close(routed.float(), np.asarray(jnp.asarray(ref, jnp.float32)), BF16_REL)


def test_uvit_bf16_forward_matches_jax_and_port_paths_agree():
    jm = JaxUViT(**UVIT_TINY, dtype=jnp.bfloat16, _defer_init=True)
    port, unused = port_of(jm, MaskGiTUViT_v2, random_params(jm, 0))
    assert not unused, unused
    jm.astype(jnp.bfloat16)
    ids, ehs, cond, micro = uvit_inputs(1)
    ref = jm(jnp.asarray(ids), jnp.asarray(ehs, jnp.bfloat16), jnp.asarray(cond, jnp.bfloat16),
             jnp.asarray(micro))
    assert_bf16_paths_agree_and_match(
        port.to(torch.bfloat16), ref, torch.from_numpy(ids).long(),
        torch.from_numpy(ehs).bfloat16(), torch.from_numpy(cond).bfloat16(),
        torch.from_numpy(micro))


def test_uvit_down_up_sample_matches_jax():
    """force_down_up_sample: the stride-2 conv and the transposed conv (whose
    kernel the converter flips to torch's convolution order)."""
    jm, port = uvit_pair(seed=2, force_down_up_sample=True)
    ids, ehs, cond, micro = uvit_inputs(3, seq=64)
    ref = jm(jnp.asarray(ids), jnp.asarray(ehs), jnp.asarray(cond), jnp.asarray(micro))
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long(), torch.from_numpy(ehs),
                   torch.from_numpy(cond), torch.from_numpy(micro))
    assert_close(got, ref, 1e-4)


def test_uvit_mask_token_forced_to_vocab_end():
    port = MaskGiTUViT_v2(MaskGiTUViT_v2.config_from_dict({**UVIT_TINY, "mask_token_id": 3}))
    assert port.config.mask_token_id == UVIT_TINY["vocab_size"] - 1


def test_clip_hidden_states_and_projection_match_jax():
    jm = JaxCLIP(**CLIP_TINY, _defer_init=True)
    flat = random_params(jm, 4)
    port, unused = port_of(jm, CLIPTextEncoder, flat)
    assert not unused, unused
    ids = np.random.RandomState(5).randint(1, 90, size=(2, 16)).astype(np.int32)
    ids[0, 9:] = 99  # EOS / pad = max id: pooled at the first EOS
    ids[1, -1] = 99
    hs, last, proj = jm.encode(jnp.asarray(ids))
    with torch.no_grad():
        phs, plast, pproj = port(torch.from_numpy(ids).long())
    assert len(phs) == len(hs) == CLIP_TINY["num_hidden_layers"] + 1
    assert_close(phs[-2], hs[-2], 1e-5)
    assert_close(plast, last, 1e-5)
    assert_close(pproj, proj, 1e-5)


def test_vqgan_decode_code_matches_jax():
    jm = JaxVQGAN(**VQGAN_TINY, _defer_init=True)
    flat = random_params(jm, 6)
    port, unused = port_of(jm, VQGANModel, flat)
    assert not unused, unused  # encode and decode side
    ids = np.random.RandomState(7).randint(0, 64, size=(2, 256)).astype(np.int32)
    ref = jm.decode_code(jnp.asarray(ids))
    with torch.no_grad():
        got = port.decode_code(torch.from_numpy(ids).long())
    assert got.shape == (2, 32, 32, 3)
    assert_close(got, ref, 1e-4)
