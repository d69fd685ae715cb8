"""The serving slice, port vs JAX, on the CPU in fp32: the MaskGIT CFG decode
and text -> image under the same injected noise.

Sampling matches JAX only in distribution, so the noise is drawn with JAX
from the decode loop's own key chain (``key, sample_key, mask_key =
jax.random.split(key, 3)`` per step) and handed to the port; token ids must
then match exactly.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from open_muse_tpu.models.clip_text import CLIPTextEncoder as JaxCLIP
from open_muse_tpu.models.clip_text import SimpleTokenizer as JaxTokenizer
from open_muse_tpu.models.taming_vqgan import VQGANModel as JaxVQGAN
from open_muse_tpu.models.transformer_v2 import MaskGiTUViT_v2 as JaxUViT
from open_muse_tpu.models.transformer_v2 import decode_schedules as jax_schedules
from open_muse_tpu.pipelines.pipeline_muse import PipelineMuse as JaxPipeline
from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder, SimpleTokenizer
from open_muse_tpu_torch.models.taming_vqgan import VQGANModel
from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2, decode_schedules
from open_muse_tpu_torch.pipelines.pipeline_muse import PipelineMuse
from test_torch_models import UVIT_TINY, VQGAN_TINY, port_of, random_params

# text tower widths feed the UViT: hidden -> encoder_hidden_size, projection
# -> cond_embed_dim; the VQGAN codebook is the UViT codebook
CLIP_FOR_UVIT = dict(vocab_size=100, hidden_size=48, intermediate_size=96,
                     num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=16,
                     projection_dim=32, eos_token_id=99)


def jax_noise(key, timesteps, batch, seq, vocab):
    """The Gumbel noise the JAX decode loop draws at each step."""
    sample, mask = [], []
    for _ in range(timesteps):
        key, sample_key, mask_key = jax.random.split(key, 3)
        sample.append(jax.random.gumbel(sample_key, (batch, seq, vocab), jnp.float32))
        mask.append(jax.random.gumbel(mask_key, (batch, seq), jnp.float32))
    return (torch.from_numpy(np.array(jnp.stack(sample))),
            torch.from_numpy(np.array(jnp.stack(mask))))


@pytest.fixture(scope="module")
def pipelines():
    jt = JaxUViT(**UVIT_TINY, _defer_init=True)
    jc = JaxCLIP(**CLIP_FOR_UVIT, _defer_init=True)
    jv = JaxVQGAN(**VQGAN_TINY, _defer_init=True)
    ports = [port_of(m, cls, random_params(m, seed))[0]
             for seed, (m, cls) in enumerate(((jt, MaskGiTUViT_v2), (jc, CLIPTextEncoder),
                                              (jv, VQGANModel)))]
    jax_pipe = JaxPipeline(vae=jv, transformer=jt, text_encoder=jc,
                           tokenizer=JaxTokenizer(100, 16))
    port_pipe = PipelineMuse(vae=ports[2], transformer=ports[0], text_encoder=ports[1],
                             tokenizer=SimpleTokenizer(100, 16))
    return jax_pipe, port_pipe


def test_categorical_is_gumbel_argmax():
    """The JAX CPU decode samples with jax.random.categorical, which is
    argmax(logits + gumbel(sample_key)): the identity the injected noise
    relies on."""
    key = jax.random.PRNGKey(3)
    logits = jax.random.normal(jax.random.PRNGKey(4), (2, 16, 64))
    np.testing.assert_array_equal(
        np.asarray(jax.random.categorical(key, logits, axis=-1)),
        np.asarray(jnp.argmax(logits + jax.random.gumbel(key, logits.shape), axis=-1)))


@pytest.mark.parametrize("timesteps", [3, 12])
def test_decode_schedules_match_jax_bit_for_bit(timesteps):
    for got, want in zip(decode_schedules(timesteps, (2, 0), 8.0),
                         jax_schedules(timesteps, (2, 0), 8.0)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("guidance", [3.0, 0.0])
def test_generate2_tokens_equal_jax(pipelines, guidance):
    """With CFG (the sampling kernel's path) and without (plain sampling)."""
    jax_pipe, port_pipe = pipelines
    ids = jnp.asarray(JaxTokenizer(100, 16)(["a red fox", "two cubes"])["input_ids"])
    empty = jnp.asarray(JaxTokenizer(100, 16)([""])["input_ids"])
    hs, _, pooled = jax_pipe.text_encoder.encode(ids)
    ehs_e, _, pooled_e = jax_pipe.text_encoder.encode(empty)
    micro = jnp.asarray([[512, 512, 0, 0, 6.0]], jnp.float32)
    key = jax.random.PRNGKey(7)
    timesteps = 4
    want = jax_pipe.transformer.generate2(
        hs[-2], pooled, micro, empty_embeds=ehs_e[-2], empty_cond_embeds=pooled_e,
        temperature=(2, 0), timesteps=timesteps, guidance_scale=guidance, key=key,
        seq_len=256)
    noise = jax_noise(key, timesteps, 2, 256, UVIT_TINY["codebook_size"])
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    got = port_pipe.transformer.generate2(
        t(hs[-2]), t(pooled), t(micro), empty_embeds=t(ehs_e[-2]), empty_cond_embeds=t(pooled_e),
        temperature=(2, 0), timesteps=timesteps, guidance_scale=guidance, noise=noise,
        seq_len=256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.max()) < UVIT_TINY["codebook_size"]


def test_text2image_matches_jax_compile_text2image(pipelines):
    """Images to 1e-4 of their range (fp32 both sides; equal tokens)."""
    jax_pipe, port_pipe = pipelines
    ids = np.asarray(JaxTokenizer(100, 16)(["a photo of a cat"])["input_ids"])
    micro = np.asarray([[512, 512, 0, 0, 6.0]], np.float32)
    key = jax.random.PRNGKey(11)
    fused = jax_pipe.compile_text2image(batch_size=1, timesteps=3, guidance_scale=2.0,
                                        seq_len=256)
    want = np.asarray(fused(jnp.asarray(ids), jnp.asarray(micro), key))
    noise = jax_noise(key, 3, 1, 256, UVIT_TINY["codebook_size"])
    got = port_pipe.text2image(torch.from_numpy(ids), torch.from_numpy(micro), noise,
                               timesteps=3, guidance_scale=2.0, seq_len=256)
    assert got.shape == want.shape == (1, 32, 32, 3)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_text2image_at_the_512px_token_grid_matches_jax(pipelines):
    """A 512 px request's 32 x 32 = 1024 tokens through the port's entry
    point ``text2image(seq_len=1024)`` (on the card the flagship's trunk
    attends over 1024 keys: kernel 5's two-pass variant inside kernel 9):
    token ids exactly equal to the JAX decode's under JAX-drawn noise, the
    images to 1e-4 of their range against JAX ``compile_text2image``."""
    jax_pipe, port_pipe = pipelines
    tok = JaxTokenizer(100, 16)
    ids = np.asarray(tok(["a lighthouse at dusk"])["input_ids"])
    empty = jnp.asarray(tok([""])["input_ids"])
    micro = np.asarray([[512, 512, 0, 0, 6.0]], np.float32)
    key, steps, guidance = jax.random.PRNGKey(19), 2, 3.0
    hs, _, pooled = jax_pipe.text_encoder.encode(jnp.asarray(ids))
    ehs_e, _, pooled_e = jax_pipe.text_encoder.encode(empty)
    want_tokens = jax_pipe.transformer.generate2(
        hs[-2], pooled, jnp.asarray(micro), empty_embeds=ehs_e[-2], empty_cond_embeds=pooled_e,
        temperature=(2, 0), timesteps=steps, guidance_scale=guidance, key=key, seq_len=1024)
    fused = jax_pipe.compile_text2image(batch_size=1, timesteps=steps, guidance_scale=guidance,
                                        seq_len=1024)
    want = np.asarray(fused(jnp.asarray(ids), jnp.asarray(micro), key))
    noise = jax_noise(key, steps, 1, 1024, UVIT_TINY["codebook_size"])
    got, tokens = port_pipe.text2image(torch.from_numpy(ids), torch.from_numpy(micro), noise,
                                       timesteps=steps, guidance_scale=guidance, seq_len=1024,
                                       return_tokens=True)
    assert tokens.shape == (1, 1024)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    assert got.shape == want.shape == (1, 64, 64, 3)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_pipeline_call_with_generator(pipelines):
    """The user entry point: prompts in, PIL images out; seeded runs repeat;
    guidance 0 runs the CFG-free decode."""
    _, port_pipe = pipelines
    run = lambda: port_pipe(["a cat", "a dog"], timesteps=3, guidance_scale=4.0,  # noqa: E731
                            generator=torch.Generator().manual_seed(0),
                            transformer_seq_len=256, return_pil=False)
    images = run()
    assert images.shape == (2, 32, 32, 3) and torch.isfinite(images).all()
    assert torch.equal(images, run())
    pil = port_pipe("a cat", timesteps=2, guidance_scale=0.0,
                    generator=torch.Generator().manual_seed(1), transformer_seq_len=256)
    assert len(pil) == 1 and pil[0].size == (32, 32)
