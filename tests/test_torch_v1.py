"""The class-conditional slice, port vs JAX, on the CPU in fp32 (and the
forward in bf16): MaskGitTransformer (v1), its MaskGIT decode under injected
noise, the MaskGIT VQGAN decoder, and the pipeline end to end with class ids
and with text.

Weights come from numpy seeds and carry across through
``jax_params_to_state_dict``.  Sampling matches JAX only in distribution, so
the decode noise is drawn with JAX from the loop's own key chain and handed
to the port; token ids must then be exactly equal.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from open_muse_tpu.models.clip_text import CLIPTextEncoder as JaxCLIP
from open_muse_tpu.models.clip_text import SimpleTokenizer as JaxTokenizer
from open_muse_tpu.models.maskgit_vqgan import MaskGitVQGAN as JaxMaskGitVQGAN
from open_muse_tpu.models.transformer_v1 import MaskGitTransformer as JaxV1
from open_muse_tpu.pipelines.pipeline_muse import PipelineMuse as JaxPipeline
from open_muse_tpu_torch import kernels
from open_muse_tpu_torch.core.convert import jax_params_to_state_dict
from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder, SimpleTokenizer
from open_muse_tpu_torch.models.maskgit_vqgan import MaskGitVQGAN
from open_muse_tpu_torch.models.transformer_v1 import MaskGitTransformer, v1_schedules
from open_muse_tpu_torch.ops.sampling import cosine_schedule
from open_muse_tpu_torch.pipelines.pipeline_muse import PipelineMuse
from test_torch_models import (assert_bf16_paths_agree_and_match, assert_close, port_of,
                               random_params)
from test_torch_pipeline import CLIP_FOR_UVIT, jax_noise

# 64 codes + 4 classes + the mask token; head_dim 16; 16 image tokens (4 x 4)
# after the class token
V1_TINY = dict(vocab_size=69, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=128, codebook_size=64, num_vq_tokens=16,
               max_position_embeddings=17, num_classes=4, hidden_dropout=0.0,
               attention_dropout=0.0, layer_norm_eps=1e-6)
V1_CASES = {
    "imagenet_like": V1_TINY,
    # RMSNorm with biases, masked cross-attention over projected text states
    "text_rms_bias": {**V1_TINY, "norm_type": "rmsnorm", "use_bias": True,
                      "add_cross_attention": True, "project_encoder_hidden_states": True,
                      "encoder_hidden_size": 48},
    # conv in / out with a 2 x 2 pixel-(un)shuffle, no Normformer norms
    "conv_patch2": {**V1_TINY, "num_classes": None, "use_conv_in_out": True, "patch_size": 2,
                    "embedding_size": 32,
                    "use_normformer": False, "max_position_embeddings": 16},
}
# the MaskGIT VQGAN at 32px, f2: level 0 widens 64 -> 32 (nin_shortcut)
MASKGIT_VQ_TINY = dict(resolution=32, hidden_channels=32, channel_mult=(1, 2), num_res_blocks=2,
                       z_channels=16, num_embeddings=64, quantized_embed_dim=16)
# fp32 on both sides, differing in summation order: max |error| <= REL x max |reference|
REL = 1e-4


def v1_pair(case, seed=0):
    jm = JaxV1(**V1_CASES[case], _defer_init=True)
    port, unused = port_of(jm, MaskGitTransformer, random_params(jm, seed))
    assert not unused, unused
    return jm, port


def vq_pair(seed=0):
    jm = JaxMaskGitVQGAN(**MASKGIT_VQ_TINY, _defer_init=True)
    port, unused = port_of(jm, MaskGitVQGAN, random_params(jm, seed))
    # the encoder is ported too: every leaf maps
    assert not unused, unused
    return jm, port


@pytest.mark.parametrize("case", sorted(V1_CASES))
def test_v1_forward_logits_and_loss_match_jax(case):
    """Both port paths (kernel wrappers, whose CPU route is the plain
    versions, and use_kernels=False); the loss over the labelled tokens."""
    cfg = V1_CASES[case]
    jm, port = v1_pair(case, seed=len(case))
    rs = np.random.RandomState(1)
    seq = cfg["num_vq_tokens"] + (0 if cfg.get("use_conv_in_out") else 1)
    ids = rs.randint(0, cfg["vocab_size"], size=(2, seq)).astype(np.int32)
    labels = rs.randint(0, cfg["codebook_size"], size=(2, seq)).astype(np.int32)
    labels[:, ::3] = -100
    args, targs = (jnp.asarray(ids),), (torch.from_numpy(ids).long(),)
    kwargs = {}
    if cfg.get("add_cross_attention"):
        ehs = rs.randn(2, 5, 48).astype(np.float32)
        mask = np.ones((2, 5), np.int32)
        mask[1, 3:] = 0
        args += (jnp.asarray(ehs),)
        targs += (torch.from_numpy(ehs),)
        kwargs = dict(encoder_attention_mask=mask)
    want_logits, want_loss = jm(*args, labels=jnp.asarray(labels),
                                **{k: jnp.asarray(v) for k, v in kwargs.items()})
    with torch.no_grad():
        for use_kernels in (True, False):
            logits, loss = port(*targs, labels=torch.from_numpy(labels).long(),
                                use_kernels=use_kernels,
                                **{k: torch.from_numpy(v) for k, v in kwargs.items()})
            assert_close(logits, want_logits, REL)
            np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)


@pytest.mark.parametrize("case", sorted(V1_CASES))
def test_v1_bf16_forward_matches_jax_and_port_paths_agree(case):
    """bf16 logits on both port paths, bit-equal to each other and within
    BF16_REL of the JAX model's (``test_torch_models``)."""
    cfg = V1_CASES[case]
    jm = JaxV1(**cfg, dtype=jnp.bfloat16, _defer_init=True)
    port, unused = port_of(jm, MaskGitTransformer, random_params(jm, len(case)))
    assert not unused, unused
    jm.astype(jnp.bfloat16)
    rs = np.random.RandomState(1)
    seq = cfg["num_vq_tokens"] + (0 if cfg.get("use_conv_in_out") else 1)
    ids = rs.randint(0, cfg["vocab_size"], size=(2, seq)).astype(np.int32)
    args, targs, kwargs, tkwargs = (jnp.asarray(ids),), (torch.from_numpy(ids).long(),), {}, {}
    if cfg.get("add_cross_attention"):
        ehs = rs.randn(2, 5, 48).astype(np.float32)
        mask = np.ones((2, 5), np.int32)
        mask[1, 3:] = 0
        args += (jnp.asarray(ehs, jnp.bfloat16),)
        targs += (torch.from_numpy(ehs).bfloat16(),)
        kwargs = dict(encoder_attention_mask=jnp.asarray(mask))
        tkwargs = dict(encoder_attention_mask=torch.from_numpy(mask))
    assert_bf16_paths_agree_and_match(port.to(torch.bfloat16), jm(*args, **kwargs), *targs,
                                      **tkwargs)


@pytest.mark.parametrize("timesteps,temperature", [(8, (2, 0)), (5, 4.5), (1, (2, 0))])
def test_v1_schedules_match_jax_bit_for_bit(timesteps, temperature):
    """The temperatures JAX's generate2 computes in fp32, bit for bit; the
    mask ratios to 1 fp32 ulp (torch's cos and XLA's round differently),
    with equal mask lengths floor(S * ratio) at S = 16 and 256."""
    ratios = (jnp.arange(timesteps, dtype=jnp.float32) + 1) / timesteps
    if isinstance(temperature, tuple):
        want_t = jnp.linspace(temperature[0], temperature[1], timesteps)
    else:
        want_t = temperature * jnp.cumprod(1.0 - ratios)
    got_t, got_r = v1_schedules(timesteps, temperature, cosine_schedule)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    want_r = np.asarray(jnp.cos(ratios * np.pi * 0.5))
    np.testing.assert_array_max_ulp(got_r.numpy(), want_r, maxulp=1)
    for s in (16, 256):
        np.testing.assert_array_equal(np.floor(np.float32(s) * got_r.numpy()),
                                      np.floor(np.float32(s) * want_r))


@pytest.mark.parametrize("temperature", [(2, 0), 4.5])
def test_v1_generate2_class_ids_equal_jax(temperature):
    """Class-conditional decode, a (start, end) and a scalar temperature:
    token ids exactly equal under the JAX loop's own noise, in the codebook,
    and no kernel launch on the CPU."""
    jm, port = v1_pair("imagenet_like", seed=3)
    class_ids = np.asarray([1, 3], np.int32)
    key, timesteps = jax.random.PRNGKey(5), 6
    want = np.asarray(jm.generate2(class_ids=jnp.asarray(class_ids), temperature=temperature,
                                   timesteps=timesteps, key=key))
    noise = jax_noise(key, timesteps, 2, 16, V1_TINY["codebook_size"])
    kernels.reset_launch_counts()
    got = port.generate2(class_ids=torch.from_numpy(class_ids), temperature=temperature,
                         timesteps=timesteps, noise=noise)
    assert kernels.launch_counts() == {fn.__name__: 0 for fn in kernels.WRAPPERS}
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.min()) >= 0 and int(got.max()) < V1_TINY["codebook_size"]


def test_v1_generate2_text_cfg_equal_jax():
    """Text-conditional decode with CFG (zero unconditional states, the
    sampler's CFG route): token ids exactly equal."""
    jm, port = v1_pair("text_rms_bias", seed=4)
    ehs = np.random.RandomState(6).randn(2, 5, 48).astype(np.float32)
    key, timesteps = jax.random.PRNGKey(7), 4
    want = np.asarray(jm.generate2(encoder_hidden_states=jnp.asarray(ehs), guidance_scale=2.0,
                                   temperature=(2, 0), timesteps=timesteps, key=key))
    noise = jax_noise(key, timesteps, 2, 16, V1_TINY["codebook_size"])
    got = port.generate2(encoder_hidden_states=torch.from_numpy(ehs), guidance_scale=2.0,
                         temperature=(2, 0), timesteps=timesteps, noise=noise)
    np.testing.assert_array_equal(got.numpy(), want)


def test_maskgit_vqgan_decode_code_matches_jax():
    jm, port = vq_pair(seed=8)
    ids = np.random.RandomState(9).randint(0, 64, size=(2, 256)).astype(np.int32)
    want = jm.decode_code(jnp.asarray(ids))
    with torch.no_grad():
        got = port.decode_code(torch.from_numpy(ids).long())
    assert got.shape == (2, 32, 32, 3)
    assert_close(got, want, REL)


def test_converter_maps_every_v1_leaf_and_jax_reads_it_back():
    """Each port key takes one leaf; the JAX loader reads the port's
    state_dict back bit for bit (open-muse key names on both sides)."""
    for case, cfg in V1_CASES.items():
        jm = JaxV1(**cfg, _defer_init=True)
        flat = random_params(jm, 10)
        port = MaskGitTransformer(MaskGitTransformer.config_from_dict(jm.config.to_dict()))
        state, unused = jax_params_to_state_dict(flat, port)
        assert not unused and len(state) == len(flat), (case, unused)
        back = JaxV1(**cfg, _defer_init=True)
        missing, unexpected = back.load_torch_weights(
            {k: v.numpy() for k, v in state.items()}, strict=False)
        assert not missing and not unexpected, (case, missing, unexpected)


def test_class_conditional_pipeline_matches_jax():
    """PipelineMuse(is_class_conditioned=True): class ids -> generate2 ->
    decode_code, images to REL of their range (equal tokens); the PIL route
    and seeded repeats on the port side."""
    jt = JaxV1(**V1_TINY, _defer_init=True)
    jv = JaxMaskGitVQGAN(**MASKGIT_VQ_TINY, _defer_init=True)
    transformer = port_of(jt, MaskGitTransformer, random_params(jt, 11))[0]
    vae = port_of(jv, MaskGitVQGAN, random_params(jv, 12))[0]
    jax_pipe = JaxPipeline(vae=jv, transformer=jt, is_class_conditioned=True)
    pipe = PipelineMuse(vae=vae, transformer=transformer, is_class_conditioned=True)
    key, timesteps = jax.random.PRNGKey(13), 4
    # 16 tokens decode to a 4 x 4 latent: 8 x 8 images at f2
    want = np.asarray(jax_pipe(class_ids=[2], timesteps=timesteps, key=key, return_pil=False))
    noise = jax_noise(key, timesteps, 1, 16, V1_TINY["codebook_size"])
    got = pipe(class_ids=[2], timesteps=timesteps, noise=noise, return_pil=False)
    assert got.shape == want.shape == (1, 8, 8, 3)
    assert_close(got, want, REL)
    run = lambda: pipe(class_ids=[0, 3], timesteps=2,  # noqa: E731
                       generator=torch.Generator().manual_seed(0), return_pil=False)
    images = run()
    assert images.shape == (2, 8, 8, 3) and torch.equal(images, run())
    pil = pipe(class_ids=1, timesteps=2, generator=torch.Generator().manual_seed(1))
    assert len(pil) == 1 and pil[0].size == (8, 8)
    with pytest.raises(ValueError):
        pipe(text="a cat", class_ids=1)


def _recording_decode(vae, seen):
    """Wrap ``vae.decode_code`` so that the token ids it is given are kept."""
    decode = vae.decode_code

    def wrapped(tokens):
        seen.append(np.asarray(tokens))
        return decode(tokens)

    vae.decode_code = wrapped


def test_text_pipeline_serves_v1_as_jax():
    """PipelineMuse(text=...) with a v1 MaskGitTransformer (cross-attention,
    RMSNorm with biases): the text tower's last hidden states, CFG against
    the empty prompt, ``generate2`` -- the reference's
    ``use_maskgit_generate=True`` -- and the MaskGIT VQGAN decode.  Token ids
    exactly equal to the JAX pipeline's under its own noise, images to REL of
    their range (fp32 both sides)."""
    jt = JaxV1(**V1_CASES["text_rms_bias"], _defer_init=True)
    jc = JaxCLIP(**CLIP_FOR_UVIT, _defer_init=True)
    jv = JaxMaskGitVQGAN(**MASKGIT_VQ_TINY, _defer_init=True)
    transformer = port_of(jt, MaskGitTransformer, random_params(jt, 14))[0]
    text_encoder = port_of(jc, CLIPTextEncoder, random_params(jc, 15))[0]
    vae = port_of(jv, MaskGitVQGAN, random_params(jv, 16))[0]
    jax_pipe = JaxPipeline(vae=jv, transformer=jt, text_encoder=jc,
                           tokenizer=JaxTokenizer(100, 16))
    pipe = PipelineMuse(vae=vae, transformer=transformer, text_encoder=text_encoder,
                        tokenizer=SimpleTokenizer(100, 16))
    want_ids, got_ids = [], []
    _recording_decode(jv, want_ids)
    _recording_decode(vae, got_ids)
    text, key, timesteps = ["a red fox", "two cubes"], jax.random.PRNGKey(17), 4
    want = np.asarray(jax_pipe(text=text, timesteps=timesteps, guidance_scale=2.0, key=key,
                               return_pil=False))
    noise = jax_noise(key, timesteps, 2, 16, V1_TINY["codebook_size"])
    got = pipe(text=text, timesteps=timesteps, guidance_scale=2.0, noise=noise,
               return_pil=False)
    np.testing.assert_array_equal(got_ids[0], want_ids[0])
    assert got.shape == want.shape == (2, 8, 8, 3)
    assert_close(got, want, REL)


# -- the MOVQ pipelines: configs/imagenet_movq.yaml and configs/cc12m_movq.yaml ----

def _movq_pair(seed):
    from open_muse_tpu.models.movq import MOVQ as JaxMOVQ
    from open_muse_tpu_torch.models.movq import MOVQ
    from test_torch_tokenizers import MOVQ_TINY

    jv = JaxMOVQ(**MOVQ_TINY, _defer_init=True)
    return jv, port_of(jv, MOVQ, random_params(jv, seed))[0]


# T5 at the width of the v1 text case's text states (encoder_hidden_size 48)
T5_FOR_V1 = dict(vocab_size=120, d_model=48, d_kv=12, d_ff=96, num_layers=2, num_heads=4,
                 feed_forward_proj="gated-gelu")


def movq_text_pipelines(seed, max_length=16):
    """The v1 text case (cross-attention, RMSNorm), a T5 tower and a MOVQ,
    in both packages, with the hash tokenizer at ``max_length``."""
    from open_muse_tpu.models.t5_text import T5TextEncoder as JaxT5
    from open_muse_tpu_torch.models.t5_text import T5TextEncoder

    jt = JaxV1(**V1_CASES["text_rms_bias"], _defer_init=True)
    jc = JaxT5(**T5_FOR_V1, _defer_init=True)
    transformer = port_of(jt, MaskGitTransformer, random_params(jt, seed))[0]
    text_encoder = port_of(jc, T5TextEncoder, random_params(jc, seed + 1))[0]
    jv, vae = _movq_pair(seed + 2)
    return (JaxPipeline(vae=jv, transformer=jt, text_encoder=jc,
                        tokenizer=JaxTokenizer(120, max_length)),
            PipelineMuse(vae=vae, transformer=transformer, text_encoder=text_encoder,
                         tokenizer=SimpleTokenizer(120, max_length)))


def test_movq_class_pipeline_matches_jax():
    """A class-id request with the MOVQ decoding the v1 tokens
    (``configs/imagenet_movq.yaml``'s pairing): token ids exactly equal to
    the JAX pipeline's under its noise, images to REL of their range."""
    jt = JaxV1(**V1_TINY, _defer_init=True)
    transformer = port_of(jt, MaskGitTransformer, random_params(jt, 100))[0]
    jv, vae = _movq_pair(101)
    jax_pipe = JaxPipeline(vae=jv, transformer=jt, is_class_conditioned=True)
    pipe = PipelineMuse(vae=vae, transformer=transformer, is_class_conditioned=True)
    want_ids, got_ids = [], []
    _recording_decode(jv, want_ids)
    _recording_decode(vae, got_ids)
    key, timesteps = jax.random.PRNGKey(102), 4
    want = np.asarray(jax_pipe(class_ids=[3, 1], timesteps=timesteps, key=key,
                               return_pil=False))
    got = pipe(class_ids=[3, 1], timesteps=timesteps, return_pil=False,
               noise=jax_noise(key, timesteps, 2, 16, V1_TINY["codebook_size"]))
    np.testing.assert_array_equal(got_ids[0], want_ids[0])
    assert got.shape == want.shape == (2, 8, 8, 3)  # 4 x 4 tokens, the MOVQ at f2
    assert_close(got, want, REL)


def test_t5_movq_text_pipeline_matches_jax():
    """A text request with a T5 tower (its last hidden state, no pooled
    output), CFG against the empty prompt and the MOVQ decode
    (``configs/cc12m_movq.yaml``'s pairing): token ids exactly equal to the
    JAX pipeline's under its noise, images to REL of their range."""
    jax_pipe, pipe = movq_text_pipelines(103)
    want_ids, got_ids = [], []
    _recording_decode(jax_pipe.vae, want_ids)
    _recording_decode(pipe.vae, got_ids)
    text, key, timesteps = ["a red fox", "two cubes"], jax.random.PRNGKey(104), 4
    want = np.asarray(jax_pipe(text=text, timesteps=timesteps, guidance_scale=2.0, key=key,
                               return_pil=False))
    got = pipe(text=text, timesteps=timesteps, guidance_scale=2.0, return_pil=False,
               noise=jax_noise(key, timesteps, 2, 16, V1_TINY["codebook_size"]))
    np.testing.assert_array_equal(got_ids[0], want_ids[0])
    assert got.shape == want.shape == (2, 8, 8, 3)
    assert_close(got, want, REL)


def test_jax_saved_t5_movq_pipeline_loads_in_the_port(tmp_path, monkeypatch):
    """The JAX pipeline's ``save_pretrained`` directory (flax weights, the
    JAX configs) read by the port's ``from_pretrained``: the T5 tower told
    apart by its ``_class_name``, the MOVQ by its own, no tokenizer files so
    the hash tokenizer at 77 tokens, as the JAX pipeline falls back to; the
    same tokens and images as the JAX pipeline.  The port's own directory
    then round-trips: the port reads it back, and so does the JAX
    pipeline (T5 by the HF ``architectures``)."""
    from open_muse_tpu_torch.models.movq import MOVQ
    from open_muse_tpu_torch.models.t5_text import T5TextEncoder

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    jax_pipe, _ = movq_text_pipelines(105, max_length=77)
    jax_pipe.save_pretrained(str(tmp_path / "jax"))
    back = PipelineMuse.from_pretrained(str(tmp_path / "jax"), device="cpu")
    assert isinstance(back.text_encoder, T5TextEncoder) and isinstance(back.vae, MOVQ)
    assert isinstance(back.tokenizer, SimpleTokenizer)
    assert (back.tokenizer.vocab_size, back.tokenizer.model_max_length) == (120, 77)
    key, timesteps = jax.random.PRNGKey(106), 3
    noise = jax_noise(key, timesteps, 1, 16, V1_TINY["codebook_size"])
    want = np.asarray(jax_pipe(text="a lighthouse", timesteps=timesteps, guidance_scale=2.0,
                               key=key, return_pil=False))
    got = back(text="a lighthouse", timesteps=timesteps, guidance_scale=2.0, noise=noise,
               return_pil=False)
    assert_close(got, want, REL)
    back.save_pretrained(str(tmp_path / "port"))
    again = PipelineMuse.from_pretrained(str(tmp_path / "port"), device="cpu")
    for name in ("transformer", "text_encoder", "vae"):
        a, b = getattr(back, name).state_dict(), getattr(again, name).state_dict()
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a), name
    jax_again = JaxPipeline.from_pretrained(str(tmp_path / "port"))
    assert type(jax_again.text_encoder).__name__ == "T5TextEncoder"
    assert type(jax_again.vae).__name__ == "MOVQ"
    assert_close(np.asarray(jax_again(text="a lighthouse", timesteps=timesteps,
                                      guidance_scale=2.0, key=key, return_pil=False)), want, REL)
