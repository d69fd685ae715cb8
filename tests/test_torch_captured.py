"""The captured request paths and the rest of the pipeline API, port vs JAX,
on the CPU in fp32.

On the CPU ``core.captured`` runs each request eagerly, so these tests hold
what a graph replays -- the decode loops with every noise draw made before
the loop, ``return_intermediate``, v1 ``generate``, the MaskGIT VQGAN
encoder, the pipeline's embeddings, class-id and v1 inpainting and its
``from_pretrained`` / ``save_pretrained`` -- against the JAX package and
against the step-by-step loop the port ran before.  The graphs' cache keys
are read at the call sites.  Replays on the card are in
``tests/test_torch_cuda.py``.  Noise is drawn with JAX from each loop's own
key chain; token ids must then be exactly equal.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from open_muse_tpu.models.clip_text import CLIPTextEncoder as JaxCLIP
from open_muse_tpu.models.clip_text import SimpleTokenizer as JaxTokenizer
from open_muse_tpu.models.maskgit_vqgan import MaskGitVQGAN as JaxMaskGitVQGAN
from open_muse_tpu.models.taming_vqgan import VQGANModel as JaxVQGAN
from open_muse_tpu.models.transformer_v1 import MaskGitTransformer as JaxV1
from open_muse_tpu.models.transformer_v2 import MaskGiTUViT_v2 as JaxUViT
from open_muse_tpu.ops import vq as jax_vq
from open_muse_tpu.pipelines.pipeline_muse import PipelineMuse as JaxPipeline
from open_muse_tpu.pipelines.pipeline_muse import PipelineMuseInpainting as JaxInpainting
from open_muse_tpu_torch import kernels
from open_muse_tpu_torch.kernels.fused_sample import (draw_seed, fused_categorical_plain,
                                                      philox_gumbel_plain, sample_gumbel)
from open_muse_tpu_torch.models import transformer_v1, transformer_v2
from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder, SimpleTokenizer
from open_muse_tpu_torch.models.maskgit_vqgan import MaskGitVQGAN
from open_muse_tpu_torch.models.t5_text import T5TextEncoder
from open_muse_tpu_torch.models.taming_vqgan import VQGANModel
from open_muse_tpu_torch.models.transformer_v1 import MaskGitTransformer, v1_schedules
from open_muse_tpu_torch.models.transformer_v2 import (MaskGiTUViT_v2, decode_schedules,
                                                        decode_step)
from open_muse_tpu_torch.pipelines import pipeline_muse
from open_muse_tpu_torch.pipelines.pipeline_muse import PipelineMuse, PipelineMuseInpainting
from test_torch_models import (UVIT_TINY, VQGAN_TINY, assert_close, port_of, random_params,
                               uvit_inputs)
from test_torch_pipeline import CLIP_FOR_UVIT, jax_noise
from test_torch_v1 import MASKGIT_VQ_TINY, REL, V1_CASES, V1_TINY, v1_pair


def t(x):
    return torch.from_numpy(np.array(x))


def jax_generate_noise(key, timesteps, batch, seq, vocab):
    """The Gumbel noise the JAX ``generate`` draws: ``key, gkey =
    split(key)`` a step."""
    out = []
    for _ in range(timesteps):
        key, gkey = jax.random.split(key)
        out.append(jax.random.gumbel(gkey, (batch, seq, vocab), jnp.float32))
    return t(jnp.stack(out))


# -- the loops with their noise drawn before the loop ------------------------

def stepwise_v2(model, ehs, cond, micro, guidance, timesteps, generator, seq_len=16):
    """The decode as the port ran it step by step before: each step draws
    its sampler noise, then its mask noise, from the CPU generator and
    reads its temperature and mask ratio on the host."""
    cfg = model.config
    temps, scales, ratios = decode_schedules(timesteps, (2, 0), guidance)
    use_cfg = guidance > 0
    if use_cfg:
        ehs, cond, micro = (torch.cat([x, torch.zeros_like(x) if i < 2 else x])
                            for i, x in enumerate((ehs, cond, micro)))
    ctx = model.step_context(ehs, cond, micro)
    ids = torch.full((ehs.shape[0] // (2 if use_cfg else 1), seq_len), cfg.mask_token_id)
    sampled = ids
    for step in range(timesteps):
        raw = model(torch.cat([ids, ids]) if use_cfg else ids, step_ctx=ctx)
        sample = sample_gumbel((ids.shape[0], seq_len, cfg.codebook_size), generator)
        mask = sample_gumbel(ids.shape, generator)
        ids, sampled, _ = decode_step(
            raw, ids, mask_token_id=cfg.mask_token_id, codebook_size=cfg.codebook_size,
            guidance_scale=float(scales[step]) if use_cfg else None, mask_ratio=ratios[step],
            temperature=float(temps[step]), mask_gumbel=mask, sample_gumbel=sample)
    return sampled


@pytest.mark.parametrize("guidance", [3.0, 0.0])
def test_v2_noise_drawn_up_front_gives_the_stepwise_tokens(guidance):
    """``generate2`` with a generator, its noise drawn before the loop,
    against the step-by-step loop on the same generator seed: token ids
    exactly equal; no kernel launch on the CPU."""
    _, port = transformer_v2_pair(30)
    _, ehs, cond, micro = (torch.from_numpy(x) for x in uvit_inputs(31))
    want = stepwise_v2(port, ehs, cond, micro[:2], guidance, 4, torch.Generator().manual_seed(5))
    kernels.reset_launch_counts()
    got = port.generate2(ehs, cond, micro[:1], empty_embeds=torch.zeros_like(ehs[:1]),
                         empty_cond_embeds=torch.zeros_like(cond[:1]), temperature=(2, 0),
                         timesteps=4, guidance_scale=guidance, seq_len=16,
                         generator=torch.Generator().manual_seed(5))
    assert kernels.launch_counts() == {fn.__name__: 0 for fn in kernels.WRAPPERS}
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_v1_noise_drawn_up_front_gives_the_stepwise_tokens():
    """v1 ``generate2`` with class ids, as the v2 test."""
    _, port = v1_pair("imagenet_like", seed=32)
    cfg = port.config
    temps, ratios = v1_schedules(5, (2, 0))
    gen = torch.Generator().manual_seed(6)
    classes = torch.tensor([1, 3]) + cfg.codebook_size
    ids = torch.full((2, 16), cfg.mask_token_id)
    ctx = port.step_context(None)
    for step in range(5):
        raw = port(torch.cat([classes[:, None], ids], 1), step_ctx=ctx)[:, 1:].contiguous()
        sample = sample_gumbel((2, 16, cfg.codebook_size), gen)
        mask = sample_gumbel((2, 16), gen)
        ids, want, _ = decode_step(
            raw, ids, mask_token_id=cfg.mask_token_id, codebook_size=cfg.codebook_size,
            guidance_scale=None, mask_ratio=ratios[step], temperature=float(temps[step]),
            mask_gumbel=mask, sample_gumbel=sample)
    got = port.generate2(class_ids=[1, 3], temperature=(2, 0), timesteps=5,
                         generator=torch.Generator().manual_seed(6))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_seed_route_on_the_cpu_is_the_philox_stream():
    """``seed=`` (the card's route) on CPU tensors: the plain version fed
    ``philox_gumbel_plain`` of that seed, exactly."""
    logits = torch.randn(2, 5, 40, generator=torch.Generator().manual_seed(0))
    seed = draw_seed(torch.Generator().manual_seed(1))
    got = kernels.fused_categorical(logits, 32, seed=torch.tensor([seed]))
    want = fused_categorical_plain(logits, 32, philox_gumbel_plain(seed, 10, 32).reshape(2, 5, 32))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        kernels.fused_categorical(logits, 32, seed=torch.tensor([seed]),
                                  generator=torch.Generator())


def transformer_v2_pair(seed):
    jm = JaxUViT(**UVIT_TINY, _defer_init=True)
    port, unused = port_of(jm, MaskGiTUViT_v2, random_params(jm, seed))
    assert not unused
    return jm, port


@pytest.mark.parametrize("guidance", [3.0, 0.0])
def test_return_intermediate_equals_jax(guidance):
    """``generate2(return_intermediate=True)``: the final tokens and each
    step's raw samples (T, B, S), exactly equal under the JAX noise."""
    jm, port = transformer_v2_pair(33)
    _, ehs, cond, micro = uvit_inputs(34)
    key, steps = jax.random.PRNGKey(35), 3
    kwargs = dict(temperature=(2, 0), timesteps=steps, guidance_scale=guidance, seq_len=16)
    empty = dict(empty_embeds=np.zeros_like(ehs[:1]), empty_cond_embeds=np.zeros_like(cond[:1]))
    want, want_inter = jm.generate2(jnp.asarray(ehs), jnp.asarray(cond), jnp.asarray(micro[:1]),
                                    key=key, return_intermediate=True,
                                    **{k: jnp.asarray(v) for k, v in empty.items()}, **kwargs)
    got, inter = port.generate2(t(ehs), t(cond), t(micro[:1]), return_intermediate=True,
                                noise=jax_noise(key, steps, 2, 16, 64),
                                **{k: t(v) for k, v in empty.items()}, **kwargs)
    assert inter.shape == (steps, 2, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(inter.numpy(), np.asarray(want_inter))


# -- the graphs' keys -------------------------------------------------------

@pytest.fixture
def recorded_keys(monkeypatch):
    """Each ``captured`` key the call sites build, the body run eagerly."""
    keys = []

    def record(owner, key, fn, *tensors, modules=()):
        keys.append(key)
        return fn(*tensors)

    for module in (transformer_v2, transformer_v1, pipeline_muse):
        monkeypatch.setattr(module, "captured", record)
    return keys


def test_graph_keys_follow_what_a_graph_bakes_in(recorded_keys):
    """A new graph for new timesteps, guidance (or guidance schedule) and
    seq_len; the same graph for a new temperature, whose schedule is an
    input of the graph, not baked into it."""
    _, port = transformer_v2_pair(36)
    _, ehs, cond, micro = (torch.from_numpy(x) for x in uvit_inputs(37))
    empty = dict(empty_embeds=torch.zeros_like(ehs[:1]),
                 empty_cond_embeds=torch.zeros_like(cond[:1]))
    base = dict(temperature=(2, 0), timesteps=2, guidance_scale=3.0, seq_len=16)
    for change in ({}, {"temperature": 1.5}, {"timesteps": 3}, {"guidance_scale": 2.0},
                   {"guidance_schedule": "linear"}, {"seq_len": 64}):
        args = {**base, **change}
        port.generate2(ehs, cond, micro[:1], generator=torch.Generator().manual_seed(0),
                       **empty, **args)
    keys = recorded_keys
    assert keys[0] == keys[1]
    assert len(set(keys[:1] + keys[2:])) == 5, keys
    _, v1 = v1_pair("imagenet_like", seed=38)
    for steps in (2, 2, 3):
        v1.generate2(class_ids=[0], timesteps=steps, generator=torch.Generator().manual_seed(0))
    assert keys[-3] == keys[-2] != keys[-1]


# -- v1 generate and the MaskGIT VQGAN encoder --------------------------------

@pytest.mark.parametrize("case,temperature", [("imagenet_like", 4.5), ("text_rms_bias", 1.0)])
def test_v1_generate_equals_jax(case, temperature):
    """The top-k decode, class ids (no CFG) or text with CFG: token ids
    exactly equal under the JAX loop's noise."""
    jm, port = v1_pair(case, seed=39)
    key, steps = jax.random.PRNGKey(40), 5
    if case == "imagenet_like":
        inputs = dict(class_ids=np.asarray([1, 3], np.int32))
    else:
        inputs = dict(encoder_hidden_states=np.random.RandomState(41).randn(2, 5, 48)
                      .astype(np.float32))
    want = jm.generate(**{k: jnp.asarray(v) for k, v in inputs.items()}, timesteps=steps,
                       temperature=temperature, guidance_scale=2.0, key=key)
    got = port.generate(**{k: t(v) for k, v in inputs.items()}, timesteps=steps,
                        temperature=temperature, guidance_scale=2.0,
                        noise=jax_generate_noise(key, steps, 2, 16, V1_TINY["codebook_size"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.max()) < V1_TINY["codebook_size"]


@pytest.fixture
def interpret_kernels(monkeypatch):
    monkeypatch.setenv("MUSE_TPU_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("codes", [64, 1024])
def test_maskgit_vqgan_encode_and_get_code_match_jax(codes, interpret_kernels):
    """Encoder latents to 1e-4 of their range; z_q to atol 1e-5 where the
    ids agree; ids equal except where JAX's own fp32 distances to the two
    picks are equal (near-ties, as ``test_torch_encode``).  1024 codes send
    JAX to its Pallas kernel (interpret mode); NHWC and NCHW images."""
    jm = JaxMaskGitVQGAN(**{**MASKGIT_VQ_TINY, "num_embeddings": codes}, _defer_init=True)
    port, unused = port_of(jm, MaskGitVQGAN, random_params(jm, 42))
    assert not unused, unused
    x = np.random.RandomState(43).rand(2, 32, 32, 3).astype(np.float32)
    latents = np.asarray(jm.module.apply({"params": jm.params}, jnp.asarray(x),
                                         method=lambda m, p: m.encoder(p)))
    want_zq, want_ids = (np.asarray(a) for a in jm.encode(jnp.asarray(x)))
    want_code = np.asarray(jm.get_code(jnp.asarray(x)))
    np.testing.assert_array_equal(want_code, want_ids)
    d = np.asarray(jax_vq.compute_distances(jnp.asarray(latents.reshape(-1, 16)),
                                            jm.params["quantize"]["embedding"]["embedding"]))
    with torch.no_grad():
        assert_close(port._latents(t(x)), latents, REL)
        for pixels in (t(x), t(x).permute(0, 3, 1, 2)):
            z_q, ids = port.encode(pixels)
            assert z_q.shape == (2, 16, 16, 16) and ids.shape == (2, 256)
            np.testing.assert_array_equal(port.get_code(pixels).numpy(), ids.numpy())
            got, want = ids.numpy().reshape(-1), want_ids.reshape(-1)
            rows = np.nonzero(got != want)[0]
            np.testing.assert_array_equal(d[rows, got[rows]], d[rows, want[rows]])
            same = (got == want).reshape(2, 256)
            np.testing.assert_allclose(z_q.numpy()[same.reshape(2, 16, 16)],
                                       want_zq[same.reshape(2, 16, 16)], rtol=0, atol=1e-5)


# -- the pipeline API ---------------------------------------------------------

@pytest.fixture(scope="module")
def text_pipelines():
    jt = JaxUViT(**UVIT_TINY, _defer_init=True)
    jc = JaxCLIP(**CLIP_FOR_UVIT, _defer_init=True)
    jv = JaxVQGAN(**VQGAN_TINY, _defer_init=True)
    ports = [port_of(m, cls, random_params(m, seed))[0]
             for seed, (m, cls) in enumerate(((jt, MaskGiTUViT_v2), (jc, CLIPTextEncoder),
                                              (jv, VQGANModel)), start=44)]
    jax_pipe = JaxPipeline(vae=jv, transformer=jt, text_encoder=jc,
                           tokenizer=JaxTokenizer(100, 16))
    port_pipe = PipelineMuse(vae=ports[2], transformer=ports[0], text_encoder=ports[1],
                             tokenizer=SimpleTokenizer(100, 16))
    return jax_pipe, port_pipe


def test_compiled_text2image_calls_equal_jax_and_fresh_eager_calls(text_pipelines):
    """One ``compile_text2image`` function, two prompts in turn: each call's
    images within 1e-4 of the JAX program's range and of a fresh eager call
    (``fn.eager``), tokens equal to the eager call's, so nothing of one
    request stays in the next."""
    jax_pipe, port_pipe = text_pipelines
    fused = jax_pipe.compile_text2image(batch_size=1, timesteps=3, guidance_scale=2.0)
    fn = port_pipe.compile_text2image(batch_size=1, timesteps=3, guidance_scale=2.0)
    micro = np.asarray([[512, 512, 0, 0, 6.0]], np.float32)
    for i, prompt in enumerate(["a photo of a cat", "two red cubes"]):
        ids = np.asarray(JaxTokenizer(100, 16)([prompt])["input_ids"])
        key = jax.random.PRNGKey(50 + i)
        want = np.asarray(fused(jnp.asarray(ids), jnp.asarray(micro), key))
        noise = jax_noise(key, 3, 1, 256, UVIT_TINY["codebook_size"])
        images, tokens = fn(t(ids), t(micro), noise, return_tokens=True)
        eager, eager_tokens = fn.eager(t(ids), t(micro), noise, return_tokens=True)
        assert images.shape == want.shape == (1, 32, 32, 3)
        assert np.abs(images.numpy() - want).max() <= 1e-4 * np.abs(want).max()
        assert torch.equal(tokens, eager_tokens) and torch.equal(images, eager)


def test_prompt_embeds_match_jax(text_pipelines):
    """``prompt_embeds`` / ``pooled_embeds`` and the negative pair in place
    of text encoding: images within REL of the JAX pipeline's range."""
    jax_pipe, port_pipe = text_pipelines
    rs = np.random.RandomState(51)
    embeds = dict(prompt_embeds=rs.randn(2, 16, 48), pooled_embeds=rs.randn(2, 32),
                  negative_prompt_embeds=rs.randn(2, 16, 48),
                  negative_pooled_embeds=rs.randn(2, 32))
    embeds = {k: v.astype(np.float32) for k, v in embeds.items()}
    key, steps = jax.random.PRNGKey(52), 3
    common = dict(text=["a", "b"], negative_text=None, timesteps=steps, guidance_scale=3.0,
                  transformer_seq_len=256, return_pil=False)
    want = np.asarray(jax_pipe(**{k: jnp.asarray(v) for k, v in embeds.items()}, key=key,
                               **common))
    got = port_pipe(**{k: t(v) for k, v in embeds.items()},
                    noise=jax_noise(key, steps, 2, 256, UVIT_TINY["codebook_size"]), **common)
    assert got.shape == want.shape == (2, 32, 32, 3)
    assert_close(got, want, REL)


def v1_class_pipelines(seed, inpainting=False, case="imagenet_like", text=False):
    jt = JaxV1(**V1_CASES[case], _defer_init=True)
    jv = JaxMaskGitVQGAN(**MASKGIT_VQ_TINY, _defer_init=True)
    transformer = port_of(jt, MaskGitTransformer, random_params(jt, seed))[0]
    vae = port_of(jv, MaskGitVQGAN, random_params(jv, seed + 1))[0]
    extra, port_extra = {}, {}
    if text:
        jc = JaxCLIP(**CLIP_FOR_UVIT, _defer_init=True)
        extra = dict(text_encoder=jc, tokenizer=JaxTokenizer(100, 16))
        port_extra = dict(text_encoder=port_of(jc, CLIPTextEncoder, random_params(jc, seed + 2))[0],
                          tokenizer=SimpleTokenizer(100, 16))
    jcls, pcls = (JaxInpainting, PipelineMuseInpainting) if inpainting else (JaxPipeline,
                                                                            PipelineMuse)
    return (jcls(vae=jv, transformer=jt, is_class_conditioned=not text, **extra),
            pcls(vae=vae, transformer=transformer, is_class_conditioned=not text, **port_extra))


def test_use_maskgit_generate_false_matches_jax():
    """``use_maskgit_generate=False``: class ids through v1 ``generate``,
    images within REL of the JAX pipeline's range (equal tokens)."""
    jax_pipe, pipe = v1_class_pipelines(53)
    key, steps = jax.random.PRNGKey(54), 4
    common = dict(class_ids=[2, 0], timesteps=steps, temperature=4.5,
                  use_maskgit_generate=False, return_pil=False)
    want = np.asarray(jax_pipe(key=key, **common))
    got = pipe(noise=jax_generate_noise(key, steps, 2, 16, V1_TINY["codebook_size"]), **common)
    assert got.shape == want.shape == (2, 8, 8, 3)
    assert_close(got, want, REL)


@pytest.mark.parametrize("text", [False, True])
def test_v1_inpainting_matches_jax(text):
    """``PipelineMuseInpainting`` with a v1 transformer and the MaskGIT
    VQGAN: class ids, or text with CFG (no micro-conditioning, which a v1
    config does not take).  Images within REL of the JAX pipeline's range;
    tokens outside the mask stay the image's own codes."""
    jax_pipe, pipe = v1_class_pipelines(55, inpainting=True, text=text,
                                        case="text_rms_bias" if text else "imagenet_like")
    image = np.random.RandomState(56).rand(8, 8, 3).astype(np.float32)
    mask = np.zeros(16, bool)
    mask[5:11] = True
    key, steps = jax.random.PRNGKey(57), 3
    inputs = dict(text="a red fox") if text else dict(class_ids=3)
    common = dict(timesteps=steps, guidance_scale=2.0, temperature=(2, 0), return_pil=False)
    want = np.asarray(jax_pipe(image, mask, key=key, **inputs, **common))
    tokens = []
    decode = pipe.vae.decode_code
    pipe.vae.decode_code = lambda ids: (tokens.append(ids), decode(ids))[1]
    got = pipe(image, mask, noise=jax_noise(key, steps, 1, 16, V1_TINY["codebook_size"]),
               **inputs, **common)
    assert got.shape == want.shape == (1, 8, 8, 3)
    assert_close(got, want, REL)
    codes = pipe.vae.get_code(t(image)[None])
    assert torch.equal(tokens[0][:, ~torch.from_numpy(mask)], codes[:, ~torch.from_numpy(mask)])


@pytest.fixture
def offline(monkeypatch):
    """Tokenizer loading reads local files only."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")


def test_save_pretrained_round_trip_loads_in_both_packages(tmp_path, text_pipelines, offline):
    """``save_pretrained`` -> ``PipelineMuse.from_pretrained`` (the port, on
    the CPU) gives the same weights; the JAX pipeline's ``from_pretrained``
    reads the directory too, and both serve the same images (equal tokens,
    images within 1e-4 of the range).  Without tokenizer files both fall
    back to their hash tokenizers.  A T5 text encoder directory gives the
    T5 tower and the hash tokenizer at 77 tokens; a hub id raises."""
    _, port_pipe = text_pipelines
    port_pipe.save_pretrained(str(tmp_path))
    back = PipelineMuse.from_pretrained(str(tmp_path), device="cpu")
    for name in ("transformer", "text_encoder", "vae"):
        want, got = getattr(port_pipe, name).state_dict(), getattr(back, name).state_dict()
        assert want.keys() == got.keys() and all(torch.equal(want[k], got[k]) for k in want)
    assert isinstance(back.tokenizer, SimpleTokenizer) and back.device == torch.device("cpu")
    jax_back = JaxPipeline.from_pretrained(str(tmp_path))
    ids = np.asarray(JaxTokenizer(100, 16)(["a lighthouse"])["input_ids"])
    micro = np.asarray([[512, 512, 0, 0, 6.0]], np.float32)
    key = jax.random.PRNGKey(58)
    want = np.asarray(jax_back.compile_text2image(timesteps=2, guidance_scale=2.0)(
        jnp.asarray(ids), jnp.asarray(micro), key))
    got = back.text2image(t(ids), t(micro), jax_noise(key, 2, 1, 256, 64), timesteps=2,
                          guidance_scale=2.0)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    t5 = str(tmp_path / "t5")
    T5TextEncoder(vocab_size=100, d_model=48, d_kv=12, d_ff=64, num_layers=1,
                  num_heads=4).save_pretrained(t5)
    with_t5 = PipelineMuse.from_pretrained(str(tmp_path), text_encoder_path=t5, device="cpu")
    assert isinstance(with_t5.text_encoder, T5TextEncoder)
    assert with_t5.tokenizer.model_max_length == 77
    with pytest.raises(ValueError, match="local"):
        PipelineMuse.from_pretrained("openMUSE/muse-laiona6-uvit-clip-220k", device="cpu")


def test_class_conditioned_round_trip(tmp_path, offline):
    """A v1 + MaskGIT VQGAN pipeline saved and read back by both packages:
    the class-id requests give the same images."""
    jax_pipe, pipe = v1_class_pipelines(59)
    pipe.save_pretrained(str(tmp_path))
    back = PipelineMuse.from_pretrained(str(tmp_path), is_class_conditioned=True, device="cpu")
    jax_back = JaxPipeline.from_pretrained(str(tmp_path), is_class_conditioned=True)
    key = jax.random.PRNGKey(60)
    want = np.asarray(jax_back(class_ids=[1], timesteps=3, key=key, return_pil=False))
    got = back(class_ids=[1], timesteps=3, noise=jax_noise(key, 3, 1, 16, 64), return_pil=False)
    assert_close(got, want, REL)
