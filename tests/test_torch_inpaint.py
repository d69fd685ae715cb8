"""Inpainting and pre-encoding, port vs JAX, on the CPU in fp32.

``PipelineMuseInpainting`` against the JAX pipeline under the same injected
noise, and ``python -m open_muse_tpu_torch.scripts.pre_encode`` against
``scripts/pre_encode.py`` on one tiny shard, with checkpoints the port's
``save_pretrained`` writes and the JAX loader reads.
"""

import io
import os
import sys
import tarfile

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from open_muse_tpu.models.clip_text import CLIPTextEncoder as JaxCLIP
from open_muse_tpu.models.clip_text import SimpleTokenizer as JaxTokenizer
from open_muse_tpu.models.taming_vqgan import VQGANModel as JaxVQGAN
from open_muse_tpu.models.transformer_v2 import MaskGiTUViT_v2 as JaxUViT
from open_muse_tpu.pipelines.pipeline_muse import PipelineMuseInpainting as JaxInpainting
from open_muse_tpu_torch import kernels
from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder, SimpleTokenizer
from open_muse_tpu_torch.models.taming_vqgan import VQGANModel
from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2
from open_muse_tpu_torch.pipelines.pipeline_muse import PipelineMuseInpainting
from open_muse_tpu_torch.scripts import pre_encode
from open_muse_tpu_torch.training.data import PreEncodedDataset
from open_muse_tpu_torch.training.train_muse import prepare_batch
from open_muse_tpu_torch.utils.config import Config
from test_torch_models import CLIP_TINY, UVIT_TINY, VQGAN_TINY, port_of, random_params
from test_torch_pipeline import CLIP_FOR_UVIT, jax_noise

# a 16 x 16 token map: repaint the centre 8 x 8
MASK = np.zeros((16, 16), bool)
MASK[4:12, 4:12] = True


def _image(seed, size=40):
    from PIL import Image

    return Image.fromarray((np.random.RandomState(seed).rand(size, size, 3) * 255)
                           .astype(np.uint8))


@pytest.fixture(scope="module")
def pipelines():
    jt = JaxUViT(**UVIT_TINY, _defer_init=True)
    jc = JaxCLIP(**CLIP_FOR_UVIT, _defer_init=True)
    jv = JaxVQGAN(**VQGAN_TINY, _defer_init=True)
    ports = [port_of(m, cls, random_params(m, seed))[0]
             for seed, (m, cls) in enumerate(((jt, MaskGiTUViT_v2), (jc, CLIPTextEncoder),
                                              (jv, VQGANModel)), start=20)]
    jax_pipe = JaxInpainting(vae=jv, transformer=jt, text_encoder=jc,
                             tokenizer=JaxTokenizer(100, 16))
    port_pipe = PipelineMuseInpainting(vae=ports[2], transformer=ports[0],
                                       text_encoder=ports[1], tokenizer=SimpleTokenizer(100, 16))
    return jax_pipe, port_pipe


def test_inpainting_call_matches_jax(pipelines):
    """A PIL image resized and centre-cropped, the centre 8 x 8 tokens
    repainted under CFG: token ids exactly equal (captured at the VQGAN
    decode), images to atol 1e-4 (fp32 both sides)."""
    jax_pipe, port_pipe = pipelines
    key, timesteps = jax.random.PRNGKey(21), 3
    captured = []
    jax_decode = jax_pipe.vae.decode_code
    jax_pipe.vae.decode_code = lambda t: (captured.append(np.asarray(t)), jax_decode(t))[1]
    try:
        want = np.asarray(jax_pipe(_image(0), MASK, "a red fox", timesteps=timesteps,
                                   guidance_scale=3.0, key=key, image_size=32,
                                   return_pil=False))
    finally:
        del jax_pipe.vae.decode_code
    noise = jax_noise(key, timesteps, 1, 256, UVIT_TINY["codebook_size"])
    port_tokens = []
    port_pipe.vae.decode_code = lambda t: (port_tokens.append(t),
                                           VQGANModel.decode_code(port_pipe.vae, t))[1]
    try:
        got = port_pipe(_image(0), MASK, "a red fox", timesteps=timesteps, guidance_scale=3.0,
                        noise=noise, image_size=32, return_pil=False)
    finally:
        del port_pipe.vae.decode_code
    np.testing.assert_array_equal(port_tokens[0].numpy(), captured[0])
    assert got.shape == want.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_inpaint_entry_point_matches_jax(pipelines):
    """The serving entry point ``inpaint`` (what ``chip_smoke.py`` drives) fed
    what the JAX ``__call__`` builds: the same pixels, mask, tokenized prompt
    and micro-conds, noise from the same key.  Token ids exactly equal,
    images to atol 1e-4 (fp32 both sides)."""
    jax_pipe, port_pipe = pipelines
    key, timesteps = jax.random.PRNGKey(23), 3
    captured = []
    jax_decode = jax_pipe.vae.decode_code
    jax_pipe.vae.decode_code = lambda t: (captured.append(np.asarray(t)), jax_decode(t))[1]
    try:
        want = np.asarray(jax_pipe(_image(2), MASK, "a blue bird", timesteps=timesteps,
                                   guidance_scale=3.0, temperature=(2, 0), key=key,
                                   image_size=32, return_pil=False))
    finally:
        del jax_pipe.vae.decode_code
    pixels = torch.from_numpy(np.array(jax_pipe._preprocess_image(_image(2), 32)))
    ids = torch.as_tensor(SimpleTokenizer(100, 16)(["a blue bird"])["input_ids"]).long()
    micro = torch.tensor([[256.0, 256.0, 0.0, 0.0, 6.0]])  # the JAX call's defaults
    noise = jax_noise(key, timesteps, 1, 256, UVIT_TINY["codebook_size"])
    tokens = []
    port_pipe.vae.decode_code = lambda t: (tokens.append(t),
                                           VQGANModel.decode_code(port_pipe.vae, t))[1]
    try:
        got = port_pipe.inpaint(pixels, MASK, ids, micro, noise, timesteps=timesteps,
                                guidance_scale=3.0, temperature=(2, 0))
    finally:
        del port_pipe.vae.decode_code
    np.testing.assert_array_equal(tokens[0].numpy(), captured[0])
    assert got.shape == want.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_inpaint_entry_point_keeps_unmasked_tokens(pipelines):
    """``inpaint`` (tokenized text, NHWC or NCHW pixels): tokens outside the
    mask are the image's own codes; seeded runs repeat; nothing launches on
    the CPU."""
    _, port_pipe = pipelines
    pixels = PipelineMuseInpainting._preprocess_image(_image(1), 32)
    ids = torch.as_tensor(SimpleTokenizer(100, 16)(["a cube"])["input_ids"]).long()
    micro = torch.tensor([[256.0, 256.0, 0.0, 0.0, 6.0]])
    codes = port_pipe.vae.get_code(pixels)
    tokens = []
    port_pipe.vae.decode_code = lambda t: (tokens.append(t),
                                           VQGANModel.decode_code(port_pipe.vae, t))[1]
    kernels.reset_launch_counts()
    try:
        for layout in (pixels, pixels.permute(0, 3, 1, 2)):
            images = port_pipe.inpaint(layout, MASK, ids, micro,
                                       torch.Generator().manual_seed(3), timesteps=4)
            assert images.shape == (1, 32, 32, 3) and torch.isfinite(images).all()
    finally:
        del port_pipe.vae.decode_code
    keep = torch.from_numpy(~MASK.reshape(1, -1))
    assert torch.equal(tokens[0][keep], codes[keep])
    assert torch.equal(tokens[0], tokens[1])
    assert int(tokens[0].max()) < UVIT_TINY["codebook_size"]
    assert kernels.launch_counts() == {fn.__name__: 0 for fn in kernels.WRAPPERS}


# -- pre-encoding -------------------------------------------------------------

CLIP_PRE = {**CLIP_TINY, "hidden_size": 48, "num_attention_heads": 4}


def _caption_shard(tmp_path, n=4):
    """Raw image + caption samples as ``scripts/convert_datasets_to_wds.py``
    writes them."""
    from scripts.convert_datasets_to_wds import main as convert_main

    src = tmp_path / "imgs"
    src.mkdir()
    for i in range(n):
        _image(i).save(src / f"img{i:03d}.png")
        (src / f"img{i:03d}.txt").write_text(f"caption number {i}")
    pattern = str(tmp_path / "raw" / "d-%05d.tar")
    convert_main(["--input", str(src), "--output", pattern, "--mode", "caption",
                  "--samples-per-shard", str(n)])
    return pattern % 0


def _members(path):
    out = {}
    with tarfile.open(path) as tf:
        for m in tf.getmembers():
            data = tf.extractfile(m).read()
            out[m.name] = np.load(io.BytesIO(data)) if m.name.endswith(".npy") else data
    return out


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A tiny taming VQGAN and CLIP tower, saved by the port's
    ``save_pretrained`` (the JAX configs' fields)."""
    root = tmp_path_factory.mktemp("ckpt")
    for name, jax_cls, port_cls, cfg, seed in (
            ("vq", JaxVQGAN, VQGANModel, VQGAN_TINY, 30), ("clip", JaxCLIP, CLIPTextEncoder,
                                                         CLIP_PRE, 31)):
        jm = jax_cls(**cfg, _defer_init=True)
        port, _ = port_of(jm, port_cls, random_params(jm, seed))
        port.save_pretrained(str(root / name))
    return str(root / "vq"), str(root / "clip")


def test_save_pretrained_loads_in_jax_and_port(checkpoints):
    vq_dir, clip_dir = checkpoints
    port = VQGANModel.from_pretrained(vq_dir, device="cpu")
    jm = JaxVQGAN.from_pretrained(vq_dir)
    x = np.random.RandomState(5).rand(1, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        got = port.get_code(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jm.get_code(jnp.asarray(x))))
    clip = CLIPTextEncoder.from_pretrained(clip_dir, device="cpu")
    assert clip.config == CLIPTextEncoder.config_from_dict(CLIP_PRE)
    assert JaxCLIP.from_pretrained(clip_dir).config.hidden_size == 48


def test_pre_encode_matches_jax_script(tmp_path, checkpoints, monkeypatch):
    """Same shard, same checkpoints: ``vq_f16.npy`` exactly equal, the fp16
    CLIP members to atol 1e-3 (fp16 rounding of fp32 states that agree to
    ~1e-6); every member has the JAX script's name, shape and dtype; the
    output reads back through ``PreEncodedDataset`` and ``prepare_batch``."""
    from scripts.pre_encode import main as jax_main

    # the JAX script tries transformers.AutoTokenizer first; without it, it
    # takes the same hash tokenizer as the port does for a directory with no
    # tokenizer files
    monkeypatch.setitem(sys.modules, "transformers", None)
    vq_dir, clip_dir = checkpoints
    shard = _caption_shard(tmp_path)
    common = ["--shards", shard, "--vae-f16", vq_dir, "--text-encoder", clip_dir,
              "--batch-size", "3", "--resolution", "32"]
    jax_main(common + ["--output-dir", str(tmp_path / "jax"), "--task-id", "0",
                       "--num-tasks", "1"])
    stats = pre_encode.main(common + ["--output-dir", str(tmp_path / "port"),
                                      "--device", "cpu"])
    assert stats["n_samples"] == 4 and stats["n_batches"] == 2  # one full batch, a tail of 1
    want = _members(str(tmp_path / "jax" / os.path.basename(shard)))
    got = _members(str(tmp_path / "port" / os.path.basename(shard)))
    assert sorted(got) == sorted(want) and len(got) == 4 * 5  # 3 .npy, .txt, .json each
    for name, ref in want.items():
        mine = got[name]
        if not name.endswith(".npy"):
            assert mine == ref, name
            continue
        assert (mine.shape, mine.dtype) == (ref.shape, ref.dtype), name
        if name.endswith("vq_f16.npy"):
            assert mine.shape == (256,) and mine.dtype == np.int32
            np.testing.assert_array_equal(mine, ref, err_msg=name)
        else:
            assert mine.dtype == np.float16
            np.testing.assert_allclose(mine.astype(np.float32), ref.astype(np.float32),
                                       rtol=0, atol=1e-3, err_msg=name)

    out = str(tmp_path / "port" / os.path.basename(shard))
    batch = next(iter(PreEncodedDataset(out, 2, shuffle_buffer_size=4)))
    config = Config({"training": {}})
    tensors = prepare_batch(batch, config, CLIP_PRE["projection_dim"], torch.device("cpu"))
    assert tensors["image_tokens"].shape == (2, 256)
    assert tensors["encoder_hidden_states"].shape == (2, 16, 48)
    assert tensors["cond_embeds"].shape == (2, 32)


def test_pre_encode_maskgit_vqgan_matches_jax_script(tmp_path, monkeypatch):
    """A tiny seeded MaskGIT VQGAN checkpoint: ``vq_f16.npy`` of the port's
    pre-encode equal to the JAX script's, except where JAX's own fp32
    distances from the latent to the two picks are equal (near-ties, as
    ``test_torch_captured`` compares the encoder); members named, shaped and
    typed alike.  1024 codes send JAX to its Pallas kernel (interpret mode)."""
    from scripts.pre_encode import main as jax_main
    from open_muse_tpu.models.maskgit_vqgan import MaskGitVQGAN as JaxMaskGitVQGAN
    from open_muse_tpu.ops import vq as jax_vq
    from open_muse_tpu_torch.models.maskgit_vqgan import MaskGitVQGAN
    from open_muse_tpu_torch.training.data import decode_sample, image_transform, tar_samples
    from test_torch_v1 import MASKGIT_VQ_TINY

    monkeypatch.setenv("MUSE_TPU_PALLAS_INTERPRET", "1")
    jm = JaxMaskGitVQGAN(**{**MASKGIT_VQ_TINY, "num_embeddings": 1024}, _defer_init=True)
    port, _ = port_of(jm, MaskGitVQGAN, random_params(jm, 33))
    vq_dir = str(tmp_path / "maskgit")
    port.save_pretrained(vq_dir)
    shard = _caption_shard(tmp_path)
    common = ["--shards", shard, "--vae-f16", vq_dir, "--batch-size", "3", "--resolution", "32"]
    jax_main(common + ["--output-dir", str(tmp_path / "jax"), "--task-id", "0",
                       "--num-tasks", "1"])
    stats = pre_encode.main(common + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert stats["n_samples"] == 4
    want = _members(str(tmp_path / "jax" / os.path.basename(shard)))
    got = _members(str(tmp_path / "port" / os.path.basename(shard)))
    assert sorted(got) == sorted(want) and len(got) == 4 * 3  # vq_f16.npy, .txt, .json each
    jm = JaxMaskGitVQGAN.from_pretrained(vq_dir)
    codebook = jm.params["quantize"]["embedding"]["embedding"]
    images = {s["__key__"]: s["image"] for s in map(decode_sample, tar_samples(shard))}
    assert len(images) == 4
    for key, image in images.items():
        name = f"{key}.vq_f16.npy"
        mine, ref = got[name], want[name]
        assert (mine.shape, mine.dtype) == (ref.shape, ref.dtype) == ((256,), np.int32), name
        pixels = image_transform(image, 32, center_crop=True)[0][None]
        latents = jm.module.apply({"params": jm.params}, jnp.asarray(pixels),
                                  method=lambda m, p: m.encoder(p))
        d = np.asarray(jax_vq.compute_distances(latents.reshape(-1, latents.shape[-1]),
                                                codebook))
        rows = np.nonzero(mine != ref)[0]
        np.testing.assert_array_equal(d[rows, mine[rows]], d[rows, ref[rows]], err_msg=name)
        assert len(rows) <= 2, (name, rows)


def test_pre_encode_rejects_what_is_not_ported(tmp_path, checkpoints):
    """A checkpoint whose config names no tokenizer the port has (told
    apart by its ``_class_name``) raises, naming the class; MOVQ and Paella
    directories are taken (here without weights, so their loading raises)."""
    base = ["--shards", "none.tar", "--output-dir", str(tmp_path / "o"), "--device", "cpu"]
    for name in ("VQVAE2", "MOVQ", "PaellaVQModel"):
        directory = tmp_path / name
        directory.mkdir()
        (directory / "config.json").write_text(f'{{"_class_name": "{name}"}}')
    with pytest.raises(ValueError, match="VQVAE2"):
        pre_encode.main(base + ["--vae-f16", str(tmp_path / "VQVAE2")])
    with pytest.raises(OSError, match="no model weights"):
        pre_encode.main(base + ["--vae-f16", str(tmp_path / "MOVQ")])
    with pytest.raises(OSError, match="no model weights"):
        pre_encode.main(base + ["--vae-f16", checkpoints[0], "--vae-f8",
                                str(tmp_path / "PaellaVQModel")])


def test_pre_encode_vae_f8_matches_jax_script(tmp_path, monkeypatch):
    """A tiny seeded MOVQ as ``--vae-f16`` and a Paella as ``--vae-f8``, both
    written by the port's ``save_pretrained``: ``vq_f16.npy`` and
    ``vq_f8.npy`` of the port's pre-encode equal to the JAX script's except
    where JAX's own fp32 distances from the latent to the two picks are
    equal (near-ties, as ``tests/test_torch_tokenizers.py`` compares); the
    same members, shapes and dtypes."""
    from scripts.pre_encode import main as jax_main
    from open_muse_tpu.models.movq import MOVQ as JaxMOVQ
    from open_muse_tpu.models.paella_vq import PaellaVQModel as JaxPaella
    from open_muse_tpu_torch.training.data import decode_sample, image_transform, tar_samples
    from test_torch_tokenizers import assert_ids_match, movq_pair, paella_pair

    monkeypatch.setitem(sys.modules, "transformers", None)
    dirs = {"f16": str(tmp_path / "movq"), "f8": str(tmp_path / "paella")}
    movq_pair(34)[1].save_pretrained(dirs["f16"])
    paella_pair(35)[1].save_pretrained(dirs["f8"])
    shard = _caption_shard(tmp_path)
    common = ["--shards", shard, "--vae-f16", dirs["f16"], "--vae-f8", dirs["f8"],
              "--batch-size", "3", "--resolution", "32"]
    jax_main(common + ["--output-dir", str(tmp_path / "jax"), "--task-id", "0",
                       "--num-tasks", "1"])
    stats = pre_encode.main(common + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert stats["n_samples"] == 4
    want = _members(str(tmp_path / "jax" / os.path.basename(shard)))
    got = _members(str(tmp_path / "port" / os.path.basename(shard)))
    assert sorted(got) == sorted(want) and len(got) == 4 * 4  # vq_f16, vq_f8, .txt, .json
    models = {"f16": JaxMOVQ.from_pretrained(dirs["f16"]),
              "f8": JaxPaella.from_pretrained(dirs["f8"])}
    latents_of = {"f16": lambda m, p: m.quant_conv(m.encoder(p)),
                  "f8": lambda m, p: m._encode_latent(p)}
    codebooks = {"f16": models["f16"].params["quantize"]["embedding"]["embedding"],
                 "f8": models["f8"].params["vquantizer"]["codebook"]["embedding"]}
    for sample in map(decode_sample, tar_samples(shard)):
        pixels = jnp.asarray(image_transform(sample["image"], 32, center_crop=True)[0][None])
        for kind, tokens in (("f16", 256), ("f8", 64)):
            name = f"{sample['__key__']}.vq_{kind}.npy"
            mine, ref = got[name], want[name]
            assert (mine.shape, mine.dtype) == (ref.shape, ref.dtype) == ((tokens,), np.int32)
            jm = models[kind]
            latents = jm.module.apply({"params": jm.params}, pixels, method=latents_of[kind])
            assert_ids_match(mine, ref, latents.reshape(-1, 4), codebooks[kind])


def test_entry_points_default_to_cuda(checkpoints):
    """Without CUDA, an entry point given no device raises instead of moving
    to the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device works")
    from open_muse_tpu_torch.training.train_muse import main as train_main

    vq_dir, _ = checkpoints
    with pytest.raises(RuntimeError, match="CUDA"):
        VQGANModel.from_pretrained(vq_dir)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main([f"config={os.path.join(os.path.dirname(os.path.dirname(__file__)), 'configs', 'laiona6plus_uvit_clip.yaml')}"])
    with pytest.raises(RuntimeError, match="CUDA"):
        pre_encode.main(["--shards", "x.tar", "--output-dir", "unused", "--vae-f16", vq_dir])
