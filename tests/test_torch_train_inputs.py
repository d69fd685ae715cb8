"""The trainer's last inputs in the port against the JAX package, on the CPU.

The class trainer on MOVQ tokens (``model.vq_model_type: movq``), the
``dataset_map`` dialects of raw shards, the ``.pth`` members named after
the encoder checkpoints, the native shard reader (``native_io``, built from
``native/muse_io.cpp``) against the Python reader, and the inpainting panel
of ``train_muse`` against the JAX ``generate_inpainting_images`` under
JAX-drawn noise.
"""

import io
import json
import logging
import os
import tarfile

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image

from open_muse_tpu.models.movq import MOVQ as JaxMOVQ
from open_muse_tpu.models.clip_text import SimpleTokenizer as JaxTokenizer
from open_muse_tpu.training import data as jdata
from open_muse_tpu.training import train_muse as jtrain_muse
from open_muse_tpu_torch.kernels.vq_argmin import vq_near_ties
from open_muse_tpu_torch.models.clip_text import SimpleTokenizer
from open_muse_tpu_torch.models.movq import MOVQ
from open_muse_tpu_torch.training import data, native_io, train_maskgit_imagenet, train_muse
from test_torch_models import port_of, random_params
from test_torch_pipeline import jax_noise, pipelines  # noqa: F401  (a fixture)
from test_torch_tokenizers import MOVQ_TINY
from test_torch_train_cli import REPO_ROOT
from test_torch_train_v1 import V1_CLASS_TINY, write_class_shard


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny models gain nothing from torch's intra-op threads, and the
    parallel test workers share the cores: one thread each, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _png(array):
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, format="PNG")
    return buf.getvalue()


def _add(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def test_class_trainer_trains_on_movq_tokens(tmp_path):
    """``configs/imagenet_movq.yaml`` shrunk by overrides (a tiny MOVQ saved
    by ``save_pretrained``, 16 x 16 latents over 64 codes): two steps of
    ``train_maskgit_imagenet.main`` on the CPU, finite losses and a
    checkpoint; the MOVQ the trainer loads gives the JAX MOVQ's codes on the
    same directory and images (tie-aware: where the picks differ, JAX's own
    fp32 distances to both agree to 1e-5 of their scale)."""
    shard, out, vq_dir = (str(tmp_path / n) for n in ("cls-000.tar", "out", "movq"))
    write_class_shard(shard, 8)
    jm = JaxMOVQ(**MOVQ_TINY, _defer_init=True)
    port, _ = port_of(jm, MOVQ, random_params(jm, 21))
    port.save_pretrained(vq_dir)
    argv = ([f"config={os.path.join(REPO_ROOT, 'configs', 'imagenet_movq.yaml')}",
             f"dataset.params.train_shards_path_or_url={shard}",
             "dataset.params.shuffle_buffer_size=8", "dataset.params.resolution=32",
             f"experiment.output_dir={out}", "experiment.log_every=1", "experiment.save_every=2",
             "experiment.generate_every=100", "experiment.resume_from_checkpoint=null",
             f"model.vq_model.pretrained={vq_dir}", "training.batch_size=4",
             "training.mixed_precision=no", "training.max_train_steps=2",
             "lr_scheduler.params.warmup_steps=1", "device=cpu"]
            + [f"model.transformer.{k}={v}" for k, v in V1_CLASS_TINY.items()])
    state = train_maskgit_imagenet.main(argv)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    assert [m["step"] for m in logged] == [1, 2] and state.optimizer.count == 2
    assert all(np.isfinite(m["loss"]) for m in logged)
    assert os.path.isdir(os.path.join(out, "checkpoint-2"))

    from open_muse_tpu_torch.utils.config import load_config

    vq = train_muse.load_vq_model(load_config(argv), "cpu")
    assert isinstance(vq, MOVQ)
    pixels = np.random.RandomState(22).rand(2, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        got = vq.get_code(torch.from_numpy(pixels)).reshape(-1)
        latents = vq._latents(torch.from_numpy(pixels)).reshape(got.shape[0], -1)
    want = torch.from_numpy(np.asarray(JaxMOVQ.from_pretrained(vq_dir).get_code(
        jnp.asarray(pixels)))).reshape(-1)
    assert int(got.max()) < 64 and got.shape[0] == 2 * 256
    near, _, _ = vq_near_ties(want.int(), latents, vq.quantize.weight, 1e-5)
    assert bool(((got == want) | near).all())


def _dialect_samples():
    """Raw samples of the three dialects: sdxl (three candidates, clip
    scores; one sample without scores, one whose best candidate is
    missing), ds_clean (2 x 2 grids) and ds_clean_upscaled."""
    rs = np.random.RandomState(5)

    def image(h, w):
        return _png((rs.rand(h, w, 3) * 255).astype(np.uint8))

    sdxl = []
    for i in range(6):
        sample = {"__key__": f"{i:05d}", "__url__": "sdxl.tar", "txt": f"prompt {i}".encode()}
        for c in range(3):
            sample[f"{c}.png"] = image(40 + 4 * c, 44)
        if i != 4:
            sample["clip_scores.txt"] = ",".join(f"{v:.3f}" for v in rs.rand(3)).encode()
        if i == 5:  # the best candidate, 3, is not in the sample
            sample["clip_scores.txt"] = b"0.1,0.2,0.3,0.9"
        sdxl.append(sample)
    clean = [{"__key__": f"{i:05d}", "__url__": "clean.tar", "txt": f"grid {i}".encode(),
              "png": image(72, 80)} for i in range(4)]
    return sdxl, clean


@pytest.mark.parametrize("name", ["sdxl_synthetic", "ds_clean", "ds_clean_upscaled"])
def test_dataset_maps_equal_jax(name):
    """Each dialect's map gives JAX's members byte for byte (the best
    candidate and its metadata; the top-left quadrant re-encoded; the real
    size), and raises where JAX's raises (a best candidate not in the
    sample)."""
    sdxl, clean = _dialect_samples()
    samples = [s for s in sdxl if "clip_scores.txt" in s] if name == "sdxl_synthetic" else clean
    ours, theirs = data.DATASET_MAPS[name], jdata.DATASET_MAPS[name]
    for sample in samples:
        try:
            want = theirs(dict(sample))
        except ValueError:
            with pytest.raises(ValueError):
                ours(dict(sample))
            continue
        assert ours(dict(sample)) == want


def _write(path, samples):
    with tarfile.open(path, "w") as tf:
        for sample in samples:
            for ext, value in sample.items():
                if not ext.startswith("__"):
                    _add(tf, f"{sample['__key__']}.{ext}", value)


@pytest.mark.parametrize("name", ["sdxl_synthetic", "ds_clean"])
def test_dataset_map_batches_equal_jax(tmp_path, name):
    """``Text2ImageDataset(dataset_map=name)`` on a shard of the dialect:
    batches equal to the JAX dataset's (the Python reader and no prefetch
    thread on both sides; sdxl's samples without clip scores skipped and a
    failing sample skipped with a warning on both)."""
    sdxl, clean = _dialect_samples()
    shard = str(tmp_path / "dialect-000.tar")
    _write(shard, sdxl if name == "sdxl_synthetic" else clean)
    kw = dict(resolution=32, shuffle_buffer_size=2, seed=4, prefetch_depth=0, resample=False,
              dataset_map=name, use_native=False)
    got = list(data.Text2ImageDataset(shard, 2, **kw))
    want = list(jdata.Text2ImageDataset(shard, 2, **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["input_text"] == w["input_text"]
        for key in ("pixel_values", "orig_sizes", "crop_coords", "aesthetic_scores"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_pth_members_renamed_as_jax(tmp_path):
    """Pre-encoded members named after the encoder checkpoints
    (``<vae_checkpoint>.pth``, ``<text_encoder_checkpoint>.pth``, lower case,
    ``/`` as ``.``) come out as ``image_input_ids`` and
    ``encoder_hidden_states``, equal to the JAX dataset's, and
    ``prepare_batch`` takes them."""
    shard = str(tmp_path / "pre-000.tar")
    vae, text = "openMUSE/maskgit-vqgan-imagenet-f16-256", "openai/clip-vit-large-patch14"
    rs = np.random.RandomState(6)
    with tarfile.open(shard, "w") as tf:
        for i in range(4):
            for name, value in ((vae.lower().replace("/", "."), torch.from_numpy(
                    rs.randint(0, 64, (16,)))), (text.lower().replace("/", "."),
                                                torch.from_numpy(rs.randn(7, 48).astype(
                                                    np.float32)))):
                buf = io.BytesIO()
                torch.save(value, buf)
                _add(tf, f"{i:05d}.{name}.pth", buf.getvalue())
    got = next(iter(data.PreEncodedDataset(shard, 4, shuffle_buffer_size=1, resample=False,
                                           vae_checkpoint=vae, text_encoder_checkpoint=text)))
    want = next(iter(jdata.Text2ImageDataset(shard, 4, shuffle_buffer_size=1, resample=False,
                                             pre_encode=True, use_native=False, prefetch_depth=0,
                                             vae_checkpoint=vae, text_encoder_checkpoint=text)))
    assert sorted(got) == sorted(want) == ["__keys__", "encoder_hidden_states",
                                           "image_input_ids"]
    for key in ("image_input_ids", "encoder_hidden_states"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    from open_muse_tpu_torch.utils.config import load_config

    config = load_config([f"config={os.path.join(REPO_ROOT, 'configs', 'cc12m.yaml')}"])
    batch = train_muse.prepare_batch(got, config, 32, torch.device("cpu"))
    assert batch["image_tokens"].shape == (4, 16) and batch["cond_embeds"].shape == (4, 32)


def test_native_reader_gives_the_python_readers_samples(tmp_path, caplog):
    """The library builds from ``native/muse_io.cpp`` into the package's
    ``_build/`` (not ``native/``); ``NativeShardReader`` over three shards
    gives every sample ``tar_samples`` gives, members byte-equal (but
    ``__url__``); ``Text2ImageDataset`` says which reader ran, and with the
    native one walks the same samples as with the Python one."""
    from test_torch_train_raw import write_raw_shard

    shards = [str(tmp_path / f"raw-{i:03d}.tar") for i in range(3)]
    for i, path in enumerate(shards):
        write_raw_shard(path, 6, seed=i)
    lib = native_io.build_native()
    assert lib is not None and native_io.native_available()
    assert lib.parent.name == "_build" and lib.parent.parent.name == "open_muse_tpu_torch"
    python = {(s["__url__"], s["__key__"]): s for url in shards for s in data.tar_samples(url)}
    with native_io.NativeShardReader(shards, num_threads=3) as reader:
        native = list(reader)
    assert len(native) == len(python) == 18
    by_key = {}
    for url in shards:
        for s in data.tar_samples(url):
            by_key.setdefault(s["__key__"], []).append({k: v for k, v in s.items()
                                                         if k != "__url__"})
    for s in native:
        assert s in by_key[s["__key__"]]
    caplog.set_level(logging.INFO, logger=data.__name__)
    kw = dict(resolution=32, shuffle_buffer_size=1, seed=1, prefetch_depth=0, resample=False,
              require_text=False)
    walked = {}
    for use_native in (True, False):
        batches = list(data.Text2ImageDataset(shards, 2, use_native=use_native,
                                              native_threads=1, **kw))
        walked[use_native] = sorted(text for b in batches for text in b["input_text"])
    assert walked[True] == walked[False] and len(walked[True]) == 18
    messages = [r.getMessage() for r in caplog.records]
    assert any("native reader" in m for m in messages)
    assert any("Python reader" in m for m in messages)


def test_inpainting_panel_matches_jax(tmp_path, pipelines):  # noqa: F811
    """The in-repo ``inpainting_validation`` folders at 32 px over 16 x 16
    tokens: the loaded entries equal JAX's; the panel of a tiny U-ViT, CLIP
    and VQGAN (JAX weights carried across, fp32) under JAX-drawn noise
    (``fold_in(key, i)`` an entry) equals JAX's grid to one 8-bit level
    (equal tokens; the decode's fp32 sums apart), and every generated token
    outside a mask is the encoded image's."""
    jax_pipe, port_pipe = pipelines
    directory = os.path.join(REPO_ROOT, "inpainting_validation")
    entries = train_muse.load_inpainting_validation_data(directory, 32, 16)
    want_entries = jtrain_muse.load_inpainting_validation_data(directory, 32, 16)
    assert len(entries) == len(want_entries) == 5
    for e, w in zip(entries, want_entries):
        assert e["prompt"] == w["prompt"]
        np.testing.assert_array_equal(e["image"], w["image"])
        np.testing.assert_array_equal(e["mask"], w["mask"])

    def jax_text(texts):
        ids = jnp.asarray(JaxTokenizer(100, 16)(texts, padding="max_length", truncation=True,
                                                max_length=16, return_tensors="np")["input_ids"])
        hs, _, pooled = jax_pipe.text_encoder.encode(ids)
        return hs[-2], pooled

    tokenizer = SimpleTokenizer(100, 16)

    def port_text(texts):
        ids = tokenizer(texts, padding="max_length", truncation=True, max_length=16,
                        return_tensors="np")["input_ids"]
        with torch.no_grad():
            hs, _, pooled = port_pipe.text_encoder(torch.from_numpy(np.asarray(ids)).long())
        return hs[-2], pooled

    key = jax.random.PRNGKey(13)
    micro = np.asarray([[512, 512, 0, 0, 6.0]], np.float32)
    empty_ehs, empty_pooled = jax_text([""])
    mask_id = jax_pipe.transformer.config.mask_token_id
    jtrain_muse.generate_inpainting_images(
        jax_pipe.transformer, jax_pipe.vae, want_entries, jax_text, mask_id, jnp.asarray(micro),
        empty_ehs, empty_pooled, str(tmp_path / "jax.png"), key)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    generated = train_muse.generate_inpainting_images(
        port_pipe.transformer, port_pipe.vae, entries, port_text, mask_id, t(micro),
        t(empty_ehs), t(empty_pooled), str(tmp_path / "port.png"),
        lambda i: {"noise": jax_noise(jax.random.fold_in(key, i), 8, 1, 256, 64)})
    got = np.asarray(Image.open(tmp_path / "port.png"), np.int32)
    want = np.asarray(Image.open(tmp_path / "jax.png"), np.int32)
    assert got.shape == want.shape and np.abs(got - want).max() <= 1
    for entry, ids in zip(entries, generated):
        mask = torch.from_numpy(entry["mask"].reshape(-1))
        with torch.no_grad():
            codes = port_pipe.vae.get_code(torch.from_numpy(entry["image"])[None])[0]
        assert torch.equal(ids[0][~mask], codes[~mask].long())
        assert not bool((ids == mask_id).any())
