"""The raw-image branch of the port's trainer against the JAX package, on the
CPU in fp32: the raw dataset, the frozen encoders' ``prepare_batch`` (the JAX
one is a closure inside ``main``, so its parts are compared: ``get_code``,
the text tower's penultimate and pooled states, the micro-conds) and
``train_muse.main`` end to end with eval, the sample panel, the grad-norm
lines, the bucket diagnostics, a profiler window, gradient accumulation and
a resume, at tiny size.
"""

import io
import json
import os
import tarfile

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from open_muse_tpu.models.clip_text import CLIPTextEncoder as JaxCLIP
from open_muse_tpu.models.taming_vqgan import VQGANModel as JaxVQGAN
from open_muse_tpu.models.transformer_v2 import MaskGiTUViT_v2 as JaxUViT
from open_muse_tpu.ops import vq as jax_vq
from open_muse_tpu.training import data as jdata
from open_muse_tpu.training.trainer import grad_norm_param_names as jax_grad_norm_names
from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder, SimpleTokenizer
from open_muse_tpu_torch.models.taming_vqgan import VQGANModel
from open_muse_tpu_torch.training.data import Text2ImageDataset, WebdatasetSelect
from open_muse_tpu_torch.training.train_muse import FrozenEncoders, main
from test_torch_models import UVIT_TINY, VQGAN_TINY, port_of, random_params
from test_torch_pipeline import CLIP_FOR_UVIT
from test_torch_train_cli import REPO_ROOT, TINY

FILTER = dict(min_size=32, max_pwatermark=0.5, min_aesthetic_score=6.0)
SIZES = ((48, 40), (40, 56), (40, 40), (64, 48), (40, 44), (52, 40))


def write_raw_shard(path, n, seed=0):
    """``n`` seeded PNGs of mixed sizes with captions and LAION metadata,
    all passing ``FILTER`` but the sample at 5 (aesthetic 4.0); every other
    one gives its original size in the metadata."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            w, h = SIZES[i % len(SIZES)]
            png = io.BytesIO()
            Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(png, format="PNG")
            meta = {"width": w, "height": h, "pwatermark": 0.1,
                    "aesthetic": 4.0 if i == 5 else 6.0 + 0.1 * i}
            if i % 2:
                meta.update(original_width=4 * w, original_height=4 * h)
            caption = f"a photo of thing {i} and <person>" if i == 3 else f"a photo of thing {i}"
            for ext, data in (("png", png.getvalue()), ("txt", caption.encode()),
                              ("json", json.dumps(meta).encode())):
                info = tarfile.TarInfo(f"{i:05d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    """A tiny CLIP tower and taming VQGAN in both packages with the same
    seeded weights, saved by the port's ``save_pretrained``."""
    root = tmp_path_factory.mktemp("frozen")
    jc = JaxCLIP(**CLIP_FOR_UVIT, _defer_init=True)
    jv = JaxVQGAN(**VQGAN_TINY, _defer_init=True)
    clip, _ = port_of(jc, CLIPTextEncoder, random_params(jc, 50))
    vq, _ = port_of(jv, VQGANModel, random_params(jv, 51))
    clip.save_pretrained(str(root / "clip"))
    vq.save_pretrained(str(root / "vq"))
    return jc, jv, clip, vq, str(root / "clip"), str(root / "vq")


def _batches(dataset, n):
    it = iter(dataset)
    return [next(it) for _ in range(n)]


def test_raw_dataset_matches_jax(tmp_path):
    """The same shard, seed and filter: batches equal to the JAX
    ``Text2ImageDataset``'s (random crops, the person word, original sizes
    from the metadata where present, aesthetic scores), the filtered sample
    left out; centred crops for eval.  Both read without the prefetch
    thread, which would race the crop draws against the shuffle."""
    shard = str(tmp_path / "raw-000.tar")
    write_raw_shard(shard, 12)
    for center in (False, True):
        kw = dict(resolution=32, shuffle_buffer_size=4, seed=3, center_crop=center,
                  prefetch_depth=0)
        port = Text2ImageDataset(shard, 4, select=WebdatasetSelect(**FILTER), **kw)
        jax_ds = jdata.Text2ImageDataset(shard, 4, select=jdata.WebdatasetSelect(**FILTER),
                                         use_native=False, **kw)
        for got, want in zip(_batches(port, 3), _batches(jax_ds, 3)):
            assert sorted(got) == sorted(want)
            assert got["input_text"] == want["input_text"]
            for key in ("pixel_values", "orig_sizes", "crop_coords", "aesthetic_scores"):
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            assert got["pixel_values"].shape == (4, 32, 32, 3)
            assert 4.0 not in got["aesthetic_scores"].tolist()
            assert not any("<person>" in t for t in got["input_text"])


def test_raw_prepare_batch_matches_jax(tmp_path, encoders):
    """``FrozenEncoders.prepare_batch`` on a raw batch against the parts of
    the JAX ``prepare_batch``: tokens equal to ``get_code`` on the same
    pixels except where JAX's own fp32 distances to the two picks are equal
    (near-ties); the penultimate hidden state and the pooled output to atol
    1e-5 (fp32, summation order); the micro-conds built as the JAX trainer
    builds them, exactly; the empty prompt's embeddings as the JAX
    ``text_encoder.encode`` of the tokenized empty string."""
    jc, jv, clip, vq, _, _ = encoders
    shard = str(tmp_path / "raw-000.tar")
    write_raw_shard(shard, 8)
    batch = next(iter(Text2ImageDataset(shard, 4, resolution=32, shuffle_buffer_size=4,
                                        seed=1, prefetch_depth=0)))
    tokenizer = SimpleTokenizer(100, 16)
    frozen = FrozenEncoders(clip, tokenizer, vq, torch.device("cpu"))
    out = frozen.prepare_batch(batch)

    pixels = jnp.asarray(batch["pixel_values"])
    want_tokens = np.asarray(jv.get_code(pixels))
    got_tokens = out["image_tokens"].numpy()
    assert got_tokens.shape == want_tokens.shape == (4, 256)
    latents = jv.module.apply({"params": jv.params}, pixels,
                              method=lambda m, p: m.quant_conv(m.encoder(p)))
    d = np.asarray(jax_vq.compute_distances(latents.reshape(-1, latents.shape[-1]),
                                            jv.params["quantize"]["embedding"]["embedding"]))
    got, want = got_tokens.reshape(-1), want_tokens.reshape(-1)
    rows = np.nonzero(got != want)[0]
    np.testing.assert_array_equal(d[rows, got[rows]], d[rows, want[rows]])

    ids = tokenizer(batch["input_text"], padding="max_length", truncation=True,
                    max_length=16, return_tensors="np")["input_ids"]
    hs, _, pooled = jc.encode(jnp.asarray(ids))
    np.testing.assert_allclose(out["encoder_hidden_states"].numpy(), np.asarray(hs[-2]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["cond_embeds"].numpy(), np.asarray(pooled), rtol=0,
                               atol=1e-5)
    want_micro = np.concatenate([batch["orig_sizes"], batch["crop_coords"],
                                 np.asarray(batch["aesthetic_scores"]).reshape(4, 1)], axis=1)
    np.testing.assert_array_equal(out["micro_conds"].numpy(), want_micro.astype(np.float32))
    assert sorted(out) == ["cond_embeds", "encoder_hidden_states", "image_tokens",
                           "micro_conds"]

    empty = frozen.empty_embeds()
    hs, _, pooled = jc.encode(jnp.asarray(tokenizer([""], padding="max_length",
                                                    max_length=16)["input_ids"]))
    np.testing.assert_allclose(empty["empty_embeds"].numpy(), np.asarray(hs[-2]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(empty["empty_cond_embeds"].numpy(), np.asarray(pooled), rtol=0,
                               atol=1e-5)


def _raw_argv(shard, eval_shard, out, clip_dir, vq_dir, steps, resume="null"):
    return ([f"config={os.path.join(REPO_ROOT, 'configs', 'laiona6plus_uvit_clip.yaml')}",
             f"dataset.params.train_shards_path_or_url={shard}",
             f"dataset.params.eval_shards_path_or_url={eval_shard}",
             "dataset.params.shuffle_buffer_size=8", "dataset.params.resolution=32",
             "dataset.quality_filter.min_size=32", f"experiment.output_dir={out}",
             "experiment.log_every=1", "experiment.save_every=2", "experiment.eval_every=2",
             "experiment.max_eval_batches=1", "experiment.generate_every=4",
             "experiment.log_grad_norm_every=2", "experiment.log_entropy_buckets=true",
             "experiment.profile_steps=[2,3]", f"experiment.resume_from_checkpoint={resume}",
             f"model.text_encoder.pretrained={clip_dir}", f"model.vq_model.pretrained={vq_dir}",
             "training.batch_size=4", "training.mixed_precision=no",
             "training.gradient_accumulation_steps=2", "training.cond_dropout_prob=0.5",
             f"training.max_train_steps={steps}", "lr_scheduler.params.warmup_steps=0",
             "device=cpu"]
            + [f"model.transformer.{k}={v}" for k, v in TINY.items()
               if k not in ("encoder_hidden_size", "cond_embed_dim")]
            + ["model.transformer.encoder_hidden_size=48", "model.transformer.cond_embed_dim=32"])


def test_train_muse_main_raw_branch(tmp_path, encoders):
    """``train_muse.main`` on the flagship config without pre-encoding, at
    tiny size on the CPU: raw images through the VQGAN and the text tower
    every step, CFG cond dropout, gradient accumulation 2, eval every 2
    steps, a sample panel at step 4, per-parameter grad norms under the JAX
    package's flax names every 2, the bucket diagnostics every step, a
    profiler window over steps 2 - 3; then a resume that does nothing
    (every tensor equal to the first run's) and one that trains on."""
    _, _, _, _, clip_dir, vq_dir = encoders
    shard, eval_shard = str(tmp_path / "raw-000.tar"), str(tmp_path / "eval-000.tar")
    write_raw_shard(shard, 12)
    write_raw_shard(eval_shard, 8, seed=1)
    out = str(tmp_path / "out")
    argv = _raw_argv(shard, eval_shard, out, clip_dir, vq_dir, 4)
    state = main(argv)
    assert state.step == 4 and state.optimizer.count == 2 and state.optimizer.mini_step == 0
    with open(os.path.join(out, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    steps = [m for m in logged if "loss" in m]
    assert [m["step"] for m in steps] == [1, 2, 3, 4]
    assert all(np.isfinite(m["loss"]) and len(m["pixel_entropy_by_bucket"]) == 10
               and np.shape(m["token_prob_deciles_by_bucket"]) == (10, 11) for m in steps)
    evals = [m for m in logged if "eval_loss" in m]
    assert [m["step"] for m in evals] == [2, 4] and all(np.isfinite(m["eval_loss"])
                                                        for m in evals)
    norms = [m for m in logged if any(k.startswith("grad_norm/") for k in m)]
    assert [m["step"] for m in norms] == [2, 4]
    cfg = {**UVIT_TINY, **{k: v for k, v in TINY.items() if k != "block_out_channels"},
           "encoder_hidden_size": 48, "cond_embed_dim": 32}
    names = jax_grad_norm_names(JaxUViT(**cfg, _defer_init=True).params_shapes())
    assert [k for k in norms[0] if k != "step"] == [f"grad_norm/{n}" for n in names]
    assert all(np.isfinite(v) and v >= 0 for k, v in norms[0].items() if k != "step")
    assert os.path.isfile(os.path.join(out, "samples-4.png"))
    assert os.path.isfile(os.path.join(out, "profile", "trace.json"))

    again = main(_raw_argv(shard, eval_shard, out, clip_dir, vq_dir, 4, resume="latest"))
    assert again.step == 4 and again.optimizer.count == 2
    mine = dict(state.model.named_parameters())
    for name, p in again.model.named_parameters():
        assert torch.equal(p, mine[name]), name
        assert torch.equal(again.ema.shadow[name], state.ema.shadow[name]), name
    for a, b in zip(again.optimizer.acc, state.optimizer.acc):
        assert torch.equal(a, b)
    more = main(_raw_argv(shard, eval_shard, out, clip_dir, vq_dir, 5, resume="latest"))
    assert more.step == 5 and more.optimizer.count == 2 and more.optimizer.mini_step == 1
