"""The port's eval protocols and scripts end to end, on the CPU.

The quality and distillation regressions and the mid-scale protocol at the
JAX package's smoke sizes (each returns at least the JAX dict's keys, all
finite; the learning gate itself is ``slow``), ``calculate_fid.main`` on a
tiny saved pipeline and ``gen_synthetic_dataset.main`` read back through
``sdxl_synthetic_dataset_map``.
"""

import functools
import io
import json
import os
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from open_muse_tpu_torch.eval import distill_midscale as mid
from open_muse_tpu_torch.eval import inception as inc
from open_muse_tpu_torch.eval import quality_regression as qr
from test_torch_clip_vision import _scorer


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The parallel test workers share the cores: two threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# the keys of the JAX package's result dicts
QUALITY_KEYS = {"vq_recon_loss", "train_loss_first", "train_loss_last",
                "fid_clipfeat_seeded_trained", "fid_clipfeat_seeded_untrained",
                "color_accuracy_trained", "color_accuracy_untrained",
                "clip_score_seeded_trained", "n_eval", "train_steps"}
INCEPTION_KEYS = {"fid_inception_seeded_trained", "fid_inception_seeded_untrained",
                  "isc_seeded_trained", "isc_seeded_trained_std"}
DISTILL_KEYS = {"teacher_timesteps", "student_timesteps", "guidance_scale",
                "distill_loss_first", "distill_loss_last", "fid_teacher_full",
                "color_accuracy_teacher_full", "fid_teacher_k", "color_accuracy_teacher_k",
                "fid_student_k", "color_accuracy_student_k", "n_eval", "train_steps",
                "distill_steps"}
MIDSCALE_KEYS = {"n_params_m", "hidden", "layers", "teacher_timesteps", "student_timesteps",
                 "guidance_scale", "vq_recon_loss", "train_loss_first", "train_loss_last",
                 "distill_loss_first", "distill_loss_last", "fid_split_half_floor",
                 "fid_teacher_full", "color_accuracy_teacher_full", "fid_teacher_k",
                 "color_accuracy_teacher_k", "fid_student_k", "color_accuracy_student_k",
                 "n_eval", "train_steps", "distill_steps"}


def _finite(metrics):
    return all(np.isfinite(v) for v in metrics.values())


def test_regressions_smoke():
    """Every stage of the three protocols at the JAX smoke sizes, on the
    CPU: each returns at least the JAX dict's keys, all finite."""
    q = qr.run_quality_regression(train_steps=3, vq_steps=3, n_eval=6, device="cpu",
                                  log=lambda *a: None)
    assert QUALITY_KEYS <= set(q) and not INCEPTION_KEYS & set(q) and _finite(q)
    d = qr.run_distill_regression(train_steps=3, vq_steps=3, distill_steps=2, n_eval=6,
                                  teacher_timesteps=4, device="cpu", log=lambda *a: None)
    assert DISTILL_KEYS <= set(d) and _finite(d) and d["student_timesteps"] == 2.0
    m = mid.run_distill_midscale(train_steps=3, vq_steps=3, distill_steps=2, n_eval=6,
                                 hidden=128, layers=1, batch=6, teacher_timesteps=4,
                                 step_ratio=2, probe_every=2, distill_eval_every=1,
                                 device="cpu", log=lambda *a: None)
    assert MIDSCALE_KEYS <= set(m) and _finite(m) and m["student_timesteps"] == 2.0


def test_quality_regression_with_inception_returns_its_keys(monkeypatch):
    """``inception=True`` adds the seeded InceptionV3 FIDs and Inception
    Score.  To keep the CPU run short the fully convolutional graph is fed
    96 px (299 in the protocol) and its FIDs take the first 64 of the 2048
    pool3 features (scipy's sqrtm of a 2048-wide covariance takes seconds)."""
    monkeypatch.setattr(inc, "inception_preprocess",
                        functools.partial(inc.inception_preprocess, size=96))
    extract = inc.InceptionFeatureExtractor.extract
    monkeypatch.setattr(inc.InceptionFeatureExtractor, "extract",
                        lambda self, images: extract(self, images)[:, :64])
    q = qr.run_quality_regression(train_steps=2, vq_steps=2, n_eval=4, inception=True,
                                  device="cpu", log=lambda *a: None)
    assert QUALITY_KEYS | INCEPTION_KEYS <= set(q) and _finite(q)


@pytest.mark.slow
def test_quality_regression_trained_beats_untrained():
    """The learning gate, as the JAX package's: trained CLIP-FID under half
    the untrained one's, colour accuracy >= 0.9 trained and <= 0.67
    untrained."""
    m = qr.run_quality_regression(train_steps=200, vq_steps=150, n_eval=18, seed=0,
                                  device="cpu", log=lambda *a: None)
    assert m["fid_clipfeat_seeded_trained"] < 0.5 * m["fid_clipfeat_seeded_untrained"], m
    assert m["color_accuracy_trained"] >= 0.9, m
    assert m["color_accuracy_untrained"] <= 0.67, m


# -- the scripts ----------------------------------------------------------------

@pytest.fixture
def saved_pipeline(tmp_path):
    """A tiny v2 + CLIP + taming VQGAN pipeline (32 px images) saved by
    ``save_pretrained``, and a full CLIPModel scorer directory."""
    from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder, SimpleTokenizer
    from open_muse_tpu_torch.models.taming_vqgan import VQGANModel
    from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2
    from open_muse_tpu_torch.pipelines.pipeline_muse import PipelineMuse
    from test_torch_models import UVIT_TINY, VQGAN_TINY
    from test_torch_pipeline import CLIP_FOR_UVIT

    torch.manual_seed(0)
    pipe = PipelineMuse(VQGANModel(**VQGAN_TINY).eval(), MaskGiTUViT_v2(**UVIT_TINY).eval(),
                        text_encoder=CLIPTextEncoder(**CLIP_FOR_UVIT).eval(),
                        tokenizer=SimpleTokenizer(100, 16))
    pipe.save_pretrained(str(tmp_path / "pipe"))
    _scorer().save_pretrained(str(tmp_path / "clip"))
    return str(tmp_path / "pipe"), str(tmp_path / "clip")


def test_calculate_fid_main(tmp_path, saved_pipeline):
    """Task 1 of 2 names its images by global caption index (1, 3, 5); one
    task over every caption scores its set against real PNGs with the
    --clip-model tower (no cleanfid here) and reports the CLIP score; the
    set against itself scores ~0."""
    from open_muse_tpu_torch.scripts import calculate_fid

    pipe_dir, clip_dir = saved_pipeline
    captions = tmp_path / "captions.txt"
    captions.write_text("\n".join(f"caption {i}" for i in range(6)))
    out = tmp_path / "fake"
    base = ["--model", pipe_dir, "--captions", str(captions), "--num-images", "6",
            "--batch-size", "2", "--timesteps", "2", "--guidance-scale", "2", "--device", "cpu"]
    result = calculate_fid.main(base + ["--output-dir", str(out), "--num-tasks", "2",
                                        "--task-id", "1"])
    assert sorted(os.listdir(out)) == ["000001.png", "000003.png", "000005.png"]
    assert set(result) == {"images_per_s"}
    real = tmp_path / "real"
    real.mkdir()
    rs = np.random.RandomState(0)
    for i in range(6):
        Image.fromarray(rs.randint(0, 256, (32, 32, 3), np.uint8)).save(real / f"{i}.png")
    result = calculate_fid.main(base + ["--output-dir", str(tmp_path / "all"), "--real-dir",
                                        str(real), "--clip-model", clip_dir, "--clip-score"])
    assert len(os.listdir(tmp_path / "all")) == 6
    assert result["backend"] == f"clip_fid({clip_dir})"
    assert np.isfinite(result["fid"]) and result["fid"] > 0 and 0 <= result["clip_score"] <= 100
    same, _ = calculate_fid.compute_fid(str(real), str(real), clip_model=clip_dir, device="cpu")
    assert abs(same) < 1e-6


def _members(path):
    with tarfile.open(path) as tf:
        return {m.name: tf.extractfile(m).read() for m in tf.getmembers()}


def test_gen_synthetic_dataset_round_trips_through_the_dataset_map(tmp_path, saved_pipeline):
    """Three prompts x 3 CLIP-scored candidates in shards of two samples;
    ``sdxl_synthetic_dataset_map`` picks each prompt's arg-max candidate.
    With one candidate the flat jpg / txt / json schema."""
    from open_muse_tpu_torch.scripts import gen_synthetic_dataset
    from open_muse_tpu_torch.training.data import sdxl_synthetic_dataset_map, tar_samples

    pipe_dir, clip_dir = saved_pipeline
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a red cube\na dog\nthe sea\n")
    pattern = str(tmp_path / "syn" / "syn-%05d.tar")
    args = ["--model", pipe_dir, "--prompts", str(prompts), "--timesteps", "2",
            "--guidance-scale", "2", "--device", "cpu", "--samples-per-shard", "2"]
    assert gen_synthetic_dataset.main(args + ["--output", pattern, "--candidates", "3",
                                              "--clip-model", clip_dir]) == 2
    samples = [s for k in range(2) for s in tar_samples(pattern % k, handler="raise")]
    assert [s["txt"].decode() for s in samples] == ["a red cube", "a dog", "the sea"]
    for s in samples:
        scores = [float(x) for x in s["clip_scores.txt"].decode().split(",")]
        assert len(scores) == 3 and all(f"{i}.png" in s for i in range(3))
        best = sdxl_synthetic_dataset_map(dict(s))
        assert best["png"] == s[f"{int(np.argmax(scores))}.png"]
    flat = str(tmp_path / "flat" / "flat-%05d.tar")
    assert gen_synthetic_dataset.main(args + ["--output", flat, "--candidates", "1",
                                              "--samples-per-shard", "10"]) == 1
    members = _members(flat % 0)
    assert sorted(members) == sorted(f"{i:08d}.{ext}" for i in range(3)
                                     for ext in ("jpg", "txt", "json"))
    assert json.loads(members["00000000.json"])["synthetic"] is True
    assert Image.open(io.BytesIO(members["00000000.jpg"])).size == (32, 32)
