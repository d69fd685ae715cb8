"""The port's eval metrics against the JAX package's, on the CPU.

The Fréchet math, the CLIP score and the Inception Score take the same
numpy inputs on both sides (within 1e-10, float64 math on both; the CLIP
score within 2e-3, fp32 towers).  The InceptionV3 graph, both variants:
seeded port weights go to the JAX graph through its
``convert_torch_inception_state_dict``; pool3 and logits at 135 px (odd: the
stride-2 convs' asymmetric edges) within the JAX test's atol 2e-4 / 2e-3
(rtol 1e-3).  The preprocessing within 1e-5, the synthetic worlds exactly.
"""

import numpy as np
import pytest
import torch

from open_muse_tpu.eval import distill_midscale as jmid
from open_muse_tpu.eval import fid as jfid
from open_muse_tpu.eval import inception as jinc
from open_muse_tpu.eval import quality_regression as jqr
from open_muse_tpu.eval.clip_score import clip_score as jax_clip_score
from open_muse_tpu.eval.inception_score import inception_score_from_logits as jax_isc
from open_muse_tpu.models.clip_text import SimpleTokenizer as JaxTokenizer
from open_muse_tpu.models.clip_vision import CLIPScorer as JaxScorer
from open_muse_tpu_torch.eval import distill_midscale as mid
from open_muse_tpu_torch.eval import fid
from open_muse_tpu_torch.eval import inception as inc
from open_muse_tpu_torch.eval import quality_regression as qr
from open_muse_tpu_torch.eval.clip_score import clip_score
from open_muse_tpu_torch.eval.inception_score import inception_score, inception_score_from_logits
from open_muse_tpu_torch.models.clip_vision import CLIPScorer
from test_torch_clip_vision import _scorer


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The parallel test workers share the cores: two threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_frechet_math_equals_jax():
    rs = np.random.RandomState(0)
    a, b = rs.randn(40, 6), rs.randn(50, 6) * 1.5 + 0.3
    for got, want in zip(fid.compute_statistics(a), jfid.compute_statistics(a)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    stats = fid.compute_statistics(a) + fid.compute_statistics(b)
    assert abs(fid.frechet_distance(*stats) - jfid.frechet_distance(*stats)) <= 1e-10
    # a rank-deficient pair takes the jittered retry on both sides
    c = np.repeat(rs.randn(8, 3), 2, axis=1)
    low = fid.compute_statistics(c) + fid.compute_statistics(c[::-1] + 0.1)
    assert abs(fid.frechet_distance(*low) - jfid.frechet_distance(*low)) <= 1e-10
    mu, sigma = fid.compute_statistics(a)
    assert abs(fid.frechet_distance(mu, sigma, mu, sigma)) < 1e-6


def test_clip_score_and_inception_score_equal_jax(tmp_path):
    """``clip_score`` through one scorer directory read by both packages
    (fixed scale 100, clipped at 0); the Inception Score over seeded logits,
    split and unsplit."""
    _scorer().save_pretrained(str(tmp_path))
    port = CLIPScorer.from_pretrained(str(tmp_path), device="cpu")
    jax = JaxScorer.from_pretrained(str(tmp_path), tokenizer=JaxTokenizer(100))
    rs = np.random.RandomState(1)
    images = [rs.rand(30, 30, 3).astype(np.float32) for _ in range(5)]
    captions = ["a red cube", "a dog", "the sea", "a blue square", "a lighthouse"]
    got = clip_score(port, images, captions, batch_size=2)
    assert got == pytest.approx(jax_clip_score(jax, images, captions, batch_size=2), abs=2e-3)
    with pytest.raises(ValueError):
        clip_score(port, images, captions[:3])
    logits = rs.randn(37, 11) * 3
    for splits in (1, 4, 10):
        np.testing.assert_allclose(inception_score_from_logits(logits, splits),
                                   jax_isc(logits, splits), rtol=0, atol=1e-10)
    assert inception_score(list(logits), lambda x: np.stack(x), splits=4, batch_size=8) == \
        pytest.approx(jax_isc(logits, 4), abs=1e-10)


def _randomized_inception(variant, seed):
    """The JAX test's law for every tensor (tests/test_inception.py
    ``_randomize``), from a CPU generator."""
    model = inc.InceptionV3(variant)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.normal_(0, 0.05, generator=g)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0, 0.1, generator=g)
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
            elif isinstance(m, torch.nn.Linear):
                m.weight.normal_(0, 0.05, generator=g)
                m.bias.normal_(0, 0.1, generator=g)
    return model.eval()


@pytest.mark.parametrize("variant", ["fid", "torchvision"])
def test_inception_graph_equals_jax(variant):
    model = _randomized_inception(variant, 0)
    params = jinc.convert_torch_inception_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    x = np.random.RandomState(0).rand(2, 135, 135, 3).astype(np.float32) * 2 - 1
    with torch.no_grad():
        pool3, logits = model(torch.from_numpy(x.transpose(0, 3, 1, 2)), return_logits=True)
    want_pool3, want_logits = jinc.InceptionV3(variant=variant).apply(
        {"params": params}, x, return_logits=True)
    np.testing.assert_allclose(pool3.numpy(), np.asarray(want_pool3), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("size", [256, 512, 299])
def test_inception_preprocess_equals_jax(size):
    """299 from below (bilinear), from above (antialiased, as jax.image.resize
    shrinks) and unchanged; uint8 and [0, 1] float inputs; within 1e-5."""
    rs = np.random.RandomState(size)
    images = [rs.randint(0, 256, (size, size, 3), np.uint8),
              rs.rand(size, size, 3).astype(np.float32)]
    got = inc.inception_preprocess(images).numpy().transpose(0, 2, 3, 1)
    want = np.asarray(jinc.inception_preprocess(images))
    assert got.shape == want.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_inception_checkpoints_load_by_variant(tmp_path):
    """A pytorch-fid layout (1008 classes, no num_batches_tracked) and a
    torchvision one (1000 classes, an AuxLogits head) load into their
    variants; the JAX converter takes the same files; an unknown key raises."""
    fid_state = {k: v for k, v in _randomized_inception("fid", 1).state_dict().items()
                 if not k.endswith("num_batches_tracked")}
    tv_state = dict(_randomized_inception("torchvision", 2).state_dict())
    tv_state["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    for name, state, variant in (("fid.pth", fid_state, "fid"),
                                 ("tv.pth", tv_state, "torchvision")):
        torch.save(state, tmp_path / name)
        ex = inc.InceptionFeatureExtractor.from_torch_checkpoint(str(tmp_path / name),
                                                                 device="cpu")
        assert ex.model.variant == variant == inc.detect_variant(state)
        assert jinc.detect_variant({k: v.numpy() for k, v in state.items()}) == variant
        assert torch.equal(ex.model.fc.weight, state["fc.weight"])
    torch.save({**fid_state, "surprise.weight": torch.zeros(1)}, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="unrecognized"):
        inc.InceptionFeatureExtractor.from_torch_checkpoint(str(tmp_path / "bad.pth"),
                                                            device="cpu")


def test_seeded_extractors_contract():
    """The seeded Inception and CLIP extractors give finite features of the
    right width; a set against itself scores 0; Inception's head gives
    probabilities."""
    rs = np.random.RandomState(3)
    imgs = [rs.randint(0, 255, (80, 80, 3), np.uint8) for _ in range(4)]
    ex = inc.InceptionFeatureExtractor.seeded(seed=0, batch_size=3, device="cpu")
    feats = ex.extract(imgs)
    assert feats.shape == (4, 2048) and np.isfinite(feats).all() and feats.std() > 0
    probs = ex.predict_proba(imgs)
    assert probs.shape == (4, 1008) and np.allclose(probs.sum(1), 1.0)
    clip = fid.CLIPFeatureExtractor.seeded(seed=7, device="cpu", image_size=16, patch_size=8,
                                           num_hidden_layers=2)
    a = clip.extract(imgs)
    assert a.shape == (4, 64) and np.isfinite(a).all()
    assert abs(fid.frechet_distance(*fid.compute_statistics(a),
                                    *fid.compute_statistics(a))) < 1e-6


def test_square_worlds_equal_jax():
    """The two synthetic worlds and their colour scores, under the same
    RandomState."""
    colors = ["red", "green", "blue", "red"]
    np.testing.assert_array_equal(qr.make_square_images(colors, np.random.RandomState(0)),
                                  jqr.make_square_images(colors, np.random.RandomState(0)))
    scenes = list(mid.MID_COLORS) + ["red"]
    got = mid.make_scene_images(scenes, np.random.RandomState(1))
    np.testing.assert_array_equal(got, jmid.make_scene_images(scenes, np.random.RandomState(1)))
    rs = np.random.RandomState(2)
    images = [rs.rand(16, 16, 3) for _ in range(9)] + list(qr.make_square_images(colors, rs))
    prompts = [f"a {c} square" for c in (["red", "green", "blue"] * 3 + colors)]
    assert qr.color_accuracy(images, prompts) == jqr.color_accuracy(images, prompts)
    prompts = [f"a {c} square" for c in scenes]
    shifted = prompts[1:] + prompts[:1]
    for p in (prompts, shifted):
        assert mid.scene_color_accuracy(list(got), p) == jmid.scene_color_accuracy(list(got), p)
    assert mid.scene_color_accuracy(list(got), prompts) == 1.0
