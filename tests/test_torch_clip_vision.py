"""The port's CLIP vision tower and scorer against the JAX package (CPU, fp32).

Weights are drawn from a numpy seed into the port's state_dict and carried
to the JAX tower by its own ``load_torch_weights`` (the HF key names both
keep); the same numpy pixels go through both.  fp32 on both sides, differing
in summation order: hidden states, pooled and projected embeddings within
atol 2e-5 + rtol 1e-4; logits_per_image within atol 2e-3 (logit scale 100
times unit-norm cosines).
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from open_muse_tpu.models.clip_text import SimpleTokenizer as JaxTokenizer
from open_muse_tpu.models.clip_vision import CLIPScorer as JaxScorer
from open_muse_tpu.models.clip_vision import CLIPVisionEncoder as JaxVision
from open_muse_tpu.models.clip_vision import clip_preprocess_images as jax_preprocess
from open_muse_tpu_torch.models import clip_text
from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder, SimpleTokenizer
from open_muse_tpu_torch.models.clip_vision import (CLIPScorer, CLIPVisionEncoder,
                                                    clip_preprocess_images)

# the JAX package's own test tower (tests/test_clip_vision.py)
VISION_TINY = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                   num_attention_heads=4, image_size=28, patch_size=7, projection_dim=24)
TEXT_TINY = dict(vocab_size=100, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=16, projection_dim=24,
                 eos_token_id=99)
ATOL, RTOL = 2e-5, 1e-4


def seeded_state_(model, seed):
    """Seeded noise at a sensible scale in every parameter (no zeroed layer)."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = rs.randn(*p.shape).astype(np.float32)
            if p.dim() >= 2 and "embedding.weight" not in name:
                noise /= np.sqrt(p[0].numel())
            elif name.endswith("weight") and p.dim() == 1:
                noise = 1.0 + 0.1 * noise
            else:
                noise *= 0.1
            p.copy_(torch.from_numpy(noise))
    return model.eval()


def vision_pair(seed=0, **overrides):
    port = seeded_state_(CLIPVisionEncoder(**{**VISION_TINY, **overrides}), seed)
    jm = JaxVision(config={**VISION_TINY, **overrides}, _defer_init=True)
    missing, unexpected = jm.load_torch_weights(
        {k: v.numpy() for k, v in port.state_dict().items()}, strict=False)
    assert not missing and not unexpected, (missing, unexpected)
    return jm, port


def test_vision_tower_equals_jax():
    """Every hidden state, the pooled CLS token and the image embeds."""
    jm, port = vision_pair(0)
    px = np.random.RandomState(1).randn(2, 28, 28, 3).astype(np.float32)
    want = jm.encode(px)
    with torch.no_grad():
        got = port(torch.from_numpy(px))
    assert len(got[0]) == len(want[0]) == VISION_TINY["num_hidden_layers"] + 1
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(port.embed(torch.from_numpy(px)).numpy(),
                               np.asarray(jm.embed(px)), atol=ATOL, rtol=RTOL)


def test_vision_attention_goes_to_the_kernel_wrapper_and_text_attention_does_not(monkeypatch):
    """The tower's unmasked attention at the default scale reaches
    ``flash_attention`` once a layer; the text tower's causal attention never
    does."""
    from open_muse_tpu_torch.ops import layers

    calls = []
    real = layers.flash_attention
    monkeypatch.setattr(layers, "flash_attention",
                        lambda q, k, v: calls.append(q.shape) or real(q, k, v))
    _, port = vision_pair(2)
    with torch.no_grad():
        port(torch.zeros(1, 28, 28, 3))
    assert calls == [(1, 17, 4, 8)] * VISION_TINY["num_hidden_layers"]
    with torch.no_grad():
        CLIPTextEncoder(**TEXT_TINY)(torch.zeros(1, 16, dtype=torch.long))
    assert len(calls) == VISION_TINY["num_hidden_layers"]


def _images(seed, n=3):
    rs = np.random.RandomState(seed)
    sizes = [(40, 33), (28, 28), (50, 64), (31, 29)]
    return [Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8))
            for h, w in sizes[:n]]


def test_preprocess_equals_jax_bit_for_bit():
    """PIL images of odd sizes (both orientations, already square) and float
    and uint8 arrays."""
    rs = np.random.RandomState(3)
    images = _images(3, 4) + [rs.rand(30, 45, 3).astype(np.float32),
                              (rs.rand(45, 30, 3) * 255).astype(np.uint8)]
    got, want = clip_preprocess_images(images, 28), jax_preprocess(images, 28)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _scorer(seed=4):
    _, vision = vision_pair(seed)
    text = seeded_state_(CLIPTextEncoder(**TEXT_TINY), seed + 1)
    return CLIPScorer(vision, text, SimpleTokenizer(100), logit_scale=float(np.exp(2.3)))


@pytest.mark.parametrize("layout", ["clip_model", "subfolders"])
def test_scorer_directory_reads_into_both_packages(tmp_path, layout):
    """``CLIPScorer.save_pretrained`` writes one full CLIPModel directory
    (whose nested vision and text projection_dim are made a wrong 512 here:
    the top-level one must win in both loaders); or the towers'
    ``save_pretrained`` in ``vision_encoder/`` and ``text_encoder/``.  Both
    packages' ``CLIPScorer.from_pretrained`` read it, and their scores,
    ``best_of`` and logit scales agree."""
    scorer = _scorer()
    if layout == "clip_model":
        scorer.save_pretrained(str(tmp_path))
        config = json.loads((tmp_path / "config.json").read_text())
        config["vision_config"]["projection_dim"] = config["text_config"]["projection_dim"] = 512
        (tmp_path / "config.json").write_text(json.dumps(config))
        scale = scorer.logit_scale
    else:
        scorer.vision.save_pretrained(str(tmp_path / "vision_encoder"))
        scorer.text.save_pretrained(str(tmp_path / "text_encoder"))
        scale = 100.0
    port = CLIPScorer.from_pretrained(str(tmp_path), device="cpu")
    jax = JaxScorer.from_pretrained(str(tmp_path), tokenizer=JaxTokenizer(100))
    assert port.vision.config.projection_dim == jax.vision.config.projection_dim == 24
    assert port.logit_scale == pytest.approx(scale, rel=1e-6)
    assert jax.logit_scale == pytest.approx(scale, rel=1e-6)
    images, texts = _images(5), ["a red cube", "a lighthouse at dusk"]
    got, want = port.score(images, texts), jax.score(images, texts)
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-3)
    np.testing.assert_allclose(got / scale, scorer.score(images, texts) / scorer.logit_scale,
                               atol=1e-6)
    assert port.best_of(images, texts[0]) == jax.best_of(images, texts[0])


def test_text_tower_unchanged_by_the_optional_mask():
    """``CLIPEncoderLayer`` with the causal mask still gives the text tower's
    causal forward: the first token's state ignores every later token."""
    torch.manual_seed(6)
    layer = clip_text.CLIPEncoderLayer(clip_text.CLIPTextConfig(**TEXT_TINY)).eval()
    x = torch.randn(1, 5, 32)
    causal = torch.ones(5, 5, dtype=torch.bool).triu(1)
    y = x.clone()
    y[:, 1:] += torch.randn(1, 4, 32)
    with torch.no_grad():
        assert torch.allclose(layer(x, causal)[:, 0], layer(y, causal)[:, 0])
        assert not torch.allclose(layer(x)[:, 0], layer(y)[:, 0])
