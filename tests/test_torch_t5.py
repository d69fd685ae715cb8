"""The T5 v1.1 text encoder, port vs the JAX package, on the CPU in fp32.

Weights are drawn from a numpy seed into the JAX model and carried into the
port by ``jax_params_to_state_dict``; the same token ids go through both.
atol 3e-4 / rtol 1e-3, the tolerance of ``tests/test_t5.py``; masked rows
are compared where the mask keeps them, as there.
"""

import json

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from open_muse_tpu.models.t5_text import T5TextEncoder as JaxT5
from open_muse_tpu.models.t5_text import _relative_position_bucket
from open_muse_tpu_torch.models.t5_text import T5TextEncoder, relative_position_bucket
from test_torch_models import port_of, random_params

T5_TINY = dict(vocab_size=120, d_model=32, d_kv=8, d_ff=64, num_layers=3, num_heads=4,
               feed_forward_proj="relu")
T5_TOL = dict(atol=3e-4, rtol=1e-3)


def t5_pair(seed, **overrides):
    jm = JaxT5(**{**T5_TINY, **overrides}, _defer_init=True)
    port, unused = port_of(jm, T5TextEncoder, random_params(jm, seed))
    assert not unused, unused
    return jm, port


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("proj", ["relu", "gated-gelu"])
def test_t5_matches_jax(proj, masked):
    """The last hidden state, with and without an attention mask (the
    padded keys masked; rows compared where kept); the encoder triple."""
    jm, port = t5_pair(90, feed_forward_proj=proj)
    rs = np.random.RandomState(91)
    ids = rs.randint(0, 120, (2, 12))
    mask = None
    if masked:
        mask = np.ones((2, 12), np.int64)
        mask[0, 7:] = 0
        mask[1, 10:] = 0
    want = np.asarray(jm(jnp.asarray(ids), None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():
        hidden, last, pooled = port(torch.from_numpy(ids),
                                    None if mask is None else torch.from_numpy(mask))
    assert pooled is None and hidden == (last,) and last.shape == (2, 12, 32)
    keep = np.ones((2, 12), bool) if mask is None else mask.astype(bool)
    np.testing.assert_allclose(last.numpy()[keep], want[keep], **T5_TOL)


def test_relative_position_bucket_matches_jax():
    """Every relative position in [-300, 300] (past max_distance 128 on both
    sides), at the default and at a smaller bucketing."""
    rel = np.arange(-300, 301)[None] - np.zeros((1, 1), np.int64)
    for buckets, distance in ((32, 128), (16, 64)):
        want = np.asarray(_relative_position_bucket(jnp.asarray(rel), buckets, distance))
        got = relative_position_bucket(torch.from_numpy(rel), buckets, distance).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.min() == 0 and got.max() == buckets - 1


def test_t5_save_pretrained_reads_as_t5(tmp_path):
    """The port's directory names its architecture (as HF's does), so the
    JAX package's loader reads it as a T5 tower with the HF key names."""
    jm, port = t5_pair(92, feed_forward_proj="gated-gelu")
    port.save_pretrained(str(tmp_path))
    config = json.loads((tmp_path / "config.json").read_text())
    assert config["architectures"] == ["T5EncoderModel"] and config["model_type"] == "t5"
    back = JaxT5.from_pretrained(str(tmp_path))
    ids = np.random.RandomState(93).randint(0, 120, (1, 9))
    np.testing.assert_array_equal(np.asarray(back(jnp.asarray(ids))),
                                  np.asarray(jm(jnp.asarray(ids))))
    assert T5TextEncoder.from_pretrained(str(tmp_path), device="cpu").state_dict().keys() == \
        port.state_dict().keys()
