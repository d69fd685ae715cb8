"""Soft VQ targets (``training.use_soft_code_target``) in the port against the
JAX package, on the CPU in fp32: three v2 train steps with
``use_soft_targets`` against ``make_uvit_train_step(..., use_soft_targets=
True)``, the raw branch's soft codes against the JAX VQ model's
``get_soft_code``, and ``train_muse.main`` with soft targets on raw shards.
"""

import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from open_muse_tpu_torch.models.clip_text import SimpleTokenizer
from open_muse_tpu_torch.training.train_muse import FrozenEncoders, main
from test_torch_train_raw import _raw_argv, encoders, write_raw_shard  # noqa: F401 (fixture)
from test_torch_training import (_assert_state_matches, _batches, _jax_and_port_steps,
                                 _port_noise, _t)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny convolutions gain nothing from torch's intra-op threads, and the
    parallel test workers share the cores: one thread each, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_soft_target_steps_match_jax():
    """Three steps on one batch whose soft targets (B, S, K) are a softmax
    of seeded noise, each on the masking noise of its JAX key: loss and
    grad norm to rtol 2e-5, parameters and EMA to atol 2e-6 (fp32,
    summation order; updates ~1e-3), as the hard-target steps are held;
    the loss is not the hard-target loss of the same step."""
    jm, port, jstate, jstep, state, step = _jax_and_port_steps(use_soft_targets=True)
    jbatch, tbatch = _batches(jm, seed=11, batch=2)
    k = jm.config.codebook_size
    logits = np.random.RandomState(12).randn(2, 16, k).astype(np.float32) * 3.0
    soft = np.exp(logits - logits.max(-1, keepdims=True))
    soft /= soft.sum(-1, keepdims=True)
    jbatch["soft_targets"] = jnp.asarray(soft)
    tbatch["soft_targets"] = _t(soft)
    _, _, _, _, hard_state, hard_step = _jax_and_port_steps()
    for i in range(3):
        key = jax.random.PRNGKey(500 + i)
        jstate, jmetrics = jstep(jstate, jbatch, key)
        noise = _port_noise(key, tbatch["image_tokens"], k)
        metrics = step(state, tbatch, noise)
        for name in ("loss", "grad_norm", "avg_masking_rate"):
            np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]), rtol=2e-5,
                                       err_msg=name)
        _assert_state_matches(state, jstate, port)
        if i == 0:
            hard = hard_step(hard_state, tbatch, _port_noise(key, tbatch["image_tokens"], k))
            assert abs(float(hard["loss"]) - float(metrics["loss"])) > 1e-3


@pytest.mark.parametrize("stochastic", [False, True])
def test_raw_soft_codes_match_jax(tmp_path, encoders, stochastic):  # noqa: F811
    """``FrozenEncoders.prepare_batch`` with soft codes at temp 0.5: the soft
    targets (B, 256, K) against the JAX taming VQGAN's ``get_soft_code`` to
    rtol 2e-3 / atol 1e-7 (a probability's relative error is its distance's
    absolute error over the temperature: fp32 latents and the ``|z|^2 +
    |e|^2 - 2 z.e`` cancellation in another summation order give ~1e-4),
    the image tokens its codes, exactly: the argmin of the same distances,
    or with ``stochastic`` the sample under Gumbel noise, which the port
    draws from the trainer's generator (so JAX gets the same noise through
    ``jax.random.gumbel``'s place in ``categorical``: here its codes are
    rebuilt from the port's noise)."""
    from open_muse_tpu.ops import vq as jax_vq
    from open_muse_tpu_torch.ops.vq import gumbel_noise
    from open_muse_tpu_torch.training.data import Text2ImageDataset

    jc, jv, clip, vq, _, _ = encoders
    shard = str(tmp_path / "raw-000.tar")
    write_raw_shard(shard, 8)
    batch = next(iter(Text2ImageDataset(shard, 4, resolution=32, shuffle_buffer_size=4,
                                        seed=1, prefetch_depth=0)))
    frozen = FrozenEncoders(clip, SimpleTokenizer(100, 16), vq, torch.device("cpu"),
                            soft_code=(0.5, stochastic))
    out = frozen.prepare_batch(batch, torch.Generator().manual_seed(3))
    assert set(out) == {"soft_targets", "image_tokens", "encoder_hidden_states",
                        "cond_embeds", "micro_conds"}
    pixels = jnp.asarray(batch["pixel_values"])
    jsoft, jcodes = jv.get_soft_code(pixels, 0.5)
    np.testing.assert_allclose(out["soft_targets"].numpy(), np.asarray(jsoft), rtol=2e-3,
                               atol=1e-7)
    if stochastic:
        latents = jv.module.apply({"params": jv.params}, pixels,
                                  method=lambda m, p: m.quant_conv(m.encoder(p)))
        d = jax_vq.compute_distances(latents.reshape(-1, latents.shape[-1]),
                                     jv.params["quantize"]["embedding"]["embedding"])
        gumbel = gumbel_noise((d.shape[0], d.shape[1]), torch.Generator().manual_seed(3))
        jcodes = jnp.argmax(-d / 0.5 + jnp.asarray(gumbel.numpy()), axis=-1).reshape(4, -1)
    np.testing.assert_array_equal(out["image_tokens"].numpy(), np.asarray(jcodes))


def test_train_muse_soft_targets_on_raw_shards(tmp_path, encoders):  # noqa: F811
    """``train_muse.main`` on the flagship config's raw branch with
    ``use_soft_code_target`` and stochastic codes at temp 0.5, 2 steps at
    tiny size: finite losses, a checkpoint; the soft-target loss differs
    from the hard-target run on the same shards and seed.  With
    ``pre_encode`` it refuses (pre-encoded shards carry no soft targets)."""
    _, _, _, _, clip_dir, vq_dir = encoders
    shard, eval_shard = str(tmp_path / "raw-000.tar"), str(tmp_path / "eval-000.tar")
    write_raw_shard(shard, 12)
    write_raw_shard(eval_shard, 8, seed=1)
    losses = {}
    for soft in (True, False):
        out = str(tmp_path / f"out-{soft}")
        argv = _raw_argv(shard, eval_shard, out, clip_dir, vq_dir, 2) + [
            "experiment.eval_every=100", "experiment.generate_every=100",
            "experiment.log_grad_norm_every=null", "experiment.log_entropy_buckets=false",
            "experiment.profile_steps=null", "training.gradient_accumulation_steps=1",
            f"training.use_soft_code_target={str(soft).lower()}",
            "training.soft_code_temp=0.5", "training.use_stochastic_code=true"]
        state = main(argv)
        assert state.step == 2 and os.path.isdir(os.path.join(out, "checkpoint-2"))
        with open(os.path.join(out, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        losses[soft] = [m["loss"] for m in logged if "loss" in m]
        assert len(losses[soft]) == 2 and all(np.isfinite(losses[soft]))
    assert losses[True] != losses[False]
    with pytest.raises(ValueError, match="raw-image branch"):
        main(argv + ["training.pre_encode=true", "training.use_soft_code_target=true"])
