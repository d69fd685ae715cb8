"""Step and guidance distillation in the port against the JAX package, on the
CPU in fp32.

A tiny MaskGiTUViT_v2 (JAX weights carried across) is both teacher and
student.  Sampling matches JAX only in distribution, so every draw of a JAX
distill step is made with JAX from the step's own key splits (``key,
traj_key, t_key``; the decode's per-step ``key, sample_key, mask_key``) and
handed to the port; the trajectory's token ids must then be equal, and the
loss, the soft KL and the parameters after the update within the stated
tolerances.
"""

import copy
import functools
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from open_muse_tpu.models.transformer_v2 import decode_schedules as jax_schedules
from open_muse_tpu.models.transformer_v2 import parallel_decode_loop as jax_decode_loop
from open_muse_tpu.training import distill as jdistill
from open_muse_tpu.training import trainer as jtrainer
from open_muse_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder
from open_muse_tpu_torch.models.transformer_v2 import decode_schedules, parallel_decode_loop
from open_muse_tpu_torch.training import distill
from open_muse_tpu_torch.training import trainer as ttrainer
from open_muse_tpu_torch.training.ema import EMA
from open_muse_tpu_torch.training.optimizers import get_optimizer
from test_torch_models import CLIP_TINY, UVIT_TINY, uvit_pair
from test_torch_pipeline import jax_noise
from test_torch_training import _port_params

SEQ, TIMESTEPS, RATIO, GUIDANCE, TEMPERATURE = 16, 4, 2, 3.0, (2.0, 0.0)
LR = 1e-3
CODEBOOK = UVIT_TINY["codebook_size"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny models gain nothing from torch's intra-op threads, and the
    parallel test workers share the cores: one thread each, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def text_batch(seed=0, batch=3):
    rs = np.random.RandomState(seed)
    return {"encoder_hidden_states": rs.randn(batch, 7, 48).astype(np.float32),
            "cond_embeds": rs.randn(batch, 32).astype(np.float32),
            "micro_conds": np.asarray([[256, 256, 0, 0, 6.0]] * batch, np.float32),
            "empty_embeds": (0.1 * rs.randn(1, 7, 48)).astype(np.float32),
            "empty_cond_embeds": (0.1 * rs.randn(1, 32)).astype(np.float32)}


def jax_step_noise(key, batch):
    """The draws of the JAX distill step at ``key``: the trajectory's
    Gumbel noise from ``traj_key`` and the pair from ``t_key``."""
    _, traj_key, t_key = jax.random.split(key, 3)
    sample, mask = jax_noise(traj_key, TIMESTEPS, batch, SEQ, CODEBOOK)
    pair = _t(jax.random.randint(t_key, (batch,), 0, TIMESTEPS // RATIO)).long()
    return distill.DistillNoise(mask_gumbel=mask, pair=pair, sample_gumbel=sample), traj_key


@pytest.fixture(scope="module")
def models():
    return uvit_pair(5)


@pytest.mark.parametrize("guidance", [GUIDANCE, 0.0])
def test_return_trajectory_equals_jax(models, guidance):
    """states (the carry-in ids, all masks at t 0), sampled (each step's
    committed grid) and the final ids equal to JAX's ``return_trajectory``
    under the same noise, with CFG and without."""
    jm, port = models
    b = text_batch(1)
    use_cfg = guidance > 0
    ehs, cond, micro = b["encoder_hidden_states"], b["cond_embeds"], b["micro_conds"]
    if use_cfg:
        ehs = np.concatenate([ehs, np.broadcast_to(b["empty_embeds"], ehs.shape)])
        cond = np.concatenate([cond, np.broadcast_to(b["empty_cond_embeds"], cond.shape)])
        micro = np.concatenate([micro, micro])
    key = jax.random.PRNGKey(3)
    temps, gscales, ratios = jax_schedules(TIMESTEPS, TEMPERATURE, guidance)
    ids = jnp.full((3, SEQ), jm.config.mask_token_id, jnp.int32)
    want = jax.jit(functools.partial(
        jax_decode_loop, jm.module.apply, jm.config, use_cfg=use_cfg, seq_len=SEQ,
        timesteps=TIMESTEPS, return_trajectory=True))(
        jm.params, ids, jnp.asarray(ehs), jnp.asarray(cond), jnp.asarray(micro), key, temps,
        gscales, ratios)
    sample, mask = jax_noise(key, TIMESTEPS, 3, SEQ, CODEBOOK)
    t_temps, t_gscales, t_ratios = decode_schedules(TIMESTEPS, TEMPERATURE, guidance)
    got = parallel_decode_loop(
        port, _t(ids).long(), _t(ehs), _t(cond), _t(micro), t_temps,
        tuple(t_gscales.tolist()) if use_cfg else None, t_ratios, use_cfg=use_cfg, seq_len=SEQ,
        timesteps=TIMESTEPS, mask_gumbel=mask, sample_gumbel=sample, return_trajectory=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].shape == (TIMESTEPS, 3, SEQ)
    assert bool((got[1][0] == jm.config.mask_token_id).all())
    assert not bool((got[2] == jm.config.mask_token_id).any())


def _jax_side(jm, soft_weight):
    tx = jax_get_optimizer("adamw", LR)
    step = jdistill.make_distill_step(
        jm.module, tx, mask_token_id=jm.config.mask_token_id, teacher_timesteps=TIMESTEPS,
        step_ratio=RATIO, temperature=TEMPERATURE, guidance_scale=GUIDANCE, seq_len=SEQ,
        max_grad_norm=1.0, soft_weight=soft_weight)
    teacher = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), jm.params)
    state = jtrainer.create_train_state(
        jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), jm.params), tx, with_ema=True)
    return step, teacher, state


def _port_side(port, soft_weight):
    student = copy.deepcopy(port).train()
    step = distill.make_distill_step(
        distill.frozen_teacher(port), mask_token_id=port.config.mask_token_id,
        teacher_timesteps=TIMESTEPS, step_ratio=RATIO, temperature=TEMPERATURE,
        guidance_scale=GUIDANCE, seq_len=SEQ, max_grad_norm=1.0, soft_weight=soft_weight)
    state = ttrainer.TrainState(model=student, optimizer=get_optimizer("adamw", student, LR),
                                ema=EMA(student))
    return step, state


@pytest.mark.parametrize("soft_weight", [0.5, 0.0])
def test_distill_steps_match_jax(models, soft_weight):
    """Two distill steps (12-step-like CFG teacher cut to 4 steps, pairs of 2,
    temperature (2, 0), guidance 3, clip 1.0, AdamW at 1e-3, EMA) under
    JAX-drawn noise, with the soft KL term and without: the teacher's
    trajectory ids exactly JAX's; loss, soft_kl and grad_norm to rtol 2e-5;
    avg_masked_frac and avg_pair_step (means of equal ids) to rtol 1e-6;
    after each step the student's parameters within 1e-3 (one update) of
    JAX's, and at most 0.1% of their
    elements beyond 2e-6 (Adam's m / (sqrt(v) + eps) at a gradient near
    eps); the EMA the same way; the teacher untouched."""
    jm, port = models
    jstep, jteacher, jstate = _jax_side(jm, soft_weight)
    step, state = _port_side(port, soft_weight)
    teacher_before = {k: v.clone() for k, v in step.spec.teacher.state_dict().items()}
    b = text_batch(2)
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    tbatch = {k: _t(v) for k, v in b.items()}
    for i in range(2):
        key = jax.random.PRNGKey(40 + i)
        noise, traj_key = jax_step_noise(key, 3)
        # the trajectory the JAX step decodes from traj_key
        temps, gscales, ratios = jax_schedules(TIMESTEPS, TEMPERATURE, GUIDANCE)
        t_ehs = jnp.concatenate([jbatch["encoder_hidden_states"],
                                 jnp.broadcast_to(jbatch["empty_embeds"], (3, 7, 48))])
        t_cond = jnp.concatenate([jbatch["cond_embeds"],
                                  jnp.broadcast_to(jbatch["empty_cond_embeds"], (3, 32))])
        _, jstates, jsampled = jax_decode_loop(
            jm.module.apply, jm.config, jteacher,
            jnp.full((3, SEQ), jm.config.mask_token_id, jnp.int32), t_ehs, t_cond,
            jnp.concatenate([jbatch["micro_conds"]] * 2), traj_key, temps, gscales, ratios,
            use_cfg=True, seq_len=SEQ, timesteps=TIMESTEPS, return_trajectory=True)
        state_in, target, _, t_in = distill.teacher_targets(
            step.spec, {**tbatch, **step.spec.step_inputs(0, "cpu")}, noise)
        rows = torch.arange(3)
        np.testing.assert_array_equal(state_in.numpy(), np.asarray(jstates)[t_in, rows])
        np.testing.assert_array_equal(target.numpy(), np.asarray(jsampled)[t_in + RATIO - 1, rows])

        jstate, jmetrics = jstep(jstate, jteacher, jbatch, key)
        metrics = step(state, tbatch, noise)
        assert set(metrics) == set(jmetrics)
        for name in ("loss", "grad_norm") + (("soft_kl",) if soft_weight else ()):
            np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]), rtol=2e-5,
                                       err_msg=name)
        for name in ("avg_masked_frac", "avg_pair_step"):  # means of equal ids
            np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]), rtol=1e-6,
                                       err_msg=name)
        for got, want in ((dict(state.model.named_parameters()), jstate.params),
                          (state.ema.shadow, jstate.ema_params)):
            want = _port_params(want, state.model)
            moved = 0
            for name, p in got.items():
                diff = (p.detach() - want[name]).abs()
                assert float(diff.max()) <= LR, (i, name, float(diff.max()))
                moved += int((diff > 2e-6).sum())
            assert moved <= 1e-3 * sum(p.numel() for p in got.values()), (i, moved)
    for k, v in step.spec.teacher.state_dict().items():
        assert torch.equal(v, teacher_before[k]), k
    assert state.step == 2 and state.optimizer.count == 2


def test_distilled_generate_equals_jax(models):
    """The student's 2-step (4 // 2) CFG-free decode: token ids equal to JAX's
    ``distilled_generate`` under the same noise."""
    jm, port = models
    b = text_batch(4, batch=2)
    key = jax.random.PRNGKey(9)
    want = jdistill.distilled_generate(
        jm, jnp.asarray(b["encoder_hidden_states"]), jnp.asarray(b["cond_embeds"]),
        jnp.asarray(b["micro_conds"]), teacher_timesteps=TIMESTEPS, step_ratio=RATIO,
        temperature=TEMPERATURE, seq_len=SEQ, key=key)
    got = distill.distilled_generate(
        port, _t(b["encoder_hidden_states"]), _t(b["cond_embeds"]), _t(b["micro_conds"]),
        teacher_timesteps=TIMESTEPS, step_ratio=RATIO, temperature=TEMPERATURE, seq_len=SEQ,
        noise=jax_noise(key, TIMESTEPS // RATIO, 2, SEQ, CODEBOOK))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _main_argv(tmp_path, teacher_dir, clip_dir, steps, out="out"):
    from test_torch_train_cli import REPO_ROOT

    return [f"config={os.path.join(REPO_ROOT, 'configs', 'distill.yaml')}",
            f"experiment.output_dir={tmp_path / out}", "experiment.save_every=2",
            "experiment.log_every=1", "experiment.resume_from_checkpoint=latest",
            f"distill.teacher_checkpoint={teacher_dir}",
            "distill.prompts_file=" + os.path.join(REPO_ROOT, "validation_prompts",
                                                   "cc_validation_prompts.txt"),
            f"distill.teacher_timesteps={TIMESTEPS}", "distill.resolution=64",
            f"model.text_encoder.pretrained={clip_dir}", "training.batch_size=2",
            f"training.max_train_steps={steps}", "lr_scheduler.params.warmup_steps=1",
            "device=cpu"]


def test_distill_main_end_to_end_and_resume(tmp_path, models):
    """``distill.main`` on ``configs/distill.yaml`` at tiny size on the CPU
    (a saved tiny teacher and CLIP tower without tokenizer files, the 32
    validation prompts, 4x4 tokens): 3 steps with the config's guidance 8,
    temperature (2, 0), pairs of 2, soft weight 0.5, EMA and clip; a metrics
    line a step with finite loss and soft_kl; checkpoints at 2 and 3.  A run
    stopped at step 2 and resumed from its checkpoint ends with the
    parameters, EMA and AdamW moments of the run that never stopped, bit for
    bit."""
    _, port = models
    teacher_dir, clip_dir = str(tmp_path / "teacher"), str(tmp_path / "clip")
    port.save_pretrained(teacher_dir)
    torch.manual_seed(0)
    CLIPTextEncoder(**{**CLIP_TINY, "hidden_size": 48, "projection_dim": 32}).save_pretrained(
        clip_dir)
    straight = distill.main(_main_argv(tmp_path, teacher_dir, clip_dir, 3, "straight"))
    with open(tmp_path / "straight" / "metrics.jsonl") as f:
        logged = [json.loads(line) for line in f]
    assert [m["step"] for m in logged] == [1, 2, 3]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["soft_kl"]) for m in logged)
    assert sorted(d for d in os.listdir(tmp_path / "straight") if d.startswith("checkpoint-")) \
        == ["checkpoint-2", "checkpoint-3"]
    distill.main(_main_argv(tmp_path, teacher_dir, clip_dir, 2))
    resumed = distill.main(_main_argv(tmp_path, teacher_dir, clip_dir, 3))
    assert resumed.step == straight.step == 3
    for (name, p), q in zip(straight.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(straight.ema.shadow[name], resumed.ema.shadow[name]), name
        for key, value in straight.optimizer.torch_optimizer.state[p].items():
            assert torch.equal(value, resumed.optimizer.torch_optimizer.state[q][key]), (name, key)
