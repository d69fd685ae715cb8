"""The port's training pieces vs the JAX package on the CPU, in fp32.

Masking runs on noise drawn with JAX from the train step's own key splits;
losses, schedules and the weight-decay mask are compared directly; and three
train steps of a tiny MaskGiTUViT_v2 (JAX weights carried across, the same
batch and masking noise) are held against ``make_uvit_train_step``.
"""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from open_muse_tpu.core.convert import flatten_dict
from open_muse_tpu.ops import losses as jlosses
from open_muse_tpu.ops.sampling import get_mask_schedule as jax_mask_schedule
from open_muse_tpu.training import lr_schedules as jlr
from open_muse_tpu.training import masking as jmasking
from open_muse_tpu.training import trainer as jtrainer
from open_muse_tpu.training.optimizers import decay_mask_fn
from open_muse_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from open_muse_tpu_torch.core.convert import jax_params_to_state_dict
from open_muse_tpu_torch.ops import losses as tlosses
from open_muse_tpu_torch.ops.sampling import get_mask_schedule
from open_muse_tpu_torch.training import lr_schedules as tlr
from open_muse_tpu_torch.training import trainer as ttrainer
from open_muse_tpu_torch.training.ema import EMA, ema_decay
from open_muse_tpu_torch.training.masking import MaskingNoise, mask_or_random_replace_tokens
from open_muse_tpu_torch.training.optimizers import decay_mask, flax_param_name, get_optimizer

from test_torch_models import uvit_inputs, uvit_pair


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_masking_noise(key, batch, seq, codebook, num_eval_ratios=None):
    """The draws ``mask_or_random_replace_tokens`` makes from ``key``."""
    _, t_key, mask_key, strat_key, noise_key = jax.random.split(key, 5)
    kh, _, ksh, ksw, kchoice = jax.random.split(strat_key, 5)
    uniform = lambda k, shape: _t(jax.random.uniform(k, shape))  # noqa: E731
    return MaskingNoise(
        timesteps=uniform(t_key, (batch,)), permutation=uniform(mask_key, (batch, seq)),
        rect=torch.stack([uniform(kh, (batch,)), uniform(ksh, (batch,)),
                          uniform(ksw, (batch,))]),
        use_rect=uniform(kchoice, ()),
        random_tokens=_t(jax.random.randint(noise_key, (batch, seq), 0, codebook)).long(),
        eval_index=None if num_eval_ratios is None
        else _t(jax.random.randint(t_key, (batch,), 0, num_eval_ratios)).long())


MASKING_CASES = {
    "mask": dict(noise_type="mask"),
    "predict_all": dict(noise_type="mask", predict_all_tokens=True, min_masking_rate=0.2),
    "random_replace": dict(noise_type="random_replace"),
    "contiguous": dict(noise_type="mask", mask_contiguous_region_prob=1.0),
}


@pytest.mark.parametrize("case", sorted(MASKING_CASES))
@pytest.mark.parametrize("schedule", ["linear", "cosine"])
def test_masking_matches_jax_on_jax_noise(case, schedule):
    """ids, labels exactly equal; mask_prob and loss_weight exactly equal
    under the linear schedule, within 1 ulp under cosine (XLA's and torch's
    fp32 cos differ in the last bit for ~5% of inputs)."""
    kwargs = MASKING_CASES[case]
    batch, seq, codebook, mask_id = 16, 256, 8192, 8255
    rs = np.random.RandomState(7)
    tokens = rs.randint(0, codebook, (batch, seq)).astype(np.int32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jmasking.mask_or_random_replace_tokens(
            key, jnp.asarray(tokens), mask_id, jax_mask_schedule(schedule),
            codebook_size=codebook, **kwargs)
        got = mask_or_random_replace_tokens(
            _t(tokens).long(), mask_id, get_mask_schedule(schedule),
            jax_masking_noise(key, batch, seq, codebook), codebook_size=codebook, **kwargs)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        ulp = 0 if schedule == "linear" else 1
        np.testing.assert_array_max_ulp(got[3].numpy(), np.asarray(want[3]), maxulp=ulp)
        assert (got[2] is None) == (want[2] is None)
        if got[2] is not None:
            np.testing.assert_array_max_ulp(got[2].numpy(), np.asarray(want[2]), maxulp=ulp)


def test_eval_masking_matches_jax():
    ratios = (0.1, 0.3, 0.5, 0.7, 0.9)
    tokens = np.random.RandomState(0).randint(0, 64, (8, 16)).astype(np.int32)
    key = jax.random.PRNGKey(3)
    want = jmasking.mask_or_random_replace_tokens(
        key, jnp.asarray(tokens), 67, jax_mask_schedule("cosine"),
        eval_mask_ratios=list(ratios), is_train=False)
    got = mask_or_random_replace_tokens(
        _t(tokens).long(), 67, get_mask_schedule("cosine"),
        jax_masking_noise(key, 8, 16, 64, num_eval_ratios=len(ratios)),
        eval_mask_ratios=ratios, is_train=False)
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))


def test_losses_match_jax():
    """fp32, rtol 1e-6 (log-softmax over 64 classes in another order)."""
    rs = np.random.RandomState(0)
    logits = rs.randn(2, 16, 64).astype(np.float32) * 3
    labels = rs.randint(0, 64, (2, 16))
    all_labels = labels.copy()
    labels[rs.rand(2, 16) < 0.4] = -100
    weight = rs.rand(2, 16).astype(np.float32)
    soft = rs.dirichlet(np.ones(64), (2, 16)).astype(np.float32)
    jl, tl = jnp.asarray(logits), _t(logits)
    for smoothing in (0.0, 0.1):
        np.testing.assert_allclose(
            float(tlosses.cross_entropy_loss(tl, _t(labels), smoothing)),
            float(jlosses.cross_entropy_loss(jl, jnp.asarray(labels), smoothing)), rtol=1e-6)
        np.testing.assert_allclose(
            float(tlosses.weighted_cross_entropy_loss(tl, _t(all_labels), _t(weight),
                                                      smoothing)),
            float(jlosses.weighted_cross_entropy_loss(jl, jnp.asarray(all_labels),
                                                      jnp.asarray(weight), smoothing)),
            rtol=1e-6)
    for drop_first in (True, False):
        want_soft = soft[:, 1:] if drop_first else soft
        np.testing.assert_allclose(
            float(tlosses.soft_target_cross_entropy(tl, _t(labels), _t(want_soft), drop_first)),
            float(jlosses.soft_target_cross_entropy(jl, jnp.asarray(labels),
                                                    jnp.asarray(want_soft), drop_first)),
            rtol=1e-6)


@pytest.mark.parametrize("name,kwargs", [
    ("constant", {}), ("constant_with_warmup", {}), ("linear", {}), ("cosine", {}),
    ("cosine", {"num_cycles": 1.5}), ("cosine_with_restarts", {"num_cycles": 3}),
    ("polynomial", {"power": 2.0, "lr_end": 1e-5}),
])
def test_schedules_match_jax(name, kwargs):
    """Steps 0..60 (warmup 10, 50 training steps: past the end too); rtol
    1e-6 plus 1e-6 of the base lr: JAX evaluates in fp32, the port in fp64,
    and a cosine's fp32 argument and 1 + cos lose a few ulps of base_lr."""
    args = dict(base_lr=3e-4, num_warmup_steps=10, num_training_steps=50, **kwargs)
    want_fn, got_fn = jlr.get_scheduler(name, **args), tlr.get_scheduler(name, **args)
    for step in range(61):
        want = float(want_fn(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(got_fn(step), want, rtol=1e-6, atol=3e-10)
    assert got_fn(0) == (0.0 if name != "constant" else 3e-4)


def test_decay_mask_matches_flax_names():
    """Every port parameter maps to a JAX leaf, all leaves are covered, and
    decay is decided as ``decay_mask_fn`` decides it (the port's norm
    scales are named ``weight`` and must not be decayed)."""
    jm, port = uvit_pair(0)
    want = {".".join(str(getattr(k, "key", k)) for k in path): bool(v)
            for path, v in jax.tree_util.tree_flatten_with_path(decay_mask_fn(jm.params))[0]}
    got = decay_mask(port)
    names = {name: flax_param_name(port, name) for name in got}
    assert sorted(names.values()) == sorted(want)
    assert {name: want[flax] for name, flax in names.items()} == got
    assert not got["transformer_layers.0.attn_layer_norm.weight"]
    assert got["transformer_layers.0.attention.query.weight"]


def test_ema_decay_matches_jax():
    for step in range(0, 40):
        assert ema_decay(step) == pytest.approx(float(jtrainer._ema_decay(jnp.int32(step))),
                                                rel=1e-6)


def _port_params(jax_params, port):
    state, unused = jax_params_to_state_dict(
        {k: np.asarray(v) for k, v in flatten_dict(jax.device_get(jax_params)).items()}, port)
    assert not unused
    return state


def test_train_step_matches_jax():
    """Three steps on the same batch and noise, warmup over 2 updates and
    global-norm clipping at 1.0 (it clips every step here).  Loss and grad
    norm to rtol 2e-5; params and the EMA shadow to atol 2e-6 after each
    update (fp32 on both sides, summation order; updates are ~1e-3); the
    first update has lr 0 and leaves the params bit-equal."""
    jm, port = uvit_pair(0)
    ids, ehs, cond, micro = uvit_inputs(1)
    ids = ids % jm.config.codebook_size  # image tokens are codebook ids
    mask_schedule, mask_id, codebook = "cosine", jm.config.mask_token_id, jm.config.codebook_size
    base_lr, warmup, clip = 1e-3, 2, 1.0
    tx = jax_get_optimizer("adamw", jlr.get_scheduler("constant_with_warmup", base_lr, warmup),
                           weight_decay=0.01, max_grad_norm=clip)
    jstate = jtrainer.create_train_state(jm.params, tx, with_ema=True)
    jstep = jtrainer.make_uvit_train_step(jm.module, tx, jax_mask_schedule(mask_schedule),
                                          mask_id, codebook_size=codebook)
    batch = {"image_tokens": jnp.asarray(ids), "encoder_hidden_states": jnp.asarray(ehs),
             "cond_embeds": jnp.asarray(cond), "micro_conds": jnp.asarray(micro)}

    port.train()
    optimizer = get_optimizer("adamw", port, tlr.get_scheduler("constant_with_warmup", base_lr,
                                                               warmup),
                              weight_decay=0.01, max_grad_norm=clip)
    state = ttrainer.TrainState(model=port, optimizer=optimizer, ema=EMA(port))
    step = ttrainer.make_uvit_train_step(get_mask_schedule(mask_schedule), mask_id,
                                         codebook_size=codebook)
    tbatch = {k: _t(np.asarray(v)) for k, v in batch.items()}
    tbatch["image_tokens"] = tbatch["image_tokens"].long()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    for i in range(3):
        key = jax.random.PRNGKey(100 + i)
        jstate, jmetrics = jstep(jstate, batch, key)
        mask_key, _ = jax.random.split(key)
        metrics = step(state, tbatch, jax_masking_noise(mask_key, *ids.shape, codebook))
        assert state.step == int(jstate.step) == i + 1
        for name in ("loss", "grad_norm", "avg_masking_rate"):
            np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]), rtol=2e-5,
                                       err_msg=name)
        want = _port_params(jstate.params, port)
        want_ema = _port_params(jstate.ema_params, port)
        for name, p in port.state_dict().items():
            if i == 0:
                assert torch.equal(p, before[name]), name
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=2e-6, rtol=0,
                                       err_msg=name)
            np.testing.assert_allclose(state.ema.shadow[name].numpy(), want_ema[name].numpy(),
                                       atol=2e-6, rtol=0, err_msg=name)
    assert float(metrics["grad_norm"]) > clip and math.isfinite(float(metrics["loss"]))


def test_eval_step_matches_jax():
    """Fixed eval ratios drawn with the same key; loss to rtol 2e-5."""
    jm, port = uvit_pair(2)
    ids, ehs, cond, micro = uvit_inputs(3)
    ids = ids % jm.config.codebook_size
    ratios = (0.1, 0.5, 0.9)
    key = jax.random.PRNGKey(5)
    want = jtrainer.make_uvit_eval_step(jm.module, jax_mask_schedule("cosine"),
                                        jm.config.mask_token_id, eval_mask_ratios=ratios)(
        jm.params, {"image_tokens": jnp.asarray(ids), "encoder_hidden_states": jnp.asarray(ehs),
                    "cond_embeds": jnp.asarray(cond), "micro_conds": jnp.asarray(micro)}, key)
    got = ttrainer.make_uvit_eval_step(get_mask_schedule("cosine"), jm.config.mask_token_id,
                                       eval_mask_ratios=ratios)(
        port, {"image_tokens": _t(ids).long(), "encoder_hidden_states": _t(ehs),
               "cond_embeds": _t(cond), "micro_conds": _t(micro)},
        jax_masking_noise(key, *ids.shape, jm.config.codebook_size, num_eval_ratios=len(ratios)))
    np.testing.assert_allclose(float(got), float(want), rtol=2e-5)


def test_generator_noise_is_seeded_and_shaped():
    from open_muse_tpu_torch.training.masking import draw_masking_noise

    draw = lambda: draw_masking_noise(4, 16, torch.Generator().manual_seed(9), 64, 5)  # noqa: E731
    a, b = draw(), draw()
    for name in ("timesteps", "permutation", "rect", "use_rect", "random_tokens", "eval_index"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.permutation.shape == (4, 16) and a.rect.shape == (3, 4) and a.use_rect.shape == ()
    assert int(a.random_tokens.max()) < 64 and int(a.eval_index.max()) < 5


def test_dots_remat_policy_is_refused():
    """The port takes JAX's remat settings, true, false and 'dots', and
    refuses any other policy by name."""
    _, port = uvit_pair(0)
    port.set_gradient_checkpointing("dots")
    assert port.gradient_checkpointing == "dots"
    with pytest.raises(ValueError, match="dots"):
        port.set_gradient_checkpointing("everything")


def _loss_and_grads_jax(jm, ids, ehs, cond, micro, labels):
    def loss_fn(params):
        return jm.module.apply({"params": params}, jnp.asarray(ids), jnp.asarray(ehs),
                               jnp.asarray(cond), jnp.asarray(micro),
                               labels=jnp.asarray(labels))[1]

    return jax.value_and_grad(loss_fn)(jm.params)


def test_dots_remat_matches_jax_and_full_remat():
    """Loss and grads of one masked batch with ``'dots'`` checkpointing
    (selective: the 2-D matmuls' outputs kept) against JAX ``remat='dots'``
    (loss rtol 2e-5, every grad atol 2e-6: fp32, summation order) and
    against the port's full checkpointing (``True``) and none, bit-equal:
    the recompute runs the same fp32 ops on the CPU."""
    from open_muse_tpu.models.transformer_v2 import MaskGiTUViT_v2 as JaxUViT
    from test_torch_models import UVIT_TINY

    jm, port = uvit_pair(0)
    jm_dots = JaxUViT(**UVIT_TINY, remat="dots", _defer_init=True)
    jm_dots.params = jm.params
    ids, ehs, cond, micro = uvit_inputs(1)
    ids = ids % jm.config.codebook_size
    key = jax.random.PRNGKey(8)
    input_ids, labels, _, _ = jmasking.mask_or_random_replace_tokens(
        key, jnp.asarray(ids), jm.config.mask_token_id, jax_mask_schedule("cosine"),
        codebook_size=jm.config.codebook_size)
    input_ids, labels = np.asarray(input_ids), np.asarray(labels)
    want_loss, want_grads = _loss_and_grads_jax(jm_dots, input_ids, ehs, cond, micro, labels)
    want = _port_params(want_grads, port)
    port.train()
    got = {}
    for mode in ("dots", True, False):
        port.set_gradient_checkpointing(mode)
        port.zero_grad(set_to_none=True)
        _, loss = port(_t(input_ids).long(), _t(ehs), _t(cond), _t(micro),
                       labels=_t(labels).long())
        loss.backward()
        got[mode] = (loss.detach(), {n: p.grad.clone() for n, p in port.named_parameters()})
    np.testing.assert_allclose(float(got["dots"][0]), float(want_loss), rtol=2e-5)
    for name, grad in got["dots"][1].items():
        np.testing.assert_allclose(grad.numpy(), want[name].numpy(), atol=2e-6, rtol=0,
                                   err_msg=name)
        for mode in (True, False):
            assert torch.equal(grad, got[mode][1][name]), (mode, name)
    assert torch.equal(got["dots"][0], got[True][0])


def _jax_and_port_steps(scheduler="constant_with_warmup", base_lr=1e-3, warmup=2, clip=1.0,
                        accumulation_steps=1, seed=0, **step_kwargs):
    """A tiny U-ViT in both packages with the same weights, each with its
    AdamW chain (``optax.MultiSteps`` around it for ``accumulation_steps``
    > 1) and EMA, and the train step of each."""
    import optax

    jm, port = uvit_pair(seed)
    mask_id, codebook = jm.config.mask_token_id, jm.config.codebook_size
    schedule = (scheduler, base_lr, warmup)
    tx = jax_get_optimizer("adamw", jlr.get_scheduler(*schedule), weight_decay=0.01,
                           max_grad_norm=clip)
    if accumulation_steps > 1:
        tx = optax.MultiSteps(tx, accumulation_steps)
    jstate = jtrainer.create_train_state(jm.params, tx, with_ema=True)
    jstep = jtrainer.make_uvit_train_step(jm.module, tx, jax_mask_schedule("cosine"), mask_id,
                                          codebook_size=codebook, **step_kwargs)
    port.train()
    optimizer = get_optimizer("adamw", port, tlr.get_scheduler(*schedule), weight_decay=0.01,
                              max_grad_norm=clip, accumulation_steps=accumulation_steps)
    state = ttrainer.TrainState(model=port, optimizer=optimizer, ema=EMA(port))
    step = ttrainer.make_uvit_train_step(get_mask_schedule("cosine"), mask_id,
                                         codebook_size=codebook, **step_kwargs)
    return jm, port, jstate, jstep, state, step


def _batches(jm, seed=1, batch=2):
    ids, ehs, cond, micro = uvit_inputs(seed, batch=batch)
    ids = ids % jm.config.codebook_size  # image tokens are codebook ids
    jbatch = {"image_tokens": jnp.asarray(ids), "encoder_hidden_states": jnp.asarray(ehs),
              "cond_embeds": jnp.asarray(cond), "micro_conds": jnp.asarray(micro)}
    tbatch = {k: _t(np.asarray(v)) for k, v in jbatch.items()}
    tbatch["image_tokens"] = tbatch["image_tokens"].long()
    return jbatch, tbatch


def _port_noise(key, ids, codebook, cond_dropout=False):
    """The port's noise from the JAX step's key: its masking key's draws and,
    with ``cond_dropout``, the uniform of its dropout key."""
    mask_key, drop_key = jax.random.split(key)
    noise = jax_masking_noise(mask_key, *ids.shape, codebook)
    if cond_dropout:
        noise.cond_dropout = _t(jax.random.uniform(drop_key, (ids.shape[0], 1, 1))).reshape(-1)
    return noise


def _assert_state_matches(state, jstate, port, atol=2e-6):
    want = _port_params(jstate.params, port)
    want_ema = _port_params(jstate.ema_params, port)
    for name, p in port.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=atol, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(state.ema.shadow[name].numpy(), want_ema[name].numpy(),
                                   atol=atol, rtol=0, err_msg=name)


def test_gradient_accumulation_matches_jax_multisteps():
    """``gradient_accumulation_steps`` 2 against ``optax.MultiSteps(tx, 2)``
    over 3 calls at a constant lr, each on other masking noise: call 1
    accumulates (params bit-equal to the start), call 2 folds in its grads,
    clips the mean by the mean's own norm (the clip at 1.0 binds), updates
    and zeroes the mean, call 3 accumulates again; the EMA and the step
    count move every call, the update count only on call 2.  Loss, grad
    norm (the micro-batch's) and masking rate to rtol 2e-5; the running
    mean (``acc_grads``) to rtol 1e-4 plus atol 2e-6 (as grads are held
    elsewhere) and AdamW's moments (``mu``, ``nu``: 0.1 x the clipped mean,
    0.001 x its square) to rtol 1e-4 plus atol 2e-7 / 1e-10; params and the
    EMA shadow
    to atol 2e-6 where the first moment exceeds 1e-7 (ten times eps, times 1
    - beta1).  Below that, Adam's m / (sqrt(v) + eps) turns the fp32
    summation noise of a grad near eps into a step of up to the lr, so
    those elements are held to atol lr."""
    base_lr = 1e-4
    jm, port, jstate, jstep, state, step = _jax_and_port_steps("constant", base_lr=base_lr,
                                                               accumulation_steps=2)
    jbatch, tbatch = _batches(jm)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    params = dict(port.named_parameters())

    def jax_leaves(tree):
        return _port_params(tree, port)

    for i in range(3):
        key = jax.random.PRNGKey(200 + i)
        jstate, jmetrics = jstep(jstate, jbatch, key)
        metrics = step(state, tbatch, _port_noise(key, tbatch["image_tokens"],
                                                  jm.config.codebook_size))
        assert state.step == int(jstate.step) == i + 1
        assert state.optimizer.count == (0 if i == 0 else 1)
        assert state.optimizer.mini_step == int(jstate.opt_state.mini_step) == (i + 1) % 2
        for name in ("loss", "grad_norm", "avg_masking_rate"):
            np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]), rtol=2e-5,
                                       err_msg=name)
        acc = jax_leaves(jstate.opt_state.acc_grads)
        adam = jstate.opt_state.inner_opt_state[1][0]
        mu, nu = jax_leaves(adam.mu), jax_leaves(adam.nu)
        want, want_ema = jax_leaves(jstate.params), jax_leaves(jstate.ema_params)
        moments = state.optimizer.torch_optimizer.state
        for (name, p), a in zip(params.items(), state.optimizer.acc):
            np.testing.assert_allclose(a.numpy(), acc[name].numpy(), rtol=1e-4, atol=2e-6,
                                       err_msg=name)
            if i:
                for ours, theirs, atol in (("exp_avg", mu, 2e-7), ("exp_avg_sq", nu, 1e-10)):
                    np.testing.assert_allclose(moments[p][ours].numpy(), theirs[name].numpy(),
                                               rtol=1e-4, atol=atol, err_msg=(ours, name))
            sharp = (mu[name].abs() > 1e-7).numpy()
            for got, ref in ((p.detach(), want[name]), (state.ema.shadow[name], want_ema[name])):
                err = np.abs(got.numpy() - ref.numpy())
                assert err[sharp].max(initial=0) <= 2e-6, name
                assert err.max() <= base_lr, name
            if i == 0:
                assert torch.equal(p, before[name]), name
            if i == 1:
                assert not torch.equal(p, before[name]), name


def test_cond_dropout_matches_jax():
    """CFG cond dropout at probability 0.5 with the empty prompt's
    embeddings, two steps at batch 4: the dropout uniforms are those of the
    JAX step's dropout key, some images keep their text and some drop it.
    Loss and grad norm to rtol 2e-5, params and EMA to atol 2e-6."""
    jm, port, jstate, jstep, state, step = _jax_and_port_steps(cond_dropout_prob=0.5)
    jbatch, tbatch = _batches(jm, seed=4, batch=4)
    rs = np.random.RandomState(9)
    empty = {"empty_embeds": rs.randn(1, 7, 48).astype(np.float32),
             "empty_cond_embeds": rs.randn(1, 32).astype(np.float32)}
    jbatch.update({k: jnp.asarray(v) for k, v in empty.items()})
    tbatch.update({k: _t(v) for k, v in empty.items()})
    dropped = []
    for i in range(2):
        key = jax.random.PRNGKey(300 + i)
        jstate, jmetrics = jstep(jstate, jbatch, key)
        noise = _port_noise(key, tbatch["image_tokens"], jm.config.codebook_size,
                            cond_dropout=True)
        dropped += (noise.cond_dropout < 0.5).tolist()
        metrics = step(state, tbatch, noise)
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]), rtol=2e-5,
                                       err_msg=name)
        _assert_state_matches(state, jstate, port)
    assert any(dropped) and not all(dropped)


def test_step_diagnostics_and_param_grad_norms_match_jax():
    """``with_diagnostics`` and ``with_param_grad_norms`` at batch 8 (every
    masked-fraction decile a few images): the four bucket metrics (10 and
    10 x 11 values, NaN where a bucket is empty, at the same places) and the
    per-parameter grad norms, named by the JAX package's
    ``grad_norm_param_names`` in its order, to rtol 2e-5 / atol 1e-6."""
    kwargs = dict(with_diagnostics=True, with_param_grad_norms=True)
    jm, port, jstate, jstep, state, step = _jax_and_port_steps(**kwargs)
    jbatch, tbatch = _batches(jm, seed=6, batch=8)
    key = jax.random.PRNGKey(400)
    jstate, jmetrics = jstep(jstate, jbatch, key)
    metrics = step(state, tbatch, _port_noise(key, tbatch["image_tokens"],
                                              jm.config.codebook_size))
    assert ttrainer.grad_norm_param_names(port) == jtrainer.grad_norm_param_names(jm.params)
    for name in ("pixel_entropy_by_bucket", "image_entropy_by_bucket",
                 "cross_entropy_by_bucket", "token_prob_deciles_by_bucket",
                 "param_grad_norms"):
        want = np.asarray(jmetrics[name])
        assert metrics[name].shape == want.shape, name
        np.testing.assert_allclose(metrics[name].numpy(), want, rtol=2e-5, atol=1e-6,
                                   err_msg=name)
    assert np.isfinite(metrics["token_prob_deciles_by_bucket"].numpy()).any()
