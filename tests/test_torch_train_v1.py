"""The v1 trainers of the port against the JAX package, on the CPU in fp32:
the v1 forward's training routes (``hidden_dropout``, ``cond_dropout_mask``),
``make_maskgit_train_step`` and ``make_v1_text2image_train_step`` over three
steps, ``ClassificationDataset``, and the two entry points end to end
(``train_maskgit_imagenet.main``, ``train_muse.main`` with
``model.architecture: transformer``) at tiny size.

The JAX steps draw their noise from key splits: masking from the first key,
the cond-dropout uniform from ``drop`` and the model's ``nn.Dropout`` masks
from ``dropout``.  The same draws go to the port: the masking noise and the
uniform as arrays, and the dropout keep masks, recovered from a
``deterministic=False`` apply of the JAX module with
``flax.linen.intercept_methods``, through the forward's ``dropout`` source.
"""

import io
import json
import math
import os
import tarfile

import numpy as np
import pytest
import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch

from open_muse_tpu.models.clip_text import CLIPTextEncoder as JaxCLIP
from open_muse_tpu.models.transformer_v1 import MaskGitTransformer as JaxV1
from open_muse_tpu.ops.sampling import get_mask_schedule as jax_mask_schedule
from open_muse_tpu.training import data as jdata
from open_muse_tpu.training import lr_schedules as jlr
from open_muse_tpu.training import trainer as jtrainer
from open_muse_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder
from open_muse_tpu_torch.models.maskgit_vqgan import MaskGitVQGAN
from open_muse_tpu_torch.models.taming_vqgan import VQGANModel
from open_muse_tpu_torch.models.transformer_v1 import KeepMasks, MaskGitTransformer
from open_muse_tpu_torch.ops.sampling import get_mask_schedule
from open_muse_tpu_torch.training import lr_schedules as tlr
from open_muse_tpu_torch.training import trainer as ttrainer
from open_muse_tpu_torch.training import train_maskgit_imagenet, train_muse
from open_muse_tpu_torch.training.data import ClassificationDataset
from open_muse_tpu_torch.training.ema import EMA
from open_muse_tpu_torch.training.masking import cond_keep_mask, prepend_class_token
from open_muse_tpu_torch.training.optimizers import get_optimizer
from open_muse_tpu_torch.utils.config import load_config
from test_torch_models import VQGAN_TINY, assert_close, port_of, random_params
from test_torch_pipeline import CLIP_FOR_UVIT
from test_torch_train_cli import REPO_ROOT, make_preencoded_shard
from test_torch_training import _port_params, _t, jax_masking_noise
from test_torch_v1 import MASKGIT_VQ_TINY, REL, T5_FOR_V1, V1_CASES

RATE = 0.1  # hidden_dropout, the JAX class default


def v1_pair_with_dropout(case, seed=0, rate=RATE):
    jm = JaxV1(**{**V1_CASES[case], "hidden_dropout": rate}, _defer_init=True)
    port, unused = port_of(jm, MaskGitTransformer, random_params(jm, seed))
    assert not unused, unused
    return jm, port


def jax_keep_masks(jm, params, dropout_key, *args):
    """The keep masks the JAX module's ``nn.Dropout`` sites draw from
    ``dropout_key`` in a ``deterministic=False`` apply, in call order, and
    the apply's output.  Each site runs on ones (its output is 1 / keep_prob
    where it keeps, 0 elsewhere) and returns what flax's Dropout returns for
    its real input, ``where(keep, x / keep_prob, 0)``: one draw a site, as
    without the interceptor."""
    masks = []

    def interceptor(next_fun, call_args, call_kwargs, context):
        if not isinstance(context.module, fnn.Dropout) or context.method_name != "__call__":
            return next_fun(*call_args, **call_kwargs)
        x = call_args[0]
        keep = np.asarray(next_fun(jnp.ones_like(x), *call_args[1:], **call_kwargs)) != 0
        masks.append(keep)
        return jnp.where(keep, x / (1.0 - context.module.rate), 0)

    with fnn.intercept_methods(interceptor):
        out = jm.module.apply({"params": params}, *args, deterministic=False,
                              rngs={"dropout": dropout_key})
    return masks, out


class Injected:
    """A dropout source handing over given keep masks in order (the port's
    sites run in the JAX module's order)."""

    def __init__(self, masks=()):
        self.masks = list(masks)

    def __call__(self, shape, keep_prob, device):
        assert math.isclose(keep_prob, 1 - RATE)
        keep = torch.from_numpy(self.masks.pop(0))
        assert keep.shape == shape, (keep.shape, shape)
        return keep.to(device)


def _inputs(case, batch, seed):
    cfg = V1_CASES[case]
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg["vocab_size"], size=(batch, cfg["num_vq_tokens"] + 1))
    labels = rs.randint(0, cfg["codebook_size"], size=ids.shape)
    labels[:, ::3] = -100
    ehs = rs.randn(batch, 5, 48).astype(np.float32) if cfg.get("add_cross_attention") else None
    return ids.astype(np.int32), labels.astype(np.int32), ehs


@pytest.mark.parametrize("case", ["imagenet_like", "text_rms_bias"])
def test_v1_dropout_forward_matches_jax(case):
    """``hidden_dropout`` 0.1 at ``deterministic=False``: the JAX module's
    keep masks (after the embeddings, before each FFN's ``wo``: 1 + 2
    sites) injected into the port's forward, whose logits and loss match
    the JAX apply's within REL of the largest logit (fp32, summation order)
    and rtol 1e-5; the text case also drops the text of image 1
    (``cond_dropout_mask``).  The interceptor does not change the JAX
    output, and without masks the port's forward is the deterministic one."""
    jm, port = v1_pair_with_dropout(case, seed=len(case))
    ids, labels, ehs = _inputs(case, 3, 2)
    args = (jnp.asarray(ids),)
    targs = (torch.from_numpy(ids).long(),)
    kwargs = {}
    if ehs is not None:
        mask = np.array([1.0, 0.0, 1.0], np.float32)[:, None, None]
        args += (jnp.asarray(ehs), None, jnp.asarray(labels), 0.0, jnp.asarray(mask))
        targs += (torch.from_numpy(ehs),)
        kwargs = {"cond_dropout_mask": torch.from_numpy(mask)}
    else:
        args += (None, None, jnp.asarray(labels))
    key = jax.random.PRNGKey(7)
    masks, (want_logits, want_loss) = jax_keep_masks(jm, jm.params, key, *args)
    plain_logits, _ = jm.module.apply({"params": jm.params}, *args, deterministic=False,
                                      rngs={"dropout": key})
    np.testing.assert_array_equal(np.asarray(plain_logits), np.asarray(want_logits))
    assert len(masks) == 1 + V1_CASES[case]["num_hidden_layers"]
    assert all(0.75 < m.mean() < 0.97 for m in masks), [m.mean() for m in masks]
    with torch.no_grad():
        logits, loss = port(*targs, labels=torch.from_numpy(labels).long(),
                            dropout=Injected(masks), **kwargs)
        deterministic, _ = port(*targs, labels=torch.from_numpy(labels).long(), **kwargs)
    assert_close(logits, want_logits, REL)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_det = jm.module.apply({"params": jm.params}, *args)[0]
    assert_close(deterministic, want_det, REL)


def test_cond_dropout_mask_applies_after_the_projection():
    """``project_encoder_hidden_states=True`` (RMSNorm, biases): the mask
    multiplies the projected and normed text states, as in the JAX module
    (within REL); the kept images' logits equal the unmasked forward's, the
    dropped image's equal those of a forward that drops every image, and
    differ from zero text states fed in before the projection."""
    jm, port = v1_pair_with_dropout("text_rms_bias", seed=3, rate=0.0)
    ids, _, ehs = _inputs("text_rms_bias", 3, 4)
    mask = np.array([1.0, 0.0, 1.0], np.float32)[:, None, None]
    want = jm.module.apply({"params": jm.params}, jnp.asarray(ids), jnp.asarray(ehs), None,
                           None, 0.0, jnp.asarray(mask))
    tids, tehs = torch.from_numpy(ids).long(), torch.from_numpy(ehs)
    with torch.no_grad():
        got = port(tids, tehs, cond_dropout_mask=torch.from_numpy(mask))
        unmasked = port(tids, tehs)
        all_dropped = port(tids, tehs, cond_dropout_mask=torch.zeros(3, 1, 1))
        # zero text states before the projection: its bias and norm make them nonzero
        raw_zero = port(tids, torch.zeros_like(tehs))
    assert_close(got, want, REL)
    torch.testing.assert_close(got[[0, 2]], unmasked[[0, 2]], rtol=0, atol=0)
    assert not torch.allclose(got[1], unmasked[1])
    torch.testing.assert_close(got[1], all_dropped[1], rtol=0, atol=0)
    assert not torch.allclose(got[1], raw_zero[1])


def test_dropout_at_rate_zero_draws_nothing():
    """At ``hidden_dropout`` 0 a given source is never called (nothing is
    drawn or launched) and the forward is bit-equal to the deterministic
    one; the class token helper shifts ids past the codebook, label -100."""
    _, port = v1_pair_with_dropout("imagenet_like", seed=1, rate=0.0)
    ids, labels, _ = _inputs("imagenet_like", 2, 5)

    def never(*args):
        raise AssertionError("drew at rate 0")

    with torch.no_grad():
        got = port(torch.from_numpy(ids).long(), dropout=never)
        want = port(torch.from_numpy(ids).long())
    assert torch.equal(got, want)
    tids, tlabels = prepend_class_token(torch.tensor([[5, 6]]), torch.tensor([[-100, 6]]),
                                        torch.tensor([3], dtype=torch.int32), 64)
    assert tids.tolist() == [[67, 5, 6]] and tlabels.tolist() == [[-100, -100, 6]]
    keep = cond_keep_mask(torch.tensor([0.05, 0.5]), 0.1, torch.float32)
    assert keep.shape == (2, 1, 1) and keep.flatten().tolist() == [0.0, 1.0]


def _states(case, jax_step_fn, port_step_fn, clip=1.0, base_lr=1e-3, **kw):
    """The tiny v1 model (dropout 0.1) in both packages, each with AdamW
    (warmup over 2 updates, clip ``clip``) and an EMA, and its step."""
    jm, port = v1_pair_with_dropout(case)
    cfg = jm.config
    schedule = ("constant_with_warmup", base_lr, 2)
    tx = jax_get_optimizer("adamw", jlr.get_scheduler(*schedule), weight_decay=0.01,
                           max_grad_norm=clip)
    jstate = jtrainer.create_train_state(jm.params, tx, with_ema=True)
    jstep = jax_step_fn(jm.module, tx, jax_mask_schedule("cosine"), cfg.mask_token_id,
                        codebook_size=cfg.codebook_size, **kw.get("jax", {}))
    port.train()
    optimizer = get_optimizer("adamw", port, tlr.get_scheduler(*schedule), weight_decay=0.01,
                              max_grad_norm=clip)
    state = ttrainer.TrainState(model=port, optimizer=optimizer, ema=EMA(port))
    step = port_step_fn(get_mask_schedule("cosine"), cfg.mask_token_id,
                        codebook_size=cfg.codebook_size, dropout=Injected(), **kw.get("port", {}))
    return jm, port, jstate, jstep, state, step


def _assert_params(state, jstate, port, lr, initial=None):
    """Params and EMA against JAX to atol 2e-6 where AdamW's first moment
    exceeds 1e-7 (ten times eps, times 1 - beta1).  Below that, as in
    ``test_gradient_accumulation_matches_jax_multisteps``, m / (sqrt(v) +
    eps) turns the fp32 summation noise of a gradient that is zero in exact
    arithmetic (the attention key biases: a constant added to one query's
    logits) into a step of up to the lr, so those elements are held to atol
    lr.  With ``initial``, the EMA is exactly the initial weights on both
    sides."""
    want = _port_params(jstate.params, port)
    want_ema = _port_params(jstate.ema_params, port)
    moments = state.optimizer.torch_optimizer.state
    for name, p in port.named_parameters():
        sharp = (moments[p]["exp_avg"].abs() > 1e-7).numpy()
        for got, ref in ((p.detach(), want[name]), (state.ema.shadow[name], want_ema[name])):
            err = np.abs(got.numpy() - ref.numpy())
            assert err[sharp].max(initial=0) <= 2e-6, (name, err[sharp].max())
            assert err.max() <= lr, (name, err.max())
        if initial is not None:
            assert torch.equal(state.ema.shadow[name], initial[name]), name
            assert torch.equal(want_ema[name], initial[name]), name


def _assert_metrics(metrics, jmetrics):
    for name in ("loss", "grad_norm", "avg_masking_rate"):
        np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]), rtol=2e-5,
                                   err_msg=name)


def test_maskgit_train_step_matches_jax():
    """Three class-conditional steps at batch 3 (class ids prepended,
    dropout 0.1 on the JAX step's own masks): loss, grad norm and masking
    rate to rtol 2e-5, params as ``_assert_params`` holds them after each
    (fp32, summation order); the EMA moves on neither side (the JAX trainer
    passes no ``ema_decay``)."""
    jm, port, jstate, jstep, state, step = _states(
        "imagenet_like", jtrainer.make_maskgit_train_step, ttrainer.make_maskgit_train_step)
    cfg = jm.config
    rs = np.random.RandomState(11)
    tokens = rs.randint(0, cfg.codebook_size, size=(3, cfg.num_vq_tokens)).astype(np.int32)
    class_ids = np.array([0, 3, 1], np.int32)
    jbatch = {"image_tokens": jnp.asarray(tokens), "class_ids": jnp.asarray(class_ids)}
    initial = {k: v.clone() for k, v in port.state_dict().items()}
    tbatch = {"image_tokens": _t(tokens).long(), "class_ids": _t(class_ids).long()}
    for i in range(3):
        key = jax.random.PRNGKey(500 + i)
        mask_key, dropout_key = jax.random.split(key)
        masks, _ = jax_keep_masks(jm, jstate.params, dropout_key,
                                  jnp.zeros((3, cfg.num_vq_tokens + 1), jnp.int32))
        jstate, jmetrics = jstep(jstate, jbatch, key)
        step.spec.dropout.masks = masks
        metrics = step(state, tbatch, jax_masking_noise(mask_key, *tokens.shape,
                                                        cfg.codebook_size))
        assert not step.spec.dropout.masks and state.step == int(jstate.step) == i + 1
        _assert_metrics(metrics, jmetrics)
        _assert_params(state, jstate, port, 1e-3, initial)


def test_v1_text2image_train_step_matches_jax():
    """Three text steps at batch 4 (projected text states, CFG cond dropout
    at 0.5 from the ``drop`` key's uniforms, some images dropped and some
    kept, dropout 0.1, the EMA at 0.9999): loss, grad norm and masking rate
    to rtol 2e-5; params and the EMA shadow as ``_assert_params`` holds
    them after each."""
    jm, port, jstate, jstep, state, step = _states(
        "text_rms_bias", jtrainer.make_v1_text2image_train_step,
        ttrainer.make_v1_text2image_train_step,
        jax={"cond_dropout_prob": 0.5, "ema_decay": 0.9999}, port={"cond_dropout_prob": 0.5})
    cfg = jm.config
    rs = np.random.RandomState(12)
    tokens = rs.randint(0, cfg.codebook_size, size=(4, cfg.num_vq_tokens)).astype(np.int32)
    ehs = rs.randn(4, 5, 48).astype(np.float32)
    jbatch = {"image_tokens": jnp.asarray(tokens), "encoder_hidden_states": jnp.asarray(ehs)}
    tbatch = {"image_tokens": _t(tokens).long(), "encoder_hidden_states": _t(ehs)}
    dropped = []
    for i in range(3):
        key = jax.random.PRNGKey(600 + i)
        mask_key, drop_key, dropout_key = jax.random.split(key, 3)
        masks, _ = jax_keep_masks(jm, jstate.params, dropout_key,
                                  jnp.zeros((4, cfg.num_vq_tokens), jnp.int32), jnp.asarray(ehs))
        jstate, jmetrics = jstep(jstate, jbatch, key)
        noise = jax_masking_noise(mask_key, *tokens.shape, cfg.codebook_size)
        noise.cond_dropout = _t(jax.random.uniform(drop_key, (4, 1, 1))).reshape(-1)
        dropped += (noise.cond_dropout < 0.5).tolist()
        step.spec.dropout.masks = masks
        metrics = step(state, tbatch, noise)
        _assert_metrics(metrics, jmetrics)
        _assert_params(state, jstate, port, 1e-3)
    assert any(dropped) and not all(dropped)


def write_class_shard(path, n, seed=0, captions=()):
    """``n`` seeded PNGs of mixed sizes with ``.cls`` members (class i % 4)
    and, for the indices in ``captions``, a caption."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            w, h = ((40, 36), (36, 48), (36, 36))[i % 3]
            png = io.BytesIO()
            Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(png, format="PNG")
            members = [("png", png.getvalue()), ("cls", str(i % 4).encode())]
            if i in captions:
                members.append(("txt", f"caption {i}".encode()))
            for ext, data in members:
                info = tarfile.TarInfo(f"{i:05d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def test_classification_dataset_matches_jax(tmp_path):
    """The same shard (images without captions but two), seed and class
    mapping: batches equal to the JAX ``ClassificationDataset``'s (random
    crops, class ids int32, the mapping's texts, the default centre crop
    off), read without the prefetch thread."""
    shard = str(tmp_path / "cls-000.tar")
    write_class_shard(shard, 12, captions=(2, 7))
    mapping = str(tmp_path / "classes.json")
    with open(mapping, "w") as f:
        json.dump({"0": "tench", "1": "goldfish", "3": "shark"}, f)
    kw = dict(resolution=32, shuffle_buffer_size=4, seed=3, prefetch_depth=0)
    for path in (None, mapping):
        port = ClassificationDataset(shard, 4, imagenet_class_mapping_path=path, **kw)
        jax_ds = jdata.ClassificationDataset(shard, batch_size=4, use_native=False,
                                             imagenet_class_mapping_path=path, **kw)
        got_batches, want_batches = iter(port), iter(jax_ds)
        for _ in range(3):
            got, want = next(got_batches), next(want_batches)
            assert sorted(got) == sorted(want) == sorted(
                ["pixel_values", "class_ids"] + (["input_text"] if path else []))
            np.testing.assert_array_equal(got["pixel_values"], want["pixel_values"])
            np.testing.assert_array_equal(got["class_ids"], want["class_ids"])
            assert got["class_ids"].dtype == np.int32 and got["pixel_values"].shape == (4, 32, 32, 3)
            if path:
                assert got["input_text"] == want["input_text"]


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _assert_resumed(again, state, steps):
    """``again`` (main resumed from ``latest`` with nothing left to do) holds
    the first run's step, parameters, EMA and AdamW state."""
    assert again.step == state.step == steps and again.optimizer.count == steps
    mine = dict(state.model.named_parameters())
    for name, p in again.model.named_parameters():
        assert torch.equal(p, mine[name]), name
        if state.ema is not None:
            assert torch.equal(again.ema.shadow[name], state.ema.shadow[name]), name
    first = state.optimizer.torch_optimizer.state_dict()["state"]
    for idx, moments in again.optimizer.torch_optimizer.state_dict()["state"].items():
        assert torch.equal(moments["exp_avg"], first[idx]["exp_avg"])
        assert torch.equal(moments["exp_avg_sq"], first[idx]["exp_avg_sq"])


V1_CLASS_TINY = {"vocab_size": 69, "hidden_size": 32, "num_hidden_layers": 2,
                 "num_attention_heads": 2, "intermediate_size": 64, "codebook_size": 64,
                 "num_vq_tokens": 256, "max_position_embeddings": 257, "num_classes": 4,
                 "hidden_dropout": RATE}


def test_train_maskgit_imagenet_main_trains_samples_and_resumes(tmp_path):
    """``configs/imagenet.yaml`` shrunk by overrides, on the CPU: 4 steps of
    the class step with dropout 0.1 (``KeepMasks`` on a CPU generator), the
    EMA on and never moved, the panel at step 4, checkpoints at 2 and 4;
    resuming ``latest`` with nothing left to do restores every tensor, and
    two more steps train on."""
    shard, out = str(tmp_path / "cls-000.tar"), str(tmp_path / "out")
    write_class_shard(shard, 8)
    vq_dir = str(tmp_path / "vq")
    MaskGitVQGAN(**MASKGIT_VQ_TINY).save_pretrained(vq_dir)

    def argv(steps, resume="null"):
        return ([f"config={os.path.join(REPO_ROOT, 'configs', 'imagenet.yaml')}",
                 f"dataset.params.train_shards_path_or_url={shard}",
                 "dataset.params.shuffle_buffer_size=8", "dataset.params.resolution=32",
                 f"experiment.output_dir={out}", "experiment.log_every=1",
                 "experiment.save_every=2", "experiment.generate_every=4",
                 f"experiment.resume_from_checkpoint={resume}", f"model.vq_model.pretrained={vq_dir}",
                 "training.batch_size=4", "training.mixed_precision=no", "training.use_ema=true",
                 f"training.max_train_steps={steps}", "lr_scheduler.params.warmup_steps=2",
                 "device=cpu"] + [f"model.transformer.{k}={v}" for k, v in V1_CLASS_TINY.items()])

    state = train_maskgit_imagenet.main(argv(4))
    logged = _metrics(out)
    assert [m["step"] for m in logged] == [1, 2, 3, 4] and state.optimizer.count == 4
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in logged)
    assert logged[0]["lr"] == 5e-5 and logged[1]["lr"] == 1e-4  # warmup over 2 updates
    assert sorted(os.listdir(out)) == ["checkpoint-2", "checkpoint-4", "metrics.jsonl",
                                       "samples-4.png"]
    for name, p in state.model.named_parameters():  # trained; the EMA never moved
        assert not torch.equal(p, state.ema.shadow[name]), name
    assert state.model.config.mask_token_id == 68

    again = train_maskgit_imagenet.main(argv(4, "latest"))
    _assert_resumed(again, state, 4)
    more = train_maskgit_imagenet.main(argv(6, "latest"))
    assert more.step == 6 and [m["step"] for m in _metrics(out)][-2:] == [5, 6]


V1_TEXT_TINY = {"vocab_size": 72, "hidden_size": 32, "num_hidden_layers": 2,
                "num_attention_heads": 2, "intermediate_size": 64, "codebook_size": 64,
                "num_vq_tokens": 256, "max_position_embeddings": 256, "encoder_hidden_size": 48,
                "hidden_dropout": RATE}


def _v1_text_argv(shard, out, steps, resume="null", extra=()):
    return ([f"config={os.path.join(REPO_ROOT, 'configs', 'cc12m.yaml')}",
             f"dataset.params.train_shards_path_or_url={shard}",
             "dataset.params.shuffle_buffer_size=8", "dataset.params.resolution=32",
             f"experiment.output_dir={out}", "experiment.log_every=1", "experiment.save_every=2",
             "experiment.generate_every=4", f"experiment.resume_from_checkpoint={resume}",
             "training.batch_size=4", "training.mixed_precision=no",
             f"training.max_train_steps={steps}", "lr_scheduler.params.warmup_steps=2",
             "device=cpu", *extra] + [f"model.transformer.{k}={v}" for k, v in V1_TEXT_TINY.items()])


def test_train_muse_v1_on_pre_encoded_shards(tmp_path):
    """``configs/cc12m.yaml`` (``architecture: transformer``, T5-sized text
    states, ``cond_dropout_prob`` 0.1) with ``training.pre_encode``: no text
    tower and no VQ model, so no panel and no eval; 4 steps of the v1 text
    step and checkpoints, then an exact resume."""
    shard, out = str(tmp_path / "enc-000.tar"), str(tmp_path / "out")
    make_preencoded_shard(shard, 8, seq=256, text_dim=48)
    state = train_muse.main(_v1_text_argv(shard, out, 4, extra=["training.pre_encode=true"]))
    assert isinstance(state.model, MaskGitTransformer) and state.ema is None
    logged = _metrics(out)
    assert [m["step"] for m in logged] == [1, 2, 3, 4]
    assert all(np.isfinite(m["loss"]) and "eval_loss" not in m for m in logged)
    assert sorted(os.listdir(out)) == ["checkpoint-2", "checkpoint-4", "config.yaml",
                                       "metrics.jsonl"]
    again = train_muse.main(_v1_text_argv(shard, out, 4, "latest",
                                          extra=["training.pre_encode=true"]))
    _assert_resumed(again, state, 4)


def test_train_muse_v1_on_raw_shards(tmp_path):
    """The same config on raw image + caption shards with a CLIP tower and
    a taming VQGAN (``text_encoder.type: clip`` overridden; as written, the
    T5 tower's directory is missing, which raises, and a T5 tower without
    tokenizer files raises naming ROADMAP fault 3.11): 4 steps, the v1
    panel (12 steps, CFG 8 against zero text states) at step 4, ``use_ema``
    on (the EMA moves), checkpoints, then an exact resume."""
    from test_torch_train_raw import write_raw_shard

    shard, out = str(tmp_path / "raw-000.tar"), str(tmp_path / "out")
    write_raw_shard(shard, 8)
    clip_dir, vq_dir = str(tmp_path / "clip"), str(tmp_path / "vq")
    jc = JaxCLIP(**CLIP_FOR_UVIT, _defer_init=True)
    clip, _ = port_of(jc, CLIPTextEncoder, random_params(jc, 60))
    clip.save_pretrained(clip_dir)
    VQGANModel(**VQGAN_TINY).save_pretrained(vq_dir)
    with pytest.raises(ValueError, match="needs model.text_encoder"):
        train_muse.main(_v1_text_argv(shard, out, 1))
    t5_params = [f"model.text_encoder.params.{k}={v}" for k, v in T5_FOR_V1.items()]
    with pytest.raises(ValueError, match="fault 3.11"):
        train_muse.main(_v1_text_argv(shard, out, 1, extra=t5_params))
    extra = ["model.text_encoder.type=clip", f"model.text_encoder.pretrained={clip_dir}",
             f"model.vq_model.pretrained={vq_dir}", "training.use_ema=true"]
    state = train_muse.main(_v1_text_argv(shard, out, 4, extra=extra))
    logged = _metrics(out)
    assert [m["step"] for m in logged] == [1, 2, 3, 4]
    assert all(np.isfinite(m["loss"]) for m in logged)
    assert os.path.isfile(os.path.join(out, "samples-4.png"))
    assert any(not torch.equal(state.ema.shadow[n], p)
               for n, p in state.model.named_parameters())
    again = train_muse.main(_v1_text_argv(shard, out, 4, "latest", extra=extra))
    _assert_resumed(again, state, 4)


def test_keep_masks_draw_from_their_generator():
    """``KeepMasks``: uniforms below keep_prob from its generator, so two
    sources of one seed draw the same masks and the kept share is near
    keep_prob."""
    a, b = (KeepMasks(torch.Generator().manual_seed(4)) for _ in range(2))
    m = a((64, 256), 0.9, torch.device("cpu"))
    assert m.dtype == torch.bool and torch.equal(m, b((64, 256), 0.9, torch.device("cpu")))
    assert abs(m.float().mean().item() - 0.9) < 0.01


def test_train_muse_movq_raw_against_jax(tmp_path):
    """``configs/cc12m_movq.yaml`` (``vq_model_type: movq``) on raw shards
    with a CLIP tower (``text_encoder.type: clip`` overridden: the config's
    T5 needs tokenizer files, fault 3.11) and a seeded MOVQ: the frozen
    encoders' image tokens equal to the JAX MOVQ's ``get_code`` on the same
    pixels, tie-aware; then the port's ``train_muse.main`` and the JAX
    package's on the same shard and checkpoints, 2 steps each (8 images a
    batch, one per JAX CPU device), both logging finite losses."""
    from open_muse_tpu.training.train_muse import main as jax_main
    from open_muse_tpu_torch.training.data import Text2ImageDataset
    from test_torch_tokenizers import assert_ids_match, movq_pair
    from test_torch_train_raw import write_raw_shard

    shard = str(tmp_path / "raw-000.tar")
    write_raw_shard(shard, 16)
    clip_dir, movq_dir = str(tmp_path / "clip"), str(tmp_path / "movq")
    jc = JaxCLIP(**CLIP_FOR_UVIT, _defer_init=True)
    port_of(jc, CLIPTextEncoder, random_params(jc, 110))[0].save_pretrained(clip_dir)
    jv, movq = movq_pair(111)
    movq.save_pretrained(movq_dir)

    def argv(out, steps):
        return ([f"config={os.path.join(REPO_ROOT, 'configs', 'cc12m_movq.yaml')}",
                 f"dataset.params.train_shards_path_or_url={shard}",
                 "dataset.params.shuffle_buffer_size=8", "dataset.params.resolution=32",
                 f"experiment.output_dir={out}", "experiment.log_every=1",
                 "experiment.save_every=100", "experiment.generate_every=100",
                 "experiment.resume_from_checkpoint=null", "model.text_encoder.type=clip",
                 f"model.text_encoder.pretrained={clip_dir}",
                 f"model.vq_model.pretrained={movq_dir}", "training.batch_size=8",
                 "training.mixed_precision=no", f"training.max_train_steps={steps}",
                 # a number: the JAX trainer takes yaml's string "1e-4" as it is
                 "optimizer.params.learning_rate=0.0001",
                 "lr_scheduler.params.warmup_steps=1", "device=cpu"]
                + [f"model.transformer.{k}={v}" for k, v in V1_TEXT_TINY.items()])

    config = load_config(argv(str(tmp_path / "unused"), 1))
    frozen = train_muse.FrozenEncoders.from_config(config, torch.device("cpu"))
    assert isinstance(frozen.vq_model, type(movq))
    batch = next(iter(Text2ImageDataset(shard, 4, resolution=32, shuffle_buffer_size=4, seed=1,
                                        prefetch_depth=0)))
    tokens = frozen.prepare_batch(batch)["image_tokens"]
    pixels = jnp.asarray(batch["pixel_values"])
    latents = jv.module.apply({"params": jv.params}, pixels,
                              method=lambda m, p: m.quant_conv(m.encoder(p)))
    assert tokens.shape == (4, 256)
    assert_ids_match(tokens, np.asarray(jv.get_code(pixels)), latents.reshape(-1, 4),
                     jv.params["quantize"]["embedding"]["embedding"])

    state = train_muse.main(argv(str(tmp_path / "port"), 2))
    assert state.step == 2 and isinstance(state.model, MaskGitTransformer)
    jax_main(argv(str(tmp_path / "jax"), 2))
    for side in ("port", "jax"):
        logged = [m for m in _metrics(str(tmp_path / side)) if "loss" in m]
        assert [m["step"] for m in logged] == [1, 2], side
        assert all(np.isfinite(m["loss"]) for m in logged), side


def test_frozen_encoders_take_a_t5_tower():
    """``FrozenEncoders`` with a T5 tower: the text states are its last
    hidden state (the JAX ``encode``'s ``hs[-1]``), to atol 1e-5; no pooled
    output for v1, zeros of ``cond_embed_dim`` for v2, as the JAX trainer
    feeds; the empty prompt's embeddings likewise."""
    from open_muse_tpu.models.t5_text import T5TextEncoder as JaxT5
    from open_muse_tpu_torch.models.clip_text import SimpleTokenizer
    from open_muse_tpu_torch.models.t5_text import T5TextEncoder
    from test_torch_tokenizers import movq_pair

    jc = JaxT5(**T5_FOR_V1, _defer_init=True)
    t5 = port_of(jc, T5TextEncoder, random_params(jc, 112))[0]
    tokenizer = SimpleTokenizer(120, 16)
    texts = ["a photo of a cat", ""]
    ids = tokenizer(texts, padding="max_length", max_length=16)["input_ids"]
    want = np.asarray(jc.encode(jnp.asarray(ids))[0][-1])
    for cond_embed_dim in (None, 32):
        frozen = train_muse.FrozenEncoders(t5, tokenizer, movq_pair(113)[1], torch.device("cpu"),
                                           cond_embed_dim)
        states, pooled = frozen.encode_text(texts)
        np.testing.assert_allclose(states.numpy(), want, rtol=0, atol=1e-5)
        empty = frozen.empty_embeds()
        np.testing.assert_allclose(empty["empty_embeds"].numpy(), want[1:], rtol=0, atol=1e-5)
        if cond_embed_dim is None:
            assert pooled is None and empty["empty_cond_embeds"] is None
        else:
            assert torch.equal(pooled, torch.zeros(2, 32))
            assert torch.equal(empty["empty_cond_embeds"], torch.zeros(1, 32))
