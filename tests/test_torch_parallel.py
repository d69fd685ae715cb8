"""The port's multi-process parts on the CPU: the partition rules against the
JAX package's, and one two-process gloo run (``torch_parallel_worker.py``)
held against the single-process port and JAX.

The rules are checked on every leaf of the tiny flagship U-ViT: the port's
spec of a ``state_dict`` name, carried through the converter's name and
axis maps, is the JAX spec of the flax leaf on a (dp 2, fsdp 2, tp 2) mesh.

The two ranks run, on one global batch of 4 and the masking noise JAX draws
for it (each rank keeps its rows): two dp=2 train steps, whose metrics
(rtol 2e-5) and parameters and EMA (atol 2e-6: fp32, summation order; the
updates are ~1e-3) must equal the single-process port's and the JAX step's,
and the same under gradient accumulation 2;
the same two steps with FSDP2 (fsdp=2) within the same bounds;
``all_reduce_min`` (the eval-count agreement); ``train_muse.main`` on a
shard a rank with uneven eval shards, rank 0's checkpoint read back by both
ranks (and with fsdp=2, then resumed); the raw-image branch at fsdp=2 with
its sample and inpainting panels; and sharded ``compile_text2image`` at batch 2 and
3 (3 does not divide over 2 ranks) under noise JAX draws, whose token ids
must equal the unsharded port call's and JAX's (the unsharded call's images
equal JAX's: ``test_torch_pipeline.py``), images within 1e-5 of the range
of the unsharded call's (the VQ decode at another batch).  Tensor-parallel
weights (``training.tp=2``, the whole batch on both ranks): two v2 steps of
a U-ViT with 4 heads (2 a rank: the fused sublayers' plain versions on head
shards) and two v1 text steps (biases, RMSNorm, the Normformer mid-MLP
norm, dropout 0.1 on the JAX step's masks, cond dropout), whose metrics
(rtol 2e-5) and whole weights and EMA must equal the single-process
port's and the JAX step's on a (1, 1, 2) JAX mesh (atol 2e-6 where
AdamW's first moment exceeds 1e-7, else the lr: see
``test_torch_train_v1._assert_params``); ``8bit_adamw`` at tp=2 against
one process (its blocks that straddle the shards take the largest absmax
of their parts); ``train_muse.main`` at ``training.tp=2`` for v2 and v1,
the v2 checkpoint of whole weights read by one port process and by the
JAX loader, then resumed.  One pair of processes for the whole file, with
its own timeout.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from open_muse_tpu.models.clip_text import CLIPTextEncoder as JaxCLIP
from open_muse_tpu.models.clip_text import SimpleTokenizer as JaxTokenizer
from open_muse_tpu.models.taming_vqgan import VQGANModel as JaxVQGAN
from open_muse_tpu.models.transformer_v2 import MaskGiTUViT_v2 as JaxUViT
from open_muse_tpu.parallel import sharding as jsharding
from open_muse_tpu.parallel.mesh import create_mesh as jax_create_mesh
from open_muse_tpu.pipelines.pipeline_muse import PipelineMuse as JaxPipeline
from open_muse_tpu.core.convert import flatten_dict
from open_muse_tpu_torch.core.convert import jax_layout
from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder, SimpleTokenizer
from open_muse_tpu_torch.models.taming_vqgan import VQGANModel
from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2
from open_muse_tpu_torch.parallel import sharding
from open_muse_tpu_torch.pipelines.pipeline_muse import PipelineMuse
from open_muse_tpu_torch.training.optimizers import flax_param_name
from open_muse_tpu.training import lr_schedules as jlr
from open_muse_tpu.training import trainer as jtrainer
from open_muse_tpu.ops.sampling import get_mask_schedule as jax_mask_schedule
from open_muse_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from test_torch_models import UVIT_TINY, VQGAN_TINY, port_of, random_params, uvit_inputs
from test_torch_pipeline import CLIP_FOR_UVIT, jax_noise
from test_torch_train_cli import REPO_ROOT, _argv, make_preencoded_shard
from test_torch_train_raw import _raw_argv, write_raw_shard
from test_torch_train_v1 import _v1_text_argv, jax_keep_masks, v1_pair_with_dropout
from test_torch_training import (_assert_state_matches, _batches, _jax_and_port_steps,
                                 _port_noise, _port_params, jax_masking_noise, uvit_pair)

HERE = os.path.dirname(os.path.abspath(__file__))
# the pair takes ~45 s alone; a loaded machine (the whole suite in
# parallel) slows it several times
WORKER_TIMEOUT_S = 420
SERVE_BATCHES = (2, 3)


# -- the partition rules ------------------------------------------------------

def test_rules_match_jax_on_every_leaf_of_the_flagship():
    """Every leaf: the port's rule (by flax path) is JAX's, its torch spec
    puts each axis on the torch dim the converter maps the JAX dim to, and
    the fits fallback (replication where an axis does not divide) agrees
    with JAX's ``make_param_shardings`` on a (2, 2, 2) mesh."""
    jm = JaxUViT(**UVIT_TINY, _defer_init=True)
    flat = random_params(jm, 0)
    port, _ = port_of(jm, MaskGiTUViT_v2, flat)
    mesh = jax_create_mesh(dp=2, fsdp=2, tp=2)
    want = {k: tuple(v.spec) for k, v in flatten_dict(
        jsharding.make_param_shardings(mesh, jm.params)).items()}
    got = sharding.make_param_shardings(port, {"dp": 2, "fsdp": 2, "tp": 2})
    assert set(got) == {n for n, _ in port.named_parameters()}
    split = 0
    for name, p in port.named_parameters():
        path = flax_param_name(port, name)
        assert sharding.spec_for_path(path) == tuple(jsharding.spec_for_path(path)), path
        jax_spec = want[path] + (None,) * (p.dim() - len(want[path]))
        owner, _, leaf = name.rpartition(".")
        layout = jax_layout(port.get_submodule(owner), leaf)
        perm = layout[0] if layout is not None else tuple(range(p.dim()))
        spec = got[name] + (None,) * (p.dim() - len(got[name]))
        for j, axis in enumerate(jax_spec):
            assert spec[perm[j]] == axis, (name, spec, jax_spec)
            assert p.shape[perm[j]] == flat[path].shape[j]
        split += any(a is not None for a in jax_spec)
    assert split >= 10  # the projections, the GLU, the embedding and the head


def test_linear_and_conv_specs_turn_with_the_layout():
    """(in, out) -> (out, in) for a Linear; HWIO -> OIHW for a conv."""
    lin = torch.nn.Linear(8, 4)
    conv = torch.nn.Conv2d(8, 4, 1)
    assert sharding.torch_spec(lin, "weight", ("fsdp", "tp"), 2) == ("tp", "fsdp")
    assert sharding.torch_spec(conv, "weight", (None, None, "fsdp", "tp"), 4) == \
        ("tp", "fsdp", None, None)
    assert sharding.torch_spec(lin, "bias", (), 1) == (None,)


def test_put_batch_moves_rows_and_keeps_broadcast_rows_whole():
    from open_muse_tpu_torch.parallel.mesh import local_batch_slice, put_batch

    assert local_batch_slice(8, 1, 2) == slice(4, 8)
    batch = {"image_tokens": np.arange(8).reshape(4, 2), "input_text": ["a", "b"],
             "empty_embeds": np.zeros((1, 3, 2), np.float32), "step": np.int64(3)}
    placed = put_batch(batch, "cpu")
    assert torch.equal(placed["image_tokens"], torch.arange(8).reshape(4, 2))
    assert placed["input_text"] == ["a", "b"] and placed["step"].dim() == 0
    with pytest.raises(ValueError, match="one row shared"):
        put_batch({"empty_embeds": np.zeros((2, 3, 2))}, "cpu")


# -- the two-process run -------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serving_pipelines():
    jt = JaxUViT(**UVIT_TINY, _defer_init=True)
    jc = JaxCLIP(**CLIP_FOR_UVIT, _defer_init=True)
    jv = JaxVQGAN(**VQGAN_TINY, _defer_init=True)
    ports = [port_of(m, cls, random_params(m, seed))[0]
             for seed, (m, cls) in enumerate(((jt, MaskGiTUViT_v2), (jc, CLIPTextEncoder),
                                              (jv, VQGANModel)), start=60)]
    jax_pipe = JaxPipeline(vae=jv, transformer=jt, text_encoder=jc,
                           tokenizer=JaxTokenizer(100, 16))
    port_pipe = PipelineMuse(vae=ports[2], transformer=ports[0], text_encoder=ports[1],
                             tokenizer=SimpleTokenizer(100, 16))
    return jax_pipe, port_pipe


PROMPTS = ["a photo of a cat", "two red cubes", "a dog on a beach"]


# a U-ViT whose 4 heads split 2 a rank at tp=2: the fused sublayers run
UVIT_TP = dict(hidden_size=256, num_attention_heads=4)
TP_STEPS = 2


def _jax_steps(jm, jstep_fn, steps, mesh=None, **kw):
    """``steps`` JAX steps (AdamW, warmup over 2 updates, clip 1, EMA) from
    ``jm``'s params, on ``mesh`` when given: (state, [metrics])."""
    tx = jax_get_optimizer("adamw", jlr.get_scheduler("constant_with_warmup", 1e-3, 2),
                           weight_decay=0.01, max_grad_norm=1.0)
    params = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), jm.params)  # donated
    jstate = jtrainer.create_train_state(params, tx, mesh=mesh, with_ema=True)
    jstep = jstep_fn(jm.module, tx, jax_mask_schedule("cosine"), jm.config.mask_token_id,
                     codebook_size=jm.config.codebook_size, **kw)
    metrics = []
    for batch, key in steps:
        jstate, m = jstep(jstate, batch, key)
        metrics.append({k: float(v) for k, v in m.items()})
    return jstate, metrics


def _single(case, optimizer_name="adamw"):
    """The single-process port's two steps of ``case``, as the workers run
    them sharded (``torch_parallel_worker.tp_steps``)."""
    from torch_parallel_worker import tp_steps

    out = tp_steps(case, None, optimizer_name)
    state = out.pop("state")
    out["model"] = state.model
    if optimizer_name == "adamw":
        moments = state.optimizer.torch_optimizer.state
        out["moments"] = {n: moments[p]["exp_avg"] for n, p in state.model.named_parameters()}
    return out


def _tp_cases(work):
    """The tp=2 cases the workers run, with the single-process port's and
    JAX's results on a (1, 1, 2) mesh."""
    mesh = jax_create_mesh(dp=1, fsdp=1, tp=2, devices=jax.devices()[:2])
    # v2: the batch whole on both ranks; JAX keys -> the port's noise
    jm, port = uvit_pair(7, **UVIT_TP)
    weights = {k: v.clone() for k, v in port.state_dict().items()}
    ids, ehs, cond, micro = uvit_inputs(8, batch=4)
    jbatch = {"image_tokens": jnp.asarray(ids % jm.config.codebook_size),
              "encoder_hidden_states": jnp.asarray(ehs), "cond_embeds": jnp.asarray(cond),
              "micro_conds": jnp.asarray(micro)}
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    tbatch["image_tokens"] = tbatch["image_tokens"].long()
    keys = [jax.random.PRNGKey(800 + i) for i in range(TP_STEPS)]
    noise = [_port_noise(k, np.asarray(jbatch["image_tokens"]), jm.config.codebook_size)
             for k in keys]
    v2 = {"kind": "v2", "config": dataclasses.asdict(port.config), "weights": weights,
          "batch": tbatch, "noise": noise, "mask_id": jm.config.mask_token_id,
          "codebook": jm.config.codebook_size}
    refs = {"v2": {"jax_mesh": _jax_steps(jm, jtrainer.make_uvit_train_step,
                                          [(jbatch, k) for k in keys], mesh),
                   "port": _single(v2), "port_8bit": _single(v2, "8bit_adamw"), "jm": jm}}
    # v1 text: biases, RMSNorm, Normformer norms, dropout 0.1, cond dropout 0.5
    jm1, port1 = v1_pair_with_dropout("text_rms_bias")
    cfg = jm1.config
    rs = np.random.RandomState(13)
    tokens = rs.randint(0, cfg.codebook_size, size=(4, cfg.num_vq_tokens)).astype(np.int32)
    ehs1 = rs.randn(4, 5, 48).astype(np.float32)
    jbatch1 = {"image_tokens": jnp.asarray(tokens), "encoder_hidden_states": jnp.asarray(ehs1)}
    keys1 = [jax.random.PRNGKey(900 + i) for i in range(TP_STEPS)]
    masks, noise1 = [], []
    jax_kw = {"cond_dropout_prob": 0.5, "ema_decay": 0.9999}
    # flax's dropout masks depend on the key and the shapes, not on the
    # params: each step's come from its key through the initial params
    for key in keys1:
        mask_key, drop_key, dropout_key = jax.random.split(key, 3)
        masks.append(jax_keep_masks(jm1, jm1.params, dropout_key,
                                    jnp.zeros((4, cfg.num_vq_tokens), jnp.int32),
                                    jnp.asarray(ehs1))[0])
        n = jax_masking_noise(mask_key, *tokens.shape, cfg.codebook_size)
        n.cond_dropout = torch.from_numpy(np.array(
            jax.random.uniform(drop_key, (4, 1, 1)))).reshape(-1)
        noise1.append(n)
    v1 = {"kind": "v1", "config": dataclasses.asdict(port1.config),
          "weights": {k: v.clone() for k, v in port1.state_dict().items()},
          "batch": {"image_tokens": torch.from_numpy(tokens).long(),
                    "encoder_hidden_states": torch.from_numpy(ehs1)},
          "noise": noise1, "masks": masks, "mask_id": cfg.mask_token_id,
          "codebook": cfg.codebook_size}
    refs["v1"] = {"jax_mesh": _jax_steps(jm1, jtrainer.make_v1_text2image_train_step,
                                         [(jbatch1, k) for k in keys1], mesh, **jax_kw),
                  "port": _single(v1), "jm": jm1}
    # train_muse.main at tp=2: the CLI's tiny U-ViT with 4 heads, and v1 text
    shard = str(work / "tp-enc-000.tar")
    make_preencoded_shard(shard, 8)
    tp_out = str(work / "main_tp")
    widths = [f"model.transformer.{k}={v}" for k, v in UVIT_TP.items()]
    main_v2 = _argv(shard, tp_out, 2) + widths + ["training.tp=2", "device=cpu"]
    resume = [a for a in main_v2 if not a.startswith(("training.max_train_steps",
                                                       "experiment.resume"))]
    v1_shard = str(work / "tp-v1-000.tar")
    make_preencoded_shard(v1_shard, 8, seq=256, text_dim=48)
    out = {"v2": v2, "v1": v1, "main_v2": main_v2,
           "main_v2_resume": resume + ["training.max_train_steps=3",
                                       "experiment.resume_from_checkpoint=latest"],
           "main_v1": _v1_text_argv(v1_shard, str(work / "main_tp_v1"), 2,
                                    extra=["training.pre_encode=true", "training.tp=2"])}
    refs["main_out"] = tp_out
    return out, refs


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """The single-process port and JAX results, and both ranks' outputs."""
    work = tmp_path_factory.mktemp("parallel")
    jm, port, jstate, jstep, state, step = _jax_and_port_steps(seed=0)
    _, acc_port, acc_jstate, acc_jstep, acc_state, acc_step = _jax_and_port_steps(
        seed=0, accumulation_steps=2)
    jbatch, tbatch = _batches(jm, seed=1, batch=4)
    weights = {k: v.clone() for k, v in port.state_dict().items()}
    noises, single, jax_metrics, acc_single = [], [], [], []
    for i in range(2):
        key = jax.random.PRNGKey(300 + i)
        noise = _port_noise(key, np.asarray(jbatch["image_tokens"]), jm.config.codebook_size)
        noises.append(noise)
        jstate, jm_metrics = jstep(jstate, jbatch, key)
        acc_jstate, _ = acc_jstep(acc_jstate, jbatch, key)
        jax_metrics.append({k: float(v) for k, v in jm_metrics.items()})
        single.append({k: float(v) for k, v in step(state, tbatch, noise).items()})
        acc_single.append({k: float(v) for k, v in acc_step(acc_state, tbatch, noise).items()})

    shards = [str(work / f"enc-{i:03d}.tar") for i in range(2)]
    for s in shards:
        make_preencoded_shard(s, 8)
    evals = [str(work / f"eval-{i:03d}.tar") for i in range(3)]
    for s in evals:
        make_preencoded_shard(s, 4)
    main_out = str(work / "main")
    main_argv = _argv(str(work / "enc-{000..001}.tar"), main_out, 2) + [
        f"dataset.params.eval_shards_path_or_url={work / 'eval-{000..002}.tar'}",
        "experiment.eval_every=2", "experiment.max_eval_batches=8",
        "optimizer.params.scale_lr=true"]

    # the raw-image branch under fsdp=2, with its sample and inpainting panels
    jc, jv = JaxCLIP(**CLIP_FOR_UVIT, _defer_init=True), JaxVQGAN(**VQGAN_TINY, _defer_init=True)
    port_of(jc, CLIPTextEncoder, random_params(jc, 50))[0].save_pretrained(str(work / "clip"))
    port_of(jv, VQGANModel, random_params(jv, 51))[0].save_pretrained(str(work / "vq"))
    for i in range(2):
        write_raw_shard(str(work / f"raw-{i:03d}.tar"), 8, seed=i)
    raw_out = str(work / "raw")
    raw_argv = _raw_argv(str(work / "raw-{000..001}.tar"), str(work / "raw-{000..001}.tar"),
                         raw_out, str(work / "clip"), str(work / "vq"), 2) + [
        "training.fsdp=2", "experiment.generate_every=2", "experiment.profile_steps=null",
        f"experiment.inpainting_validation_dir={REPO_ROOT}/inpainting_validation"]

    jax_pipe, port_pipe = _serving_pipelines()
    port_pipe.save_pretrained(str(work / "pipe"))
    serve, serve_ref = {}, {}
    micro1 = np.asarray([[512, 512, 0, 0, 6.0]], np.float32)
    for batch in SERVE_BATCHES:
        ids = np.asarray(JaxTokenizer(100, 16)(PROMPTS[:batch])["input_ids"])
        micro = np.repeat(micro1, batch, 0)
        key = jax.random.PRNGKey(70 + batch)
        noise = jax_noise(key, 3, batch, 256, UVIT_TINY["codebook_size"])
        fn = port_pipe.compile_text2image(batch_size=batch, timesteps=3, guidance_scale=2.0)
        images, tokens = fn(torch.from_numpy(ids), torch.from_numpy(micro), noise,
                            return_tokens=True)
        hs, _, pooled = jax_pipe.text_encoder.encode(jnp.asarray(ids))
        ehs_e, _, pooled_e = jax_pipe.text_encoder.encode(
            jnp.asarray(JaxTokenizer(100, 16)([""])["input_ids"]))
        jax_tokens = jax_pipe.transformer.generate2(
            hs[-2], pooled, jnp.asarray(micro), empty_embeds=ehs_e[-2],
            empty_cond_embeds=pooled_e, temperature=(2, 0), timesteps=3, guidance_scale=2.0,
            key=key, seq_len=256)
        serve[batch] = (torch.from_numpy(ids), torch.from_numpy(micro), noise)
        serve_ref[batch] = {"images": images, "tokens": tokens,
                            "jax_tokens": np.asarray(jax_tokens)}

    tp_inputs, tp_refs = _tp_cases(work)
    torch.save({"config": dataclasses.asdict(port.config), "weights": weights,
                "batch": tbatch, "noise": noises, "mask_id": jm.config.mask_token_id,
                "codebook": jm.config.codebook_size, "main_argv": main_argv,
                "main_out": main_out, "raw_argv": raw_argv, "serve": serve,
                "tp": tp_inputs}, str(work / "inputs.pt"))
    port_number = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MUSE_", "RANK", "WORLD_SIZE", "MASTER_", "LOCAL_RANK"))}
    env["OMP_NUM_THREADS"] = "1"  # tiny models: threads only contend
    # each rank's output to a file: a pipe that fills would stall its rank
    logs = [open(work / f"rank{rank}.log", "w+") for rank in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
                               str(rank), "2", str(port_number), str(work)],
                              env=env, stdout=logs[rank], stderr=subprocess.STDOUT)
             for rank in range(2)]
    try:
        for p in procs:
            p.wait(timeout=WORKER_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        assert p.returncode == 0, f"worker {rank} failed:\n{log.read()[-6000:]}"
        log.close()
    ranks = [torch.load(str(work / f"rank{r}.pt"), weights_only=False) for r in range(2)]
    with open(os.path.join(os.path.dirname(HERE), "configs", "laiona6plus_uvit_clip.yaml")) as f:
        base_lr = float(yaml.safe_load(f)["optimizer"]["params"]["learning_rate"])
    return {"base_lr": base_lr, "jstate": jstate, "jax_metrics": jax_metrics, "single": single,
            "state": state, "acc": (acc_port, acc_jstate, acc_single),
            "port": port, "ranks": ranks, "serve_ref": serve_ref, "main_out": main_out,
            "raw_out": raw_out, "tp": tp_refs}


def _metrics_close(got, want, names=("loss", "grad_norm", "avg_masking_rate")):
    for i, (g, w) in enumerate(zip(got, want)):
        for name in names:
            np.testing.assert_allclose(g[name], w[name], rtol=2e-5, err_msg=f"step {i} {name}")


def test_dp2_steps_match_the_single_process_port_and_jax(cluster):
    state, port = cluster["state"], cluster["port"]
    for rank in cluster["ranks"]:
        dp = rank["dp"]
        _metrics_close(dp["metrics"], cluster["single"])
        _metrics_close(dp["metrics"], cluster["jax_metrics"])
        for name, p in port.state_dict().items():
            np.testing.assert_allclose(dp["params"][name].numpy(), p.numpy(), atol=2e-6, rtol=0,
                                       err_msg=name)
            np.testing.assert_allclose(dp["ema"][name].numpy(), state.ema.shadow[name].numpy(),
                                       atol=2e-6, rtol=0, err_msg=name)
        port_copy = type(port)(port.config)
        port_copy.load_state_dict(dp["params"])
        _assert_state_matches(types.SimpleNamespace(ema=types.SimpleNamespace(shadow=dp["ema"])),
                              cluster["jstate"], port_copy)
    a, b = (r["dp"]["params"] for r in cluster["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a)  # the replicas stay equal


def test_dp2_accumulation_reduces_the_mean_once_and_matches(cluster):
    """Gradient accumulation 2 under dp=2: the loss metric is the global
    batch's every step (the ``grad_norm`` metric, the micro-batch's, is the
    rank's own under accumulation, so it is not compared); the one update,
    from the mean reduced once, equals the single-process port's and
    ``optax.MultiSteps``' (atol 2e-6)."""
    acc_port, acc_jstate, acc_single = cluster["acc"]
    want = _port_params(acc_jstate.params, acc_port)
    for rank in cluster["ranks"]:
        got = rank["dp_acc"]
        _metrics_close(got["metrics"], acc_single, names=("loss", "avg_masking_rate"))
        for name, p in acc_port.state_dict().items():
            np.testing.assert_allclose(got["params"][name].numpy(), p.numpy(), atol=2e-6,
                                       rtol=0, err_msg=name)
            np.testing.assert_allclose(got["params"][name].numpy(), want[name].numpy(),
                                       atol=2e-6, rtol=0, err_msg=name)


def test_fsdp2_steps_match_the_single_process_port_and_jax(cluster):
    want = _port_params(cluster["jstate"].params, cluster["port"])
    for rank in cluster["ranks"]:
        fsdp = rank["fsdp"]
        _metrics_close(fsdp["metrics"], cluster["single"])
        _metrics_close(fsdp["metrics"], cluster["jax_metrics"])
        for name, p in cluster["port"].state_dict().items():
            np.testing.assert_allclose(fsdp["params"][name].numpy(), p.numpy(), atol=2e-6,
                                       rtol=0, err_msg=name)
            np.testing.assert_allclose(fsdp["params"][name].numpy(), want[name].numpy(),
                                       atol=2e-6, rtol=0, err_msg=name)


def test_ranks_agree_on_the_eval_count(cluster):
    assert [r["eval_count"] for r in cluster["ranks"]] == [3, 3]


def test_rank0_checkpoint_reloads_on_both_ranks(cluster):
    """``train_muse.main`` with a shard a rank: rank 0 alone wrote the
    checkpoint, both ranks read it back equal to their state, the replicas
    agree, the lr scaled by the global batch and the world size, and rank 0
    alone logged (the fsdp run below resumes)."""
    ranks = cluster["ranks"]
    for r in ranks:
        assert r["main"]["step"] == 2 and r["main"]["reloads"]
        # scale_lr: the config's lr x the global batch (4) x the world size (2)
        assert r["main"]["lr"] == pytest.approx(cluster["base_lr"] * 4 * 2)
    a, b = (r["main"]["params"] for r in ranks)
    assert all(torch.equal(a[k], b[k]) for k in a)
    out = cluster["main_out"]
    assert sorted(d for d in os.listdir(out) if d.startswith("checkpoint-")) == ["checkpoint-2"]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [line for line in f if '"eval_loss"' in line]
    assert len(lines) == 1  # rank 0 alone logs, once at step 2


def test_fsdp2_main_saves_whole_weights_and_resumes(cluster):
    """``train_muse.main`` with ``training.fsdp=2``: the parameters are
    FSDP2 shards, the checkpoint holds the whole weights (gathered), both
    ranks' gathered weights agree with the dp run's to atol 2e-6, and a
    resume from each rank's optimizer shard continues at step 3."""
    ranks = cluster["ranks"]
    for r in ranks:
        got = r["main_fsdp"]
        assert got["sharded"] and got["reloads"] and got["step"] == 2
        assert got["resumed_step"] == 3
        for name, p in r["main"]["params"].items():
            if name in got["params"]:
                np.testing.assert_allclose(got["params"][name].numpy(), p.numpy(), atol=2e-6,
                                           rtol=0, err_msg=name)
    assert os.path.isfile(os.path.join(cluster["main_out"] + "_fsdp", "checkpoint-2",
                                       "training_state-rank1.pt"))


def test_fsdp2_raw_branch_panels_gather_the_shards(cluster):
    """The raw-image branch with ``training.fsdp=2`` and gradient
    accumulation 2: at step 2 both ranks gather the sharded EMA weights and
    rank 0 writes the sample and inpainting panels; both ranks finish."""
    for r in cluster["ranks"]:
        assert r["raw_fsdp"] == {"step": 2, "sharded": True}
    out = cluster["raw_out"]
    assert os.path.isfile(os.path.join(out, "samples-2.png"))
    assert os.path.isfile(os.path.join(out, "inpainting-2.png"))


@pytest.mark.parametrize("batch", SERVE_BATCHES)
def test_sharded_text2image_equals_the_unsharded_call_and_jax(cluster, batch):
    ref = cluster["serve_ref"][batch]
    for r in cluster["ranks"]:
        got = r["serve"][batch]
        assert got["tokens"].shape == (batch, 256)
        assert torch.equal(got["tokens"], ref["tokens"])
        np.testing.assert_array_equal(got["tokens"].numpy(), ref["jax_tokens"])
        # the VQ decode of 1 - 2 rows a rank against all rows: fp32 summation order
        scale = np.abs(ref["images"].numpy()).max()
        assert np.abs(got["images"].numpy() - ref["images"].numpy()).max() <= 1e-5 * scale


# -- tensor-parallel weights (training.tp = 2) ---------------------------------------

def assert_adamw_params(got, want, moments, lr=1e-3):
    """``got`` (whole weights or EMA) against ``want`` as
    ``test_torch_train_v1._assert_params`` holds them: atol 2e-6 where the
    single-process port's AdamW first moment exceeds 1e-7, else the lr (m /
    (sqrt(v) + eps) of an exactly-zero gradient's fp32 noise: the attention
    key biases)."""
    for name in moments:
        err = np.abs(got[name].numpy() - want[name].numpy())
        sharp = (moments[name].abs() > 1e-7).numpy()
        assert err[sharp].max(initial=0) <= 2e-6, (name, err[sharp].max())
        assert err.max() <= lr, (name, err.max())


def _tp_case_matches(cluster, kind):
    """Both ranks' tp=2 steps of ``kind``: the metrics equal the
    single-process port's and the JAX step's on the (1, 1, 2) mesh to rtol
    2e-5; the whole weights and EMA equal the port's and JAX's as
    ``assert_adamw_params`` holds them (fp32, summation order)."""
    refs = cluster["tp"][kind]
    single = refs["port"]
    port = refs["port"]["model"]
    moments = refs["port"]["moments"]
    for rank in cluster["ranks"]:
        got = rank["tp"][kind]
        assert got["sharded"]
        want_metrics = [{k: float(v) for k, v in m.items() if v.dim() == 0}
                        for m in single["metrics"]]
        got_metrics = [{k: float(v) for k, v in m.items() if v.dim() == 0}
                       for m in got["metrics"]]
        _metrics_close(got_metrics, want_metrics)
        _metrics_close(got_metrics, refs["jax_mesh"][1])
        for key in ("params", "ema"):
            assert_adamw_params(got[key], single[key], moments)
        jstate = refs["jax_mesh"][0]
        assert_adamw_params(got["params"], _port_params(jstate.params, port), moments)
        assert_adamw_params(got["ema"], _port_params(jstate.ema_params, port), moments)


def test_tp2_v2_steps_match_the_single_process_port_and_jax(cluster):
    _tp_case_matches(cluster, "v2")
    for rank in cluster["ranks"]:  # the per-parameter grad norms: of the whole leaves
        for got, want in zip(rank["tp"]["v2"]["metrics"], cluster["tp"]["v2"]["port"]["metrics"]):
            np.testing.assert_allclose(got["param_grad_norms"].numpy(),
                                       want["param_grad_norms"].numpy(), rtol=2e-5, atol=1e-7)


def test_tp2_v1_text_steps_match_the_single_process_port_and_jax(cluster):
    _tp_case_matches(cluster, "v1")


def test_tp2_8bit_adamw_matches_one_process(cluster):
    """``8bit_adamw`` at tp=2: the GLU's column shards (128 of 256 a rank)
    cut its 256-wide blocks, which take the largest absmax of their parts,
    so the codes are the whole leaf's.  The weights equal the single-process
    port's to atol 2e-6 but at the rare elements whose moment sits at a
    code's tie (fp32 summation order flips the code): at most 1e-3 of a
    leaf's elements, each within the lr."""
    want = cluster["tp"]["v2"]["port_8bit"]
    for rank in cluster["ranks"]:
        got = rank["tp"]["v2_8bit"]
        for name, p in want["params"].items():
            err = np.abs(got["params"][name].numpy() - p.numpy())
            assert (err > 2e-6).mean() <= 1e-3, (name, (err > 2e-6).mean())
            assert err.max() <= 1e-3, (name, err.max())


def test_tp2_main_saves_whole_weights_read_by_one_process_and_jax(cluster):
    """``train_muse.main`` at ``training.tp=2`` (v2, the kernels' plain
    versions on 2 heads a rank): the parameters are DTensor shards, rank 0
    writes whole weights, which one port process and the JAX loader read
    equal to both ranks' gathered weights; a resume re-shards them and
    steps on; the v1 text run at tp=2 finishes too."""
    from open_muse_tpu.models.transformer_v2 import MaskGiTUViT_v2 as JaxModel

    ckpt = os.path.join(cluster["tp"]["main_out"], "checkpoint-2", "unwrapped_model")
    model = MaskGiTUViT_v2.from_pretrained(ckpt, device="cpu")
    saved = model.state_dict()
    jax_saved = _port_params(JaxModel.from_pretrained(ckpt).params, model)
    a, b = (r["tp"]["main_v2"] for r in cluster["ranks"])
    for got in (a, b):
        assert got["sharded"] and got["step"] == 2 and got["resumed_step"] == 3
        assert set(got["params"]) == set(saved)
        for name, p in saved.items():
            assert torch.equal(got["params"][name], p), name
            assert torch.equal(jax_saved[name], p), name
    for r in cluster["ranks"]:
        assert r["tp"]["main_v1"]["sharded"] and r["tp"]["main_v1"]["step"] == 2

