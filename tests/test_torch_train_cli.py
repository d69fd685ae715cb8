"""The port's ``train_muse.main`` end to end on a tiny pre-encoded shard (CPU).

It runs the research config ``configs/laiona6plus_uvit_clip.yaml`` with
command-line overrides that shrink the model, as ``chip_smoke.py`` runs it
at full width on the card: 4 steps, checkpoints, then two resumed runs.
"""

import io
import json
import os
import tarfile

import numpy as np
import torch

from open_muse_tpu_torch.training.train_muse import main

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"hidden_size": 128, "num_hidden_layers": 2, "num_attention_heads": 2,
        "intermediate_size": 256, "vocab_size": 68, "codebook_size": 64, "in_channels": 32,
        "block_out_channels": "[32]", "num_res_blocks": 1, "block_num_heads": 2,
        "encoder_hidden_size": 48, "cond_embed_dim": 32, "micro_cond_encode_dim": 8,
        "micro_cond_embed_dim": 40}


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def make_preencoded_shard(path, n, seq=16, codebook=64, text_len=7, text_dim=48, pooled=32):
    """The dialect scripts/pre_encode.py writes, with LAION-style metadata that
    passes the config's quality filter."""
    rs = np.random.RandomState(0)
    meta = json.dumps({"width": 512, "height": 512, "pwatermark": 0.1, "aesthetic": 6.5})
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            for ext, data in (
                    ("vq_f16.npy", _npy(rs.randint(0, codebook, (seq,)).astype(np.int32))),
                    ("clip_penultimate.npy",
                     _npy(rs.randn(text_len, text_dim).astype(np.float16))),
                    ("clip_pooled.npy", _npy(rs.randn(pooled).astype(np.float16))),
                    ("json", meta.encode())):
                info = tarfile.TarInfo(f"{i:05d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def _argv(shard, out, steps, resume="null"):
    return ([f"config={os.path.join(REPO_ROOT, 'configs', 'laiona6plus_uvit_clip.yaml')}",
             f"dataset.params.train_shards_path_or_url={shard}",
             "dataset.params.shuffle_buffer_size=8", f"experiment.output_dir={out}",
             "experiment.log_every=1", "experiment.save_every=2",
             f"experiment.resume_from_checkpoint={resume}", "training.batch_size=4",
             "training.pre_encode=true", "training.mixed_precision=no",
             f"training.max_train_steps={steps}", "lr_scheduler.params.warmup_steps=2"]
            + [f"model.transformer.{k}={v}" for k, v in TINY.items()])


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_muse_main_trains_saves_and_resumes(tmp_path):
    shard, out = str(tmp_path / "enc-000.tar"), str(tmp_path / "out")
    make_preencoded_shard(shard, 16)
    state = main(_argv(shard, out, 4) + ["device=cpu"])
    assert state.step == 4 and state.optimizer.count == 4
    logged = _metrics(out)
    assert [m["step"] for m in logged] == [1, 2, 3, 4]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in logged)
    assert logged[0]["lr"] == 5e-5 and logged[1]["lr"] == 1e-4  # warmup over 2 updates
    assert sorted(os.listdir(out)) == ["checkpoint-2", "checkpoint-4", "config.yaml",
                                       "metrics.jsonl"]
    with open(os.path.join(out, "checkpoint-4", "metadata.json")) as f:
        assert json.load(f)["global_step"] == 4

    # resume "latest" with nothing left to do: step, params, EMA and
    # optimizer are those of the first run
    again = main(_argv(shard, out, 4, resume="latest") + ["device=cpu"])
    assert again.step == 4 and again.optimizer.count == 4
    mine = dict(state.model.named_parameters())
    for name, p in again.model.named_parameters():
        assert torch.equal(p, mine[name]), name
        assert torch.equal(again.ema.shadow[name], state.ema.shadow[name]), name
    first = state.optimizer.torch_optimizer.state_dict()["state"]
    for idx, moments in again.optimizer.torch_optimizer.state_dict()["state"].items():
        assert torch.equal(moments["exp_avg_sq"], first[idx]["exp_avg_sq"])

    # and training on from there
    more = main(_argv(shard, out, 6, resume="latest") + ["device=cpu"])
    assert more.step == 6
    assert [m["step"] for m in _metrics(out)][-2:] == [5, 6]


def test_train_muse_main_trains_the_512px_config(tmp_path):
    """configs/research_run_512.yaml (the flagship 512px run, 1024 tokens),
    shrunk in width and depth as chip_smoke.py's train_512 phase is not:
    its optimizer settings reach AdamW as numbers (yaml reads its ``1e-8``
    as a string) and two steps over a 32 x 32 token grid stay finite."""
    shard, out = str(tmp_path / "enc-000.tar"), str(tmp_path / "out")
    make_preencoded_shard(shard, 8, seq=1024)
    argv = ([f"config={os.path.join(REPO_ROOT, 'configs', 'research_run_512.yaml')}",
             f"dataset.params.train_shards_path_or_url={shard}",
             "dataset.params.shuffle_buffer_size=8", f"experiment.output_dir={out}",
             "experiment.log_every=1", "experiment.resume_from_checkpoint=null",
             "training.batch_size=2", "training.mixed_precision=no",
             "training.max_train_steps=2", "lr_scheduler.params.warmup_steps=0", "device=cpu"]
            + [f"model.transformer.{k}={v}" for k, v in TINY.items()])
    state = main(argv)
    group = state.optimizer.torch_optimizer.param_groups[0]
    assert group["eps"] == 1e-8 and group["betas"] == (0.9, 0.999)
    logged = _metrics(out)
    assert [m["step"] for m in logged] == [1, 2]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in logged)
