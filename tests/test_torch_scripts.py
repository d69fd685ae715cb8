"""The port's user scripts, examples and launcher on the CPU, as the JAX
package's tests run its own (``tests/test_scripts.py``,
``tests/test_tpu_scripts.py``): each runs through its ``main`` at a tiny
size and writes what it promises.  ``compute_offline_ema`` is held against
the JAX script over the same checkpoints (fp32, atol 1e-6).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder, SimpleTokenizer
from open_muse_tpu_torch.models.maskgit_vqgan import MaskGitVQGAN
from open_muse_tpu_torch.models.taming_vqgan import VQGANModel
from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2
from open_muse_tpu_torch.pipelines.pipeline_muse import PipelineMuse, PipelineMuseInpainting
from open_muse_tpu_torch.scripts import launch
from test_torch_models import UVIT_TINY, VQGAN_TINY
from test_torch_pipeline import CLIP_FOR_UVIT

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ["a red square", "a blue circle", "two green cubes"]


@pytest.fixture(scope="module")
def pipeline_dir(tmp_path_factory):
    """A tiny text pipeline (256 tokens from a 32px taming VQGAN) saved as
    a ``save_pretrained`` directory, seeded torch weights."""
    torch.manual_seed(0)
    pipe = PipelineMuse(vae=VQGANModel(**VQGAN_TINY), transformer=MaskGiTUViT_v2(**UVIT_TINY),
                        text_encoder=CLIPTextEncoder(**CLIP_FOR_UVIT),
                        tokenizer=SimpleTokenizer(100, 16))
    path = str(tmp_path_factory.mktemp("pipe") / "pipeline")
    pipe.save_pretrained(path)
    return path


# -- the launcher ---------------------------------------------------------------

def _dry(capsys, *argv):
    assert launch.main(["--dry-run", *argv]) == 0
    out = capsys.readouterr().out.strip()
    assert out.startswith("DRY-RUN: ")
    return out


def test_launch_dry_run_one_node(capsys):
    out = _dry(capsys, "--nproc-per-node", "8", "--",
               "config=configs/research_run_512.yaml", "training.batch_size=512")
    assert "-m torch.distributed.run --nnodes 1 --nproc_per_node 8 --standalone" in out
    assert "--module open_muse_tpu_torch.training.train_muse" in out
    assert out.endswith("config=configs/research_run_512.yaml training.batch_size=512")


def test_launch_dry_run_nodes_modules_and_env(capsys):
    """Several nodes and another module; the environment is the shell's
    (the ranks inherit it), so the launcher takes no variables itself."""
    out = _dry(capsys, "--nnodes", "2", "--rdzv-endpoint", "host0:29500", "--module",
               "open_muse_tpu_torch.scripts.pre_encode", "--", "--shards", "raw/{0..9}.tar")
    assert out.startswith(f"DRY-RUN: {sys.executable} -m torch.distributed.run ")
    with pytest.raises(SystemExit):
        launch.main(["--dry-run", "--env", "TORCH_NCCL_ASYNC_ERROR_HANDLING=1"])
    assert "--rdzv_backend c10d --rdzv_endpoint host0:29500" in out
    assert "--module open_muse_tpu_torch.scripts.pre_encode --shards" in out
    with pytest.raises(ValueError, match="rdzv-endpoint"):
        launch.build_command([], nnodes=2)


def test_pre_encode_takes_the_launchers_rank(monkeypatch):
    from open_muse_tpu_torch.scripts.pre_encode import distribute_shards, task_share

    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert task_share() == (1, 2)
    assert task_share(0, 4) == (0, 4)  # --task-id / --num-tasks win
    assert distribute_shards(list(range(10)), *task_share()) == [5, 6, 7, 8, 9]
    monkeypatch.delenv("RANK")
    monkeypatch.delenv("WORLD_SIZE")
    assert task_share() == (0, 1)


# -- the scripts ----------------------------------------------------------------

def test_compute_offline_ema_matches_the_jax_script(tmp_path):
    """Three MaskGIT VQGAN checkpoints saved by the JAX package (the port's
    ``from_pretrained`` reads them): the port's EMA equals the JAX script's."""
    from open_muse_tpu.models.maskgit_vqgan import MaskGitVQGAN as JaxVQ
    from scripts.compute_offline_ema import main as jax_main
    from open_muse_tpu_torch.scripts.compute_offline_ema import main

    cfg = dict(resolution=32, hidden_channels=32, channel_mult=(1, 2), num_res_blocks=1,
               z_channels=16, num_embeddings=64, quantized_embed_dim=16)
    for step, seed in [(10, 0), (20, 1), (30, 2)]:
        JaxVQ(seed=seed, **cfg).save_pretrained(
            str(tmp_path / f"checkpoint-{step}" / "unwrapped_model"))
    jax_main(["--checkpoints-dir", str(tmp_path), "--output", str(tmp_path / "jax_ema"),
              "--model-class", "MaskGitVQGAN"])
    out = main(["--checkpoints-dir", str(tmp_path), "--output", str(tmp_path / "ema"),
                "--model-class", "MaskGitVQGAN", "--decay", "0.9999", "--device", "cpu"])
    got = MaskGitVQGAN.from_pretrained(out, device="cpu").state_dict()
    want = MaskGitVQGAN.from_pretrained(str(tmp_path / "jax_ema"), device="cpu").state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-6, rtol=0, err_msg=k)
    with open(os.path.join(out, "config.json")) as f:
        cfg_out = json.load(f)
    assert cfg_out["optimization_step"] == 2 and cfg_out["decay"] == 0.9999


def test_log_generations_writes_grids_and_inpaintings(tmp_path, pipeline_dir):
    from PIL import Image

    from open_muse_tpu_torch.scripts.log_generations import main

    prompts = tmp_path / "prompts.txt"
    prompts.write_text("\n".join(PROMPTS) + "\n")
    val = tmp_path / "val" / "a_blue_dog"
    val.mkdir(parents=True)
    rs = np.random.RandomState(1)
    Image.fromarray((rs.rand(32, 32, 3) * 255).astype(np.uint8)).save(val / "image.png")
    mask = np.zeros((32, 32), np.uint8)
    mask[:16] = 255
    Image.fromarray(mask).save(val / "mask.png")
    out = tmp_path / "gens"
    written = main(["--model", pipeline_dir, "--prompts", str(prompts), "--inpainting-dir",
                    str(tmp_path / "val"), "--output-dir", str(out), "--timesteps", "2",
                    "--batch-size", "2", "--image-size", "32", "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["generations-0000.png", "generations-0002.png",
                                       "inpaint-a_blue_dog.png"]
    assert len(written) == 3
    assert Image.open(out / "generations-0000.png").size == (64, 32)  # 2 images a row


def _inpainting_pipe():
    """A 64px MaskGIT VQGAN (4 x 4 tokens) under a 16-token U-ViT."""
    torch.manual_seed(1)
    vq = MaskGitVQGAN(resolution=64, hidden_channels=32, channel_mult=(1, 1, 2, 2, 4),
                      num_res_blocks=1, z_channels=32, num_embeddings=64, quantized_embed_dim=32)
    return PipelineMuseInpainting(vae=vq, transformer=MaskGiTUViT_v2(**UVIT_TINY),
                                  text_encoder=CLIPTextEncoder(**CLIP_FOR_UVIT),
                                  tokenizer=SimpleTokenizer(100, 16))


def test_log_inpainting_images_script(tmp_path):
    from PIL import Image

    from open_muse_tpu_torch.scripts.log_inpainting_images import main

    src = tmp_path / "input.png"
    Image.fromarray((np.random.RandomState(0).rand(64, 64, 3) * 255).astype(np.uint8)).save(src)
    out = tmp_path / "gen"
    assert main(["--model", "unused", "--input-image", str(src), "--text", "a red square",
                 "--image-size", "64", "--mask-start-x", "1", "--mask-end-x", "3",
                 "--mask-start-y", "1", "--mask-end-y", "3", "--timesteps", "2",
                 "--num-generations", "2", "--output-dir", str(out)],
                pipe=_inpainting_pipe()) == 0
    for name in ("segmented.jpg", "output_0.jpg", "output_1.jpg", "output_grid.png"):
        assert (out / name).is_file(), name
    seg = np.asarray(Image.open(out / "segmented.jpg"))
    assert seg[16:48, 16:48].mean() < 16  # the masked block zeroed (JPEG noise only)


def test_log_inpainting_images_validation_dir(tmp_path):
    from PIL import Image

    from open_muse_tpu_torch.scripts.log_inpainting_images import main

    val = tmp_path / "val" / "a_blue_dog"
    val.mkdir(parents=True)
    rs = np.random.RandomState(1)
    Image.fromarray((rs.rand(64, 64, 3) * 255).astype(np.uint8)).save(val / "image.png")
    m = np.zeros((64, 64), np.uint8)
    m[:32] = 255
    Image.fromarray(m).save(val / "mask.png")
    out = tmp_path / "gen"
    assert main(["--model", "unused", "--validation-dir", str(tmp_path / "val"),
                 "--image-size", "64", "--timesteps", "2", "--num-generations", "2",
                 "--output-dir", str(out)], pipe=_inpainting_pipe()) == 0
    assert (out / "inpaint-a_blue_dog_grid.png").is_file()
    assert (out / "inpaint-a_blue_dog_0.jpg").is_file()


def test_benchmark_models_prints_both_settings(capsys):
    from open_muse_tpu_torch.scripts.benchmark_models import main

    config = {**UVIT_TINY, "block_out_channels": [32]}
    lines = main(["--device", "cpu", "--timesteps", "2", "--iters", "2",
                  "--model-config", json.dumps(config)])
    printed = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert printed == lines and [p["setting"] for p in printed] == ["bf16", "fp32"]
    for p in printed:
        assert set(p) == {"setting", "timesteps", "batch_size", "median_ms"}
        assert p["timesteps"] == 2 and p["batch_size"] == 1 and p["median_ms"] > 0


# -- the examples ---------------------------------------------------------------

def test_quickstart_trains_reloads_and_samples(tmp_path):
    from PIL import Image

    from open_muse_tpu_torch.examples.quickstart import main

    png = main(["--device", "cpu", "--workdir", str(tmp_path), "--steps", "2"])
    assert Image.open(png).size == (32, 32)
    assert sorted(os.listdir(tmp_path / "run"))[:2] == ["checkpoint-1", "checkpoint-2"]


def test_serving_micro_batches_and_pads(tmp_path, pipeline_dir, monkeypatch):
    from PIL import Image

    from open_muse_tpu_torch.examples.serving import main

    prompts = tmp_path / "prompts.txt"
    prompts.write_text("\n".join(PROMPTS + ["a yellow star", "a cat"]) + "\n")
    captures = []
    original = PipelineMuse.compile_text2image
    monkeypatch.setattr(PipelineMuse, "compile_text2image",
                        lambda self, **kw: captures.append(kw) or original(self, **kw))
    out = tmp_path / "served"
    stats = main(["--checkpoint", pipeline_dir, "--prompts", str(prompts), "--batch-size", "2",
                  "--timesteps", "2", "--out-dir", str(out), "--device", "cpu",
                  "--dtype", "float32"])
    assert [s["images"] for s in stats] == [2, 2, 1]  # the last batch padded to 2
    assert all(s["ms"] > 0 and s["images_per_s"] > 0 for s in stats)
    assert len(captures) == 1 and captures[0]["batch_size"] == 2  # one request function
    assert sorted(os.listdir(out)) == [f"{i:05d}.png" for i in range(5)]
    assert Image.open(out / "00000.png").size == (32, 32)
