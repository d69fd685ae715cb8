"""Checkpoints the port writes, read back by both packages' loaders (CPU).

A trainer's ``checkpoint-{step}/unwrapped_model`` and ``ema_model`` carry
the model's ``_class_name``, so ``PipelineMuse.from_pretrained`` of either
package serves them (``train_muse`` v2, ``train_maskgit_imagenet``, and
``distill``'s student).  Every model class loads from diffusers'
``diffusion_pytorch_model.bin`` and from a ``subfolder=``, in both packages.
"""

import os

import pytest
import torch

from open_muse_tpu.models.clip_text import CLIPTextEncoder as JaxCLIP
from open_muse_tpu.models.clip_vision import CLIPVisionEncoder as JaxCLIPVision
from open_muse_tpu.models.maskgit_vqgan import MaskGitVQGAN as JaxMaskGitVQGAN
from open_muse_tpu.models.movq import MOVQ as JaxMOVQ
from open_muse_tpu.models.paella_vq import PaellaVQModel as JaxPaella
from open_muse_tpu.models.t5_text import T5TextEncoder as JaxT5
from open_muse_tpu.models.taming_vqgan import VQGANModel as JaxVQGAN
from open_muse_tpu.models.transformer_v1 import MaskGitTransformer as JaxV1
from open_muse_tpu.models.transformer_v2 import MaskGiTUViT_v2 as JaxUViT
from open_muse_tpu.pipelines.pipeline_muse import PipelineMuse as JaxPipeline
from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder
from open_muse_tpu_torch.models.clip_vision import CLIPVisionEncoder
from open_muse_tpu_torch.models.maskgit_vqgan import MaskGitVQGAN
from open_muse_tpu_torch.models.movq import MOVQ
from open_muse_tpu_torch.models.paella_vq import PaellaVQModel
from open_muse_tpu_torch.models.t5_text import T5TextEncoder
from open_muse_tpu_torch.models.taming_vqgan import VQGANModel
from open_muse_tpu_torch.models.transformer_v1 import MaskGitTransformer
from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2
from open_muse_tpu_torch.pipelines.pipeline_muse import PipelineMuse
from test_torch_clip_vision import VISION_TINY
from test_torch_models import CLIP_TINY, UVIT_TINY, VQGAN_TINY
from test_torch_pipeline import CLIP_FOR_UVIT
from test_torch_t5 import T5_TINY
from test_torch_tokenizers import MOVQ_TINY, PAELLA_TINY
from test_torch_train_v1 import MASKGIT_VQ_TINY, V1_CLASS_TINY

CLASSES = {
    "uvit": (JaxUViT, MaskGiTUViT_v2, UVIT_TINY),
    "v1": (JaxV1, MaskGitTransformer, V1_CLASS_TINY),
    "clip": (JaxCLIP, CLIPTextEncoder, CLIP_TINY),
    "clip_vision": (JaxCLIPVision, CLIPVisionEncoder, VISION_TINY),
    "t5": (JaxT5, T5TextEncoder, T5_TINY),
    "vqgan": (JaxVQGAN, VQGANModel, VQGAN_TINY),
    "maskgit_vqgan": (JaxMaskGitVQGAN, MaskGitVQGAN, MASKGIT_VQ_TINY),
    "movq": (JaxMOVQ, MOVQ, MOVQ_TINY),
    "paella": (JaxPaella, PaellaVQModel, PAELLA_TINY),
}


# the HF towers' JAX loaders read model.safetensors and pytorch_model.bin only
HF_TOWERS = ("clip", "clip_vision", "t5")


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_every_model_loads_diffusers_weights_from_a_subfolder(tmp_path, name):
    """A ``save_pretrained`` directory whose weights are renamed to
    ``diffusion_pytorch_model.bin``, under ``sub/``: the port reads it with
    ``subfolder="sub"`` into the same state_dict, and the JAX package's
    ``from_pretrained(path, subfolder="sub")`` reads it too (its HF towers
    under the name they read, ``pytorch_model.bin``)."""
    jax_cls, port_cls, cfg = CLASSES[name]
    torch.manual_seed(0)
    model = port_cls(**cfg)
    sub = tmp_path / "sub"
    model.save_pretrained(str(sub))
    os.remove(sub / "model.safetensors")
    torch.save(model.state_dict(), sub / "diffusion_pytorch_model.bin")
    back = port_cls.from_pretrained(str(tmp_path), subfolder="sub", device="cpu")
    want, got = model.state_dict(), back.state_dict()
    assert want.keys() == got.keys() and all(torch.equal(want[k], got[k]) for k in want)
    if name in HF_TOWERS:
        os.rename(sub / "diffusion_pytorch_model.bin", sub / "pytorch_model.bin")
    jm = jax_cls.from_pretrained(str(tmp_path), subfolder="sub")
    assert jm.params is not None
    with pytest.raises(EnvironmentError):
        port_cls.from_pretrained(str(tmp_path), device="cpu")  # no weights at the top


def _train_muse(tmp_path):
    from open_muse_tpu_torch.training.train_muse import main
    from test_torch_train_cli import _argv, make_preencoded_shard

    shard, out = str(tmp_path / "enc-000.tar"), str(tmp_path / "out")
    make_preencoded_shard(shard, 8)
    main(_argv(shard, out, 2) + ["device=cpu"])
    vae, text = str(tmp_path / "vae"), str(tmp_path / "text")
    VQGANModel(**VQGAN_TINY).save_pretrained(vae)
    CLIPTextEncoder(**CLIP_FOR_UVIT).save_pretrained(text)
    return os.path.join(out, "checkpoint-2"), dict(vae_path=vae, text_encoder_path=text)


def _train_maskgit_imagenet(tmp_path):
    from open_muse_tpu_torch.training import train_maskgit_imagenet
    from test_torch_train_cli import REPO_ROOT
    from test_torch_train_v1 import write_class_shard

    shard, out, vae = (str(tmp_path / "cls-000.tar"), str(tmp_path / "out"),
                       str(tmp_path / "vq"))
    write_class_shard(shard, 4)
    MaskGitVQGAN(**MASKGIT_VQ_TINY).save_pretrained(vae)
    train_maskgit_imagenet.main(
        [f"config={os.path.join(REPO_ROOT, 'configs', 'imagenet.yaml')}",
         f"dataset.params.train_shards_path_or_url={shard}",
         "dataset.params.shuffle_buffer_size=4", "dataset.params.resolution=32",
         f"experiment.output_dir={out}", "experiment.save_every=2",
         "experiment.generate_every=100", f"model.vq_model.pretrained={vae}",
         "training.batch_size=2", "training.mixed_precision=no", "training.use_ema=true",
         "training.max_train_steps=2", "device=cpu"]
        + [f"model.transformer.{k}={v}" for k, v in V1_CLASS_TINY.items()])
    return os.path.join(out, "checkpoint-2"), dict(vae_path=vae, is_class_conditioned=True)


def _distill(tmp_path):
    from open_muse_tpu_torch.training import distill
    from test_torch_distill import _main_argv

    teacher, text, vae = (str(tmp_path / "teacher"), str(tmp_path / "text"),
                          str(tmp_path / "vae"))
    torch.manual_seed(0)
    MaskGiTUViT_v2(**UVIT_TINY).save_pretrained(teacher)
    CLIPTextEncoder(**CLIP_FOR_UVIT).save_pretrained(text)
    VQGANModel(**VQGAN_TINY).save_pretrained(vae)
    distill.main(_main_argv(tmp_path, teacher, text, 2))
    return os.path.join(tmp_path, "out", "checkpoint-2"), dict(vae_path=vae,
                                                               text_encoder_path=text)


TRAINERS = {"train_muse": _train_muse, "train_maskgit_imagenet": _train_maskgit_imagenet,
            "distill": _distill}


@pytest.mark.parametrize("trainer", sorted(TRAINERS))
def test_trainer_checkpoints_serve_through_both_pipelines(tmp_path, trainer):
    """The trainer's ``unwrapped_model/`` and ``ema_model/`` are each the
    transformer of a ``PipelineMuse.from_pretrained`` in the port (which
    answers a 2-step request from it) and in the JAX package."""
    checkpoint, paths = TRAINERS[trainer](tmp_path)
    for sub in ("unwrapped_model", "ema_model"):
        path = os.path.join(checkpoint, sub)
        pipe = PipelineMuse.from_pretrained(transformer_path=path, device="cpu", **paths)
        saved = torch.load(os.path.join(path, "pytorch_model.bin"), weights_only=True)
        for name, p in pipe.transformer.named_parameters():
            assert torch.equal(p, saved[name].to(p.dtype)), (sub, name)
        request = dict(class_ids=[1]) if paths.get("is_class_conditioned") else dict(
            text="a lighthouse")
        images = pipe(**request, timesteps=2, generator=torch.Generator().manual_seed(0),
                      return_pil=False)
        assert images.shape == (1, 32, 32, 3) and bool(torch.isfinite(images).all())
        jax_pipe = JaxPipeline.from_pretrained(transformer_path=path, **paths)
        assert jax_pipe.transformer.params is not None
        assert jax_pipe.transformer.config.hidden_size == pipe.transformer.config.hidden_size
