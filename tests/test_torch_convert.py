"""Weight conversion between the JAX package and the port, config reading,
checkpoint loading, and the port's hygiene (no jax import, no kernel launch
for CPU tensors)."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import jax
import torch

from open_muse_tpu.core.convert import flatten_dict
from open_muse_tpu.models.clip_text import CLIPTextEncoder as JaxCLIP
from open_muse_tpu.models.movq import MOVQ as JaxMOVQ
from open_muse_tpu.models.paella_vq import PaellaVQModel as JaxPaella
from open_muse_tpu.models.t5_text import T5TextEncoder as JaxT5
from open_muse_tpu.models.taming_vqgan import VQGANModel as JaxVQGAN
from open_muse_tpu.models.transformer_v2 import MaskGiTUViT_v2 as JaxUViT
from open_muse_tpu_torch import kernels
from open_muse_tpu_torch.core.convert import flax_key_candidates, jax_params_to_state_dict
from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder
from open_muse_tpu_torch.models.movq import MOVQ
from open_muse_tpu_torch.models.paella_vq import PaellaVQModel
from open_muse_tpu_torch.models.t5_text import T5TextEncoder
from open_muse_tpu_torch.models.taming_vqgan import VQGANModel
from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2
from test_torch_models import (CLIP_TINY, UVIT_TINY, VQGAN_TINY, port_of, random_params,
                               uvit_inputs)
from test_torch_t5 import T5_TINY
from test_torch_tokenizers import MOVQ_TINY, PAELLA_TINY

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    "uvit": (JaxUViT, MaskGiTUViT_v2, UVIT_TINY),
    "uvit_down_up": (JaxUViT, MaskGiTUViT_v2, {**UVIT_TINY, "force_down_up_sample": True}),
    "clip": (JaxCLIP, CLIPTextEncoder, CLIP_TINY),
    "vqgan": (JaxVQGAN, VQGANModel, VQGAN_TINY),
    "movq": (JaxMOVQ, MOVQ, MOVQ_TINY),
    "movq_one_res_block": (JaxMOVQ, MOVQ, {**MOVQ_TINY, "num_res_blocks": 1}),
    "paella": (JaxPaella, PaellaVQModel, PAELLA_TINY),
    "t5": (JaxT5, T5TextEncoder, {**T5_TINY, "feed_forward_proj": "gated-gelu"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_leaf_maps_to_one_port_key(case):
    jax_cls, port_cls, cfg = CASES[case]
    jm = jax_cls(**cfg, _defer_init=True)
    flat = random_params(jm, 0)
    port = port_cls(port_cls.config_from_dict(jm.config.to_dict()))
    state, unused = jax_params_to_state_dict(flat, port)
    # each port key took a distinct leaf, with the port's shape
    assert len(state) == len(flat) - len(unused)
    for key, value in state.items():
        assert value.shape == port.state_dict()[key].shape, key
    assert not unused, unused  # the VQGAN's encoder and quant_conv included


@pytest.mark.parametrize("case", ["uvit", "clip", "vqgan", "movq", "paella", "t5"])
def test_jax_loader_reads_port_state_dict_bit_for_bit(case):
    """The port's keys are the ones the JAX loader maps: loading the port's
    state_dict into the JAX model reproduces its params exactly."""
    jax_cls, port_cls, cfg = CASES[case]
    jm = jax_cls(**cfg, _defer_init=True)
    flat = random_params(jm, 1)
    port, _ = port_of(jm, port_cls, flat)
    back = jax_cls(**cfg, _defer_init=True)
    missing, unexpected = back.load_torch_weights(
        {k: v.numpy() for k, v in port.state_dict().items()}, strict=False)
    assert not unexpected, unexpected
    assert not missing, missing
    got = flatten_dict(back.params)
    for key, value in got.items():
        np.testing.assert_array_equal(np.asarray(value), flat[key], err_msg=key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_from_pretrained_reads_the_jax_save_pretrained_directory(case, tmp_path):
    """The JAX package's own ``save_pretrained`` directory (its config.json
    and ``flax_model.safetensors``) loads into the port: the same
    state_dict as ``jax_params_to_state_dict`` of the JAX params."""
    jax_cls, port_cls, cfg = CASES[case]
    jm = jax_cls(**cfg, _defer_init=True)
    port, _ = port_of(jm, port_cls, random_params(jm, 5))
    jm.save_pretrained(str(tmp_path))
    loaded = port_cls.from_pretrained(str(tmp_path), device="cpu")
    want, got = port.state_dict(), loaded.state_dict()
    assert want.keys() == got.keys() and all(torch.equal(want[k], got[k]) for k in want)


def test_flax_key_candidates():
    assert flax_key_candidates("down_blocks.0.res_blocks.1.channelwise.2.gamma") == [
        "down_blocks_0.res_blocks_1.channelwise_2.gamma"]
    assert flax_key_candidates("transformer_layers.3.ffn.wi_0.weight")[0] == \
        "transformer_layers_3.ffn.wi_0.kernel"


def test_from_pretrained_reads_config_and_safetensors(tmp_path):
    from safetensors.torch import save_file

    jm = JaxUViT(**UVIT_TINY, _defer_init=True)
    port, _ = port_of(jm, MaskGiTUViT_v2, random_params(jm, 2))
    jm.save_config(str(tmp_path))  # the JAX package's config.json format
    save_file({k: v.contiguous() for k, v in port.state_dict().items()},
              str(tmp_path / "model.safetensors"))
    loaded = MaskGiTUViT_v2.from_pretrained(str(tmp_path), device="cpu").eval()
    assert loaded.config == port.config
    ids, ehs, cond, micro = (torch.from_numpy(a) for a in uvit_inputs(0))
    with torch.no_grad():
        assert torch.equal(loaded(ids.long(), ehs, cond, micro), port(ids.long(), ehs, cond, micro))


def test_clip_config_from_full_clip_model_dict():
    cfg = CLIPTextEncoder.config_from_dict(
        {"projection_dim": 768, "text_config": {"hidden_size": 768, "vocab_size": 49408}})
    assert (cfg.hidden_size, cfg.projection_dim) == (768, 768)


def test_port_imports_no_jax():
    """Neither jax, flax nor any module of the JAX package (open_muse_tpu.*)
    is imported by the port's modules, entry points or chip_smoke.py (the
    optimizers, distillation, the dataset dialects, the native reader, the
    CLIP vision tower and scorer, the eval stack and its scripts
    included)."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO_ROOT!r})
        import torch
        import open_muse_tpu_torch
        from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2
        from open_muse_tpu_torch.pipelines.pipeline_muse import (PipelineMuse,
                                                                 PipelineMuseInpainting)
        from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder
        from open_muse_tpu_torch.models.taming_vqgan import VQGANModel
        from open_muse_tpu_torch.models.transformer_v1 import MaskGitTransformer
        from open_muse_tpu_torch.models.maskgit_vqgan import MaskGitVQGAN
        from open_muse_tpu_torch.models.movq import MOVQ
        from open_muse_tpu_torch.models.paella_vq import PaellaVQModel
        from open_muse_tpu_torch.models.t5_text import T5TextEncoder
        from open_muse_tpu_torch.kernels import flash_attention, fused_residual_layernorm
        from open_muse_tpu_torch.training import train_maskgit_imagenet, train_muse, train_vqgan
        from open_muse_tpu_torch.training.trainer import (make_maskgit_train_step,
                                                          make_v1_text2image_train_step,
                                                          make_vqgan_train_step)
        from open_muse_tpu_torch.models.discriminator import PatchDiscriminator
        from open_muse_tpu_torch.ops.perceptual import make_perceptual_loss_fn
        from open_muse_tpu_torch.training.data import ClassificationDataset
        from open_muse_tpu_torch.training.data import PreEncodedDataset, ShardSource
        from open_muse_tpu_torch.scripts import pre_encode
        from open_muse_tpu_torch.utils import config
        import chip_smoke
        PreEncodedDataset("shard-000.tar", 2)
        ClassificationDataset("shard-000.tar", 2)
        ShardSource("shard-{{000..003}}.tar", process_index=1, process_count=2)
        m = MaskGiTUViT_v2(**{json.dumps(UVIT_TINY)!s}).eval()
        with torch.no_grad():
            out = m(torch.zeros(1, 16, dtype=torch.long), torch.zeros(1, 7, 48),
                    torch.zeros(1, 32), torch.zeros(1, 5))
            codes = VQGANModel(**{json.dumps(VQGAN_TINY)!s}).get_code(torch.zeros(1, 32, 32, 3))
            v1 = MaskGitTransformer(vocab_size=69, hidden_size=32, num_hidden_layers=1,
                                    num_attention_heads=2, intermediate_size=64,
                                    codebook_size=64, num_vq_tokens=16,
                                    max_position_embeddings=17, num_classes=4).eval()
            tokens = v1.generate2(class_ids=[1], timesteps=2,
                                  generator=torch.Generator().manual_seed(0))
            images = MaskGitVQGAN(resolution=32, hidden_channels=32, channel_mult=(1, 2),
                                  num_res_blocks=1, z_channels=16, num_embeddings=64,
                                  quantized_embed_dim=16).decode_code(tokens)
            movq = MOVQ(**{json.dumps(MOVQ_TINY)!s}).decode_code(codes % 64)
            paella = PaellaVQModel(**{json.dumps(PAELLA_TINY)!s}).get_code(
                torch.zeros(1, 32, 32, 3))
            t5 = T5TextEncoder(**{json.dumps(T5_TINY)!s})(torch.zeros(1, 5, dtype=torch.long))[1]
        assert movq.shape == (1, 32, 32, 3) and paella.shape == (1, 64)
        assert t5.shape == (1, 5, 32)
        assert out.shape == (1, 16, 64) and codes.shape == (1, 256)
        assert tokens.shape == (1, 16) and images.shape == (1, 8, 8, 3)
        from open_muse_tpu_torch.models.transformer_v1 import KeepMasks
        from open_muse_tpu_torch.ops.sampling import get_mask_schedule
        from open_muse_tpu_torch.training.masking import draw_masking_noise
        from open_muse_tpu_torch.training.optimizers import get_optimizer
        from open_muse_tpu_torch.training.trainer import TrainState
        state = TrainState(model=v1.train(), optimizer=get_optimizer("adamw", v1, 1e-3))
        step = make_maskgit_train_step(get_mask_schedule("cosine"), 68, codebook_size=64,
                                       dropout=KeepMasks(torch.Generator().manual_seed(0)))
        metrics = step(state, {{"image_tokens": torch.zeros(2, 16, dtype=torch.long),
                               "class_ids": torch.tensor([0, 3])}},
                       draw_masking_noise(2, 16, torch.Generator().manual_seed(1), 64))
        assert state.step == 1 and metrics["loss"].isfinite()
        vq = MaskGitVQGAN(resolution=32, hidden_channels=32, channel_mult=(1, 2),
                          num_res_blocks=1, z_channels=16, num_embeddings=64,
                          quantized_embed_dim=16)
        disc = PatchDiscriminator(base_channels=8, n_layers=2)
        players = (TrainState(model=vq, optimizer=get_optimizer("adamw", vq, 1e-3)),
                   TrainState(model=disc, optimizer=get_optimizer("adamw", disc, 1e-3)))
        gan = make_vqgan_train_step(perceptual_weight=1.0, perceptual=make_perceptual_loss_fn(0),
                                    disc_weight=0.75)
        metrics = gan(players, {{"pixel_values": torch.rand(2, 32, 32, 3)}})
        assert metrics["d_loss"].isfinite() and metrics["perceptual"].isfinite()
        from open_muse_tpu_torch.training import distill, native_io, quant8
        from open_muse_tpu_torch.training.data import DATASET_MAPS
        for name in ("8bit_adamw", "bf16_adamw", "lion"):
            metrics = step(TrainState(model=v1, optimizer=get_optimizer(name, v1, 1e-3)),
                           {{"image_tokens": torch.zeros(2, 16, dtype=torch.long),
                            "class_ids": torch.tensor([0, 3])}},
                           draw_masking_noise(2, 16, torch.Generator().manual_seed(1), 64))
            assert metrics["loss"].isfinite()
        dstep = distill.make_distill_step(distill.frozen_teacher(m), mask_token_id=67,
                                          teacher_timesteps=2, step_ratio=2,
                                          guidance_scale=2.0, seq_len=16, soft_weight=0.5)
        dnoise = distill.draw_distill_noise(torch.Generator().manual_seed(2), timesteps=2,
                                            step_ratio=2, batch=1, seq_len=16,
                                            codebook_size=64, device="cpu")
        z = lambda *shape: torch.zeros(*shape)  # noqa: E731
        metrics = dstep(TrainState(model=m.train(), optimizer=get_optimizer("adamw", m, 1e-3)),
                        {{"encoder_hidden_states": z(1, 7, 48), "cond_embeds": z(1, 32),
                         "micro_conds": z(1, 5), "empty_embeds": z(1, 7, 48),
                         "empty_cond_embeds": z(1, 32)}}, dnoise)
        assert metrics["soft_kl"].isfinite() and quant8.BLOCK_SIZE == 256
        assert sorted(DATASET_MAPS) == ["ds_clean", "ds_clean_upscaled", "sdxl_synthetic"]
        assert native_io.SOURCE.name == "muse_io.cpp"
        import numpy as np
        from open_muse_tpu_torch import eval as port_eval
        from open_muse_tpu_torch.eval import distill_midscale, inception, quality_regression
        from open_muse_tpu_torch.models.clip_vision import CLIPScorer, CLIPVisionEncoder
        from open_muse_tpu_torch.scripts import calculate_fid, gen_synthetic_dataset
        vision = CLIPVisionEncoder(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                                   num_attention_heads=2, image_size=28, patch_size=14,
                                   projection_dim=16)
        extractor = port_eval.CLIPFeatureExtractor(vision)
        assert extractor.extract([np.zeros((30, 30, 3), np.uint8)] * 2).shape == (2, 16)
        assert inception.InceptionV3("torchvision").fc.out_features == 1000
        assert quality_regression.RESOLUTION == 16 and distill_midscale.CANVAS == 64
        assert CLIPScorer and calculate_fid.main and gen_synthetic_dataset.main
        bad = [name for name in sys.modules
               if name.split(".")[0] in ("jax", "flax", "jaxlib", "open_muse_tpu")]
        assert not bad, bad
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]


def test_cpu_calls_launch_nothing():
    kernels.reset_launch_counts()
    jm = JaxUViT(**UVIT_TINY, _defer_init=True)
    port, _ = port_of(jm, MaskGiTUViT_v2, random_params(jm, 3))
    ids, ehs, cond, micro = (torch.from_numpy(a) for a in uvit_inputs(4))
    with torch.no_grad():
        port.generate2(ehs, cond, micro[:1], empty_embeds=ehs[:1], empty_cond_embeds=cond[:1],
                       timesteps=2, guidance_scale=2.0, seq_len=16,
                       generator=torch.Generator().manual_seed(0))
    assert kernels.launch_counts() == {fn.__name__: 0 for fn in kernels.WRAPPERS}
