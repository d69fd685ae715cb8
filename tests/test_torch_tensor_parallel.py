"""Tensor-parallel weights (``training.tp``) on the CPU, in fp32.

In one process: the fused attention sublayers' plain versions (kernels 9 -
12) on head shards of tp = 2 and 4, the GLU's (kernels 7 / 8) on column
shards, and v1's Normformer mid-MLP norm on a split width, each rank's part
computed alone and the parts summed (or, for the norm, the row gathered
around it) as ``parallel.tensor_parallel`` and the kernels' ``tp=``
argument do; held against the JAX package's XLA oracles on the whole
weights, forward and through ``jax.vjp``, with the residual-gradient rule
(trap 1: only the rank of tp index 0 adds the residual stream's gradient).

On four gloo ranks (``torch_parallel_worker.py`` with a world of 4): fsdp=2
x tp=2, two v2 steps against the single-process port, and
``train_muse.main`` for v2 and v1 text at ``training.fsdp=2
training.tp=2``, v2 also on the raw-image branch (2 heads: 1 a rank, the
trunk's unfused path; eval, grad-norm lines, bucket diagnostics,
accumulation 2, the sample and inpainting panels gathering the shards);
two tp=4 steps of a v2 with 12 heads of 64 (3 a rank: the attentions stay
whole, so the fused sublayers still run) against the single-process port;
the two-rank tp=2 runs against JAX are in ``test_torch_parallel.py``; and
tp=2 through ``scripts/launch.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from open_muse_tpu.models.transformer_v1 import FeedForward as JaxFeedForward
from open_muse_tpu.ops.pallas import attn_sublayer as A
from open_muse_tpu_torch import kernels
from open_muse_tpu_torch.kernels import attn_sublayer as TA
from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2
from open_muse_tpu.models.clip_text import CLIPTextEncoder as JaxCLIP
from open_muse_tpu.models.taming_vqgan import VQGANModel as JaxVQGAN
from open_muse_tpu_torch.models.clip_text import CLIPTextEncoder
from open_muse_tpu_torch.models.taming_vqgan import VQGANModel
from test_torch_models import VQGAN_TINY, port_of, random_params, uvit_inputs
from test_torch_parallel import UVIT_TP, _free_port, _single
from test_torch_pipeline import CLIP_FOR_UVIT
from test_torch_train_cli import REPO_ROOT, _argv, make_preencoded_shard
from test_torch_train_raw import _raw_argv, write_raw_shard
from test_torch_train_v1 import _v1_text_argv, v1_pair_with_dropout
from test_torch_training import _port_noise, uvit_pair

HERE = os.path.dirname(os.path.abspath(__file__))
B, S, D, H, EPS = 2, 16, 512, 8, 1e-6  # 8 heads of 64: 4 a rank at tp 2, 2 at tp 4
KV_LEN, KV_PAD = 77, 128
# fp32 on both sides, summation order (and the shards' partial sums): the
# gradients are O(1) - O(10); 2e-4 absolute plus 1e-4 relative sits ~10x above
# the differences seen
ATOL = 2e-4
WORKER_TIMEOUT_S = 420
# the fused sublayers' shapes (heads of 64, rmsnorm, no bias) with 12 heads:
# 3 a rank at tp 4
UVIT_ODD_TP4 = dict(hidden_size=768, num_attention_heads=12)


def _np(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


class _Rank:
    """What the sublayer Functions read of a tp group: the rank's index."""

    def __init__(self, rank):
        self.rank = rank


def _sublayer_inputs(seed, cross):
    rs = np.random.RandomState(seed)
    p = dict(x=_np(rs, B, S, D), res=_np(rs, B, S, D), ln=1.0 + _np(rs, D, scale=0.1),
             adaln=_np(rs, B, 2 * D, scale=0.1),
             w_in=_np(rs, D, D if cross else 3 * D, scale=D ** -0.5),
             wout=_np(rs, D, D, scale=D ** -0.5), g_out=_np(rs, B, S, D),
             g_res=_np(rs, B, S, D, scale=0.5))
    if cross:
        p["kv"] = _np(rs, B, KV_LEN, 2 * D)
    return p


def _heads(w, tp, rank, parts):
    """Rank ``rank``'s columns of each of the ``parts`` [q | k | v] blocks of
    a JAX (in, parts * D) kernel, as a torch (parts * D / tp, in) weight."""
    inner = w.shape[1] // parts // tp
    cols = [w[:, j * (w.shape[1] // parts) + rank * inner:][:, :inner] for j in range(parts)]
    return _t(np.concatenate(cols, axis=1).T)


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
def test_sublayer_head_shards_sum_to_jax(cross, tp):
    """Each rank's plain forward on its heads (w_in's q / k / v columns,
    wout's rows, kv's k / v columns), the partial outputs summed, equals
    ``_xla_ref_self`` / ``_xla_ref_cross`` on the whole weights (h whole on
    every rank); the backward with g_res on rank 0 alone
    (``attn_sublayer._tp_backward``), dx, d(ln) and d(adaln) summed over
    the ranks and the weight and kv gradients stacked, equals ``jax.vjp``
    of the oracle.  kv_len 77: JAX pads kv to 128 and masks."""
    p = _sublayer_inputs(tp + 10 * cross, cross)
    local = H // tp
    j = [jnp.asarray(v) for v in (p["x"], p["res"], p["ln"], p["adaln"], p["w_in"], p["wout"])]
    if cross:
        j.append(jnp.asarray(np.pad(p["kv"], ((0, 0), (0, KV_PAD - KV_LEN), (0, 0)))))
        oracle = lambda *a: A._xla_ref_cross(*a, num_heads=H, eps=EPS, kv_len=KV_LEN)  # noqa: E731
    else:
        oracle = lambda *a: A._xla_ref_self(*a, num_heads=H, eps=EPS)  # noqa: E731
    (want_out, want_h), vjp = jax.vjp(oracle, *j)
    grads = vjp((jnp.asarray(p["g_out"]), jnp.asarray(p["g_res"])))
    x, res, ln, adaln = (_t(p[k]) for k in ("x", "res", "ln", "adaln"))
    out = 0.0
    dx = dln = dadaln = 0.0
    dw_in, dwout, dkv = [], [], []
    for rank in range(tp):
        w_in = _heads(p["w_in"], tp, rank, 1 if cross else 3)
        wout = _t(p["wout"][rank * 64 * local:(rank + 1) * 64 * local].T)
        g_res = TA._tp_backward(_t(p["g_res"]), _Rank(rank))
        if cross:
            kv = _heads(p["kv"].reshape(-1, 2 * D), tp, rank, 2).T.reshape(B, KV_LEN, -1)
            o, h = kernels.attn_sublayer_cross(x, res, ln, adaln, w_in, wout, kv, local, EPS)
            got = kernels.attn_sublayer_cross_bwd(x, res, ln, adaln, w_in, wout, kv,
                                                  _t(p["g_out"]), g_res, local, EPS)
            dkv.append(got[6])
        else:
            o, h = kernels.attn_sublayer_self(x, res, ln, adaln, w_in, wout, local, EPS)
            got = kernels.attn_sublayer_self_bwd(x, res, ln, adaln, w_in, wout,
                                                 _t(p["g_out"]), g_res, local, EPS)
        _close(h, want_h, atol=1e-6)
        out = out + o
        dx, dln, dadaln = dx + got[0], dln + got[2], dadaln + got[3]
        dw_in.append(got[4])
        dwout.append(got[5])
    _close(out, want_out)
    _close(dx, grads[0])
    _close(dx, grads[1])  # dres is dx
    _close(dln, grads[2])
    _close(dadaln, grads[3])
    parts = 1 if cross else 3
    want_w_in = np.asarray(grads[4])
    for rank in range(tp):
        _close(dw_in[rank], _heads(want_w_in, tp, rank, parts))
    _close(torch.cat(dwout, dim=1), np.asarray(grads[5]).T)
    if cross:
        want_kv = np.asarray(grads[6])[:, :KV_LEN].reshape(-1, 2 * D)
        for rank in range(tp):
            _close(dkv[rank], _heads(want_kv, tp, rank, 2).T.reshape(B, KV_LEN, -1))


def test_sublayer_rejects_a_head_count_it_cannot_take():
    with pytest.raises(ValueError, match="even head count"):
        kernels.attn_sublayer_self(torch.zeros(1, 8, 128), None, torch.ones(128),
                                   torch.zeros(1, 256), torch.zeros(192, 128),
                                   torch.zeros(128, 64), 1)
    assert TA.sublayer_shapes_supported(1024, 16, 2) and TA.sublayer_shapes_supported(1024, 16, 4)
    assert not TA.sublayer_shapes_supported(128, 2, 2)  # one head a rank


@pytest.mark.parametrize("tp", [2, 4])
def test_glu_column_shards_sum_to_jax(tp):
    """K = 256 split over the ranks (wi_0 / wi_1's columns, wo's rows): the
    partial GLU products summed equal ``(gelu(a) * b) @ wo`` and its
    ``jax.vjp``, da / db / dwo stacked back (rtol 2e-5, atol 2e-4 as the
    GLU's own tests: the Pallas erf)."""
    rs = np.random.RandomState(tp)
    m, k, n = 64, 256, 128
    a, b = _np(rs, m, k), _np(rs, m, k)
    wo, g = _np(rs, k, n, scale=0.05), _np(rs, m, n)
    f = lambda a, b, wo: (jax.nn.gelu(a, approximate=False) * b) @ wo  # noqa: E731
    want, vjp = jax.vjp(f, jnp.asarray(a), jnp.asarray(b), jnp.asarray(wo))
    da_want, db_want, dwo_want = vjp(jnp.asarray(g))
    c = k // tp
    out, da, db, dwo = 0.0, [], [], []
    for rank in range(tp):
        cols = slice(rank * c, (rank + 1) * c)
        ar, br, wr = _t(a[:, cols]), _t(b[:, cols]), _t(wo[cols].T)
        out = out + kernels.glu_down_matmul(ar, br, wr)
        got = kernels.glu_down_matmul_bwd(ar, br, wr, _t(g))
        da.append(got[0])
        db.append(got[1])
        dwo.append(got[2])
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(torch.cat(da, 1).numpy(), np.asarray(da_want), rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(torch.cat(db, 1).numpy(), np.asarray(db_want), rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(torch.cat(dwo, 1).numpy(), np.asarray(dwo_want).T, rtol=2e-5,
                               atol=2e-4)


@pytest.mark.parametrize("tp", [2, 4])
def test_v1_split_mid_mlp_norm_matches_jax(tp):
    """v1's FFN (RMSNorm with biases, the Normformer mid-MLP norm over the
    intermediate width 128) on column shards: each rank's GLU columns (and
    its slice of their biases), the row gathered whole around the mid norm
    (the port's norm module, kernel 1's plain version) and sliced back (trap
    2), wo's rows summed, the whole bias added once; against the JAX
    ``FeedForward`` on the whole weights, and its ``jax.vjp`` for x, wi_0,
    the mid norm's scale and bias and wo (REL 1e-4 of the largest value, as
    the v1 tests)."""
    jm, port = v1_pair_with_dropout("text_rms_bias", seed=3, rate=0.0)
    ffn = port.transformer_layers[0].ffn
    params = jm.params["transformer_layers_0"]["ffn"]
    x = np.random.RandomState(tp).randn(2, 16, jm.config.hidden_size).astype(np.float32)
    g = np.random.RandomState(tp + 1).randn(*x.shape).astype(np.float32)

    def jax_ffn(x, params):
        return JaxFeedForward(jm.config).apply({"params": params}, x)

    want, vjp = jax.vjp(jax_ffn, jnp.asarray(x), params)
    dx_want, dparams = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_()
    c = jm.config.intermediate_size // tp
    normed = ffn.pre_mlp_layer_norm(xt)
    parts = []
    for rank in range(tp):
        cols = slice(rank * c, (rank + 1) * c)
        h0 = torch.nn.functional.linear(normed, ffn.wi_0.weight[cols], ffn.wi_0.bias[cols])
        h1 = torch.nn.functional.linear(normed, ffn.wi_1.weight[cols], ffn.wi_1.bias[cols])
        parts.append(torch.nn.functional.gelu(h0) * h1)
    whole = ffn.mid_mlp_layer_norm(torch.cat(parts, dim=-1))  # gather, norm
    out = sum(torch.nn.functional.linear(whole[..., rank * c:(rank + 1) * c],  # scatter
                                         ffn.wo.weight[:, rank * c:(rank + 1) * c])
              for rank in range(tp)) + ffn.wo.bias
    out.backward(_t(g))
    scale = np.abs(np.asarray(want)).max()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-4 * scale)
    for got, ref in ((xt.grad, dx_want), (ffn.wi_0.weight.grad.T, dparams["wi_0"]["kernel"]),
                     (ffn.mid_mlp_layer_norm.weight.grad, dparams["mid_mlp_layer_norm"]["scale"]),
                     (ffn.wo.weight.grad.T, dparams["wo"]["kernel"]),
                     (ffn.wo.bias.grad, dparams["wo"]["bias"])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4 * np.abs(ref).max())


# -- fsdp = 2 x tp = 2 on four gloo ranks -------------------------------------------------

@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    import dataclasses

    work = tmp_path_factory.mktemp("fsdp_tp")

    def v2_case(seed, key0, **overrides):
        jm, port = uvit_pair(seed, **overrides)
        ids, ehs, cond, micro = uvit_inputs(seed + 1, batch=4)
        ids = ids % jm.config.codebook_size
        batch = {"image_tokens": torch.from_numpy(ids).long(),
                 "encoder_hidden_states": _t(ehs), "cond_embeds": _t(cond),
                 "micro_conds": _t(micro)}
        noise = [_port_noise(jax.random.PRNGKey(key0 + i), ids, jm.config.codebook_size)
                 for i in range(2)]
        return {"kind": "v2", "config": dataclasses.asdict(port.config),
                "weights": {k: v.clone() for k, v in port.state_dict().items()},
                "batch": batch, "noise": noise, "mask_id": jm.config.mask_token_id,
                "codebook": jm.config.codebook_size}

    v2 = v2_case(9, 1000, **UVIT_TP)
    v2_tp4 = v2_case(11, 1100, **UVIT_ODD_TP4)
    for i in range(2):  # a shard for each of the two batch shares (the fsdp ranks)
        make_preencoded_shard(str(work / f"enc-{i:03d}.tar"), 8)
        make_preencoded_shard(str(work / f"v1-{i:03d}.tar"), 8, seq=256, text_dim=48)
    shard, v1_shard = str(work / "enc-{000..001}.tar"), str(work / "v1-{000..001}.tar")
    split = ["training.fsdp=2", "training.tp=2"]
    main_out = str(work / "main")
    jc, jv = JaxCLIP(**CLIP_FOR_UVIT, _defer_init=True), JaxVQGAN(**VQGAN_TINY, _defer_init=True)
    port_of(jc, CLIPTextEncoder, random_params(jc, 52))[0].save_pretrained(str(work / "clip"))
    port_of(jv, VQGANModel, random_params(jv, 53))[0].save_pretrained(str(work / "vq"))
    for i in range(2):
        write_raw_shard(str(work / f"raw-{i:03d}.tar"), 8, seed=i)
    raw = str(work / "raw-{000..001}.tar")
    raw_out = str(work / "raw")
    inputs = {"v2": v2, "v2_tp4": v2_tp4,
              "main_v2": _argv(shard, main_out, 2) + split + ["device=cpu"] + [
                  f"model.transformer.{k}={v}" for k, v in UVIT_TP.items()],
              "main_v1": _v1_text_argv(v1_shard, str(work / "main_v1"), 2,
                                       extra=["training.pre_encode=true", *split]),
              "main_raw": _raw_argv(raw, raw, raw_out, str(work / "clip"), str(work / "vq"), 2)
              + split + ["experiment.generate_every=2", "experiment.profile_steps=null",
                         f"experiment.inpainting_validation_dir={REPO_ROOT}/inpainting_validation"]}
    torch.save(inputs, str(work / "inputs4.pt"))
    port_number = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MUSE_", "RANK", "WORLD_SIZE", "MASTER_", "LOCAL_RANK"))}
    env["OMP_NUM_THREADS"] = "1"
    logs = [open(work / f"rank{rank}.log", "w+") for rank in range(4)]
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
                               str(rank), "4", str(port_number), str(work)],
                              env=env, stdout=logs[rank], stderr=subprocess.STDOUT)
             for rank in range(4)]
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
    ranks = [torch.load(str(work / f"rank{r}.pt"), weights_only=False) for r in range(4)]
    return {"ranks": ranks, "single": _single(v2), "single_tp4": _single(v2_tp4),
            "main_out": main_out, "raw_out": raw_out}


def test_fsdp2_tp2_steps_match_one_process(four_ranks):
    """Two v2 steps on (dp 1, fsdp 2, tp 2), each fsdp rank on 2 of the 4
    rows: the metrics equal the single-process port's to rtol 2e-5, the
    gathered weights and EMA to atol 2e-6 where AdamW's first moment
    exceeds 1e-7, else the lr (``test_torch_parallel.assert_adamw_params``)."""
    from test_torch_parallel import _metrics_close, assert_adamw_params

    single = four_ranks["single"]
    want = [{k: float(v) for k, v in m.items() if v.dim() == 0} for m in single["metrics"]]
    for rank in four_ranks["ranks"]:
        got = rank["steps"]
        assert got["sharded"]
        _metrics_close([{k: float(v) for k, v in m.items() if v.dim() == 0}
                        for m in got["metrics"]], want)
        for key in ("params", "ema"):
            assert_adamw_params(got[key], single[key], single["moments"])


def test_tp4_odd_local_heads_keep_the_fused_sublayers(four_ranks):
    """12 heads of 64 at tp=4 (3 a rank, an odd count the fused sublayer
    kernels 9 - 12 cannot take): both attentions of every layer stay whole,
    the GLU and the head are split, and every step calls the fused sublayer
    wrappers exactly as often as the single-process step does; the metrics
    and weights equal the single-process port's as in the fsdp=2 x tp=2 test."""
    from test_torch_parallel import _metrics_close, assert_adamw_params

    single = four_ranks["single_tp4"]
    assert min(single["sublayer_calls"].values()) > 0, single["sublayer_calls"]
    want = [{k: float(v) for k, v in m.items() if v.dim() == 0} for m in single["metrics"]]
    for rank in four_ranks["ranks"]:
        got = rank["tp4"]
        assert got["sharded"] and got["split"] == {"attention": False, "ffn": True}, got["split"]
        assert got["sublayer_calls"] == single["sublayer_calls"]
        _metrics_close([{k: float(v) for k, v in m.items() if v.dim() == 0}
                        for m in got["metrics"]], want)
        for key in ("params", "ema"):
            assert_adamw_params(got[key], single[key], single["moments"])


def test_fsdp2_tp2_main_runs_and_saves_whole_weights(four_ranks):
    """``train_muse.main`` at ``training.fsdp=2 training.tp=2``: v2 (2 heads
    a rank), v1 text and the v2 raw branch all take their 2 steps sharded;
    the v2 checkpoint holds whole weights equal to every rank's gathered
    ones; the raw run's panels (the shards gathered on every rank, rank 0
    sampling) are written."""
    ckpt = os.path.join(four_ranks["main_out"], "checkpoint-2", "unwrapped_model")
    saved = MaskGiTUViT_v2.from_pretrained(ckpt, device="cpu").state_dict()
    for rank in four_ranks["ranks"]:
        for run in ("main_v2", "main_v1", "main_raw"):
            assert rank[run]["sharded"] and rank[run]["step"] == 2, run
        assert set(rank["main_v2"]["params"]) == set(saved)
        for name, p in saved.items():
            assert torch.equal(rank["main_v2"]["params"][name], p), name
    for panel in ("samples-2.png", "inpainting-2.png"):
        assert os.path.isfile(os.path.join(four_ranks["raw_out"], panel)), panel


def test_launcher_runs_train_muse_at_tp2(tmp_path):
    """``scripts/launch.py --nproc-per-node 2`` -> ``torch.distributed.run``
    -> ``train_muse.main`` at ``training.tp=2`` on the CPU (gloo): both
    ranks finish one step, and rank 0's checkpoint holds whole weights
    (``from_pretrained`` loads them strictly into the unsharded model)."""
    from open_muse_tpu_torch.scripts import launch

    shard, out = str(tmp_path / "enc-000.tar"), str(tmp_path / "out")
    make_preencoded_shard(shard, 8)
    argv = _argv(shard, out, 1) + ["training.tp=2", "device=cpu"] + [
        f"model.transformer.{k}={v}" for k, v in UVIT_TP.items()]
    assert launch.main(["--nproc-per-node", "2", "--", *argv]) == 0
    model = MaskGiTUViT_v2.from_pretrained(
        os.path.join(out, "checkpoint-1", "unwrapped_model"), device="cpu")
    assert model.transformer_layers[0].attention.query.weight.shape == (256, 256)
    assert model.mlm_layer.conv2.weight.shape[0] == model.config.codebook_size
