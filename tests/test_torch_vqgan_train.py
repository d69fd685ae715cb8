"""VQGAN training in the port against the JAX package, on the CPU in fp32.

The quantizer's training half (``return_loss``: the VQ-VAE losses and the
straight-through gradient; ``get_soft_code`` for both metrics, deterministic
and under Gumbel noise drawn with JAX), each tokenizer's ``forward(...,
return_loss=True)``, the PatchGAN discriminator and its loss heads, the
adaptive weight at each family's last decoder convolution, the perceptual
loss (also on a seeded torchvision-layout VGG16 state_dict), the weight-decay
mask of both players, three two-player steps against a JAX step composed
from the JAX package's own functions, and ``train_vqgan.main`` end to end.
Weights are drawn from a numpy seed (or by flax's init) into the JAX side
and carried into the port by ``jax_params_to_state_dict``.  Code ids are
compared tie-aware: where the two sides pick different codes, the two
codes' fp32 distances must be equal to 1e-5 of their scale.
"""

import io
import json
import os
import tarfile

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from open_muse_tpu.core.convert import flatten_dict, unflatten_dict
from open_muse_tpu.models import discriminator as jdisc
from open_muse_tpu.models.maskgit_vqgan import MaskGitVQGAN as JaxMaskGit
from open_muse_tpu.models.movq import MOVQ as JaxMOVQ
from open_muse_tpu.models.paella_vq import PaellaVQModel as JaxPaella
from open_muse_tpu.models.taming_vqgan import VQGANModel as JaxVQGAN
from open_muse_tpu.ops import perceptual as jperceptual
from open_muse_tpu.ops import vq as jax_vq
from open_muse_tpu.training import lr_schedules as jlr
from open_muse_tpu.training.optimizers import decay_mask_fn
from open_muse_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from open_muse_tpu_torch.core.convert import jax_params_to_state_dict
from open_muse_tpu_torch.kernels.vq_argmin import vq_near_ties
from open_muse_tpu_torch.models import discriminator as tdisc
from open_muse_tpu_torch.models.maskgit_vqgan import MaskGitVQGAN
from open_muse_tpu_torch.models.movq import MOVQ
from open_muse_tpu_torch.models.paella_vq import PaellaVQModel
from open_muse_tpu_torch.models.taming_vqgan import VQGANModel
from open_muse_tpu_torch.ops import perceptual as tperceptual
from open_muse_tpu_torch.ops.vq import VectorQuantizer
from open_muse_tpu_torch.training import lr_schedules as tlr
from open_muse_tpu_torch.training import trainer as ttrainer
from open_muse_tpu_torch.training.optimizers import decay_mask, flax_param_name, get_optimizer
from test_torch_models import VQGAN_TINY, port_of, random_params
from test_torch_tokenizers import MOVQ_TINY, PAELLA_TINY
from test_torch_v1 import MASKGIT_VQ_TINY


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny convolutions gain nothing from torch's intra-op threads, and the
    parallel test workers share the cores: one thread each, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

FAMILIES = {"maskgit": (JaxMaskGit, MaskGitVQGAN, MASKGIT_VQ_TINY),
            "taming": (JaxVQGAN, VQGANModel, VQGAN_TINY),
            "movq": (JaxMOVQ, MOVQ, MOVQ_TINY),
            "paella": (JaxPaella, PaellaVQModel, PAELLA_TINY)}
# fp32 on both sides, summation order apart: max |error| <= REL x max |reference|
REL = 1e-4
TIE_RTOL = 1e-5
LR = 1e-3


def assert_close(got, want, rel=REL, name=""):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (name, err, scale)


def assert_ids_tie_aware(got, want, latents, codebook):
    """Equal ids, or (near-ties) the port's pick within TIE_RTOL of the
    scale of the minimum JAX picked."""
    got = torch.as_tensor(np.asarray(got)).reshape(-1)
    want = torch.as_tensor(np.asarray(want)).reshape(-1)
    z = torch.as_tensor(np.asarray(latents)).reshape(got.shape[0], -1)
    cb = torch.as_tensor(np.asarray(codebook))
    near, _, _ = vq_near_ties(want.int(), z, cb, TIE_RTOL)
    _, _, over = vq_near_ties(got.int(), z, cb, TIE_RTOL)
    differ = got != want
    assert bool((~differ | near).all()) and bool((over[differ] <= 0).all()), differ.nonzero()


def family_pair(family, seed):
    jcls, tcls, cfg = FAMILIES[family]
    jm = jcls(**cfg, _defer_init=True)
    flat = random_params(jm, seed)
    if family == "paella":  # statistics away from (0, 1)
        rs = np.random.RandomState(seed + 1)
        for key in flat:
            if key.endswith("running_mean"):
                flat[key] = rs.uniform(-0.5, 0.5, flat[key].shape).astype(np.float32)
            elif key.endswith("running_var"):
                flat[key] = rs.uniform(0.5, 1.5, flat[key].shape).astype(np.float32)
        jm.params = jax.tree_util.tree_map(jnp.asarray, unflatten_dict(flat))
    port, unused = port_of(jm, tcls, flat)
    assert not unused, unused
    return jm, port


def _latents(jm, family, x):
    method = {"maskgit": lambda m, p: m.encoder(p),
              "paella": lambda m, p: m._encode_latent(p)}.get(
        family, lambda m, p: m.quant_conv(m.encoder(p)))
    return jm.module.apply({"params": jm.params}, jnp.asarray(x), method=method)


def _codebook(jm, family):
    if family == "paella":
        return jm.params["vquantizer"]["codebook"]["embedding"]
    return jm.params["quantize"]["embedding"]["embedding"]


def _images(seed, batch=2, res=32):
    return np.random.RandomState(seed).rand(batch, res, res, 3).astype(np.float32)


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_dict(jax.device_get(params)).items()}


def _port_state(params, module):
    state, unused = jax_params_to_state_dict(_flat(params), module)
    assert not unused, unused
    return state


# -- the quantizer --------------------------------------------------------------


@pytest.mark.parametrize("metric", ["sq_l2", "l2"])
def test_quantizer_loss_and_straight_through_gradient_match_jax(metric):
    """``forward(h, return_loss=True)``: z_q (the codes' values), ids, the
    loss at commitment cost 0.4, and the gradients of ``sum(z_q * w) +
    loss`` in h and in the codebook against ``jax.grad``, to REL."""
    rs = np.random.RandomState(0)
    h = rs.randn(2, 4, 4, 8).astype(np.float32)
    w = rs.randn(2, 4, 4, 8).astype(np.float32)
    codebook = rs.randn(32, 8).astype(np.float32)
    jq = jax_vq.VectorQuantizer(32, 8, 0.4, metric=metric)

    def jax_objective(hh, cb):
        z_q, ids, loss = jq.apply({"params": {"embedding": {"embedding": cb}}}, hh, True)
        return jnp.sum(z_q * w) + loss, (z_q, ids, loss)

    (_, (jz, jids, jloss)), (jgh, jgcb) = jax.value_and_grad(
        jax_objective, argnums=(0, 1), has_aux=True)(jnp.asarray(h), jnp.asarray(codebook))
    tq = VectorQuantizer(32, 8, commitment_cost=0.4, metric=metric)
    with torch.no_grad():
        tq.weight.copy_(torch.from_numpy(codebook))
    th = torch.from_numpy(h).requires_grad_(True)
    z_q, ids, loss = tq(th, return_loss=True)
    (z_q * torch.from_numpy(w)).sum().add(loss).backward()
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert_close(z_q.detach(), jz, name="z_q")
    assert_close(loss.detach(), jloss, name="loss")
    assert_close(th.grad, jgh, name="dh")
    assert_close(tq.weight.grad, jgcb, name="dcodebook")
    z2, ids2 = tq(th)  # the two-value form for the callers that encode
    assert torch.equal(ids2, ids) and torch.equal(z2, tq.weight[ids].reshape(2, 4, 4, 8))


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("metric", ["sq_l2", "l2"])
def test_get_soft_code_matches_jax(metric, stochastic):
    """Soft codes (softmax of -d / temp) to REL and codes exactly: the
    argmin over the same distances, or under Gumbel noise the port's sample
    from ``jax.random.gumbel`` of the key JAX's ``categorical`` takes."""
    rs = np.random.RandomState(1)
    h = rs.randn(2, 4, 4, 8).astype(np.float32)
    codebook = rs.randn(32, 8).astype(np.float32)
    jq = jax_vq.VectorQuantizer(32, 8, metric=metric)
    key = jax.random.PRNGKey(7)
    jsoft, jcode = jq.apply({"params": {"embedding": {"embedding": jnp.asarray(codebook)}}},
                            jnp.asarray(h), 0.7, stochastic, key if stochastic else None,
                            method="get_soft_code")
    tq = VectorQuantizer(32, 8, metric=metric)
    with torch.no_grad():
        tq.weight.copy_(torch.from_numpy(codebook))
    gumbel = torch.from_numpy(np.asarray(jax.random.gumbel(key, (32, 32)))) if stochastic \
        else None
    soft, code = tq.get_soft_code(torch.from_numpy(h), 0.7, stochastic, gumbel)
    assert soft.shape == (2, 16, 32) and code.shape == (2, 16)
    assert_close(soft, jsoft, name="soft")
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode))
    if stochastic:  # the generator route samples too, and needs a source
        again = tq.get_soft_code(torch.from_numpy(h), 0.7, True,
                                 generator=torch.Generator().manual_seed(0))[1]
        assert again.shape == (2, 16)
        with pytest.raises(ValueError):
            tq.get_soft_code(torch.from_numpy(h), 0.7, True)


# -- the four tokenizers --------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_with_loss_and_soft_code_match_jax(family):
    """``forward(x, return_loss=True)`` -> (recon, z_q, ids, loss) against
    the JAX ``__call__`` (NHWC and NCHW input), ids tie-aware; ``loss`` None
    without ``return_loss``; ``get_soft_code`` at temp 0.5, deterministic,
    against the JAX model's (MOVQ and Paella: the l2 metric)."""
    jm, port = family_pair(family, 90)
    x = _images(91)
    recon, z_q, ids, loss = jm.module.apply({"params": jm.params}, jnp.asarray(x), True)
    latents = _latents(jm, family, x)
    codebook = _codebook(jm, family)
    for pixels in (torch.from_numpy(x), torch.from_numpy(x).permute(0, 3, 1, 2)):
        got = port(pixels, return_loss=True)
        assert_ids_tie_aware(got[2], ids, latents, codebook)
        if torch.equal(got[2], torch.from_numpy(np.asarray(ids)).long()):
            for name, g, w in zip(("recon", "z_q", "loss"), (got[0], got[1], got[3]),
                                  (recon, z_q, loss)):
                assert_close(g.detach(), w, name=name)
    assert port(torch.from_numpy(x))[3] is None
    soft, code = port.get_soft_code(torch.from_numpy(x), 0.5)
    jsoft, jcode = jm.get_soft_code(jnp.asarray(x), 0.5)
    assert_close(soft, jsoft, name="soft")
    assert_ids_tie_aware(code, jcode, latents, codebook)


# -- the discriminator, its loss heads, the adaptive weight ---------------------


def disc_pair(seed, base=8, layers=2):
    disc = jdisc.PatchDiscriminator(base_channels=base, n_layers=layers)
    params = disc.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)))["params"]
    # GroupNorm scales and biases away from their init, so both are held too
    flat = _flat(params)
    rs = np.random.RandomState(seed)
    for key in flat:
        if key.startswith("norm_"):
            flat[key] = flat[key] + 0.1 * rs.randn(*flat[key].shape).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_dict(flat))
    port = tdisc.PatchDiscriminator(base_channels=base, n_layers=layers)
    port.load_state_dict(_port_state(params, port))
    return disc, params, port


def test_patch_discriminator_and_loss_heads_match_jax():
    """Logits NHWC (from NHWC and NCHW images) to REL; hinge and vanilla
    discriminator losses and both generator losses to REL."""
    disc, params, port = disc_pair(3, base=8, layers=3)
    real, fake = _images(4), _images(5)
    apply = jax.jit(lambda a: disc.apply({"params": params}, a))
    jr, jf = apply(real), apply(fake)
    with torch.no_grad():
        tr = port(torch.from_numpy(real))
        tf = port(torch.from_numpy(fake).permute(0, 3, 1, 2))
    assert tr.shape == (2, 2, 2, 1)
    assert_close(tr, jr, name="logits_real")
    assert_close(tf, jf, name="logits_fake")
    for tfn, jfn in ((tdisc.hinge_d_loss, jdisc.hinge_d_loss),
                     (tdisc.vanilla_d_loss, jdisc.vanilla_d_loss)):
        assert_close(tfn(tr, tf), jfn(jr, jf), name=jfn.__name__)
    for kind in ("hinge", "vanilla"):
        assert_close(tdisc.generator_loss(tf, kind), jdisc.generator_loss(jf, kind), name=kind)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_adaptive_disc_weight_at_last_decoder_conv_matches_jax(family):
    """The port's ``last_decoder_conv`` holds the kernel JAX's
    ``last_decoder_kernel_path`` finds (HWIO -> OIHW); the gradients of the
    reconstruction loss and the generator loss there, and the adaptive
    weight at disc_weight 0.75, to REL.  Paella has no decoder.conv_out:
    both sides refuse it."""
    jm, port = family_pair(family, 95)
    path = jdisc.last_decoder_kernel_path(jm.params)
    if family == "paella":
        assert path is None
        with pytest.raises(ValueError):
            tdisc.last_decoder_conv(port)
        return
    weight = tdisc.last_decoder_conv(port).weight
    kernel = jm.params
    for k in path:
        kernel = kernel[k]
    np.testing.assert_array_equal(weight.detach().numpy(),
                                  np.asarray(kernel).transpose(3, 2, 0, 1))
    disc, dparams, tdisc_model = disc_pair(96)
    x = _images(97)

    def set_kernel(params, value):
        out = jax.tree_util.tree_map(lambda a: a, params)
        node = out
        for k in path[:-1]:
            node[k] = dict(node[k])
            node = node[k]
        node[path[-1]] = value
        return out

    def heads(k):
        recon, *_ = jm.module.apply({"params": set_kernel(jm.params, k)}, jnp.asarray(x), True)
        nll = jnp.mean(jnp.square(recon - x)) + jnp.mean(jnp.abs(recon - x))
        return nll, jdisc.generator_loss(disc.apply({"params": dparams}, recon))

    @jax.jit
    def both(k):
        _, vjp = jax.vjp(heads, k)
        return vjp((jnp.float32(1.0), jnp.float32(0.0)))[0], vjp((jnp.float32(0.0),
                                                                   jnp.float32(1.0)))[0]

    jrec, jgan = both(kernel)
    recon = port(torch.from_numpy(x), return_loss=True)[0]
    target = torch.from_numpy(x)
    nll = (recon - target).square().mean() + (recon - target).abs().mean()
    g_loss = tdisc.generator_loss(tdisc_model(recon))
    rec, = torch.autograd.grad(nll, weight, retain_graph=True)
    gan, = torch.autograd.grad(g_loss, weight)
    assert_close(rec.permute(2, 3, 1, 0), jrec, name="rec_grad")
    assert_close(gan.permute(2, 3, 1, 0), jgan, name="gan_grad")
    assert_close(tdisc.adaptive_disc_weight(rec, gan, 0.75),
                 jdisc.adaptive_disc_weight(jrec, jgan, 0.75), name="d_weight")


# -- the perceptual loss --------------------------------------------------------


def test_perceptual_loss_and_vgg16_layout_match_jax():
    """The JAX extractor's parameters carried across: the loss and its
    gradient in x to REL, 0 for equal images, no gradient into the
    pyramid; a seeded torchvision-layout VGG16 ``features.*`` state_dict
    through both packages' ``load_vgg16_features``: the same loss."""
    params = jperceptual.PerceptualFeatures().init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 32, 32, 3)))["params"]
    jloss = jperceptual.make_perceptual_loss_fn(32, params=params)
    module = tperceptual.PerceptualFeatures()
    tloss = tperceptual.make_perceptual_loss_fn(state_dict=_port_state(params, module))
    x, y = _images(10), _images(11)
    jval, jgrad = jax.jit(jax.value_and_grad(lambda a: jloss(a, jnp.asarray(y))))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    tval = tloss(tx, torch.from_numpy(y))
    tval.backward()
    assert_close(tval.detach(), jval, name="loss")
    assert_close(tx.grad, jgrad, name="grad")
    assert float(tloss(tx, tx)) == 0.0
    assert not any(p.requires_grad for p in tloss.features.parameters())

    rs = np.random.RandomState(12)
    sd, tv_index, in_ch = {}, 0, 3
    for ch, n_convs in jperceptual._STAGES:
        for _ in range(n_convs):
            sd[f"features.{tv_index}.weight"] = (rs.randn(ch, in_ch, 3, 3) /
                                                 np.sqrt(9 * in_ch)).astype(np.float32)
            sd[f"features.{tv_index}.bias"] = 0.1 * rs.randn(ch).astype(np.float32)
            tv_index, in_ch = tv_index + 2, ch
        tv_index += 1
    jvgg = jperceptual.make_perceptual_loss_fn(32, params=jperceptual.load_vgg16_features(sd))
    tvgg = tperceptual.make_perceptual_loss_fn(
        state_dict=tperceptual.load_vgg16_features({k: torch.from_numpy(v)
                                                    for k, v in sd.items()}))
    assert_close(tvgg(torch.from_numpy(x), torch.from_numpy(y)),
                 jax.jit(jvgg)(jnp.asarray(x), jnp.asarray(y)), name="vgg16 loss")


# -- the weight-decay mask ------------------------------------------------------


@pytest.mark.parametrize("player", ["discriminator", *sorted(FAMILIES)])
def test_decay_mask_matches_decay_mask_fn(player):
    """``decay_mask`` on the port's parameters equals ``decay_mask_fn`` on the
    JAX tree at their flax names (codebooks ``embedding``, GroupNorm
    ``scale`` / ``bias`` undecayed); every JAX leaf has a port parameter but
    Paella's BatchNorm statistics, buffers in the port."""
    if player == "discriminator":
        _, params, port = disc_pair(0)
    else:
        jm, port = family_pair(player, 0)
        params = jm.params
    want = {".".join(str(getattr(k, "key", k)) for k in path): bool(v)
            for path, v in jax.tree_util.tree_flatten_with_path(decay_mask_fn(params))[0]}
    got = decay_mask(port)
    names = {name: flax_param_name(port, name) for name in got}
    assert {name: want[flax] for name, flax in names.items()} == got
    extra = sorted(set(want) - set(names.values()))
    assert all(k.endswith(("running_mean", "running_var")) for k in extra), extra
    assert bool(extra) == (player == "paella")
    assert any(got.values()) and not all(got.values())


# -- three two-player steps against JAX -----------------------------------------


def _adam_state(opt_state):
    """optax's ``ScaleByAdamState`` (count, mu, nu) inside an AdamW chain."""
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def jax_vqgan_steps(jm, tx, weights, perceptual_loss, disc=None, disc_tx=None, disc_start=0,
                    kind="hinge"):
    """The JAX trainer's ``train_step`` and ``gan_train_step``, composed from
    the JAX package's functions exactly as ``train_vqgan.py:94-221`` composes
    them: they are closures inside its ``main``, which cannot be imported."""
    l1_weight, l2_weight, codebook_weight, perceptual_weight, disc_weight = weights
    model = jm

    def _rec_terms(recon, pixels):
        l2 = jnp.mean(jnp.square(recon - pixels))
        l1 = jnp.mean(jnp.abs(recon - pixels))
        parts = {"l2": l2, "l1": l1}
        nll = l2_weight * l2 + l1_weight * l1
        if perceptual_loss is not None:
            p = perceptual_loss(recon, pixels)
            parts["perceptual"] = p
            nll = nll + perceptual_weight * p
        return nll, parts

    def loss_fn(params, pixels):
        recon, z_q, indices, vq_loss = model.module.apply({"params": params}, pixels, True)
        nll, parts = _rec_terms(recon, pixels)
        loss = nll + codebook_weight * vq_loss
        return loss, {**parts, "vq_loss": vq_loss}

    @jax.jit
    def train_step(state, pixels):
        (loss, parts), grads = jax.value_and_grad(loss_fn, has_aux=True)(state["params"], pixels)
        updates, new_opt = tx.update(grads, state["opt"], state["params"])
        new_params = optax.apply_updates(state["params"], updates)
        metrics = {"loss": loss, "grad_norm": optax.global_norm(grads), **parts}
        return {"step": state["step"] + 1, "params": new_params, "opt": new_opt}, metrics

    if disc is None:
        return train_step
    d_loss_fn = jdisc.hinge_d_loss if kind == "hinge" else jdisc.vanilla_d_loss
    last_path = jdisc.last_decoder_kernel_path(model.params)

    def _get(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def _set(tree, path, value):
        if not path:
            return value
        out = dict(tree)
        out[path[0]] = _set(tree[path[0]], path[1:], value)
        return out

    def gan_loss_fn(params, disc_params, pixels, d_w):
        recon, z_q, indices, vq_loss = model.module.apply({"params": params}, pixels, True)
        nll, parts = _rec_terms(recon, pixels)
        logits_fake = disc.apply({"params": disc_params}, recon)
        g_loss = jdisc.generator_loss(logits_fake, kind)
        loss = nll + codebook_weight * vq_loss + d_w * g_loss
        return loss, ({**parts, "vq_loss": vq_loss, "g_loss": g_loss}, recon)

    @jax.jit
    def gan_train_step(state, disc_state, pixels):
        disc_factor = jnp.where(state["step"] >= disc_start, 1.0, 0.0)
        kernel = _get(state["params"], last_path)

        def heads(k):
            p2 = _set(state["params"], last_path, k)
            recon, *_ = model.module.apply({"params": p2}, pixels, True)
            nll, _ = _rec_terms(recon, pixels)
            g = jdisc.generator_loss(disc.apply({"params": disc_state["params"]}, recon), kind)
            return nll, g

        _, heads_vjp = jax.vjp(heads, kernel)
        (rec_grad,) = heads_vjp((jnp.float32(1.0), jnp.float32(0.0)))
        (gan_grad,) = heads_vjp((jnp.float32(0.0), jnp.float32(1.0)))
        d_w = jdisc.adaptive_disc_weight(rec_grad, gan_grad, disc_weight) * disc_factor
        (loss, (parts, recon)), grads = jax.value_and_grad(gan_loss_fn, has_aux=True)(
            state["params"], disc_state["params"], pixels, d_w)
        updates, new_opt = tx.update(grads, state["opt"], state["params"])
        new_state = {"step": state["step"] + 1,
                     "params": optax.apply_updates(state["params"], updates), "opt": new_opt}
        recon = jax.lax.stop_gradient(recon)

        def disc_loss(dp):
            logits_real = disc.apply({"params": dp}, pixels)
            logits_fake = disc.apply({"params": dp}, recon)
            return (disc_factor * d_loss_fn(logits_real, logits_fake),
                    (jnp.mean(logits_real), jnp.mean(logits_fake)))

        (d_loss, (lr_mean, lf_mean)), d_grads = jax.value_and_grad(
            disc_loss, has_aux=True)(disc_state["params"])
        d_updates, d_new_opt = disc_tx.update(d_grads, disc_state["opt"], disc_state["params"])
        new_disc = {"step": disc_state["step"] + 1,
                    "params": optax.apply_updates(disc_state["params"], d_updates),
                    "opt": d_new_opt}
        metrics = {"loss": loss, "grad_norm": optax.global_norm(grads), "d_loss": d_loss,
                   "d_weight": d_w, "logits_real": lr_mean, "logits_fake": lf_mean, **parts}
        return new_state, new_disc, metrics

    return gan_train_step


@pytest.mark.parametrize("gan", [True, False])
def test_vqgan_steps_match_jax(gan):
    """Three steps of the MaskGIT VQGAN (perceptual weight 0.5, AdamW at a
    constant LR after a first update at lr 0, weight decay 1e-4, clipping at
    1.0 for both players) on one batch: with the hinge PatchGAN at
    disc_weight 0.75 and disc_start 1 (step 1 gated: d_weight and d_loss
    exactly 0 on both sides, the discriminator moved by weight decay alone;
    steps 2 - 3 adversarial), and without it.  After each step: every
    metric to REL; both players' AdamW first moments (the clipped gradients'
    average) to REL of each tensor's largest; their parameters within 2e-6
    of JAX's but at most 0.1% of the elements, and those within one update
    (LR): Adam's first real update is g / (|g| + eps) an element, so an
    element whose gradient lies at fp32 summation noise moves by up to LR
    either way (0.01% of the elements beyond 2e-6 without the GAN on the
    CPU, none beyond 2.1e-6 with it).  The step's ids equal to JAX's on the
    same parameters, tie-aware."""
    jm, port = family_pair("maskgit", 100)
    x = _images(101)
    weights = (1.0, 1.0, 1.0, 0.5, 0.75 if gan else 0.0)
    pparams = jperceptual.PerceptualFeatures().init(jax.random.PRNGKey(2),
                                                    jnp.zeros((1, 32, 32, 3)))["params"]
    jperc = jperceptual.make_perceptual_loss_fn(32, params=pparams)
    tperc = tperceptual.make_perceptual_loss_fn(
        state_dict=_port_state(pparams, tperceptual.PerceptualFeatures()))

    def txs():
        return jax_get_optimizer("adamw", jlr.get_scheduler("constant_with_warmup", LR, 0),
                                 weight_decay=1e-4, max_grad_norm=1.0)

    def adamw(module):
        return get_optimizer("adamw", module, tlr.get_scheduler("constant_with_warmup", LR, 0),
                             weight_decay=1e-4, max_grad_norm=1.0)

    tx = txs()
    jstate = {"step": jnp.int32(0), "params": jm.params, "opt": tx.init(jm.params)}
    players = (ttrainer.TrainState(model=port.train(), optimizer=adamw(port)),)
    disc = jdisc_state = disc_tx = None
    if gan:
        disc, dparams, tdisc_model = disc_pair(102)
        disc_tx = txs()
        jdisc_state = {"step": jnp.int32(0), "params": dparams, "opt": disc_tx.init(dparams)}
        players += (ttrainer.TrainState(model=tdisc_model, optimizer=adamw(tdisc_model)),)
    jstep = jax_vqgan_steps(jm, tx, weights, jperc, disc, disc_tx, disc_start=1)
    step = ttrainer.make_vqgan_train_step(perceptual_weight=0.5, perceptual=tperc,
                                          disc_weight=weights[-1], disc_start=1)
    keys = {"loss", "grad_norm", "l2", "l1", "perceptual", "vq_loss"}
    if gan:
        keys |= {"g_loss", "d_loss", "d_weight", "logits_real", "logits_fake"}
    before = {k: v.clone() for k, v in players[-1].model.state_dict().items()}
    latents_and_ids = jax.jit(lambda params: jm.module.apply(
        {"params": params}, jnp.asarray(x),
        method=lambda m, p: (m.encoder(p), m.quantize.get_code(m.encoder(p)))))
    for i in range(3):
        latents, jids = latents_and_ids(jstate["params"])
        with torch.no_grad():
            tids = port.get_code(torch.from_numpy(x))
        assert_ids_tie_aware(tids, jids, latents,
                             jstate["params"]["quantize"]["embedding"]["embedding"])
        if gan:
            jstate, jdisc_state, jmetrics = jstep(jstate, jdisc_state, jnp.asarray(x))
        else:
            jstate, jmetrics = jstep(jstate, jnp.asarray(x))
        metrics = step(players, {"pixel_values": torch.from_numpy(x)})
        assert set(metrics) == set(jmetrics) == keys
        for name in keys:
            assert_close(metrics[name], jmetrics[name], name=name)
        if gan and i == 0:
            assert float(metrics["d_weight"]) == float(metrics["d_loss"]) == 0.0
            for name, p in players[1].model.named_parameters():  # weight decay alone
                np.testing.assert_allclose(p.detach().numpy(),
                                           before[name].numpy() * (1 - 1e-3 * 1e-4)
                                           if decay_mask(players[1].model)[name]
                                           else before[name].numpy(), rtol=1e-6, err_msg=name)
        elif gan:
            assert float(metrics["d_weight"]) > 0 and float(metrics["d_loss"]) > 0
        sides = [(players[0], jstate)]
        if gan:
            sides.append((players[1], jdisc_state))
        for player, jside in sides:
            want = _port_state(jside["params"], player.model)
            mu = _port_state(_adam_state(jside["opt"]).mu, player.model)
            moved = 0
            for name, p in player.model.named_parameters():
                assert_close(player.optimizer.torch_optimizer.state[p]["exp_avg"], mu[name],
                             name=f"step {i + 1} first moment {name}")
                diff = (p.detach() - want[name]).abs()
                assert float(diff.max()) <= LR, (i, name, float(diff.max()))
                moved += int((diff > 2e-6).sum())
            assert moved <= 1e-3 * sum(p.numel() for p in player.model.parameters()), (i, moved)
    assert all(p.step == 3 and p.optimizer.count == 3 for p in players)


# -- the CLI end to end ---------------------------------------------------------


def write_image_shard(path, n):
    from PIL import Image

    with tarfile.open(path, "w") as tf:
        for i in range(n):
            png = io.BytesIO()
            Image.fromarray((np.random.RandomState(i).rand(36, 36, 3) * 255)
                            .astype(np.uint8)).save(png, format="PNG")
            for ext, data in (("png", png.getvalue()),
                              ("json", json.dumps({"width": 36, "height": 36}).encode())):
                info = tarfile.TarInfo(f"{i:05d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def _vqgan_argv(tmp_path, gan):
    from test_torch_train_cli import REPO_ROOT

    return [f"config={os.path.join(REPO_ROOT, 'configs', 'vqgan_gan.yaml')}",
            f"dataset.params.train_shards_path_or_url={tmp_path / 'img-000.tar'}",
            "dataset.params.shuffle_buffer_size=8", "dataset.params.resolution=32",
            f"experiment.output_dir={tmp_path / 'out'}", "experiment.log_every=2",
            "experiment.save_every=2", "experiment.generate_every=4",
            "experiment.checkpoints_total_limit=1", "training.batch_size=2",
            "training.max_train_steps=4", "training.seed=0", "lr_scheduler.params.warmup_steps=1",
            "training.disc_start=2", f"training.disc_weight={0.75 if gan else 0.0}",
            "training.disc_channels=8", "training.disc_layers=2", "device=cpu"] + [
        f"model.vq_model.params.{k}={list(v) if isinstance(v, tuple) else v}"
        for k, v in MASKGIT_VQ_TINY.items()]


@pytest.mark.parametrize("gan", [True, False])
def test_train_vqgan_main(tmp_path, gan):
    """``train_vqgan.main`` on ``configs/vqgan_gan.yaml`` at tiny size on the
    CPU: 4 steps, a metrics line every 2 (the GAN's d_weight and d_loss 0
    before disc_start 2, non-zero after), ``recon-4.png``, checkpoints
    every 2 with a limit of 1 (and the discriminator's, under
    ``discriminator/``); the saved VQ directory loads in the JAX package's
    ``from_pretrained`` and in the port's, and both give the trained
    model's ``get_code``."""
    from open_muse_tpu_torch.training import train_vqgan

    write_image_shard(str(tmp_path / "img-000.tar"), 8)
    players = train_vqgan.main(_vqgan_argv(tmp_path, gan))
    assert len(players) == (2 if gan else 1) and players[0].step == 4
    out = tmp_path / "out"
    with open(out / "metrics.jsonl") as f:
        logged = [json.loads(line) for line in f]
    assert [m["step"] for m in logged] == [2, 4]
    for m in logged:
        assert all(np.isfinite(m[k]) for k in ("loss", "l2", "l1", "perceptual", "vq_loss"))
    if gan:
        assert logged[0]["d_weight"] == logged[0]["d_loss"] == 0.0
        assert logged[1]["d_weight"] > 0 and logged[1]["d_loss"] > 0
        assert sorted(os.listdir(out / "discriminator")) == ["checkpoint-2", "checkpoint-4"]
    else:
        assert "d_loss" not in logged[0] and not (out / "discriminator").exists()
    assert (out / "recon-4.png").is_file()
    assert sorted(d for d in os.listdir(out) if d.startswith("checkpoint-")) == ["checkpoint-4"]
    saved = str(out / "checkpoint-4" / "unwrapped_model")
    x = _images(120)
    with torch.no_grad():
        want = players[0].model.get_code(torch.from_numpy(x))
        again = MaskGitVQGAN.from_pretrained(saved, device="cpu").get_code(torch.from_numpy(x))
    assert torch.equal(again, want)
    jm = JaxMaskGit.from_pretrained(saved)
    jids = jm.get_code(jnp.asarray(x))
    assert_ids_tie_aware(want, jids, _latents(jm, "maskgit", x), _codebook(jm, "maskgit"))
