"""The train steps (MaskGiTUViT_v2, v1 text -> image, class-conditional
MaskGIT, the two-player VQGAN step), the v2 eval step, and checkpoints.

Counterpart of ``open_muse_tpu/training/trainer.py`` (``make_uvit_train_step``,
``make_v1_text2image_train_step``, ``make_maskgit_train_step``,
``make_uvit_eval_step``, ``grad_norm_param_names``, ``save_checkpoint``,
``find_latest_checkpoint``, ``load_checkpoint``) and of the VQGAN trainer's
``train_step`` / ``gan_train_step`` (``open_muse_tpu/training/train_vqgan.py``).
The JAX step is one jitted, donated program a step; here a step updates the
models, optimizers and EMA of its ``TrainState``s in place and returns its
metrics as device tensors, and on the card it is one replayed CUDA graph
(``TrainStep`` around each step's body).  Masking and cond-dropout noise
come in as an argument
(``masking.MaskingNoise``) because JAX's PRNG bits cannot be reproduced; the
v1 model's dropout masks are drawn inside the step from the spec's
``dropout`` source.

Under data parallelism (a spec's ``data_parallel``, from
``parallel.mesh.data_parallel``) each rank runs a step on its rows of the
global batch, with the noise drawn for the global
batch and sliced by rank: the losses' denominators are global, the
gradients are averaged over the ranks right after the backward (before the
global norm, since JAX clips by the global gradient's norm; under gradient
accumulation once, on the mean in the step that updates), and the metrics
are the ranks' means, so a rank's update is the single-process update on
the global batch.  The collectives are issued on the step's stream, inside
its captured graph.  The bucket diagnostics stay this rank's, and under
accumulation so does the ``grad_norm`` metric (the micro-batch's norm; the
update clips the reduced mean by its own norm).

A checkpoint is ``checkpoint-{step}/`` with ``metadata.json``,
``unwrapped_model/`` and ``ema_model/`` (``config.json`` + ``pytorch_model.bin``)
and ``training_state.pt`` (step, optimizer).  The JAX package's Orbax
checkpoints are not read.  A model sharded by FSDP2
(``parallel.sharding.shard_params``) steps eagerly, since its hooks and
all-gathers are not captured into a graph (``TrainStep`` logs it once), and
so does one with tensor-parallel weights whose tp group is not NCCL's
(gloo's collectives are not captured); under NCCL a tensor-parallel step is
one captured graph, its collectives inside.  A sharded model's checkpoint
(FSDP2, tensor-parallel or both) holds the whole weights and EMA, gathered
from every rank, and each rank's optimizer shard as
``training_state-rank{r}.pt``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

from ..core.captured import capture_on, captured, pointer_key, replay
from ..core.modeling import WEIGHTS_NAMES, load_state_file
from ..models.discriminator import (adaptive_disc_weight, generator_loss, hinge_d_loss,
                                    last_decoder_conv, vanilla_d_loss)
from ..models.taming_vqgan import to_nhwc
from ..ops.losses import (cross_entropy_loss, soft_target_cross_entropy,
                          weighted_cross_entropy_loss)
from ..parallel.mesh import SINGLE, DataParallel, rank_and_world
from ..parallel.tensor_parallel import local, tensor_parallel_of
from ..utils import logging as mlog
from ..utils import training_utils as tu
from .ema import EMA
from .masking import (MaskingNoise, cond_keep_mask, mask_or_random_replace_tokens,
                      prepend_class_token)
from .optimizers import Optimizer, flax_param_name, global_norm, leaf_norms

logger = mlog.get_logger(__name__)

__all__ = ["TrainState", "StepSpec", "VQGANSpec", "TrainStep", "uvit_train_body",
           "v1_text2image_train_body", "maskgit_train_body", "vqgan_train_body",
           "make_uvit_train_step", "make_v1_text2image_train_step", "make_maskgit_train_step",
           "make_vqgan_train_step", "make_uvit_eval_step", "grad_norm_param_names",
           "save_checkpoint", "find_latest_checkpoint", "load_checkpoint"]


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    ema: Optional[EMA] = None
    step: int = 0


@dataclasses.dataclass(frozen=True)
class StepSpec:
    """What a train step closes over (a captured step's graph bakes it in)."""

    mask_schedule: Callable
    mask_id: int
    codebook_size: int
    min_masking_rate: float = 0.0
    noise_type: str = "mask"
    predict_all_tokens: bool = False
    mask_contiguous_region_prob: Optional[float] = None
    label_smoothing: float = 0.0
    cond_dropout_prob: float = 0.0
    autocast_dtype: Optional[torch.dtype] = None
    with_diagnostics: bool = False
    with_param_grad_norms: bool = False
    # the v1 forward's dropout keep-mask source (``KeepMasks``); None: no dropout
    dropout: Optional[Callable] = None
    # v2: the loss is the soft-target cross entropy against batch["soft_targets"]
    use_soft_targets: bool = False
    # the reductions over the ranks the batch is split over (``SINGLE``: none)
    data_parallel: DataParallel = SINGLE

    def step_inputs(self, step: int, device) -> Dict[str, torch.Tensor]:
        """Device inputs the host derives from the step count: none."""
        return {}


@dataclasses.dataclass(frozen=True)
class VQGANSpec:
    """What the VQGAN step closes over: the loss weights, the perceptual
    loss (``ops.perceptual``; None: no perceptual term) and the adversarial
    term (``disc_weight`` 0: no discriminator)."""

    l1_weight: float = 1.0
    l2_weight: float = 1.0
    codebook_weight: float = 1.0
    perceptual_weight: float = 0.0
    perceptual: Optional[Callable] = None
    disc_weight: float = 0.0
    disc_start: int = 0
    disc_loss: str = "hinge"
    data_parallel: DataParallel = SINGLE

    def step_inputs(self, step: int, device) -> Dict[str, torch.Tensor]:
        """``disc_factor``: 1 from the generator's update ``disc_start`` on,
        else 0 (taming's ``adopt_weight``), a 0-d device input, since a graph
        freezes host values."""
        if self.disc_weight <= 0.0:
            return {}
        return {"disc_factor": torch.full((), float(step >= self.disc_start), device=device)}


def is_fsdp(model: nn.Module) -> bool:
    """True when ``model`` is FSDP2-sharded (``fully_shard``)."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def is_sharded(model: nn.Module) -> bool:
    """True when ``model``'s parameters are DTensor shards
    (``parallel.sharding.shard_params``): FSDP2-sharded (but between a
    forward without a backward (an eval) and the next step, when the root
    holds them whole), tensor-parallel, or both."""
    return is_fsdp(model) or tensor_parallel_of(model) is not None


def steps_eagerly(model: nn.Module) -> bool:
    """True when ``model``'s train step cannot be one captured graph: FSDP2's
    hooks and all-gathers, or a tp group whose collectives (gloo's) are not
    captured."""
    tp = tensor_parallel_of(model)
    return is_fsdp(model) or (tp is not None and not tp.nccl)


def model_class(model: nn.Module) -> type:
    """The model's own class (FSDP2 puts a subclass of it in its place)."""
    from torch.distributed.fsdp import FSDPModule

    return next(c for c in type(model).__mro__ if not issubclass(c, FSDPModule))


def _flax_leaves(model: nn.Module):
    """(index in ``model.parameters()``, the JAX package's name) of every
    parameter, in the JAX ``tree_leaves`` order."""
    names = [flax_param_name(model, n) for n, _ in model.named_parameters()]
    return sorted(enumerate(names), key=lambda item: item[1].split("."))


def grad_norm_param_names(model: nn.Module) -> List[str]:
    """The JAX package's names of the model's parameters in its
    ``tree_leaves`` order, the order of ``metrics['param_grad_norms']``."""
    return [name for _, name in _flax_leaves(model)]


def autocast(spec: StepSpec, device: torch.device):
    # no autocast cache: a capture must not keep casts of the weights made
    # before the optimizer's update
    return torch.autocast(device.type, dtype=spec.autocast_dtype or torch.bfloat16,
                          enabled=spec.autocast_dtype is not None, cache_enabled=False)


def _reduced(state: TrainState, grads, dp: DataParallel):
    """``grads`` averaged over the ranks, unless the optimizer accumulates
    (it then reduces the mean once, in the step that updates)."""
    if state.optimizer.accumulation_steps == 1:
        dp.reduce_gradients_(grads)
    return grads


def update(state: TrainState, grad_norm, emit: bool, dp: DataParallel) -> None:
    """The optimizer's update (under accumulation the mean reduced over the
    ranks first) and the EMA's."""
    state.optimizer.update(grad_norm, emit, dp.reduce_gradients_)
    if state.ema is not None:
        state.ema.update(state.model)


def backward(state: TrainState, loss, dp: DataParallel = SINGLE):
    """The backward of ``loss`` into fresh ``.grad``s, averaged over the
    ranks of ``dp`` -> (grads in ``model.parameters()`` order, their global
    norm)."""
    state.optimizer.zero_grad()
    loss.backward()
    for p in state.model.parameters():
        if p.grad is None:  # a parameter the loss does not reach: JAX's grad is 0
            p.grad = torch.zeros_like(p)
    grads = _reduced(state, [p.grad for p in state.model.parameters()], dp)
    return grads, global_norm(grads)


def _grads(state: TrainState, loss, dp: DataParallel):
    """``torch.autograd.grad`` of ``loss`` over the state's model alone, set
    as its parameters' ``.grad`` -> (grads, their global norm); a parameter
    the loss does not reach gets 0, as JAX's grad."""
    params = list(state.model.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = _reduced(state, [torch.zeros_like(p) if g is None else g
                             for p, g in zip(params, grads)], dp)
    for p, g in zip(params, grads):
        p.grad = g
    return grads, global_norm(grads)


def _masked(batch, spec: StepSpec, noise: MaskingNoise):
    """The v1 steps' masking: the JAX defaults but for the schedule, the
    minimum rate and the codebook."""
    return mask_or_random_replace_tokens(
        batch["image_tokens"], spec.mask_id, spec.mask_schedule, noise,
        min_masking_rate=spec.min_masking_rate, codebook_size=spec.codebook_size)


def uvit_train_body(state: TrainState, spec: StepSpec, batch: Dict[str, torch.Tensor],
                    noise: MaskingNoise, emit: bool = True) -> Dict[str, torch.Tensor]:
    """One step's device work, with no host reads (what a graph holds):
    masking, CFG cond dropout (where the batch carries ``empty_embeds``),
    the forward with the loss under autocast (with ``spec.use_soft_targets``
    the soft-target cross entropy against ``batch["soft_targets"]`` (B, S,
    K) over the masked positions), the backward, the global grad
    norm, the optimizer's update (only accumulation when not ``emit``) and
    the EMA update.  Metrics: loss, grad_norm (the micro-batch's, before
    clipping), avg_masking_rate and, when asked, the four bucket diagnostics
    and ``param_grad_norms`` (``grad_norm_param_names`` order)."""
    model, dp = state.model, spec.data_parallel
    input_ids, labels, loss_weight, mask_prob = mask_or_random_replace_tokens(
        batch["image_tokens"], spec.mask_id, spec.mask_schedule, noise,
        min_masking_rate=spec.min_masking_rate, noise_type=spec.noise_type,
        codebook_size=spec.codebook_size, predict_all_tokens=spec.predict_all_tokens,
        mask_contiguous_region_prob=spec.mask_contiguous_region_prob)
    ehs, cond = batch["encoder_hidden_states"], batch["cond_embeds"]
    if spec.cond_dropout_prob > 0.0 and "empty_embeds" in batch:
        keep = noise.cond_dropout >= spec.cond_dropout_prob
        ehs = torch.where(keep[:, None, None], ehs, batch["empty_embeds"].to(ehs.dtype))
        cond = torch.where(keep[:, None], cond, batch["empty_cond_embeds"].to(cond.dtype))
    with autocast(spec, ehs.device):
        logits = model(input_ids, ehs, cond, batch["micro_conds"])
        if spec.use_soft_targets:  # neither loss_weight nor label_smoothing, as in JAX
            loss = soft_target_cross_entropy(logits, labels, batch["soft_targets"],
                                             drop_first=False, ratio=dp.ratio)
        elif loss_weight is not None:
            loss = weighted_cross_entropy_loss(logits, labels, loss_weight,
                                               spec.label_smoothing, ratio=dp.ratio)
        else:
            loss = cross_entropy_loss(logits, labels, spec.label_smoothing, ratio=dp.ratio)
    grads, grad_norm = backward(state, loss, dp)
    loss, masking_rate = dp.mean(loss.detach(), mask_prob.mean())
    metrics = {"loss": loss, "grad_norm": grad_norm, "avg_masking_rate": masking_rate}
    if spec.with_diagnostics:
        logits = logits.detach()
        metrics["pixel_entropy_by_bucket"] = tu.pixel_entropy_per_percent_masked_bucket(
            logits, input_ids, spec.mask_id)
        metrics["image_entropy_by_bucket"] = tu.image_entropy_per_percent_masked_bucket(
            logits, input_ids, spec.mask_id)
        metrics["cross_entropy_by_bucket"] = tu.cross_entropy_per_percent_masked_bucket(
            logits, labels, input_ids, spec.mask_id, spec.label_smoothing)
        metrics["token_prob_deciles_by_bucket"] = \
            tu.token_prob_deciles_per_percent_masked_bucket(logits, input_ids, spec.mask_id)
    if spec.with_param_grad_norms:
        # DTensor shards' norms: of the whole tensors
        metrics["param_grad_norms"] = leaf_norms([grads[i] for i, _ in _flax_leaves(model)])
    update(state, grad_norm, emit, dp)
    return metrics


def v1_text2image_train_body(state: TrainState, spec: StepSpec, batch: Dict[str, torch.Tensor],
                             noise: MaskingNoise, emit: bool = True) -> Dict[str, torch.Tensor]:
    """The v1 ``MaskGitTransformer`` text -> image step's device work
    (``make_v1_text2image_train_step``): masking, the CFG cond-dropout mask
    (``noise.cond_dropout >= cond_dropout_prob``) multiplied into the
    projected text states, the forward with dropout from ``spec.dropout``
    and the loss under autocast, the backward, the global grad norm, the
    optimizer's update and the EMA update (where the state has an EMA).
    batch: image_tokens (B, S), encoder_hidden_states (B, L, E); the text
    conditions through cross-attention alone.  Metrics: loss, grad_norm,
    avg_masking_rate."""
    input_ids, labels, _, mask_prob = _masked(batch, spec, noise)
    ehs = batch["encoder_hidden_states"]
    cond_mask = None
    if spec.cond_dropout_prob > 0.0:
        cond_mask = cond_keep_mask(noise.cond_dropout, spec.cond_dropout_prob, ehs.dtype)
    dp = spec.data_parallel
    with autocast(spec, ehs.device):
        logits = state.model(input_ids, ehs, cond_dropout_mask=cond_mask, dropout=spec.dropout)
        loss = cross_entropy_loss(logits, labels, spec.label_smoothing, ratio=dp.ratio)
    _, grad_norm = backward(state, loss, dp)
    update(state, grad_norm, emit, dp)
    loss, masking_rate = dp.mean(loss.detach(), mask_prob.mean())
    return {"loss": loss, "grad_norm": grad_norm, "avg_masking_rate": masking_rate}


def maskgit_train_body(state: TrainState, spec: StepSpec, batch: Dict[str, torch.Tensor],
                       noise: MaskingNoise, emit: bool = True) -> Dict[str, torch.Tensor]:
    """The class-conditional MaskGIT step's device work
    (``make_maskgit_train_step``): masking, the class token prepended
    (``class_ids + codebook_size``, label -100), the forward with dropout
    from ``spec.dropout`` and the loss under autocast, the backward, the
    global grad norm and the optimizer's update.  No EMA update, even when
    the state has an EMA: the JAX trainer builds this step without an
    ``ema_decay`` (ROADMAP fault 3.10).  batch: image_tokens (B, S),
    class_ids (B,).  Metrics: loss, grad_norm, avg_masking_rate."""
    input_ids, labels, _, mask_prob = _masked(batch, spec, noise)
    input_ids, labels = prepend_class_token(input_ids, labels, batch["class_ids"],
                                            spec.codebook_size)
    dp = spec.data_parallel
    with autocast(spec, input_ids.device):
        logits = state.model(input_ids, dropout=spec.dropout)
        loss = cross_entropy_loss(logits, labels, spec.label_smoothing, ratio=dp.ratio)
    _, grad_norm = backward(state, loss, dp)
    state.optimizer.update(grad_norm, emit, dp.reduce_gradients_)
    loss, masking_rate = dp.mean(loss.detach(), mask_prob.mean())
    return {"loss": loss, "grad_norm": grad_norm, "avg_masking_rate": masking_rate}


def vqgan_train_body(states, spec: VQGANSpec, batch: Dict[str, torch.Tensor], noise=None,
                     emit: bool = True) -> Dict[str, torch.Tensor]:
    """The VQGAN step's device work (``train_step`` / ``gan_train_step`` of
    the JAX trainer).  states: (generator,) or, with the adversarial term,
    (generator, discriminator); batch: pixel_values (B, R, R, 3) in [0, 1]
    and, with the term, disc_factor (0-d).

    The generator: the model's forward with the VQ loss, ``nll = l2_weight
    l2 + l1_weight l1 [+ perceptual_weight perceptual]``; with the term,
    ``d_weight = adaptive_disc_weight(d nll / dW, d g_loss / dW) *
    disc_factor`` at the decoder's last convolution W, then ``loss = nll +
    codebook_weight vq_loss + d_weight g_loss`` (without it, no g_loss);
    its gradients over the generator's parameters alone, the global norm,
    clip and update.  Then the discriminator on the same batch with the
    reconstruction detached: ``disc_factor * d_loss(D(x), D(recon))``, its
    gradients, clip and update (both updates run before ``disc_start``
    too: zero gradients, and the weight decay still moves the weights).
    Metrics as JAX names them: loss, grad_norm (before clipping), l2, l1,
    perceptual, vq_loss and with the term g_loss, d_loss, d_weight,
    logits_real, logits_fake."""
    gen, dp = states[0], spec.data_parallel
    target = to_nhwc(batch["pixel_values"])
    recon, _, _, vq_loss = gen.model(target, return_loss=True)
    l2 = (recon - target).square().mean()
    l1 = (recon - target).abs().mean()
    metrics = {"l2": l2.detach(), "l1": l1.detach(), "vq_loss": vq_loss.detach()}
    nll = spec.l2_weight * l2 + spec.l1_weight * l1
    if spec.perceptual is not None:
        perceptual = spec.perceptual(recon, target)
        metrics["perceptual"] = perceptual.detach()
        nll = nll + spec.perceptual_weight * perceptual
    loss = nll + spec.codebook_weight * vq_loss
    if len(states) > 1:
        disc, disc_factor = states[1].model, batch["disc_factor"]
        g_loss = generator_loss(disc(recon), spec.disc_loss)
        # both heads' gradients at W from this one forward (taming's way);
        # JAX takes the same two numbers from one more forward and two VJP pulls
        weight = last_decoder_conv(gen.model).weight
        rec_grad, = torch.autograd.grad(nll, weight, retain_graph=True)
        gan_grad, = torch.autograd.grad(g_loss, weight, retain_graph=True)
        dp.reduce_gradients_([rec_grad, gan_grad])  # the global batch's, as in JAX
        d_weight = adaptive_disc_weight(rec_grad, gan_grad, spec.disc_weight) * disc_factor
        loss = loss + d_weight * g_loss
        metrics.update(g_loss=g_loss.detach(), d_weight=d_weight)
    _, grad_norm = _grads(gen, loss, dp)
    gen.optimizer.update(grad_norm, emit, dp.reduce_gradients_)
    metrics.update(loss=loss.detach(), grad_norm=grad_norm)
    if len(states) > 1:
        d_loss_fn = hinge_d_loss if spec.disc_loss == "hinge" else vanilla_d_loss
        logits_real, logits_fake = disc(target), disc(recon.detach())
        d_loss = disc_factor * d_loss_fn(logits_real, logits_fake)
        _, d_grad_norm = _grads(states[1], d_loss, dp)
        states[1].optimizer.update(d_grad_norm, emit, dp.reduce_gradients_)
        metrics.update(d_loss=d_loss.detach(), logits_real=logits_real.detach().mean(),
                       logits_fake=logits_fake.detach().mean())
    means = [k for k in metrics if k not in ("grad_norm", "d_weight")]  # those two are global
    return {**metrics, **dict(zip(means, dp.mean(*(metrics[k] for k in means))))}


def _flat_inputs(batch, noise):
    """(names, tensors) of a batch and its noise (if any), in a fixed order."""
    names, tensors = [], []
    for k in sorted(batch):
        names.append(("batch", k))
        tensors.append(batch[k])
    for f in dataclasses.fields(noise) if noise is not None else ():
        value = getattr(noise, f.name)
        if value is not None:
            names.append(("noise", f.name))
            tensors.append(value)
    return tuple(names), tensors


def _unflat_inputs(names, tensors, noise_cls):
    batch, noise = {}, {}
    for (kind, k), t in zip(names, tensors):
        (batch if kind == "batch" else noise)[k] = t
    return batch, noise_cls(**noise) if noise else None


@dataclasses.dataclass
class _StepGraph:
    graph: torch.cuda.CUDAGraph
    inputs: List[torch.Tensor]
    outputs: Dict[str, torch.Tensor]
    launches: Dict[str, int]


class TrainStep:
    """``step(state, batch, noise) -> metrics``: the host's part of a step
    (the lr at the update count, the EMA decay at ``state.step``, whether
    this call emits an update under gradient accumulation, the spec's
    ``step_inputs`` at ``state.step`` added to the batch, the counters)
    around ``body(state, spec, batch, noise, emit)`` (``uvit_train_body``,
    ``v1_text2image_train_body``, ``maskgit_train_body``,
    ``vqgan_train_body``).  ``state`` is one ``TrainState`` or a tuple of
    them, the players of one step (the VQGAN's generator and
    discriminator): each has its host part, and the graph holds them all.

    On CPU tensors the body runs eagerly.  On the card it is one replayed
    CUDA graph a step (two under gradient accumulation: accumulate, and
    accumulate and update, chosen on the host), the counterpart of the JAX
    package's one jitted, donated step.  A graph's first call is a real
    step run eagerly on a side stream (it builds the kernels and allocates
    the optimizer state), after which the graph is captured, launching
    nothing; every later call copies the batch and noise into the graph's
    static buffers and replays it, and returns clones of its metrics.  The
    graphs are keyed on the pointers of the parameters, the EMA shadow, the
    accumulation buffers and (for the update) the optimizer state: a resumed
    or rebuilt state captures afresh.  A capture that fails raises; the
    eager body never runs in its place.  ``step.eager`` runs the same host
    part and body without a graph.  The kernels' launch counts stay exact:
    a replay adds the wrappers' counts its capture recorded.  The generator
    of ``spec.dropout`` (if any) is registered with each graph, so a replay
    draws new dropout masks and advances it."""

    def __init__(self, body: Callable, spec: StepSpec):
        self.body = body
        self.spec = spec
        self._graphs: Dict[bool, tuple] = {}  # emit -> (key, _StepGraph)
        self.last_capture: Dict[str, Any] = {}
        self._told_eager = False

    def __call__(self, state, batch, noise: Optional[MaskingNoise] = None):
        return self._run(state, batch, noise, graph=True)

    def eager(self, state, batch, noise: Optional[MaskingNoise] = None):
        return self._run(state, batch, noise, graph=False)

    def _run(self, state, batch, noise, graph: bool):
        players = state if isinstance(state, tuple) else (state,)
        emits = {p.optimizer.begin_step() for p in players}
        if len(emits) != 1:
            raise ValueError("the players of one step must share gradient_accumulation_steps")
        emit = emits.pop()
        for p in players:
            if p.ema is not None:
                p.ema.set_step(p.step)
        device = next(iter(batch.values())).device
        batch = {**batch, **self.spec.step_inputs(players[0].step, device)}
        names, tensors = _flat_inputs(batch, noise)
        eagerly = any(steps_eagerly(p.model) for p in players)
        if eagerly and graph and device.type == "cuda" and not self._told_eager:
            logger.warning("the model is FSDP2-sharded or its tensor-parallel group is not "
                           "NCCL's: its train step runs eagerly (FSDP2's hooks and all-gathers "
                           "and gloo's collectives are not captured into a CUDA graph)")
            self._told_eager = True
        if not graph or eagerly or all(t.device.type == "cpu" for t in tensors):
            metrics = self.body(state, self.spec, batch, noise, emit)
        else:
            metrics = self._replay(state, players, (type(noise), names), tensors, emit)
        for p in players:
            p.optimizer.end_step(emit)
            p.step += 1
        return metrics

    def _key(self, players, names, tensors, emit):
        held = []
        for p in players:
            held += [*p.model.parameters(), *p.optimizer.accumulators()]
            if p.ema is not None:
                held += [*p.ema.shadow.values(), p.ema.step_decay]
            if emit:
                held += p.optimizer.state_tensors()
        return (names, tuple((tuple(t.shape), t.dtype, t.device) for t in tensors),
                pointer_key(local(t) for t in held))

    def _replay(self, state, players, names, tensors, emit):
        key = self._key(players, names, tensors, emit)
        cached = self._graphs.get(emit)
        if cached is not None and cached[0] == key:
            entry = cached[1]
            for static, t in zip(entry.inputs, tensors):
                static.copy_(t)
            replay(entry.graph, entry.launches)
            return {k: v.clone() for k, v in entry.outputs.items()}
        self._graphs.pop(emit, None)  # stale pointers: drop the old graph first
        metrics, entry = self._warm_up_and_capture(state, names, tensors, emit)
        self._graphs[emit] = (self._key(players, names, tensors, emit), entry)
        return metrics

    def _warm_up_and_capture(self, state, names, tensors, emit):
        t0 = time.perf_counter()
        inputs = [t.clone(memory_format=torch.contiguous_format) for t in tensors]
        noise_cls, names = names
        body = lambda: self.body(  # noqa: E731
            state, self.spec, *_unflat_inputs(names, inputs, noise_cls), emit)
        stream = torch.cuda.Stream(device=inputs[0].device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):  # the real step: it launches, and counts
            metrics = {k: v.clone() for k, v in body().items()}
        warm = time.perf_counter() - t0
        generator = getattr(getattr(self.spec, "dropout", None), "generator", None)
        graph, outputs, delta = capture_on(stream, body, "the train step",
                                           generators=() if generator is None else (generator,))
        self.last_capture = {"emit": emit, "warm_up_s": warm,
                             "seconds": time.perf_counter() - t0, "launches": delta}
        return metrics, _StepGraph(graph, inputs, outputs, delta)


def make_uvit_train_step(
    mask_schedule,
    mask_id: int,
    *,
    codebook_size: int,
    min_masking_rate: float = 0.0,
    noise_type: str = "mask",
    predict_all_tokens: bool = False,
    mask_contiguous_region_prob: Optional[float] = None,
    label_smoothing: float = 0.0,
    cond_dropout_prob: float = 0.0,
    autocast_dtype: Optional[torch.dtype] = None,
    with_diagnostics: bool = False,
    with_param_grad_norms: bool = False,
    use_soft_targets: bool = False,
    data_parallel: DataParallel = SINGLE,
) -> TrainStep:
    """``train_step(state, batch, noise) -> metrics`` (``TrainStep`` around
    ``uvit_train_body``).

    batch: image_tokens (B, S) int, encoder_hidden_states (B, L, E),
    cond_embeds (B, C), micro_conds (B, 5) and, for CFG cond dropout,
    empty_embeds (1, L, E) and empty_cond_embeds (1, C): an image keeps its
    text where ``noise.cond_dropout >= cond_dropout_prob``.  One call masks,
    runs the forward with the loss (under autocast to ``autocast_dtype``
    when given) and the backward, takes the global grad norm, has the
    optimizer clip and update (or accumulate, under gradient accumulation)
    and then updates the EMA, and increments ``state.step``.  With
    ``use_soft_targets`` the batch also carries soft_targets (B, S, K) fp32
    (the VQ model's ``get_soft_code``) and the loss is their cross entropy
    over the masked positions.  ``data_parallel``
    (``parallel.mesh.data_parallel``): the reductions over the ranks the
    global batch is split over, each rank stepping on its rows."""
    return TrainStep(uvit_train_body, StepSpec(
        mask_schedule, mask_id, codebook_size, min_masking_rate, noise_type, predict_all_tokens,
        mask_contiguous_region_prob, label_smoothing, cond_dropout_prob, autocast_dtype,
        with_diagnostics, with_param_grad_norms, use_soft_targets=use_soft_targets,
        data_parallel=data_parallel))


def make_v1_text2image_train_step(mask_schedule, mask_id: int, *, codebook_size: int,
                                  min_masking_rate: float = 0.0, label_smoothing: float = 0.0,
                                  cond_dropout_prob: float = 0.0,
                                  autocast_dtype: Optional[torch.dtype] = None,
                                  dropout: Optional[Callable] = None,
                                  data_parallel: DataParallel = SINGLE) -> TrainStep:
    """The v1 ``MaskGitTransformer`` text -> image step (``model.architecture:
    transformer``), ``TrainStep`` around ``v1_text2image_train_body``.  An
    image keeps its text where ``noise.cond_dropout >= cond_dropout_prob``;
    ``dropout`` (``KeepMasks``) draws the model's ``hidden_dropout`` masks,
    None runs the forward deterministic.  The EMA moves where the state has
    one (the JAX trainer's ``ema_decay`` 0.9999 under ``use_ema``);
    clipping is the optimizer's (``max_grad_norm``); ``data_parallel`` as in
    ``make_uvit_train_step``."""
    return TrainStep(v1_text2image_train_body, StepSpec(
        mask_schedule, mask_id, codebook_size, min_masking_rate, label_smoothing=label_smoothing,
        cond_dropout_prob=cond_dropout_prob, autocast_dtype=autocast_dtype, dropout=dropout,
        data_parallel=data_parallel))


def make_maskgit_train_step(mask_schedule, mask_id: int, *, codebook_size: int,
                            min_masking_rate: float = 0.0, label_smoothing: float = 0.0,
                            autocast_dtype: Optional[torch.dtype] = None,
                            dropout: Optional[Callable] = None,
                            data_parallel: DataParallel = SINGLE) -> TrainStep:
    """The class-conditional MaskGIT step (``train_maskgit_imagenet``),
    ``TrainStep`` around ``maskgit_train_body``; batch: image_tokens (B, S),
    class_ids (B,); ``dropout`` and ``data_parallel`` as in
    ``make_v1_text2image_train_step``."""
    return TrainStep(maskgit_train_body, StepSpec(
        mask_schedule, mask_id, codebook_size, min_masking_rate, label_smoothing=label_smoothing,
        autocast_dtype=autocast_dtype, dropout=dropout, data_parallel=data_parallel))


def make_vqgan_train_step(*, l1_weight: float = 1.0, l2_weight: float = 1.0,
                          codebook_weight: float = 1.0, perceptual_weight: float = 0.0,
                          perceptual: Optional[Callable] = None, disc_weight: float = 0.0,
                          disc_start: int = 0, disc_loss: str = "hinge",
                          data_parallel: DataParallel = SINGLE) -> TrainStep:
    """The VQGAN tokenizer's step, ``TrainStep`` around ``vqgan_train_body``:
    ``step((generator,), {"pixel_values": x})``, or with ``disc_weight`` > 0
    ``step((generator, discriminator), {"pixel_values": x})``, each player a
    ``TrainState`` with its own AdamW and no EMA; the step fills the batch's
    disc_factor from the generator's ``step`` and ``disc_start``;
    ``data_parallel`` as in ``make_uvit_train_step``."""
    if disc_loss not in ("hinge", "vanilla"):
        raise ValueError(f"disc_loss {disc_loss!r}: hinge or vanilla")
    return TrainStep(vqgan_train_body, VQGANSpec(
        l1_weight, l2_weight, codebook_weight, perceptual_weight,
        perceptual if perceptual_weight > 0.0 else None, disc_weight, disc_start, disc_loss,
        data_parallel))


def make_uvit_eval_step(mask_schedule, mask_id: int, *,
                        eval_mask_ratios=(0.1, 0.3, 0.5, 0.7, 0.9),
                        label_smoothing: float = 0.0,
                        autocast_dtype: Optional[torch.dtype] = None,
                        data_parallel: DataParallel = SINGLE) -> Callable:
    """``eval_step(model, batch, noise) -> loss`` at fixed mask ratios
    (``noise.eval_index`` picks one per image; with ``data_parallel``, the
    global batch's loss from this rank's rows); on the card one replayed
    CUDA graph (``core.captured``), as the JAX eval step is jitted."""
    dp = data_parallel
    ratios = tuple(eval_mask_ratios)

    @torch.no_grad()
    def body(model, image_tokens, ehs, cond, micro, permutation, eval_index, ratio_values):
        noise = MaskingNoise(None, permutation, None, None, None, eval_index)
        input_ids, labels, _, _ = mask_or_random_replace_tokens(
            image_tokens, mask_id, mask_schedule, noise, eval_mask_ratios=ratio_values,
            is_train=False)
        with torch.autocast(ehs.device.type, dtype=autocast_dtype or torch.bfloat16,
                            enabled=autocast_dtype is not None, cache_enabled=False):
            logits = model(input_ids, ehs, cond, micro)
            loss = cross_entropy_loss(logits, labels, label_smoothing, ratio=dp.ratio)
        return dp.mean(loss)

    def eval_step(model, batch, noise: MaskingNoise):
        if is_sharded(model):  # FSDP2's all-gathers stay out of graphs
            return body(model, batch["image_tokens"], batch["encoder_hidden_states"],
                        batch["cond_embeds"], batch["micro_conds"], noise.permutation,
                        noise.eval_index,
                        torch.tensor(ratios, device=noise.eval_index.device))
        return captured(model, ("eval_step", ratios, label_smoothing, autocast_dtype,
                                dp.share, dp.batch_group is None),
                        lambda *t: body(model, *t), batch["image_tokens"],
                        batch["encoder_hidden_states"], batch["cond_embeds"],
                        batch["micro_conds"], noise.permutation, noise.eval_index,
                        torch.tensor(ratios, device=noise.eval_index.device),
                        modules=(model,))

    return eval_step


# -- checkpoints (reference train_muse.py:571-610, 1265-1306) ------------------

_STATE_FILE = "training_state.pt"


def _save_model(path: str, model, state_dict) -> None:
    """``model``'s ``config.json``, as its ``save_pretrained`` writes it, and
    ``state_dict`` as ``pytorch_model.bin``: a directory both packages'
    ``from_pretrained`` (and so ``PipelineMuse.from_pretrained``) read."""
    model.save_config(path)
    torch.save(state_dict, os.path.join(path, WEIGHTS_NAMES[1]))


def _whole(v):
    """A DTensor gathered whole: on a 1-D mesh of even shards (tensor-parallel
    weights) by a list all-gather, which gloo also takes for CUDA tensors;
    otherwise by ``full_tensor``."""
    from torch.distributed.tensor import DTensor

    if not isinstance(v, DTensor):
        return v
    mesh, (placement,) = v.device_mesh, v.placements[:1]
    if mesh.ndim != 1 or (placement.is_shard() and v.shape[placement.dim] % mesh.size()):
        return v.full_tensor()
    part = v.to_local().detach()
    if not placement.is_shard():
        return part
    parts = [torch.empty_like(part) for _ in range(mesh.size())]
    torch.distributed.all_gather(parts, part.contiguous(), group=mesh.get_group())
    return torch.cat(parts, dim=placement.dim)


def full_tensors(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Whole tensors of a state: DTensor shards gathered from every rank
    (a collective: every rank calls it)."""
    return {k: _whole(v) for k, v in tensors.items()}


def save_checkpoint(output_dir: str, state: TrainState,
                    checkpoints_total_limit: Optional[int] = None,
                    pretrained: bool = False, is_main: bool = True) -> str:
    """Write ``output_dir/checkpoint-{step}/``, first removing the oldest
    checkpoints beyond ``checkpoints_total_limit``.  ``pretrained``: the
    model's ``save_pretrained`` directory as ``unwrapped_model/`` (what the
    VQGAN trainer writes, as the JAX one does), which both packages'
    ``from_pretrained`` read.  An FSDP2-sharded state is saved by every
    rank's call (``is_main`` on rank 0 alone): the weights and EMA are
    gathered and rank 0 writes them, and each rank writes its optimizer
    shard."""
    path = os.path.join(output_dir, f"checkpoint-{state.step}")
    if is_sharded(state.model):
        weights = full_tensors(state.model.state_dict())
        shadow = full_tensors(state.ema.shadow) if state.ema is not None else None
        os.makedirs(path, exist_ok=True)
        torch.save({"step": state.step, "optimizer": state.optimizer.state_dict()},
                   os.path.join(path, f"training_state-rank{rank_and_world()[0]}.pt"))
        if not is_main:
            return path
    elif not is_main:
        return path
    else:
        weights, shadow = None, None
    os.makedirs(path, exist_ok=True)
    if checkpoints_total_limit is not None:
        existing = sorted((d for d in os.listdir(output_dir)
                           if d.startswith("checkpoint-") and d != os.path.basename(path)),
                          key=lambda d: int(d.split("-")[1]))
        while len(existing) >= checkpoints_total_limit:
            shutil.rmtree(os.path.join(output_dir, existing.pop(0)))
    if pretrained and weights is None:
        state.model.save_pretrained(os.path.join(path, "unwrapped_model"))
    else:
        _save_model(os.path.join(path, "unwrapped_model"), state.model,
                    weights if weights is not None else state.model.state_dict())
    if state.ema is not None:
        _save_model(os.path.join(path, "ema_model"), state.model,
                    shadow if shadow is not None else state.ema.shadow)
    if weights is None:
        torch.save({"step": state.step, "optimizer": state.optimizer.state_dict()},
                   os.path.join(path, _STATE_FILE))
    else:
        torch.save({"step": state.step}, os.path.join(path, _STATE_FILE))
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump({"global_step": state.step}, f)
    return path


def find_latest_checkpoint(output_dir: str) -> Optional[str]:
    # reference "latest" scan (train_muse.py:574-585)
    if not os.path.isdir(output_dir):
        return None
    dirs = [d for d in os.listdir(output_dir) if d.startswith("checkpoint-")]
    if not dirs:
        return None
    return os.path.join(output_dir, max(dirs, key=lambda d: int(d.split("-")[1])))


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore model, optimizer, EMA and step from ``path`` into ``state``
    (an FSDP2-sharded state: each rank its shards of the whole weights and
    EMA, and its own optimizer shard)."""
    device = next(state.model.parameters()).device

    def weights(sub):
        name = next(n for n in WEIGHTS_NAMES if os.path.isfile(os.path.join(path, sub, n)))
        return {k: v.to(device) for k, v in load_state_file(os.path.join(path, sub, name)).items()}

    if is_sharded(state.model):
        from torch.distributed.checkpoint.state_dict import (StateDictOptions,
                                                             set_model_state_dict)

        set_model_state_dict(state.model, weights("unwrapped_model"),
                             options=StateDictOptions(full_state_dict=True))
        if state.ema is not None:
            from torch.distributed.tensor import distribute_tensor

            shadow = weights("ema_model")
            for name, shard in state.ema.shadow.items():
                shard.copy_(distribute_tensor(shadow[name].to(shard.dtype), shard.device_mesh,
                                              shard.placements))
        saved = torch.load(os.path.join(path, f"training_state-rank{rank_and_world()[0]}.pt"),
                           map_location=device, weights_only=False)
        state.optimizer.load_state_dict(saved["optimizer"])
        state.step = int(saved["step"])
        return state
    state.model.load_state_dict(weights("unwrapped_model"))
    if state.ema is not None:
        state.ema.load_state_dict({"decay": state.ema.decay, "shadow": weights("ema_model")})
    saved = torch.load(os.path.join(path, _STATE_FILE), map_location=device, weights_only=True)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return state
