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

A checkpoint is ``checkpoint-{step}/`` with ``metadata.json``,
``unwrapped_model/`` and ``ema_model/`` (``config.json`` + ``pytorch_model.bin``)
and ``training_state.pt`` (step, optimizer).  The JAX package's Orbax
checkpoints are not read.
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
from ..ops.losses import soft_target_cross_entropy
from ..utils import training_utils as tu
from .ema import EMA
from .masking import (MaskingNoise, cond_keep_mask, mask_or_random_replace_tokens,
                      prepend_class_token)
from .optimizers import Optimizer, flax_param_name, global_norm

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

    def step_inputs(self, step: int, device) -> Dict[str, torch.Tensor]:
        """``disc_factor``: 1 from the generator's update ``disc_start`` on,
        else 0 (taming's ``adopt_weight``), a 0-d device input, since a graph
        freezes host values."""
        if self.disc_weight <= 0.0:
            return {}
        return {"disc_factor": torch.full((), float(step >= self.disc_start), device=device)}


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


def backward(state: TrainState, loss):
    """The backward of ``loss`` into fresh ``.grad``s -> (grads in
    ``model.parameters()`` order, their global norm)."""
    state.optimizer.zero_grad()
    loss.backward()
    for p in state.model.parameters():
        if p.grad is None:  # a parameter the loss does not reach: JAX's grad is 0
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in state.model.parameters()]
    return grads, global_norm(grads)


def _grads(state: TrainState, loss):
    """``torch.autograd.grad`` of ``loss`` over the state's model alone, set
    as its parameters' ``.grad`` -> (grads, their global norm); a parameter
    the loss does not reach gets 0, as JAX's grad."""
    params = list(state.model.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
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
    model = state.model
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
        if spec.use_soft_targets:  # neither loss_weight nor label_smoothing, as in JAX
            logits = model(input_ids, ehs, cond, batch["micro_conds"])
            loss = soft_target_cross_entropy(logits, labels, batch["soft_targets"],
                                             drop_first=False)
        else:
            logits, loss = model(input_ids, ehs, cond, batch["micro_conds"], labels=labels,
                                 loss_weight=loss_weight, label_smoothing=spec.label_smoothing)
    grads, grad_norm = backward(state, loss)
    metrics = {"loss": loss.detach(), "grad_norm": grad_norm,
               "avg_masking_rate": mask_prob.mean()}
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
        metrics["param_grad_norms"] = torch.stack(
            torch._foreach_norm([grads[i].float() for i, _ in _flax_leaves(model)]))
    state.optimizer.update(grad_norm, emit)
    if state.ema is not None:
        state.ema.update(model)
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
    with autocast(spec, ehs.device):
        _, loss = state.model(input_ids, ehs, labels=labels, label_smoothing=spec.label_smoothing,
                              cond_dropout_mask=cond_mask, dropout=spec.dropout)
    _, grad_norm = backward(state, loss)
    state.optimizer.update(grad_norm, emit)
    if state.ema is not None:
        state.ema.update(state.model)
    return {"loss": loss.detach(), "grad_norm": grad_norm, "avg_masking_rate": mask_prob.mean()}


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
    with autocast(spec, input_ids.device):
        _, loss = state.model(input_ids, labels=labels, label_smoothing=spec.label_smoothing,
                              dropout=spec.dropout)
    _, grad_norm = backward(state, loss)
    state.optimizer.update(grad_norm, emit)
    return {"loss": loss.detach(), "grad_norm": grad_norm, "avg_masking_rate": mask_prob.mean()}


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
    gen = states[0]
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
        d_weight = adaptive_disc_weight(rec_grad, gan_grad, spec.disc_weight) * disc_factor
        loss = loss + d_weight * g_loss
        metrics.update(g_loss=g_loss.detach(), d_weight=d_weight)
    _, grad_norm = _grads(gen, loss)
    gen.optimizer.update(grad_norm, emit)
    metrics.update(loss=loss.detach(), grad_norm=grad_norm)
    if len(states) > 1:
        d_loss_fn = hinge_d_loss if spec.disc_loss == "hinge" else vanilla_d_loss
        logits_real, logits_fake = disc(target), disc(recon.detach())
        d_loss = disc_factor * d_loss_fn(logits_real, logits_fake)
        _, d_grad_norm = _grads(states[1], d_loss)
        states[1].optimizer.update(d_grad_norm, emit)
        metrics.update(d_loss=d_loss.detach(), logits_real=logits_real.detach().mean(),
                       logits_fake=logits_fake.detach().mean())
    return metrics


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
        if not graph or all(t.device.type == "cpu" for t in tensors):
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
                pointer_key(held))

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
    over the masked positions."""
    return TrainStep(uvit_train_body, StepSpec(
        mask_schedule, mask_id, codebook_size, min_masking_rate, noise_type, predict_all_tokens,
        mask_contiguous_region_prob, label_smoothing, cond_dropout_prob, autocast_dtype,
        with_diagnostics, with_param_grad_norms, use_soft_targets=use_soft_targets))


def make_v1_text2image_train_step(mask_schedule, mask_id: int, *, codebook_size: int,
                                  min_masking_rate: float = 0.0, label_smoothing: float = 0.0,
                                  cond_dropout_prob: float = 0.0,
                                  autocast_dtype: Optional[torch.dtype] = None,
                                  dropout: Optional[Callable] = None) -> TrainStep:
    """The v1 ``MaskGitTransformer`` text -> image step (``model.architecture:
    transformer``), ``TrainStep`` around ``v1_text2image_train_body``.  An
    image keeps its text where ``noise.cond_dropout >= cond_dropout_prob``;
    ``dropout`` (``KeepMasks``) draws the model's ``hidden_dropout`` masks,
    None runs the forward deterministic.  The EMA moves where the state has
    one (the JAX trainer's ``ema_decay`` 0.9999 under ``use_ema``);
    clipping is the optimizer's (``max_grad_norm``)."""
    return TrainStep(v1_text2image_train_body, StepSpec(
        mask_schedule, mask_id, codebook_size, min_masking_rate, label_smoothing=label_smoothing,
        cond_dropout_prob=cond_dropout_prob, autocast_dtype=autocast_dtype, dropout=dropout))


def make_maskgit_train_step(mask_schedule, mask_id: int, *, codebook_size: int,
                            min_masking_rate: float = 0.0, label_smoothing: float = 0.0,
                            autocast_dtype: Optional[torch.dtype] = None,
                            dropout: Optional[Callable] = None) -> TrainStep:
    """The class-conditional MaskGIT step (``train_maskgit_imagenet``),
    ``TrainStep`` around ``maskgit_train_body``; batch: image_tokens (B, S),
    class_ids (B,); ``dropout`` as in ``make_v1_text2image_train_step``."""
    return TrainStep(maskgit_train_body, StepSpec(
        mask_schedule, mask_id, codebook_size, min_masking_rate, label_smoothing=label_smoothing,
        autocast_dtype=autocast_dtype, dropout=dropout))


def make_vqgan_train_step(*, l1_weight: float = 1.0, l2_weight: float = 1.0,
                          codebook_weight: float = 1.0, perceptual_weight: float = 0.0,
                          perceptual: Optional[Callable] = None, disc_weight: float = 0.0,
                          disc_start: int = 0, disc_loss: str = "hinge") -> TrainStep:
    """The VQGAN tokenizer's step, ``TrainStep`` around ``vqgan_train_body``:
    ``step((generator,), {"pixel_values": x})``, or with ``disc_weight`` > 0
    ``step((generator, discriminator), {"pixel_values": x})``, each player a
    ``TrainState`` with its own AdamW and no EMA; the step fills the batch's
    disc_factor from the generator's ``step`` and ``disc_start``."""
    if disc_loss not in ("hinge", "vanilla"):
        raise ValueError(f"disc_loss {disc_loss!r}: hinge or vanilla")
    return TrainStep(vqgan_train_body, VQGANSpec(
        l1_weight, l2_weight, codebook_weight, perceptual_weight,
        perceptual if perceptual_weight > 0.0 else None, disc_weight, disc_start, disc_loss))


def make_uvit_eval_step(mask_schedule, mask_id: int, *,
                        eval_mask_ratios=(0.1, 0.3, 0.5, 0.7, 0.9),
                        label_smoothing: float = 0.0,
                        autocast_dtype: Optional[torch.dtype] = None) -> Callable:
    """``eval_step(model, batch, noise) -> loss`` at fixed mask ratios
    (``noise.eval_index`` picks one per image); on the card one replayed
    CUDA graph (``core.captured``), as the JAX eval step is jitted."""
    ratios = tuple(eval_mask_ratios)

    @torch.no_grad()
    def body(model, image_tokens, ehs, cond, micro, permutation, eval_index, ratio_values):
        noise = MaskingNoise(None, permutation, None, None, None, eval_index)
        input_ids, labels, _, _ = mask_or_random_replace_tokens(
            image_tokens, mask_id, mask_schedule, noise, eval_mask_ratios=ratio_values,
            is_train=False)
        with torch.autocast(ehs.device.type, dtype=autocast_dtype or torch.bfloat16,
                            enabled=autocast_dtype is not None, cache_enabled=False):
            _, loss = model(input_ids, ehs, cond, micro, labels=labels,
                            label_smoothing=label_smoothing)
        return loss

    def eval_step(model, batch, noise: MaskingNoise):
        return captured(model, ("eval_step", ratios, label_smoothing, autocast_dtype),
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


def save_checkpoint(output_dir: str, state: TrainState,
                    checkpoints_total_limit: Optional[int] = None,
                    pretrained: bool = False) -> str:
    """Write ``output_dir/checkpoint-{step}/``, first removing the oldest
    checkpoints beyond ``checkpoints_total_limit``.  ``pretrained``: the
    model's ``save_pretrained`` directory as ``unwrapped_model/`` (what the
    VQGAN trainer writes, as the JAX one does), which both packages'
    ``from_pretrained`` read."""
    path = os.path.join(output_dir, f"checkpoint-{state.step}")
    os.makedirs(path, exist_ok=True)
    if checkpoints_total_limit is not None:
        existing = sorted((d for d in os.listdir(output_dir)
                           if d.startswith("checkpoint-") and d != os.path.basename(path)),
                          key=lambda d: int(d.split("-")[1]))
        while len(existing) >= checkpoints_total_limit:
            shutil.rmtree(os.path.join(output_dir, existing.pop(0)))
    if pretrained:
        state.model.save_pretrained(os.path.join(path, "unwrapped_model"))
    else:
        _save_model(os.path.join(path, "unwrapped_model"), state.model, state.model.state_dict())
    if state.ema is not None:
        _save_model(os.path.join(path, "ema_model"), state.model, state.ema.shadow)
    torch.save({"step": state.step, "optimizer": state.optimizer.state_dict()},
               os.path.join(path, _STATE_FILE))
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
    """Restore model, optimizer, EMA and step from ``path`` into ``state``."""
    device = next(state.model.parameters()).device

    def weights(sub):
        name = next(n for n in WEIGHTS_NAMES if os.path.isfile(os.path.join(path, sub, n)))
        return {k: v.to(device) for k, v in load_state_file(os.path.join(path, sub, name)).items()}

    state.model.load_state_dict(weights("unwrapped_model"))
    if state.ema is not None:
        state.ema.load_state_dict({"decay": state.ema.decay, "shadow": weights("ema_model")})
    saved = torch.load(os.path.join(path, _STATE_FILE), map_location=device, weights_only=True)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return state
