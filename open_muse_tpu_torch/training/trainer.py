"""The train steps (MaskGiTUViT_v2, v1 text -> image, class-conditional
MaskGIT), the v2 eval step, and checkpoints.

Counterpart of ``open_muse_tpu/training/trainer.py`` (``make_uvit_train_step``,
``make_v1_text2image_train_step``, ``make_maskgit_train_step``,
``make_uvit_eval_step``, ``grad_norm_param_names``, ``save_checkpoint``,
``find_latest_checkpoint``, ``load_checkpoint``).  The JAX step is one
jitted, donated program a step; here a step updates the model, optimizer and
EMA of a ``TrainState`` in place and returns its metrics as device tensors,
and on the card it is one replayed CUDA graph (``TrainStep`` around each
step's body).  Masking and cond-dropout noise come in as an argument
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
from ..core.modeling import WEIGHTS_NAMES
from ..utils import training_utils as tu
from .ema import EMA
from .masking import (MaskingNoise, cond_keep_mask, mask_or_random_replace_tokens,
                      prepend_class_token)
from .optimizers import Optimizer, flax_param_name, global_norm

__all__ = ["TrainState", "StepSpec", "TrainStep", "uvit_train_body", "v1_text2image_train_body",
           "maskgit_train_body", "make_uvit_train_step", "make_v1_text2image_train_step",
           "make_maskgit_train_step", "make_uvit_eval_step", "grad_norm_param_names",
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


def _flax_leaves(model: nn.Module):
    """(index in ``model.parameters()``, the JAX package's name) of every
    parameter, in the JAX ``tree_leaves`` order."""
    names = [flax_param_name(model, n) for n, _ in model.named_parameters()]
    return sorted(enumerate(names), key=lambda item: item[1].split("."))


def grad_norm_param_names(model: nn.Module) -> List[str]:
    """The JAX package's names of the model's parameters in its
    ``tree_leaves`` order, the order of ``metrics['param_grad_norms']``."""
    return [name for _, name in _flax_leaves(model)]


def _autocast(spec: StepSpec, device: torch.device):
    # no autocast cache: a capture must not keep casts of the weights made
    # before the optimizer's update
    return torch.autocast(device.type, dtype=spec.autocast_dtype or torch.bfloat16,
                          enabled=spec.autocast_dtype is not None, cache_enabled=False)


def _backward(state: TrainState, loss):
    """The backward of ``loss`` into fresh ``.grad``s -> (grads in
    ``model.parameters()`` order, their global norm)."""
    state.optimizer.zero_grad()
    loss.backward()
    for p in state.model.parameters():
        if p.grad is None:  # a parameter the loss does not reach: JAX's grad is 0
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in state.model.parameters()]
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
    the forward with the loss under autocast, the backward, the global grad
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
    with _autocast(spec, ehs.device):
        logits, loss = model(input_ids, ehs, cond, batch["micro_conds"], labels=labels,
                             loss_weight=loss_weight, label_smoothing=spec.label_smoothing)
    grads, grad_norm = _backward(state, loss)
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
    with _autocast(spec, ehs.device):
        _, loss = state.model(input_ids, ehs, labels=labels, label_smoothing=spec.label_smoothing,
                              cond_dropout_mask=cond_mask, dropout=spec.dropout)
    _, grad_norm = _backward(state, loss)
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
    with _autocast(spec, input_ids.device):
        _, loss = state.model(input_ids, labels=labels, label_smoothing=spec.label_smoothing,
                              dropout=spec.dropout)
    _, grad_norm = _backward(state, loss)
    state.optimizer.update(grad_norm, emit)
    return {"loss": loss.detach(), "grad_norm": grad_norm, "avg_masking_rate": mask_prob.mean()}


def _flat_inputs(batch, noise):
    """(names, tensors) of a batch and its noise, in a fixed order."""
    names, tensors = [], []
    for k in sorted(batch):
        names.append(("batch", k))
        tensors.append(batch[k])
    for f in dataclasses.fields(noise):
        value = getattr(noise, f.name)
        if value is not None:
            names.append(("noise", f.name))
            tensors.append(value)
    return tuple(names), tensors


def _unflat_inputs(names, tensors):
    batch, noise = {}, {}
    for (kind, k), t in zip(names, tensors):
        (batch if kind == "batch" else noise)[k] = t
    return batch, MaskingNoise(**noise)


@dataclasses.dataclass
class _StepGraph:
    graph: torch.cuda.CUDAGraph
    inputs: List[torch.Tensor]
    outputs: Dict[str, torch.Tensor]
    launches: Dict[str, int]


class TrainStep:
    """``step(state, batch, noise) -> metrics``: the host's part of a step
    (the lr at the update count, the EMA decay at ``state.step``, whether
    this call emits an update under gradient accumulation, the counters)
    around ``body(state, spec, batch, noise, emit)`` (``uvit_train_body``,
    ``v1_text2image_train_body``, ``maskgit_train_body``).

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

    def __call__(self, state: TrainState, batch, noise: MaskingNoise):
        return self._run(state, batch, noise, graph=True)

    def eager(self, state: TrainState, batch, noise: MaskingNoise):
        return self._run(state, batch, noise, graph=False)

    def _run(self, state, batch, noise, graph: bool):
        emit = state.optimizer.begin_step()
        if state.ema is not None:
            state.ema.set_step(state.step)
        names, tensors = _flat_inputs(batch, noise)
        if not graph or all(t.device.type == "cpu" for t in tensors):
            metrics = self.body(state, self.spec, batch, noise, emit)
        else:
            metrics = self._replay(state, names, tensors, emit)
        state.optimizer.end_step(emit)
        state.step += 1
        return metrics

    def _key(self, state, names, tensors, emit):
        held = [*state.model.parameters(), *state.optimizer.accumulators()]
        if state.ema is not None:
            held += [*state.ema.shadow.values(), state.ema.step_decay]
        if emit:
            held += state.optimizer.state_tensors()
        return (names, tuple((tuple(t.shape), t.dtype, t.device) for t in tensors),
                pointer_key(held))

    def _replay(self, state, names, tensors, emit):
        key = self._key(state, names, tensors, emit)
        cached = self._graphs.get(emit)
        if cached is not None and cached[0] == key:
            entry = cached[1]
            for static, t in zip(entry.inputs, tensors):
                static.copy_(t)
            replay(entry.graph, entry.launches)
            return {k: v.clone() for k, v in entry.outputs.items()}
        self._graphs.pop(emit, None)  # stale pointers: drop the old graph first
        metrics, entry = self._warm_up_and_capture(state, names, tensors, emit)
        self._graphs[emit] = (self._key(state, names, tensors, emit), entry)
        return metrics

    def _warm_up_and_capture(self, state, names, tensors, emit):
        t0 = time.perf_counter()
        inputs = [t.clone(memory_format=torch.contiguous_format) for t in tensors]
        body = lambda: self.body(state, self.spec, *_unflat_inputs(names, inputs),  # noqa: E731
                                 emit)
        stream = torch.cuda.Stream(device=inputs[0].device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):  # the real step: it launches, and counts
            metrics = {k: v.clone() for k, v in body().items()}
        warm = time.perf_counter() - t0
        generator = getattr(self.spec.dropout, "generator", None)
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
    and then updates the EMA, and increments ``state.step``."""
    return TrainStep(uvit_train_body, StepSpec(
        mask_schedule, mask_id, codebook_size, min_masking_rate, noise_type, predict_all_tokens,
        mask_contiguous_region_prob, label_smoothing, cond_dropout_prob, autocast_dtype,
        with_diagnostics, with_param_grad_norms))


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


def _save_model(path: str, config, state_dict) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(config), f, indent=2)
    torch.save(state_dict, os.path.join(path, WEIGHTS_NAMES[1]))


def save_checkpoint(output_dir: str, state: TrainState,
                    checkpoints_total_limit: Optional[int] = None) -> str:
    """Write ``output_dir/checkpoint-{step}/``, first removing the oldest
    checkpoints beyond ``checkpoints_total_limit``."""
    path = os.path.join(output_dir, f"checkpoint-{state.step}")
    os.makedirs(path, exist_ok=True)
    if checkpoints_total_limit is not None:
        existing = sorted((d for d in os.listdir(output_dir)
                           if d.startswith("checkpoint-") and d != os.path.basename(path)),
                          key=lambda d: int(d.split("-")[1]))
        while len(existing) >= checkpoints_total_limit:
            shutil.rmtree(os.path.join(output_dir, existing.pop(0)))
    config = state.model.config
    _save_model(os.path.join(path, "unwrapped_model"), config, state.model.state_dict())
    if state.ema is not None:
        _save_model(os.path.join(path, "ema_model"), config, state.ema.shadow)
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
        return torch.load(os.path.join(path, sub, WEIGHTS_NAMES[1]), map_location=device,
                          weights_only=True)

    state.model.load_state_dict(weights("unwrapped_model"))
    if state.ema is not None:
        state.ema.load_state_dict({"decay": state.ema.decay, "shadow": weights("ema_model")})
    saved = torch.load(os.path.join(path, _STATE_FILE), map_location=device, weights_only=True)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return state
