"""One rank of the port's two-process gloo run (spawned by test_torch_parallel.py).

Usage: python torch_parallel_worker.py <rank> <world> <port> <workdir>

The group is joined through the JAX package's variables
(``MUSE_COORDINATOR_ADDRESS`` / ``MUSE_NUM_PROCESSES`` / ``MUSE_PROCESS_ID``),
which ``parallel.mesh.initialize_distributed`` reads.  ``workdir/inputs.pt``
(written by the test) holds the tiny U-ViT's weights and config, the global
batch and each step's masking noise drawn for the global batch, the serving
noise and the tokenized prompts; ``workdir/pipe`` is the tiny pipeline.
Each stage's results go to ``workdir/rank<rank>.pt`` for the test to hold
against the single-process port and JAX:

- ``dp``: two dp=2 train steps, each rank on its rows; ``dp_acc`` the same
  under gradient accumulation 2 (one update);
- ``fsdp``: the same two steps with the model sharded by FSDP2 (dp=1,
  fsdp=2), the full parameters gathered after;
- ``eval_count``: ``all_reduce_min`` of a count that differs by rank;
- ``main``: ``train_muse.main`` on two pre-encoded shards (one a rank) with
  uneven eval shards, rank 0's checkpoint read back on every rank;
  ``main_fsdp`` the same with ``training.fsdp=2``, then a resumed step;
  ``raw_fsdp``: the raw-image branch with ``training.fsdp=2``, its sample
  and inpainting panels at step 2 (the sharded weights gathered on both
  ranks, rank 0 sampling);
- ``serve``: sharded ``compile_text2image`` at batch 2 and 3;
- ``tp`` (tensor-parallel weights, ``training.tp``; the whole batch on both
  ranks): two tp=2 steps each of the v2 U-ViT (AdamW, and ``8bit_adamw``)
  and of the v1 text model (dropout on the JAX step's masks, handed over
  whole), the whole weights and EMA gathered after; ``train_muse.main`` at
  ``training.tp=2`` for v2 (its checkpoint, then a resumed step) and v1.

Run with a world of 4 (``tests/test_torch_tensor_parallel.py``), it runs the
fsdp=2 x tp=2 stages alone: two v2 steps, and ``train_muse.main`` for v2
(pre-encoded and raw, with its panels) and v1 at ``training.fsdp=2
training.tp=2``; and two tp=4 steps of a v2 with 12 heads (3 a rank).
"""

import collections
import contextlib
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


class _Masks:
    """Dropout keep masks handed over in order (the JAX step's own)."""

    def __init__(self, masks):
        self.masks = list(masks)

    def __call__(self, shape, keep_prob, device):
        import torch

        keep = torch.from_numpy(self.masks.pop(0))
        assert tuple(keep.shape) == tuple(shape), (keep.shape, shape)
        return keep.to(device)


@contextlib.contextmanager
def _counted(module, name, calls):
    """``module.name`` counting its calls into ``calls[name]`` while open."""
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls[name] += 1
        return fn(*args, **kwargs)

    setattr(module, name, counted)
    try:
        yield
    finally:
        setattr(module, name, fn)


def tp_steps(case, mesh, optimizer_name="adamw"):
    """Two steps of ``case`` (a dict of the test's inputs) with the model
    sharded over ``mesh`` (None: one process), each rank on its batch
    share's rows: the metrics, and the whole weights and EMA after."""
    import torch

    from open_muse_tpu_torch.models.transformer_v1 import MaskGitTransformer
    from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2
    from open_muse_tpu_torch.ops.sampling import get_mask_schedule
    from open_muse_tpu_torch.parallel import mesh as M
    from open_muse_tpu_torch.parallel.sharding import shard_params
    from open_muse_tpu_torch.training import lr_schedules as tlr
    from open_muse_tpu_torch.training import trainer as T
    from open_muse_tpu_torch.training.ema import EMA
    from open_muse_tpu_torch.training.optimizers import get_optimizer

    from open_muse_tpu_torch.models import transformer_v2 as V2

    v1 = case["kind"] == "v1"
    cls = MaskGitTransformer if v1 else MaskGiTUViT_v2
    model = cls(cls.config_from_dict(case["config"]))
    model.load_state_dict(case["weights"])
    model.train()
    if mesh is not None:
        shard_params(model, mesh)
    optimizer = get_optimizer(optimizer_name, model,
                              tlr.get_scheduler("constant_with_warmup", 1e-3, 2),
                              weight_decay=0.01, max_grad_norm=1.0)
    state = T.TrainState(model=model, optimizer=optimizer, ema=EMA(model))
    dp = M.data_parallel(mesh, fsdp_applied=T.is_fsdp(model))
    schedule = get_mask_schedule("cosine")
    if v1:
        step = T.make_v1_text2image_train_step(
            schedule, case["mask_id"], codebook_size=case["codebook"], cond_dropout_prob=0.5,
            dropout=_Masks([m for masks in case["masks"] for m in masks]), data_parallel=dp)
    else:
        step = T.make_uvit_train_step(schedule, case["mask_id"], codebook_size=case["codebook"],
                                      data_parallel=dp, with_param_grad_norms=True)
    rows = M.local_batch_slice(case["batch"]["image_tokens"].shape[0], *M.batch_share(mesh))
    local = {k: v[rows] for k, v in case["batch"].items()}
    calls = collections.Counter()
    with _counted(V2, "attn_sublayer_self", calls), _counted(V2, "attn_sublayer_cross", calls):
        metrics = [{k: v.clone() for k, v in step(state, local, noise.rows(rows)).items()}
                   for noise in case["noise"]]
    layer = model.transformer_layers[0]
    out = {"metrics": metrics, "params": T.full_tensors(model.state_dict()),
           "ema": T.full_tensors(state.ema.shadow), "sharded": T.is_sharded(model),
           "sublayer_calls": dict(calls),
           "split": {"attention": layer.attention.tp is not None,
                     "ffn": getattr(layer.ffn, "tp", None) is not None}}
    if mesh is None:
        out["state"] = state
    return out


def tp_main(argv, resume_argv=None):
    """``train_muse.main`` on ``argv``: its step count, whether its model is
    sharded, and its whole weights; with ``resume_argv`` also the step a
    resumed run ends at."""
    from open_muse_tpu_torch.training import trainer as T
    from open_muse_tpu_torch.training.train_muse import main as train_main

    trained = train_main(argv)
    out = {"step": trained.step, "sharded": T.is_sharded(trained.model),
           "params": T.full_tensors(trained.model.state_dict())}
    if resume_argv is not None:
        out["resumed_step"] = train_main(resume_argv).step
    return out


def _step_state(inputs, model_cls, build_optimizer):
    from open_muse_tpu_torch.training import trainer as T
    from open_muse_tpu_torch.training.ema import EMA

    model = model_cls(model_cls.config_from_dict(inputs["config"]))
    model.load_state_dict(inputs["weights"])
    model.train()
    return model, lambda m: T.TrainState(model=m, optimizer=build_optimizer(m), ema=EMA(m))


def main():
    rank, world, port, workdir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    os.environ.update(MUSE_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                      MUSE_NUM_PROCESSES=str(world), MUSE_PROCESS_ID=str(rank))
    import torch
    import torch.distributed as dist

    from open_muse_tpu_torch.models.transformer_v2 import MaskGiTUViT_v2
    from open_muse_tpu_torch.ops.sampling import get_mask_schedule
    from open_muse_tpu_torch.parallel import mesh as M
    from open_muse_tpu_torch.parallel.sharding import shard_params
    from open_muse_tpu_torch.pipelines.pipeline_muse import PipelineMuse
    from open_muse_tpu_torch.training import lr_schedules as tlr
    from open_muse_tpu_torch.training import trainer as T
    from open_muse_tpu_torch.training.optimizers import get_optimizer

    assert M.initialize_distributed("cpu") is True
    assert dist.get_world_size() == world and dist.get_backend() == "gloo"
    if world == 4:  # fsdp = 2 x tp = 2
        inputs = torch.load(os.path.join(workdir, "inputs4.pt"), weights_only=False)
        mesh = M.create_mesh(dp=1, fsdp=2, tp=2, device="cpu")
        out = {"steps": tp_steps(inputs["v2"], mesh),
               "tp4": tp_steps(inputs["v2_tp4"], M.create_mesh(dp=1, tp=4, device="cpu")),
               **{run: tp_main(inputs[run]) for run in ("main_v2", "main_v1", "main_raw")}}
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        M.barrier()
        dist.destroy_process_group()
        print(f"worker {rank}: done", flush=True)
        return
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = {}
    rows = M.local_batch_slice(inputs["batch"]["image_tokens"].shape[0])
    local = {k: v[rows] for k, v in inputs["batch"].items()}

    def optimizer(m, accumulation_steps=1):
        return get_optimizer("adamw", m, tlr.get_scheduler("constant_with_warmup", 1e-3, 2),
                             weight_decay=0.01, max_grad_norm=1.0,
                             accumulation_steps=accumulation_steps)

    def run_steps(state, dp):
        step = T.make_uvit_train_step(get_mask_schedule("cosine"), inputs["mask_id"],
                                      codebook_size=inputs["codebook"], data_parallel=dp)
        return [{k: float(v) for k, v in step(state, local, noise.rows(rows)).items()}
                for noise in inputs["noise"]]

    # dp = 2: replicated weights, each rank its rows, gradients averaged
    mesh = M.create_mesh()
    dp = M.data_parallel(mesh)
    model, new_state = _step_state(inputs, MaskGiTUViT_v2, optimizer)
    state = new_state(model)
    out["dp"] = {"metrics": run_steps(state, dp),
                 "params": {k: v.clone() for k, v in model.state_dict().items()},
                 "ema": {k: v.clone() for k, v in state.ema.shadow.items()}}

    # dp = 2 under gradient accumulation 2: the mean reduced once, in the update
    model, new_state = _step_state(inputs, MaskGiTUViT_v2, lambda m: optimizer(m, 2))
    state = new_state(model)
    out["dp_acc"] = {"metrics": run_steps(state, dp),
                     "params": {k: v.clone() for k, v in model.state_dict().items()}}

    # fsdp = 2: FSDP2 shards, all-gathers before the forward, reduce-scatters
    from torch.distributed.checkpoint.state_dict import StateDictOptions, get_model_state_dict

    fsdp_mesh = M.create_mesh(dp=1, fsdp=2)
    model, new_state = _step_state(inputs, MaskGiTUViT_v2, optimizer)
    shard_params(model, fsdp_mesh)
    state = new_state(model)
    metrics = run_steps(state, M.data_parallel(fsdp_mesh, fsdp_applied=True))
    full = get_model_state_dict(model, options=StateDictOptions(full_state_dict=True))
    out["fsdp"] = {"metrics": metrics, "params": {k: v.clone() for k, v in full.items()}}

    out["eval_count"] = M.all_reduce_min(3 + 2 * rank, "cpu")

    # train_muse.main: its own init (the group exists), data split, eval, checkpoint
    from open_muse_tpu_torch.training.train_muse import main as train_main

    argv = inputs["main_argv"]
    trained = train_main(argv + ["device=cpu"])
    saved = MaskGiTUViT_v2.from_pretrained(
        os.path.join(inputs["main_out"], "checkpoint-2", "unwrapped_model"), device="cpu")
    out["main"] = {
        "step": trained.step, "lr": trained.optimizer.schedule(10 ** 6),
        "reloads": all(torch.equal(a, b) for a, b in zip(saved.state_dict().values(),
                                                         trained.model.state_dict().values())),
        "params": {k: v.clone() for k, v in trained.model.state_dict().items()}}

    # the same with training.fsdp=2: FSDP2 shards, gathered checkpoint, per-rank optimizer
    fsdp_out = inputs["main_out"] + "_fsdp"
    fsdp_argv = [a.replace(inputs["main_out"], fsdp_out) for a in argv] + ["training.fsdp=2"]
    trained = train_main(fsdp_argv + ["device=cpu"])
    saved = MaskGiTUViT_v2.from_pretrained(
        os.path.join(fsdp_out, "checkpoint-2", "unwrapped_model"), device="cpu")
    full = T.full_tensors(trained.model.state_dict())
    out["main_fsdp"] = {
        "step": trained.step, "sharded": T.is_sharded(trained.model),
        "reloads": all(torch.equal(saved.state_dict()[k], v) for k, v in full.items()),
        "params": full}
    resumed = train_main([a for a in fsdp_argv if not a.startswith((
        "training.max_train_steps", "experiment.resume"))]
        + ["training.max_train_steps=3", "experiment.resume_from_checkpoint=latest",
           "device=cpu"])
    out["main_fsdp"]["resumed_step"] = resumed.step

    # the raw-image branch with training.fsdp=2: the panels gather the shards
    raw = train_main(inputs["raw_argv"])
    out["raw_fsdp"] = {"step": raw.step, "sharded": T.is_sharded(raw.model)}

    # sharded serving: every rank holds the pipeline and returns the whole batch
    pipe = PipelineMuse.from_pretrained(os.path.join(workdir, "pipe"), device="cpu")
    out["serve"] = {}
    for batch, (ids, micro, noise) in inputs["serve"].items():
        fn = pipe.compile_text2image(batch_size=batch, timesteps=3, guidance_scale=2.0,
                                     mesh=mesh)
        images, tokens = fn(ids, micro, noise, return_tokens=True)
        out["serve"][batch] = {"images": images, "tokens": tokens}

    # tp = 2: tensor-parallel weights, the batch whole on both ranks
    tp_mesh = M.create_mesh(dp=1, tp=2, device="cpu")
    tp = inputs["tp"]
    out["tp"] = {"v2": tp_steps(tp["v2"], tp_mesh), "v1": tp_steps(tp["v1"], tp_mesh),
                 "v2_8bit": tp_steps(tp["v2"], tp_mesh, "8bit_adamw"),
                 "main_v2": tp_main(tp["main_v2"], tp["main_v2_resume"]),
                 "main_v1": tp_main(tp["main_v1"])}

    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    M.barrier()
    dist.destroy_process_group()
    print(f"worker {rank}: done", flush=True)


if __name__ == "__main__":
    main()
