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
- ``serve``: sharded ``compile_text2image`` at batch 2 and 3.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


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

    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    M.barrier()
    dist.destroy_process_group()
    print(f"worker {rank}: done", flush=True)


if __name__ == "__main__":
    main()
