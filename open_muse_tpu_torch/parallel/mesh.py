"""Process groups, the device mesh, and the data-parallel reductions.

Counterpart of ``open_muse_tpu/parallel/mesh.py``.  The JAX package builds a
``('dp', 'fsdp', 'tp')`` ``jax.sharding.Mesh`` and lets GSPMD insert the
collectives; here the mesh is a ``torch.distributed`` ``DeviceMesh`` with the
same dims, one rank a device, and the collectives are written out:

- ``initialize_distributed`` joins the ranks (torchrun's environment, or the
  JAX package's ``MUSE_*`` variables);
- ``create_mesh`` builds the mesh, with ``mesh.py:29-42``'s defaults and
  errors;
- the batch is split over the dp x fsdp coordinates (``batch_share``,
  ``local_batch_slice``): each rank loads and runs its rows, as each JAX
  host contributes its slice of the global array; the ranks of one tp group
  (``tensor_parallel``) take the same rows;
- ``data_parallel(mesh)`` gives the reductions that make a rank's step
  compute the global batch's (``DataParallel``): a trainer hands them to
  its steps, and nothing else reads them.  ``SINGLE``, the single process's,
  communicates nothing.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["MeshAxes", "REPLICATED_BATCH_KEYS", "create_mesh", "initialize_distributed",
           "local_batch_slice", "batch_share", "put_batch", "rank_and_world", "init_training",
           "DataParallel", "SINGLE", "data_parallel", "collectives", "all_gather_rows",
           "barrier", "all_reduce_min"]

MeshAxes = ("dp", "fsdp", "tp")

# dict keys that carry broadcast tensors (one row shared by the whole batch)
# rather than per-sample rows: they stay whole on every rank
REPLICATED_BATCH_KEYS = frozenset({"empty_embeds", "empty_cond_embeds"})

_LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _init(device: torch.device, rank: int, world: int, **kwargs) -> None:
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % max(1, torch.cuda.device_count())))
        torch.cuda.set_device(local)
        # bound to its device, the group builds NCCL's communicator now, not
        # inside the first captured collective
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(_backend(device), rank=rank, world_size=world, **kwargs)


def initialize_distributed(device="cuda", coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Join this process to the job's ranks (``init_process_group``); True
    when a group exists afterwards.

    The rank and world size come from the arguments, else from a launcher's
    environment (``torch.distributed.run``: ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` / ``MASTER_PORT``, ``LOCAL_RANK``), else from the JAX
    package's ``MUSE_COORDINATOR_ADDRESS`` (host:port) / ``MUSE_NUM_PROCESSES``
    / ``MUSE_PROCESS_ID``.  NCCL on the card, gloo when ``device`` is the CPU;
    on the card each rank takes the device of its ``LOCAL_RANK``.  A process
    started without a launcher and with no ``MUSE_NUM_PROCESSES`` above 1 is
    a single process: nothing is done.  A launcher's world of one is joined
    too (rank 0 of 1), so that its steps run the collectives they would run
    on more ranks."""
    if dist.is_initialized():
        return True
    env = os.environ
    device = torch.device(device)
    if num_processes is None and all(k in env for k in _LAUNCHER_VARS):
        _init(device, int(env["RANK"]), int(env["WORLD_SIZE"]), init_method="env://")
        return True
    world = int(num_processes if num_processes is not None
                else env.get("MUSE_NUM_PROCESSES", "1"))
    if world <= 1:
        return False
    address = coordinator_address or env.get("MUSE_COORDINATOR_ADDRESS")
    rank = process_id if process_id is not None else env.get("MUSE_PROCESS_ID")
    if address is None or rank is None:
        raise ValueError(f"{world} processes need a coordinator address and a process id "
                         f"(MUSE_COORDINATOR_ADDRESS / MUSE_PROCESS_ID)")
    _init(device, int(rank), world, init_method=f"tcp://{address}")
    return True


def create_mesh(dp: Optional[int] = None, fsdp: int = 1, tp: int = 1, device=None):
    """A ``DeviceMesh`` of dims ``('dp', 'fsdp', 'tp')`` over the group's
    ranks; dp defaults to all the ranks fsdp and tp leave.  A process with no
    group gets a group of one first (NCCL on the card, gloo when ``device``
    is the CPU), so that one code path serves every world size.  The mesh's
    device type is ``device``'s where given (a gloo group may carry CUDA
    tensors), else the group's backend's."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        device = torch.device(device if device is not None else "cuda")
        _init(device, 0, 1, store=dist.HashStore())
    n = dist.get_world_size()
    if dp is None:
        if n % (fsdp * tp) != 0:
            raise ValueError(f"{n} devices not divisible by fsdp*tp={fsdp * tp}")
        dp = n // (fsdp * tp)
    if dp * fsdp * tp != n:
        raise ValueError(f"dp*fsdp*tp={dp * fsdp * tp} != {n} devices")
    device_type = torch.device(device).type if device is not None else (
        "cuda" if dist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(device_type, (dp, fsdp, tp), mesh_dim_names=MeshAxes)


def rank_and_world(group=None):
    """(rank, world size) in ``group`` (the default group); (0, 1) without
    a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def batch_share(mesh=None):
    """(this rank's index, the count) of the batch split: its dp x fsdp
    coordinate on ``mesh`` (the ranks of one tp group share their rows), or
    (rank, world size) without a mesh."""
    if mesh is None:
        return rank_and_world()
    dp, fsdp, _ = mesh.get_coordinate()
    return dp * mesh.size(1) + fsdp, mesh.size(0) * mesh.size(1)


def local_batch_slice(global_batch: int, process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> slice:
    """This rank's slice of the global batch (accelerate's split_batches:
    the global batch stays fixed whatever the rank count); the split is
    over every rank unless given (``batch_share`` under tp)."""
    rank, world = rank_and_world()
    process_index = rank if process_index is None else process_index
    process_count = world if process_count is None else process_count
    per_host = global_batch // process_count
    return slice(process_index * per_host, (process_index + 1) * per_host)


def put_batch(batch: dict, device, replicated_keys=REPLICATED_BATCH_KEYS) -> dict:
    """This rank's share of a host batch, on ``device``: every entry is
    already the rank's rows (the caller loaded its ``local_batch_slice``),
    so each array or tensor moves to the device as it is; lists of strings
    stay on the host.  Entries named in ``replicated_keys`` and 0-d values
    are the whole value on every rank, as the JAX package replicates
    them."""
    device = torch.device(device)

    def place(v):
        if isinstance(v, (list, tuple)) and v and isinstance(v[0], str):
            return v
        t = torch.as_tensor(v)
        return t.to(device, non_blocking=device.type == "cuda" and t.is_pinned())

    out = {k: place(v) for k, v in batch.items()}
    for k in replicated_keys:  # broadcast rows: never split, never gathered
        if k in out and isinstance(out[k], torch.Tensor) and out[k].dim() and \
                out[k].shape[0] != 1:
            raise ValueError(f"{k} is one row shared by the batch, got {tuple(out[k].shape)}")
    return out


def init_training(device, batch_size: int, fsdp: int = 1, tp: int = 1):
    """A trainer's start: ``initialize_distributed(device)`` and, in a group,
    the mesh of ``fsdp`` / ``tp`` (``training.fsdp`` / ``training.tp``) with
    the global ``batch_size`` split over dp x fsdp, which must divide it.
    Returns the mesh (``data_parallel(mesh)`` gives its steps'
    reductions), or None for a single process."""
    if not initialize_distributed(device):
        if fsdp * tp != 1:
            raise ValueError(f"training.fsdp={fsdp} / training.tp={tp} need {fsdp * tp} ranks; "
                             f"this is a single process")
        return None
    mesh = create_mesh(fsdp=fsdp, tp=tp, device=device)
    shards = mesh.size(0) * mesh.size(1)
    if batch_size % shards:
        raise ValueError(f"training.batch_size={batch_size} must be divisible by "
                         f"dp*fsdp={shards} (global batch is sharded over those mesh axes)")
    return mesh


# -- the data-parallel reductions of a train step ------------------------------

# the train steps' all-reduces: those issued, and those issued while their
# stream was being captured into a CUDA graph (recorded in it, so every
# replay runs them; a replay issues nothing from Python)
collectives = {"issued": 0, "captured": 0}


def _count(t: torch.Tensor) -> None:
    collectives["issued"] += 1
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        collectives["captured"] += 1


def _avg_op(group):
    """(the reduce op, whether to divide after): NCCL averages in the
    reduction itself, gloo sums and the caller divides."""
    if dist.get_backend(group) == "nccl":
        return dist.ReduceOp.AVG, False
    return dist.ReduceOp.SUM, True


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """The reductions that make a rank's train step compute the global
    batch's, passed to the step explicitly (``StepSpec.data_parallel``):
    the losses' denominators are summed over the ranks (``ratio``), the
    gradients averaged (``reduce_gradients_``) and the metrics too
    (``mean``), each on the stream it is issued on, so a captured train step
    holds them.  ``SINGLE`` (no group) is a single process: none of them
    communicates, and each is the identity."""

    batch_group: object = None  # the ranks the batch is split over (dp x fsdp)
    grad_group: object = None  # the ranks whose gradients this code averages
    rank: int = 0  # this rank's index in batch_group
    world: int = 1  # batch_group's size

    @property
    def share(self):
        """(this rank's index, the rank count) of the batch split."""
        return self.rank, self.world

    def ratio(self, total, count, min_count=None):
        """``total / count`` of the global batch, as this rank's term:
        ``total`` (this rank's part, differentiable) over ``count`` summed
        over the ranks (no gradient) and divided by the rank count, so that
        the ranks' mean (``mean``, and the averaged gradients) is the global
        batch's ratio; alone, the ratio itself.  ``min_count`` clamps the
        global count from below."""
        if self.batch_group is None:
            return total / (count if min_count is None else count.clamp(min=min_count))
        count = count.detach().float().reshape(1).clone()
        dist.all_reduce(count, group=self.batch_group)
        _count(count)
        if min_count is not None:
            count = count.clamp(min=min_count)
        return total / (count[0] / self.world)

    def mean(self, *tensors):
        """Each tensor (a metric) averaged over the ranks, in one all-reduce;
        the tensors themselves alone."""
        if self.batch_group is None:
            return tensors if len(tensors) != 1 else tensors[0]
        flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
        op, divide = _avg_op(self.batch_group)
        dist.all_reduce(flat, op=op, group=self.batch_group)
        _count(flat)
        if divide:
            flat.div_(dist.get_world_size(self.batch_group))
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
            at += t.numel()
        return tuple(out) if len(out) != 1 else out[0]

    def reduce_gradients_(self, grads) -> None:
        """Average ``grads`` over the ranks in place (a DTensor's local
        shard): one coalesced all-reduce of the tensors of each dtype, with
        no staging copy; nothing alone."""
        if self.grad_group is None or not grads:
            return
        local = [getattr(g, "_local_tensor", g) for g in grads]
        op, divide = _avg_op(self.grad_group)
        for dtype in dict.fromkeys(t.dtype for t in local):  # the same order on every rank
            part = [t for t in local if t.dtype == dtype]
            with dist._coalescing_manager(group=self.grad_group):
                for t in part:
                    dist.all_reduce(t, op=op, group=self.grad_group)
            _count(part[0])
            if divide:
                torch._foreach_div_(part, dist.get_world_size(self.grad_group))


SINGLE = DataParallel()


def data_parallel(mesh=None, fsdp_applied: bool = False) -> DataParallel:
    """The train steps' reductions over ``mesh`` (None: ``SINGLE``).  The
    batch is split over dp x fsdp (``batch_share``); the gradients are
    averaged over those ranks, or with ``fsdp_applied`` (the model sharded
    by ``sharding.shard_params``: FSDP2 reduces its gradients over fsdp)
    over dp alone.  Under tp each group of ranks that share a tp coordinate
    reduces apart (trap 5 of the tensor-parallel port: a tp shard's gradient
    is averaged with the same shard's on the other batch ranks); a mesh
    whose dp x fsdp is 1 (tp alone) reduces nothing: ``SINGLE``'s
    reductions with the mesh's one batch share."""
    if mesh is None:
        return SINGLE
    rank, world = batch_share(mesh)
    if mesh.size(MeshAxes.index("tp")) == 1:
        batch_group = dist.group.WORLD
    elif world == 1:
        return SINGLE
    else:
        batch_group = mesh["dp", "fsdp"]._flatten("dp_fsdp").get_group()
    grad_group = mesh.get_group("dp") if fsdp_applied else batch_group
    return DataParallel(batch_group, grad_group, rank, world)


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0 in rank
    order, on every rank."""
    _, world = rank_and_world(group)
    if world == 1:
        return t
    out = torch.empty((world * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def all_reduce_min(value: int, device) -> int:
    """The smallest of every rank's ``value`` (the ranks agree on a count
    before any collective that count drives); ``value`` itself alone."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)  # outside any step: not counted
    return int(t.item())


def barrier() -> None:
    """Wait for every rank (nothing without a group)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
