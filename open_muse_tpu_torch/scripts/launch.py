"""Multi-GPU launcher: runs a trainer (or any of the port's ``python -m``
entry points) under ``torch.distributed.run``.

Counterpart of the JAX package's ``tpu_scripts/launch_pod.sh``,
``pre_encode_pod.sh``, ``fid_pod.sh`` and ``benchmark_pod.sh``.  Those copy
the repo to every TPU host over gcloud and start one process a host; here
this script runs on each node, as torchrun does, and starts
``--nproc-per-node`` ranks (one a GPU) of ``--module`` with the config and
overrides.  One node rendezvouses on its own (``--standalone``); several
need ``--nnodes`` and a ``--rdzv-endpoint`` host:port that every node
reaches (c10d rendezvous).  The ranks read ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` from torchrun (``parallel.mesh.initialize_distributed``;
``scripts.pre_encode`` takes its ``--task-id`` / ``--num-tasks`` from them).

    python -m open_muse_tpu_torch.scripts.launch [--dry-run] [--nproc-per-node 8] \\
        [--nnodes 2 --rdzv-endpoint host0:29500] \\
        [--module open_muse_tpu_torch.training.train_muse] -- \\
        config=configs/research_run_512.yaml training.batch_size=512

Tensor-parallel weights take the trainer's own overrides: ``--nproc-per-node 2
-- config=configs/laiona6plus_uvit_clip.yaml training.tp=2`` splits every
rank pair's heads and GLU columns (``training.fsdp=2 training.tp=2`` on four
ranks adds FSDP2 on top); with ``device=cpu`` the ranks join under gloo.

``--dry-run`` prints the command (``DRY-RUN: ...``) and runs nothing.
The ranks inherit the launcher's environment, so a ``TORCH_NCCL_*`` or
``NCCL_*`` setting goes before the command on each node, e.g.
``TORCH_NCCL_ASYNC_ERROR_HANDLING=1 python -m open_muse_tpu_torch.scripts.launch
...``; the library sets none of them.
"""

from __future__ import annotations

import argparse
import shlex
import subprocess
import sys
from typing import List, Optional

__all__ = ["build_command", "main"]

DEFAULT_MODULE = "open_muse_tpu_torch.training.train_muse"


def build_command(args: List[str], *, module: str = DEFAULT_MODULE, nproc_per_node: int = 1,
                  nnodes: int = 1, rdzv_endpoint: Optional[str] = None) -> List[str]:
    """The ``python -m torch.distributed.run`` command for ``module`` and its
    ``args``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", str(nnodes),
           "--nproc_per_node", str(nproc_per_node)]
    if nnodes == 1 and rdzv_endpoint is None:
        cmd.append("--standalone")
    else:
        if rdzv_endpoint is None:
            raise ValueError(f"{nnodes} nodes need --rdzv-endpoint host:port")
        cmd += ["--rdzv_backend", "c10d", "--rdzv_endpoint", rdzv_endpoint, "--rdzv_id", "muse"]
    return cmd + ["--module", module, *args]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--module", default=DEFAULT_MODULE,
                        help=f"the entry point the ranks run (default {DEFAULT_MODULE})")
    parser.add_argument("--nproc-per-node", type=int, default=1, help="ranks on this node")
    parser.add_argument("--nnodes", type=int, default=1)
    parser.add_argument("--rdzv-endpoint", help="host:port every node reaches (several nodes)")
    parser.add_argument("--dry-run", action="store_true", help="print the command only")
    parser.add_argument("args", nargs=argparse.REMAINDER,
                        help="the module's arguments (config=... overrides), after --")
    args = parser.parse_args(argv)
    rest = args.args[1:] if args.args[:1] == ["--"] else args.args
    cmd = build_command(rest, module=args.module, nproc_per_node=args.nproc_per_node,
                        nnodes=args.nnodes, rdzv_endpoint=args.rdzv_endpoint)
    line = " ".join(shlex.quote(c) for c in cmd)
    if args.dry_run:
        print(f"DRY-RUN: {line}")
        return 0
    print(f">> {line}", flush=True)
    return subprocess.run(cmd).returncode


if __name__ == "__main__":
    sys.exit(main())
