"""Multi-process runtime setup and sharded-input conventions (port of
allpathslg_tpu/parallel/multihost.py).

Every process runs the same program, calls `initialize()` once, owns 1/n
of the input files and holds its shards of the global mesh. All
cross-process data movement happens in the collectives of parallel/mesh
(the all_to_all kmer routing, psum spectra, all_gather boundary sums),
through torch.distributed.

The settings are the reference's three, under PyTorch's names:
MASTER_ADDR:MASTER_PORT (JAX_COORDINATOR_ADDRESS), WORLD_SIZE
(JAX_NUM_PROCESSES) and RANK (JAX_PROCESS_ID). The backend is an explicit
argument: `nccl` when every process has its own card; `gloo` otherwise
(two processes on one card: NCCL refuses two ranks on one GPU), and then
each exchange is staged through host memory (parallel/mesh._staging).

Input convention: files are assigned round-robin by index; each process's
batch is a contiguous block of the global batch, laid out over (process,
local shard).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch.distributed as dist

from allpathslg_tpu_torch.parallel import mesh as pmesh


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "gloo") -> None:
    """Bring up torch.distributed for a multi-process run.

    A no-op with one process. Arguments default from the environment
    (MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK), so launchers only
    export them. `backend`: "nccl" when each process has its own card,
    "gloo" otherwise (exchanges staged through host memory)."""
    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if num_processes <= 1 or coordinator is None:
        return
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def _rank_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(n_local: Optional[int] = None,
                device="cuda") -> pmesh.Mesh:
    """1-D mesh over the shards of every process: this process holds
    n_local of them (default: one a card) on `device`; the kmer table
    shards by hash over the mesh, read batches data-parallel over it."""
    rank, world = _rank_world()
    local = pmesh.make_mesh(n_local, device)
    backend = dist.get_backend() if world > 1 else None
    return pmesh.Mesh(local.devices, rank, world, backend)


def my_file_shard(paths: Sequence[str]) -> List[str]:
    """Round-robin assignment of input files to this process."""
    pid, n = _rank_world()
    return [p for i, p in enumerate(paths) if i % n == pid]


def host_batch_to_global(local_batch: np.ndarray, mesh: pmesh.Mesh):
    """A process-local batch (this process's contiguous rows of the global
    batch) as the local shards' blocks on their devices, which every
    parallel function takes in place of a global array."""
    local_batch = np.asarray(local_batch)
    m = mesh.n_local
    if local_batch.shape[0] % m:
        raise ValueError(f"{local_batch.shape[0]} local rows not divisible "
                         f"by {m} local shards")
    rows = local_batch.shape[0] // m
    return pmesh.local_blocks(
        mesh, [local_batch[s * rows:(s + 1) * rows] for s in range(m)])
