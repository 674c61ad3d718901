"""Device mesh for multi-device runs (port of allpathslg_tpu/parallel/mesh.py).

The reference builds a 1-D `jax.sharding.Mesh` over its chips (axis "x")
and runs per-shard bodies under `shard_map`. Here a `Mesh` is the ordered
list of this process's shards, each on an explicit torch device, plus the
process's rank and the world size when several processes share the mesh
(parallel/multihost.py). A `shard_map` body becomes a plain loop over the
local shards, and its collectives become the explicit functions below:

  * `all_to_all`: block j of shard i goes to shard j; each shard receives
    its blocks ordered by source shard, as
    `lax.all_to_all(x.reshape(n, cap), AXIS, 0, 0)` does;
  * `psum`: the sum over every shard;
  * `all_gather`: the stack over every shard, in shard order.

Across processes these run through torch.distributed: with `nccl` the
tensors stay on the card; with `gloo`, which takes CPU tensors only, each
exchange is staged through host memory by an explicit copy to the CPU and
back to the shard's device. Shards are placed on the card unless the
caller asks for the CPU; nothing falls back to the CPU when there is no
card. The artifacts are the same whatever the shards' placement.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXIS = "x"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The shards this process holds of a 1-D mesh of `size` shards.

    Local shard s is global shard `rank * n_local + s`. `backend` is the
    torch.distributed backend when world > 1 (None in one process)."""

    devices: Tuple[torch.device, ...]
    rank: int = 0
    world: int = 1
    backend: Optional[str] = None

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        return self.n_local * self.world

    @property
    def first(self) -> int:
        """Global index of this process's first shard."""
        return self.rank * self.n_local

    @property
    def home(self) -> torch.device:
        """Device of the first local shard: where replicated results and
        concatenations of the local shards are put."""
        return self.devices[0]

    @property
    def platform(self) -> str:
        return self.devices[0].type


def shard_devices(n: int, device="cuda") -> Tuple[torch.device, ...]:
    """Devices of n shards: every shard on the CPU for device "cpu"; for
    "cuda", shard i on cuda:(i % device_count), or every shard on the one
    card a device index names. Raises when no card is present."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return (dev,) * n
    if dev.type != "cuda":
        raise ValueError(f"make_mesh: no mesh on device type {dev.type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"make_mesh(device={device!r}): no CUDA device; "
                           f"pass device='cpu' for a CPU mesh")
    if dev.index is not None:
        return (dev,) * n
    n_cards = torch.cuda.device_count()
    return tuple(torch.device("cuda", i % n_cards) for i in range(n))


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A one-process mesh of n_devices shards (default: one a card, or one
    shard on the CPU)."""
    if n_devices is None:
        n_devices = (torch.cuda.device_count()
                     if torch.device(device).type == "cuda" else 1)
    if n_devices < 1:
        raise ValueError(f"make_mesh: n_devices={n_devices}")
    return Mesh(shard_devices(n_devices, device))


def _as_tensor(x) -> torch.Tensor:
    """A tensor of x; uint32 numpy words become int64 holding them (the
    port's word type, kmer/bits.py)."""
    if torch.is_tensor(x):
        return x
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(x))


def sharded(mesh: Mesh, x) -> List[torch.Tensor]:
    """The local shards' row blocks of a global array (numpy or tensor):
    axis 0 split into mesh.size contiguous blocks (the reference's P("x")),
    block g on global shard g's device."""
    x = _as_tensor(x)
    n = mesh.size
    if x.shape[0] % n:
        raise ValueError(f"sharded: {x.shape[0]} rows not divisible by mesh "
                         f"size {n}")
    rows = x.shape[0] // n
    return [x[(mesh.first + s) * rows:(mesh.first + s + 1) * rows]
            .to(dev) for s, dev in enumerate(mesh.devices)]


def local_blocks(mesh: Mesh, x) -> List[torch.Tensor]:
    """`x` as the local shards' blocks: a list of mesh.n_local blocks is
    taken as given (moved to the shards' devices), anything else is a
    global array and goes through `sharded`."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.n_local:
            raise ValueError(f"{len(x)} blocks for {mesh.n_local} local "
                             f"shards")
        return [_as_tensor(b).to(dev) for b, dev in zip(x, mesh.devices)]
    return sharded(mesh, x)


def replicated(mesh: Mesh, x) -> List[torch.Tensor]:
    """The same array on every local shard (the reference's P())."""
    x = _as_tensor(x)
    return [x.to(dev) for dev in mesh.devices]


def concat_local(mesh: Mesh, blocks: Sequence[torch.Tensor]) -> torch.Tensor:
    """The local shards' blocks as one array on mesh.home: this process's
    rows of the global sharded array (all of it in one process)."""
    return torch.cat([b.to(mesh.home) for b in blocks])


def _staging(mesh: Mesh) -> torch.device:
    """Where cross-process collectives run: host memory for gloo, which
    takes CPU tensors only; the home device otherwise."""
    return torch.device("cpu") if mesh.backend == "gloo" else mesh.home


def all_to_all(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """xs: one [size * cap] array a local shard. Block j of shard i goes to
    shard j; shard j receives [size * cap] with block i from shard i."""
    n, m = mesh.size, mesh.n_local
    cap = xs[0].shape[0] // n
    if mesh.world == 1:
        return [torch.cat([x[d * cap:(d + 1) * cap].to(dev) for x in xs])
                for d, dev in enumerate(mesh.devices)]
    stage = _staging(mesh)
    # [destination process, local source, local destination, cap]: chunk p
    # of dim 0 goes to process p, which receives [source process, local
    # source, its local destination, cap], i.e. global source order
    send = torch.stack([x.to(stage).view(mesh.world, m, cap) for x in xs],
                       dim=1).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    return [recv[:, :, d].reshape(-1).to(dev)
            for d, dev in enumerate(mesh.devices)]


def psum(mesh: Mesh, xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum over every shard of the local shards' values, on mesh.home."""
    total = xs[0].to(mesh.home).clone()
    for x in xs[1:]:
        total += x.to(mesh.home)
    if mesh.world == 1:
        return total
    buf = total.to(_staging(mesh))
    dist.all_reduce(buf)
    return buf.to(mesh.home)


def all_gather(mesh: Mesh, xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """[size, ...]: every shard's value, in global shard order, on
    mesh.home."""
    local = torch.stack([x.to(mesh.home) for x in xs])
    if mesh.world == 1:
        return local
    buf = local.to(_staging(mesh))
    parts = [torch.empty_like(buf) for _ in range(mesh.world)]
    dist.all_gather(parts, buf)
    return torch.cat(parts).to(mesh.home)
