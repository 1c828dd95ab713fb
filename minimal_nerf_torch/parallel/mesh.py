"""The 1-D ``"data"`` mesh of a data-parallel run, and its batch sharding.

Counterpart of ``minimal_nerf_tpu/parallel/mesh.py``. In JAX one program
spans the mesh's devices; here each rank of the ``torch.distributed`` world
is a process with one device, and the mesh says which rank this process is
(``make_mesh``). A rank's share of a whole-batch tensor is its contiguous
block of rows (``shard_batch``), as JAX's ``P("data")`` places them.
Rendering shards over the local devices of one process instead
(``local_devices``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel world (the default process
    group): ``size`` ranks, this one ``rank``, its ``device``."""

    size: int
    rank: int
    device: torch.device


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The data mesh of this process: the initialised ``torch.distributed``
    world (``parallel.distributed.initialize``), else a world of one.

    ``n_devices``, when given, must be the world's size: a mesh of more
    ranks than the world has raises, as JAX's ``make_mesh`` raises for more
    devices than are visible, and so does one of fewer (JAX would take the
    first devices; here every rank of the world steps). ``device`` is this
    rank's device; a bare ``"cuda"`` is card ``rank % device_count()``
    (one rank per card of each host), which becomes the current card.
    """
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    if n_devices is not None and n_devices > world:
        raise ValueError(f"requested a {n_devices}-device mesh but only {world} ranks are "
                         "in the torch.distributed world")
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested a {n_devices}-device mesh in a world of {world} ranks; "
                         "every rank of the world takes part")
    dev = torch.device(device)
    if dev.type == "cuda":
        from minimal_nerf_torch import resolve_device

        resolve_device(dev)
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return Mesh(size=world, rank=rank, device=dev)


def local_devices(n: int, device="cuda") -> List[torch.device]:
    """``n`` devices of ``device``'s type in this process, for a render
    sharded over them: the cards from ``device``'s index (0 for a bare
    ``"cuda"``) on, more than are visible raising (nothing falls back to
    fewer), or the CPU ``n`` times."""
    dev = torch.device(device)
    if n < 1:
        raise ValueError(f"a mesh of {n} devices")
    if dev.type != "cuda":
        return [dev] * n
    from minimal_nerf_torch import resolve_device

    resolve_device(dev)
    first, visible = dev.index or 0, torch.cuda.device_count()
    if first + n > visible:
        raise ValueError(f"requested a {n}-device mesh from cuda:{first} but only {visible} "
                         "CUDA devices are visible")
    return [torch.device("cuda", first + i) for i in range(n)]


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a whole-batch tensor (JAX ``shard_batch``'s
    ``P("data")`` placement): rows ``[rank * n, (rank + 1) * n)`` with ``n =
    rows / mesh.size``; a batch that does not divide raises."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"batch of {x.shape[0]} rows not divisible by mesh size {mesh.size}")
    n = x.shape[0] // mesh.size
    return x[mesh.rank * n:(mesh.rank + 1) * n]
