"""The multi-process runtime of a data-parallel run on ``torch.distributed``.

Counterpart of ``minimal_nerf_tpu/parallel/distributed.py``. Each rank is a
process with one device (``parallel.mesh.make_mesh``); ranks meet at a
``tcp://`` address (``initialize``), the collectives run over NCCL between
cards or over gloo (the CPU, or CUDA tensors without NCCL). Every rank
draws the whole step and computes its rows (``training.loop``), so nothing
but the initial state (``put_replicated``), the resume step
(``check_same_step``) and each step's gradients and metrics
(``all_reduce_mean``) crosses ranks. Rank 0 alone writes checkpoints,
metrics and images (``is_primary``; ``training.trainer.Trainer``).
"""

from __future__ import annotations

import socket
from typing import List, Optional

import torch
import torch.distributed as dist


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               backend: Optional[str] = None, device="cuda") -> None:
    """Join the ``num_processes``-rank world as rank ``process_id`` through
    ``tcp://coordinator_address`` (``HOST:PORT``; rank 0 listens there).
    ``backend`` defaults to ``"nccl"`` for a CUDA ``device`` and ``"gloo"``
    otherwise."""
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator's HOST:PORT, the number "
                         "of processes and this process's id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside a world of {num_processes}")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the world (a no-op outside one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port free on this host now, for a local coordinator."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend() -> str:
    """The backend of the world's collectives (``"nccl"``, ``"gloo"``)."""
    return str(dist.get_backend())


def is_primary() -> bool:
    """True on the process that owns host-side IO (checkpoints, metrics,
    images): rank 0, or the only process."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _tensors(tree) -> List[torch.Tensor]:
    from minimal_nerf_torch.training.checkpoint import flatten_tree

    return [t for t in flatten_tree(tree) if torch.is_tensor(t)]


@torch.no_grad()
def put_replicated(tree, mesh):
    """Every tensor of ``tree`` (params, Adam moments, a grid) overwritten
    IN PLACE with rank 0's, so every rank starts from rank 0's state;
    returns ``tree``. One broadcast of a flat fp32 buffer per call."""
    leaves = _tensors(tree)
    if mesh is None or mesh.size == 1 or not leaves:
        return tree
    flat = torch.cat([t.reshape(-1).float() for t in leaves])
    dist.broadcast(flat, src=0)
    offset = 0
    for t in leaves:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return tree


def check_same_step(step: int, mesh) -> None:
    """Raise unless every rank resumed at ``step`` (JAX ``trainer.py:215-
    222``): a checkpoint readable on some hosts only would start the ranks
    from different states."""
    if mesh is None or mesh.size == 1:
        return
    # each rank's step in its own slot, summed: an all-reduce, which every
    # backend takes on CUDA tensors (gloo's all-gather does not)
    steps = torch.zeros(mesh.size, dtype=torch.int64, device=mesh.device)
    steps[mesh.rank] = int(step)
    dist.all_reduce(steps)
    found = sorted({int(s) for s in steps.tolist()})
    if len(found) != 1:
        raise RuntimeError(f"multihost resume mismatch: ranks restored different steps "
                           f"{found}; make the checkpoint readable on every host or pass a "
                           "--ckpt that exists everywhere")


def all_reduce_mean(tensors: List[torch.Tensor], mesh) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor (JAX's ``pmean``): ONE
    all-reduce of a flat fp32 buffer that holds them all, divided by the
    world size; returns new tensors shaped as the given ones."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    if dist.is_available() and dist.is_initialized():  # else a world of one
        dist.all_reduce(flat)
    flat = flat / mesh.size
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return out
