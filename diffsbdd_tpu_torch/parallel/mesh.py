"""Process groups and collectives of the multi-device paths.

The reference trains with PyTorch-Lightning DDP over NCCL; the JAX package
puts a 1-D 'data' mesh over its devices and lets XLA all-reduce the
gradients.  Here one process drives one card (launched by ``torchrun`` or
``torch.multiprocessing.spawn``): a global batch is split over the ranks of a
data group (``shard_batch``), the parameters are made identical from the
group's first rank once (``broadcast_module``), and the gradients, loss and
metrics of every step are averaged with one packed ``all_reduce``
(``all_reduce_mean``, JAX's ``pmean``).  Every collective runs on a process
group that the caller passes in; ``None`` stands for a process on its own.
"""
from __future__ import annotations

import itertools
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(cfg=None, device="cuda", init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     backend: Optional[str] = None) -> int:
    """Join the process group of a multi-process run; returns the process count.

    The run is multi-process when the ``torchrun`` environment is set
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``), when ``init_method`` is given (with ``rank`` and
    ``world_size``), or when the config sets ``tpu.multihost`` (which then
    fails without the environment, as JAX's initialization does).  Otherwise
    the process stays on its own and 1 is returned.  NCCL serves a CUDA
    device and gloo the CPU unless ``backend`` says otherwise; on CUDA the
    process is bound to card ``LOCAL_RANK`` (the rank without torchrun's
    environment) first.  Already initialized: returns the world size.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    multihost = cfg is not None and bool(cfg.tpu.get("multihost", False))
    if init_method is None and "WORLD_SIZE" not in os.environ and not multihost:
        return 1
    device = torch.device(device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if init_method is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    return dist.get_world_size()


def make_data_group(n_data: int = -1):
    """The process group of the first ``n_data`` ranks (every rank when
    ``n_data`` < 1), the counterpart of the JAX package's ``make_mesh``; every
    rank must call it, in the same order as the other groups it makes.  Raises
    when more ranks are asked for than exist.  None without a process group:
    a process on its own."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data < 1:
        n_data = world
    if n_data > world:
        # silently truncating would desync callers that sized their batch
        # against the requested group
        raise ValueError(f"requested a {n_data}-rank data group but only {world} "
                         f"processes are running")
    if not dist.is_initialized():
        return None
    return dist.new_group(ranks=list(range(n_data)))


def group_rank_size(group) -> Tuple[int, int]:
    """(this process's rank in ``group``, the group's size); (0, 1) for None."""
    if group is None:
        return 0, 1
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError(f"rank {dist.get_rank()} is not a member of the group")
    return rank, dist.get_world_size(group)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s own random stream, derived from (seed,
    rank): each rank draws its own noise, as the JAX package folds the data
    axis index into the step key.  Rank 0 keeps ``seed``, so that a group of
    one draws what a process on its own draws."""
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(rank)]).generate_state(1)[0])


def shard_batch(batch, group):
    """This rank's contiguous slice of every leading (batch) axis of a
    (nested) dict of arrays, tensors or lists; raises when the group's size
    does not divide the batch."""
    index, count = group_rank_size(group)
    if isinstance(batch, dict):
        return {k: shard_batch(v, group) for k, v in batch.items()}
    n = len(batch)
    if n % count != 0:
        raise ValueError(f"batch {n} is not divisible by the {count} ranks of "
                         f"the data group")
    local = n // count
    return batch[index * local:(index + 1) * local]


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, group) -> None:
    """Parameters and buffers of ``module`` copied from the group's first rank
    to every other rank of ``group``."""
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    for t in itertools.chain(module.parameters(), module.buffers()):
        dist.broadcast(t.data, src=src, group=group)


def all_reduce_mean(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The mean of each tensor over the ranks of ``group`` (JAX's ``pmean``):
    the tensors packed into one flat buffer, one ``all_reduce`` (sum), divided
    by the group's size.  The backend fixes the order of the sum and uses no
    atomics, so the result is the same on every rank and in every run."""
    _, size = group_rank_size(group)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= size
    return [part.view_as(t) for part, t in
            zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along the batch axis, in
    rank order, on every rank."""
    _, size = group_rank_size(group)
    if size == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, 0)
