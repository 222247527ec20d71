"""Data parallelism over ``torch.distributed`` (the port of
insmos_tpu/parallel/mesh.py).

The reference's only distribution strategy is data parallelism (Lightning
DDP: a replicated model, the batch split across ranks, a gradient
all-reduce); the JAX package shards the batch's leading axis over a 1-D
device mesh. Here it is one process per device, as torchrun starts them
(its ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``), with NCCL between cards
and gloo between CPU processes.

A :class:`World` names this process's place: its rank, the number of
processes, and how many of them take a shard of the current batch
(``data_size``, :func:`data_world_for_batch`, which also records the
global batch size). Ranks at or beyond
``data_size`` take an empty shard and still join every collective with
zeros, so their replicas stay equal to the others'. Without torchrun's
environment the world is one process with no process group, and every
function here is the identity.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class World:
    rank: int = 0
    size: int = 1
    data_size: int = 1  # ranks 0 .. data_size - 1 take a shard
    distributed: bool = False  # a process group is open
    batch_size: int = 0  # the global batch it was sized for (0: not sized)

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def rank_device(device: str = "cuda") -> str:
    """The device of this process: ``cuda:LOCAL_RANK`` under torchrun when
    ``device`` is the bare ``"cuda"``, else ``device`` as given."""
    if device == "cuda" and "LOCAL_RANK" in os.environ:
        return f"cuda:{int(os.environ['LOCAL_RANK'])}"
    return device


def init_world(device, init_method: str = "env://",
               timeout: datetime.timedelta = datetime.timedelta(minutes=10)
               ) -> World:
    """Open the process group that torchrun's environment (or ``RANK`` and
    ``WORLD_SIZE`` set by the caller) describes: NCCL when ``device`` is a
    card, gloo on the CPU. Without ``WORLD_SIZE`` in the environment, the
    world of one process and no group. The caller closes the group with
    :func:`close_world`."""
    if "WORLD_SIZE" not in os.environ:
        return World()
    size = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=size, timeout=timeout, **kw)
    return World(rank, size, size, True)


def close_world(world: World) -> None:
    if world.distributed and dist.is_initialized():
        dist.destroy_process_group()


def data_world_for_batch(world: World, batch_size: int) -> World:
    """The largest number of ranks that divides the batch (as the JAX
    package's ``data_mesh_for_batch``: each shard is batch / data_size
    samples). The ranks beyond it sit out: they take empty shards."""
    n = world.size
    while n > 1 and batch_size % n:
        n -= 1
    return dataclasses.replace(world, data_size=n, batch_size=batch_size)


def shard_batch(world: World, batch: dict) -> dict:
    """This rank's contiguous slice of the batch's leading axis (as
    ``P('data')`` splits it); empty on a rank that sits out."""
    B = next(iter(batch.values())).shape[0]
    if world.batch_size and B != world.batch_size:
        raise ValueError(f"batch {B}, but the world was sized for "
                         f"{world.batch_size}")
    if B % world.data_size:
        raise ValueError(f"batch {B} does not split over {world.data_size} "
                         "ranks")
    m = B // world.data_size
    lo = min(world.rank, world.data_size) * m
    hi = lo + m if world.rank < world.data_size else lo
    return {k: v[lo:hi] for k, v in batch.items()}


def replicate(world: World, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast the parameters and buffers of rank 0 to every rank."""
    if world.distributed:
        with torch.no_grad():
            for t in module.state_dict().values():
                dist.broadcast(t, src=0)
    return module


def all_reduce_sum(world: World, tensors: list[torch.Tensor]
                   ) -> list[torch.Tensor]:
    """The elementwise sum of each tensor over the ranks (one collective:
    the tensors travel in one flat buffer of the first one's dtype, which
    must hold the others exactly)."""
    if not world.distributed:
        return tensors
    flat = torch.cat([t.reshape(-1).to(tensors[0].dtype) for t in tensors])
    dist.all_reduce(flat)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def all_reduce_grads(world: World, params) -> None:
    """Sum every parameter's gradient over the ranks, in one all-reduce. A
    parameter no rank gave a gradient keeps ``.grad`` None, as on one
    process (the optimizer skips it); one that some rank lacked counts
    that rank's as zeros."""
    if not world.distributed:
        return
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    has = torch.tensor([p.grad is not None for p in params],
                       dtype=grads[0].dtype, device=grads[0].device)
    *summed, has = all_reduce_sum(world, grads + [has])
    for p, g, h in zip(params, summed, has.tolist()):
        p.grad = g if h else None
