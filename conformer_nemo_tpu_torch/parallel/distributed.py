"""Process groups for multi-GPU training (port of
conformer_nemo_tpu/parallel/distributed.py).

One process per GPU, as `torchrun` (or `python -m torch.distributed.run`)
starts them: each reads MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK and
LOCAL_RANK, the environment the JAX package's `initialize_distributed`
honours too, and trains on cuda:LOCAL_RANK. The backend is NCCL for CUDA
and gloo for the CPU unless the caller names one. A world of one with no
launcher environment is a no-op; a failed initialisation raises, and
nothing carries on as a single process.

Besides the bootstrap: the rank and world size, `AppState` (a snapshot of
the topology), `is_main_process`,
`barrier`, `host_psum_scalars` (host scalars summed over a group, as the
WER counts are), `all_reduce_sum` (a sum whose gradient is the sum of the
ranks' gradients, for the synchronised BatchNorm), and the coalesced
all-reduce of gradients with its byte count.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as dist

from conformer_nemo_tpu_torch.device import resolve_device

DEFAULT_TIMEOUT_S = 1800.0
BUCKET_ELEMENTS = 1 << 24  # gradients all-reduce in flat buckets of this many elements

# bytes and calls of the gradient all-reduce since the last reset (per process)
GRAD_ALL_REDUCE = {"bytes": 0, "calls": 0}


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *, backend: Optional[str] = None,
                           device=None, timeout_s: Optional[float] = None) -> tuple:
    """Join the process group of this launch. -> (rank, world size).

    The address is `coordinator_address` ("host:port"), else
    COORDINATOR_ADDRESS, else MASTER_ADDR:MASTER_PORT; the world size and
    rank come from the arguments, else WORLD_SIZE and RANK. A world of one
    with no address is a no-op (0, 1). The rank's device is `device`, else
    cuda:LOCAL_RANK (device.resolve_device); the backend is `backend`, else
    NCCL on CUDA and gloo on the CPU. Every collective of the group times
    out after `timeout_s` (default 30 minutes). Already initialised: the
    current group's (rank, world size)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if addr is None and os.environ.get("MASTER_ADDR"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT') or '12355'}"
    world = (num_processes if num_processes is not None
             else int(os.environ.get("WORLD_SIZE") or 1))
    rank = process_id if process_id is not None else int(os.environ.get("RANK") or 0)
    if world == 1 and addr is None:
        return 0, 1
    if addr is None:
        raise ValueError(f"a world of {world} processes needs an address: set MASTER_ADDR "
                         "and MASTER_PORT (torchrun does), or pass coordinator_address")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is outside a world of {world}")
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s or DEFAULT_TIMEOUT_S))
    return rank, world


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


@dataclasses.dataclass
class AppState:
    """A snapshot of the topology (NeMo's AppState): this process's rank and
    the world's size from torch.distributed when it is initialised (else 0
    and 1), the GPUs this process sees (the CPU counts as one device where
    there is none), and the world's devices: one a rank, as the port runs
    (one process per GPU), or this process's own outside a process group."""

    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int

    @classmethod
    def current(cls) -> "AppState":
        local = torch.cuda.device_count() or 1
        world = get_world_size()
        return cls(process_index=get_rank(), process_count=world, local_device_count=local,
                   global_device_count=world if is_initialized() else local)

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0


def barrier() -> None:
    """Every rank waits for every other (no-op outside a process group)."""
    if is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def collective_device(group=None) -> torch.device:
    """Where a group's host-side collectives put their tensors: the current
    CUDA device for NCCL, the CPU otherwise."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_psum_scalars(group=None, **scalars) -> dict:
    """Host scalars summed over `group` (default: the world) -> {name:
    float}, in float64; outside a process group, the scalars as floats."""
    if not is_initialized():
        return {k: float(v) for k, v in scalars.items()}
    vals = torch.tensor([float(v) for v in scalars.values()], dtype=torch.float64,
                        device=collective_device(group))
    dist.all_reduce(vals, group=group)
    return {k: float(v) for k, v in zip(scalars, vals.tolist())}


def all_reduce_min(value: int, group=None) -> int:
    """The least of an integer over `group` (outside a process group: itself)."""
    if not is_initialized():
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=collective_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return int(t.item())


class _AllReduceSum(torch.autograd.Function):
    """y = the sum over the group of x; dx = the sum over the group of dy
    (each rank's loss reads y, and the losses add up)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.contiguous().clone()
        dist.all_reduce(dx, group=ctx.group)
        return dx, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of x, differentiable (see _AllReduceSum)."""
    return _AllReduceSum.apply(x, group)


def all_reduce_coalesced(tensors: List[torch.Tensor], group, average: bool = False) -> list:
    """Sum (or average) each tensor over `group`, through flat buffers of
    at most BUCKET_ELEMENTS per dtype; -> new tensors in the given order.
    Counts the bytes in GRAD_ALL_REDUCE."""
    out: list = [None] * len(tensors)
    size = dist.get_world_size(group)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idxs in by_dtype.values():
        start = 0
        while start < len(idxs):
            bucket, n = [], 0
            while start < len(idxs) and (not bucket or n + tensors[idxs[start]].numel()
                                         <= BUCKET_ELEMENTS):
                bucket.append(idxs[start])
                n += tensors[idxs[start]].numel()
                start += 1
            flat = torch.cat([tensors[i].reshape(-1) for i in bucket])
            dist.all_reduce(flat, group=group)
            GRAD_ALL_REDUCE["bytes"] += flat.numel() * flat.element_size()
            GRAD_ALL_REDUCE["calls"] += 1
            if average:
                flat = flat / size
            for i, piece in zip(bucket, flat.split([tensors[i].numel() for i in bucket])):
                out[i] = piece.view_as(tensors[i])
    return out
