"""The ('data', 'model') mesh of a training run, as process groups (port of
conformer_nemo_tpu/parallel/mesh.py).

Ranks lie on the mesh as the JAX package lays devices out,
`reshape(data, model)` with the model axis fastest: rank r has data index
r // model and model index r % model. The data groups (one per model
index) reduce gradients, the loss's weights and the BatchNorm statistics;
the model groups (one per data index) carry the tensor-parallel encoder
(parallel/sharding.py). Both ranks of a model group load the same rows.

`data: -1` (or None) means world // model. A mesh that does not multiply
to the world raises before any step. The JAX `fit` shrinks its data axis
until it divides the batch size, because it splits one `batch_size` batch
over its devices; each port rank loads `batch_size` rows of its own, so
the global batch is batch_size x data (NeMo's DDP convention) and no
shrinking is needed.

Outside a process group the mesh is 1 x 1 with no groups, and every
method below is the identity of the single-process step. Inside one, the
groups exist even at size 1, so a world of one still runs its collectives.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from conformer_nemo_tpu_torch.parallel.distributed import (
    all_reduce_coalesced,
    collective_device,
    get_rank,
    get_world_size,
    is_initialized,
)
from conformer_nemo_tpu_torch.train.optim import global_norm


@dataclasses.dataclass
class Mesh:
    data: int = 1
    model: int = 1
    rank: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def distributed(self) -> bool:
        return self.data_group is not None

    def describe(self, batch_size: int) -> str:
        if not self.distributed:
            return (f"one process, one device (no launcher environment); batch {batch_size}")
        return (f"world {self.world}, rank {self.rank}: mesh data {self.data} x model "
                f"{self.model}; global batch {batch_size} rows a rank x {self.data} = "
                f"{batch_size * self.data}")

    # -- the train step's reductions --------------------------------------

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the data group (no gradient)."""
        if not self.distributed:
            return x
        y = x.detach().clone()
        dist.all_reduce(y, group=self.data_group)
        return y

    def reduce_grads(self, grads: list, params: list) -> list:
        """Sum gradients over the data group (the loss is each rank's share
        of the global mean); then average the replicated parameters'
        gradients over the model group, which leaves equal gradients as
        they are and keeps the replicas equal where a kernel's
        accumulation order differs between ranks."""
        if not self.distributed:
            return grads
        grads = all_reduce_coalesced(grads, self.data_group)
        if self.model > 1:
            rep = [i for i, p in enumerate(params) if getattr(p, "tp_dim", None) is None]
            for i, g in zip(rep, all_reduce_coalesced([grads[i] for i in rep],
                                                      self.model_group, average=True)):
                grads[i] = g
        return grads

    def grad_norm(self, grads: list, params: list) -> torch.Tensor:
        """The global norm of the full (unsharded) gradients: the sharded
        parameters' squares summed over the model group, the replicated
        ones' counted once."""
        if self.model == 1 or not self.distributed:
            return global_norm(grads)
        zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        is_sharded = [getattr(p, "tp_dim", None) is not None for p in params]
        squares = lambda want: sum(((g.to(torch.float32) ** 2).sum()
                                    for g, s in zip(grads, is_sharded) if s == want), zero)
        sharded = squares(True)
        dist.all_reduce(sharded, group=self.model_group)
        return torch.sqrt(sharded + squares(False))

    def all_finite(self, norm: torch.Tensor) -> bool:
        """Whether the gradient norm is finite on every rank: one decision,
        so that no rank skips a step that another takes."""
        ok = bool(torch.isfinite(norm))
        if not self.distributed:
            return ok
        flag = torch.tensor([int(ok)], dtype=torch.int32, device=collective_device())
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return bool(flag.item())


def parse_mesh(mesh_cfg: Optional[dict]) -> tuple:
    """The config's trainer.mesh -> (data, model); data -1 or absent is None
    (world // model)."""
    mesh_cfg = mesh_cfg or {}
    model = int(mesh_cfg.get("model", 1) or 1)
    data = mesh_cfg.get("data", -1)
    data = None if data is None or int(data) == -1 else int(data)
    if model < 1 or (data is not None and data < 1):
        raise ValueError(f"trainer.mesh {mesh_cfg}: each axis is -1 (data only) or >= 1")
    return data, model


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The mesh of this process's world: its groups when a process group is
    initialised (every rank must call this, in the same order), else the
    1 x 1 mesh of one process. data None means world // model."""
    world, rank = get_world_size(), get_rank()
    if world % model:
        raise ValueError(f"trainer.mesh model={model} does not divide a world of {world} "
                         "processes")
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"trainer.mesh data={data} x model={model} needs a world of "
                         f"{data * model} processes; this is a world of {world} (launch one "
                         f"process per GPU with torchrun --nproc-per-node {data * model}, or "
                         "set data: -1)")
    if not is_initialized():
        return Mesh()
    data_groups = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]
    return Mesh(data=data, model=model, rank=rank, data_group=data_groups[rank % model],
                model_group=model_groups[rank // model])
