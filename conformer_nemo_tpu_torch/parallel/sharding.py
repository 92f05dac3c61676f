"""The tensor-parallel encoder over the mesh's 'model' axis (port of
conformer_nemo_tpu/parallel/sharding.py).

The JAX package assigns PartitionSpecs and lets XLA split the products and
insert the collectives. The port has no partitioner, so it follows the
same rules with explicit Megatron-style pieces: `copy_to_tp` (identity
forward, all-reduce backward) where a block enters the sharded region and
`reduce_from_tp` (all-reduce forward, identity backward) after a
row-parallel product, whose bias is added after the reduction. One
all-reduce a block forward and one backward.

Rules, on NeMo's parameter names (torch layouts: a linear's weight is
[out, in]):
  * column-parallel (output rows sharded, bias too): feed-forward
    `linear1`; attention `linear_q/k/v/pos` (head-sharded: each rank
    holds n_heads / model heads); `pointwise_conv1`, whose 2D outputs are
    the GLU's halves (a, gate): each half is sharded, so rank k holds the
    k-th slice of both;
  * row-parallel (input columns sharded, bias replicated): `linear2`,
    `linear_out`, `pointwise_conv2`;
  * by channel: the depthwise kernel, its bias and the conv module's norm
    (NeMo's `batch_norm` for both norm types: a BatchNorm's weight, bias
    and running statistics, or a LayerNorm's weight and bias, whose
    statistics the ranks all-reduce); by head: `pos_bias_u/v`
    [H, d_head] (the JAX package leaves those to XLA);
  * everything else (subsampling, LayerNorms, the CTC head, the prediction
    network and joint) replicated.

A sharded parameter carries `tp_dim` (its sharded dimension), which the
mesh reads to reduce gradients and norms. The flash kernels see n_heads /
model heads (BH halves at model 2); their depth d1 = d_head + d_model does
not change, so the flash training limits hold as they are.

Checkpoints and archives hold full tensors: `gather_*` assemble them
(collective: every rank of the model group calls), `shard_*` cut them for
the live layout.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch import nn


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A module's place on the model axis."""

    group: Any
    size: int
    rank: int


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """Enter the sharded region: identity; the backward sums the ranks'
    input gradients."""
    return x if tp is None else _CopyToTP.apply(x, tp.group)


def reduce_from_tp(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """Leave it: the ranks' partial sums added; the backward passes the
    gradient to every rank as it is."""
    return x if tp is None else _ReduceFromTP.apply(x, tp.group)


# -- which parameters are sharded -------------------------------------------

_LAYER = r"(?:^|\.)encoder\.layers\.\d+\."
_RULES = [  # (pattern, sharded dim, GLU halves)
    (_LAYER + r"feed_forward[12]\.linear1\.(weight|bias)$", 0, False),
    (_LAYER + r"feed_forward[12]\.linear2\.weight$", 1, False),
    (_LAYER + r"self_attn\.linear_[qkv]\.(weight|bias)$", 0, False),
    (_LAYER + r"self_attn\.linear_pos\.weight$", 0, False),
    (_LAYER + r"self_attn\.pos_bias_[uv]$", 0, False),
    (r"(?:^|\.)encoder\.pos_bias_[uv]$", 0, False),
    (_LAYER + r"self_attn\.linear_out\.weight$", 1, False),
    (_LAYER + r"conv\.pointwise_conv1\.(weight|bias)$", 0, True),
    (_LAYER + r"conv\.depthwise_conv\.(weight|bias)$", 0, False),
    (_LAYER + r"conv\.batch_norm\.(weight|bias|running_mean|running_var)$", 0, False),
    (_LAYER + r"conv\.pointwise_conv2\.weight$", 1, False),
]
_RULES = [(re.compile(p), dim, glu) for p, dim, glu in _RULES]


def param_spec(name: str) -> Optional[tuple]:
    """-> (sharded dim, GLU halves) of a state_dict entry, or None when it is
    replicated."""
    for pattern, dim, glu in _RULES:
        if pattern.search(name):
            return dim, glu
    return None


def shard_tensor(t: torch.Tensor, dim: int, glu: bool, rank: int, size: int) -> torch.Tensor:
    """Rank `rank`'s slice of a full tensor (of each GLU half)."""
    halves = t.chunk(2, dim=dim) if glu else (t,)
    return torch.cat([h.chunk(size, dim=dim)[rank] for h in halves], dim=dim).contiguous()


def gather_tensor(t: torch.Tensor, dim: int, glu: bool, tp: TensorParallel) -> torch.Tensor:
    """The full tensor from every rank's slice (collective over the model
    group; all-reduce of the slices placed in zeros, which every backend
    takes, CUDA tensors on gloo included)."""
    shape = list(t.shape)
    shape[dim] *= tp.size
    full = torch.zeros(shape, dtype=t.dtype, device=t.device)
    halves = full.chunk(2, dim=dim) if glu else (full,)
    for h, piece in zip(halves, t.chunk(len(halves), dim=dim)):
        h.narrow(dim, tp.rank * piece.shape[dim], piece.shape[dim]).copy_(piece)
    dist.all_reduce(full, group=tp.group)
    return full


def _check_shardable(model: nn.Module, size: int) -> None:
    for mod in model.modules():
        cfg = getattr(mod, "cfg", None)
        if not getattr(type(mod), "TENSOR_PARALLEL", False) or cfg is None:
            continue
        if cfg.n_heads % size or cfg.d_model % size or cfg.d_ff % size:
            raise ValueError(f"mesh model={size} must divide n_heads={cfg.n_heads}, "
                             f"d_model={cfg.d_model} and d_ff={cfg.d_ff}")


def _replace_tensors(model: nn.Module, make) -> None:
    """Replace every parameter and buffer that has a spec with make(name,
    tensor, spec), a tied parameter once (its modules share the new one)."""
    new: dict = {}
    for name, p in model.named_parameters():
        spec = param_spec(name)
        if spec is not None:
            new[id(p)] = nn.Parameter(make(name, p.detach(), spec), requires_grad=p.requires_grad)
    for mod_name, mod in model.named_modules():
        for key, p in list(mod._parameters.items()):
            if p is not None and id(p) in new:
                mod._parameters[key] = new[id(p)]
        for key, b in list(mod._buffers.items()):
            name = f"{mod_name}.{key}" if mod_name else key
            spec = param_spec(name)
            if b is not None and spec is not None:
                mod._buffers[key] = make(name, b, spec)


def _set_tp(model: nn.Module, tp: Optional[TensorParallel]) -> None:
    for mod in model.modules():
        if getattr(type(mod), "TENSOR_PARALLEL", False):
            mod.tp = tp
    for name, p in model.named_parameters():
        spec = param_spec(name)
        p.tp_dim = None if tp is None or spec is None else spec[0]


def shard_model_(model: nn.Module, mesh) -> None:
    """Cut the full encoder to this rank's slices, in place (a no-op at
    model 1)."""
    if mesh.model == 1:
        return
    _check_shardable(model, mesh.model)
    tp = TensorParallel(mesh.model_group, mesh.model, mesh.model_index)
    _replace_tensors(model, lambda name, t, spec: shard_tensor(t, *spec, tp.rank, tp.size))
    _set_tp(model, tp)


def tp_of(model: nn.Module) -> Optional[TensorParallel]:
    """The model's tensor-parallel place, or None when it holds full tensors."""
    for mod in model.modules():
        if getattr(type(mod), "TENSOR_PARALLEL", False) and mod.tp is not None:
            return mod.tp
    return None


def unshard_model_(model: nn.Module) -> None:
    """Gather the full tensors back onto every rank, in place (collective;
    a no-op for a model that holds full tensors)."""
    tp = tp_of(model)
    if tp is None:
        return
    _replace_tensors(model, lambda name, t, spec: gather_tensor(t, *spec, tp))
    _set_tp(model, None)


def full_state_dict(model: nn.Module) -> dict:
    """The model's state_dict with full tensors (collective when sharded)."""
    sd = model.state_dict()
    tp = tp_of(model)
    if tp is None:
        return sd
    return {k: (gather_tensor(v, *param_spec(k), tp) if param_spec(k) else v)
            for k, v in sd.items()}


def shard_state_dict(sd: dict, tp: Optional[TensorParallel]) -> dict:
    """A full state_dict cut to a rank's slices (tp None: as it is)."""
    if tp is None:
        return sd
    return {k: (shard_tensor(v, *param_spec(k), tp.rank, tp.size) if param_spec(k) else v)
            for k, v in sd.items()}


def _map_param_lists(obj: Any, n: int, fn) -> Any:
    """Apply fn(i, tensor) to each entry of every list of n tensors in an
    optimizer state (the per-parameter moments, in parameter order)."""
    if isinstance(obj, dict):
        return {k: _map_param_lists(v, n, fn) for k, v in obj.items()}
    if isinstance(obj, list) and len(obj) == n and all(torch.is_tensor(t) for t in obj):
        return [fn(i, t) for i, t in enumerate(obj)]
    return obj


def _cut_along(t: torch.Tensor, spec: Optional[tuple], shape: torch.Size, size: int) -> bool:
    """Whether a moment of a parameter with `spec` and (slice) `shape` is cut
    along the sharded dim: it has the parameter's rank and the dim's full
    length (size = model) or slice length (size = 1) there. Scalars
    (novograd's per-leaf norm), placeholders and factored moments reduced
    over the sharded dim (adafactor's, kept as size 1) hold the full
    leaf's value on every rank."""
    return (spec is not None and t.dim() == len(shape)
            and t.shape[spec[0]] == shape[spec[0]] * size)


def gather_opt_state(opt_state: Any, model: nn.Module) -> Any:
    """The optimizer state with full per-parameter tensors (collective when
    the model is sharded)."""
    tp = tp_of(model)
    if tp is None:
        return opt_state
    params = list(model.named_parameters())

    def gather(i: int, t: torch.Tensor) -> torch.Tensor:
        spec = param_spec(params[i][0])
        return gather_tensor(t, *spec, tp) if _cut_along(t, spec, params[i][1].shape, 1) else t

    return _map_param_lists(opt_state, len(params), gather)


def shard_opt_state(opt_state: Any, model: nn.Module,
                    tp: Optional[TensorParallel] = None) -> Any:
    """A full optimizer state cut to the slices of `tp` (default: the
    model's own place; the model holds its slices)."""
    tp = tp or tp_of(model)
    if tp is None:
        return opt_state
    params = list(model.named_parameters())

    def shard(i: int, t: torch.Tensor) -> torch.Tensor:
        spec = param_spec(params[i][0])
        if _cut_along(t, spec, params[i][1].shape, tp.size):
            return shard_tensor(t, *spec, tp.rank, tp.size)
        return t

    return _map_param_lists(opt_state, len(params), shard)


def set_sync_batchnorm(model: nn.Module, group) -> None:
    """Point every BatchNorm's training statistics at `group` (None: local)."""
    for mod in model.modules():
        if hasattr(type(mod), "sync_group"):
            mod.sync_group = group
