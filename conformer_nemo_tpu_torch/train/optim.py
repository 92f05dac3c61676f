"""Optimizers with optax's arithmetic (port of conformer_nemo_tpu/train/optim.py).

Functional, as optax is: `init(params) -> state`, `update(grads, state,
params) -> (updates, state)`, then `apply_updates(params, updates)` adds
them in place. Lists of tensors stand for the pytrees; states hold a
Python step count and tensors.

Ported: adamw (optax.adamw: Adam, then + weight_decay * p, then * -lr),
adam, sgd (a momentum trace), optax's global-norm clipping (scale by
max_norm / norm only when norm >= max_norm; torch's clip_grad_norm_ adds
1e-6 to the norm and does not match), and `with_grad_accumulation`
(optax.MultiSteps: the running mean of k micro-batch gradients, one inner
update every k-th call). The schedule is read at the pre-increment count.
novograd, adafactor, adadelta, adamax, adagrad, rmsprop and rprop raise:
torch's versions place eps and initialise accumulators differently from
optax's, so each needs its own port (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

Tensors = List[torch.Tensor]
EPS = 1e-8  # Adam's epsilon (optax's default, as the JAX package uses it)
MOMENTUM = 0.9  # sgd's momentum, likewise


@dataclasses.dataclass
class Transformation:
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (optax.global_norm)."""
    return torch.sqrt(sum((t.to(torch.float32) ** 2).sum() for t in tensors))


def _bias_correction(moment: torch.Tensor, decay: float, count: int) -> torch.Tensor:
    return moment / (1.0 - decay ** count)


def _adam(lr_schedule: Callable[[int], float], b1: float, b2: float, eps: float,
          weight_decay: Optional[float]) -> Transformation:
    def init(params):
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(grads, state, params):
        count = state["count"] + 1
        lr = lr_schedule(state["count"])
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state["mu"])]
        nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state["nu"])]
        updates = []
        for i, (m, v) in enumerate(zip(mu, nu)):
            u = _bias_correction(m, b1, count) / (torch.sqrt(_bias_correction(v, b2, count)) + eps)
            if weight_decay is not None:
                u = u + weight_decay * params[i]
            updates.append(-lr * u)
        return updates, {"count": count, "mu": mu, "nu": nu}

    return Transformation(init, update)


def _sgd(lr_schedule: Callable[[int], float], momentum: float) -> Transformation:
    def init(params):
        return {"count": 0, "trace": [torch.zeros_like(p) for p in params]}

    def update(grads, state, params):
        lr = lr_schedule(state["count"])
        trace = [g + momentum * t for g, t in zip(grads, state["trace"])]
        return [-lr * t for t in trace], {"count": state["count"] + 1, "trace": trace}

    return Transformation(init, update)


def _clip_by_global_norm(inner: Transformation, max_norm: float,
                         grad_norm: Callable) -> Transformation:
    def update(grads, state, params):
        norm = grad_norm(grads, params)
        keep = norm < max_norm
        return inner.update([torch.where(keep, g, g / norm * max_norm) for g in grads],
                            state, params)

    return Transformation(inner.init, update)


_NOT_PORTED = ("novograd", "adafactor", "adadelta", "adamax", "adagrad", "rmsprop", "rprop")


def make_optimizer(name: str, lr_schedule: Callable[[int], float], *, weight_decay: float = 0.0,
                   betas: tuple = (0.9, 0.98), grad_clip: Optional[float] = None,
                   grad_norm: Optional[Callable] = None) -> Transformation:
    """grad_norm(grads, params): the norm that clipping reads (default the
    global norm of `grads`; a tensor-parallel run passes the mesh's norm of
    the full gradients)."""
    name = name.lower()
    if name == "adamw":
        opt = _adam(lr_schedule, betas[0], betas[1], EPS, weight_decay)
    elif name == "adam":
        opt = _adam(lr_schedule, betas[0], betas[1], EPS, None)
    elif name == "sgd":
        opt = _sgd(lr_schedule, MOMENTUM)
    elif name in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP.md, slice 2 leftovers): torch's "
            "version differs from optax's in eps placement and initial accumulators")
    else:
        raise ValueError(f"unknown optimizer {name}")
    if grad_clip and grad_clip > 0:
        opt = _clip_by_global_norm(opt, float(grad_clip),
                                   grad_norm or (lambda grads, params: global_norm(grads)))
    return opt


def with_grad_accumulation(opt: Transformation, every: int) -> Transformation:
    """Average the gradients of `every` micro-batches before one update of
    `opt` (optax.MultiSteps); the other calls return zero updates."""
    if every <= 1:
        return opt

    def init(params):
        return {"mini_step": 0, "inner": opt.init(params),
                "acc": [torch.zeros_like(p) for p in params]}

    def update(grads, state, params):
        n = state["mini_step"]
        acc = [a + (g - a) / (n + 1) for g, a in zip(grads, state["acc"])]
        if n < every - 1:
            return ([torch.zeros_like(g) for g in grads],
                    {"mini_step": n + 1, "inner": state["inner"], "acc": acc})
        updates, inner = opt.update(acc, state["inner"], params)
        return updates, {"mini_step": 0, "inner": inner,
                         "acc": [torch.zeros_like(a) for a in acc]}

    return Transformation(init, update)


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """params += updates, in place (optax.apply_updates)."""
    for p, u in zip(params, updates):
        p.add_(u.to(p.dtype))
