"""Optimizers with optax's arithmetic (port of conformer_nemo_tpu/train/optim.py).

Functional, as optax is: `init(params) -> state`, `update(grads, state,
params) -> (updates, state)`, then `apply_updates(params, updates)` adds
them in place. Lists of tensors stand for the pytrees, one entry a leaf
(the port's parameters are the JAX package's leaves one for one, in other
layouts); states hold Python step counts and tensors.

All ten of the JAX package's optimizers, with the arguments it gives optax
0.2.6, each written out from optax's source (torch.optim's versions place
eps, start accumulators and initialise novograd differently):

  adamw, adam   scale_by_adam (+ weight_decay * p for adamw), * -lr
  sgd           a momentum trace, * -lr
  novograd      per-leaf squared gradient norm nu (the first step sets it,
                later steps average it with b2), mu = b1 mu + g / (sqrt(nu)
                + eps) + weight_decay * p (the first step sets it), * -lr
  adafactor     optax.adafactor(lr): the factored second moment over a
                leaf's two largest axes when both are >= 128 (decay
                1 - (t+1)^-0.8, eps 1e-30), else a full one; clipping by
                the update's block RMS at 1; * lr; * the parameter's block
                RMS (floor 1e-3); * -1
  adadelta      rho 0.9: sqrt(E[dx^2] + eps) / sqrt(E[g^2] + eps) * g, * -lr
  adamax        b1, b2: mu / (1 - b1^t) / max(|g| + eps, b2 nu), * -lr
  adagrad       accumulators start at 0.1: g * rsqrt(sum g^2 + eps), * -lr
  rmsprop       decay 0.9: g * rsqrt(nu + eps), * -lr, then a momentum trace
  rprop         step sizes from lr_schedule(0), eta 0.5 / 1.2 in [1e-6, 50],
                * -1; as in optax 0.2.6 a call emits the previous call's
                step (so the first moves nothing)

optax's global-norm clipping (scale by max_norm / norm only when norm >=
max_norm; torch's clip_grad_norm_ adds 1e-6 to the norm and does not match)
wraps any of them, and `with_grad_accumulation` (optax.MultiSteps: the
running mean of k micro-batch gradients, one inner update every k-th call)
wraps that. A schedule is read at the pre-increment count.

Under tensor parallelism a rank holds a shard of some leaves (a parameter
with `tp_dim` set, parallel/sharding.py). The JAX package reduces over the
full leaf, so every per-leaf reduction here (novograd's gradient norm,
adafactor's factored means and block RMSs) sums its shards over the
`model_group` passed to `make_optimizer`; adafactor picks the factored
axes from the full shape. Adafactor keeps its factored moments with the
reduced axis as size 1, so each has its leaf's rank and the sharding code
cuts it along the leaf's sharded axis where that axis survives.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

Tensors = List[torch.Tensor]
EPS = 1e-8  # the JAX package's default eps (Adam's, novograd's, ...)
MOMENTUM = 0.9  # its default momentum (sgd's, rmsprop's)
NAMES = ("adamw", "adam", "sgd", "novograd", "adafactor", "adadelta", "adamax", "adagrad",
         "rmsprop", "rprop")


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


# -- per-leaf reductions over a sharded leaf's ranks -------------------------


def _tp_dim(p: torch.Tensor, group) -> Optional[int]:
    return None if group is None else getattr(p, "tp_dim", None)


def _leaf_sum(x: torch.Tensor, p: torch.Tensor, group) -> torch.Tensor:
    """A partial sum over leaf p's local entries -> the full leaf's."""
    if _tp_dim(p, group) is None:
        return x
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


def _full_shape(p: torch.Tensor, group) -> tuple:
    dim = _tp_dim(p, group)
    shape = list(p.shape)
    if dim is not None:
        shape[dim] *= dist.get_world_size(group)
    return tuple(shape)


def _leaf_mean(x: torch.Tensor, p: torch.Tensor, group) -> torch.Tensor:
    """jnp.mean over the whole of leaf p (x has p's local shape)."""
    return _leaf_sum(x.sum(), p, group) / float(np.prod(_full_shape(p, group)))


def _axis_mean(x: torch.Tensor, axis: int, p: torch.Tensor, group) -> torch.Tensor:
    """jnp.mean over one axis of leaf p, kept as size 1 (x has p's rank)."""
    total = x.sum(dim=axis, keepdim=True)
    if axis == _tp_dim(p, group):
        total = _leaf_sum(total, p, group)
    return total / float(_full_shape(p, group)[axis])


def factored_dims(shape: tuple, min_dim: int = 128) -> Optional[tuple]:
    """optax's `_factored_dims`: (d1, d0), the second-largest and largest
    axes (numpy's argsort order on ties), when the second-largest is at
    least `min_dim`; else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


# -- the optimizers ----------------------------------------------------------


def _schedule_scale(lr_schedule: Callable[[int], float], count: int, updates: Tensors,
                    sign: float = -1.0) -> Tensors:
    lr = sign * lr_schedule(count)
    return [lr * u for u in updates]


def _novograd(lr_schedule, b1: float, b2: float, eps: float, weight_decay: float,
              group) -> Transformation:
    def init(params):
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros((), dtype=p.dtype, device=p.device) for p in params]}

    def update(grads, state, params):
        count = state["count"] + 1
        mu, nu = [], []
        for g, p, m, n in zip(grads, params, state["mu"], state["nu"]):
            sq = torch.sqrt(_leaf_sum((g * g).sum(), p, group)) ** 2  # jnp.linalg.norm ** 2
            n = sq if count == 1 else (1 - b2) * sq + b2 * n
            add = g / (torch.sqrt(n) + eps) + weight_decay * p
            mu.append(add if count == 1 else b1 * m + add)
            nu.append(n)
        return (_schedule_scale(lr_schedule, state["count"], mu),
                {"count": count, "mu": mu, "nu": nu})

    return Transformation(init, update)


def _adafactor(lr_schedule, group, decay_rate: float = 0.8, eps: float = 1e-30,
               clipping_threshold: float = 1.0, min_scale: float = 1e-3) -> Transformation:
    def init(params):
        out = {"count": 0, "v_row": [], "v_col": [], "v": []}
        for p in params:
            dims = factored_dims(_full_shape(p, group))
            one = torch.zeros((1,), dtype=p.dtype, device=p.device)
            if dims is None:
                out["v_row"].append(one)
                out["v_col"].append(one.clone())
                out["v"].append(torch.zeros_like(p))
                continue
            d1, d0 = dims
            row, col = list(p.shape), list(p.shape)
            row[d0], col[d1] = 1, 1
            out["v_row"].append(torch.zeros(row, dtype=p.dtype, device=p.device))
            out["v_col"].append(torch.zeros(col, dtype=p.dtype, device=p.device))
            out["v"].append(one)
        return out

    def update(grads, state, params):
        count = state["count"]
        decay = float(1.0 - torch.tensor(count + 1, dtype=torch.float32) ** -decay_rate)
        new = {"count": count + 1, "v_row": [], "v_col": [], "v": []}
        updates = []
        for g, p, vr, vc, v in zip(grads, params, state["v_row"], state["v_col"], state["v"]):
            dims = factored_dims(_full_shape(p, group))
            g2 = g * g + eps
            if dims is None:
                v = decay * v + (1.0 - decay) * g2
                u = g * v ** -0.5
            else:
                d1, d0 = dims
                vr = decay * vr + (1.0 - decay) * _axis_mean(g2, d0, p, group)
                vc = decay * vc + (1.0 - decay) * _axis_mean(g2, d1, p, group)
                row_col_mean = _axis_mean(vr, d1, p, group)
                u = g * (vr / row_col_mean) ** -0.5 * vc ** -0.5
            new["v_row"].append(vr)
            new["v_col"].append(vc)
            new["v"].append(v)
            # clip_by_block_rms, * lr, scale_by_param_block_rms, * -1
            u = u / torch.clamp(torch.sqrt(_leaf_mean(u * u, p, group)) / clipping_threshold,
                                min=1.0)
            u = lr_schedule(count) * u
            rms = torch.sqrt(_leaf_mean(p * p, p, group))
            u = u * torch.where(rms <= min_scale, torch.full_like(rms, min_scale), rms)
            updates.append(-1 * u)
        return updates, new

    return Transformation(init, update)


def _adadelta(lr_schedule, eps: float, rho: float = 0.9) -> Transformation:
    def init(params):
        return {"count": 0, "e_g": [torch.zeros_like(p) for p in params],
                "e_x": [torch.zeros_like(p) for p in params]}

    def update(grads, state, params):
        e_g = [(1 - rho) * (g ** 2) + rho * t for g, t in zip(grads, state["e_g"])]
        ups = [torch.sqrt(x + eps) / torch.sqrt(eg + eps) * g
               for g, eg, x in zip(grads, e_g, state["e_x"])]
        e_x = [(1 - rho) * (u ** 2) + rho * t for u, t in zip(ups, state["e_x"])]
        return (_schedule_scale(lr_schedule, state["count"], ups),
                {"count": state["count"] + 1, "e_g": e_g, "e_x": e_x})

    return Transformation(init, update)


def _adamax(lr_schedule, b1: float, b2: float, eps: float) -> Transformation:
    def init(params):
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(grads, state, params):
        count = state["count"] + 1
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state["mu"])]
        nu = [torch.maximum(g.abs() + eps, b2 * n) for g, n in zip(grads, state["nu"])]
        ups = [_bias_correction(m, b1, count) / n for m, n in zip(mu, nu)]
        return (_schedule_scale(lr_schedule, state["count"], ups),
                {"count": count, "mu": mu, "nu": nu})

    return Transformation(init, update)


def _adagrad(lr_schedule, eps: float, initial: float = 0.1) -> Transformation:
    def init(params):
        return {"count": 0, "sum_of_squares": [torch.full_like(p, initial) for p in params]}

    def update(grads, state, params):
        sos = [g * g + t for g, t in zip(grads, state["sum_of_squares"])]
        ups = [torch.where(t > 0, torch.rsqrt(t + eps), torch.zeros_like(t)) * g
               for g, t in zip(grads, sos)]
        return (_schedule_scale(lr_schedule, state["count"], ups),
                {"count": state["count"] + 1, "sum_of_squares": sos})

    return Transformation(init, update)


def _rmsprop(lr_schedule, eps: float, momentum: Optional[float],
             decay: float = 0.9) -> Transformation:
    def init(params):
        out = {"count": 0, "nu": [torch.zeros_like(p) for p in params]}
        if momentum is not None:
            out["trace"] = [torch.zeros_like(p) for p in params]
        return out

    def update(grads, state, params):
        nu = [(1 - decay) * (g ** 2) + decay * n for g, n in zip(grads, state["nu"])]
        ups = _schedule_scale(lr_schedule, state["count"],
                              [torch.rsqrt(n + eps) * g for g, n in zip(grads, nu)])
        new = {"count": state["count"] + 1, "nu": nu}
        if momentum is not None:
            ups = [u + momentum * t for u, t in zip(ups, state["trace"])]
            new["trace"] = ups
        return ups, new

    return Transformation(init, update)


def _rprop(lr0: float, eta_minus: float = 0.5, eta_plus: float = 1.2,
           min_step: float = 1e-6, max_step: float = 50.0) -> Transformation:
    def init(params):
        return {"step_sizes": [torch.full_like(p, lr0) for p in params],
                "prev_updates": [torch.zeros_like(p) for p in params]}

    def update(grads, state, params):
        steps, prevs, ups = [], [], []
        for g, step, prev in zip(grads, state["step_sizes"], state["prev_updates"]):
            sign = g * prev
            grown = torch.clamp(step * torch.where(sign > 0, eta_plus, eta_minus),
                                min=min_step, max=max_step)
            step = torch.where(sign == 0, step, grown)
            new_prev = torch.where(sign < 0, torch.zeros_like(g), step * torch.sign(g))
            # optax 0.2.6 emits the state's previous step here, not the new
            # one (its update lags a step; the first call moves nothing)
            ups.append(-1.0 * torch.where(sign < 0, torch.zeros_like(prev), prev))
            steps.append(step)
            prevs.append(new_prev)
        return ups, {"step_sizes": steps, "prev_updates": prevs}

    return Transformation(init, update)


def _clip_by_global_norm(inner: Transformation, max_norm: float,
                         grad_norm: Callable) -> Transformation:
    def update(grads, state, params):
        norm = grad_norm(grads, params)
        keep = norm < max_norm
        return inner.update([torch.where(keep, g, g / norm * max_norm) for g in grads],
                            state, params)

    return Transformation(inner.init, update)


def make_optimizer(name: str, lr_schedule: Callable[[int], float], *, weight_decay: float = 0.0,
                   betas: tuple = (0.9, 0.98), eps: float = EPS, momentum: float = MOMENTUM,
                   grad_clip: Optional[float] = None, grad_norm: Optional[Callable] = None,
                   model_group=None) -> Transformation:
    """The JAX package's `make_optimizer`, argument for argument.
    grad_norm(grads, params): the norm that clipping reads (default the
    global norm of `grads`; a tensor-parallel run passes the mesh's norm of
    the full gradients). model_group: the mesh's model group, over which a
    sharded leaf's per-leaf reductions are summed (None: one process)."""
    name = name.lower()
    b1, b2 = betas
    if name == "adamw":
        opt = _adam(lr_schedule, b1, b2, eps, weight_decay)
    elif name == "adam":
        opt = _adam(lr_schedule, b1, b2, eps, None)
    elif name == "sgd":
        opt = _sgd(lr_schedule, momentum)
    elif name == "novograd":
        opt = _novograd(lr_schedule, b1, b2, eps, weight_decay, model_group)
    elif name == "adafactor":
        opt = _adafactor(lr_schedule, model_group)
    elif name == "adadelta":
        opt = _adadelta(lr_schedule, eps)
    elif name == "adamax":
        opt = _adamax(lr_schedule, b1, b2, eps)
    elif name == "adagrad":
        opt = _adagrad(lr_schedule, eps)
    elif name == "rmsprop":
        opt = _rmsprop(lr_schedule, eps, momentum)
    elif name == "rprop":
        # an initial per-weight step size, not a schedule (as the JAX package)
        opt = _rprop(float(lr_schedule(0) if callable(lr_schedule) else lr_schedule))
    else:
        raise ValueError(f"unknown optimizer {name}")
    if grad_clip and grad_clip > 0:
        opt = _clip_by_global_norm(opt, float(grad_clip),
                                   grad_norm or (lambda grads, params: global_norm(grads)))
    return opt


def constant_adamw(lr: float, weight_decay: float) -> Transformation:
    """optax.adamw(lr, weight_decay=...) with optax's defaults (b2 0.999,
    eps 1e-8): the SSL and label models' `fit`."""
    return make_optimizer("adamw", lambda count: lr, weight_decay=weight_decay,
                          betas=(0.9, 0.999), eps=1e-8)


def with_grad_accumulation(opt: Transformation, every: int) -> Transformation:
    """Average the gradients of `every` micro-batches before one update of
    `opt` (optax.MultiSteps); the other calls return zero updates."""
    if every <= 1:
        return opt

    def init(params):
        return {"mini_step": 0, "gradient_step": 0, "inner": opt.init(params),
                "acc": [torch.zeros_like(p) for p in params]}

    def update(grads, state, params):
        n = state["mini_step"]
        acc = [a + (g - a) / (n + 1) for g, a in zip(grads, state["acc"])]
        if n < every - 1:
            return ([torch.zeros_like(g) for g in grads], {**state, "mini_step": n + 1, "acc": acc})
        updates, inner = opt.update(acc, state["inner"], params)
        return updates, {"mini_step": 0, "gradient_step": state["gradient_step"] + 1,
                         "inner": inner, "acc": [torch.zeros_like(a) for a in acc]}

    return Transformation(init, update)


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """params += updates, in place (optax.apply_updates)."""
    for p, u in zip(params, updates):
        p.add_(u.to(p.dtype))
