"""Learning-rate schedules as step -> lr functions (port of
conformer_nemo_tpu/train/lr_schedule.py; closed forms of the reference
registry: NoamAnnealing, CosineAnnealing, InverseSquareRootAnnealing,
WarmupPolicy, SquareAnnealing, SquareRootAnnealing, WarmupAnnealing,
T5InverseSquareRootAnnealing, PolynomialDecayAnnealing,
PolynomialHoldDecayAnnealing, StepLR, ExponentialLR). Pure Python floats;
the optimizer reads the schedule at its pre-increment update count, as
optax does. ReduceLROnPlateau and CyclicLR have no step -> lr form and
raise, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

Schedule = Callable[[int], float]


def noam_annealing(base_lr: float, d_model: int, warmup_steps: int, min_lr: float = 0.0,
                   max_steps: Optional[int] = None) -> Schedule:
    """lr = base * d_model^-0.5 * min(s^-0.5, s * warmup^-1.5), s = max(step, 1);
    the min_lr floor applies after warmup, min_lr past max_steps."""
    normalize = d_model ** (-0.5)

    def schedule(step):
        s = max(float(step), 1.0)
        lr = base_lr * normalize * min(s ** -0.5, s * warmup_steps ** -1.5)
        if s > warmup_steps:
            lr = max(lr, min_lr)
        if max_steps is not None and s > max_steps:
            lr = min_lr
        return lr

    return schedule


def cosine_annealing(base_lr: float, max_steps: int, warmup_steps: int = 0,
                     min_lr: float = 0.0) -> Schedule:
    """Linear warmup, then cosine from base_lr to min_lr."""

    def schedule(step):
        s = float(step)
        if warmup_steps > 0 and s < warmup_steps:
            return base_lr * s / max(warmup_steps, 1)
        t = min(max((s - warmup_steps) / max(max_steps - warmup_steps, 1), 0.0), 1.0)
        return (base_lr - min_lr) * 0.5 * (1 + math.cos(math.pi * t)) + min_lr

    return schedule


def inverse_sqrt_annealing(base_lr: float, warmup_steps: int, min_lr: float = 0.0) -> Schedule:
    def schedule(step):
        s = max(float(step), 1.0)
        if s < warmup_steps:
            return base_lr * s / max(warmup_steps, 1)
        return max(base_lr * warmup_steps ** 0.5 * s ** -0.5, min_lr)

    return schedule


def warmup_policy(anneal: Schedule, base_lr: float, warmup_steps: int = 0,
                  max_steps: Optional[int] = None, min_lr: float = 0.0) -> Schedule:
    """Linear warmup lr = base * (step+1)/(warmup+1) while step <= warmup;
    min_lr past max_steps; `anneal(step)` otherwise."""

    def schedule(step):
        s = float(step)
        if max_steps is not None and s > max_steps:
            return min_lr
        if warmup_steps > 0 and s <= warmup_steps:
            return base_lr * (s + 1.0) / (warmup_steps + 1.0)
        return anneal(s)

    return schedule


def square_annealing(base_lr, max_steps, warmup_steps=0, min_lr=1e-5) -> Schedule:
    """mult = ((D - s')/D)^2, s' = step - warmup, D = max - warmup."""
    d = max(max_steps - warmup_steps, 1)
    return warmup_policy(
        lambda s: max(base_lr * max((d - (s - warmup_steps)) / d, 0.0) ** 2, min_lr),
        base_lr, warmup_steps, max_steps, min_lr)


def squareroot_annealing(base_lr, max_steps, warmup_steps=0, min_lr=0.0) -> Schedule:
    """mult = ((max - step)/max)^0.5 on the raw step."""
    return warmup_policy(
        lambda s: max(base_lr * math.sqrt(max((max_steps - s) / max_steps, 0.0)), min_lr),
        base_lr, warmup_steps, max_steps, min_lr)


def warmup_annealing(base_lr, max_steps, warmup_steps=0, min_lr=0.0) -> Schedule:
    """Linear decay from base_lr to min_lr over (warmup, max]."""
    d = max(max_steps - warmup_steps, 1)
    return warmup_policy(
        lambda s: min_lr + (1.0 - (s - warmup_steps) / d) * (base_lr - min_lr),
        base_lr, warmup_steps, max_steps, min_lr)


def t5_inverse_sqrt_annealing(constant_steps, max_steps, min_lr=0.0) -> Schedule:
    """lr = 1/sqrt(step), held at 1/sqrt(constant_steps) during the constant
    period; the reference ignores base_lr here, and so does this."""
    constant_lr = 1.0 / constant_steps ** 0.5 if constant_steps else 1.0

    def schedule(step):
        s = max(float(step), 1.0)
        if max_steps is not None and s > max_steps:
            return min_lr
        if constant_steps and s <= constant_steps:
            return constant_lr
        return 1.0 / math.sqrt(s)

    return schedule


def polynomial_decay_annealing(base_lr, max_steps, warmup_steps=0, min_lr=0.0, power=1.0,
                               cycle=False, hold_steps=0) -> Schedule:
    """(base - min) * (1 - s'/D)^power + min, s' = step - max(warmup, hold)
    offset as in PolynomialDecayAnnealing / PolynomialHoldDecayAnnealing."""
    offset = hold_steps if hold_steps else warmup_steps
    d0 = max(max_steps - max(warmup_steps, hold_steps), 1)

    def anneal(s):
        sp = s - offset
        if cycle:
            d = d0 * max(math.ceil(sp / d0), 1.0)
        else:
            d = d0
            sp = min(sp, d)
        p = min(max(sp / d, 0.0), 1.0)
        return (base_lr - min_lr) * (1.0 - p) ** power + min_lr

    sched = warmup_policy(anneal, base_lr, warmup_steps, max_steps, min_lr)
    if hold_steps and hold_steps > warmup_steps:
        def held(step):
            s = float(step)
            return base_lr if warmup_steps < s < hold_steps else sched(s)

        return held
    return sched


def step_lr(base_lr, step_size, gamma=0.1) -> Schedule:
    """torch StepLR: lr = base * gamma^(step // step_size)."""
    return lambda step: base_lr * gamma ** math.floor(float(step) / step_size)


def exponential_lr(base_lr, gamma) -> Schedule:
    """torch ExponentialLR: lr = base * gamma^step."""
    return lambda step: base_lr * gamma ** float(step)


def make_lr_schedule(cfg: dict, base_lr: float) -> Schedule:
    """From a reference-shaped `optim.sched` dict."""
    name = cfg.get("name", "NoamAnnealing")
    base_lr = float(base_lr)
    # PyYAML reads a bare '1e-6' as a string: coerce
    min_lr = float(cfg.get("min_lr") or 0.0)
    max_steps = int(cfg["max_steps"]) if cfg.get("max_steps") else None
    if name == "NoamAnnealing":
        warmup = cfg.get("warmup_steps")
        if warmup is None and cfg.get("warmup_ratio") is not None:
            warmup = int(float(cfg["warmup_ratio"]) * max_steps)
        return noam_annealing(base_lr, d_model=int(cfg["d_model"]),
                              warmup_steps=int(warmup or 0) or 1, min_lr=min_lr,
                              max_steps=max_steps)
    if name == "CosineAnnealing":
        return cosine_annealing(base_lr, max_steps=max_steps,
                                warmup_steps=int(cfg.get("warmup_steps") or 0), min_lr=min_lr)
    if name == "InverseSquareRootAnnealing":
        return inverse_sqrt_annealing(base_lr, warmup_steps=int(cfg.get("warmup_steps") or 1),
                                      min_lr=min_lr)
    warmup = int(cfg.get("warmup_steps") or 0)
    if warmup == 0 and cfg.get("warmup_ratio") is not None and max_steps:
        warmup = int(float(cfg["warmup_ratio"]) * max_steps)
    if name == "WarmupPolicy":
        return warmup_policy(lambda s: base_lr, base_lr, warmup, max_steps, min_lr)
    if name == "SquareAnnealing":
        return square_annealing(base_lr, max_steps, warmup, min_lr=float(cfg.get("min_lr") or 1e-5))
    if name == "SquareRootAnnealing":
        return squareroot_annealing(base_lr, max_steps, warmup, min_lr)
    if name == "WarmupAnnealing":
        return warmup_annealing(base_lr, max_steps, warmup, min_lr)
    if name == "T5InverseSquareRootAnnealing":
        return t5_inverse_sqrt_annealing(int(cfg.get("constant_steps") or 0), max_steps, min_lr)
    if name in ("PolynomialDecayAnnealing", "PolynomialHoldDecayAnnealing"):
        return polynomial_decay_annealing(
            base_lr, max_steps, warmup, min_lr, power=float(cfg.get("power") or 1.0),
            cycle=bool(cfg.get("cycle", False)),
            hold_steps=int(cfg.get("hold_steps") or 0)
            if name == "PolynomialHoldDecayAnnealing" else 0)
    if name == "StepLR":
        return step_lr(base_lr, int(cfg.get("step_size") or 1),
                       gamma=float(cfg.get("gamma") or 0.1))
    if name == "ExponentialLR":
        return exponential_lr(base_lr, float(cfg.get("gamma") or 0.9))
    if name in ("ReduceLROnPlateau", "CyclicLR"):
        raise ValueError(f"{name} is metric-driven/stateful and has no pure step->lr form; "
                         "use a closed-form scheduler from this registry")
    raise ValueError(f"unknown scheduler {name}")
