"""Tensor contracts: rank, axis-letter consistency and dtype kind, checked on
each call (port of conformer_nemo_tpu/utils/typecheck.py; NeMo's
typecheck / NeuralType role).

    @typecheck(audio=("B", "T"), lengths=("B",), outputs=(("B", "D", "F"), ("B",)))
    def log_mel(audio, lengths): ...

Axis entries: a letter binds an extent, and every use of the same letter in
one call must match; an int is an exact extent; None is any extent.
`Spec(axes, dtype=...)` adds a dtype: a torch or numpy dtype (equality), or
a numpy kind class (`np.floating`, `np.integer`, ...). The checks read
`.shape` and `.dtype` only: no host read of a CUDA tensor, no launch.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Any, Optional, Sequence

import numpy as np
import torch

__all__ = ["Spec", "typecheck", "check_shapes", "TypecheckError"]


class TypecheckError(TypeError):
    """Raised when a tensor fails its declared axis contract."""


@dataclasses.dataclass(frozen=True)
class Spec:
    """Axis contract for one tensor: `Spec(("B", "T"), dtype=np.floating)`."""

    axes: tuple
    dtype: Any = None


def _as_spec(s) -> Optional[Spec]:
    if s is None:
        return None
    if isinstance(s, Spec):
        return s
    return Spec(tuple(s))


# the numpy kind of each torch dtype class
_TORCH_KINDS = ((lambda d: d.is_floating_point, np.floating),
                (lambda d: d.is_complex, np.complexfloating),
                (lambda d: d == torch.bool, np.bool_),
                (lambda d: not (d.is_floating_point or d.is_complex or d == torch.bool),
                 np.integer))


def _dtype_ok(dt, want) -> bool:
    if isinstance(dt, torch.dtype):
        if isinstance(want, torch.dtype):
            return dt == want
        if inspect.isclass(want):
            return any(is_kind(dt) and issubclass(kind, want) for is_kind, kind in _TORCH_KINDS)
        return False
    dt = np.dtype(dt)
    if isinstance(want, torch.dtype):
        return False
    return np.issubdtype(dt, want) if inspect.isclass(want) else dt == np.dtype(want)


def _check_one(name: str, value, spec: Spec, env: dict) -> None:
    shape = getattr(value, "shape", None)
    if shape is None:
        raise TypecheckError(f"{name}: expected an array with axes {spec.axes}, got {type(value)}")
    if len(shape) != len(spec.axes):
        raise TypecheckError(
            f"{name}: rank {len(shape)} (shape {tuple(shape)}) does not match axes {spec.axes}")
    for dim, ax in zip(shape, spec.axes):
        if ax is None:
            continue
        if isinstance(ax, int):
            if dim != ax:
                raise TypecheckError(
                    f"{name}: axis with fixed extent {ax} has extent {dim} (shape {tuple(shape)})")
            continue
        bound = env.setdefault(ax, (dim, name))
        if bound[0] != dim:
            raise TypecheckError(
                f"{name}: axis '{ax}' has extent {dim} but was bound to {bound[0]} by {bound[1]!r}")
    if spec.dtype is not None:
        dt = getattr(value, "dtype", None)
        if not _dtype_ok(dt, spec.dtype):
            raise TypecheckError(f"{name}: dtype {dt} does not satisfy {spec.dtype}")


def check_shapes(env: Optional[dict] = None, **named) -> dict:
    """Imperative form: `check_shapes(audio=(wav, ("B", "T")), lens=(lengths, ("B",)))`.
    -> the axis bindings, so that chained calls share letters."""
    env = env if env is not None else {}
    for name, (value, spec) in named.items():
        _check_one(name, value, _as_spec(spec), env)
    return env


def typecheck(outputs=None, **arg_specs):
    """Decorator: axis contracts on named arguments and, optionally, the
    outputs (one axis tuple / Spec, or a tuple of them matching a returned
    tuple). Arguments given as None are not checked."""
    out_specs: Optional[Sequence] = None
    if outputs is not None:
        if isinstance(outputs, Spec) or (
                isinstance(outputs, (tuple, list)) and outputs
                and isinstance(outputs[0], (str, int, type(None)))):
            out_specs = (outputs,)
        else:
            out_specs = tuple(outputs)

    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            env: dict = {}
            for name, spec in arg_specs.items():
                if name in bound.arguments and bound.arguments[name] is not None:
                    _check_one(name, bound.arguments[name], _as_spec(spec), env)
            result = fn(*args, **kwargs)
            if out_specs is not None:
                outs = result if isinstance(result, tuple) else (result,)
                for i, (value, spec) in enumerate(zip(outs, out_specs)):
                    if spec is not None:
                        _check_one(f"output[{i}]", value, _as_spec(spec), env)
            return result

        return wrapped

    return deco
