"""The JAX package's resumable checkpoint, `step_N/state.msgpack`, read into
and written from the port's train state.

The file is flax's `serialization.to_bytes` of the JAX `TrainState`
(conformer_nemo_tpu/train/trainer.py): `step`, `params`, `batch_stats`,
`opt_state` (optax's state tree: tuples as {"0": ...}, named tuples by
field, empty states as {}) and `rng` (a threefry key, two uint32 words).
convert/flax_msgpack.py reads and writes the bytes.

Parameters and every per-parameter moment go through one index map per
port parameter (`param_index`), made by pushing index arrays through the
weight bridge (convert/jax_params.py) with forget_gate_bias taken as 0:
entry j of the port tensor is entry index[j] of its JAX leaf, whatever
transposes and row permutations the bridge applies, and the port's LSTM
bias leaf is the JAX leaf itself (models/rnnt.py). adafactor's factored
moments (kept by the port with the reduced axis as size 1) map through the
same index, with the axis correspondence telling which of JAX's v_row and
v_col each one is. BatchNorm statistics go through the bridge as they are.

The optimizer state is optax's chain for the configured optimizer
(train/optim.py), inside `clip_by_global_norm`'s chain when clipping is
set and inside `MultiSteps` (mini_step, gradient_step, acc_grads) when
gradients accumulate. The port keeps one count where optax keeps the
transformation's and the learning-rate schedule's (equal: both advance
every update); the step count of the state goes across as it is.

The random streams cannot cross: the JAX key is threefry, the port's a
CPU torch generator. The rule: a JAX key (k0, k1) seeds the port's
generator with k0 * 2^32 + k1; the port's generator gives the key the two
uint32 words it would draw next (from a copy, so the live generator does
not move). A crossed run is therefore exact for everything but its random
draws (dither, SpecAugment, dropout).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np
import torch

from conformer_nemo_tpu_torch.convert import flax_msgpack
from conformer_nemo_tpu_torch.convert.jax_params import (
    ctc_state_dict_from_jax,
    ctc_variables_to_jax,
    rnnt_state_dict_from_jax,
    rnnt_variables_to_jax,
)
from conformer_nemo_tpu_torch.train.optim import factored_dims

STATE_FILE = "state.msgpack"
_LSTM_BIAS = re.compile(r"^(.*)\.bias_l(\d+)$")


@dataclasses.dataclass
class LeafIndex:
    """Where a port parameter's entries lie in its JAX leaf."""

    path: tuple  # the leaf's keys in the JAX params tree
    shape: tuple  # the JAX leaf's shape
    index: torch.Tensor  # int64, the port's shape: flat JAX offsets
    axes: tuple  # port axis -> the JAX axis along which it runs (None: size 1)


def _family(model) -> str:
    return "rnnt" if hasattr(model, "joint") else "ctc"


def _bridge(family: str, cfg):
    """(to_jax, from_jax, the config with no forget-gate constant)."""
    if family == "ctc":
        return ctc_variables_to_jax, ctc_state_dict_from_jax, cfg
    dec = dataclasses.replace(cfg.decoder, forget_gate_bias=0.0)
    return rnnt_variables_to_jax, rnnt_state_dict_from_jax, dataclasses.replace(cfg, decoder=dec)


def _leaves(tree: dict, prefix: tuple = ()) -> list:
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _leaves(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]
    return out


def _rebuild(leaves: list) -> dict:
    tree: dict = {}
    for path, v in leaves:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _sd_key(name: str, sd: dict) -> str:
    m = _LSTM_BIAS.match(name)
    return f"{m.group(1)}.bias_ih_l{m.group(2)}" if m and name not in sd else name


def param_index(model) -> dict:
    """{port parameter name: LeafIndex} for the model's JAX params tree."""
    to_jax, from_jax, cfg0 = _bridge(_family(model), model.cfg)
    params = to_jax(model.state_dict(), cfg0)["params"]
    leaves = _leaves(params)
    for _, x in leaves:
        if x.size >= 1 << 24:
            raise ValueError(f"a leaf of {x.size} entries is past float32's exact integers")
    ids = from_jax({"params": _rebuild([(p, np.full(np.shape(x), i, np.float32))
                                        for i, (p, x) in enumerate(leaves)])}, cfg0)
    pos = from_jax({"params": _rebuild([(p, np.arange(np.size(x), dtype=np.float32)
                                         .reshape(np.shape(x))) for p, x in leaves])}, cfg0)
    out = {}
    for name, p in model.named_parameters():
        key = _sd_key(name, ids)
        lo, hi = torch.aminmax(ids[key])
        if lo != hi:
            raise ValueError(f"{name}: entries from more than one JAX leaf")
        path, x = leaves[int(lo)]
        index = pos[key].to(torch.int64).reshape(p.shape)
        out[name] = LeafIndex(path, tuple(np.shape(x)), index, _axes(index, tuple(np.shape(x))))
    return out


def _axes(index: torch.Tensor, jax_shape: tuple) -> tuple:
    """Port axis k -> the JAX axis that moves when k does."""
    out = []
    origin = np.unravel_index(int(index.reshape(-1)[0]), jax_shape)
    for k, n in enumerate(index.shape):
        if n == 1:
            out.append(None)
            continue
        step = np.unravel_index(int(index.select(k, 1).reshape(-1)[0]), jax_shape)
        moved = [a for a in range(len(jax_shape)) if step[a] != origin[a]]
        if len(moved) != 1:
            raise ValueError(f"port axis {k} moves JAX axes {moved}")
        out.append(moved[0])
    return tuple(out)


# -- one tensor across ----------------------------------------------------------


def _to_port(leaf: np.ndarray, li: LeafIndex, dtype, device) -> torch.Tensor:
    flat = torch.from_numpy(np.ascontiguousarray(leaf, dtype=np.float32).reshape(-1))
    return flat[li.index].to(device=device, dtype=dtype)


def _to_jax(t: torch.Tensor, li: LeafIndex) -> np.ndarray:
    out = torch.zeros(int(np.prod(li.shape)), dtype=torch.float32)
    out.index_copy_(0, li.index.reshape(-1), t.detach().to("cpu", torch.float32).reshape(-1))
    return out.reshape(li.shape).numpy()


def _factored_index(li: LeafIndex, port_axis: int) -> tuple:
    """The port moment reduced over `port_axis` (size 1 there) -> (which
    JAX vector, "v_row" or "v_col", and the flat offsets into it)."""
    d1, d0 = factored_dims(li.shape)
    a = li.axes[port_axis]
    which = {d0: "v_row", d1: "v_col"}.get(a)
    if which is None:
        raise ValueError(f"port axis {port_axis} is JAX axis {a}, not a factored one")
    multi = np.unravel_index(li.index.narrow(port_axis, 0, 1).reshape(-1).numpy(), li.shape)
    reduced = tuple(s for i, s in enumerate(li.shape) if i != a)
    flat = np.ravel_multi_index(tuple(m for i, m in enumerate(multi) if i != a), reduced)
    return which, torch.from_numpy(flat.astype(np.int64)), reduced


# -- the optimizer state -----------------------------------------------------------

# the fields of each position of an optimizer's optax chain (an empty
# state has none); "count" is the port's count, the schedule's too. adamax
# and novograd keep adam's layout (novograd's nu a scalar a leaf)
_CHAINS = {
    "adamw": [("count", "mu", "nu"), (), ("count",)],
    "adam": [("count", "mu", "nu"), ("count",)],
    "sgd": [("trace",), ("count",)],
    "adafactor": [("count", "v_row", "v_col", "v"), (), ("count",), (), ()],
    "adadelta": [(), ("e_g", "e_x"), ("count",)],
    "adagrad": [("sum_of_squares",), ("count",)],
    "rmsprop": [("nu",), ("count",), ("trace",)],
    "rprop": [("step_sizes", "prev_updates"), ()],
}
_LAYOUT = {"adamax": "adam", "novograd": "adam"}


def _chain_to_port(node: dict, chain: list, indices: list, like: dict) -> dict:
    """optax's state of one optimizer -> the port's, shaped as `like` (the
    port optimizer's own state of the same parameters)."""
    out = {}
    for pos, fields in enumerate(chain):
        for field in fields:
            value = node[str(pos)][field]
            if field == "count":
                out["count"] = int(np.asarray(value))
            elif field in ("v_row", "v_col"):
                out[field] = [_factored_to_port(node["0"], li, t)
                              for li, t in zip(indices, like[field])]
            else:
                out[field] = _tree_to_port(value, indices, like[field])
    return out


def _tree_to_port(tree: dict, indices: list, like: list) -> list:
    leaves = dict(_leaves(tree))
    out = []
    for li, t in zip(indices, like):
        leaf = np.asarray(leaves[li.path], np.float32)
        if t.shape == li.index.shape:
            out.append(_to_port(leaf, li, t.dtype, t.device))
        else:  # a scalar a leaf (novograd's nu) or adafactor's placeholder
            out.append(torch.from_numpy(leaf.copy()).reshape(t.shape).to(t.device, t.dtype))
    return out


def _factored_to_port(node: dict, li: LeafIndex, like: torch.Tensor) -> torch.Tensor:
    """adafactor's moment of one leaf, reduced over the port axis that is
    size 1 in `like`, from JAX's v_row or v_col (a placeholder as it is)."""
    if like.numel() == 1 and like.dim() == 1:  # not factored
        vec = np.asarray(dict(_leaves(node["v_row"]))[li.path], np.float32)
        return torch.from_numpy(vec.copy()).reshape(like.shape).to(like.device, like.dtype)
    axis = [k for k in range(like.dim()) if like.shape[k] == 1 and li.index.shape[k] > 1][0]
    which, flat, _ = _factored_index(li, axis)
    src = np.asarray(dict(_leaves(node[which]))[li.path], np.float32).reshape(-1)
    return torch.from_numpy(src[flat.numpy()]).reshape(like.shape).to(like.device, like.dtype)


def _chain_to_jax(state: dict, chain: list, indices: list) -> dict:
    node: dict = {str(pos): {} for pos in range(len(chain))}
    for pos, fields in enumerate(chain):
        for field in fields:
            if field == "count":
                node[str(pos)][field] = np.asarray(state.get("count", 0), np.int32)
            elif field not in ("v_row", "v_col"):
                node[str(pos)][field] = _tree_to_jax(state[field], indices)
    if "v_row" in chain[0]:
        rows, cols = [], []
        for li, vr, vc in zip(indices, state["v_row"], state["v_col"]):
            r, c = _factored_to_jax(li, vr, vc)
            rows.append((li.path, r))
            cols.append((li.path, c))
        node["0"]["v_row"], node["0"]["v_col"] = _rebuild(rows), _rebuild(cols)
    return node


def _tree_to_jax(tensors: list, indices: list) -> dict:
    out = []
    for li, t in zip(indices, tensors):
        if t.shape == li.index.shape:
            out.append((li.path, _to_jax(t, li)))
        else:
            arr = t.detach().to("cpu", torch.float32).numpy()
            out.append((li.path, arr.reshape(()) if t.dim() == 0 else arr.copy()))
    return _rebuild(out)


def _factored_to_jax(li: LeafIndex, vr: torch.Tensor, vc: torch.Tensor) -> tuple:
    if vr.numel() == 1 and vr.dim() == 1:  # not factored
        return vr.detach().cpu().float().numpy().copy(), vc.detach().cpu().float().numpy().copy()
    out = {}
    for t in (vr, vc):
        axis = [k for k in range(t.dim()) if t.shape[k] == 1 and li.index.shape[k] > 1][0]
        which, flat, reduced = _factored_index(li, axis)
        vec = np.zeros(int(np.prod(reduced)), np.float32)
        vec[flat.numpy()] = t.detach().to("cpu", torch.float32).reshape(-1).numpy()
        out[which] = vec.reshape(reduced)
    return out["v_row"], out["v_col"]


def _chain_of(node: dict) -> list:
    """The chain whose layout optax state `node` has."""
    got = [set(node[str(pos)]) for pos in range(len(node))]
    for chain in _CHAINS.values():
        if got == [set(fields) for fields in chain]:
            return chain
    raise ValueError(f"an optax state this port does not know: {got}")


def _unwrap(opt_state: dict) -> tuple:
    """JAX opt_state -> (MultiSteps node or None, clipped?, inner chain)."""
    multi = opt_state if "mini_step" in opt_state else None
    inner = opt_state["inner_opt_state"] if multi is not None else opt_state
    clipped = (set(inner) == {"0", "1"} and inner["0"] == {} and isinstance(inner["1"], dict)
               and "0" in inner["1"])
    return multi, clipped, inner["1"] if clipped else inner


def opt_state_to_port(opt_state: dict, indices: list, like: dict) -> dict:
    """The JAX opt_state -> the port's, shaped as `like` (the state the
    port's optimizer of the same config made)."""
    multi, _, inner = _unwrap(opt_state)
    port_inner = like["inner"] if multi is not None else like
    out = _chain_to_port(inner, _chain_of(inner), indices, port_inner)
    if set(out) != set(port_inner):
        raise ValueError(f"the checkpoint's optimizer state {sorted(out)} is not this "
                         f"optimizer's {sorted(port_inner)}")
    if multi is None:
        return out
    return {"mini_step": int(np.asarray(multi["mini_step"])),
            "gradient_step": int(np.asarray(multi["gradient_step"])), "inner": out,
            "acc": _tree_to_port(multi["acc_grads"], indices, like["acc"])}


def opt_state_to_jax(state: dict, indices: list, name: str, clipped: bool) -> dict:
    """The port's optimizer state -> optax's tree for `name` (wrapped in
    clipping's chain when `clipped`, in MultiSteps when the port state
    accumulates)."""
    multi = "mini_step" in state
    inner_state = state["inner"] if multi else state
    name = name.lower()
    node = _chain_to_jax(inner_state, _CHAINS[_LAYOUT.get(name, name)], indices)
    if clipped:
        node = {"0": {}, "1": node}
    if not multi:
        return node
    return {"mini_step": np.asarray(state["mini_step"], np.int32),
            "gradient_step": np.asarray(state["gradient_step"], np.int32),
            "inner_opt_state": node, "acc_grads": _tree_to_jax(state["acc"], indices),
            "skip_state": {}}


# -- the random stream ---------------------------------------------------------------


def generator_from_key(key) -> torch.Generator:
    """A JAX key's two uint32 words (k0, k1) seed a CPU generator with
    k0 * 2^32 + k1 (bit 63 cleared: torch seeds are below 2^63)."""
    k0, k1 = (int(w) for w in np.asarray(key, np.uint32).reshape(-1)[:2])
    return torch.Generator().manual_seed(((k0 << 32) | k1) & ((1 << 63) - 1))


def key_from_generator(gen: torch.Generator) -> np.ndarray:
    """The two uint32 words a copy of `gen` draws next, as a JAX key."""
    copy = torch.Generator()
    copy.set_state(gen.get_state())
    return torch.randint(0, 1 << 32, (2,), generator=copy, dtype=torch.int64).numpy().astype(
        np.uint32)


# -- whole files ----------------------------------------------------------------------


def _index_list(model) -> list:
    index = param_index(model)
    return [index[name] for name, _ in model.named_parameters()]


def read_train_state(path: str, state) -> None:
    """Load `path` (a state.msgpack) into the port's train state in place:
    parameters, BatchNorm statistics, optimizer state, step and the
    generator (by the rule above). The port's optimizer must be the
    checkpoint's (its state's layout is checked)."""
    with open(path, "rb") as f:
        tree = flax_msgpack.loads(f.read())
    model = state.model
    family = _family(model)
    _, from_jax, _ = _bridge(family, model.cfg)
    indices = _index_list(model)
    params = dict(_leaves(tree["params"]))
    sd = from_jax({"params": tree["params"], "batch_stats": tree.get("batch_stats") or {}},
                  model.cfg)
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        for (name, p), li in zip(model.named_parameters(), indices):
            p.copy_(_to_port(np.asarray(params[li.path]), li, p.dtype, p.device))
    state.opt_state = opt_state_to_port(tree["opt_state"], indices, state.opt_state)
    state.step = int(np.asarray(tree["step"]))
    state.generator = generator_from_key(tree["rng"])


def train_state_tree(state, optim_name: str, grad_clip: Optional[float]) -> dict:
    """The JAX TrainState tree (numpy leaves) of the port's train state; the
    optimizer's name and clipping come from the config (the port's state
    does not say whether adamw decays or clipping is on)."""
    model = state.model
    to_jax, _, _ = _bridge(_family(model), model.cfg)
    indices = _index_list(model)
    variables = to_jax(model.state_dict(), model.cfg)
    leaves = {li.path: _to_jax(p, li) for (name, p), li in zip(model.named_parameters(), indices)}
    params = _rebuild([(path, leaves.get(path, v)) for path, v in _leaves(variables["params"])])
    return {"step": np.asarray(state.step, np.int32), "params": params,
            "batch_stats": variables.get("batch_stats", {}),
            "opt_state": opt_state_to_jax(state.opt_state, indices, optim_name,
                                          bool(grad_clip and grad_clip > 0)),
            "rng": key_from_generator(state.generator)}


def write_train_state(path: str, state, optim_name: str, grad_clip: Optional[float]) -> None:
    with open(path, "wb") as f:
        f.write(flax_msgpack.dumps(train_state_tree(state, optim_name, grad_clip)))
