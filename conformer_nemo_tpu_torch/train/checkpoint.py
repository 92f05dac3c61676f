"""Checkpoints: resumable train state and the portable `.cntpu` archive
(port of conformer_nemo_tpu/train/checkpoint.py).

Resumable state keeps the JAX package's layout: `ckpt_dir/step_N/` holds the
state file and `meta.json` (`step`, `metrics`); `ckpt_dir/last` names the
newest; pruning keeps the top k by a monitored metric and `last`. The state
file is the port's own (`state.pt`, `torch.save`): the model's state_dict
(parameters and BatchNorm statistics), the trained leaves that the
state_dict writes under other names (`leaves`: the LSTM bias), the
optimizer state, the train state's CPU generator (`get_state()`) and the
step. Each step's seeds come
from that generator and the LR schedule reads the optimizer's count, so a
restored run continues bit for bit.

The train step updates parameters and Adam moments in place, so an async
save copies every tensor to the host on the calling thread before it
returns; only the write runs on the background thread (one worker: saves
stay ordered and `last` only moves forward).

Across ranks a save is collective, as the JAX package's is: every rank
calls it, the tensor-parallel shards are gathered to full NeMo-layout
tensors (parallel/sharding.py), rank 0 alone copies them to the host and
writes, and the synchronous save leaves through a barrier. A restore
waits at a barrier, loads the full state and cuts it to the live layout,
so a checkpoint written at dp x tp resumes at world 1, and the reverse.

A step directory that holds the JAX package's `state.msgpack` and no
`state.pt` restores through convert/jax_train_state.py, so
`resume_from_checkpoint` and `resume_if_exists` resume a JAX run
(scripts/convert_checkpoint.py writes the other direction).

The portable archive is the JAX package's: a tar.gz of `model_config.yaml`,
`model_weights.msgpack` (flax's msgpack tree, convert/flax_msgpack.py),
`artifacts.json` and the artifact files, so either package restores the
other's.
"""

from __future__ import annotations

import json
import os
import shutil
import tarfile
import tempfile
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Optional

import torch
import yaml

from conformer_nemo_tpu_torch.convert import flax_msgpack, jax_train_state
from conformer_nemo_tpu_torch.parallel.distributed import barrier, is_main_process
from conformer_nemo_tpu_torch.parallel.sharding import (
    full_state_dict,
    gather_opt_state,
    shard_opt_state,
    shard_state_dict,
    tp_of,
)

STATE_FILE = "state.pt"

# ---------------------------------------------------------------------------
# Resumable train-state checkpoints
# ---------------------------------------------------------------------------


def _map_tensors(obj: Any, fn) -> Any:
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


def _host_copy(state) -> Optional[dict]:
    """The train state as full host tensors that nothing else holds: a copy
    made now, on this thread, so later in-place steps cannot reach it.
    Collective for a tensor-parallel model (every rank gathers); rank 0
    alone copies, the others get None."""
    model_sd = full_state_dict(state.model)
    opt_state = gather_opt_state(state.opt_state, state.model)
    if not is_main_process():
        return None
    payload = {"model": model_sd, "opt_state": opt_state,
               "generator": state.generator.get_state(), "step": int(state.step),
               "leaves": unsaved_leaves(state.model, model_sd)}
    return _map_tensors(payload, lambda t: t.detach().to("cpu", copy=True))


def unsaved_leaves(model, model_sd: dict) -> dict:
    """The trained parameters that the state_dict carries under other
    names (the LSTM's bias leaf, written as NeMo's bias pair, whose sum
    less c need not give the leaf back bit for bit), by parameter name.
    They are replicated under tensor parallelism."""
    return {name: p.detach() for name, p in model.named_parameters() if name not in model_sd}


def load_leaves(model, leaves: dict) -> None:
    """Put `unsaved_leaves` back after the state_dict is loaded."""
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, t in leaves.items():
            params[name].copy_(t)


def _write_train_state(ckpt_dir: str, payload: dict, step: int,
                       metrics: Optional[dict]) -> str:
    path = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(path, exist_ok=True)
    torch.save(payload, os.path.join(path, STATE_FILE))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": step, "metrics": metrics or {}}, f)
    with open(os.path.join(ckpt_dir, "last"), "w") as f:
        f.write(f"step_{step}")
    return path


def save_train_state(ckpt_dir: str, state, step: int, metrics: Optional[dict] = None) -> str:
    """Write the train state to ckpt_dir/step_{step}/ and point `last` at it
    (collective across ranks: rank 0 writes, every rank leaves together)."""
    payload = _host_copy(state)
    path = os.path.join(ckpt_dir, f"step_{step}")
    if payload is not None:
        path = _write_train_state(ckpt_dir, payload, step, metrics)
    barrier()
    return path


_SAVE_POOL: Optional[ThreadPoolExecutor] = None


def _save_pool() -> ThreadPoolExecutor:
    global _SAVE_POOL
    if _SAVE_POOL is None:
        _SAVE_POOL = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-save")
    return _SAVE_POOL


def save_train_state_async(ckpt_dir: str, state, step: int, metrics: Optional[dict] = None,
                           then: Optional[Callable[[], None]] = None) -> Future:
    """The host copy now (it returns only once every tensor is on the host),
    the write on the background thread, then `then()` on that thread (the
    experiment manager's pruning), so the Future resolves after both.
    Across ranks the gather is collective and rank 0 alone writes; the
    others get a resolved Future. -> a Future of the path."""
    payload = _host_copy(state)
    if payload is None:
        done: Future = Future()
        done.set_result(os.path.join(ckpt_dir, f"step_{step}"))
        return done

    def write() -> str:
        path = _write_train_state(ckpt_dir, payload, step, metrics)
        if then is not None:
            then()
        return path

    return _save_pool().submit(write)


def restore_train_state(ckpt_dir: str, state, step: Optional[int] = None):
    """Load a checkpoint into `state` in place (step None: `last`), tensors
    onto the device of the model's parameters, cut to the model's
    tensor-parallel slices where it has them. Every rank waits at a
    barrier first, so that none reads before the writer is done. ->
    (state, meta), or (None, None) when the directory has no `last`."""
    barrier()
    if step is None:
        last = os.path.join(ckpt_dir, "last")
        if not os.path.exists(last):
            return None, None
        with open(last) as f:
            name = f.read().strip()
    else:
        name = f"step_{step}"
    path = os.path.join(ckpt_dir, name)
    if not os.path.exists(os.path.join(path, STATE_FILE)) and os.path.exists(
            os.path.join(path, jax_train_state.STATE_FILE)):
        return _restore_jax_state(path, state)
    payload = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    tp = tp_of(state.model)
    state.model.load_state_dict(shard_state_dict(payload["model"], tp), strict=True)
    load_leaves(state.model, payload.get("leaves", {}))
    dev = next(state.model.parameters()).device
    state.opt_state = _map_tensors(shard_opt_state(payload["opt_state"], state.model, tp),
                                   lambda t: t.to(dev))
    state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return state, meta


def _restore_jax_state(path: str, state):
    """A step directory the JAX package wrote (state.msgpack): its train
    state read into the port's (convert/jax_train_state.py), onto the
    model's full tensors; `fit` cuts it to a mesh's slices afterwards."""
    if tp_of(state.model) is not None:
        raise ValueError("a JAX checkpoint restores into the full model, before it is sharded")
    jax_train_state.read_train_state(os.path.join(path, jax_train_state.STATE_FILE), state)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return state, meta


def list_checkpoints(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        mpath = os.path.join(ckpt_dir, name, "meta.json")
        if name.startswith("step_") and os.path.exists(mpath):
            with open(mpath) as f:
                out.append((name, json.load(f)))
    return sorted(out, key=lambda x: x[1]["step"])


def prune_checkpoints(ckpt_dir: str, save_top_k: int, monitor: str = "val_wer",
                      mode: str = "min") -> None:
    """Keep the top k by the monitored metric, and the `last` checkpoint."""
    ckpts = list_checkpoints(ckpt_dir)
    scored = [(name, meta["metrics"].get(monitor)) for name, meta in ckpts
              if meta["metrics"].get(monitor) is not None]
    scored.sort(key=lambda x: x[1], reverse=mode == "max")
    keep = {name for name, _ in scored[:save_top_k]}
    last = None
    last_path = os.path.join(ckpt_dir, "last")
    if os.path.exists(last_path):
        with open(last_path) as f:
            last = f.read().strip()
    for name, _meta in ckpts:
        if name not in keep and name != last:
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


# ---------------------------------------------------------------------------
# Portable archive (.cntpu)
# ---------------------------------------------------------------------------


def save_portable(out_path: str, config: dict, variables: Any,
                  artifacts: Optional[dict] = None) -> None:
    """tar.gz of model_config.yaml, model_weights.msgpack (the JAX package's
    variables tree, numpy or CPU tensors), artifacts.json and the artifact
    files (stored under their base names). A SentencePiece model given as
    the artifact "tokenizer_model" is stored as tokenizer.model, and the
    archived tokenizer config drops its model_file and dir: either package
    then builds the tokenizer from the extracted archive (its `dir` rule),
    not from a path of the machine that wrote it. An aggregate tokenizer's
    languages are given as the artifacts "tokenizer_<lang>.model" (every
    language's), stored flat under those names, and the archived config
    points each language's `model_file` at its base name: the JAX package's
    rule for multilang archives."""
    names = {key: os.path.basename(src) for key, src in (artifacts or {}).items()}
    tok = (config.get("model") or {}).get("tokenizer")
    if "tokenizer_model" in names:
        names["tokenizer_model"] = "tokenizer.model"
        if tok:
            tok = {k: v for k, v in tok.items() if k not in ("model_file", "dir")}
    elif tok and tok.get("type") == "agg" and names:
        langs = {}
        for lang, sub in tok["langs"].items():
            key = f"tokenizer_{lang}.model"
            if key not in names:
                raise ValueError(f"an aggregate tokenizer's archive needs the artifact {key!r}")
            names[key] = key
            langs[lang] = {"type": (sub or {}).get("type", "bpe"), "model_file": key}
        tok = {"type": "agg", "langs": langs}
    if tok is not None:
        config = {**config, "model": {**config["model"], "tokenizer": tok}}
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "model_config.yaml"), "w") as f:
            yaml.safe_dump(config, f)
        with open(os.path.join(tmp, "model_weights.msgpack"), "wb") as f:
            f.write(flax_msgpack.dumps(variables))
        for key, src in (artifacts or {}).items():
            shutil.copy(src, os.path.join(tmp, names[key]))
        with open(os.path.join(tmp, "artifacts.json"), "w") as f:
            json.dump(names, f)
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with tarfile.open(out_path, "w:gz") as tar:
            for name in os.listdir(tmp):
                tar.add(os.path.join(tmp, name), arcname=name)


def load_portable(path: str, extract_dir: Optional[str] = None):
    """-> (config dict, variables tree of numpy leaves, {artifact key:
    extracted path})."""
    tmp = extract_dir or tempfile.mkdtemp(prefix="cntpu_")
    with tarfile.open(path, "r:gz") as tar:
        tar.extractall(tmp, filter="data")
    with open(os.path.join(tmp, "model_config.yaml")) as f:
        config = yaml.safe_load(f)
    with open(os.path.join(tmp, "model_weights.msgpack"), "rb") as f:
        variables = flax_msgpack.loads(f.read())
    artifacts = {}
    art_json = os.path.join(tmp, "artifacts.json")
    if os.path.exists(art_json):
        with open(art_json) as f:
            artifacts = {k: os.path.join(tmp, v) for k, v in json.load(f).items()}
    return config, variables, artifacts
