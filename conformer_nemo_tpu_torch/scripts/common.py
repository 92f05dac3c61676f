"""Shared CLI plumbing (port of scripts/common.py): Hydra-style dotted
overrides on argv, the experiment manager from the config's `exp_manager`
section, and the training entry points' common body.

    a.b=1  +c.d=x  flag=true  x=null  lr=0.5  name=run

set `a.b` to 1, `c.d` to "x" (a leading + is dropped), true/false to
booleans, null/none to None, and ints and floats to numbers; every other
argument goes to argparse. Every entry point runs on CUDA unless given
`--device cpu`.

The training scripts run one process per GPU under a launcher:

    torchrun --nproc-per-node 8 -m conformer_nemo_tpu_torch.scripts.speech_to_text_ctc \
        --config configs/conformer_ctc_bpe.yaml trainer.mesh.data=-1 ...

Each process joins the process group (parallel/distributed.py, from the
launcher's MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK/LOCAL_RANK) before it
builds its model on cuda:LOCAL_RANK; only rank 0 prints the result and
writes the archive.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Optional, Sequence


def parse_overrides(argv):
    """['a.b=1', '+c.d=x'] -> ({'a.b': 1, 'c.d': 'x'}, leftover_args)."""
    overrides, leftover = {}, []
    for arg in argv:
        if "=" in arg and not arg.startswith("-"):
            key, _, val = arg.partition("=")
            overrides[key.lstrip("+")] = _coerce(val)
        else:
            leftover.append(arg)
    return overrides, leftover


def _coerce(val: str):
    low = val.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none"):
        return None
    for cast in (int, float):
        try:
            return cast(val)
        except ValueError:
            pass
    return val


def build_exp_manager(raw_cfg: dict):
    """The config's `exp_manager` section -> an ExperimentManager, or None
    when it neither checkpoints nor names an exp_dir."""
    from conformer_nemo_tpu_torch.train.exp_manager import ExpManagerConfig, ExperimentManager

    em = raw_cfg.get("exp_manager") or {}
    if not em.get("create_checkpoint_callback", True) and not em.get("exp_dir"):
        return None
    cb = em.get("checkpoint_callback_params") or {}
    return ExperimentManager(ExpManagerConfig(
        exp_dir=em.get("exp_dir"),
        name=str(em.get("name") or raw_cfg.get("name") or "run"),
        resume_if_exists=bool(em.get("resume_if_exists", False)),
        resume_ignore_no_checkpoint=bool(em.get("resume_ignore_no_checkpoint", False)),
        monitor=cb.get("monitor", "val_wer"),
        mode=cb.get("mode", "min"),
        save_top_k=int(cb.get("save_top_k", 5)),
        always_save_portable=bool(cb.get("always_save_portable", cb.get("always_save_nemo", True))),
        create_wandb_logger=bool(em.get("create_wandb_logger", False)),
        wandb_logger_kwargs=em.get("wandb_logger_kwargs"),
        create_tensorboard_logger=bool(em.get("create_tensorboard_logger", True)),
    ))


def tokenizer_artifacts(raw_cfg: dict, tokenizer_dir: Optional[str] = None) -> dict:
    """The tokenizer files of a config as portable-archive artifacts, so
    that the archive restores in either package without the training
    machine's files: {} for char labels; {"tokenizer_<lang>.model": path}
    for each language of an aggregate tokenizer (its SentencePiece models);
    else an HF tokenizer.json as "tokenizer" or the SentencePiece model as
    "tokenizer_model", whichever the builder would read."""
    m = raw_cfg["model"]
    if m.get("labels"):
        return {}
    tok = m.get("tokenizer") or {}
    if tok.get("type") == "agg":
        return {f"tokenizer_{lang}.model": path for lang, sub in tok["langs"].items()
                for path in [sub.get("model_file")
                             or os.path.join(sub.get("dir") or "", "tokenizer.model")]
                if os.path.isfile(path)}
    d = tokenizer_dir or tok.get("dir") or ""
    if not tok.get("model_file") and os.path.isfile(os.path.join(d, "tokenizer.json")):
        return {"tokenizer": os.path.join(d, "tokenizer.json")}
    path = tok.get("model_file") or os.path.join(d, "tokenizer.model")
    return {"tokenizer_model": path} if os.path.isfile(path) else {}


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must be present); cpu to run there")


def train(cls, default_config: str, argv: Optional[Sequence[str]] = None):
    """The body of the training scripts: build `cls` from --config and the
    overrides, fit with the config's experiment manager (or one step with
    +fast_dev_run=true, no manager), then write the portable archive when
    always_save_portable. -> (model, fit result)."""
    overrides, leftover = parse_overrides(sys.argv[1:] if argv is None else list(argv))
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=default_config)
    ap.add_argument("--tokenizer-dir", default=None)
    add_device_arg(ap)
    args = ap.parse_args(leftover)
    fast_dev_run = bool(overrides.pop("fast_dev_run", False))
    from conformer_nemo_tpu_torch.parallel.distributed import (
        initialize_distributed,
        is_main_process,
    )

    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    initialize_distributed(device=args.device)  # a no-op outside a launcher
    model = cls.from_config_file(args.config, tokenizer_dir=args.tokenizer_dir,
                                 overrides=overrides, device=args.device)
    em = None if fast_dev_run else build_exp_manager(model.raw_cfg)
    result = model.fit(max_steps=1 if fast_dev_run else None,
                       max_epochs=1 if fast_dev_run else None, exp_manager=em)
    main = is_main_process()
    if main:
        print(f"done: {result}", flush=True)
    if em is not None and em.cfg.always_save_portable:
        path = em.save_portable(model.raw_cfg, model.portable_variables,
                                tokenizer_artifacts(model.raw_cfg, args.tokenizer_dir))
        if main:
            print("portable:", path, flush=True)
    return model, result
