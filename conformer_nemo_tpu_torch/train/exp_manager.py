"""Experiment orchestration: run dirs, scalar logging, resume, checkpoints
(port of conformer_nemo_tpu/train/exp_manager.py).

Versioned run dirs (exp_dir/name/version_N), `run-info.json`, scalars as
`metrics.jsonl` always, and as TensorBoard events (tensorboardX, else
torch.utils.tensorboard) and a W&B run when their packages import;
otherwise that logger is skipped with one message. Checkpoints go to
run_dir/checkpoints (train/checkpoint.py), by default with the write on a
background thread.

Across ranks (parallel/distributed.py) rank 0 picks the version and
broadcasts it, and alone logs, writes `run-info.json` and prunes; every
rank calls `save` (the gather of a tensor-parallel model is collective)
and `maybe_resume` (each rank restores its own slices).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import subprocess
import sys
import time
from typing import Optional

import torch.distributed as dist

from conformer_nemo_tpu_torch.parallel.distributed import get_world_size, is_main_process
from conformer_nemo_tpu_torch.train import checkpoint as ckpt

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ExpManagerConfig:
    exp_dir: Optional[str] = None
    name: str = "default"
    version: Optional[str] = None
    resume_if_exists: bool = False
    resume_ignore_no_checkpoint: bool = False
    create_checkpoint_callback: bool = True
    monitor: str = "val_wer"
    mode: str = "min"
    save_top_k: int = 5
    always_save_portable: bool = True
    log_every_n_steps: int = 10
    # the host copy stays on the calling thread; the write goes to a worker
    async_checkpointing: bool = True
    create_wandb_logger: bool = False
    wandb_logger_kwargs: Optional[dict] = None
    create_tensorboard_logger: bool = True


def _tensorboard_writer(log_dir: str):
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            log.warning("TensorBoard logging skipped: %s", e)
            return None
    return SummaryWriter(log_dir)


class ScalarLogger:
    """JSONL scalar logger, plus TensorBoard events and a W&B run where
    their packages import."""

    def __init__(self, log_dir: str, wandb_kwargs: Optional[dict] = None,
                 tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = _tensorboard_writer(log_dir) if tensorboard else None
        self._wandb = None
        if wandb_kwargs is not None:
            try:
                import wandb

                self._wandb = wandb.init(dir=log_dir, **wandb_kwargs)
            except Exception as e:  # no package, or no network
                log.warning("W&B logging requested but unavailable: %s", e)

    def log(self, step: int, **scalars):
        values = {k: float(v) for k, v in scalars.items()}
        self._f.write(json.dumps({"step": step, "time": time.time(), **values}) + "\n")
        self._f.flush()
        if self._tb:
            for k, v in values.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb:
            self._wandb.log(values, step=step)

    def close(self):
        self._f.close()
        if self._tb:
            self._tb.close()
        if self._wandb:
            self._wandb.finish()


class _NoLogger:
    """The logger of a rank other than 0: scalars go nowhere."""

    def log(self, step: int, **scalars):
        pass

    def close(self):
        pass


class ExperimentManager:
    def __init__(self, cfg: ExpManagerConfig):
        self.cfg = cfg
        exp_dir = cfg.exp_dir or "./experiments"
        version = cfg.version
        if version is None and is_main_process():
            base = os.path.join(exp_dir, cfg.name)
            n = 0
            while os.path.exists(os.path.join(base, f"version_{n}")) and not cfg.resume_if_exists:
                n += 1
            if cfg.resume_if_exists and os.path.exists(base):
                versions = sorted((v for v in os.listdir(base) if v.startswith("version_")),
                                  key=lambda v: int(v.split("_")[1]))
                if versions:
                    n = int(versions[-1].split("_")[1])
            version = f"version_{n}"
        if get_world_size() > 1:  # every rank takes rank 0's version
            box = [version]
            dist.broadcast_object_list(box, src=0)
            version = box[0]
        self.run_dir = os.path.join(exp_dir, cfg.name, version)
        self.ckpt_dir = os.path.join(self.run_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._pending_save = None
        if not is_main_process():
            self.logger = _NoLogger()
            return
        self.logger = ScalarLogger(
            self.run_dir, (cfg.wandb_logger_kwargs or {}) if cfg.create_wandb_logger else None,
            tensorboard=cfg.create_tensorboard_logger)
        self._write_env_info()

    def _write_env_info(self):
        try:
            git = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                                 timeout=5).stdout.strip()
        except Exception:
            git = "unknown"
        with open(os.path.join(self.run_dir, "run-info.json"), "w") as f:
            json.dump({"git": git, "argv": sys.argv, "time": time.time()}, f)

    def maybe_resume(self, state):
        """Restore the last checkpoint into `state` when resume_if_exists.
        -> (state or None, meta or None)."""
        if not self.cfg.resume_if_exists:
            return None, None
        restored, meta = ckpt.restore_train_state(self.ckpt_dir, state)
        if restored is None and not self.cfg.resume_ignore_no_checkpoint:
            raise FileNotFoundError(
                f"resume_if_exists=True but no checkpoint found in {self.ckpt_dir}")
        return restored, meta

    def _prune(self):
        if not is_main_process():
            return
        ckpt.prune_checkpoints(self.ckpt_dir, self.cfg.save_top_k, self.cfg.monitor,
                               self.cfg.mode)

    def save(self, state, step: int, metrics: Optional[dict] = None):
        if not self.cfg.create_checkpoint_callback:
            return
        if self.cfg.async_checkpointing:
            self.wait_for_saves()  # at most one save in flight
            self._pending_save = ckpt.save_train_state_async(self.ckpt_dir, state, step,
                                                             metrics, then=self._prune)
            return
        ckpt.save_train_state(self.ckpt_dir, state, step, metrics)
        self._prune()

    def wait_for_saves(self):
        """Block until the in-flight checkpoint (if any) is on disk."""
        if self._pending_save is not None:
            self._pending_save.result()
            self._pending_save = None

    def save_portable(self, config: dict, variables, artifacts=None,
                      name: Optional[str] = None) -> str:
        """Rank 0 writes the archive; -> its path on every rank."""
        out = os.path.join(self.run_dir, (name or self.cfg.name) + ".cntpu")
        if is_main_process():
            ckpt.save_portable(out, config, variables, artifacts)
        return out
