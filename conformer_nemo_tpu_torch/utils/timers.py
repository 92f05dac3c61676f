"""Step timing (port of conformer_nemo_tpu/utils/timers.py): NeMo's
NamedTimer (named start/stop accumulators) and a train_step_timing hook.

`sync_fn` runs before a timer stops, so that a GPU step is timed to its end
(e.g. `torch.cuda.synchronize`)."""

from __future__ import annotations

import time
from typing import Dict, List, Optional


class NamedTimer:
    def __init__(self, reduction: str = "mean", sync_fn=None):
        self.reduction = reduction
        self._starts: Dict[str, float] = {}
        self._records: Dict[str, List[float]] = {}
        self._sync_fn = sync_fn

    def start(self, name: str = ""):
        self._starts[name] = time.perf_counter()

    def stop(self, name: str = ""):
        """-> the seconds since `start(name)` (None when it was not started)."""
        if name not in self._starts:
            return None
        if self._sync_fn is not None:
            self._sync_fn()
        dt = time.perf_counter() - self._starts.pop(name)
        self._records.setdefault(name, []).append(dt)
        return dt

    def get(self, name: str = "") -> Optional[float]:
        """The records of `name` reduced (mean, min, max, else the last)."""
        rec = self._records.get(name)
        if not rec:
            return None
        if self.reduction == "mean":
            return sum(rec) / len(rec)
        if self.reduction == "min":
            return min(rec)
        if self.reduction == "max":
            return max(rec)
        return rec[-1]

    def reset(self, name: Optional[str] = None):
        if name is None:
            self._records.clear()
            self._starts.clear()
        else:
            self._records.pop(name, None)

    @property
    def active_timers(self):
        return list(self._starts)


class StepTimingHook:
    """A rolling train_step_timing: the mean of the last `buffer_size`
    steps, logged every `log_every` steps through `logger.log(step, **)`."""

    def __init__(self, logger=None, log_every: int = 10, buffer_size: int = 100):
        self.timer = NamedTimer()
        self.logger = logger
        self.log_every = log_every
        self.buffer_size = buffer_size

    def before_step(self):
        self.timer.start("train_step")

    def after_step(self, step: int):
        self.timer.stop("train_step")
        recs = self.timer._records.get("train_step", [])
        if len(recs) > self.buffer_size:
            del recs[: -self.buffer_size]
        if self.logger and step % self.log_every == 0 and recs:
            self.logger.log(step, train_step_timing=sum(recs) / len(recs))
