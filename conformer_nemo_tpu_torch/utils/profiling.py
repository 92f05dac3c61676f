"""Profiling hooks (port of conformer_nemo_tpu/utils/profiling.py):
`torch.profiler` traces of the CPU and, where there is one, the GPU,
written as Chrome traces (chrome://tracing, Perfetto).

    with profile_trace("exp/profile"):
        for _ in range(5):
            step(batch)
    with annotate("decode"):       # a named range inside the trace
        ...
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """Trace the block; the trace lands in `log_dir` as
    `trace_<pid>_<ns>.json`. The CUDA activity is traced when a GPU is
    present; pending GPU work is waited for before the trace ends."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named range in the trace, usable inside host loops."""
    return torch.profiler.record_function(name)
