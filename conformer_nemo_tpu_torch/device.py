"""Device selection: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """None -> cuda, or cuda:LOCAL_RANK under a launcher that sets
    LOCAL_RANK (torchrun: one process per GPU); raises when no GPU is
    present. Otherwise the device the caller named. There is no silent
    fall-back to the CPU."""
    if device is None:
        local = os.environ.get("LOCAL_RANK")
        device = "cuda" if local is None else f"cuda:{int(local)}"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: this entry point runs on the GPU by "
            "default; pass device='cpu' to run on the CPU explicitly")
    return dev
