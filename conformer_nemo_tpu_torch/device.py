"""Device selection: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """None -> cuda (raises when no GPU is present); otherwise the device
    the caller named. There is no silent fall-back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: this entry point runs on the GPU by "
            "default; pass device='cpu' to run on the CPU explicitly")
    return dev
