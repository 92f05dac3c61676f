"""CTC greedy decoding (port of conformer_nemo_tpu/decode/ctc_greedy.py):
argmax on the device, then collapse repeats and drop blanks on the host."""

from __future__ import annotations

import numpy as np
import torch


def ctc_greedy_decode(log_probs: torch.Tensor) -> torch.Tensor:
    """[B, T, V+1] log-probs (or logits) -> argmax ids [B, T] int32."""
    return torch.argmax(log_probs, dim=-1).to(torch.int32)


def collapse_ctc_ids(predictions, lengths, blank_id: int) -> list[list[int]]:
    """Collapse repeats then drop blanks, per sample."""
    predictions = np.asarray(predictions)
    out = []
    for i in range(predictions.shape[0]):
        seq = predictions[i]
        if lengths is not None:
            seq = seq[: int(lengths[i])]
        decoded = []
        previous = blank_id
        for p in seq.tolist():
            if (p != previous or previous == blank_id) and p != blank_id:
                decoded.append(int(p))
            previous = p
        out.append(decoded)
    return out
