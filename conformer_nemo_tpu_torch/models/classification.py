"""Classification and regression head over a convolutional encoder (port
of conformer_nemo_tpu/models/classification.py): pool the encoder output
over its valid frames (mean or max; the JAX package's length-masked
deviation from the reference's pool over the padded axis) and one Linear,
`fc`, to num_classes (softmax when return_logits is False).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ClassificationDecoderConfig:
    feat_in: int = 256
    num_classes: int = 2
    pooling_type: str = "avg"  # avg | max
    return_logits: bool = True
    dtype: Any = torch.bfloat16


class ClassificationDecoder(nn.Module):
    """[B, C, T] + lengths [B] -> logits [B, num_classes] (fp32)."""

    def __init__(self, cfg: ClassificationDecoderConfig):
        super().__init__()
        if cfg.pooling_type not in ("avg", "max"):
            raise ValueError("pooling_type must be 'avg' or 'max'")
        self.cfg = cfg
        self.fc = nn.Linear(cfg.feat_in, cfg.num_classes)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        mask = (torch.arange(x.shape[-1], device=x.device)[None, :] < lengths[:, None])[:, None]
        xf = x.to(torch.float32)
        if self.cfg.pooling_type == "avg":
            denom = torch.clamp(lengths.to(torch.float32), min=1.0)[:, None]
            pooled = torch.where(mask, xf, 0.0).sum(-1) / denom
        else:
            pooled = torch.where(mask, xf, float("-inf")).amax(-1)
        logits = F.linear(pooled, self.fc.weight, self.fc.bias)
        return logits if self.cfg.return_logits else torch.softmax(logits, dim=-1)
