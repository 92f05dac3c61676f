"""Wav2vec-style contrastive loss over masked spectrogram steps (port of
conformer_nemo_tpu/ops/contrastive_loss.py).

`combine_time_steps` spectrogram frames make one target step; a step is
"masked" when more than `mask_threshold` of its values were zeroed by the
augmentation. Targets quantise (GumbelVectorQuantizer) or linearly project
the clean spectrogram. Each step's negatives are `num_negatives` distinct
masked steps of its own row, drawn by Gumbel-top-k (uniform without
replacement; wrapped by tiling when the row has fewer steps than that), and
the loss is the cross entropy of the cosine similarities (over
`logit_temp`) of the decoder outputs against [positive, negatives], summed
over masked steps (or their mean). A negative equal to its positive
(isclose, atol 1e-6) is excluded. With quantised targets it adds
`prob_ppl_weight * ppl * sample_size`.

Randomness: the Gumbel draws of the negatives [B, T', T'] and of the
quantiser [B, T', G, V] may be passed in (`noise`), so that a test feeds
the JAX package's draws; otherwise they come from a generator. Steps that
are not masked rank below every masked one, lower index first (XLA's
top_k breaks ties so), which makes the negatives of a row with fewer
masked steps than `num_negatives` the JAX package's too.

The negatives are gathered ([B, T', n, C]: about 0.75 GB in fp32 at B 8,
T' 1843, n 100, C 128) rather than formed by one-hot products.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from conformer_nemo_tpu_torch.models.ssl import (
    GumbelVectorQuantizer,
    GumbelVQConfig,
    gumbel_noise,
    gumbel_temperature,
)


@dataclasses.dataclass(frozen=True)
class ContrastiveLossConfig:
    in_dim: int = 80  # spectrogram channels
    proj_dim: int = 128
    combine_time_steps: int = 4
    num_negatives: int = 100
    quantized_targets: bool = False
    codebook_size: int = 320
    num_groups: int = 2
    prob_ppl_weight: float = 0.1
    logit_temp: float = 0.1
    reduce: str = "sum"  # sum | mean
    mask_threshold: float = 0.8
    quantizer_temp_start: float = 2.0
    quantizer_temp_min: float = 0.5
    quantizer_temp_decay: float = 0.999995
    dtype: Any = torch.float32


def vq_config(cfg: ContrastiveLossConfig) -> GumbelVQConfig:
    return GumbelVQConfig(
        dim=cfg.combine_time_steps * cfg.in_dim, num_vars=cfg.codebook_size,
        groups=cfg.num_groups, combine_groups=True, vq_dim=cfg.proj_dim,
        temp_start=cfg.quantizer_temp_start, temp_min=cfg.quantizer_temp_min,
        temp_decay=cfg.quantizer_temp_decay)


def _cosine(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    # eps inside the square root keeps the gradient finite at a zero vector
    num = (a * b).sum(-1)
    return num / torch.sqrt(((a * a).sum(-1) + eps) * ((b * b).sum(-1) + eps))


class ContrastiveLoss(nn.Module):
    """Owns the target projection (`target_proj`) or the quantizer
    (`quantizer`): their parameters train with the model."""

    def __init__(self, cfg: ContrastiveLossConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.quantized_targets:
            self.quantizer = GumbelVectorQuantizer(vq_config(cfg))
        else:
            self.target_proj = nn.Linear(cfg.combine_time_steps * cfg.in_dim, cfg.proj_dim)

    def draw_noise(self, b: int, t: int, generator: torch.Generator, device) -> dict:
        """The Gumbel draws for B spectrograms of T frames: "neg" [B, T', T']
        and, with quantised targets, "q" [B, T', groups, codebook_size]."""
        cfg = self.cfg
        tp = t // cfg.combine_time_steps
        noise = {"neg": gumbel_noise((b, tp, tp), generator, device)}
        if cfg.quantized_targets:
            noise["q"] = gumbel_noise((b, tp, cfg.num_groups, cfg.codebook_size), generator,
                                      device)
        return noise

    def forward(self, spectrograms: torch.Tensor, spec_masks: torch.Tensor,
                decoder_outputs: torch.Tensor, *, step: int, train: bool = True,
                noise: Optional[dict] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """spectrograms [B, D, T] (clean), spec_masks [B, D, T] (1 where the
        augmentation zeroed), decoder_outputs [B, >= T', proj_dim] with T' =
        T // combine_time_steps -> the scalar loss. noise: {"neg", "q"}
        Gumbel draws (see `draw_noise`); without it they come from
        `generator`."""
        cfg = self.cfg
        b, d, t = spectrograms.shape
        k = cfg.combine_time_steps
        tp = t // k
        dev = spectrograms.device
        if noise is None:
            if generator is None:
                raise ValueError("the contrastive loss needs its Gumbel noise or a generator")
            noise = self.draw_noise(b, t, generator, dev)
        targets = spectrograms[:, :, : tp * k].transpose(1, 2).reshape(b, tp, k * d)
        targets = targets.to(torch.float32)
        masks = spec_masks[:, :, : tp * k].transpose(1, 2).reshape(b, tp, k * d)
        masked = masks.to(torch.float32).mean(dim=-1) > cfg.mask_threshold  # [B, T']

        ppl = 0.0
        if cfg.quantized_targets:
            temp = gumbel_temperature(self.quantizer.cfg, step)
            targets, ppl = self.quantizer(targets, temp, train=train, noise=noise.get("q"))
        else:
            targets = F.linear(targets, self.target_proj.weight, self.target_proj.bias)
        outputs = decoder_outputs[:, :tp].to(torch.float32)

        n = cfg.num_negatives
        steps = torch.arange(tp, device=dev, dtype=torch.float32)
        # masked steps score their Gumbel draw; the others rank below them all,
        # lower index first
        scores = torch.where(masked[:, None, :], noise["neg"].to(dev, torch.float32),
                             -1e5 - steps[None, None, :])
        neg_idx = torch.topk(scores, min(n, tp), dim=-1).indices  # [B, T', n]
        if n > tp:
            neg_idx = neg_idx.repeat(1, 1, -(-n // tp))[:, :, :n]
        rows = torch.arange(b, device=dev)[:, None, None]
        negs = targets[rows, neg_idx]  # [B, T', n, C]

        pos_sim = _cosine(outputs, targets)  # [B, T']
        neg_sim = _cosine(outputs[:, :, None, :], negs)  # [B, T', n]
        neg_is_pos = torch.isclose(targets[:, :, None, :], negs, atol=1e-6).all(dim=-1)
        neg_sim = torch.where(neg_is_pos, float("-inf"), neg_sim)
        logits = torch.cat([pos_sim[:, :, None], neg_sim], dim=-1) / cfg.logit_temp
        ce = -torch.log_softmax(logits, dim=-1)[:, :, 0]
        w = masked.to(torch.float32)
        loss = (ce * w).sum()
        sample_size = w.sum()
        if cfg.reduce == "mean":
            loss = loss / torch.clamp(sample_size, min=1.0)
        if cfg.quantized_targets and cfg.prob_ppl_weight != 0:
            loss = loss + cfg.prob_ppl_weight * ppl * sample_size
        return loss
