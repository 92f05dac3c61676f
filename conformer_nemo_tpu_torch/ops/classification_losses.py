"""Classification losses and accuracy counts (port of
conformer_nemo_tpu/ops/classification_losses.py): mean softmax cross
entropy with optional label smoothing, the ArcFace angular-margin loss,
per-k (correct, total) top-k counts that sum across batches, and the
regression path's mean squared error. Reductions in fp32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross entropy; logits [B, V] (any float dtype), labels [B]."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    v = logits.shape[-1]
    target = F.one_hot(labels.long(), v).to(torch.float32)
    if label_smoothing > 0.0:
        target = target * (1.0 - label_smoothing) + label_smoothing / v
    return -(target * logp).sum(-1).mean()


def angular_softmax_loss(logits: torch.Tensor, labels: torch.Tensor, scale: float = 20.0,
                         margin: float = 1.35, eps: float = 1e-7) -> torch.Tensor:
    """ArcFace: `logits` are cosines in [-1, 1] (SpeakerDecoder with
    angular=True); the numerator is s * cos(acos(cos_y) + m), cos_y clipped
    to [-1 + eps, 1 - eps]; the denominator adds the other classes at
    plain s * cos."""
    logits = logits.to(torch.float32)
    labels = labels.long()
    cos_y = logits.gather(1, labels[:, None])[:, 0]
    # jnp.clip's form: at a value equal to a bound the gradient splits in two
    lo, hi = torch.tensor(-1.0 + eps), torch.tensor(1.0 - eps)
    clipped = torch.minimum(torch.maximum(cos_y, lo.to(cos_y.device)), hi.to(cos_y.device))
    numerator = scale * torch.cos(torch.acos(clipped) + margin)
    onehot = F.one_hot(labels, logits.shape[1]).bool()
    excl = torch.where(onehot, float("-inf"), scale * logits)
    denom = torch.exp(numerator) + torch.exp(excl).sum(dim=1)
    return -(numerator - torch.log(denom)).mean()


def top_k_counts(logits: torch.Tensor, labels: torch.Tensor,
                 top_k: Sequence[int] = (1,)) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-k (correct, total) int32 counts over the batch."""
    pred = torch.topk(logits.to(torch.float32), max(top_k), dim=-1).indices
    hit = pred == labels.long()[:, None]
    correct = torch.stack([hit[:, :k].any(dim=1).sum() for k in top_k]).to(torch.int32)
    total = torch.full((len(top_k),), logits.shape[0], dtype=torch.int32, device=logits.device)
    return correct, total


def mse_loss(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The regression model's loss."""
    return (preds.to(torch.float32) - targets.to(torch.float32)).square().mean()
