"""Conformer-CTC model (port of conformer_nemo_tpu/models/ctc_model.py):
encoder + 1x1 decoder head -> log-probs over V+1 classes, blank id = V,
and the training loss `ctc_model_loss`."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig, log_mel_spectrogram
from conformer_nemo_tpu_torch.audio.spec_augment import SpecAugmentConfig
from conformer_nemo_tpu_torch.models.conformer import ConformerEncoder, ConformerEncoderConfig
from conformer_nemo_tpu_torch.ops.ctc_loss import CTCLossKernel, ctc_forward_neg_log_likelihood


@dataclasses.dataclass(frozen=True)
class CTCModelConfig:
    preprocessor: MelFeatureConfig = MelFeatureConfig()
    spec_augment: SpecAugmentConfig = SpecAugmentConfig()
    encoder: ConformerEncoderConfig = ConformerEncoderConfig()
    num_classes: int = 128  # vocabulary size V; blank id = V
    ctc_reduction: str = "mean_batch"

    @property
    def blank_id(self) -> int:
        return self.num_classes


class CTCDecoderHead(nn.Module):
    """1x1 Conv1d to V+1 classes (NeMo ConvASRDecoder names), fp32 log_softmax."""

    def __init__(self, feat_in: int, num_classes: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.decoder_layers = nn.Sequential(nn.Conv1d(feat_in, num_classes + 1, 1))

    def forward(self, encoded: torch.Tensor) -> torch.Tensor:
        # encoded: [B, D, T] -> [B, T, V+1] log-probs
        conv = self.decoder_layers[0]
        dt = self.dtype
        logits = F.linear(encoded.transpose(1, 2).to(dt), conv.weight[..., 0].to(dt),
                          conv.bias.to(dt))
        return torch.log_softmax(logits.to(torch.float32), dim=-1)


class CTCModel(nn.Module):
    """encoder + head; the frontend and augmentation run outside (parameter-free)."""

    def __init__(self, cfg: CTCModelConfig):
        super().__init__()
        self.cfg = cfg
        enc = cfg.encoder
        self.encoder = ConformerEncoder(enc)
        d_out = enc.feat_out if enc.feat_out > 0 else enc.d_model
        self.decoder = CTCDecoderHead(d_out, cfg.num_classes, enc.dtype)

    def forward(self, features: torch.Tensor, feat_lengths: torch.Tensor,
                dropout_seed: Optional[int] = None):
        encoded, enc_lengths = self.encoder(features, feat_lengths, dropout_seed)
        return self.decoder(encoded), enc_lengths


@torch.inference_mode()
def ctc_forward(model: CTCModel, audio: torch.Tensor, audio_lens: torch.Tensor):
    """wav [B, T] -> (log_probs [B, T', V+1], enc_lengths [B]); inference."""
    feats, feat_lens = log_mel_spectrogram(model.cfg.preprocessor, audio, audio_lens)
    return model(feats, feat_lens)


def ctc_model_loss(cfg: CTCModelConfig, log_probs: torch.Tensor, enc_lengths: torch.Tensor,
                   tokens: torch.Tensor, token_lens: torch.Tensor,
                   sample_weight: Optional[torch.Tensor] = None,
                   impl: str = "auto",
                   denominator: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CTC loss over the rows with weight (the trainer passes
    audio_lens > 0, so the loader's zero rows count 0):
    sum(nll * w) / max(denominator, 1), the denominator sum(w) unless given
    (a data-parallel rank passes the global batch's).

    impl: "kernel" (K1-fwd/bwd, `CTCLossKernel`; the JAX package's "pallas"),
    "plain" (autograd through the recursion; its "scan"), or "auto": the
    kernel for CUDA tensors, the plain recursion on the CPU."""
    if impl == "auto":
        impl = "kernel" if log_probs.is_cuda else "plain"
    if impl == "kernel":
        nll = CTCLossKernel.apply(log_probs, tokens, enc_lengths, token_lens, cfg.blank_id)
    elif impl == "plain":
        nll = ctc_forward_neg_log_likelihood(log_probs, tokens, enc_lengths, token_lens,
                                             cfg.blank_id)
    else:
        raise ValueError(f"impl must be 'auto', 'kernel' or 'plain', got {impl!r}")
    if sample_weight is None:
        return nll.mean()
    w = sample_weight.to(nll.dtype)
    denominator = w.sum() if denominator is None else denominator.to(nll.dtype)
    return (nll * w).sum() / torch.clamp(denominator, min=1.0)
