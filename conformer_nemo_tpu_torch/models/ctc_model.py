"""Conformer-CTC model (port of conformer_nemo_tpu/models/ctc_model.py):
encoder + 1x1 decoder head -> log-probs over V+1 classes, blank id = V."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig, log_mel_spectrogram
from conformer_nemo_tpu_torch.models.conformer import ConformerEncoder, ConformerEncoderConfig


@dataclasses.dataclass(frozen=True)
class CTCModelConfig:
    preprocessor: MelFeatureConfig = MelFeatureConfig()
    encoder: ConformerEncoderConfig = ConformerEncoderConfig()
    num_classes: int = 128  # vocabulary size V; blank id = V

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
    """encoder + head; the frontend runs outside (parameter-free)."""

    def __init__(self, cfg: CTCModelConfig):
        super().__init__()
        self.cfg = cfg
        enc = cfg.encoder
        self.encoder = ConformerEncoder(enc)
        d_out = enc.feat_out if enc.feat_out > 0 else enc.d_model
        self.decoder = CTCDecoderHead(d_out, cfg.num_classes, enc.dtype)

    def forward(self, features: torch.Tensor, feat_lengths: torch.Tensor):
        encoded, enc_lengths = self.encoder(features, feat_lengths)
        return self.decoder(encoded), enc_lengths


@torch.inference_mode()
def ctc_forward(model: CTCModel, audio: torch.Tensor, audio_lens: torch.Tensor):
    """wav [B, T] -> (log_probs [B, T', V+1], enc_lengths [B]); inference."""
    feats, feat_lens = log_mel_spectrogram(model.cfg.preprocessor, audio, audio_lens)
    return model(feats, feat_lens)
