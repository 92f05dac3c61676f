"""MFCC front end (port of conformer_nemo_tpu/audio/mfcc.py).

    out, frames = mfcc(MFCCConfig(), wav, lengths)            # on the GPU
    out, frames = mfcc(MFCCConfig(), wav, lengths, device="cpu")

torchaudio's MFCC, as NeMo's AudioToMFCCPreprocessor wraps it: the mel
power spectrogram (center reflect pad, no preemphasis, no dither), its log
(or dB), then the DCT-II (ortho) keeping n_mfcc coefficients. Built on the
port's log-mel pieces (audio/features.py: the framed real-DFT basis, the
Slaney mel filterbank, the frame count); the DCT is one more small product.
Every product runs in true fp32 (TF32 off for the call), as the JAX STFT's
Precision.HIGHEST does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from conformer_nemo_tpu_torch.audio.features import (
    MelFeatureConfig,
    mel_filterbank,
    mel_seq_len,
    stft_basis,
)
from conformer_nemo_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MFCCConfig:
    sample_rate: int = 16000
    window_size: float = 0.02
    window_stride: float = 0.01
    window: str = "hann"
    n_fft: int | None = None
    lowfreq: float = 0.0
    highfreq: float | None = None
    n_mels: int = 64
    n_mfcc: int = 64
    dct_type: int = 2
    norm: str = "ortho"
    log: bool = True

    @property
    def win_length(self) -> int:
        return int(self.window_size * self.sample_rate)

    @property
    def hop_length(self) -> int:
        return int(self.window_stride * self.sample_rate)

    @property
    def n_fft_(self) -> int:
        return self.n_fft or 2 ** math.ceil(math.log2(self.win_length))


def dct_matrix(n_mfcc: int, n_mels: int, norm: str = "ortho") -> np.ndarray:
    """DCT-II basis [n_mels, n_mfcc] (torchaudio's create_dct)."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)[None, :]
    basis = np.cos(np.pi / n_mels * (n[:, None] + 0.5) * k)
    if norm == "ortho":
        basis[:, 0] *= 1.0 / math.sqrt(n_mels)
        basis[:, 1:] *= math.sqrt(2.0 / n_mels)
    else:
        basis *= 2.0
    return basis.astype(np.float32)


@contextlib.contextmanager
def fp32_matmuls():
    """CUDA float32 products in true fp32 for the block (TF32 off)."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        yield
    finally:
        flags.allow_tf32 = saved


def mfcc(cfg: MFCCConfig, waveform, lengths, device=None) -> tuple:
    """wav [B, T] + valid lengths [B] (numpy or tensors) on `device` (None:
    CUDA) -> (mfcc [B, n_mfcc, Tf] float32, frame lengths [B] int32)."""
    dev = resolve_device(device)
    n_fft, hop = cfg.n_fft_, cfg.hop_length
    x = torch.as_tensor(waveform).to(dev, torch.float32)
    lengths = torch.as_tensor(lengths).to(dev)
    frames_len = mel_seq_len(MelFeatureConfig(sample_rate=cfg.sample_rate,
                                              window_size=cfg.window_size,
                                              window_stride=cfg.window_stride, n_fft=n_fft),
                             lengths)
    pad = n_fft // 2
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    basis = torch.from_numpy(stft_basis(n_fft, cfg.win_length, cfg.window)).to(dev)
    fb = torch.from_numpy(mel_filterbank(cfg.sample_rate, n_fft, cfg.n_mels, cfg.lowfreq,
                                         cfg.highfreq)).to(dev)
    dct = torch.from_numpy(dct_matrix(cfg.n_mfcc, cfg.n_mels, cfg.norm)).to(dev)
    with fp32_matmuls():
        spec = torch.matmul(x.unfold(1, n_fft, hop), basis)  # [B, F, 2 * bins]
        n_bins = n_fft // 2 + 1
        power = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2
        mel = torch.matmul(power, fb.t())  # [B, F, n_mels]
        if cfg.log:
            mel = torch.log(mel + 1e-6)
        else:
            mel = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))  # dB
        out = torch.matmul(mel, dct).transpose(1, 2)  # [B, n_mfcc, F]
    return out.contiguous(), frames_len
