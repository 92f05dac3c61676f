"""Log-mel spectrogram frontend (port of conformer_nemo_tpu/audio/features.py).

The reference FilterbankFeatures:

    [training: dither] -> preemphasis -> STFT (symmetric window, center
    reflect pad) -> power -> [training: narrowband] -> Slaney mel matmul
    -> log(x + guard) -> per-feature masked mean/std normalisation
    -> pad_value beyond length -> pad_to multiple.

Everything runs in float32. The STFT is one framed matmul against the
windowed real-DFT basis, like the JAX package's; both matmuls are plain
float32 `torch.matmul` (never TF32: `torch.backends.cuda.matmul.allow_tf32`
is False by default and no convolution is involved). In training mode,
dither adds `dither` x N(0, 1) noise to the waveform and narrowband
augmentation zeroes, with probability `nb_augmentation_prob` per sample,
the power bins at or above `nb_max_freq`; both draw from an explicit
`torch.Generator` on the waveform's device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from conformer_nemo_tpu_torch.utils.typecheck import typecheck

LOG_GUARD = 2.0 ** -24  # reference log_zero_guard_value
STD_GUARD = 1e-5  # reference CONSTANT added to std


# ---------------------------------------------------------------------------
# Host-side constants (numpy): mel filters + windowed DFT basis
# ---------------------------------------------------------------------------


def _hz_to_mel_slaney(freqs: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    freqs = np.asarray(freqs, dtype=np.float64)
    f_sp = 200.0 / 3.0
    mels = freqs / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    above = freqs >= min_log_hz
    return np.where(
        above, min_log_mel + np.log(np.maximum(freqs, 1e-10) / min_log_hz) / logstep, mels)


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3.0
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    above = mels >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank, [n_mels, n_fft//2 + 1]
    (librosa.filters.mel(htk=False, norm='slaney'))."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def window_fn(window: str | None, win_length: int) -> np.ndarray:
    """Symmetric (periodic=False) analysis window: hann | hamming | blackman
    | bartlett | none. Note torch.hann_window's default is periodic."""
    if window in (None, "none"):
        return np.ones(win_length, dtype=np.float64)
    if win_length == 1:
        return np.ones(1, dtype=np.float64)
    frac = np.arange(win_length, dtype=np.float64) / (win_length - 1)
    if window == "hann":
        return 0.5 - 0.5 * np.cos(2.0 * np.pi * frac)
    if window == "hamming":
        return 0.54 - 0.46 * np.cos(2.0 * np.pi * frac)
    if window == "blackman":
        return 0.42 - 0.5 * np.cos(2.0 * np.pi * frac) + 0.08 * np.cos(4.0 * np.pi * frac)
    if window == "bartlett":
        return 1.0 - np.abs(2.0 * frac - 1.0)
    raise ValueError(f"unsupported window: {window}")


def stft_basis(n_fft: int, win_length: int, window: str = "hann") -> np.ndarray:
    """Windowed real-DFT basis, [n_fft, 2 * n_bins] = [cos | -sin] columns;
    a window shorter than n_fft is centred with zeros (torch.stft rule)."""
    n_bins = n_fft // 2 + 1
    pad_left = (n_fft - win_length) // 2
    full_win = np.zeros(n_fft, dtype=np.float64)
    full_win[pad_left : pad_left + win_length] = window_fn(window, win_length)
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    angle = 2.0 * np.pi * n * k / n_fft
    return np.concatenate(
        [np.cos(angle) * full_win[:, None], -np.sin(angle) * full_win[:, None]], axis=1
    ).astype(np.float32)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MelFeatureConfig:
    """Schema of the reference AudioToMelSpectrogramPreprocessor."""

    sample_rate: int = 16000
    window_size: float = 0.025  # seconds
    window_stride: float = 0.01  # seconds
    window: str = "hann"
    features: int = 80
    n_fft: int | None = 512
    lowfreq: float = 0.0
    highfreq: float | None = None
    log: bool = True
    log_zero_guard_type: str = "add"  # add | clamp
    log_zero_guard_value: float | str = LOG_GUARD  # number | 'tiny' | 'eps'
    dither: float = 1e-5  # training only (waveform noise scale)
    preemph: float | None = 0.97
    normalize: str = "per_feature"  # per_feature | all_features | fixed_mean_and_std | none
    fixed_mean: tuple | None = None
    fixed_std: tuple | None = None
    mag_power: float = 2.0
    pad_to: int | str = 0  # int multiple, or 'max'
    pad_value: float = 0.0
    max_duration: float = 16.7
    frame_splicing: int = 1
    exact_pad: bool = False
    nb_augmentation_prob: float = 0.0  # training only
    nb_max_freq: int = 4000

    def __post_init__(self):
        if self.exact_pad and self.hop_length % 2 == 1:
            raise ValueError("exact_pad requires an even hop size")
        if self.log_zero_guard_type not in ("add", "clamp"):
            raise ValueError(
                f"log_zero_guard_type must be 'add' or 'clamp', got {self.log_zero_guard_type!r}")

    @property
    def win_length(self) -> int:
        return int(self.window_size * self.sample_rate)

    @property
    def hop_length(self) -> int:
        return int(self.window_stride * self.sample_rate)

    @property
    def n_fft_(self) -> int:
        return self.n_fft or 2 ** math.ceil(math.log2(self.win_length))

    @property
    def stft_pad_amount(self) -> int:
        """One-sided reflect pad: n_fft//2, or (n_fft - hop)//2 with exact_pad."""
        n_fft = self.n_fft_
        return (n_fft - self.hop_length) // 2 if self.exact_pad else n_fft // 2

    @property
    def log_guard(self) -> float:
        v = self.log_zero_guard_value
        if v == "tiny":
            return float(np.finfo(np.float32).tiny)
        if v == "eps":
            return float(np.finfo(np.float32).eps)
        return float(v)


def mel_seq_len(cfg: MelFeatureConfig, sample_len: torch.Tensor) -> torch.Tensor:
    """STFT frame count for `sample_len` samples (float32 arithmetic, as the
    reference get_seq_len)."""
    pad_amount = cfg.stft_pad_amount * 2
    x = sample_len.to(torch.float32)
    return (torch.floor((x + pad_amount - cfg.n_fft_) / cfg.hop_length) + 1).to(torch.int32)


def _decode_transport(waveform: torch.Tensor) -> torch.Tensor:
    """int16 PCM or int8 mu-law (mu=255) transport -> float32 in [-1, 1)."""
    x = waveform.to(torch.float32)
    if waveform.dtype == torch.int16:
        x = x * (1.0 / 32768.0)
    elif waveform.dtype == torch.int8:
        y = x * (1.0 / 127.0)
        x = torch.sign(y) * (torch.exp2(8.0 * torch.abs(y)) - 1.0) * (1.0 / 255.0)
    return x


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device)


def _bernoulli(gen: torch.Generator, p: float, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device) < p


@typecheck(waveform=("B", "T"), lengths=("B",))
def log_mel_spectrogram(cfg: MelFeatureConfig, waveform: torch.Tensor, lengths: torch.Tensor,
                        *, generator: torch.Generator | None = None,
                        training: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """wav [B, T] (float32, int16 or int8 mu-law) + valid lengths [B]
    -> (log-mel [B, D, Tf] float32, frame lengths [B] int32). With
    training=True, dither and narrowband augmentation draw from `generator`."""
    n_fft, hop = cfg.n_fft_, cfg.hop_length
    dev = waveform.device
    x = _decode_transport(waveform)
    seq_len = mel_seq_len(cfg, lengths)

    needs_nb = (training and 0.0 < cfg.nb_augmentation_prob
                and cfg.nb_max_freq < cfg.sample_rate / 2)
    if (training and cfg.dither > 0 or needs_nb) and generator is None:
        raise ValueError("training=True with dither/narrowband augmentation needs a generator")
    if training and cfg.dither > 0:
        x = x + cfg.dither * _normal(generator, x.shape, dev)

    if cfg.preemph is not None:
        x = torch.cat([x[:, :1], x[:, 1:] - cfg.preemph * x[:, :-1]], dim=1)
    pad = cfg.stft_pad_amount
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0, :]

    basis = torch.from_numpy(stft_basis(n_fft, cfg.win_length, cfg.window)).to(dev)
    frames = x.unfold(1, n_fft, hop)  # [B, F, n_fft], a strided view
    spec = torch.matmul(frames, basis)
    n_bins = n_fft // 2 + 1
    power = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2  # [B, F, bins]
    if needs_nb:
        # zeroing the magnitude bins >= the cut equals zeroing the power bins
        nb_bin = int((cfg.nb_max_freq / cfg.sample_rate) * n_fft)
        drop = _bernoulli(generator, cfg.nb_augmentation_prob, (power.shape[0], 1, 1), dev)
        hi = (torch.arange(n_bins, device=dev) >= nb_bin)[None, None, :]
        power = torch.where(drop & hi, torch.zeros((), device=dev), power)
    if cfg.mag_power == 1.0:
        power = torch.sqrt(power)
    elif cfg.mag_power != 2.0:
        power = torch.sqrt(power) ** cfg.mag_power

    fb = torch.from_numpy(
        mel_filterbank(cfg.sample_rate, n_fft, cfg.features, cfg.lowfreq, cfg.highfreq)).to(dev)
    mel = torch.matmul(fb, power.transpose(1, 2))  # [B, D, F]

    if cfg.log:
        if cfg.log_zero_guard_type == "add":
            mel = torch.log(mel + cfg.log_guard)
        else:
            mel = torch.log(torch.clamp(mel, min=cfg.log_guard))
    if cfg.frame_splicing > 1:
        # the reference's splice degenerates to channel duplication
        mel = torch.cat([mel] * cfg.frame_splicing, dim=1)

    num_frames = mel.shape[-1]
    valid = torch.arange(num_frames, device=dev)[None, :] < seq_len[:, None]  # [B, F]
    if cfg.normalize in ("per_feature", "all_features"):
        mask = valid[:, None, :].to(mel.dtype)
        axes = (-1,) if cfg.normalize == "per_feature" else (1, 2)
        per = 1 if cfg.normalize == "per_feature" else mel.shape[1]
        cnt = torch.clamp(seq_len.to(mel.dtype), min=1.0)[:, None, None] * per
        mean = torch.sum(mel * mask, dim=axes, keepdim=True) / cnt
        # torch.std's default unbiased (ddof=1) estimator
        var = torch.sum(((mel - mean) * mask) ** 2, dim=axes, keepdim=True) / torch.clamp(
            cnt - 1.0, min=1.0)
        mel = (mel - mean) / (torch.sqrt(var) + STD_GUARD)
    elif cfg.normalize == "fixed_mean_and_std":
        mean = torch.tensor(cfg.fixed_mean, dtype=torch.float32, device=dev)[None, :, None]
        std = torch.tensor(cfg.fixed_std, dtype=torch.float32, device=dev)[None, :, None]
        mel = (mel - mean) / std

    mel = torch.where(valid[:, None, :], mel, torch.full_like(mel, cfg.pad_value))

    if cfg.pad_to == "max":
        max_len = int(math.floor(
            (cfg.max_duration * cfg.sample_rate + cfg.stft_pad_amount * 2 - n_fft) / hop) + 1)
        if mel.shape[-1] < max_len:
            mel = F.pad(mel, (0, max_len - mel.shape[-1]), value=cfg.pad_value)
    elif cfg.pad_to and cfg.pad_to > 0:
        rem = mel.shape[-1] % cfg.pad_to
        if rem:
            mel = F.pad(mel, (0, cfg.pad_to - rem), value=cfg.pad_value)
    return mel, seq_len
