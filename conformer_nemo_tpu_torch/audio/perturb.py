"""Waveform perturbations, host-side augmentation (port of
conformer_nemo_tpu/audio/perturb.py).

The reference's perturbations (perturb.py): speed (polyphase resampling),
time-stretch (STFT, a numpy phase vocoder, iSTFT), gain, shift, white
noise, noise (SNR-targeted mixing of clips from a manifest), impulse (RIR
convolution), rir_noise_aug (RIR plus foreground and background noise) and
transcode_aug (a G.711 chain), and the `AudioAugmentor` that applies each
with its probability (`process_augmentations` builds it from a config).

Every draw comes from the `random.Random` passed in (the loader passes a
per-item stream of (seed, epoch, index)), in the JAX package's order, so
the same stream gives the same waveform in both packages.
"""

from __future__ import annotations

import dataclasses
import logging
import random
from typing import List, Optional

import numpy as np

from conformer_nemo_tpu_torch.data.audio_io import load_audio, resample_poly

log = logging.getLogger(__name__)


_TAR_NOTED: set = set()


def _ignore_tarred(**paths) -> None:
    """Noise and impulse banks are read from their manifests' paths, as the
    JAX package reads them: a tar list is accepted and ignored, which is
    logged once per argument name."""
    for name in sorted(k for k, v in paths.items() if v and k not in _TAR_NOTED):
        _TAR_NOTED.add(name)
        log.warning("%s is ignored: the bank is read from its manifest's audio paths, as the "
                    "JAX package reads it", name)


class Perturbation:
    def max_augmentation_length(self, length: float) -> float:
        return length

    def perturb(self, samples: np.ndarray, sr: int, rng: random.Random) -> np.ndarray:
        raise NotImplementedError


class SpeedPerturbation(Perturbation):
    """Resample-based speed change (perturb.py:101): rate drawn from
    [min_speed_rate, max_speed_rate] or discrete num_rates grid."""

    def __init__(self, sr: int = 16000, resample_type: str = "kaiser_fast",
                 min_speed_rate: float = 0.9, max_speed_rate: float = 1.1,
                 num_rates: int = 5):
        self.min_rate = min_speed_rate
        self.max_rate = max_speed_rate
        self.num_rates = num_rates
        if num_rates > 0:
            self.rates = np.linspace(min_speed_rate, max_speed_rate, num_rates)

    def max_augmentation_length(self, length: float) -> float:
        return length * self.max_rate

    def perturb(self, samples, sr, rng):
        if self.num_rates > 0:
            rate = float(self.rates[rng.randrange(self.num_rates)])
        else:
            rate = rng.uniform(self.min_rate, self.max_rate)
        if abs(rate - 1.0) < 1e-6:
            return samples
        new_sr = int(round(sr * rate))
        return resample_poly(samples, new_sr, sr)


def _stft_np(y: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """librosa.core.stft semantics: periodic hann, win_length=n_fft,
    center=True reflect padding. -> complex [n_fft//2+1, frames]."""
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    pad = n_fft // 2
    y = np.pad(y, (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = y[idx] * win[None, :]
    return np.fft.rfft(frames, axis=1).T.astype(np.complex64)


def _istft_np(D: np.ndarray, hop: int, length: int) -> np.ndarray:
    """librosa.core.istft semantics: periodic hann overlap-add with
    squared-window normalization, center trim, crop/pad to `length`."""
    n_fft = 2 * (D.shape[0] - 1)
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    frames = np.fft.irfft(D.T, n=n_fft, axis=1)  # [T, n_fft]
    n_frames = frames.shape[0]
    out_len = n_fft + hop * (n_frames - 1)
    y = np.zeros(out_len, np.float64)
    wsum = np.zeros(out_len, np.float64)
    for t in range(n_frames):
        s = t * hop
        y[s : s + n_fft] += frames[t] * win
        wsum[s : s + n_fft] += win**2
    y = np.where(wsum > 1e-10, y / np.maximum(wsum, 1e-10), y)
    pad = n_fft // 2
    y = y[pad:]
    if length is not None:
        y = y[:length] if len(y) >= length else np.pad(y, (0, length - len(y)))
    return y


def phase_vocoder(D: np.ndarray, rate: float, hop: int) -> np.ndarray:
    """Pitch-preserving time stretch of a complex spectrogram.

    Vectorized port of the reference's numba kernel
    (asr/parts/utils/numba_utils.py:18-88, itself librosa.core.phase_vocoder):
    linear magnitude interpolation between straddling frames + accumulated
    wrapped phase advance (here as one cumsum instead of the frame loop).
    """
    n_bins = D.shape[0]
    phi_advance = np.linspace(0, np.pi * hop, n_bins)
    time_steps = np.arange(0, D.shape[1], rate)
    Dp = np.pad(D, [(0, 0), (0, 2)], mode="constant")
    idx = time_steps.astype(np.int64)
    alpha = np.mod(time_steps, 1.0)[None, :]
    c0 = Dp[:, idx]
    c1 = Dp[:, idx + 1]
    mag = (1.0 - alpha) * np.abs(c0) + alpha * np.abs(c1)
    dphase = np.angle(c1) - np.angle(c0) - phi_advance[:, None]
    dphase -= 2.0 * np.pi * np.round(dphase / (2.0 * np.pi))
    # phase used at output frame t is the accumulation over frames < t,
    # seeded with the first input frame's phase
    steps = phi_advance[:, None] + dphase
    phase = np.angle(D[:, :1]) + np.concatenate(
        [np.zeros((n_bins, 1)), np.cumsum(steps, axis=1)[:, :-1]], axis=1
    )
    return (mag * np.exp(1.0j * phase)).astype(np.complex64)


class TimeStretchPerturbation(Perturbation):
    """Pitch-preserving tempo change via STFT -> phase vocoder -> iSTFT
    (reference TimeStretchPerturbation, perturb.py:170-276, incl. the
    n_fft-doubling trick for slow-down rates)."""

    def __init__(self, min_speed_rate: float = 0.9, max_speed_rate: float = 1.1,
                 num_rates: int = 5, n_fft: int = 512):
        self.min_rate = float(min_speed_rate)
        self.max_rate = float(max_speed_rate)
        self.num_rates = num_rates
        if num_rates > 0:
            self.rates = np.linspace(min_speed_rate, max_speed_rate, num_rates)
        self.n_fft = int(n_fft)

    def max_augmentation_length(self, length: float) -> float:
        return length * self.max_rate

    def perturb(self, samples, sr, rng):
        if self.num_rates > 0:
            rate = float(self.rates[rng.randrange(self.num_rates)])
        else:
            rate = rng.uniform(self.min_rate, self.max_rate)
        if abs(rate - 1.0) < 1e-6:
            return samples
        # slow-down uses 2x n_fft (reference perturb.py:242-256)
        mult = 1 if rate >= 1.0 else 2
        n_fft = self.n_fft * mult
        hop = (self.n_fft // 2) * mult
        D = _stft_np(np.asarray(samples, np.float32), n_fft, hop)
        D2 = phase_vocoder(D, rate, hop)
        return _istft_np(D2, hop, int(round(len(samples) / rate))).astype(np.float32)


class GainPerturbation(Perturbation):
    """Random gain in dB (perturb.py:232)."""

    def __init__(self, min_gain_dbfs: float = -10, max_gain_dbfs: float = 10):
        self.min_gain = min_gain_dbfs
        self.max_gain = max_gain_dbfs

    def perturb(self, samples, sr, rng):
        gain = rng.uniform(self.min_gain, self.max_gain)
        return samples * (10.0 ** (gain / 20.0))


class ShiftPerturbation(Perturbation):
    """Time shift in ms, zero-filled (perturb.py:324)."""

    def __init__(self, min_shift_ms: float = -5.0, max_shift_ms: float = 5.0):
        self.min_shift = min_shift_ms
        self.max_shift = max_shift_ms

    def perturb(self, samples, sr, rng):
        shift_ms = rng.uniform(self.min_shift, self.max_shift)
        shift = int(sr * shift_ms / 1000.0)
        if shift == 0:
            return samples
        out = np.zeros_like(samples)
        if shift > 0:
            out[shift:] = samples[:-shift]
        else:
            out[:shift] = samples[-shift:]
        return out


class WhiteNoisePerturbation(Perturbation):
    """Gaussian noise at a random dB level (perturb.py:481)."""

    def __init__(self, min_level: float = -90, max_level: float = -46):
        self.min_level = min_level
        self.max_level = max_level

    def perturb(self, samples, sr, rng):
        level = rng.uniform(self.min_level, self.max_level)
        std = 10.0 ** (level / 20.0)
        noise = np.random.RandomState(rng.randrange(2 ** 31)).randn(len(samples)).astype(np.float32)
        return samples + std * noise


def _rms_db(x: np.ndarray) -> float:
    mean_sq = float(np.mean(x ** 2)) + 1e-12
    return 10.0 * np.log10(mean_sq)


class NoisePerturbation(Perturbation):
    """SNR-targeted mixing of noise clips from a manifest (perturb.py:377).

    Exposes the reference's three mixing entry points: `perturb` (background
    overlay), `mix_input_noise` (perturb_with_input_noise, perturb.py:439-456)
    and `mix_foreground_noise` (perturb_with_foreground_noise,
    perturb.py:460-484) — the latter two are composed by
    RirAndNoisePerturbation.
    """

    def __init__(self, manifest_path: str, min_snr_db: float = 10,
                 max_snr_db: float = 50, max_gain_db: float = 300.0,
                 audio_tar_filepaths=None, orig_sr: int = 16000):
        from conformer_nemo_tpu_torch.data.manifest import read_manifest

        _ignore_tarred(audio_tar_filepaths=audio_tar_filepaths)
        self.samples_meta = read_manifest(manifest_path)
        self.min_snr = min_snr_db
        self.max_snr = max_snr_db
        self.max_gain = max_gain_db
        self.orig_sr = orig_sr

    def get_one_noise_sample(self, sr: int, rng: random.Random) -> np.ndarray:
        meta = self.samples_meta[rng.randrange(len(self.samples_meta))]
        return load_audio(meta.audio_file, target_sr=sr)

    def perturb(self, samples, sr, rng):
        noise = self.get_one_noise_sample(sr, rng)
        return self.mix_input_noise(samples, noise, rng)

    def mix_input_noise(self, samples, noise, rng, data_rms=None):
        """Background overlay: one SNR-scaled noise segment across the clip."""
        if len(noise) == 0:
            return samples
        snr = rng.uniform(self.min_snr, self.max_snr)
        if data_rms is None:
            data_rms = _rms_db(samples)
        gain_db = min(data_rms - _rms_db(noise) - snr, self.max_gain)
        noise = noise * (10.0 ** (gain_db / 20.0))
        if len(noise) >= len(samples):
            start = rng.randrange(len(noise) - len(samples) + 1)
            return samples + noise[start : start + len(samples)]
        start = rng.randrange(len(samples) - len(noise) + 1)
        out = samples.copy()
        out[start : start + len(noise)] += noise
        return out

    def mix_foreground_noise(self, samples, noise, sr, rng, data_rms=None,
                             max_noise_dur: float = 2.0, max_additions: int = 1):
        """Foreground events: 1..max_additions short random noise snippets,
        all at one SNR-derived gain (perturb.py:460-484)."""
        if len(noise) == 0:
            return samples
        snr = rng.uniform(self.min_snr, self.max_snr)
        if data_rms is None:
            data_rms = _rms_db(samples)
        gain = 10.0 ** (min(data_rms - _rms_db(noise) - snr, self.max_gain) / 20.0)
        noise_duration = len(noise) / sr
        out = samples.copy()
        for _ in range(rng.randint(1, max(max_additions, 1))):
            noise_dur = rng.uniform(0.0, max_noise_dur)
            start_time = rng.uniform(0.0, noise_duration)
            start = int(round(start_time * sr))
            end = int(round(min(noise_duration, start_time + noise_dur) * sr))
            snippet = noise[start:end] * gain
            if len(snippet) > len(out):
                snippet = snippet[: len(out)]
            if len(snippet) == 0 or len(out) == len(snippet):
                idx = 0
            else:
                idx = rng.randrange(len(out) - len(snippet))
            out[idx : idx + len(snippet)] += snippet
        return out


class ImpulsePerturbation(Perturbation):
    """Room impulse response convolution (perturb.py:275-345).

    Matches the reference's two modes: plain 'same'-mode convolution with the
    min-max-normalized impulse, or (shift_impulse) convolution with the
    impulse tail from its peak onward so the response's onset delay is
    removed (perturb.py:334-344).
    """

    def __init__(self, manifest_path: str, shift_impulse: bool = False,
                 audio_tar_filepaths=None, shuffle_n: int = 128):
        from conformer_nemo_tpu_torch.data.manifest import read_manifest

        _ignore_tarred(audio_tar_filepaths=audio_tar_filepaths)
        self.samples_meta = read_manifest(manifest_path)
        self.shift_impulse = shift_impulse

    def perturb(self, samples, sr, rng):
        from scipy.signal import fftconvolve

        meta = self.samples_meta[rng.randrange(len(self.samples_meta))]
        rir = load_audio(meta.audio_file, target_sr=sr)
        if len(rir) == 0:
            return samples
        lo, hi = float(rir.min()), float(rir.max())
        rir = (rir - lo) / max(hi - lo, 1e-9)
        if not self.shift_impulse:
            out = fftconvolve(samples, rir, "same")
        else:
            resp = rir[int(np.argmax(np.abs(rir))):]
            out = fftconvolve(samples, resp, "full")[: -len(resp)]
        return out.astype(np.float32)


class RirAndNoisePerturbation(Perturbation):
    """RIR convolution + foreground and background noise at various SNRs
    (reference RirAndNoisePerturbation, perturb.py:508-624).

    Noise banks are keyed by the noise files' original sample rate
    (mixed-sample-rate training); lookups fall back to the highest key, same
    as the reference (perturb.py:606-614). Our loader resamples on read, so
    `orig_sample_rate` only selects the bank.
    """

    def __init__(
        self,
        rir_manifest_path=None,
        rir_prob: float = 0.5,
        noise_manifest_paths=None,
        min_snr_db=(0,),
        max_snr_db=(50,),
        rir_tar_filepaths=None,
        rir_shuffle_n: int = 100,
        noise_tar_filepaths=None,
        apply_noise_rir: bool = False,
        orig_sample_rate=None,
        max_additions: int = 5,
        max_duration: float = 2.0,
        bg_noise_manifest_paths=None,
        bg_min_snr_db=(10,),
        bg_max_snr_db=(50,),
        bg_noise_tar_filepaths=None,
        bg_orig_sample_rate=None,
    ):
        _ignore_tarred(rir_tar_filepaths=rir_tar_filepaths,
                       noise_tar_filepaths=noise_tar_filepaths,
                       bg_noise_tar_filepaths=bg_noise_tar_filepaths)
        self.rir_prob = rir_prob
        self.apply_noise_rir = apply_noise_rir
        self.max_additions = max_additions
        self.max_duration = max_duration
        self.rir = (
            ImpulsePerturbation(rir_manifest_path, shift_impulse=True)
            if rir_manifest_path else None
        )
        self.fg: dict[int, NoisePerturbation] = {}
        self.bg: dict[int, NoisePerturbation] = {}
        for i, path in enumerate(noise_manifest_paths or []):
            sr = (orig_sample_rate or [16000] * len(noise_manifest_paths))[i]
            self.fg[sr] = NoisePerturbation(
                path, min_snr_db=min_snr_db[i], max_snr_db=max_snr_db[i], orig_sr=sr)
        for i, path in enumerate(bg_noise_manifest_paths or []):
            sr = (bg_orig_sample_rate or [16000] * len(bg_noise_manifest_paths))[i]
            self.bg[sr] = NoisePerturbation(
                path, min_snr_db=bg_min_snr_db[i], max_snr_db=bg_max_snr_db[i], orig_sr=sr)

    def perturb(self, samples, sr, rng):
        if self.rir is not None and rng.uniform(0.0, 1.0) < self.rir_prob:
            samples = self.rir.perturb(samples, sr, rng)
        data_rms = _rms_db(samples)
        out = samples
        if self.fg:
            fg = self.fg.get(sr, self.fg[max(self.fg)])
            noise = fg.get_one_noise_sample(sr, rng)
            if self.apply_noise_rir and self.rir is not None:
                noise = self.rir.perturb(noise, sr, rng)
            out = fg.mix_foreground_noise(
                out, noise, sr, rng, data_rms=data_rms,
                max_noise_dur=self.max_duration, max_additions=self.max_additions)
        if self.bg:
            bg = self.bg.get(sr, self.bg[max(self.bg)])
            noise = bg.get_one_noise_sample(sr, rng)
            out = bg.mix_input_noise(out, noise, rng, data_rms=data_rms)
        return out


def _alaw_roundtrip(x: np.ndarray) -> np.ndarray:
    """G.711 a-law compand -> 8-bit quantize -> expand."""
    A = 87.6
    ln_a = 1.0 + np.log(A)
    ax = np.abs(np.clip(x, -1.0, 1.0))
    y = np.where(ax < 1.0 / A, A * ax / ln_a, (1.0 + np.log(np.maximum(A * ax, 1e-12))) / ln_a)
    y = np.sign(x) * y
    y = np.round(y * 127.0) / 127.0  # 8-bit levels
    ay = np.abs(y)
    out = np.where(ay < 1.0 / ln_a, ay * ln_a / A, np.exp(ay * ln_a - 1.0) / A)
    return (np.sign(y) * out).astype(np.float32)


class TranscodePerturbation(Perturbation):
    """Codec simulation (reference TranscodePerturbation, perturb.py:627-686).

    The reference shells out to sox for g711/amr-nb/ogg. sox is not a
    dependency here; the g711 chain (resample to 8 kHz, 300-3400 Hz band
    limit, a-law 8-bit round-trip, resample back) is implemented natively.
    amr-nb/ogg require their actual codecs and are rejected with a clear
    error instead of silently approximated.
    """

    def __init__(self, codecs=None):
        self.att_factor = 0.8
        self._codecs = list(codecs) if codecs is not None else ["g711"]
        for codec in self._codecs:
            if codec not in ("g711",):
                raise ValueError(
                    f"TranscodePerturbation: codec {codec!r} needs an external "
                    "codec binary (sox) and is not supported; use ['g711']")

    def perturb(self, samples, sr, rng):
        from scipy.signal import butter, lfilter

        max_level = float(np.max(np.abs(samples))) if len(samples) else 0.0
        out = samples * (self.att_factor / max_level) if max_level > 0.8 else samples.copy()
        narrow = resample_poly(out, sr, 8000)
        b, a = butter(4, [300.0 / 4000.0, 3400.0 / 4000.0], btype="band")
        narrow = lfilter(b, a, narrow).astype(np.float32)
        narrow = _alaw_roundtrip(narrow)
        wide = resample_poly(narrow, 8000, sr)
        if len(wide) >= len(samples):
            return wide[: len(samples)].astype(np.float32)
        return np.pad(wide, (0, len(samples) - len(wide))).astype(np.float32)


@dataclasses.dataclass
class _Entry:
    prob: float
    perturbation: Perturbation


class AudioAugmentor:
    """Applies each registered perturbation with its probability
    (perturb.py:709-737)."""

    def __init__(self, perturbations: Optional[List[tuple]] = None, seed: Optional[int] = None):
        self._rng = random.Random(seed)
        self._entries = [ _Entry(p, pert) for p, pert in (perturbations or []) ]

    def perturb(self, samples: np.ndarray, sr: int, rng: Optional[random.Random] = None) -> np.ndarray:
        """`rng`: optional per-item RNG. Parallel loaders pass a stream derived
        from (seed, epoch, sample index) so augmentation is deterministic and
        thread-safe regardless of worker count/scheduling; the shared
        `self._rng` (reference semantics) remains the single-threaded default."""
        rng = rng if rng is not None else self._rng
        for e in self._entries:
            if rng.random() <= e.prob:
                samples = e.perturbation.perturb(samples, sr, rng)
        return np.ascontiguousarray(samples, dtype=np.float32)

    def max_augmentation_length(self, length: float) -> float:
        for e in self._entries:
            length = e.perturbation.max_augmentation_length(length)
        return length


_REGISTRY = {
    "speed": SpeedPerturbation,
    "time_stretch": TimeStretchPerturbation,
    "gain": GainPerturbation,
    "shift": ShiftPerturbation,
    "white_noise": WhiteNoisePerturbation,
    "noise": NoisePerturbation,
    "impulse": ImpulsePerturbation,
    "rir_noise_aug": RirAndNoisePerturbation,
    "transcode_aug": TranscodePerturbation,
}


def process_augmentations(augmenter_cfg: Optional[dict], seed: Optional[int] = None) -> Optional[AudioAugmentor]:
    """Config dict {name: {prob: p, **kwargs}} -> AudioAugmentor
    (perturb.py:738 registry semantics)."""
    if not augmenter_cfg:
        return None
    entries = []
    for name, kwargs in augmenter_cfg.items():
        kwargs = dict(kwargs or {})
        prob = float(kwargs.pop("prob", 1.0))
        cls = _REGISTRY.get(name)
        if cls is None:
            raise ValueError(f"unknown perturbation '{name}' (known: {sorted(_REGISTRY)})")
        entries.append((prob, cls(**kwargs)))
    return AudioAugmentor(entries, seed=seed)
