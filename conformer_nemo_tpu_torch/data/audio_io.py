"""Host-side audio decode (port of conformer_nemo_tpu/data/audio_io.py).

WAV files (PCM 8/16/24/32-bit) are parsed from the RIFF container with the
standard library and resampled with scipy's polyphase filter, as in the JAX
package. FLAC, MP3 and Ogg decoding are not ported yet (ROADMAP.md queue 1,
"FLAC/MP3 decode"): `load_audio` raises for them.
"""

from __future__ import annotations

import wave
from fractions import Fraction

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 samples [T] mono or [T, C], sample_rate)."""
    with wave.open(path, "rb") as w:
        sr, n_ch, width = w.getframerate(), w.getnchannels(), w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        b = np.zeros((a.shape[0], 4), dtype=np.uint8)
        b[:, 1:] = a
        data = b.view("<i4")[:, 0].astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV sample width {width} in {path}")
    if n_ch > 1:
        data = data.reshape(-1, n_ch)
    return data, sr


def resample_poly(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return x
    from scipy.signal import resample_poly as _rp

    frac = Fraction(target_sr, orig_sr)
    return _rp(x, frac.numerator, frac.denominator).astype(np.float32)


def load_audio(
    path: str,
    target_sr: int = 16000,
    offset: float = 0.0,
    duration: float = 0.0,
    mono: bool = True,
) -> np.ndarray:
    """Decode + mono-mix + resample + crop -> float32 [T] at target_sr."""
    if not path.lower().endswith(".wav"):
        raise NotImplementedError(
            f"{path}: only WAV decoding is ported so far; FLAC/MP3/Ogg wait "
            "for the ROADMAP.md queue-1 item 'FLAC/MP3 decode'")
    data, sr = read_wav(path)
    if mono and data.ndim > 1:
        data = data.mean(axis=1)
    if offset > 0 or duration > 0:
        start = int(offset * sr)
        end = start + int(duration * sr) if duration > 0 else len(data)
        data = data[start:end]
    data = resample_poly(data, sr, target_sr)
    return np.ascontiguousarray(data, dtype=np.float32)


def write_wav(path: str, samples: np.ndarray, sr: int = 16000) -> None:
    """Mono PCM16 writer."""
    pcm = np.clip(samples, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
