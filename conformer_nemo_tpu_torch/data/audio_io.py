"""Host-side audio decode (port of conformer_nemo_tpu/data/audio_io.py).

WAV (PCM 8/16/24/32-bit) is parsed from the RIFF container with the
standard library; FLAC through the port's own decoder (data/csrc/
flac_decoder.cpp, built at first use by ops/build.py); MP3, Ogg/Vorbis and
Ogg/Opus through data/codecs.py. Resampling is scipy's polyphase filter, as
in the JAX package. `load_audio` dispatches on the extension (on magic
bytes for .ogg/.oga and unknown extensions); a decoder never gives way to
another.

The integer transports start here: `load_audio_pcm16` reads mono 16-bit
WAV or FLAC at the target rate straight to int16 and decodes anything else
(a lossy file, another rate or width) through `load_audio` before
quantising, and `mulaw8_encode` makes the 8-bit mu-law code that the
frontend expands on the device (audio/features.py).
"""

from __future__ import annotations

import ctypes
import io
import wave
from fractions import Fraction

import numpy as np

from conformer_nemo_tpu_torch.ops.build import host_library


def _parse_wav(w) -> tuple[np.ndarray, int]:
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
        raise ValueError(f"unsupported WAV sample width {width}")
    if n_ch > 1:
        data = data.reshape(-1, n_ch)
    return data, sr


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 samples [T] mono or [T, C], sample_rate)."""
    with wave.open(path, "rb") as w:
        return _parse_wav(w)


def read_wav_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """Parse an in-memory WAV (a tar member)."""
    with wave.open(io.BytesIO(data), "rb") as w:
        return _parse_wav(w)


def _flac_lib() -> ctypes.CDLL:
    lib = host_library("flac_decoder")
    lib.flac_decode.restype = ctypes.c_int
    lib.flac_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.flac_free.argtypes = [ctypes.POINTER(ctypes.c_int32)]
    return lib


def _read_flac_raw(data: bytes) -> tuple[np.ndarray, int, int, int]:
    """-> (int32 samples [T * C] interleaved, channels, sr, bits_per_sample)."""
    lib = _flac_lib()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    out = ctypes.POINTER(ctypes.c_int32)()
    n, ch, sr, bps = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.flac_decode(buf, len(data), ctypes.byref(out), ctypes.byref(n), ctypes.byref(ch),
                         ctypes.byref(sr), ctypes.byref(bps))
    if rc != 0:
        raise ValueError(f"FLAC decode failed (code {rc})")
    try:
        total = n.value * ch.value
        arr = (np.ctypeslib.as_array(out, shape=(total,)).copy() if total
               else np.zeros((0,), np.int32))
    finally:
        lib.flac_free(out)
    return arr, ch.value, sr.value, bps.value


def read_flac_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """Decode an in-memory FLAC stream -> (float32 [T] or [T, C], sr)."""
    arr, ch, sr, bps = _read_flac_raw(data)
    audio = arr.astype(np.float32) / float(1 << (bps - 1))
    if ch > 1:
        audio = audio.reshape(-1, ch)
    return audio, sr


def read_flac(path: str) -> tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        return read_flac_bytes(f.read())


def trim_silence(x: np.ndarray, top_db: float = 60.0, frame_length: int = 2048,
                 hop_length: int = 512) -> np.ndarray:
    """Drop the leading and trailing frames whose RMS lies more than top_db
    below the loudest frame's (librosa.effects.trim's rule)."""
    if len(x) == 0:
        return x
    n_frames = max(1, 1 + (len(x) - frame_length) // hop_length) if len(x) >= frame_length else 1
    rms = np.empty(n_frames, np.float64)
    for i in range(n_frames):
        seg = x[i * hop_length: i * hop_length + frame_length]
        rms[i] = np.sqrt(np.mean(np.square(seg, dtype=np.float64))) if len(seg) else 0.0
    ref = rms.max()
    if ref <= 0:
        return x
    keep = rms > ref * (10.0 ** (-top_db / 20.0))
    if not keep.any():
        return x[:0]
    first, last = int(np.argmax(keep)), int(len(keep) - 1 - np.argmax(keep[::-1]))
    return x[first * hop_length: min(len(x), last * hop_length + frame_length)]


def resample_poly(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return x
    from scipy.signal import resample_poly as _rp

    frac = Fraction(target_sr, orig_sr)
    return _rp(x, frac.numerator, frac.denominator).astype(np.float32)


def decode_audio_bytes(data: bytes, hint: str = "") -> tuple[np.ndarray, int]:
    """Decode an in-memory container (WAV, FLAC, MP3, Ogg/Vorbis, Ogg/Opus)
    by its magic bytes -> (float32 [T] or [T, C], sr); `hint` (a file name)
    only goes into the error message."""
    from conformer_nemo_tpu_torch.data import codecs

    readers = {"wav": read_wav_bytes, "flac": read_flac_bytes, "mp3": codecs.read_mp3_bytes,
               "ogg": codecs.read_ogg_bytes, "opus": codecs.read_opus_bytes}
    reader = readers.get(codecs.sniff_container(data))
    if reader is None:
        raise ValueError(f"unrecognized audio container{f' for {hint}' if hint else ''} "
                         "(supported: WAV, FLAC, MP3, Ogg/Vorbis, Ogg/Opus)")
    return reader(data)


def load_audio(path: str, target_sr: int = 16000, offset: float = 0.0, duration: float = 0.0,
               mono: bool = True, trim: bool = False) -> np.ndarray:
    """Decode, mono-mix, crop, resample (and with `trim`, trim silence)
    -> float32 [T] at target_sr."""
    from conformer_nemo_tpu_torch.data import codecs

    lower = path.lower()
    if lower.endswith(".flac"):
        data, sr = read_flac(path)
    elif lower.endswith(".wav"):
        data, sr = read_wav(path)
    elif lower.endswith(".mp3"):
        data, sr = codecs.read_mp3(path)
    elif lower.endswith(".opus"):
        data, sr = codecs.read_opus(path)
    else:  # .ogg/.oga hold Vorbis or Opus, and an unknown extension anything
        with open(path, "rb") as f:
            data, sr = decode_audio_bytes(f.read(), hint=path)
    if mono and data.ndim > 1:
        data = data.mean(axis=1)
    if offset > 0 or duration > 0:
        start = int(offset * sr)
        end = start + int(duration * sr) if duration > 0 else len(data)
        data = data[start:end]
    data = resample_poly(data, sr, target_sr)
    if trim:
        data = trim_silence(data)
    return np.ascontiguousarray(data, dtype=np.float32)


def _lossless_pcm16(path: str, target_sr: int):
    """int16 [T] of a mono 16-bit WAV or FLAC at target_sr, else None."""
    lower = path.lower()
    if lower.endswith(".flac"):
        with open(path, "rb") as f:
            arr, ch, sr, bps = _read_flac_raw(f.read())
        return arr.astype(np.int16) if (ch, bps, sr) == (1, 16, target_sr) else None
    if lower.endswith(".wav"):
        with wave.open(path, "rb") as w:
            if (w.getnchannels(), w.getsampwidth(), w.getframerate()) != (1, 2, target_sr):
                return None
            return np.frombuffer(w.readframes(w.getnframes()), dtype="<i2").copy()
    return None  # a lossy container


def load_audio_pcm16(path: str, target_sr: int = 16000, offset: float = 0.0,
                     duration: float = 0.0) -> np.ndarray:
    """int16 [T]: straight from a lossless mono 16-bit WAV or FLAC already at
    target_sr (no float round trip), else `load_audio` quantised. Which one
    is a property of the file (the JAX package's format rule), not a
    fallback: both give the same samples where both apply."""
    data = _lossless_pcm16(path, target_sr)
    if data is None:
        x = load_audio(path, target_sr=target_sr, offset=offset, duration=duration)
        return np.clip(x * 32768.0, -32768, 32767).astype(np.int16)
    if offset > 0 or duration > 0:
        start = int(offset * target_sr)
        end = start + int(duration * target_sr) if duration > 0 else len(data)
        data = data[start:end]
    return data


def mulaw8_encode(x: np.ndarray) -> np.ndarray:
    """float32 [-1, 1] (or int16) waveform -> int8 mu-law (mu = 255) code:
    a quarter of f32's bytes on the host-to-device link at ~38 dB SNR; the
    frontend expands it on the device."""
    if x.dtype == np.int16:
        x = x.astype(np.float32) * (1.0 / 32768.0)
    x = np.clip(x.astype(np.float32), -1.0, 1.0)
    y = np.sign(x) * np.log1p(255.0 * np.abs(x)) * (1.0 / np.log(256.0))
    return np.clip(np.rint(y * 127.0), -127, 127).astype(np.int8)


def write_wav(path: str, samples: np.ndarray, sr: int = 16000) -> None:
    """Mono PCM16 writer."""
    pcm = np.clip(samples, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
