"""Port WAV reading and resampling vs the JAX package's (both numpy/scipy:
results must be identical); FLAC through the port's own decoder equals the
JAX package's bit for bit (tests/test_torch_codecs.py holds the rest of
the formats)."""

import os
import wave

import numpy as np
import pytest

from conformer_nemo_tpu.data import audio_io as jax_io
from conformer_nemo_tpu_torch.data import audio_io as port_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(path, width, channels, sr, rng):
    n = 1234
    if width == 1:
        raw = rng.randint(0, 256, size=n * channels).astype(np.uint8).tobytes()
    else:
        raw = rng.randint(0, 256, size=n * channels * width).astype(np.uint8).tobytes()
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(raw)


@pytest.mark.parametrize("width,channels,sr", [(1, 1, 16000), (2, 2, 16000), (3, 1, 8000),
                                               (4, 2, 22050)])
def test_read_and_load_wav_match_jax(tmp_path, width, channels, sr):
    path = str(tmp_path / "x.wav")
    _write(path, width, channels, sr, np.random.RandomState(width))
    got, got_sr = port_io.read_wav(path)
    want, want_sr = jax_io.read_wav(path)
    assert got_sr == want_sr and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_io.load_audio(path, 16000),
                                  jax_io.load_audio(path, 16000))
    np.testing.assert_array_equal(port_io.load_audio(path, 16000, offset=0.01, duration=0.02),
                                  jax_io.load_audio(path, 16000, offset=0.01, duration=0.02))


def test_write_wav_round_trip_and_other_containers_raise(tmp_path):
    x = np.sin(np.linspace(0, 50, 4000)).astype(np.float32) * 0.5
    path = str(tmp_path / "y.wav")
    port_io.write_wav(path, x)
    np.testing.assert_array_equal(port_io.load_audio(path), jax_io.load_audio(path))
    assert np.abs(port_io.load_audio(path) - x).max() < 1e-4  # PCM16 rounding
    # FLAC, once refused, now decodes as the JAX package decodes it
    flac = os.path.join(ROOT, "tests", "fixtures", "speech", "utt1.flac")
    np.testing.assert_array_equal(port_io.load_audio(flac), jax_io.load_audio(flac))
    # a container neither package knows raises in both
    (tmp_path / "z.bin").write_bytes(b"not audio at all")
    for io in (port_io, jax_io):
        with pytest.raises(ValueError, match="unrecognized audio container"):
            io.load_audio(str(tmp_path / "z.bin"))
