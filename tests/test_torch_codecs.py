"""The port's audio decoders and encoders against the JAX package's, on the CPU.

- FLAC through the port's own decoder (data/csrc/flac_decoder.cpp): bit for
  bit the JAX package's `read_flac` on the repo's fixture FLACs and on files
  written by both packages' encoders (which write the same bytes);
- MP3, Ogg/Vorbis and Ogg/Opus: the port's decode equals the JAX decoder's
  bit for bit (the same system libraries), and the round trip from the
  source keeps an SNR of at least CODEC_MIN_SNR_DB;
- `sniff_container`, `decode_audio_bytes`, `load_audio`'s dispatch for
  every extension, `trim_silence`, `load_audio_pcm16` (lossless and
  decoded), `mulaw8_encode`: equal to the JAX package's;
- the host libraries' build: a missing system library raises naming it (no
  decoder stands in), a failed build raises with the compiler's output and
  is retried, and threads that reach a first build at once share one build.
"""

import os
import threading
import wave

import numpy as np
import pytest

from conformer_nemo_tpu.data import audio_io as jax_io
from conformer_nemo_tpu.data import codecs as jax_codecs
from conformer_nemo_tpu.data import flac_encode as jax_flac
from conformer_nemo_tpu_torch.data import audio_io as port_io
from conformer_nemo_tpu_torch.data import codecs as port_codecs
from conformer_nemo_tpu_torch.data import flac_encode as port_flac
from conformer_nemo_tpu_torch.ops import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEECH = os.path.join(ROOT, "tests", "fixtures", "speech")
# a lossy round trip of tones in white noise against its source: the noise
# costs the codecs most (measured 15.6 dB Vorbis q0.4, 18.0 dB MP3 128 kbps,
# 23.9 dB Opus 64 kbps on this signal)
CODEC_MIN_SNR_DB = 10.0
FIXTURE_SAMPLES = {"utt1.flac": 16320, "utt3.flac": 14080, "utt5.flac": 14080}


def _signal(seconds=3.0, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    tones = sum(0.1 * np.sin(2 * np.pi * f * t) for f in rng.uniform(150, 3000, 3))
    return (0.05 * rng.randn(len(t)) + tones).astype(np.float32)


@pytest.mark.parametrize("name", sorted(FIXTURE_SAMPLES))
def test_fixture_flac_decodes_bit_for_bit(name):
    path = os.path.join(SPEECH, name)
    got, sr = port_io.read_flac(path)
    want, want_sr = jax_io.read_flac(path)
    assert sr == want_sr == 16000 and got.shape == (FIXTURE_SAMPLES[name],)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_io.load_audio(path, 8000), jax_io.load_audio(path, 8000))
    np.testing.assert_array_equal(port_io.load_audio_pcm16(path), jax_io.load_audio_pcm16(path))


@pytest.mark.parametrize("n,block", [(40000, 4096), (4097, 4096), (3, 4096), (12345, 1024)])
def test_flac_encoders_and_decoders_agree(tmp_path, n, block):
    x = _signal(n / 16000, seed=n)[:n]
    data = port_flac.encode_flac(x, block=block)
    assert data == jax_flac.encode_flac(x, block=block)
    ints = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    assert port_flac.encode_flac(ints, block=block) == data
    path = str(tmp_path / "a.flac")
    port_flac.write_flac(path, x, block=block)
    got, _ = port_io.read_flac_bytes(data)
    np.testing.assert_array_equal(got, jax_io.read_flac(path)[0])
    # the int16 it was written from, bit for bit
    np.testing.assert_array_equal(port_io.load_audio_pcm16(path), ints)


@pytest.mark.parametrize("codec,ext", [("mp3", ".mp3"), ("ogg", ".ogg"), ("ogg", ".oga"),
                                       ("opus", ".opus"), ("opus", ".ogg")])
def test_lossy_codecs_match_jax_and_keep_the_snr(tmp_path, codec, ext):
    assert port_codecs.have_codec(codec) and jax_codecs.have_codec(codec)
    x = _signal()
    path = str(tmp_path / f"a{ext}")
    {"mp3": port_codecs.write_mp3, "ogg": port_codecs.write_ogg,
     "opus": port_codecs.write_opus}[codec](path, x)
    with open(path, "rb") as f:
        data = f.read()
    assert port_codecs.sniff_container(data) == jax_codecs.sniff_container(data) == codec
    got = port_io.load_audio(path)
    np.testing.assert_array_equal(got, jax_io.load_audio(path))
    np.testing.assert_array_equal(port_io.decode_audio_bytes(data)[0],
                                  jax_io.decode_audio_bytes(data)[0])
    np.testing.assert_array_equal(port_io.load_audio_pcm16(path), jax_io.load_audio_pcm16(path))
    snr, _ = port_codecs.snr_db(x, got)
    assert snr >= CODEC_MIN_SNR_DB, snr


def test_containers_sniff_and_dispatch_like_jax(tmp_path):
    x = _signal(1.0)
    wav, flac = str(tmp_path / "a.wav"), str(tmp_path / "a.flac")
    port_io.write_wav(wav, x)
    port_flac.write_flac(flac, x)
    for path, kind in ((wav, "wav"), (flac, "flac")):
        with open(path, "rb") as f:
            data = f.read()
        assert port_codecs.sniff_container(data) == kind
        a, sa = port_io.decode_audio_bytes(data)
        b, sb = jax_io.decode_audio_bytes(data)
        assert sa == sb
        np.testing.assert_array_equal(a, b)
        # a file with an unknown extension dispatches on its magic bytes
        odd = str(tmp_path / f"{kind}.audio")
        with open(odd, "wb") as f:
            f.write(data)
        np.testing.assert_array_equal(port_io.load_audio(odd), jax_io.load_audio(odd))
    for head in (b"ID3\x03", b"\xff\xfb\x90", b"OggS" + bytes(40), b"junk"):
        assert port_codecs.sniff_container(head) == jax_codecs.sniff_container(head)
    with pytest.raises(ValueError, match="unrecognized audio container for x.bin"):
        port_io.decode_audio_bytes(b"junk", hint="x.bin")


def test_trim_pcm16_and_mulaw_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    x = np.concatenate([np.zeros(5000), 0.3 * rng.randn(7000), 1e-5 * rng.randn(6000)])
    x = x.astype(np.float32)
    for top_db in (60.0, 30.0, 10.0):
        np.testing.assert_array_equal(port_io.trim_silence(x, top_db),
                                      jax_io.trim_silence(x, top_db))
    for y in (np.zeros(100, np.float32), x[:10], np.zeros(0, np.float32)):
        np.testing.assert_array_equal(port_io.trim_silence(y), jax_io.trim_silence(y))
    path = str(tmp_path / "a.wav")
    port_io.write_wav(path, x)
    np.testing.assert_array_equal(port_io.load_audio(path, trim=True),
                                  jax_io.load_audio(path, trim=True))
    for sr, kw in ((16000, {}), (16000, {"offset": 0.1, "duration": 0.5}), (8000, {}),
                   (16000, {"duration": 0.25})):
        np.testing.assert_array_equal(port_io.load_audio_pcm16(path, sr, **kw),
                                      jax_io.load_audio_pcm16(path, sr, **kw))
    stereo = str(tmp_path / "b.wav")
    with wave.open(stereo, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((rng.randn(4000) * 3000).astype("<i2").tobytes())
    np.testing.assert_array_equal(port_io.load_audio_pcm16(stereo),
                                  jax_io.load_audio_pcm16(stereo))
    for y in (x, np.clip(x * 4, -2, 2), (x * 32767).astype(np.int16)):
        np.testing.assert_array_equal(port_io.mulaw8_encode(y), jax_io.mulaw8_encode(y))


@pytest.fixture
def scratch_build(tmp_path, monkeypatch):
    """The host libraries built into an empty directory, as at first use."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_HOST_LIBS", {})
    return tmp_path


def test_missing_system_library_raises_naming_it(scratch_build, monkeypatch):
    real = build.find_system_library
    monkeypatch.setattr(build, "find_system_library",
                        lambda stem: None if stem == "libvorbisfile" else real(stem))
    with pytest.raises(build.MissingSystemLibrary, match="libvorbisfile"):
        port_codecs.read_ogg_bytes(b"OggS")
    assert not port_codecs.have_codec("ogg")
    report = build.build_host_all()
    assert "libvorbisfile" in report["ogg_mem"]["missing"]
    assert "seconds" in report["opus_mem"] and "seconds" in report["flac_decoder"]
    monkeypatch.setattr(port_codecs, "_lib", lambda sonames: (_ for _ in ()).throw(
        build.MissingSystemLibrary(f"the codec library {sonames[0]} is not available")))
    with pytest.raises(build.MissingSystemLibrary, match="libmpg123"):
        port_codecs.read_mp3_bytes(b"ID3")
    assert not port_codecs.have_codec("mp3")
    # no decoder stands in for another: an MP3 file never reaches the Ogg path
    path = str(scratch_build / "a.mp3")
    with open(path, "wb") as f:
        f.write(b"ID3\x03" + bytes(64))
    with pytest.raises(build.MissingSystemLibrary, match="libmpg123"):
        port_io.load_audio(path)


def test_failed_build_raises_with_the_compiler_output(scratch_build, monkeypatch):
    csrc = scratch_build / "csrc"
    csrc.mkdir()
    (csrc / "flac_decoder.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(build, "HOST_CSRC_DIR", str(csrc))
    for _ in range(2):  # a failure is not remembered: the second call builds again
        with pytest.raises(RuntimeError, match=r"g\+\+ failed for flac_decoder.cpp:\n.*error"):
            port_io.read_flac(os.path.join(SPEECH, "utt1.flac"))
    assert not os.path.exists(os.path.join(build.BUILD_DIR, "libflac_decoder.so"))
    assert os.listdir(build.BUILD_DIR) == []  # no half-written library left behind


def test_threads_share_one_first_build(scratch_build):
    path = os.path.join(SPEECH, "utt3.flac")
    want = jax_io.read_flac(path)[0]
    results, errors = [], []

    def read():
        try:
            results.append(port_io.read_flac(path)[0])
        except Exception as e:  # collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=read) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(results) == 8 and all(np.array_equal(r, want) for r in results)
    assert sorted(os.listdir(build.BUILD_DIR)) == ["libflac_decoder.so"]
    assert set(build._HOST_LIBS) == {"flac_decoder"}
