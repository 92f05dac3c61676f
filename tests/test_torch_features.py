"""Port log-mel frontend vs the JAX frontend (dither off, inference).

Inputs: the fixture WAVs (batched with zero padding), int16 PCM and int8
mu-law transport batches, plus the frontend's config variants. Frame
lengths must match exactly; normalised log-mel values within 1e-3
absolute: the log and the per-feature normalisation amplify fp32
summation-order differences of the two STFT formulations (one framed
matmul here, four hop-aligned partial products there) near silence.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.audio import features as jf
from conformer_nemo_tpu_torch.audio import features as pf
from conformer_nemo_tpu_torch.data.audio_io import load_audio

torch.set_num_threads(2)

SPEECH = os.path.join(os.path.dirname(__file__), "fixtures", "speech")
ATOL = 1e-3


def _batch(zero_row=True):
    wavs = [load_audio(os.path.join(SPEECH, f)) for f in ("utt0.wav", "utt2.wav", "utt4.wav")]
    t = max(len(w) for w in wavs) + 800
    rows = len(wavs) + int(zero_row)  # the last row: an all-zero padding row
    audio = np.zeros((rows, t), np.float32)
    lens = np.zeros((rows,), np.int32)
    for i, w in enumerate(wavs):
        audio[i, : len(w)] = w
        lens[i] = len(w)
    return audio, lens


def _compare(jcfg, pcfg, audio, lens):
    mel_j, len_j = jf.log_mel_spectrogram(jcfg, jnp.asarray(audio), jnp.asarray(lens))
    mel_p, len_p = pf.log_mel_spectrogram(pcfg, torch.from_numpy(audio), torch.from_numpy(lens))
    np.testing.assert_array_equal(len_p.numpy(), np.asarray(len_j))
    assert mel_p.shape == mel_j.shape and mel_p.dtype == torch.float32
    np.testing.assert_allclose(mel_p.numpy(), np.asarray(mel_j), rtol=0, atol=ATOL)


CONFIGS = {
    "default": {},
    "all_features_pad16": {"normalize": "all_features", "pad_to": 16, "pad_value": -1.0},
    "hamming_clamp_mag1": {"window": "hamming", "log_zero_guard_type": "clamp",
                           "mag_power": 1.0, "normalize": "none"},
    "exact_pad_pad_max": {"exact_pad": True, "pad_to": "max", "max_duration": 1.5},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_log_mel_matches_jax_on_fixture_wavs(name):
    kw = dict(dither=0.0, **CONFIGS[name])
    # all_features normalises a zero row by a zero std: its values are
    # rounding noise times 1e5 in both frameworks, so leave that row out
    audio, lens = _batch(zero_row=name != "all_features_pad16")
    _compare(jf.MelFeatureConfig(**kw), pf.MelFeatureConfig(**kw), audio, lens)


@pytest.mark.parametrize("transport", ["int16", "int8"])
def test_log_mel_matches_jax_on_transport_dtypes(transport):
    audio, lens = _batch()
    if transport == "int16":
        wire = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    else:  # mu-law (mu=255) code, as data/audio_io.py mulaw8_encode
        y = np.sign(audio) * np.log1p(255.0 * np.abs(audio)) / np.log(256.0)
        wire = np.clip(np.rint(y * 127.0), -127, 127).astype(np.int8)
    _compare(jf.MelFeatureConfig(dither=0.0), pf.MelFeatureConfig(dither=0.0), wire, lens)


def test_mel_constants_and_seq_len_match_jax():
    np.testing.assert_array_equal(pf.mel_filterbank(16000, 512, 80),
                                  jf.mel_filterbank(16000, 512, 80))
    np.testing.assert_array_equal(pf.stft_basis(512, 400, "hann"), jf.stft_basis(512, 400, "hann"))
    n = np.array([0, 1, 159, 160, 16000, 799999, 800000], np.int32)
    for cfg_kw in ({}, {"exact_pad": True}):
        got = pf.mel_seq_len(pf.MelFeatureConfig(**cfg_kw), torch.from_numpy(n)).numpy()
        want = np.asarray(jf.mel_seq_len(jf.MelFeatureConfig(**cfg_kw), jnp.asarray(n)))
        np.testing.assert_array_equal(got, want)
