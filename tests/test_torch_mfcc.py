"""The port's MFCC front end (audio/mfcc.py) against the JAX package's, on the
CPU: the DCT basis equal, the frame lengths equal, the coefficients within
1e-4 of the JAX output's largest magnitude (fp32 on both sides: the STFT
and mel products sum in other orders, and the log of the mel power turns
their rounding into absolute error), for the log and dB variants, the
default and a narrower configuration, unequal lengths and an n_fft given.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.audio import mfcc as jmfcc
from conformer_nemo_tpu_torch.audio import mfcc as pmfcc

torch.set_num_threads(2)

REL = 1e-4
CONFIGS = {
    "default_log": {},
    "default_db": {"log": False},
    "narrow_log": {"n_mels": 32, "n_mfcc": 16},
    "n_fft_512_db": {"n_fft": 512, "n_mels": 40, "n_mfcc": 13, "log": False, "highfreq": 7000.0,
                     "lowfreq": 20.0},
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mfcc_matches_jax(name):
    kw = CONFIGS[name]
    rs = np.random.RandomState(len(name))
    t = np.arange(16000) / 16000
    wav = np.stack([0.1 * rs.randn(16000) + 0.3 * np.sin(2 * np.pi * 440 * t),
                    0.05 * rs.randn(16000)]).astype(np.float32)
    lens = np.array([16000, 9000], np.int32)
    want, want_len = jmfcc.mfcc(jmfcc.MFCCConfig(**kw), jnp.asarray(wav), jnp.asarray(lens))
    got, got_len = pmfcc.mfcc(pmfcc.MFCCConfig(**kw), wav, lens, device="cpu")
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert got.shape[1] == kw.get("n_mfcc", 64)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    err = np.abs(got.numpy() - want).max()
    assert err <= REL * np.abs(want).max(), (err, np.abs(want).max())


def test_dct_basis_and_config_equal_jax():
    for n_mfcc, n_mels, norm in ((64, 64, "ortho"), (13, 40, "ortho"), (16, 32, None)):
        np.testing.assert_array_equal(pmfcc.dct_matrix(n_mfcc, n_mels, norm),
                                      jmfcc.dct_matrix(n_mfcc, n_mels, norm))
    d = pmfcc.dct_matrix(32, 32)
    np.testing.assert_allclose(d.T @ d, np.eye(32), atol=1e-5)
    for kw in ({}, {"window_size": 0.025, "sample_rate": 8000}, {"n_fft": 1024}):
        p, j = pmfcc.MFCCConfig(**kw), jmfcc.MFCCConfig(**kw)
        assert (p.win_length, p.hop_length, p.n_fft_) == (j.win_length, j.hop_length, j.n_fft_)


def test_int16_samples_are_taken_as_they_are():
    """As the JAX function: samples cast to float32, not rescaled."""
    wav = (np.random.RandomState(0).randn(1, 4000) * 3000).astype(np.int16)
    lens = np.array([4000], np.int32)
    cfg = {"n_mels": 32, "n_mfcc": 16}
    want, _ = jmfcc.mfcc(jmfcc.MFCCConfig(**cfg), jnp.asarray(wav), jnp.asarray(lens))
    got, _ = pmfcc.mfcc(pmfcc.MFCCConfig(**cfg), torch.from_numpy(wav), lens, device="cpu")
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= REL * np.abs(want).max()
