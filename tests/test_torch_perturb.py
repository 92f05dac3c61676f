"""The port's waveform perturbations against the JAX package's, on the CPU:
each perturbation, given `random.Random` streams of equal seed, returns the
same waveform (both are numpy/scipy on the same draws, so the limit is
exact equality; the time-stretch phase vocoder's float64 path included),
and leaves the stream in the same state. Then the `AudioAugmentor` built
by `process_augmentations` from one config in both packages, with its
seeded default stream and with per-item streams; what the port cannot
honour raises."""

import json
import random

import numpy as np
import pytest

from conformer_nemo_tpu.audio import perturb as jax_pt
from conformer_nemo_tpu_torch.audio import perturb as port_pt
from conformer_nemo_tpu_torch.data.audio_io import write_wav


def _wave(n=9000, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000
    return (0.2 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.randn(n)).astype(np.float32)


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    """Noise and RIR manifests of generated clips."""
    d = tmp_path_factory.mktemp("banks")
    rng = np.random.RandomState(1)
    paths = {}
    for name, clips in (("noise", [0.1 * rng.randn(n) for n in (4000, 12000, 30000)]),
                        ("rir", [np.exp(-np.arange(n) / 300.0) * rng.randn(n)
                                 for n in (800, 1600)])):
        with open(d / f"{name}.json", "w", encoding="utf-8") as f:
            for i, clip in enumerate(clips):
                wav = str(d / f"{name}{i}.wav")
                write_wav(wav, np.clip(clip, -1, 1).astype(np.float32))
                f.write(json.dumps({"audio_filepath": wav, "duration": len(clip) / 16000,
                                    "text": ""}) + "\n")
        paths[name] = str(d / f"{name}.json")
    return paths


CASES = {
    "speed": ("SpeedPerturbation", {}),
    "speed_continuous": ("SpeedPerturbation", {"num_rates": 0}),
    "time_stretch": ("TimeStretchPerturbation", {}),
    "time_stretch_continuous": ("TimeStretchPerturbation", {"num_rates": 0, "n_fft": 256}),
    "gain": ("GainPerturbation", {}),
    "shift": ("ShiftPerturbation", {"min_shift_ms": -40.0, "max_shift_ms": 40.0}),
    "white_noise": ("WhiteNoisePerturbation", {"min_level": -60, "max_level": -30}),
    "noise": ("NoisePerturbation", {"manifest_path": "noise", "min_snr_db": 0,
                                    "max_snr_db": 20}),
    "impulse": ("ImpulsePerturbation", {"manifest_path": "rir"}),
    "impulse_shifted": ("ImpulsePerturbation", {"manifest_path": "rir", "shift_impulse": True}),
    "rir_noise": ("RirAndNoisePerturbation", {
        "rir_manifest_path": "rir", "rir_prob": 0.7, "noise_manifest_paths": ["noise"],
        "min_snr_db": [0], "max_snr_db": [30], "bg_noise_manifest_paths": ["noise"],
        "apply_noise_rir": True, "max_additions": 3}),
    "transcode": ("TranscodePerturbation", {}),
}


def _kwargs(kwargs, banks):
    sub = lambda v: banks.get(v, v) if isinstance(v, str) else (
        [sub(x) for x in v] if isinstance(v, list) else v)
    return {k: sub(v) for k, v in kwargs.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_perturbation_matches_jax(case, banks):
    cls, kwargs = CASES[case]
    kwargs = _kwargs(kwargs, banks)
    port, ref = getattr(port_pt, cls)(**kwargs), getattr(jax_pt, cls)(**kwargs)
    x = _wave(seed=len(case))
    for seed in range(6):  # several draws: rates, levels, banks, offsets
        rp, rj = random.Random(seed), random.Random(seed)
        got, want = port.perturb(x.copy(), 16000, rp), ref.perturb(x.copy(), 16000, rj)
        assert got.dtype == want.dtype and got.shape == want.shape, (case, seed)
        np.testing.assert_array_equal(got, want)
        assert rp.getstate() == rj.getstate()
    assert port.max_augmentation_length(10.0) == ref.max_augmentation_length(10.0)


AUG_CFG = {"speed": {"prob": 0.5, "min_speed_rate": 0.95, "max_speed_rate": 1.05},
           "gain": {"prob": 0.5},
           "shift": {"prob": 0.5},
           "white_noise": {"prob": 1.0, "min_level": -70, "max_level": -40},
           "time_stretch": {"prob": 0.3}}


def test_augmentor_from_config_matches_jax():
    port = port_pt.process_augmentations(AUG_CFG, seed=7)
    ref = jax_pt.process_augmentations(AUG_CFG, seed=7)
    x = _wave(12000, seed=3)
    for i in range(8):  # the augmentor's own seeded stream
        np.testing.assert_array_equal(port.perturb(x, 16000), ref.perturb(x, 16000))
    for idx in range(8):  # per-item streams, as the loader passes
        np.testing.assert_array_equal(port.perturb(x, 16000, rng=random.Random(idx)),
                                      ref.perturb(x, 16000, rng=random.Random(idx)))
    assert port.max_augmentation_length(4.0) == ref.max_augmentation_length(4.0)
    assert port_pt.process_augmentations(None) is None
    assert port_pt.process_augmentations({}) is None


def test_what_the_port_cannot_honour_raises(banks):
    with pytest.raises(ValueError, match="unknown perturbation 'reverb'"):
        port_pt.process_augmentations({"reverb": {"prob": 1.0}})
    with pytest.raises(ValueError, match="codec 'amr-nb'"):
        port_pt.process_augmentations({"transcode_aug": {"codecs": ["g711", "amr-nb"]}})


TARRED = {
    "noise": ("NoisePerturbation", {"manifest_path": "noise", "min_snr_db": 0,
                                    "max_snr_db": 20, "audio_tar_filepaths": "noise_{0..3}.tar"}),
    "impulse": ("ImpulsePerturbation", {"manifest_path": "rir",
                                        "audio_tar_filepaths": ["rir_0.tar"]}),
    "rir_noise": ("RirAndNoisePerturbation", {
        "rir_manifest_path": "rir", "rir_prob": 0.7, "noise_manifest_paths": ["noise"],
        "min_snr_db": [0], "max_snr_db": [30], "bg_noise_manifest_paths": ["noise"],
        "apply_noise_rir": True, "max_additions": 3, "rir_tar_filepaths": "rir.tar",
        "noise_tar_filepaths": ["n.tar"], "bg_noise_tar_filepaths": ["bg.tar"]}),
}


@pytest.mark.parametrize("case", sorted(TARRED))
def test_tarred_bank_arguments_read_the_manifest_as_jax(case, banks, caplog):
    """A tar list given to a noise or impulse bank is accepted and ignored,
    as the JAX package does: the bank is the manifest's, so the port's draws
    equal the JAX augmentor's; the port logs that the tar list is ignored."""
    cls, kwargs = TARRED[case]
    kwargs = _kwargs(kwargs, banks)
    port_pt._TAR_NOTED.clear()
    with caplog.at_level("WARNING", logger=port_pt.__name__):
        port = getattr(port_pt, cls)(**kwargs)
    assert "is ignored" in caplog.text and "tar_filepaths" in caplog.text
    ref = getattr(jax_pt, cls)(**kwargs)
    x = _wave(seed=len(case))
    for seed in range(4):
        rp, rj = random.Random(seed), random.Random(seed)
        np.testing.assert_array_equal(port.perturb(x.copy(), 16000, rp),
                                      ref.perturb(x.copy(), 16000, rj))
        assert rp.getstate() == rj.getstate()
