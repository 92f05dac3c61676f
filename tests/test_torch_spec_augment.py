"""Port SpecAugment / SpecCutout / SpecShot and the frontend's training
path (dither, narrowband) vs the JAX package.

The random streams differ by design (torch.Generator vs jax.random), so:
  * geometry: both sides get the same injected starts and widths (their
    `_randint_incl` is replaced by a queue of numpy arrays) and must give
    the same masked spectrogram, exactly;
  * distributions: over many draws, bounds hold and the masked fractions
    agree with JAX's within 5 standard errors; the choose-one rule picks
    each enabled augmentation a third of the time, within 5 standard errors;
  * dither and narrowband: the same injected noise and drop decisions give
    the same features as JAX's (absolute 1e-3, as the inference frontend
    test: fp32 STFT and mel matmuls summed in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.audio import features as jf
from conformer_nemo_tpu.audio import spec_augment as jsa
from conformer_nemo_tpu_torch.audio import features as pf
from conformer_nemo_tpu_torch.audio import spec_augment as psa

torch.set_num_threads(2)

CFG = dict(freq_masks=2, time_masks=3, freq_width=7, time_width=0.1, rect_masks=2,
           rect_time=5, rect_freq=9, specshot_ratio=0.3, augmask_value=-1.5)


def _spec(seed=0, b=4, d=40, t=60):
    rng = np.random.RandomState(seed)
    return rng.randn(b, d, t).astype(np.float32), np.array([60, 45, 9, 1][:b], np.int32)


def _inject(monkeypatch, draws):
    """Replace both sides' `_randint_incl` with a queue of the same arrays,
    checking each against the bounds the caller asked for."""
    jax_q, port_q = list(draws), list(draws)

    def jax_fake(rng, shape, low, high):
        x = jax_q.pop(0)
        assert x.shape == tuple(shape) and (x >= low).all() and (x <= np.asarray(high)).all()
        return jnp.asarray(x)

    def port_fake(gen, shape, low, high, device):
        x = port_q.pop(0)
        assert x.shape == tuple(shape) and (x >= low).all()
        assert (torch.from_numpy(x) <= torch.as_tensor(high)).all()
        return torch.from_numpy(x).to(torch.int64)

    monkeypatch.setattr(jsa, "_randint_incl", jax_fake)
    monkeypatch.setattr(psa, "_randint_incl", port_fake)


def test_band_mask_matches_jax():
    rng = np.random.RandomState(0)
    starts = rng.randint(0, 50, (5, 3)).astype(np.int32)
    widths = rng.randint(0, 12, (5, 3)).astype(np.int32)
    want = np.asarray(jsa._band_mask(60, jnp.asarray(starts), jnp.asarray(widths)))
    got = psa.band_mask(60, torch.from_numpy(starts), torch.from_numpy(widths)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("time_width", [0.1, 6])
def test_spec_augment_geometry_matches_jax(monkeypatch, time_width):
    spec, lens = _spec()
    cfg_kw = {**CFG, "time_width": time_width}
    b = spec.shape[0]
    if isinstance(time_width, float):
        width_max = np.maximum(1, (lens * time_width).astype(np.int32))
    else:
        width_max = np.full(b, time_width, np.int32)
    start_max = np.maximum(1, lens - width_max)
    rng = np.random.RandomState(1)
    draws = [rng.randint(0, 40 - 7 + 1, (b, 2)), rng.randint(0, 8, (b, 2)),
             (rng.rand(b, 3) * (start_max[:, None] + 1)).astype(np.int32),
             (rng.rand(b, 3) * (width_max[:, None] + 1)).astype(np.int32)]
    _inject(monkeypatch, [d.astype(np.int32) for d in draws])
    want = jsa.spec_augment.__wrapped__(jsa.SpecAugmentConfig(**cfg_kw), jax.random.PRNGKey(0),
                                        jnp.asarray(spec), jnp.asarray(lens))
    got = psa.spec_augment(psa.SpecAugmentConfig(**cfg_kw), torch.Generator(),
                           torch.from_numpy(spec), torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_spec_cutout_geometry_matches_jax(monkeypatch):
    spec, _ = _spec(2)
    rng = np.random.RandomState(3)
    b = spec.shape[0]
    draws = [rng.randint(0, 40 - 9 + 1, (b, 2)), rng.randint(0, 60 - 5 + 1, (b, 2)),
             rng.randint(0, 10, (b, 2)), rng.randint(0, 6, (b, 2))]
    _inject(monkeypatch, [d.astype(np.int32) for d in draws])
    want = jsa.spec_cutout.__wrapped__(jsa.SpecAugmentConfig(**CFG), jax.random.PRNGKey(0),
                                       jnp.asarray(spec))
    got = psa.spec_cutout(psa.SpecAugmentConfig(**CFG), torch.Generator(), torch.from_numpy(spec))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _fractions(masked, lens):
    """(fraction of fully masked frequency rows, of fully masked valid frames)."""
    rows = masked.all(axis=2).mean()
    t = masked.shape[2]
    valid = np.arange(t)[None, :] < lens[:, None]
    cols = (masked.all(axis=1) & valid).sum() / valid.sum()
    return rows, cols


def test_spec_augment_bounds_and_rates_match_jax():
    n = 512
    spec = np.ones((n, 40, 60), np.float32)
    lens = np.random.RandomState(4).randint(10, 61, n).astype(np.int32)
    cfg = dict(freq_masks=2, time_masks=3, freq_width=7, time_width=0.1, augmask_value=0.0)
    want = np.asarray(jsa.spec_augment(jsa.SpecAugmentConfig(**cfg), jax.random.PRNGKey(5),
                                       jnp.asarray(spec), jnp.asarray(lens))) == 0.0
    got = psa.spec_augment(psa.SpecAugmentConfig(**cfg), torch.Generator().manual_seed(5),
                           torch.from_numpy(spec), torch.from_numpy(lens)).numpy() == 0.0
    # bounds: at most 2 bands of <= 7 rows; time bands <= max(1, 0.1 len) wide, inside the
    # first max(1, len - width) + width frames
    assert got.all(axis=2).sum(axis=1).max() <= 14
    width_max = np.maximum(1, (lens * 0.1).astype(np.int32))
    last = np.maximum(1, lens - width_max) + width_max
    cols = got.all(axis=1)
    assert not (cols & (np.arange(60)[None, :] >= last[:, None])).any()
    for a, b in zip(_fractions(got, lens), _fractions(want, lens)):
        assert abs(a - b) < 5 * np.sqrt(max(b, 1e-3) / n)


def test_spec_shot_rate():
    spec = torch.ones(8, 40, 500)
    out = psa.spec_shot(psa.SpecAugmentConfig(specshot_ratio=0.3), torch.Generator().manual_seed(0),
                        spec)
    dropped = (out == 0).float().mean().item()
    assert abs(dropped - 0.3) < 5 * np.sqrt(0.3 * 0.7 / spec.numel())


def test_choose_one_rule_frequencies(monkeypatch):
    """With all three enabled, each is picked with probability 1/3 per call."""
    picked = []
    for kind in ("spec_augment", "spec_cutout", "spec_shot"):
        monkeypatch.setattr(psa, kind, lambda *a, kind=kind: picked.append(kind) or a[2])
    cfg = psa.SpecAugmentConfig(**CFG)
    assert cfg.enabled == ("spec_cutout", "spec_augment", "spec_shot")
    gen = torch.Generator().manual_seed(0)
    spec, lens = torch.zeros(1, 4, 4), torch.tensor([4])
    n = 3000
    for _ in range(n):
        psa.apply_spectrogram_augmentation(cfg, gen, spec, lens)
    for kind in ("spec_augment", "spec_cutout", "spec_shot"):
        assert abs(picked.count(kind) / n - 1 / 3) < 5 * np.sqrt(2 / 9 / n)
    one = psa.SpecAugmentConfig(freq_masks=1)  # a single enabled kind draws no choice
    picked.clear()
    psa.apply_spectrogram_augmentation(one, gen, spec, lens)
    assert picked == ["spec_augment"]


# narrowband runs without normalisation: a mel band wholly above the cut is
# constant, and per-feature normalisation divides the rounding of its mean
# by the 1e-5 std guard on both sides (up to 0.1), which says nothing
@pytest.mark.parametrize("nb_prob,normalize", [(0.0, "per_feature"), (0.5, "none")])
def test_dither_and_narrowband_match_jax(monkeypatch, nb_prob, normalize):
    rng = np.random.RandomState(6)
    wav = (0.1 * rng.randn(3, 8000)).astype(np.float32)
    lens = np.array([8000, 6000, 0], np.int32)
    noise = rng.randn(3, 8000).astype(np.float32)
    drop = np.array([True, False, True])[:, None, None]
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=None: jnp.asarray(noise))
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(drop))
    monkeypatch.setattr(pf, "_normal", lambda gen, shape, dev: torch.from_numpy(noise))
    monkeypatch.setattr(pf, "_bernoulli", lambda gen, p, shape, dev: torch.from_numpy(drop))
    kw = dict(dither=0.01, nb_augmentation_prob=nb_prob, nb_max_freq=4000, normalize=normalize)
    mel_j, len_j = jf.log_mel_spectrogram.__wrapped__(
        jf.MelFeatureConfig(**kw), jnp.asarray(wav), jnp.asarray(lens),
        rng=jax.random.PRNGKey(0), training=True)
    mel_p, len_p = pf.log_mel_spectrogram(pf.MelFeatureConfig(**kw), torch.from_numpy(wav),
                                          torch.from_numpy(lens), generator=torch.Generator(),
                                          training=True)
    np.testing.assert_array_equal(len_p.numpy(), np.asarray(len_j))
    np.testing.assert_allclose(mel_p.numpy(), np.asarray(mel_j), rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="generator"):
        pf.log_mel_spectrogram(pf.MelFeatureConfig(**kw), torch.from_numpy(wav),
                               torch.from_numpy(lens), training=True)
