"""Spectrogram augmentation: SpecAugment, SpecCutout and SpecShot (port of
conformer_nemo_tpu/audio/spec_augment.py).

The fork's wrapper picks exactly ONE enabled augmentation uniformly at
random per batch. SpecAugment draws, per sample, `freq_masks` frequency
bands (start in [0, D - freq_width], width in [0, freq_width]) and
`time_masks` time bands whose widest band adapts to the valid length when
`time_width` is a float in [0, 1]. Cutout zeroes `rect_masks` rectangles;
SpecShot zeroes each bin with probability `specshot_ratio`.

Random numbers come from an explicit `torch.Generator` on the spectrogram's
device, in a fixed order of draws; the distributions match the JAX
package's, the streams do not. `masked_patch_augmentation` (SSL
pretraining's fixed-size time patches) and `crop_or_pad_spectrogram` take
their draws as optional arguments too (`scores`, `offsets`), so that a test
can feed the JAX package's.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SpecAugmentConfig:
    """Schema mirror of the reference `SpectrogramAugmentation.__init__`."""

    freq_masks: int = 0
    time_masks: int = 0
    freq_width: int = 10
    time_width: float = 10  # int -> fixed width; float in [0,1] -> fraction of length
    rect_masks: int = 0
    rect_time: int = 5
    rect_freq: int = 20
    specshot_ratio: float = 0.0
    augmask_value: float = 0.0

    @property
    def enabled(self) -> tuple[str, ...]:
        kinds = []
        if self.rect_masks > 0:
            kinds.append("spec_cutout")
        if self.freq_masks + self.time_masks > 0:
            kinds.append("spec_augment")
        if self.specshot_ratio > 0.0:
            kinds.append("spec_shot")
        return tuple(kinds)


def band_mask(num_positions: int, starts: torch.Tensor, widths: torch.Tensor) -> torch.Tensor:
    """OR of the half-open bands [start, start + width) -> bool [B, P];
    starts/widths: [B, n_masks]."""
    pos = torch.arange(num_positions, device=starts.device)[None, None, :]
    s = starts[..., None]
    return ((pos >= s) & (pos < s + widths[..., None])).any(dim=1)


def _randint_incl(gen: torch.Generator, shape, low: int, high, device) -> torch.Tensor:
    """Uniform ints in [low, high] inclusive (python random.randint
    semantics); `high` may be a tensor broadcasting to `shape`."""
    u = torch.rand(shape, generator=gen, device=device)
    high = torch.as_tensor(high, device=device)
    span = (high - low + 1).to(torch.float32)
    return torch.minimum(low + torch.floor(u * span).to(torch.int64), high.to(torch.int64))


def spec_augment(cfg: SpecAugmentConfig, gen: torch.Generator, spec: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """SpecAugment masking of spec [B, D, T] with valid frame lengths [B]."""
    b, d, t = spec.shape
    dev = spec.device
    mask = torch.zeros((b, d, t), dtype=torch.bool, device=dev)
    if cfg.freq_masks > 0:
        f_start = _randint_incl(gen, (b, cfg.freq_masks), 0, d - cfg.freq_width, dev)
        f_width = _randint_incl(gen, (b, cfg.freq_masks), 0, cfg.freq_width, dev)
        mask = mask | band_mask(d, f_start, f_width)[:, :, None]
    if cfg.time_masks > 0:
        lens = lengths.to(dev)
        if isinstance(cfg.time_width, float) and cfg.time_width <= 1.0:
            width_max = torch.clamp((lens.to(torch.float32) * cfg.time_width).to(torch.int64),
                                    min=1)
        else:
            width_max = torch.full((b,), int(cfg.time_width), dtype=torch.int64, device=dev)
        start_max = torch.clamp(lens.to(torch.int64) - width_max, min=1)
        t_start = _randint_incl(gen, (b, cfg.time_masks), 0, start_max[:, None], dev)
        t_width = _randint_incl(gen, (b, cfg.time_masks), 0, width_max[:, None], dev)
        mask = mask | band_mask(t, t_start, t_width)[:, None, :]
    return torch.where(mask, torch.full((), cfg.augmask_value, dtype=spec.dtype, device=dev), spec)


def spec_cutout(cfg: SpecAugmentConfig, gen: torch.Generator, spec: torch.Tensor) -> torch.Tensor:
    """Zero `rect_masks` random rectangles of spec [B, D, T] (Cutout)."""
    b, d, t = spec.shape
    dev = spec.device
    n = cfg.rect_masks
    x0 = _randint_incl(gen, (b, n), 0, d - cfg.rect_freq, dev)
    y0 = _randint_incl(gen, (b, n), 0, t - cfg.rect_time, dev)
    wx = _randint_incl(gen, (b, n), 0, cfg.rect_freq, dev)
    wy = _randint_incl(gen, (b, n), 0, cfg.rect_time, dev)
    drow = torch.arange(d, device=dev)[None, None, :, None]
    dcol = torch.arange(t, device=dev)[None, None, None, :]
    rect = ((drow >= x0[..., None, None]) & (drow < (x0 + wx)[..., None, None])
            & (dcol >= y0[..., None, None]) & (dcol < (y0 + wy)[..., None, None]))
    return torch.where(rect.any(dim=1), torch.zeros((), dtype=spec.dtype, device=dev), spec)


def spec_shot(cfg: SpecAugmentConfig, gen: torch.Generator, spec: torch.Tensor) -> torch.Tensor:
    """The fork's SpecShot: an iid keep-mask with keep probability 1 - ratio."""
    keep = torch.rand(spec.shape, generator=gen, device=spec.device) > cfg.specshot_ratio
    return spec * keep.to(spec.dtype)


def apply_spectrogram_augmentation(cfg: SpecAugmentConfig, gen: torch.Generator,
                                   spec: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Pick ONE enabled augmentation uniformly at random per call (the fork's
    rule) and apply it."""
    kinds = cfg.enabled
    if not kinds:
        return spec
    kind = kinds[0]
    if len(kinds) > 1:
        which = torch.randint(0, len(kinds), (), generator=gen, device=spec.device)
        kind = kinds[int(which)]
    if kind == "spec_augment":
        return spec_augment(cfg, gen, spec, lengths)
    if kind == "spec_cutout":
        return spec_cutout(cfg, gen, spec)
    return spec_shot(cfg, gen, spec)


def masked_patch_augmentation(spec: torch.Tensor, lengths: torch.Tensor, patch_size: int = 48,
                              mask_patches: int = 10, *, generator: torch.Generator | None = None,
                              scores: torch.Tensor | None = None) -> torch.Tensor:
    """Zero fixed-size time patches of spec [B, D, T] for SSL pretraining.

    Every row masks the same number of patches, m = min(mask_patches,
    shortest // patch_size), where rows too short for one patch are left
    out of the minimum. Row b's candidates are its first
    len_b // patch_size - 1 patches, of which it masks the min(m,
    candidates) with the lowest scores: uniform sampling without
    replacement. `scores` [B, max(T // patch_size, 1)] are those uniform
    draws; without them they come from `generator`."""
    b, d, t = spec.shape
    dev = spec.device
    max_patches = max(t // patch_size, 1)
    lens = lengths.to(device=dev, dtype=torch.int64)
    big = torch.iinfo(torch.int64).max
    min_len = torch.where(lens >= patch_size, lens, torch.full_like(lens, big)).min()
    min_len = torch.where(min_len == big, torch.zeros_like(min_len), min_len)
    m_eff = torch.where(min_len < patch_size * mask_patches, min_len // patch_size,
                        torch.full_like(min_len, mask_patches))
    n_candidates = lens // patch_size - 1
    valid = torch.arange(max_patches, device=dev)[None, :] < n_candidates[:, None]
    if scores is None:
        if generator is None:
            raise ValueError("masked_patch_augmentation needs a generator or scores")
        scores = torch.rand((b, max_patches), generator=generator, device=dev)
    scores = torch.where(valid, scores.to(dev, torch.float32), torch.full((), float("inf"),
                                                                           device=dev))
    # rank of each patch among its row's scores (a stable sort, as XLA's)
    order = torch.sort(scores, dim=1, stable=True).indices
    ranks = torch.argsort(order, dim=1)
    patch_masked = valid & (ranks < m_eff)
    frame_patch = torch.clamp(torch.arange(t, device=dev) // patch_size, max=max_patches - 1)
    frame_masked = patch_masked[:, frame_patch]  # [B, T]
    return torch.where(frame_masked[:, None, :], torch.zeros((), dtype=spec.dtype, device=dev),
                       spec)


def crop_or_pad_spectrogram(spec: torch.Tensor, lengths: torch.Tensor, audio_length: int, *,
                            generator: torch.Generator | None = None,
                            offsets: torch.Tensor | None = None) -> tuple:
    """Crop spec [B, D, T] at a random offset per row, or zero-pad it
    symmetrically (the odd frame on the right), to exactly `audio_length`
    frames. -> (spec [B, D, audio_length], lengths all audio_length).
    `offsets` [B] (in [0, T - audio_length]) are the crop's draws; without
    them they come from `generator`."""
    b, d, t = spec.shape
    dev = spec.device
    out_lengths = torch.full_like(lengths, audio_length)
    if t > audio_length:
        if offsets is None:
            if generator is None:
                raise ValueError("crop_or_pad_spectrogram needs a generator or offsets to crop")
            offsets = torch.randint(0, t - audio_length + 1, (b,), generator=generator,
                                    device=dev)
        idx = offsets.to(dev, torch.int64)[:, None] + torch.arange(audio_length, device=dev)
        return torch.gather(spec, 2, idx[:, None, :].expand(b, d, audio_length)), out_lengths
    pad_left = (audio_length - t) // 2
    pad_right = pad_left + (audio_length - t) % 2
    return torch.nn.functional.pad(spec, (pad_left, pad_right)), out_lengths
