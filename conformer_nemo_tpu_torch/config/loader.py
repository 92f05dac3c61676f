"""Config loading (port of conformer_nemo_tpu/config/loader.py).

`load_config` reads the repo's reference-shaped YAML recipes, applies
dotted-key overrides and resolves `${a.b}` interpolation; the builders map
the sections onto the port's dataclass configs.

PyYAML reads the files (checked present, 6.0.3, on the H100 machine).
"""

from __future__ import annotations

import re
from typing import Any, Optional

import torch
import yaml

from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig
from conformer_nemo_tpu_torch.audio.spec_augment import SpecAugmentConfig
from conformer_nemo_tpu_torch.models.conformer import ConformerEncoderConfig
from conformer_nemo_tpu_torch.models.ctc_model import CTCModelConfig

# ---------------------------------------------------------------------------
# Loading, overrides, interpolation
# ---------------------------------------------------------------------------

_INTERP = re.compile(r"^\$\{(.+)\}$")


def _resolve(node: Any, root: dict) -> Any:
    """Resolve `${a.b.c}` interpolations against the config root."""
    if isinstance(node, dict):
        return {k: _resolve(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve(v, root) for v in node]
    if isinstance(node, str):
        m = _INTERP.match(node)
        if m:
            cur: Any = root
            for part in m.group(1).split("."):
                cur = cur[part]
            return _resolve(cur, root)
    return node


def load_config(path: str, overrides: Optional[dict] = None) -> dict:
    """Read YAML + apply dotted-key overrides + resolve interpolation."""
    with open(path, encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    for dotted, value in (overrides or {}).items():
        cur = cfg
        parts = dotted.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = value
    return _resolve(cfg, cfg)


# ---------------------------------------------------------------------------
# Section builders
# ---------------------------------------------------------------------------


def _pick(d: dict, keys: tuple) -> dict:
    """The entries of `d` named in `keys` that are present and not None."""
    return {k: d[k] for k in keys if d.get(k) is not None}


_PREPROCESSOR_KEYS = (
    "sample_rate", "window_size", "window_stride", "window", "features", "n_fft",
    "lowfreq", "highfreq", "log", "dither", "preemph", "normalize", "mag_power",
    "pad_to", "pad_value", "frame_splicing", "exact_pad", "log_zero_guard_type",
    "log_zero_guard_value", "max_duration", "nb_augmentation_prob", "nb_max_freq",
)

_ENCODER_KEYS = (
    "feat_in", "n_layers", "d_model", "feat_out", "subsampling", "subsampling_factor",
    "subsampling_conv_channels", "ff_expansion_factor", "self_attention_model",
    "n_heads", "xscaling", "untie_biases", "pos_emb_max_len", "conv_kernel_size",
    "conv_norm_type", "dropout", "dropout_emb", "dropout_att",
    "use_flash_attention", "flash_attention_min_t", "remat",
)

_SPEC_AUGMENT_KEYS = (
    "freq_masks", "time_masks", "freq_width", "time_width", "rect_masks", "rect_time",
    "rect_freq", "specshot_ratio", "augmask_value",
)


def build_preprocessor_config(p: dict) -> MelFeatureConfig:
    kw = _pick(p, _PREPROCESSOR_KEYS)
    # normalize may arrive as the reference's {'fixed_mean', 'fixed_std'} dict
    norm = kw.get("normalize")
    if isinstance(norm, dict):
        kw["normalize"] = "fixed_mean_and_std"
        kw["fixed_mean"] = tuple(norm["fixed_mean"])
        kw["fixed_std"] = tuple(norm["fixed_std"])
    for key in ("fixed_mean", "fixed_std"):
        if p.get(key) is not None:
            kw[key] = tuple(p[key])
    return MelFeatureConfig(**kw)


def build_spec_augment_config(s: dict) -> SpecAugmentConfig:
    return SpecAugmentConfig(**_pick(s, _SPEC_AUGMENT_KEYS))


def build_encoder_config(e: dict, dtype: torch.dtype = torch.bfloat16) -> ConformerEncoderConfig:
    kw = _pick(e, _ENCODER_KEYS)
    if e.get("att_context_size"):
        kw["att_context_size"] = tuple(e["att_context_size"])
    return ConformerEncoderConfig(dtype=dtype, **kw)


def build_ctc_model_config(cfg: dict, vocab_size: Optional[int] = None,
                           dtype: torch.dtype = torch.bfloat16) -> CTCModelConfig:
    """model-section dict (reference shape) -> CTCModelConfig; V defaults to
    len(model.labels) for char configs, and the blank id is V."""
    m = cfg["model"] if "model" in cfg else cfg
    if vocab_size is None:
        labels = m.get("labels")
        if labels is None:
            raise ValueError("vocab_size required for BPE configs")
        vocab_size = len(labels)
    return CTCModelConfig(
        preprocessor=build_preprocessor_config(m.get("preprocessor", {})),
        spec_augment=build_spec_augment_config(m.get("spec_augment", {}) or {}),
        encoder=build_encoder_config(m.get("encoder", {}), dtype=dtype),
        num_classes=vocab_size,
        ctc_reduction=m.get("ctc_reduction", "mean_batch"),
    )
