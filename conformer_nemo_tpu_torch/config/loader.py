"""Config loading (port of conformer_nemo_tpu/config/loader.py).

`load_config` reads the repo's reference-shaped YAML recipes, applies
dotted-key overrides and resolves `${a.b}` interpolation, then warns
(`ConfigKeyWarning`) of keys nothing consumes and of keys accepted for the
reference's sake that do nothing here (`audit_config`: the JAX package's
schema, so both flag the same key paths); the builders map the sections
onto the port's dataclass configs.

PyYAML reads the files (checked present, 6.0.3, on the H100 machine).
"""

from __future__ import annotations

import re
import warnings
from typing import Any, Optional

import torch
import yaml

from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig
from conformer_nemo_tpu_torch.audio.spec_augment import SpecAugmentConfig
from conformer_nemo_tpu_torch.models.conformer import ConformerEncoderConfig
from conformer_nemo_tpu_torch.models.ctc_model import CTCModelConfig
from conformer_nemo_tpu_torch.models.rnnt import (
    RNNTDecoderConfig,
    RNNTJointConfig,
    RNNTModelConfig,
)
from conformer_nemo_tpu_torch.train.rnnt_trainer import RNNTTrainConfig

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
    """Read YAML + apply dotted-key overrides + resolve interpolation, then
    warn of unconsumed and no-op keys (a misspelled key must not pass in
    silence)."""
    with open(path, encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    for dotted, value in (overrides or {}).items():
        cur = cfg
        parts = dotted.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = value
    cfg = _resolve(cfg, cfg)
    for msg in audit_config(cfg):
        warnings.warn(msg, ConfigKeyWarning, stacklevel=2)
    return cfg


# ---------------------------------------------------------------------------
# Audit: the JAX package's schema of consumed keys
# ---------------------------------------------------------------------------


class ConfigKeyWarning(UserWarning):
    pass


_DS_KEYS = {
    "manifest_filepath", "sample_rate", "batch_size", "shuffle", "num_buckets",
    "trim_silence", "use_start_end_token", "augmentor", "num_workers",
    "bucketing_strategy", "bucketing_batch_size", "min_duration", "max_duration",
    "max_utts", "is_tarred", "tarred_audio_filepaths", "shuffle_n",
    "tarred_shard_strategy", "parser", "labels", "pin_memory", "drop_last",
    "bucketing_weights", "normalize_transcripts",
    "transport",  # the JAX package's host-to-device wire format (f32 | pcm16 | mulaw8)
}
_LAUNCHER = ("the port reads the topology from the launcher (torchrun: one process per GPU, "
             "WORLD_SIZE/RANK/LOCAL_RANK), laid out on the trainer's data x model axes")
_PINNED = "fit always copies training batches to the card from pinned memory (data/prefetch.py)"
_PRECISION = "the precision is fixed: parameters fp32, compute in the model's dtype (bf16 default)"
# accepted for the reference recipes' sake, but no-ops in the port
_NOOP_KEYS = {
    "model.train_ds.pin_memory": _PINNED,
    "model.validation_ds.pin_memory": _PINNED,
    "model.test_ds.pin_memory": _PINNED,
    "trainer.devices": _LAUNCHER,
    "trainer.gpus": _LAUNCHER,
    "trainer.num_nodes": _LAUNCHER,
    "trainer.strategy": "the trainer's data axis reduces gradients as DDP does, with a "
                        "synchronised BatchNorm; its model axis shards the encoder",
    "trainer.accelerator": "the device comes from the model's device= (CUDA unless the CPU is asked)",
    "trainer.precision": _PRECISION,
    "trainer.amp_level": _PRECISION,
    "trainer.amp_backend": _PRECISION,
}

_SECTION_KEYS = {
    "": {"name", "model", "trainer", "exp_manager", "init_from_nemo_model",
         "init_from_pretrained_model", "init_from_ptl_ckpt"},
    "model": {
        "sample_rate", "labels", "tokenizer", "train_ds", "validation_ds",
        "test_ds", "preprocessor", "spec_augment", "encoder", "decoder",
        "joint", "decoding", "optim", "model_defaults", "loss",
        "variational_noise", "skip_nan_grad", "ctc_reduction",
        "compute_eval_loss", "log_prediction", "log_every_n_steps",
        "gradient_mask",  # a config-only stanza in the reference too
    },
    "model.train_ds": _DS_KEYS, "model.validation_ds": _DS_KEYS,
    "model.test_ds": _DS_KEYS,
    "trainer": {
        "max_epochs", "max_steps", "log_every_n_steps",
        "accumulate_grad_batches", "gradient_clip_val", "val_check_interval",
        "check_val_every_n_epoch", "resume_from_checkpoint", "mesh",
        "enable_progress_bar", "num_sanity_val_steps", "sync_batchnorm",
        "benchmark", "logger", "enable_checkpointing", "max_time",
    } | {k.split(".", 1)[1] for k in _NOOP_KEYS if k.startswith("trainer.")},
    "exp_manager": {
        "exp_dir", "name", "version", "resume_if_exists",
        "resume_ignore_no_checkpoint", "create_checkpoint_callback",
        "checkpoint_callback_params", "create_wandb_logger",
        "wandb_logger_kwargs", "create_tensorboard_logger",
        "create_dllogger_logger", "log_every_n_steps",
    },
}


def audit_config(cfg: dict) -> list:
    """-> warning messages for unknown or no-op keys in the audited
    sections. Sections without a schema (encoder, preprocessor, optim, ...,
    whose builders raise on bad fields, and pass-throughs such as augmentor
    and decoding) are not audited."""
    msgs = []

    def walk(section: str, node):
        known = _SECTION_KEYS.get(section)
        if known is None or not isinstance(node, dict):
            return
        for key, val in node.items():
            path = f"{section}.{key}" if section else key
            if path in _NOOP_KEYS:
                msgs.append(f"config key '{path}' is accepted for reference "
                            f"compatibility but is a no-op here: {_NOOP_KEYS[path]}")
            elif key not in known and not key.startswith("_"):
                msgs.append(f"config key '{path}' is not consumed by anything "
                            "(typo, or an unsupported reference knob?)")
            walk(path, val)

    walk("", cfg)
    return msgs


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


def build_rnnt_model_config(cfg: dict, vocab_size: int,
                            dtype: torch.dtype = torch.bfloat16) -> RNNTTrainConfig:
    """model-section dict (reference shape) -> RNNTTrainConfig, as the JAX
    package's `ConformerTransducer.__init__` builds it: blank id = V; the loss
    kwargs under `warprnnt_numba_kwargs` (the reference's key) or its alias
    `rnnt_kwargs`; variational noise; the flash-joint knobs `joint_impl`,
    `joint_flash_bt` and `joint_flash_hbm_threshold`."""
    m = cfg["model"] if "model" in cfg else cfg
    defaults = m.get("model_defaults", {})
    dec_cfg = m.get("decoder", {})
    prednet = dec_cfg.get("prednet", {})
    joint_cfg = m.get("joint", {})
    jointnet = joint_cfg.get("jointnet", {})
    loss_cfg = m.get("loss") or {}
    loss_kwargs = loss_cfg.get("warprnnt_numba_kwargs") or loss_cfg.get("rnnt_kwargs") or {}
    loss_name = loss_cfg.get("loss_name", "default")
    if loss_name not in ("default", "warprnnt_numba"):
        raise ValueError(f"unsupported transducer loss_name {loss_name!r} (the one lattice "
                         "implementation covers the reference's default/warprnnt_numba)")
    vn = m.get("variational_noise") or {}
    return RNNTTrainConfig(
        preprocessor=build_preprocessor_config(m.get("preprocessor", {})),
        spec_augment=build_spec_augment_config(m.get("spec_augment", {}) or {}),
        model=RNNTModelConfig(
            encoder=build_encoder_config(m.get("encoder", {}), dtype=dtype),
            decoder=RNNTDecoderConfig(
                vocab_size=vocab_size,
                pred_hidden=prednet.get("pred_hidden", defaults.get("pred_hidden", 640)),
                pred_rnn_layers=prednet.get("pred_rnn_layers", 1),
                dropout=prednet.get("dropout", 0.1),
                forget_gate_bias=float(prednet.get("forget_gate_bias", 1.0)),
                t_max=prednet.get("t_max"),
                weights_init_scale=float(prednet.get("weights_init_scale", 1.0)),
                norm=dec_cfg.get("normalization_mode"),
                random_state_sampling=bool(dec_cfg.get("random_state_sampling", False)),
                blank_as_pad=bool(dec_cfg.get("blank_as_pad", True)),
                dtype=dtype),
            joint=RNNTJointConfig(
                joint_hidden=jointnet.get("joint_hidden", defaults.get("joint_hidden", 640)),
                activation=jointnet.get("activation", "relu"),
                dropout=jointnet.get("dropout", 0.1),
                fuse_loss_wer=joint_cfg.get("fuse_loss_wer", True),
                fused_batch_size=joint_cfg.get("fused_batch_size", 16),
                dtype=dtype),
            fastemit_lambda=float(loss_kwargs.get("fastemit_lambda", 0.0)),
            clamp=float(loss_kwargs.get("clamp", -1.0)),
            joint_impl=joint_cfg.get("joint_impl", "auto"),
            joint_flash_bt=int(joint_cfg.get("joint_flash_bt", 16)),
            joint_flash_hbm_threshold=float(joint_cfg.get("joint_flash_hbm_threshold", 5.0e9))),
        variational_noise_std=float(vn.get("std", 0.0)),
        variational_noise_start=int(vn.get("start_step", 0)),
    )
