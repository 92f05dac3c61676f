"""Port config loading vs the JAX package's: the same raw dicts from every
CTC recipe, and the same preprocessor / encoder / model configs."""

import dataclasses
import os

import jax.numpy as jnp
import pytest
import torch

from conformer_nemo_tpu.config import loader as jax_loader
from conformer_nemo_tpu_torch.config import loader as port_loader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CTC_CONFIGS = ["conformer_ctc_bpe.yaml", "conformer_ctc_bpe_longform.yaml",
               "conformer_ctc_bpe_multilang.yaml", "conformer_ctc_bpe_streaming.yaml",
               "conformer_ctc_char.yaml"]
OVERRIDES = {"model.encoder.n_layers": 3, "model.preprocessor.features": 64,
             "model.new_section.key": "value"}


def _fields(cfg, skip=("dtype",)):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name not in skip}


@pytest.mark.parametrize("name", CTC_CONFIGS)
def test_load_config_and_builders_match_jax(name):
    path = os.path.join(ROOT, "configs", name)
    raw_p = port_loader.load_config(path, OVERRIDES)
    raw_j = jax_loader.load_config(path, OVERRIDES, audit=False)
    assert raw_p == raw_j
    # ${model.preprocessor.features} resolves after the override
    assert raw_p["model"]["encoder"]["feat_in"] == 64

    pre_p = port_loader.build_preprocessor_config(raw_p["model"]["preprocessor"])
    pre_j = jax_loader.build_preprocessor_config(raw_j["model"]["preprocessor"])
    assert _fields(pre_p) == _fields(pre_j)

    enc_p = port_loader.build_encoder_config(raw_p["model"]["encoder"], dtype=torch.float32)
    enc_j = jax_loader.build_encoder_config(raw_j["model"]["encoder"], dtype=jnp.float32)
    port_fields = _fields(enc_p)
    jax_fields = _fields(enc_j)
    assert port_fields == jax_fields
    assert enc_p.dtype == torch.float32

    vocab = None if raw_p["model"].get("labels") else 128
    model_p = port_loader.build_ctc_model_config(raw_p, vocab_size=vocab)
    model_j = jax_loader.build_ctc_model_config(raw_j, vocab_size=vocab)
    assert model_p.num_classes == model_j.num_classes and model_p.blank_id == model_j.blank_id
    assert _fields(model_p.spec_augment, skip=()) == _fields(model_j.spec_augment, skip=())
    assert model_p.spec_augment.enabled == model_j.spec_augment.enabled
    assert model_p.ctc_reduction == model_j.ctc_reduction
    assert model_p.encoder.dtype == torch.bfloat16  # the default compute dtype
