"""Inputs where the port once refused late or diverged from the JAX package:

* a CUDA `fit` whose flash attention would train in a dtype or at a depth
  d1 = d_head + d_model that no kernel takes is refused before its first
  step (the libraries' limits stood in for, since this machine has no
  card); every depth the forward takes trains, and inference past a
  backward limit is not refused;
* under `use_flash_attention: auto` a CUDA encoder at depths no flash
  kernel takes (dv > 128; in bf16/fp16 a d1 past the forward's shared
  memory) takes the dense attention, saying so once, where an explicit
  True is refused at construction;
* `joint_impl: auto` takes the flash joint at every width H its kernels
  take (the backward takes every H the forward takes, to 1376 in bf16) and
  the dense joint past it, saying so once (the joint library's
  shared-memory query stood in for);
* the training loader shuffles as the JAX package's `fit` does, with seed
  0, whatever the model's seed.
"""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from conformer_nemo_tpu import api as jax_api
from conformer_nemo_tpu.data import tokenizers as jtok
from conformer_nemo_tpu_torch import api
from conformer_nemo_tpu_torch.config.loader import build_encoder_config, load_config
from conformer_nemo_tpu_torch.data.audio_io import write_wav
from conformer_nemo_tpu_torch.data.dataset import BucketedLoader
from conformer_nemo_tpu_torch.models import conformer
from conformer_nemo_tpu_torch.models import rnnt
from conformer_nemo_tpu_torch.models.ctc_model import ctc_forward
from conformer_nemo_tpu_torch.ops import flash_attention as fa
from conformer_nemo_tpu_torch.ops import rnnt_joint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "conformer_ctc_bpe.yaml")
LONGFORM = os.path.join(ROOT, "configs", "conformer_ctc_bpe_longform.yaml")
TOKENIZER = os.path.join(ROOT, "tests", "fixtures", "sp_bpe_bytefallback.model")
SMEM_LIMIT = 232448


class _BwdLimits:
    """Stand-in for the flash libraries' limit queries, as the card reports
    them at dv 128: the backward kernels take more than the forward, whose
    shared memory ends at d1 1216."""

    flash_attention_bwd_dkv_max_d1 = staticmethod(lambda dv: 1616)
    flash_attention_bwd_dq_max_d1 = staticmethod(lambda dv: 1600)
    flash_attention_fwd_smem_bytes = staticmethod(lambda d1, dv: 232448 + 128 * (d1 - 1216))


def _encoder(d_model, use_flash, n_heads=8):
    raw = load_config(LONGFORM, {"model.tokenizer.model_file": TOKENIZER,
                                 "model.encoder.d_model": d_model,
                                 "model.encoder.n_heads": n_heads,
                                 "model.encoder.use_flash_attention": use_flash})
    return build_encoder_config(raw["model"]["encoder"])


@pytest.mark.parametrize("d_model,use_flash,longest_t,refused", [
    (640, "auto", 1843, None),   # d1 = 80 + 640 = 720: past the old dK/dV kernel's 576
    (640, True, 200, None),      # flash forced at any length
    (512, "auto", 1843, None),   # d1 = 576, the flagship depth
    (640, False, 1843, None),    # the dense path trains at any depth
    (640, "auto", 900, None),    # "auto" stays dense below flash_attention_min_t
    (1024, "auto", 1843, None),  # XLarge: d1 = 128 + 1024 = 1152, dv 128
    # 16 heads: d1 = 72 + 1152 = 1224, past the 16-bit forward's shared memory
    ((1152, 16), True, 200, "flash_attention_fwd_smem_bytes"),
    ((512, torch.float64), "auto", 1843, "take torch.bfloat16, torch.float16, torch.float32"),
])
def test_cuda_flash_training_depth_is_checked_before_a_step(monkeypatch, d_model, use_flash,
                                                             longest_t, refused):
    monkeypatch.setattr(fa, "load", lambda source: _BwdLimits())
    if d_model == (512, torch.float64):
        enc = dataclasses.replace(_encoder(512, use_flash), dtype=torch.float64)
    elif isinstance(d_model, tuple):
        enc = _encoder(d_model[0], use_flash, n_heads=d_model[1])
    else:
        enc = _encoder(d_model, use_flash)
    assert enc.dropout_att == 0.0 and enc.flash_attention_min_t == 1024
    if not refused:
        conformer.check_flash_training(enc, "cuda", longest_t)
        return
    with pytest.raises(ValueError) as err:
        conformer.check_flash_training(enc, "cuda", longest_t)
    msg = str(err.value)
    assert refused in msg and "model.encoder.use_flash_attention=False" in msg
    conformer.check_flash_training(enc, "cpu", longest_t)  # the CPU path runs plain PyTorch
    # attention dropout keeps the flash path out of training
    conformer.check_flash_training(dataclasses.replace(enc, dropout_att=0.1), "cuda", longest_t)


def test_flash_inference_past_the_backward_depth_is_not_refused(monkeypatch):
    """Construction checks the dtype and the forward's depth: transcribe at
    d1 720 runs through the forward kernel, which takes any depth up to its
    shared memory."""
    monkeypatch.setattr(fa, "load", lambda source: _BwdLimits())
    enc = _encoder(640, "auto")
    conformer.check_flash_dtype(enc, "cuda")


@pytest.mark.parametrize("d_model,n_heads,dtype,dense", [
    (1152, 16, torch.bfloat16, True),   # d1 = 72 + 1152 = 1224, past the 16-bit forward's 1216
    (1152, 16, torch.float32, False),   # the fp32 forward streams the depth: any d1
    (1152, 8, torch.float32, True),     # dv = d_head 144, past 128 in every dtype
    (512, 8, torch.bfloat16, False),    # the flagship depth, d1 576
])
def test_auto_flash_takes_dense_where_no_kernel_takes_the_depth(monkeypatch, caplog, d_model,
                                                                 n_heads, dtype, dense):
    monkeypatch.setattr(fa, "load", lambda source: _BwdLimits())
    monkeypatch.setattr(conformer, "_DENSE_FOR_DEPTH", set())
    enc = dataclasses.replace(_encoder(d_model, "auto", n_heads=n_heads), dtype=dtype)
    forced = dataclasses.replace(enc, use_flash_attention=True)
    attn = conformer.RelPosMultiHeadAttention(enc)
    on_card = types.SimpleNamespace(device=torch.device("cuda"))  # lengths on the card
    t = enc.flash_attention_min_t
    with caplog.at_level("WARNING", logger=conformer.__name__):
        for _ in range(2):
            conformer.check_flash_dtype(enc, "cuda")
            conformer.check_flash_training(enc, "cuda", t)
            assert attn.use_flash(t, on_card) is not dense
    said = [r for r in caplog.records if "use_flash_attention auto" in r.getMessage()]
    assert len(said) == (1 if dense else 0)  # said once
    assert attn.use_flash(t, torch.zeros(2))  # the CPU runs the plain version at any depth
    assert not attn.use_flash(t - 1, on_card)  # below flash_attention_min_t: dense anyway
    # an explicit True is not rerouted: construction refuses the depth
    assert conformer.RelPosMultiHeadAttention(forced).use_flash(t, on_card)
    if dense:
        for check in (lambda: conformer.check_flash_dtype(forced, "cuda"),
                      lambda: conformer.check_flash_training(forced, "cuda", t)):
            with pytest.raises(ValueError, match="model.encoder.use_flash_attention=False"):
                check()
    else:
        conformer.check_flash_dtype(forced, "cuda")
        conformer.check_flash_training(forced, "cuda", t)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    d = tmp_path_factory.mktemp("faults")
    rng = np.random.RandomState(0)
    with open(d / "train.json", "w", encoding="utf-8") as f:
        for i in range(12):
            n = int(rng.uniform(0.5, 2.0) * 16000)
            write_wav(str(d / f"{i}.wav"), (0.1 * rng.randn(n)).astype(np.float32))
            f.write(json.dumps({"audio_filepath": f"{i}.wav", "duration": n / 16000,
                                "text": ["hello world", "speech", "a test"][i % 3]}) + "\n")
    return str(d / "train.json")


TINY = {"model.tokenizer.model_file": TOKENIZER, "model.encoder.n_layers": 1,
        "model.encoder.d_model": 32, "model.encoder.n_heads": 2,
        "model.train_ds.batch_size": 2, "model.train_ds.num_buckets": 1}


def test_fit_checks_the_flash_depth_at_the_longest_batch_before_a_step(monkeypatch, manifest):
    """`fit` hands the check the encoder frames of its longest bucket, and a
    refusal leaves no training state behind."""
    model = api.ConformerCTC.from_config_file(CONFIG, overrides=TINY, device="cpu",
                                              dtype=torch.float32)
    seen = {}

    def refuse(enc, device, longest_t):
        seen.update(enc=enc, device=device, longest_t=longest_t)
        raise ValueError("refused")

    monkeypatch.setattr(api, "check_flash_training", refuse)
    with pytest.raises(ValueError, match="refused"):
        model.fit(manifest, max_steps=1)
    assert model.train_state is None
    assert seen["enc"] is model.cfg.encoder and seen["device"] == model.device
    loader = model._loader(manifest, model.raw_cfg["model"]["train_ds"], shuffle=True)
    batch = next(iter(loader))  # one bucket: every batch is padded to the longest
    log_probs, _ = ctc_forward(model.model, torch.from_numpy(batch.audio),
                               torch.from_numpy(batch.audio_lens))
    assert seen["longest_t"] == log_probs.shape[1]


def _flash_joint_smem(h, v, which):
    """Stand-in for rnnt_joint_smem_bytes: every kernel fits up to H 1376."""
    return SMEM_LIMIT if h <= 1376 else 10 ** 6


@pytest.mark.parametrize("h,want", [(704, "flash"), (640, "flash"), (1392, "dense")])
def test_auto_joint_takes_dense_where_the_flash_backward_cannot_take_h(monkeypatch, caplog, h,
                                                                        want):
    monkeypatch.setattr(rnnt_joint, "_lib", lambda: types.SimpleNamespace(
        rnnt_joint_smem_bytes=_flash_joint_smem))
    monkeypatch.setattr(rnnt, "_DENSE_FOR_WIDTH", set())
    cfg = rnnt.RNNTModelConfig(decoder=rnnt.RNNTDecoderConfig(vocab_size=1024),
                               joint=rnnt.RNNTJointConfig(joint_hidden=h))
    b, t, u1 = 16, 400, 200
    assert 3 * 2 * b * t * u1 * cfg.num_classes_with_blank > cfg.joint_flash_hbm_threshold
    with caplog.at_level("WARNING", logger=rnnt.__name__):
        assert cfg.resolve_joint_impl(b, t, u1, "cuda") == want
        assert cfg.resolve_joint_impl(b, t, u1, "cuda") == want
    said = [r for r in caplog.records if "joint_hidden" in r.getMessage()]
    assert len(said) == (1 if want == "dense" else 0)  # said once
    assert cfg.resolve_joint_impl(2, 10, 5, "cuda") == "dense"  # under the threshold
    assert cfg.resolve_joint_impl(b, t, u1, "cpu") == "dense"
    # an explicit flash joint is not rerouted: its loss checks H before its forward
    assert dataclasses.replace(cfg, joint_impl="flash").resolve_joint_impl(
        b, t, u1, "cuda") == "flash"


def test_training_loader_shuffles_as_the_jax_fit_at_any_model_seed(manifest):
    model = api.ConformerCTC.from_config_file(CONFIG, overrides={
        **TINY, "model.train_ds.num_buckets": 3}, device="cpu", dtype=torch.float32, seed=7)
    ds_cfg = model.raw_cfg["model"]["train_ds"]
    got = model._loader(manifest, ds_cfg, shuffle=True)
    ref_self = types.SimpleNamespace(tokenizer=jtok.SentencePieceTokenizer(TOKENIZER))
    want = jax_api._BaseASRModel._loader(ref_self, manifest, ds_cfg, True)
    for _ in range(2):  # two epochs
        assert got._plan() == want._plan()
        got.epoch += 1
        want.epoch += 1
    # the model's seed would have given another order
    other = BucketedLoader(got.ds, ds_cfg["batch_size"], shuffle=True, seed=7)
    assert other._plan() != got._plan()
