"""`ConformerCTC.fit` on the CPU: a tiny config (2 layers, d_model 64,
remat and the flash path on, whose kernels run their plain versions here)
trains two steps on a 4-utterance manifest with validation, returns a
finite loss, leaves the model in eval mode, and transcribes; it takes an
experiment manager, a missing `trainer.resume_from_checkpoint` raises
FileNotFoundError as in the JAX package, and what is not ported raises;
the integer transports, tar shards, silence trimming and the augmentor
train on the JAX package's loader batches."""

import json
import math
import os
import tarfile

import numpy as np
import pytest
import torch

from conformer_nemo_tpu.api import ConformerCTC as JaxConformerCTC
from conformer_nemo_tpu_torch.api import ConformerCTC
from conformer_nemo_tpu_torch.data.audio_io import write_wav
from conformer_nemo_tpu_torch.train.exp_manager import ExpManagerConfig, ExperimentManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "conformer_ctc_bpe.yaml")
TINY = {
    "model.tokenizer.model_file": os.path.join(ROOT, "tests", "fixtures",
                                               "sp_bpe_bytefallback.model"),
    "model.encoder.n_layers": 2, "model.encoder.d_model": 64, "model.encoder.n_heads": 4,
    "model.encoder.remat": True, "model.encoder.use_flash_attention": True,
    "model.train_ds.batch_size": 2, "model.validation_ds.batch_size": 2,
    "model.train_ds.num_workers": 2,
}


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    d = tmp_path_factory.mktemp("fit")
    rng = np.random.RandomState(0)
    with open(d / "train.json", "w", encoding="utf-8") as f:
        for i, text in enumerate(["hello world", "the quick brown fox", "speech", "a test"]):
            n = int(rng.uniform(1.0, 2.0) * 16000)
            write_wav(str(d / f"{i}.wav"), (0.1 * rng.randn(n)).astype(np.float32))
            f.write(json.dumps({"audio_filepath": f"{i}.wav", "duration": n / 16000,
                                "text": text}) + "\n")
    return str(d / "train.json")


def test_fit_on_cpu_then_transcribe(manifest):
    model = ConformerCTC.from_config_file(CONFIG, overrides=TINY, device="cpu",
                                          dtype=torch.float32)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out = model.fit(manifest, manifest, max_steps=2)
    assert out["steps"] == 2 and math.isfinite(out["last_loss"])
    assert math.isfinite(out["val"]["loss"]) and out["val"]["words"] > 0
    assert not model.model.training
    after = model.state_dict()
    bn = "encoder.layers.0.conv.batch_norm.running_mean"
    assert not torch.equal(after[bn], before[bn])
    assert not torch.equal(after["decoder.decoder_layers.0.weight"],
                           before["decoder.decoder_layers.0.weight"])
    texts = model.transcribe([os.path.join(os.path.dirname(manifest), "0.wav")])
    assert len(texts) == 1 and isinstance(texts[0], str)


def test_fit_refuses_what_is_not_ported(manifest, tmp_path):
    """What fit still refuses raises before a step: an optimizer name the
    JAX package does not know (every name it knows now trains), and a mesh
    that does not fit the world of processes;
    the data options it once refused (integer transports, tar shards,
    silence trimming, the augmentor) now train, on the loader batches of
    the JAX package's `_loader` for the same config."""
    model = ConformerCTC.from_config_file(CONFIG, overrides=TINY, device="cpu",
                                          dtype=torch.float32)
    em = ExperimentManager(ExpManagerConfig(exp_dir=str(tmp_path), create_tensorboard_logger=False))
    assert model.fit(manifest, max_steps=1, exp_manager=em)["steps"] == 1
    assert os.path.exists(os.path.join(em.ckpt_dir, "step_1", "meta.json"))
    m = ConformerCTC.from_config_file(
        CONFIG, overrides={**TINY, "trainer.resume_from_checkpoint": "/nowhere"}, device="cpu",
        dtype=torch.float32)
    with pytest.raises(FileNotFoundError, match="no checkpoint in /nowhere"):
        m.fit(manifest, max_steps=1)  # as the JAX package's fit raises
    m = ConformerCTC.from_config_file(CONFIG, overrides={**TINY, "model.optim.name": "lamb"},
                                      device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="unknown optimizer lamb"):
        m.fit(manifest, max_steps=1)  # as the JAX package's make_optimizer raises
    for mesh in ({"data": 2, "model": 1}, {"data": -1, "model": 2}):
        m = ConformerCTC.from_config_file(CONFIG, overrides={**TINY, "trainer.mesh": mesh},
                                          device="cpu", dtype=torch.float32)
        with pytest.raises(ValueError, match="world of 1"):
            m.fit(manifest, max_steps=1)
        assert m.train_state is None  # before the first step
    d = os.path.dirname(manifest)
    with tarfile.open(os.path.join(d, "audio_0.tar"), "w") as tar:
        for i in range(4):
            tar.add(os.path.join(d, f"{i}.wav"), arcname=f"{i}.wav")
    for key, value in (("model.train_ds.transport", "pcm16"),
                       ("model.train_ds.transport", "mulaw8"),
                       ("model.train_ds.is_tarred", True),
                       ("model.train_ds.trim_silence", True),
                       ("model.train_ds.augmentor", {"white_noise": {"prob": 1.0}})):
        overrides = {**TINY, key: value,
                     "model.train_ds.tarred_audio_filepaths": os.path.join(d, "audio_{0..0}.tar")}
        m = ConformerCTC.from_config_file(CONFIG, overrides=overrides, device="cpu",
                                          dtype=torch.float32)
        jm = JaxConformerCTC.from_config_file(CONFIG, overrides=overrides)
        ds_cfg = m.raw_cfg["model"]["train_ds"]
        got, want = list(m._loader(manifest, ds_cfg, True)), list(jm._loader(manifest, ds_cfg,
                                                                           True))
        assert len(got) == len(want) > 0, key
        for a, b in zip(got, want):
            assert a.audio.dtype == b.audio.dtype, key
            for k in ("audio", "audio_lens", "tokens", "token_lens"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=f"{key} {k}")
        out = m.fit(manifest, max_steps=1)
        assert out["steps"] == 1 and math.isfinite(out["last_loss"]), (key, out)
