"""Both multilang recipes on the CPU at a tiny width (2 layers, d_model 64;
the transducer's prediction and joint width 32), against the JAX package.

- `configs/conformer_ctc_bpe_multilang.yaml` and
  `configs/conformer_transducer_bpe_multilang.yaml` build with the
  aggregate tokenizer (en: the BPE fixture, es: the unigram fixture; V 583)
  whose ids and texts equal the JAX package's on the manifests' texts;
- each fits 2 steps on FLAC audio with `lang` fields, through the pcm16
  transport, 2 loader workers and a speed + white-noise augmentor, and
  transcribes FLAC files (its own and the repo's fixtures);
- `.cntpu` archives with the aggregate tokenizer cross both ways: the
  per-language SentencePiece files stored flat as tokenizer_<lang>.model
  with relative `model_file` entries; the restored model gives the writer's
  texts (and CTC log-probs within 1e-4) in the other package.
"""

import json
import math
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.api import ConformerCTC as JaxConformerCTC
from conformer_nemo_tpu.api import ConformerTransducer as JaxConformerTransducer
from conformer_nemo_tpu.api import _tokenizer_from_model_cfg as jax_tokenizer
from conformer_nemo_tpu_torch.api import ConformerCTC, ConformerTransducer
from conformer_nemo_tpu_torch.data.flac_encode import write_flac
from conformer_nemo_tpu_torch.scripts.common import tokenizer_artifacts
from conformer_nemo_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
SPEECH = [os.path.join(FIXTURES, "speech", f) for f in ("utt1.flac", "utt3.flac")]
CONFIGS = {"ctc": "conformer_ctc_bpe_multilang.yaml",
           "rnnt": "conformer_transducer_bpe_multilang.yaml"}
TINY = {"model.encoder.n_layers": 2, "model.encoder.d_model": 64, "model.encoder.n_heads": 4,
        "model.encoder.conv_kernel_size": 15, "model.model_defaults.pred_hidden": 32,
        "model.model_defaults.joint_hidden": 32, "model.decoding.greedy.max_symbols": 3}
TRAIN = {"model.train_ds.batch_size": 2, "model.train_ds.num_workers": 2,
         "model.train_ds.transport": "pcm16",
         "model.train_ds.augmentor": {"speed": {"prob": 0.5}, "white_noise": {"prob": 1.0}}}
TEXTS = [("hello world", "en"), ("hola mundo", "es"), ("the quick brown fox", "en"),
         ("el perro come pan", "es")]
ATOL = 1e-4


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Tokenizer files named as an archive stores them, and a FLAC manifest."""
    d = tmp_path_factory.mktemp("multilang")
    for lang, src in (("en", "sp_bpe_bytefallback.model"), ("es", "sp_unigram.model")):
        shutil.copy(os.path.join(FIXTURES, src), d / f"tokenizer_{lang}.model")
    rng = np.random.RandomState(0)
    with open(d / "train.json", "w", encoding="utf-8") as f:
        for i, (text, lang) in enumerate(TEXTS):
            n = int(rng.uniform(1.0, 2.0) * 16000)
            write_flac(str(d / f"{i}.flac"), (0.1 * rng.randn(n)).astype(np.float32))
            f.write(json.dumps({"audio_filepath": f"{i}.flac", "duration": n / 16000,
                                "text": text, "lang": lang}) + "\n")
    langs = {f"model.tokenizer.langs.{lang}.model_file": str(d / f"tokenizer_{lang}.model")
             for lang in ("en", "es")}
    return {"dir": d, "manifest": str(d / "train.json"), "langs": langs}


def _port(kind, data, extra=None):
    cls = ConformerCTC if kind == "ctc" else ConformerTransducer
    return cls.from_config_file(os.path.join(ROOT, "configs", CONFIGS[kind]),
                                overrides={**TINY, **data["langs"], **(extra or {})},
                                device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_multilang_config_builds_fits_and_transcribes(kind, data):
    model = _port(kind, data, TRAIN)
    ref = jax_tokenizer(model.raw_cfg["model"])
    assert model.tokenizer.vocab_size == ref.vocab_size == 583
    for text, lang in TEXTS:
        ids = model.tokenizer.text_to_ids(text, lang)
        assert ids == ref.text_to_ids(text, lang)
        assert model.tokenizer.ids_to_text(ids) == ref.ids_to_text(ids) == text
    out = model.fit(data["manifest"], max_steps=2)
    assert out["steps"] == 2 and math.isfinite(out["last_loss"])
    texts = model.transcribe([os.path.join(data["dir"], "0.flac"), *SPEECH], batch_size=2)
    assert len(texts) == 3 and all(isinstance(t, str) for t in texts)


def _assert_same(kind, jm, pm):
    assert pm.transcribe(SPEECH, batch_size=2) == jm.transcribe(SPEECH, batch_size=2)
    if kind == "ctc":
        for a, b in zip(pm.transcribe(SPEECH, batch_size=2, logprobs=True),
                        jm.transcribe(SPEECH, batch_size=2, logprobs=True)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_aggregate_archives_cross_both_ways(kind, data, tmp_path):
    jax_cls = JaxConformerCTC if kind == "ctc" else JaxConformerTransducer
    port_cls = ConformerCTC if kind == "ctc" else ConformerTransducer
    pm = _port(kind, data)
    with torch.no_grad():  # weights away from the initial ones, so the texts say something
        gen = torch.Generator().manual_seed(1)
        for p in pm.model.parameters():
            p.add_(0.2 * torch.randn(p.shape, generator=gen))
    arts = tokenizer_artifacts(pm.raw_cfg)
    assert sorted(arts) == ["tokenizer_en.model", "tokenizer_es.model"]
    path = str(tmp_path / "port.cntpu")
    pm.save_portable(path, artifacts=arts)
    cfg, _, stored = ckpt.load_portable(path, extract_dir=str(tmp_path / "x"))
    assert cfg["model"]["tokenizer"] == {"type": "agg", "langs": {
        lang: {"type": "bpe", "model_file": f"tokenizer_{lang}.model"} for lang in ("en", "es")}}
    assert sorted(os.path.basename(p) for p in stored.values()) == sorted(arts)
    jm = jax_cls.restore_portable(path, dtype=jnp.float32)
    _assert_same(kind, jm, pm)

    # the JAX package's archive, written under the same rule, restores in the port
    jm.raw_cfg["model"]["tokenizer"] = cfg["model"]["tokenizer"]
    jpath = str(tmp_path / "jax.cntpu")
    jm.save_portable(jpath, artifacts={name: str(data["dir"] / name) for name in arts})
    back = port_cls.restore_portable(jpath, dtype=torch.float32, device="cpu")
    assert back.tokenizer.offsets == {"en": 0, "es": 295}
    _assert_same(kind, jm, back)
    with pytest.raises(ValueError, match="needs the artifact 'tokenizer_es.model'"):
        pm.save_portable(str(tmp_path / "partial.cntpu"),
                         artifacts={"tokenizer_en.model": arts["tokenizer_en.model"]})
