"""Export through `torch.export` (utils/export.py, `export` of both model
families), on the CPU, against the JAX package's StableHLO export:

- a function's round trip through save_exported / load_exported;
- CTC `forward` and the transducer's `encoder` and `decoder_joint`,
  exported on the CPU at batch 2, 0.5 s, reloaded: equal to the port's own
  live functions, and within 1e-4 of the JAX package's `export` /
  `load_exported` of the same weights (the JAX model's archive restored in
  the port; fp32, 2 layers, d_model 64);
- the manifest: the JAX archive's layout (`format`; per function `file`
  and `in_avals`, the same input shapes and dtypes);
- with the flash path on (the streaming recipe's band,
  use_flash_attention true) the program calls the port's operator
  conformer_nemo_tpu_torch::flash_attention_fwd, saved and reloaded, and
  gives the live model's log-probs.
"""

import json
import os
import tarfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.utils import export as jax_export
from conformer_nemo_tpu_torch.api import ConformerCTC, ConformerTransducer
from conformer_nemo_tpu_torch.audio.features import log_mel_spectrogram
from conformer_nemo_tpu_torch.utils.export import (
    FORMAT,
    export_fn,
    load_exported,
    save_exported,
)

from test_torch_portable import ARTIFACTS, ENC, ROOT, SP_MODEL, _jax_model

torch.set_num_threads(2)

ATOL = 1e-4
B, SECONDS = 2, 0.5
OP = "conformer_nemo_tpu_torch.flash_attention_fwd"


def _inputs(seed: int = 0, t: int = int(SECONDS * 16000)):
    rng = np.random.RandomState(seed)
    audio = (0.1 * rng.randn(B, t)).astype(np.float32)
    lens = np.array([t, t * 5 // 8], np.int32)
    audio[1, lens[1]:] = 0.0
    return audio, lens


def _manifest(path: str) -> dict:
    with tarfile.open(path, "r:gz") as tar:
        return json.loads(tar.extractfile("manifest.json").read())


def _pair(kind: str, tmp_path):
    jm = _jax_model(kind, "bpe", seed=8)
    archive = str(tmp_path / "m.cntpu")
    jm.save_portable(archive, artifacts=ARTIFACTS)
    cls = ConformerCTC if kind == "ctc" else ConformerTransducer
    return jm, cls.restore_portable(archive, dtype=torch.float32, device="cpu")


def test_function_round_trip(tmp_path):
    fn = lambda x, y: torch.tanh(x) @ y
    x, y = torch.ones(2, 3), torch.arange(12, dtype=torch.float32).reshape(3, 4)
    path = save_exported(str(tmp_path / "f.tar.gz"), {"f": export_fn(fn, (x, y))})
    assert torch.equal(load_exported(path)["f"](x, y), fn(x, y))
    assert _manifest(path) == {"format": FORMAT, "functions": {
        "f": {"file": "f.pt2", "in_avals": ["float32[2,3]", "float32[3,4]"]}}}


@pytest.mark.parametrize("kind", ["ctc", "rnnt"])
def test_export_equals_the_live_model_and_jax(kind, tmp_path):
    jm, pm = _pair(kind, tmp_path)
    p_path, j_path = str(tmp_path / "port.tar.gz"), str(tmp_path / "jax.tar.gz")
    pm.export(p_path, batch_size=B, seconds=SECONDS)
    jm.export(j_path, batch_size=B, seconds=SECONDS)
    got, want = load_exported(p_path), jax_export.load_exported(j_path)
    assert set(got) == set(want) == ({"forward"} if kind == "ctc"
                                     else {"encoder", "decoder_joint"})

    # the manifest: the JAX layout, the same inputs
    pman, jman = _manifest(p_path), _manifest(j_path)
    assert set(pman) == set(jman) == {"format", "functions"}
    for name, meta in pman["functions"].items():
        assert set(meta) == {"file", "in_avals"} <= set(jman["functions"][name])
        assert meta["in_avals"] == jman["functions"][name]["in_avals"]

    audio, lens = _inputs()
    a, l = torch.from_numpy(audio), torch.from_numpy(lens)
    name = "forward" if kind == "ctc" else "encoder"
    out = [x.numpy() for x in got[name](a, l)]
    ref = [np.asarray(x) for x in want[name](jnp.asarray(audio), jnp.asarray(lens))]
    with torch.no_grad():
        feats, fl = log_mel_spectrogram(pm.cfg.preprocessor, a, l)
        live = pm.model(feats, fl) if kind == "ctc" else pm.model.encode(feats, fl)
    assert np.array_equal(out[1], ref[1]) and np.array_equal(out[1], live[1].numpy())
    for row, n in enumerate(out[1]):
        np.testing.assert_allclose(out[0][row, :n], ref[0][row, :n], rtol=0, atol=ATOL)
        np.testing.assert_array_equal(out[0][row, :n], live[0][row, :n].numpy())
    if kind == "rnnt":
        dcfg = pm.cfg.model.decoder
        rng = np.random.RandomState(1)
        step = (out[0][:, 3], np.array([7, dcfg.vocab_size], np.int32),
                rng.randn(dcfg.pred_rnn_layers, B, dcfg.pred_hidden).astype(np.float32),
                rng.randn(dcfg.pred_rnn_layers, B, dcfg.pred_hidden).astype(np.float32))
        g = [x.numpy() for x in got["decoder_joint"](*map(torch.from_numpy, step))]
        r = [np.asarray(x) for x in want["decoder_joint"](*map(jnp.asarray, step))]
        for x, y in zip(g, r):
            np.testing.assert_allclose(x, y, rtol=0, atol=ATOL)
        assert g[0].shape == (B, dcfg.vocab_size + 1)


def test_flash_export_calls_the_kernel_operator(tmp_path):
    pm = ConformerCTC.from_config_file(
        os.path.join(ROOT, "configs", "conformer_ctc_bpe_streaming.yaml"),
        overrides={**ENC, "model.tokenizer.model_file": SP_MODEL,
                   "model.encoder.att_context_size": [8, 2],
                   "model.encoder.use_flash_attention": True},
        device="cpu", dtype=torch.float32, seed=3)
    enc = pm.cfg.encoder
    assert enc.use_flash_attention is True and tuple(enc.att_context_size) == (8, 2)
    audio, lens = _inputs(seed=2, t=16000)
    a, l = torch.from_numpy(audio), torch.from_numpy(lens)
    path = pm.export(str(tmp_path / "flash.tar.gz"), batch_size=B, seconds=1.0)
    with tarfile.open(path, "r:gz") as tar:
        program = torch.export.load(tar.extractfile("forward.pt2"))
    calls = [n for n in program.graph.nodes if OP in str(n.target)]
    assert len(calls) == enc.n_layers  # one call a layer, no other attention
    assert [n.args[4:] for n in calls] == [(0.25, 8, 2)] * enc.n_layers  # scale, band
    got = load_exported(path)["forward"](a, l)
    with torch.no_grad():
        feats, fl = log_mel_spectrogram(pm.cfg.preprocessor, a, l)
        live = pm.model(feats, fl)
    assert torch.equal(got[1], live[1])
    for row, n in enumerate(got[1].tolist()):
        assert torch.equal(got[0][row, :n], live[0][row, :n])
