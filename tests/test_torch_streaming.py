"""Buffered (streaming) decode, on the CPU, against the JAX package:

- decode/streaming.py's host pieces against conformer_nemo_tpu.decode.streaming
  on the same numpy inputs: the feature iterator's chunks, the bufferer's
  normalised buffers (bit for bit, a short last batch included), the LCS
  merge, and a fake-model FrameBatchASR and BatchedFrameASRRNNT (the same
  predictions, merges and texts);
- `transcribe_buffered` of both model families against the JAX API on the
  same weights (the JAX model's archive restored in the port; fp32, 2
  layers, d_model 64): equal texts and equal per-buffer predictions, with
  the streaming recipe's two-sided band (att_context_size [8, 2]) and with
  full attention, a last batch of buffers shorter than batch_size
  included.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conformer_nemo_tpu.decode.streaming as jax_streaming
from conformer_nemo_tpu.api import ConformerCTC as JaxConformerCTC
from conformer_nemo_tpu.data.tokenizers import CharTokenizer as JaxChar
import conformer_nemo_tpu_torch.api as port_api
from conformer_nemo_tpu_torch.api import ConformerCTC, ConformerTransducer
from conformer_nemo_tpu_torch.data.audio_io import write_wav
from conformer_nemo_tpu_torch.data.tokenizers import CharTokenizer
from conformer_nemo_tpu_torch.decode import streaming

from test_torch_portable import ARTIFACTS, ENC, ROOT, SP_MODEL, _jax_model

torch.set_num_threads(2)

LABELS = [" ", "a", "b", "c"]
STREAMING = {**ENC, "model.tokenizer.model_file": SP_MODEL,
             "model.encoder.att_context_size": [8, 2]}


def _features(samples: np.ndarray) -> np.ndarray:
    """A deterministic stand-in frontend: 4 features a 160-sample frame."""
    n = len(samples) // 160
    frames = samples[: n * 160].reshape(n, 160)
    return np.stack([frames.mean(1), frames.std(1), frames.max(1), frames.min(1)]).astype(
        np.float32)


def test_feature_iterator_chunks_equal_jax():
    rng = np.random.RandomState(0)
    samples = rng.randn(16000 * 3 + 1234).astype(np.float32)
    for frame_len in (0.3, 1.6):
        got = list(streaming.AudioFeatureIterator(samples, frame_len, _features, 0.01))
        want = list(jax_streaming.AudioFeatureIterator(samples, frame_len, _features, 0.01))
        assert len(got) == len(want) > 1
        assert all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(got, want))


def test_bufferer_buffers_equal_jax_bit_for_bit():
    rng = np.random.RandomState(1)
    # 7 frames a batch of 3: batches of 3, 3 and 1 buffers, then none
    frames = [(rng.randn(80, 160) * 4 - 10).astype(np.float32) for _ in range(7)]
    out = []
    for mod in (streaming, jax_streaming):
        buf = mod.FeatureFrameBufferer(80, 1.6, 4.0, 0.01, batch_size=3)
        buf.set_frame_reader(iter([f.copy() for f in frames]))
        batches = []
        while True:
            b = buf.get_buffers_batch()
            if not b:
                break
            batches.append(b)
        out.append(batches)
    got, want = out
    assert [len(b) for b in got] == [len(b) for b in want] == [3, 3, 1]
    for bg, bw in zip(got, want):
        for g, w in zip(bg, bw):
            assert g.shape == (80, 400) and g.dtype == np.float32
            assert np.array_equal(g, w)
    assert streaming.ZERO_LEVEL_SPEC_DB_VAL == jax_streaming.ZERO_LEVEL_SPEC_DB_VAL == -16.635


@pytest.mark.parametrize("seed", range(6))
def test_lcs_merge_equals_jax(seed):
    """The port's row-at-a-time table against the JAX package's cell loop."""
    rng = np.random.RandomState(seed)
    big = 1 + 20 * (seed % 2)  # up to 600 x 240 tokens
    x = rng.randint(0, 6, rng.randint(0, 30 * big)).tolist()
    y = (x[-rng.randint(0, 10 * big):] if x else []) + rng.randint(
        0, 6, rng.randint(0, 12 * big)).tolist()
    assert streaming.longest_common_subsequence_merge(x, y) == \
        jax_streaming.longest_common_subsequence_merge(x, y)
    assert streaming.longest_common_subsequence_merge([1, 2, 3, 4, 5], [3, 4, 5, 6, 7]) == [6, 7]


def test_fake_model_frame_batch_asr_equals_jax():
    """The same numpy forward through both modules' FrameBatchASR (the
    middle-token merge) and BatchedFrameASRRNNT (the LCS merge)."""
    blank = len(LABELS)
    samples = (np.sin(np.arange(16000 * 3) / 37.0) * 0.3).astype(np.float32)

    def forward_fn(feats, lens):
        return (np.abs(feats[:, 0, ::4] * 7).astype(np.int64) % (blank + 1))

    def decode_fn(feats, lens):
        preds = forward_fn(feats, lens)[:, ::3] % blank
        return preds.astype(np.int32), np.full(len(preds), preds.shape[1] - 2, np.int32)

    results = []
    for mod, tok in ((streaming, CharTokenizer(LABELS)), (jax_streaming, JaxChar(LABELS))):
        asr = mod.FrameBatchASR(forward_fn, _features, tok, blank, n_feat=4, frame_len=0.2,
                                total_buffer=0.6, batch_size=3)
        asr.read_audio_samples(samples, delay=10, model_stride_in_secs=0.04)
        text = asr.transcribe(tokens_per_chunk=5, delay=10)
        rnnt = mod.BatchedFrameASRRNNT(decode_fn, _features, tok, n_feat=4, frame_len=0.2,
                                       total_buffer=0.6, batch_size=3)
        rnnt.read_audio_samples(samples, delay=10, model_stride_in_secs=0.04)
        results.append((text, [p.tolist() for p in asr.all_preds], rnnt.transcribe(),
                        list(rnnt.merged)))
    assert results[0] == results[1]
    assert results[0][0] and results[0][2] and len(results[0][1]) > 3


def _recording(cls, calls: list):
    """`cls` (FrameBatchASR or BatchedFrameASRRNNT) whose forward records,
    per buffer, the predictions (CTC) or the tokens (transducer) it gives."""

    class Recording(cls):
        def __init__(self, fn, *args, **kwargs):
            def rec(feats, lens):
                out = fn(feats, lens)
                if isinstance(out, tuple):
                    toks, tl = (np.asarray(x) for x in out)
                    calls.extend(toks[i, : int(tl[i])].tolist() for i in range(len(tl)))
                else:
                    calls.extend(np.asarray(out).tolist())
                return out

            super().__init__(rec, *args, **kwargs)

    return Recording


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """Three files, 2.9-6.3 s: 2-4 buffers of 1.6 s each, a short last batch."""
    d = tmp_path_factory.mktemp("buffered")
    rng = np.random.RandomState(5)
    paths = []
    for i, secs in enumerate((2.9, 6.3, 4.1)):
        n = int(secs * 16000)
        t = np.arange(n) / 16000
        wav = 0.05 * rng.randn(n) + 0.2 * np.sin(2 * np.pi * 220 * (i + 1) * t * (1 + t / 8))
        paths.append(str(d / f"long{i}.wav"))
        write_wav(paths[-1], wav.astype(np.float32))
    return paths


def _perturbed(jm, seed: int):
    """The JAX model with perturbed initial weights and statistics, as
    test_torch_portable's `_jax_model` perturbs them."""
    state = jm._init_state(jm._make_optimizer())
    rng = np.random.RandomState(seed)
    noisy = lambda x: np.asarray(x, np.float32) + 0.2 * rng.randn(*np.shape(x)).astype(np.float32)
    stats = jax.tree.map(lambda x: jnp.asarray(np.abs(noisy(x)) + 0.5), state.batch_stats)
    jm.state = state.replace(params=jax.tree.map(lambda x: jnp.asarray(noisy(x)), state.params),
                             batch_stats=stats)
    return jm


def _ctc_pair(kind: str, tmp_path):
    if kind == "banded":
        jm = _perturbed(JaxConformerCTC.from_config_file(
            os.path.join(ROOT, "configs", "conformer_ctc_bpe_streaming.yaml"),
            overrides=STREAMING, dtype=jnp.float32), seed=4)
    else:
        jm = _jax_model("ctc", "bpe", seed=4)
    path = str(tmp_path / "m.cntpu")
    jm.save_portable(path, artifacts=ARTIFACTS)
    return jm, ConformerCTC.restore_portable(path, dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("kind", ["banded", "full"])
def test_ctc_transcribe_buffered_equals_jax(kind, wavs, tmp_path, monkeypatch):
    jm, pm = _ctc_pair(kind, tmp_path)
    assert tuple(pm.cfg.encoder.att_context_size) == ((8, 2) if kind == "banded" else (-1, -1))
    got_calls, want_calls = [], []
    monkeypatch.setattr(port_api, "FrameBatchASR",
                        _recording(streaming.FrameBatchASR, got_calls))
    monkeypatch.setattr(jax_streaming, "FrameBatchASR",
                        _recording(jax_streaming.FrameBatchASR, want_calls))
    got = pm.transcribe_buffered(wavs, batch_size=3)
    want = jm.transcribe_buffered(wavs, batch_size=3)
    assert got == want
    assert len(got_calls) == len(want_calls) >= 9
    assert got_calls == want_calls
    assert any(got), got
    assert pm.transcribe_buffered(wavs, batch_size=3) == got


def test_rnnt_transcribe_buffered_equals_jax(wavs, tmp_path, monkeypatch):
    jm = _jax_model("rnnt", "bpe", seed=6)
    path = str(tmp_path / "r.cntpu")
    jm.save_portable(path, artifacts=ARTIFACTS)
    pm = ConformerTransducer.restore_portable(path, dtype=torch.float32, device="cpu")
    got_calls, want_calls = [], []
    monkeypatch.setattr(port_api, "BatchedFrameASRRNNT",
                        _recording(streaming.BatchedFrameASRRNNT, got_calls))
    monkeypatch.setattr(jax_streaming, "BatchedFrameASRRNNT",
                        _recording(jax_streaming.BatchedFrameASRRNNT, want_calls))
    got = pm.transcribe_buffered(wavs[:2], batch_size=3)
    want = jm.transcribe_buffered(wavs[:2], batch_size=3)
    assert got == want
    assert len(got_calls) == len(want_calls) >= 6
    assert got_calls == want_calls
    assert pm.transcribe_buffered(wavs[:2], batch_size=3) == got
