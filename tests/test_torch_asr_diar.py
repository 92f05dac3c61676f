"""The port's speaker-attributed transcripts (decode/asr_diar.py) against the
JAX package's, on the CPU: equal outputs (host composition on both sides).

- Random words (seeded: starts, durations, gaps) and random diarization
  segments: the anchors at start, end and mid with offsets, the speaker of
  every word (the forward pointer, words past the last segment, no
  segments at all), ASR-based speech segments at several thresholds, the
  turns, the transcript text and `transcribe_with_speakers`.
- Words from a model: `ConformerCTC.transcribe_with_timestamps` of a tiny
  CTC model (the JAX model's archive restored in the port, fp32) on a
  session, composed with the same segments in both packages.
"""

import os

import numpy as np
import pytest
import torch

from conformer_nemo_tpu.decode import asr_diar as jad
from conformer_nemo_tpu.decode.timestamps import WordTimestamp as JaxWord
from conformer_nemo_tpu_torch.api import ConformerCTC
from conformer_nemo_tpu_torch.data.audio_io import write_wav
from conformer_nemo_tpu_torch.decode import asr_diar as pad
from conformer_nemo_tpu_torch.decode.timestamps import WordTimestamp

torch.set_num_threads(2)


def _words(rs, n: int) -> list:
    t, out = 0.0, []
    for i in range(n):
        t += float(rs.choice([0.0, 0.05, 0.3, 1.2, 2.5]))
        dur = round(float(rs.uniform(0.04, 0.9)), 2)
        out.append(WordTimestamp(f"w{i}", round(t, 2), dur))
        t += dur
    return out


def _segments(rs, total: float) -> list:
    cuts = np.sort(rs.uniform(0.0, total, 5))
    edges = [0.0, *cuts.tolist(), total]
    return [(a, b, f"speaker_{rs.randint(3)}") for a, b in zip(edges, edges[1:])]


def _jax_words(words) -> list:
    return [JaxWord(w.word, w.start_s, w.duration_s, w.probability) for w in words]


@pytest.mark.parametrize("seed", range(4))
def test_composition_equals_jax_on_random_words(seed):
    rs = np.random.RandomState(seed)
    words = _words(rs, 30)
    total = words[-1].start_s + words[-1].duration_s
    segs = _segments(rs, 0.8 * total)  # the last words fall past the last segment
    jwords = _jax_words(words)
    for start, end in ((0.5, 1.2), (3.0, 3.0)):
        for pos in ("start", "end", "mid"):
            assert pad.word_anchor(start, end, pos, 0.1) == jad.word_anchor(start, end, pos, 0.1)
    with pytest.raises(ValueError, match="start|end|mid"):
        pad.word_anchor(0.0, 1.0, "middle")
    for pos in ("start", "end", "mid"):
        for offset in (0.0, -0.2):
            assert pad.assign_words_to_speakers(words, segs, pos, offset) == \
                jad.assign_words_to_speakers(jwords, segs, pos, offset)
    assert pad.assign_words_to_speakers(words, []) == jad.assign_words_to_speakers(jwords, [])
    for thr in (0.0, 0.3, 1.0, 3.0):
        assert pad.speech_segments_from_words(words, thr) == \
            jad.speech_segments_from_words(jwords, thr)
    dicts = pad.assign_words_to_speakers(words, segs)
    turns = pad.speaker_turns(dicts)
    assert turns == jad.speaker_turns(jad.assign_words_to_speakers(jwords, segs))
    assert pad.format_transcript(turns) == jad.format_transcript(turns)
    for pos in ("start", "mid"):
        assert pad.transcribe_with_speakers(words, segs, pos) == \
            jad.transcribe_with_speakers(jwords, segs, pos)
    assert pad.transcribe_with_speakers([], segs) == jad.transcribe_with_speakers([], segs)


def test_words_of_a_ctc_model_compose_as_jax(tmp_path):
    from test_torch_portable import ARTIFACTS, _jax_model

    jm = _jax_model("ctc", "bpe", seed=1)
    path = str(tmp_path / "ctc.cntpu")
    jm.save_portable(path, artifacts=ARTIFACTS)
    pm = ConformerCTC.restore_portable(path, dtype=torch.float32, device="cpu")
    rs = np.random.RandomState(5)
    t = np.arange(int(4.0 * 16000)) / 16000
    wav = (0.05 * rs.randn(len(t)) + 0.2 * np.sin(2 * np.pi * 300 * t)
           * (np.sin(2 * np.pi * 0.5 * t) > 0)).astype(np.float32)
    session = os.path.join(str(tmp_path), "session.wav")
    write_wav(session, wav)
    words = pm.transcribe_with_timestamps([session])[0]
    jwords = jm.transcribe_with_timestamps([session])[0]
    assert [(w.word, w.start_s, w.duration_s) for w in words] == \
        [(w.word, w.start_s, w.duration_s) for w in jwords]
    assert words
    segs = [(0.0, 1.0, "speaker_0"), (1.0, 2.0, "speaker_1"), (2.0, 3.0, "speaker_0")]
    got = pad.transcribe_with_speakers(words, segs)
    assert got == jad.transcribe_with_speakers(jwords, segs)
    assert all(w["speaker_label"] in ("speaker_0", "speaker_1") for w in got["words"])
