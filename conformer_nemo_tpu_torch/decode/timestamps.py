"""CTC time alignments: token and word timestamps and CTM output (port of
conformer_nemo_tpu/decode/timestamps.py; numpy on the host over the ids
and probabilities the device produced).

NeMo's behaviour:
- `FrameCtmUnit` / `ASRCTMPredictionWriter`
  (nemo/collections/asr/data/audio_to_ctm_dataset.py:26-80): the CTM line
  `<utt> <channel> <start_s> <dur_s> <label> <prob>`;
- `WERBPE_TS.ctc_decoder_predictions_tensor_with_ts`
  (nemo/collections/asr/parts/utils/decoder_timestamps_utils.py:69): the
  greedy CTC collapse that keeps the frame where each new token first
  appears, then groups tokens into words.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class FrameAlignedToken:
    """One emitted token and its frame extent (FrameCtmUnit)."""

    token_id: int
    start_frame: int
    length: int
    probability: float = 1.0

    @property
    def end_frame(self) -> int:
        return self.start_frame + self.length


def ctc_frame_alignments(pred_ids: np.ndarray, lengths: np.ndarray, blank_id: int,
                         probs: Optional[np.ndarray] = None) -> List[List[FrameAlignedToken]]:
    """Greedy CTC collapse keeping frame extents.

    pred_ids: [B, T] per-frame argmax ids; lengths: [B] valid frames;
    probs: optional [B, T] per-frame max softmax probability (a token's
    probability is the mean over its frames, as the CTM writer's per-unit
    probability). A token's extent runs from the first frame it appears on
    through its repeats; a label repeated across a blank is a new token.
    """
    out: List[List[FrameAlignedToken]] = []
    for b in range(pred_ids.shape[0]):
        units: List[FrameAlignedToken] = []
        prev = blank_id
        for t, tok in enumerate(pred_ids[b, : int(lengths[b])]):
            tok = int(tok)
            if tok != blank_id and tok != prev:
                units.append(FrameAlignedToken(tok, t, 1))
            elif tok != blank_id and tok == prev and units:
                units[-1].length += 1
            prev = tok
        if probs is not None:
            for u in units:
                u.probability = float(np.mean(probs[b, u.start_frame: u.end_frame]))
        out.append(units)
    return out


@dataclasses.dataclass
class WordTimestamp:
    word: str
    start_s: float
    duration_s: float
    probability: float = 1.0


def words_from_alignments(units: Sequence[FrameAlignedToken], tokenizer,
                          time_per_frame: float) -> List[WordTimestamp]:
    """Group token units into words (decoder_timestamps_utils.py:102-115):
    a SentencePiece '▁'-prefixed token starts a new word; a token that is
    only a space (char tokenizers) or '▁' separates words. A word spans
    from its first token's first frame to its last token's end."""
    words: List[WordTimestamp] = []
    cur: List[FrameAlignedToken] = []

    def flush():
        if not cur:
            return
        text = tokenizer.ids_to_text([u.token_id for u in cur]).strip()
        if text:
            start = cur[0].start_frame * time_per_frame
            end = cur[-1].end_frame * time_per_frame
            prob = float(np.mean([u.probability for u in cur]))
            words.append(WordTimestamp(text, start, end - start, prob))
        cur.clear()

    tokens = tokenizer.ids_to_tokens([u.token_id for u in units])
    for u, tok in zip(units, tokens):
        if tok.strip() in ("", "▁"):
            flush()
            continue
        if tok.startswith("▁") or tok.startswith(" "):
            flush()
        cur.append(u)
    flush()
    return words


def ctm_lines(utt_name: str, units: Sequence[FrameAlignedToken], labels: Sequence[str],
              time_per_frame: float, channel: int = 1) -> List[str]:
    """CTM lines (`FrameCtmUnit.to_ctm_str` and the writer's loop,
    audio_to_ctm_dataset.py:42-64)."""
    out = []
    for u in units:
        label = labels[u.token_id] if u.token_id < len(labels) else str(u.token_id)
        out.append(f"{utt_name} {channel} {u.start_frame * time_per_frame:.3f} "
                   f"{u.length * time_per_frame:.3f} {label} {u.probability:1.3f}")
    return out


def write_ctm(path: str, utt_name: str, units, labels, time_per_frame: float) -> str:
    with open(path, "w", encoding="utf-8") as f:
        for line in ctm_lines(utt_name, units, labels, time_per_frame):
            f.write(line + "\n")
    return path


def word_ctm_line(utt_name: str, w: WordTimestamp) -> str:
    """One word's CTM line as the transcription script writes it."""
    return f"{utt_name} 1 {w.start_s:.3f} {w.duration_s:.3f} {w.word} {w.probability:1.3f}"
