"""Speaker-attributed transcripts: the words of an ASR model labelled with
the speakers of a diarization (port of conformer_nemo_tpu/decode/asr_diar.py;
host code).

    words = asr.transcribe_with_timestamps(["session.wav"])[0]   # api.py
    turns = ClusteringDiarizer(spk).diarize("session.wav")       # decode/diarization.py
    out = transcribe_with_speakers(words, [(a, b, f"speaker_{l}") for a, b, l in turns])
    print(out["transcript"])

- `assign_words_to_speakers`: one forward pointer through the diarization
  segments as the words' anchors pass each segment's end; words past the
  last segment keep its speaker.
- `word_anchor`: the word's start, end or midpoint, plus an offset.
- `speech_segments_from_words`: ASR-based VAD, word extents merged where
  the gap between them is at most a threshold.
- `speaker_turns`, `format_transcript`: consecutive words of one speaker
  grouped into turns, printed as `[HH:MM:SS.ss - HH:MM:SS.ss] speaker: text`.

Words are WordTimestamp-like (`word`, `start_s`, `duration_s`), from either
model family's `transcribe_with_timestamps`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

DiarSegment = Tuple[float, float, str]  # (start_s, end_s, speaker_label)


def word_anchor(start: float, end: float, pos: str = "start", offset: float = 0.0) -> float:
    if pos == "start":
        a = start
    elif pos == "end":
        a = end
    elif pos == "mid":
        a = 0.5 * (start + end)
    else:
        raise ValueError("anchor pos must be start|end|mid")
    return a + offset


def assign_words_to_speakers(words: Sequence, diar_segments: Sequence[DiarSegment],
                             anchor_pos: str = "start",
                             anchor_offset: float = 0.0) -> List[Dict]:
    """Each word with the speaker of the segment its anchor falls in ->
    [{"word", "start_time", "end_time", "speaker_label"}] (times rounded
    to 0.01 s; no segments: every word is speaker_0)."""
    if not diar_segments:
        return [{"word": w.word, "start_time": round(w.start_s, 2),
                 "end_time": round(w.start_s + w.duration_s, 2), "speaker_label": "speaker_0"}
                for w in words]
    out: List[Dict] = []
    idx = 0
    for w in words:
        start, end = w.start_s, w.start_s + w.duration_s
        a = word_anchor(start, end, anchor_pos, anchor_offset)
        while idx < len(diar_segments) - 1 and a > diar_segments[idx][1]:
            idx += 1
        out.append({"word": w.word, "start_time": round(start, 2), "end_time": round(end, 2),
                    "speaker_label": diar_segments[idx][2]})
    return out


def speech_segments_from_words(words: Sequence,
                               nonspeech_threshold: float = 1.0) -> List[Tuple[float, float]]:
    """Word extents merged across gaps of at most `nonspeech_threshold` s."""
    spans = [[w.start_s, w.start_s + w.duration_s] for w in words]
    i = len(spans) - 1
    while i > 0:
        if spans[i][0] - spans[i - 1][1] <= nonspeech_threshold:
            spans[i - 1] = [spans[i - 1][0], spans[i][1]]
            spans.pop(i)
        i -= 1
    return [(s, e) for s, e in spans]


def speaker_turns(word_dicts: Sequence[Dict]) -> List[Dict]:
    """Consecutive words of one speaker -> turns {"speaker_label",
    "start_time", "end_time", "words", "text"}."""
    turns: List[Dict] = []
    for wd in word_dicts:
        if turns and turns[-1]["speaker_label"] == wd["speaker_label"]:
            turns[-1]["words"].append(wd["word"])
            turns[-1]["end_time"] = wd["end_time"]
        else:
            turns.append({"speaker_label": wd["speaker_label"], "start_time": wd["start_time"],
                          "end_time": wd["end_time"], "words": [wd["word"]]})
    for t in turns:
        t["text"] = " ".join(t["words"])
    return turns


def format_transcript(turns: Sequence[Dict]) -> str:
    """`[HH:MM:SS.ss - HH:MM:SS.ss] speaker: text`, a line a turn."""

    def fmt(t: float) -> str:
        m, s = divmod(max(t, 0.0), 60.0)
        h, m = divmod(int(m), 60)
        return f"{h:02d}:{int(m):02d}:{s:05.2f}"

    return "\n".join(f"[{fmt(t['start_time'])} - {fmt(t['end_time'])}] "
                     f"{t['speaker_label']}: {t['text']}" for t in turns)


def transcribe_with_speakers(words: Sequence, diar_segments: Sequence[DiarSegment],
                             anchor_pos: str = "start") -> Dict:
    """One file's words and diarization -> {"words", "turns", "transcript"}."""
    word_dicts = assign_words_to_speakers(words, diar_segments, anchor_pos)
    turns = speaker_turns(word_dicts)
    return {"words": word_dicts, "turns": turns, "transcript": format_transcript(turns)}
