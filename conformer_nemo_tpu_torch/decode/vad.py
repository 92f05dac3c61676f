"""VAD post-processing on the host (the JAX package's numpy code,
conformer_nemo_tpu/decode/vad.py): overlap smoothing of windowed
predictions (mean or median), hysteresis binarisation with onset/offset
padding, filtering of short speech and short gaps in a configurable order,
threshold scales (absolute, relative, percentile), the segment table, the
detection error rate from interval overlap (DetER = (miss + false alarm) /
reference speech), and grid-search tuning of the parameters on a dev set.

Segments are sorted lists of (start_sec, end_sec). The device work, the
frame probabilities, is the classification model's forward
(api_label.py `ClassificationModel.vad_frame_probs`).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Segment = Tuple[float, float]


# ---------------------------------------------------------------------------
# Overlap smoothing (vad_utils.py:240-313)
# ---------------------------------------------------------------------------

def smooth_overlap_predictions(
    frame: np.ndarray,
    smoothing_method: str = "median",
    overlap: float = 0.875,
    window_length_in_sec: float = 0.63,
    shift_length_in_sec: float = 0.01,
) -> np.ndarray:
    """Re-estimate per-10ms frame probabilities by aggregating the
    overlapping windows that span each frame (median or mean).

    `frame[i]` is the model's speech probability for the window starting
    at `i * shift_length_in_sec`. Output has `len(frame) * shift_units`
    entries on the 10 ms grid.
    """
    frame = np.asarray(frame, dtype=np.float64)
    shift = int(round(shift_length_in_sec / 0.01))
    seg = int(window_length_in_sec / 0.01 + 1)
    jump_on_target = int(seg * (1 - overlap))
    jump_on_frame = int(jump_on_target / shift)
    if jump_on_frame < 1:
        raise ValueError(
            f"window/shift/overlap combination gives jump_on_frame={jump_on_frame} < 1; "
            "increase window_length_in_sec or reduce overlap"
        )
    target_len = len(frame) * shift

    win_idx = np.arange(0, len(frame), jump_on_frame)
    starts = win_idx * shift

    if smoothing_method == "mean":
        sums = np.zeros(target_len)
        counts = np.zeros(target_len)
        offs = np.arange(seg)
        pos = starts[:, None] + offs[None, :]
        vals = np.broadcast_to(frame[win_idx][:, None], pos.shape)
        valid = pos < target_len
        np.add.at(sums, pos[valid], vals[valid])
        np.add.at(counts, pos[valid], 1.0)
        covered = counts > 0
        out = np.empty(target_len)
        out[covered] = sums[covered] / counts[covered]
        out[~covered] = out[covered][-1] if covered.any() else 0.0
    elif smoothing_method == "median":
        # max windows covering one position
        max_cover = seg // (jump_on_frame * shift) + 1
        buf = np.full((target_len, max_cover), np.nan)
        cover = np.zeros(target_len, dtype=np.int64)
        for w, s in zip(win_idx, starts):
            j = np.arange(s, min(s + seg, target_len))
            buf[j, cover[j]] = frame[w]
            cover[j] += 1
        out = np.full(target_len, np.nan)
        covered = cover > 0
        if covered.any():
            out[covered] = np.nanmedian(buf[covered], axis=1)
            out[~covered] = out[covered][-1]
        else:
            out[:] = 0.0
    else:
        raise ValueError("smoothing_method must be 'mean' or 'median'")
    return np.round(out, 4)


# ---------------------------------------------------------------------------
# Binarization + filtering (vad_utils.py:386-536)
# ---------------------------------------------------------------------------

def cal_vad_onset_offset(
    scale: str, onset: float, offset: float, sequence: Optional[np.ndarray] = None
) -> Tuple[float, float]:
    """Map [0,1] thresholds onto the sequence's value range
    (vad_utils.py:538-556): absolute -> [0,1], relative -> [min,max],
    percentile -> [p1,p99]."""
    if scale == "absolute":
        lo, hi = 0.0, 1.0
    elif scale == "relative":
        lo, hi = float(np.nanmin(sequence)), float(np.nanmax(sequence))
    elif scale == "percentile":
        lo, hi = (
            float(np.nanpercentile(sequence, 1)),
            float(np.nanpercentile(sequence, 99)),
        )
    else:
        raise ValueError(f"unknown scale {scale}")
    return lo + onset * (hi - lo), lo + offset * (hi - lo)


def merge_overlap_segments(segments: Sequence[Segment]) -> List[Segment]:
    """Coalesce overlapping/touching-by-overlap intervals (vad_utils.py:521)."""
    merged: List[List[float]] = []
    for s, e in sorted(segments):
        if merged and merged[-1][1] >= s:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def binarization(
    sequence: np.ndarray,
    *,
    onset: float = 0.5,
    offset: float = 0.5,
    pad_onset: float = 0.0,
    pad_offset: float = 0.0,
    shift_length_in_sec: float = 0.01,
    scale: str = "absolute",
    **_ignored,
) -> List[Segment]:
    """Hysteresis thresholding of frame probabilities into speech segments
    (vad_utils.py:386-443): enter speech when p > onset, leave when
    p < offset; segments padded by pad_onset/pad_offset then merged.

    Matches the reference's loop exactly, including its quirks: frame 0
    never triggers a transition, and a padded segment is kept only when
    its padded end exceeds its padded start.
    """
    sequence = np.asarray(sequence, dtype=np.float64)
    onset, offset = cal_vad_onset_offset(scale, onset, offset, sequence)
    segments: List[Segment] = []
    in_speech = False
    start = 0.0
    for i in range(1, len(sequence)):
        t = i * shift_length_in_sec
        if in_speech:
            if sequence[i] < offset:
                s, e = max(0.0, start - pad_onset), t + pad_offset
                if e > s:
                    segments.append((s, e))
                in_speech = False
        elif sequence[i] > onset:
            start = t
            in_speech = True
    if in_speech:
        t = (len(sequence) - 1) * shift_length_in_sec
        segments.append((max(0.0, start - pad_onset), t + pad_offset))
    return merge_overlap_segments(segments)


def filter_short_segments(segments: Sequence[Segment], threshold: float) -> List[Segment]:
    """Drop segments shorter than `threshold` seconds (vad_utils.py:498)."""
    return [seg for seg in segments if seg[1] - seg[0] >= threshold]


def get_gap_segments(segments: Sequence[Segment]) -> List[Segment]:
    """Complement intervals between consecutive segments (vad_utils.py:509)."""
    ordered = sorted(segments)
    return [(ordered[i][1], ordered[i + 1][0]) for i in range(len(ordered) - 1)]


def _fill_short_gaps(segments: List[Segment], min_duration_off: float) -> List[Segment]:
    gaps = get_gap_segments(segments)
    short = [g for g in gaps if g[1] - g[0] < min_duration_off]
    return merge_overlap_segments(list(segments) + short)


def filtering(
    segments: Sequence[Segment],
    *,
    min_duration_on: float = 0.0,
    min_duration_off: float = 0.0,
    filter_speech_first: bool = True,
    **_ignored,
) -> List[Segment]:
    """Remove short speech segments (min_duration_on) and bridge short
    non-speech gaps (min_duration_off), in the reference's configurable
    order (vad_utils.py:444-496)."""
    segments = sorted(segments)
    if filter_speech_first:
        if min_duration_on > 0.0:
            segments = filter_short_segments(segments, min_duration_on)
        if min_duration_off > 0.0:
            segments = _fill_short_gaps(segments, min_duration_off)
    else:
        if min_duration_off > 0.0:
            segments = _fill_short_gaps(segments, min_duration_off)
        if min_duration_on > 0.0:
            segments = filter_short_segments(segments, min_duration_on)
    return sorted(segments)


def postprocess_frame_predictions(
    sequence: np.ndarray, params: Optional[dict] = None, shift_length_in_sec: float = 0.01
) -> List[Segment]:
    """binarization -> filtering with one reference-shaped params dict
    (onset/offset/pad_onset/pad_offset/min_duration_on/min_duration_off/
    filter_speech_first), as `generate_vad_segment_table_per_file` does
    (vad_utils.py:362-384)."""
    params = dict(params or {})
    segs = binarization(sequence, shift_length_in_sec=shift_length_in_sec, **params)
    return filtering(segs, **params)


def segments_to_table(
    segments: Sequence[Segment], shift_length_in_sec: float = 0.01
) -> List[Tuple[float, float, str]]:
    """(start, end) -> (start, duration, 'speech') rows; duration includes
    one trailing frame as the reference does (vad_utils.py:379)."""
    return [(s, e - s + shift_length_in_sec, "speech") for s, e in sorted(segments)]


def write_vad_segment_table(path: str, segments: Sequence[Segment], shift_length_in_sec: float = 0.01) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for s, d, lab in segments_to_table(segments, shift_length_in_sec):
            f.write(f"{s}\t{d}\t{lab}\n")


def gen_pred_from_speech_segments(
    segments: Sequence[Segment], n_frames: int, shift_length_in_sec: float = 0.01
) -> np.ndarray:
    """Rasterize segments back to a 0/1 frame sequence (vad_utils.py:792)."""
    pred = np.zeros(n_frames)
    for s, e in sorted(segments):
        pred[int(s / shift_length_in_sec): int(e / shift_length_in_sec)] = 1.0
    return pred


# ---------------------------------------------------------------------------
# Detection metrics + threshold tuning (vad_utils.py:584-667)
# ---------------------------------------------------------------------------

def _total_duration(segments: Sequence[Segment]) -> float:
    return sum(e - s for s, e in segments)


def _intersection_duration(a: Sequence[Segment], b: Sequence[Segment]) -> float:
    a, b = sorted(a), sorted(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def detection_error_rate(
    hyp: Sequence[Segment], ref: Sequence[Segment]
) -> Dict[str, float]:
    """miss / false-alarm / DetER from interval overlap, the quantities
    pyannote's DetectionErrorRate reports in the reference's tuner
    (vad_utils.py:643-647). Rates are fractions of total reference speech."""
    hyp = merge_overlap_segments(hyp)
    ref = merge_overlap_segments(ref)
    ref_dur = _total_duration(ref)
    hyp_dur = _total_duration(hyp)
    inter = _intersection_duration(hyp, ref)
    miss = ref_dur - inter
    fa = hyp_dur - inter
    denom = ref_dur if ref_dur > 0 else 1.0
    return {
        "MISS": miss / denom,
        "FA": fa / denom,
        "DetER": (miss + fa) / denom,
    }


def get_parameter_grid(params: Dict[str, object]) -> List[dict]:
    """Cartesian product over list-valued entries; scalar
    `filter_speech_first` is broadcast (vad_utils.py:584-599)."""
    params = dict(params)
    fsf = params.pop("filter_speech_first", None)
    keys = sorted(params)
    grid = [
        dict(zip(keys, combo))
        for combo in itertools.product(*(params[k] for k in keys))
    ]
    if fsf is not None:
        for g in grid:
            g["filter_speech_first"] = fsf
    return grid


def tune_thresholds(
    params: Dict[str, object],
    frame_preds: Dict[str, np.ndarray],
    ref_segments: Dict[str, Sequence[Segment]],
    *,
    focus_metric: str = "DetER",
    shift_length_in_sec: float = 0.01,
) -> Tuple[dict, Dict[str, float]]:
    """Grid-search binarization/filtering parameters on a dev set,
    minimizing the accumulated focus metric (vad_utils.py:602-667).
    `frame_preds` / `ref_segments` are keyed by utterance id."""
    if focus_metric not in ("DetER", "FA", "MISS"):
        raise ValueError("focus_metric must be DetER, FA or MISS")
    best: Tuple[Optional[dict], Optional[Dict[str, float]], float] = (None, None, float("inf"))
    common = sorted(set(frame_preds) & set(ref_segments))
    if not common:
        raise ValueError("no utterance ids shared between predictions and references")
    for param in get_parameter_grid(params):
        miss = fa = ref_total = 0.0
        for uid in common:
            hyp = postprocess_frame_predictions(
                frame_preds[uid], param, shift_length_in_sec=shift_length_in_sec
            )
            ref = merge_overlap_segments(ref_segments[uid])
            rd = _total_duration(ref)
            inter = _intersection_duration(hyp, ref)
            miss += rd - inter
            fa += _total_duration(hyp) - inter
            ref_total += rd
        denom = ref_total if ref_total > 0 else 1.0
        scores = {"MISS": miss / denom, "FA": fa / denom, "DetER": (miss + fa) / denom}
        if scores[focus_metric] < best[2]:
            best = (param, scores, scores[focus_metric])
    return best[0], best[1]


def stitch_segmented_transcripts(
    segments: Sequence[Segment], texts: Sequence[str], *, max_gap: float = 1.0
) -> List[Tuple[float, float, str]]:
    """Join per-VAD-segment ASR outputs into utterances, starting a new
    utterance when the silence gap exceeds `max_gap` seconds — the
    behavior of `stitch_segmented_asr_output` (vad_utils.py:886-959)
    without its manifest file plumbing."""
    out: List[Tuple[float, float, str]] = []
    for (s, e), text in zip(sorted(segments), texts):
        if out and s - out[-1][1] <= max_gap:
            ps, _, ptext = out[-1]
            out[-1] = (ps, e, (ptext + " " + text).strip())
        else:
            out.append((s, e, text.strip()))
    return [t for t in out if t[2]]
