"""Diarization scoring: DER, confusion, false alarm and miss with the optimal
speaker mapping, and RTTM reading and writing (port of
conformer_nemo_tpu/decode/der.py; host numpy and scipy).

    DER = (MISS + FA + CONFUSION) / TOTAL REFERENCE SPEECH

over the elementary intervals between segment boundaries, with the
hypothesis-to-reference speaker mapping that maximises their overlap (a
Hungarian assignment), a no-score zone of +-collar around every reference
boundary (pyannote's collar: total width 2 * collar), and, with
`ignore_overlap`, the reference's overlapped speech left unscored.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple

import numpy as np

Segment = Tuple[float, float, str]  # (start_s, end_s, speaker)


# -- RTTM ------------------------------------------------------------------------

def rttm_to_segments(path: str) -> List[Segment]:
    """The SPEAKER lines of an RTTM file -> [(start, end, speaker)]."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split()
            if not parts or parts[0] != "SPEAKER":
                continue
            start, dur, speaker = float(parts[3]), float(parts[4]), parts[7]
            out.append((start, start + dur, speaker))
    return out


def segments_to_rttm(segments: Sequence[Segment], uniq_id: str) -> str:
    """[(start, end, speaker)] -> RTTM text, one SPEAKER line each."""
    lines = []
    for start, end, speaker in segments:
        lines.append(
            f"SPEAKER {uniq_id} 1   {start:.3f}   {end - start:.3f} "
            f"<NA> <NA> {speaker} <NA> <NA>")
    return "\n".join(lines) + ("\n" if lines else "")


def write_rttm(path: str, segments: Sequence[Segment], uniq_id: str) -> str:
    with open(path, "w", encoding="utf-8") as f:
        f.write(segments_to_rttm(segments, uniq_id))
    return path


# -- DER -------------------------------------------------------------------------

def _overlap(a: Segment, b: Segment) -> float:
    return max(0.0, min(a[1], b[1]) - max(a[0], b[0]))


def optimal_speaker_mapping(ref: Sequence[Segment], hyp: Sequence[Segment]) -> Dict[str, str]:
    """hypothesis speaker -> reference speaker, maximising the total overlap
    (pairs that do not overlap at all stay unmapped)."""
    ref_spk = sorted({s for _, _, s in ref})
    hyp_spk = sorted({s for _, _, s in hyp})
    if not ref_spk or not hyp_spk:
        return {}
    cost = np.zeros((len(hyp_spk), len(ref_spk)))
    for (i, hs), (j, rs) in itertools.product(enumerate(hyp_spk), enumerate(ref_spk)):
        cost[i, j] = sum(_overlap(r, h) for r in ref if r[2] == rs for h in hyp if h[2] == hs)
    from scipy.optimize import linear_sum_assignment

    rows, cols = linear_sum_assignment(-cost)
    return {hyp_spk[i]: ref_spk[j] for i, j in zip(rows, cols) if cost[i, j] > 0}


def der_score(ref: Sequence[Segment], hyp: Sequence[Segment], collar: float = 0.25,
              ignore_overlap: bool = True) -> Dict[str, float]:
    """DER and its parts over the elementary intervals -> {"DER", "CER",
    "FA", "MISS", "total_speech_s", "mapping"}."""
    mapping = optimal_speaker_mapping(ref, hyp)
    hyp_m = [(s, e, mapping.get(spk, f"__hyp_{spk}")) for s, e, spk in hyp]

    noscore = []  # around every reference boundary
    for s, e, _ in ref:
        noscore.append((s - collar, s + collar))
        noscore.append((e - collar, e + collar))

    points = sorted({p for s, e, _ in list(ref) + hyp_m for p in (s, e)}
                    | {p for z in noscore for p in z})
    miss = fa = conf = total = 0.0
    for a, b in zip(points, points[1:]):
        dur = b - a
        if dur <= 0:
            continue
        mid = 0.5 * (a + b)
        if any(zs < mid < ze for zs, ze in noscore):
            continue
        r = {spk for s, e, spk in ref if s < mid < e}
        h = {spk for s, e, spk in hyp_m if s < mid < e}
        if ignore_overlap and len(r) > 1:
            continue
        total += len(r) * dur
        miss += max(len(r) - len(h), 0) * dur
        fa += max(len(h) - len(r), 0) * dur
        conf += (min(len(r), len(h)) - len(r & h)) * dur
    denom = max(total, 1e-12)
    return {"DER": (miss + fa + conf) / denom, "CER": conf / denom, "FA": fa / denom,
            "MISS": miss / denom, "total_speech_s": total, "mapping": mapping}


def score_rttm_files(pairs: Sequence[Tuple[str, str]], collar: float = 0.25,
                     ignore_overlap: bool = True) -> Dict[str, float]:
    """Cumulative DER over (reference RTTM, hypothesis RTTM) pairs: the
    errors and the reference speech summed over the files before dividing."""
    sums = {"miss": 0.0, "fa": 0.0, "conf": 0.0, "total": 0.0}
    for ref_path, hyp_path in pairs:
        r = der_score(rttm_to_segments(ref_path), rttm_to_segments(hyp_path), collar,
                      ignore_overlap)
        t = r["total_speech_s"]
        sums["miss"] += r["MISS"] * t
        sums["fa"] += r["FA"] * t
        sums["conf"] += r["CER"] * t
        sums["total"] += t
    denom = max(sums["total"], 1e-12)
    return {"DER": (sums["miss"] + sums["fa"] + sums["conf"]) / denom,
            "CER": sums["conf"] / denom, "FA": sums["fa"] / denom, "MISS": sums["miss"] / denom,
            "total_speech_s": sums["total"]}
