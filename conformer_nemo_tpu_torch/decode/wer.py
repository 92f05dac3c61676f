"""Word/character error rate, host-side (port of conformer_nemo_tpu/decode/wer.py,
its pure-Python edit distance; the native one waits)."""

from __future__ import annotations

from typing import List, Sequence


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance between two token sequences (two-row DP)."""
    if len(a) < len(b):
        a, b = b, a
    if len(b) == 0:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        cur = [i]
        for j, cb in enumerate(b, start=1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def wer_num_denom(hypotheses: List[str], references: List[str], use_cer: bool = False):
    """(edits, reference words) summed over the pairs; corpus WER is their
    ratio, summed across batches first."""
    scores, words = 0, 0
    for h, r in zip(hypotheses, references):
        h_list = list(h) if use_cer else h.split()
        r_list = list(r) if use_cer else r.split()
        words += len(r_list)
        scores += edit_distance(h_list, r_list)
    return scores, words


def word_error_rate(hypotheses: List[str], references: List[str], use_cer: bool = False) -> float:
    """Corpus-level WER = total edits / total reference words."""
    if len(hypotheses) != len(references):
        raise ValueError(f"hypotheses ({len(hypotheses)}) and references ({len(references)}) "
                         "must have the same number of elements")
    scores, words = wer_num_denom(hypotheses, references, use_cer)
    return scores / words if words else float("inf")
