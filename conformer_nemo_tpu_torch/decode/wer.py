"""Word and character error rates, host-side (port of
conformer_nemo_tpu/decode/wer.py).

The distance runs in the port's copy of the native two-row DP
(data/csrc/edit_distance.cpp, built with g++ at first use by ops/build.py
`host_library("edit_distance")`; a failed build raises); tokens are
interned to int32 ids before they cross the C interface.
`edit_distance_reference` is its plain Python twin.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np

from conformer_nemo_tpu_torch.ops.build import host_library

_SIGNED = False


def _lib() -> ctypes.CDLL:
    global _SIGNED
    lib = host_library("edit_distance")
    if not _SIGNED:
        lib.edit_distance_i32.restype = ctypes.c_int64
        lib.edit_distance_i32.argtypes = [ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                                          ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        _SIGNED = True
    return lib


def edit_distance_reference(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance between two token sequences (two-row DP, Python)."""
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


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance between two token sequences (the native DP)."""
    interned: dict = {}

    def ids(seq) -> np.ndarray:
        out = np.empty(len(seq), np.int32)
        for i, tok in enumerate(seq):
            out[i] = interned.setdefault(tok, len(interned))
        return out

    ia, ib = ids(a), ids(b)
    ptr = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    return int(_lib().edit_distance_i32(ptr(ia), len(ia), ptr(ib), len(ib)))


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
