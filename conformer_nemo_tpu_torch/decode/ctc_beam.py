"""CTC prefix beam search with n-gram LM fusion (port of
conformer_nemo_tpu/decode/ctc_beam.py): a Python wrapper over the native
C++ decoder `data/csrc/ctc_beam.cpp`, the port's own copy of the JAX
package's source, built with g++ at first use into ops/_build/
(`ops.build.host_library("ctc_beam")`).

NeMo's `BeamSearchDecoderWithLM` (nemo/collections/asr/modules/
beam_search_decoder.py:21-103) is the behaviour: the device produces
log-probs, the host runs prefix beam search with Scorer(alpha, beta,
lm_path, vocab), in parallel over the batch on CPU threads (the ctypes
call releases the GIL).
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np

from conformer_nemo_tpu_torch.decode.kenlm_binary import is_kenlm_binary, parse_header
from conformer_nemo_tpu_torch.ops.build import host_library

# KenLM data structures the native readers decode (kenlm_bin=True)
READABLE_KENLM = ("probing", "trie", "quant_trie", "array_trie", "quant_array_trie")


def _load() -> ctypes.CDLL:
    """The native decoder, built at first use, with its C ABI declared."""
    lib = host_library("ctc_beam")
    lib.ctc_lm_load.restype = ctypes.c_void_p
    lib.ctc_lm_load.argtypes = [ctypes.c_char_p]
    lib.ctc_lm_free.restype = None
    lib.ctc_lm_free.argtypes = [ctypes.c_void_p]
    lib.ctc_lm_save_binary.restype = ctypes.c_int
    lib.ctc_lm_save_binary.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ctc_lm_load_kenlm_bin.restype = ctypes.c_void_p
    lib.ctc_lm_load_kenlm_bin.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.ctc_lm_score_word.restype = ctypes.c_double
    lib.ctc_lm_score_word.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]
    lib.ctc_beam_search.restype = ctypes.c_int
    lib.ctc_beam_search.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    return lib


def _kenlm_rejection(lm_path: str, hdr, readable: bool) -> str:
    """The JAX package's actionable message for a KenLM binary it will not read."""
    hint = ("This IS a {}-structure binary: pass kenlm_bin=True (alias kenlm_probing=True) "
            "to read it directly (per-word score parity vs the real library is enforced by "
            "tests/test_kenlm_differential.py wherever the kenlm wheel exists). "
            "Alternatively, ".format(hdr.model_type) if readable else
            "The direct reader (kenlm_bin=True) covers probing and the full trie family but "
            "not this one. ")
    return (f"{lm_path} is a {hdr.describe() if hdr else 'KenLM binary'}. "
            "This framework's scorer consumes ARPA text (plus its own .binlm cache, built "
            f"automatically on first ARPA load). {hint}"
            "KenLM binaries are compiled FROM an ARPA with kenlm's build_binary and kenlm "
            "ships no reverse converter: pass the source .arpa here instead, or rebuild one "
            f"with `lmplz -o {(hdr.order if hdr and hdr.order else 'N')} <corpus.txt >lm.arpa`.")


class BeamSearchDecoderWithLM:
    """Char-level CTC prefix beam search with an optional n-gram LM.

    vocab: the labels in id order; blank is the LAST index (NeMo's
    convention: blank = V).
    """

    def __init__(self, vocab: Sequence[str], beam_width: int = 64, alpha: float = 1.0,
                 beta: float = 1.5, lm_path: Optional[str] = None, num_cpus: int = 4,
                 lm_binary_cache: bool = True, kenlm_probing: bool = False,
                 kenlm_bin: bool = False):
        """lm_binary_cache: cache the parsed ARPA tables next to the file
        (`<lm_path>.binlm`, the decoder's own flat format, not KenLM's .bin;
        the JAX package writes and reads the same format) and reload from
        the cache while it is newer than the ARPA; a cache that does not
        load is dropped and the ARPA parsed again (and cached anew).

        kenlm_bin: opt-in direct reader for KenLM `.bin` files of the
        probing and full trie families (trie, quant_trie, array_trie,
        quant_array_trie; data/csrc/kenlm_probing.h, kenlm_trie.h).
        `kenlm_probing` is the older spelling of the same opt-in. Any other
        KenLM binary raises with conversion guidance."""
        self.vocab = list(vocab)
        self.blank_id = len(self.vocab)
        self.beam_width = beam_width
        self.alpha = alpha
        self.beta = beta
        self.num_cpus = max(1, num_cpus)
        self._lib = _load()
        self._lm = None
        # the native vocabulary: the labels and a blank sentinel row
        self._vocab_joined = "\n".join(self.vocab + ["<blank>"]).encode()
        if lm_path:
            self._lm = self._load_lm(lm_path, lm_binary_cache, kenlm_bin or kenlm_probing)

    def _load_lm(self, lm_path: str, lm_binary_cache: bool, kenlm_bin: bool) -> ctypes.c_void_p:
        lib = self._lib
        if is_kenlm_binary(lm_path):
            hdr = parse_header(lm_path)
            readable = hdr is not None and hdr.model_type in READABLE_KENLM
            if not (readable and kenlm_bin):
                raise ValueError(_kenlm_rejection(lm_path, hdr, readable))
            err = ctypes.create_string_buffer(512)
            handle = lib.ctc_lm_load_kenlm_bin(lm_path.encode(), err, len(err))
            if not handle:
                raise ValueError(f"{lm_path}: {err.value.decode(errors='replace')}")
            return ctypes.c_void_p(handle)
        load_path, write_cache = lm_path, False
        if lm_binary_cache and not lm_path.endswith(".binlm"):
            cache = lm_path + ".binlm"
            if os.path.exists(cache) and os.path.getmtime(cache) >= os.path.getmtime(lm_path):
                load_path = cache
            else:
                write_cache = True
        handle = lib.ctc_lm_load(load_path.encode())
        if not handle and load_path != lm_path:
            # a stale or corrupt cache: drop it and parse the ARPA text
            try:
                os.remove(load_path)
            except OSError:
                pass
            load_path, write_cache = lm_path, True
            handle = lib.ctc_lm_load(load_path.encode())
        if not handle:
            raise ValueError(f"failed to load ARPA LM from {load_path}")
        lm = ctypes.c_void_p(handle)
        if write_cache:
            # an unwritable directory skips the cache (the call reports, nothing raises)
            lib.ctc_lm_save_binary(lm, (lm_path + ".binlm").encode())
        return lm

    def __del__(self):
        if getattr(self, "_lm", None) and getattr(self, "_lib", None):
            self._lib.ctc_lm_free(self._lm)

    def lm_score(self, context: Sequence[str], word: str) -> float:
        """log10 P(word | context) from the loaded LM (Katz backoff); raises
        without an LM."""
        if self._lm is None:
            raise ValueError("no LM loaded")
        return float(self._lib.ctc_lm_score_word(self._lm, " ".join(context).encode(),
                                                 word.encode()))

    def _decode_one(self, log_probs: np.ndarray, nbest: int) -> List[Tuple[str, float]]:
        lp = np.ascontiguousarray(log_probs, dtype=np.float32)
        t, v = lp.shape
        if v != len(self.vocab) + 1:
            raise ValueError(f"log-probs have {v} classes; the vocabulary has "
                             f"{len(self.vocab)} labels and the blank")
        buf = ctypes.create_string_buffer(1 << 20)
        n = self._lib.ctc_beam_search(
            lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), t, v, self._vocab_joined,
            self.blank_id, self.beam_width, self.alpha if self._lm else 0.0,
            self.beta if self._lm else 0.0, self._lm, nbest, buf, len(buf))
        if n < 0:
            raise RuntimeError("ctc_beam_search output buffer overflow")
        out = []
        if n > 0:
            for part in buf.value.decode("utf-8", "replace").split("\x02"):
                text, _, score = part.partition("\x01")
                out.append((text, float(score)))
        return out

    def __call__(self, log_probs_batch: np.ndarray, seq_lens: Optional[np.ndarray] = None,
                 nbest: int = 1) -> List[List[Tuple[str, float]]]:
        """[B, T, V+1] log-probs (numpy) -> per sample the n-best (text,
        score) list, decoded in parallel on `num_cpus` threads."""
        log_probs_batch = np.asarray(log_probs_batch)
        items = [log_probs_batch[i] if seq_lens is None else log_probs_batch[i, : int(seq_lens[i])]
                 for i in range(log_probs_batch.shape[0])]
        if len(items) == 1 or self.num_cpus == 1:
            return [self._decode_one(lp, nbest) for lp in items]
        with ThreadPoolExecutor(max_workers=self.num_cpus) as ex:
            return list(ex.map(lambda lp: self._decode_one(lp, nbest), items))
