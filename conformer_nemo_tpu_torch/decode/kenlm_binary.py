"""KenLM binary-file header introspection (port of
conformer_nemo_tpu/decode/kenlm_binary.py; pure Python, the same rules).

NeMo's beam decoder consumes KenLM binaries through the external
`ctc_decoders` Scorer (`nemo/collections/asr/modules/beam_search_decoder.py:64`),
and production n-gram LMs usually ship as KenLM `.bin`. The native scorer
here consumes ARPA text (plus its own `.binlm` cache); for KenLM binaries
we parse the HEADER — magic, format version, model type, order, per-order
n-gram counts — so the error a user gets is actionable ("this is a 4-gram
trie KenLM binary; dump it back to ARPA with kenlm") instead of a generic
parse failure.

This module stays header-only by design; the PROBING payload is readable
through the opt-in mmap scorer in `data/csrc/kenlm_probing.h` and the full
TRIE family (trie / quant_trie / array_trie / quant_array_trie) through
`data/csrc/kenlm_trie.h` (`BeamSearchDecoderWithLM(..., kenlm_bin=True)`;
`kenlm_probing=True` is the original spelling), which this parser gates:
only files it identifies as one of those model_types are offered that path;
rest_probing keeps the actionable rejection (a mis-parsed table that
"loads" would be strictly worse than a precise error).
`tests/test_kenlm_differential.py` carries `importorskip("kenlm")`-gated
differential tests that validate the ARPA scorer, this header parser, and
the payload readers against the real library in any environment that has
it; `tests/test_kenlm_probing.py` and `tests/test_kenlm_trie.py` validate
the readers hermetically against layout-exact fixture writers.

Layout parsed here (public format description, binary_format semantics):
  * Sanity block: magic string "mmap lm http://kheafield.com/code format
    version N\\n", then reference values — float 0.0, 1.0, -0.5; uint32 1,
    uint32 0xFFFFFFFF; uint64 1 — written so a reader can detect
    endianness/ABI mismatches. Alignment padding between magic and the
    reference values varies across builds, so we locate the reference-value
    pattern by scanning rather than assuming a fixed offset.
  * FixedWidthParameters: uint8 order, float probing_multiplier,
    uint32 model_type (0=probing, 1=rest_probing, 2=trie, 3=quant_trie,
    4=array_trie, 5=quant_array_trie), uint8 has_vocabulary,
    uint32 search_version (with natural C struct padding).
  * counts: uint64[order] n-gram counts.
Every parsed field is validated for plausibility; when validation fails we
degrade to (detected=True, details=None) rather than guessing.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional

MAGIC_PREFIX = b"mmap lm http://kheafield.com/code format version "

_MODEL_TYPES = {
    0: "probing",
    1: "rest_probing",
    2: "trie",
    3: "quant_trie",
    4: "array_trie",
    5: "quant_array_trie",
}

# float 0.0, float 1.0, float -0.5, uint32 1, uint32 max, uint64 1
_SANITY_REF = struct.pack("<fffIIQ", 0.0, 1.0, -0.5, 1, 0xFFFFFFFF, 1)


@dataclass
class KenLMHeader:
    version: Optional[int]
    model_type: Optional[str] = None
    order: Optional[int] = None
    counts: Optional[tuple] = None
    probing_multiplier: Optional[float] = None
    has_vocabulary: Optional[bool] = None

    def describe(self) -> str:
        if self.order is None:
            v = f" format version {self.version}" if self.version is not None else ""
            return f"KenLM binary language model{v}"
        total = sum(self.counts) if self.counts else 0
        return (f"KenLM binary language model (format version {self.version}, "
                f"{self.model_type or 'unknown'} data structure, order "
                f"{self.order}, {total:,} n-grams)")


def is_kenlm_binary(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(len(MAGIC_PREFIX)) == MAGIC_PREFIX
    except OSError:
        return False


def parse_header(path: str) -> Optional[KenLMHeader]:
    """Best-effort header parse. None if not a KenLM binary; a KenLMHeader
    with only `version` set if the magic matches but the parameter block
    fails plausibility validation."""
    try:
        with open(path, "rb") as f:
            head = f.read(4096)
            f.seek(0, 2)
            file_size = f.tell()
    except OSError:
        return None
    if not head.startswith(MAGIC_PREFIX):
        return None

    # version digits follow the prefix, terminated by '\n'
    version = None
    rest = head[len(MAGIC_PREFIX):len(MAGIC_PREFIX) + 16]
    digits = b""
    for ch in rest:
        if 0x30 <= ch <= 0x39:
            digits += bytes([ch])
        else:
            break
    if digits:
        version = int(digits)
    out = KenLMHeader(version=version)

    # locate the sanity reference values (alignment between the magic string
    # and these varies; the 24-byte pattern itself is unambiguous)
    idx = head.find(_SANITY_REF, len(MAGIC_PREFIX))
    if idx < 0:
        return out
    pos = idx + len(_SANITY_REF)
    # the uint64 ends the Sanity struct; FixedWidthParameters follows at the
    # next natural alignment boundary. Try the plausible paddings.
    for pad in (0, 4, 8):
        p = pos + pad
        # uint8 order, pad(3), float multiplier, uint32 model_type,
        # uint8 has_vocab, pad(3), uint32 search_version
        if p + 20 > len(head):
            continue
        order = head[p]
        try:
            (mult,) = struct.unpack_from("<f", head, p + 4)
            (mtype,) = struct.unpack_from("<I", head, p + 8)
            has_vocab = head[p + 12]
        except struct.error:
            continue
        if not (1 <= order <= 9):
            continue
        if mtype not in _MODEL_TYPES:
            continue
        if mtype in (0, 1) and not (1.0 <= mult <= 64.0):
            continue
        if has_vocab not in (0, 1):
            continue
        # counts (uint64[order]) follow the 20-byte params struct; their
        # alignment is build-dependent, so accept sequential or 8-aligned
        counts = None
        for cstart in dict.fromkeys((p + 20, p + 20 + ((-(p + 20)) % 8))):
            cand = []
            ok = True
            cpos = cstart
            for _ in range(order):
                if cpos + 8 > len(head):
                    ok = False
                    break
                (c,) = struct.unpack_from("<Q", head, cpos)
                # per-count plausibility: probing tables cost >= 4 bytes per
                # n-gram; quantized/compressed tries can go lower, so only
                # bound them at >= 1 byte/gram (heavily packed array tries)
                per_gram = 4 if mtype in (0, 1) else 1
                if c == 0 or c > max(1, file_size) // per_gram + 1:
                    ok = False
                    break
                cand.append(c)
                cpos += 8
            # totals must be plausible against the file size (probing tables
            # are ~16 bytes/gram; quantized tries can dip toward 1 byte/gram
            # — a tighter bound would reject valid headers and degrade the
            # rejection message to its version-only form)
            if ok and sum(cand) * (2 if mtype in (0, 1) else 1) <= file_size:
                counts = cand
                break
        if counts is None:
            continue
        out.model_type = _MODEL_TYPES[mtype]
        out.order = order
        out.counts = tuple(counts)
        out.probing_multiplier = float(mult)
        out.has_vocabulary = bool(has_vocab)
        return out
    return out
