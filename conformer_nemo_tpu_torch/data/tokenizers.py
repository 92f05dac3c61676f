"""Tokenizers (port of conformer_nemo_tpu/data/tokenizers.py).

- A dependency-free SentencePiece model reader (hand-rolled protobuf
  wire-format parse) that encodes (`text_to_ids`: the model's normalizer,
  then BPE merges in score order for BPE models or Viterbi segmentation
  for unigram models, with byte fallback) and decodes (`ids_to_text`).
- The char tokenizer for `labels` configs with the reference CharParser's
  rules, and the "en" parser's cleaning (data/cleaners.py).
- HuggingFace `tokenizer.json` files through the port's own reader
  (data/hf_tokenizer.py), a word tokenizer over a vocab file, and the
  aggregate multilang tokenizer: per-language tokenizers whose id spaces
  follow one another in config order.

`build_tokenizer` takes a config section as the JAX package's does.
"""

from __future__ import annotations

import heapq
import os
import struct
import unicodedata
from typing import Dict, List, Optional

from conformer_nemo_tpu_torch.data.cleaners import clean_text, make_table
from conformer_nemo_tpu_torch.data.hf_tokenizer import HFJsonTokenizer


class CharTokenizer:
    """Char-level tokenizer over a `labels` list with the reference
    CharParser's rules (strip, lowercase, per-word special labels, unknown
    characters dropped). `parser="en"` first runs the ENCharParser cleaning
    (ascii-fold, number and abbreviation expansion, punctuation words:
    data/cleaners.py); the default "base" does not, as in the JAX package."""

    def __init__(self, labels: List[str], *, unk_id: int = -1, blank_id: int = -1,
                 do_lowercase: bool = True, do_normalize: bool = True, parser: str = "base"):
        self.labels = list(labels)
        self._labels_map = {label: i for i, label in enumerate(self.labels)}
        self._special_labels = {label for label in self.labels if len(label) > 1}
        self._unk_id = unk_id
        self._blank_id = blank_id
        self._do_lowercase = do_lowercase
        self._do_normalize = do_normalize
        if parser not in ("base", "en"):
            raise ValueError(f"unknown parser {parser!r} (base | en)")
        self._en_table = make_table(self.labels) if parser == "en" else None

    @property
    def vocab_size(self) -> int:
        return len(self.labels)

    def text_to_ids(self, text: str) -> List[int]:
        if self._en_table is not None:
            text = clean_text(text, self._en_table)
        if self._do_normalize:
            text = text.strip()
            if self._do_lowercase:
                text = text.lower()
        tokens: List[int] = []
        for word_id, word in enumerate(text.split(" ")):
            if word_id != 0:
                tokens.append(self._labels_map.get(" ", self._unk_id))
            if word in self._special_labels:
                tokens.append(self._labels_map[word])
                continue
            for char in word:
                tokens.append(self._labels_map.get(char, self._unk_id))
        return [t for t in tokens if t != self._blank_id]

    def ids_to_text(self, ids: List[int]) -> str:
        return "".join(self.labels[i] for i in ids if 0 <= i < len(self.labels))

    def ids_to_tokens(self, ids: List[int]) -> List[str]:
        return [self.labels[i] for i in ids if 0 <= i < len(self.labels)]


def _read_varint(buf: bytes, i: int):
    shift, out = 0, 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _parse_protobuf_fields(buf: bytes):
    """Minimal protobuf wire-format walker: yields (field_number, wire_type, value)."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, i = _read_varint(buf, i)
        elif wire == 1:  # 64-bit
            val, i = buf[i : i + 8], i + 8
        elif wire == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            val, i = buf[i : i + ln], i + ln
        elif wire == 5:  # 32-bit
            val, i = buf[i : i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def load_sentencepiece_model(model_path: str):
    """ModelProto -> (pieces [(piece, score, type)], trainer_spec, normalizer_spec).

    ModelProto{pieces=1, trainer_spec=2, normalizer_spec=3};
    SentencePiece{piece=1:str, score=2:float, type=3:enum} (types: 1=NORMAL,
    2=UNK, 3=CONTROL, 4=USER_DEFINED, 6=BYTE); TrainerSpec{model_type=3
    (1=unigram, 2=bpe, 3=word, 4=char), byte_fallback=35};
    NormalizerSpec{name=1, add_dummy_prefix=3, remove_extra_whitespaces=4,
    escape_whitespaces=5}."""
    with open(model_path, "rb") as f:
        data = f.read()
    pieces = []
    trainer = {"model_type": 1, "byte_fallback": False}
    norm = {"name": "nmt_nfkc", "add_dummy_prefix": True,
            "remove_extra_whitespaces": True, "escape_whitespaces": True}
    for field, wire, val in _parse_protobuf_fields(data):
        if field == 1 and wire == 2:
            piece, score, ptype = None, 0.0, 1
            for f2, w2, v2 in _parse_protobuf_fields(val):
                if f2 == 1 and w2 == 2:
                    piece = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            if piece is not None:
                pieces.append((piece, score, ptype))
        elif field == 2 and wire == 2:
            for f2, w2, v2 in _parse_protobuf_fields(val):
                if f2 == 3 and w2 == 0:
                    trainer["model_type"] = v2
                elif f2 == 35 and w2 == 0:
                    trainer["byte_fallback"] = bool(v2)
        elif field == 3 and wire == 2:
            for f2, w2, v2 in _parse_protobuf_fields(val):
                if f2 == 1 and w2 == 2:
                    norm["name"] = v2.decode("utf-8")
                elif f2 == 3 and w2 == 0:
                    norm["add_dummy_prefix"] = bool(v2)
                elif f2 == 4 and w2 == 0:
                    norm["remove_extra_whitespaces"] = bool(v2)
                elif f2 == 5 and w2 == 0:
                    norm["escape_whitespaces"] = bool(v2)
    return pieces, trainer, norm


_SP_SPACE = "▁"  # SentencePiece meta-space
_UNK_PIECE, _CONTROL_PIECE, _BYTE_PIECE = 2, 3, 6

# nmt_* normalizers (sentencepiece builder.cc BuildNmtNFKCMap) apply two
# rule families before NFKC: control characters are deleted, the
# whitespace family becomes an ASCII space (exact codepoint lists)
_NMT_CHARMAP = {c: None for c in (list(range(0x0001, 0x0009)) + [0x000B]
                                  + list(range(0x000E, 0x0020)) + [0x007F, 0x008F, 0x009F])}
_NMT_CHARMAP.update({c: " " for c in ([0x0009, 0x000A, 0x000C, 0x000D, 0x1680]
                                      + list(range(0x200B, 0x2010))
                                      + [0x2028, 0x2029, 0x2581, 0xFEFF, 0xFFFD])})


def _byte_piece_value(piece: str):
    """'<0xNN>' byte-fallback piece -> int value, else None."""
    if len(piece) == 6 and piece.startswith("<0x") and piece.endswith(">"):
        try:
            return int(piece[3:5], 16)
        except ValueError:
            return None
    return None


class SentencePieceTokenizer:
    """Tokenizer over a SentencePiece model file (the sentencepiece library's
    behaviour, re-implemented from the model file)."""

    def __init__(self, model_path: str):
        raw, trainer, norm = load_sentencepiece_model(model_path)
        self.pieces = [p for p, _, _ in raw]
        self.scores = [s for _, s, _ in raw]
        self.types = [t for _, _, t in raw]
        self.model_type = int(trainer.get("model_type", 1))
        self.byte_fallback = bool(trainer.get("byte_fallback", False))
        self.norm = norm
        # UNK and CONTROL pieces never match text (bpe_model.cc skips them)
        self._piece_to_id = {p: i for i, (p, t) in enumerate(zip(self.pieces, self.types))
                             if t not in (_UNK_PIECE, _CONTROL_PIECE)}
        self.unk_id = next((i for i, t in enumerate(self.types) if t == _UNK_PIECE), 0)
        self._max_piece_len = max((len(p) for p in self.pieces), default=1)

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    def _normalize(self, text: str) -> str:
        name = self.norm.get("name") or ""
        if "nmt" in name:
            text = text.translate(_NMT_CHARMAP)
        if "nfkc" in name:
            text = unicodedata.normalize("NFKC", text)
        if self.norm.get("remove_extra_whitespaces", True):
            # the library collapses and strips only ' '
            out = []
            for ch in text:
                if ch == " " and out and out[-1] == " ":
                    continue
                out.append(ch)
            text = "".join(out).strip(" ")
        if not text:
            return ""  # empty or whitespace-only input encodes to []
        if self.norm.get("add_dummy_prefix", True):
            text = " " + text
        if self.norm.get("escape_whitespaces", True):
            text = text.replace(" ", _SP_SPACE)
        return text

    def _char_ids(self, ch: str) -> List[int]:
        """An out-of-vocabulary character -> byte pieces (byte_fallback) or unk."""
        if not self.byte_fallback:
            return [self.unk_id]
        out = []
        for b in ch.encode("utf-8"):
            bid = self._piece_to_id.get("<0x%02X>" % b)
            out.append(bid if bid is not None else self.unk_id)
        return out

    def text_to_ids(self, text: str) -> List[int]:
        s = self._normalize(text)
        if not s:
            return []
        if self.model_type == 2:
            return self._encode_bpe(s)
        return self._encode_viterbi(s)

    def _encode_bpe(self, s: str) -> List[int]:
        """bpe_model.cc: an agenda of adjacent symbol pairs ordered by (merged
        piece's score desc, left position asc); merge until no pair's
        concatenation is a piece."""
        n = len(s)
        sym = list(s)  # symbol strings, indexed by original left position
        nxt = list(range(1, n)) + [-1]
        prv = [-1] + list(range(n - 1))
        alive = [True] * n
        heap: list = []

        def push(left: int):
            if left < 0 or nxt[left] < 0:
                return
            merged = sym[left] + sym[nxt[left]]
            pid = self._piece_to_id.get(merged)
            if pid is not None:
                heapq.heappush(heap, (-self.scores[pid], left, merged))

        for i in range(n - 1):
            push(i)
        while heap:
            _, left, merged = heapq.heappop(heap)
            right = nxt[left]
            if not alive[left] or right < 0 or not alive[right] or sym[left] + sym[right] != merged:
                continue  # stale agenda entry
            sym[left] = merged
            alive[right] = False
            nxt[left] = nxt[right]
            if nxt[right] >= 0:
                prv[nxt[right]] = left
            push(prv[left])
            push(left)

        ids: List[int] = []
        i = 0  # position 0 stays alive: a merge keeps the left symbol
        while i >= 0:
            pid = self._piece_to_id.get(sym[i])
            ids.extend([pid] if pid is not None else self._char_ids(sym[i]))
            i = nxt[i]
        return ids

    def _encode_viterbi(self, s: str) -> List[int]:
        """unigram_model.cc: the segmentation maximising the summed piece
        scores; an unknown character costs -100 and falls back to bytes/unk."""
        n = len(s)
        neg = -1e18
        best = [neg] * (n + 1)
        back: List[Optional[tuple]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] <= neg / 2:
                continue
            for j in range(i + 1, min(n, i + self._max_piece_len) + 1):
                pid = self._piece_to_id.get(s[i:j])
                if pid is None:
                    if j == i + 1 and best[i] - 100.0 > best[j]:
                        best[j], back[j] = best[i] - 100.0, (i, None)
                    continue
                sc = best[i] + self.scores[pid]
                if sc > best[j]:
                    best[j], back[j] = sc, (i, pid)
        ids: List[int] = []
        j = n
        while j > 0:
            i, pid = back[j]
            ids.extend(reversed(self._char_ids(s[i:j]) if pid is None else [pid]))
            j = i
        return ids[::-1]

    def ids_to_text(self, ids: List[int]) -> str:
        # byte-fallback pieces (type BYTE) reassemble into UTF-8 bytes, as the
        # sentencepiece library's DecodePieces does
        out: List[str] = []
        byte_buf = bytearray()
        for i in ids:
            if not 0 <= i < len(self.pieces):
                continue
            p = self.pieces[i]
            b = _byte_piece_value(p) if self.types[i] == _BYTE_PIECE else None
            if b is not None:
                byte_buf.append(b)
                continue
            if byte_buf:
                out.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()
            out.append(p)
        if byte_buf:
            out.append(byte_buf.decode("utf-8", errors="replace"))
        return "".join(out).replace(_SP_SPACE, " ").strip()

    def ids_to_tokens(self, ids: List[int]) -> List[str]:
        return [self.pieces[i] for i in ids if 0 <= i < len(self.pieces)]


class AggregateTokenizer:
    """Per-language tokenizers whose id spaces follow one another in config
    order (the reference AggregateTokenizer): `text_to_ids(text, lang)`
    offsets the language's ids; `ids_to_text` decodes each run of ids with
    the language that owns them and joins the runs with a space."""

    def __init__(self, tokenizers_by_lang: Dict[str, object]):
        self.langs = list(tokenizers_by_lang)
        self.tokenizers = tokenizers_by_lang
        self.offsets: Dict[str, int] = {}
        off = 0
        for lang in self.langs:
            self.offsets[lang] = off
            off += tokenizers_by_lang[lang].vocab_size
        self._total = off

    @property
    def vocab_size(self) -> int:
        return self._total

    def text_to_ids(self, text: str, lang: str) -> List[int]:
        off = self.offsets[lang]
        return [i + off for i in self.tokenizers[lang].text_to_ids(text)]

    def _owner(self, idx: int) -> tuple:
        for lang in reversed(self.langs):
            if idx >= self.offsets[lang]:
                return lang, idx - self.offsets[lang]
        raise ValueError(f"id {idx} out of range")

    def ids_to_text(self, ids: List[int]) -> str:
        out, group, cur = [], [], None
        for idx in ids:
            lang, local = self._owner(idx)
            if lang != cur and group:
                out.append(self.tokenizers[cur].ids_to_text(group))
                group = []
            cur = lang
            group.append(local)
        if group:
            out.append(self.tokenizers[cur].ids_to_text(group))
        return " ".join(t for t in out if t)


class WordTokenizer:
    """Word-level tokenizer over a vocabulary list (the reference
    WordTokenizer): whitespace-split words, unknown words -> the unk token."""

    def __init__(self, vocab: List[str], unk_token: str = "<unk>"):
        self.labels = list(vocab)
        if unk_token not in self.labels:
            self.labels.append(unk_token)
        self._map = {w: i for i, w in enumerate(self.labels)}
        self._unk_id = self._map[unk_token]

    @property
    def vocab_size(self) -> int:
        return len(self.labels)

    def text_to_ids(self, text: str) -> List[int]:
        return [self._map.get(w, self._unk_id) for w in text.strip().split()]

    def ids_to_tokens(self, ids: List[int]) -> List[str]:
        return [self.labels[i] for i in ids if 0 <= i < len(self.labels)]

    def ids_to_text(self, ids: List[int]) -> str:
        return " ".join(self.ids_to_tokens(ids))


def _read_lines(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f if line.rstrip("\n")]


def build_tokenizer(cfg: dict, parser: str = "base"):
    """Tokenizer from a config section, case for case as the JAX package's:
    {'labels': [...]} (char, with `parser`); {'type': 'agg', 'langs':
    {lang: section}}; {'type': 'word', 'vocab_file' or 'dir'}; {'model_file':
    path} (SentencePiece); else {'dir': d} with d/tokenizer.json (HF),
    d/tokenizer.model (SentencePiece) or d/vocab.txt (char labels, case
    kept), in that order."""
    if "labels" in cfg:
        return CharTokenizer(cfg["labels"], parser=parser)
    ttype = cfg.get("type", "bpe")
    if ttype == "agg":
        return AggregateTokenizer({lang: build_tokenizer(sub)
                                   for lang, sub in cfg["langs"].items()})
    if ttype == "word":
        return WordTokenizer(_read_lines(cfg.get("vocab_file")
                                         or os.path.join(cfg["dir"], "vocab.txt")))
    if cfg.get("model_file"):
        return SentencePieceTokenizer(cfg["model_file"])
    d = cfg.get("dir")
    if not d or d == "???":
        raise ValueError(f"tokenizer config {cfg} names neither model_file nor dir")
    for name, build in (("tokenizer.json", HFJsonTokenizer),
                        ("tokenizer.model", SentencePieceTokenizer),
                        ("vocab.txt", lambda p: CharTokenizer(_read_lines(p), do_lowercase=False))):
        path = os.path.join(d, name)
        if os.path.exists(path):
            return build(path)
    raise FileNotFoundError(f"no tokenizer artifacts found in {d}")
