"""A reader of HuggingFace `tokenizer.json` files, without the `tokenizers`
package (which the JAX package's `HFTokenizer` wraps, and which a host may
lack).

It encodes and decodes as `tokenizers` does for the parts such files use:
- models: BPE (merges by rank, the leftmost first; continuing-subword
  prefix, end-of-word suffix, byte fallback, fused unknowns, ignore_merges)
  and WordPiece (greedy longest match, `##` continuations);
- normalizers: NFC, NFD, NFKC, NFKD, Lowercase, Strip, StripAccents,
  Replace (a plain string), Prepend, BertNormalizer, Sequence;
- pre-tokenizers: Metaspace, Whitespace, WhitespaceSplit, BertPreTokenizer,
  Punctuation, Sequence;
- decoders: Metaspace, WordPiece, BPEDecoder, ByteFallback, Fuse, Replace
  (a plain string), Strip, Sequence;
- added tokens (matched leftmost-longest on the raw text, or on the
  normalized text when `normalized`), skipped on decode when special.

Any other component, a post-processor, truncation or padding raises
NotImplementedError naming it. `Whitespace`'s word class takes Unicode's
Alphabetic property as the letter categories and Nl, so the few symbols
Unicode also calls alphabetic (circled letters) split differently.
"""

from __future__ import annotations

import heapq
import json
import re
import unicodedata
from typing import Callable, List, Optional

# Unicode White_Space (Rust's char::is_whitespace)
_WHITE_SPACE = frozenset([*range(0x9, 0xE), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
                          0x2028, 0x2029, 0x202F, 0x205F, 0x3000])
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _is_whitespace(c: str) -> bool:
    return ord(c) in _WHITE_SPACE


def _is_word(c: str) -> bool:
    """Rust regex's Unicode word class (Alphabetic, marks, Nd, Pc,
    Join_Control), with Alphabetic taken as the letter categories and Nl."""
    cat = unicodedata.category(c)
    return cat[0] in "LM" or cat in ("Nd", "Nl", "Pc") or c in "\u200c\u200d"


def _is_punctuation(c: str) -> bool:
    return (c.isascii() and not c.isalnum() and 0x21 <= ord(c) <= 0x7E) or \
        unicodedata.category(c).startswith("P")


def _unsupported(kind: str, spec) -> NotImplementedError:
    name = spec.get("type") if isinstance(spec, dict) else spec
    return NotImplementedError(f"tokenizer.json: the {kind} {name!r} is not supported by "
                               "the port's reader")


# ---------------------------------------------------------------------------
# normalizers: str -> str
# ---------------------------------------------------------------------------


def _bert_normalizer(spec: dict) -> Callable[[str], str]:
    clean, chinese = spec.get("clean_text", True), spec.get("handle_chinese_chars", True)
    lowercase = spec.get("lowercase", True)
    strip = spec.get("strip_accents")
    strip = lowercase if strip is None else strip

    def run(s: str) -> str:
        if clean:
            s = "".join(" " if c in "\t\n\r" or _is_whitespace(c) else c for c in s
                        if not (c in ("\x00", "�")
                                or (c not in "\t\n\r" and unicodedata.category(c)[0] == "C")))
        if chinese:
            s = "".join(f" {c} " if any(lo <= ord(c) <= hi for lo, hi in _CJK) else c for c in s)
        if strip:
            s = "".join(c for c in unicodedata.normalize("NFD", s)
                        if unicodedata.category(c) != "Mn")
        return s.lower() if lowercase else s

    return run


def _normalizer(spec: Optional[dict]) -> Callable[[str], str]:
    if spec is None:
        return lambda s: s
    kind = spec["type"]
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s: unicodedata.normalize(kind, s)
    if kind == "Lowercase":
        return str.lower
    if kind == "Strip":
        left, right = spec.get("strip_left", True), spec.get("strip_right", True)
        chars = "".join(map(chr, _WHITE_SPACE))

        def strip(s: str) -> str:
            s = s.lstrip(chars) if left else s
            return s.rstrip(chars) if right else s

        return strip
    if kind == "StripAccents":
        return lambda s: "".join(c for c in s if not unicodedata.category(c).startswith("M"))
    if kind == "Replace":
        pattern = spec["pattern"]
        if "String" not in pattern:
            raise _unsupported("normalizer", "Replace with a Regex pattern")
        return lambda s: s.replace(pattern["String"], spec["content"])
    if kind == "Prepend":
        return lambda s: spec["prepend"] + s if s else s
    if kind == "BertNormalizer":
        return _bert_normalizer(spec)
    if kind == "Sequence":
        parts = [_normalizer(p) for p in spec["normalizers"]]

        def run(s: str) -> str:
            for p in parts:
                s = p(s)
            return s

        return run
    raise _unsupported("normalizer", spec)


# ---------------------------------------------------------------------------
# pre-tokenizers: [(piece, starts at original offset 0)] -> the same, split
# ---------------------------------------------------------------------------


def _split(s: str, is_delim: Callable[[str], bool], behavior: str) -> List[tuple]:
    """tokenizers' NormalizedString::split on a char pattern -> [(start, end)]
    (empty pieces dropped)."""
    spans, i, n = [], 0, len(s)
    while i < n:
        match = is_delim(s[i])
        j = i + 1
        if not match or behavior == "Contiguous":
            while j < n and is_delim(s[j]) == match:
                j += 1
        spans.append((i, j, match))
        i = j
    if behavior == "Removed":
        out = [(a, b) for a, b, m in spans if not m]
    elif behavior in ("Isolated", "Contiguous"):
        out = [(a, b) for a, b, _ in spans]
    elif behavior in ("MergedWithPrevious", "MergedWithNext"):
        nxt = behavior == "MergedWithNext"
        out, prev_match = [], False
        for a, b, m in (reversed(spans) if nxt else spans):
            if m and not prev_match and out:
                out[-1] = (a, out[-1][1]) if nxt else (out[-1][0], b)
            else:
                out.append((a, b))
            prev_match = m
        if nxt:
            out.reverse()
    else:
        raise _unsupported("split behavior", behavior)
    return [(a, b) for a, b in out if a != b]


def _pre_tokenizer(spec: Optional[dict]) -> Callable[[List[tuple]], List[tuple]]:
    def per_piece(fn: Callable[[str, bool], List[tuple]]):
        return lambda pieces: [out for p, first in pieces for out in fn(p, first)]

    def split_with(is_delim, behavior):
        return per_piece(lambda p, first: [(p[a:b], first and a == 0)
                                           for a, b in _split(p, is_delim, behavior)])

    if spec is None:
        return lambda pieces: pieces
    kind = spec["type"]
    if kind == "Metaspace":
        rep, scheme = spec.get("replacement", "▁"), spec.get("prepend_scheme", "always")
        split = spec.get("split", True)

        def meta(p: str, first: bool) -> List[tuple]:
            p = p.replace(" ", rep)
            if p and not p.startswith(rep) and (scheme == "always" or (scheme == "first"
                                                                         and first)):
                p = rep + p
            if not split:
                return [(p, first)]
            return [(p[a:b], first and a == 0) for a, b in _split(p, lambda c: c == rep,
                                                                   "MergedWithNext")]

        return per_piece(meta)
    if kind == "Whitespace":  # the regex \w+|[^\w\s]+, with Rust's Unicode classes
        def words(p: str, first: bool) -> List[tuple]:
            out, i = [], 0
            while i < len(p):
                if _is_whitespace(p[i]):
                    i += 1
                    continue
                kind_i, j = _is_word(p[i]), i + 1
                while j < len(p) and not _is_whitespace(p[j]) and _is_word(p[j]) == kind_i:
                    j += 1
                out.append((p[i:j], first and i == 0))
                i = j
            return out

        return per_piece(words)
    if kind == "WhitespaceSplit":
        return split_with(_is_whitespace, "Removed")
    if kind == "BertPreTokenizer":
        ws, punct = split_with(_is_whitespace, "Removed"), split_with(_is_punctuation, "Isolated")
        return lambda pieces: punct(ws(pieces))
    if kind == "Punctuation":
        return split_with(_is_punctuation, spec.get("behavior", "Isolated"))
    if kind == "Sequence":
        parts = [_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def run(pieces):
            for p in parts:
                pieces = p(pieces)
            return pieces

        return run
    raise _unsupported("pre-tokenizer", spec)


# ---------------------------------------------------------------------------
# decoders: [token] -> [token]
# ---------------------------------------------------------------------------


def _byte_fallback(tokens: List[str]) -> List[str]:
    out: List[str] = []
    pending = bytearray()

    def flush():
        if pending:
            try:
                out.append(pending.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" * len(pending))
            pending.clear()

    for t in tokens:
        value = None
        if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
            try:
                value = int(t[3:5], 16)
            except ValueError:
                value = None
        if value is None:
            flush()
            out.append(t)
        else:
            pending.append(value)
    flush()
    return out


def _wordpiece_cleanup(s: str) -> str:
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                 (" n't", "n't"), (" 'm", "'m"), (" do not", " don't"), (" 's", "'s"),
                 (" 've", "'ve"), (" 're", "'re")):
        s = s.replace(a, b)
    return s


def _decoder(spec: Optional[dict]) -> Optional[Callable[[List[str]], List[str]]]:
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "Metaspace":
        rep, never = spec.get("replacement", "▁"), spec.get("prepend_scheme", "always") == "never"
        return lambda tokens: ["".join(("" if i == 0 and not never else " ") if c == rep else c
                                       for c in t) for i, t in enumerate(tokens)]
    if kind == "WordPiece":
        prefix, cleanup = spec.get("prefix", "##"), spec.get("cleanup", True)

        def wordpiece(tokens):
            out = []
            for i, t in enumerate(tokens):
                if i != 0:
                    t = t.replace(prefix, "", 1) if t.startswith(prefix) else " " + t
                out.append(_wordpiece_cleanup(t) if cleanup else t)
            return out

        return wordpiece
    if kind == "BPEDecoder":
        suffix = spec.get("suffix", "</w>")
        return lambda tokens: [t.replace(suffix, "" if i == len(tokens) - 1 else " ")
                               for i, t in enumerate(tokens)]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Replace":
        pattern = spec["pattern"]
        if "String" not in pattern:
            raise _unsupported("decoder", "Replace with a Regex pattern")
        return lambda tokens: [t.replace(pattern["String"], spec["content"]) for t in tokens]
    if kind == "Strip":
        content, start, stop = spec["content"], spec.get("start", 0), spec.get("stop", 0)

        def strip(t: str) -> str:
            lo, hi = 0, len(t)
            while lo < min(start, hi) and t[lo] == content:
                lo += 1
            n = 0
            while n < stop and hi > lo and t[hi - 1] == content:
                hi, n = hi - 1, n + 1
            return t[lo:hi]

        return lambda tokens: [strip(t) for t in tokens]
    if kind == "Sequence":
        parts = [_decoder(p) for p in spec["decoders"]]

        def run(tokens):
            for p in parts:
                tokens = p(tokens)
            return tokens

        return run
    raise _unsupported("decoder", spec)


# ---------------------------------------------------------------------------
# models: one pre-tokenized word -> ids
# ---------------------------------------------------------------------------


class _BPE:
    def __init__(self, spec: dict):
        if spec.get("dropout"):
            raise _unsupported("BPE option", "dropout")
        self.vocab = spec["vocab"]
        self.unk = spec.get("unk_token")
        self.prefix = spec.get("continuing_subword_prefix") or ""
        self.suffix = spec.get("end_of_word_suffix") or ""
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.merges = {}  # (left id, right id) -> (rank, merged id)
        for rank, m in enumerate(spec.get("merges", [])):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            merged = a + b[len(self.prefix):]
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[merged])

    def tokenize(self, word: str) -> List[int]:
        if not word:
            return []
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        ids: List[int] = []
        unk: Optional[int] = None  # a pending unknown (fused ones count once)
        for i, ch in enumerate(word):
            s = (self.prefix if i else "") + ch + (self.suffix if i == len(word) - 1 else "")
            if s in self.vocab:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(self.vocab[s])
                continue
            if self.byte_fallback:
                byte_ids = [self.vocab.get("<0x%02X>" % b) for b in s.encode("utf-8")]
                if all(b is not None for b in byte_ids):
                    ids.extend(byte_ids)
                    continue
            if self.unk is None:
                raise ValueError(f"tokenizer.json: {s!r} is out of the vocabulary and the "
                                 "BPE model has no unk_token")
            if unk is not None and not self.fuse_unk:
                ids.append(unk)
            unk = self.vocab[self.unk]
        if unk is not None:
            ids.append(unk)
        return self._merge(ids)

    def _merge(self, ids: List[int]) -> List[int]:
        """tokenizers' Word::merge_all: the lowest-ranked pair first, the
        leftmost among equals."""
        n = len(ids)
        nxt, prv, alive = list(range(1, n)) + [-1], list(range(-1, n - 1)), [True] * n
        heap = []
        for pos in range(n - 1):
            m = self.merges.get((ids[pos], ids[pos + 1]))
            if m is not None:
                heap.append((m[0], pos, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] < 0:
                continue
            right = nxt[pos]
            m = self.merges.get((ids[pos], ids[right]))
            if m is None or m[1] != new_id:
                continue  # a stale entry
            ids[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[right] >= 0:
                prv[nxt[right]] = pos
            if prv[pos] >= 0:
                m = self.merges.get((ids[prv[pos]], ids[pos]))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[pos], m[1]))
            if nxt[pos] >= 0:
                m = self.merges.get((ids[pos], ids[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [t for t, a in zip(ids, alive) if a]


class _WordPiece:
    def __init__(self, spec: dict):
        self.vocab = spec["vocab"]
        self.unk = spec.get("unk_token", "[UNK]")
        self.prefix = spec.get("continuing_subword_prefix", "##")
        self.max_chars = int(spec.get("max_input_chars_per_word", 100))

    def tokenize(self, word: str) -> List[int]:
        if len(word) > self.max_chars:
            return [self.vocab[self.unk]]
        out, start = [], 0
        while start < len(word):
            end = len(word)
            while start < end:
                sub = (self.prefix if start else "") + word[start:end]
                if sub in self.vocab:
                    out.append(self.vocab[sub])
                    break
                end -= 1
            if start == end:
                return [self.vocab[self.unk]]
            start = end
        return out


# ---------------------------------------------------------------------------
# the tokenizer
# ---------------------------------------------------------------------------


class HFJsonTokenizer:
    """A `tokenizer.json` (BPE or WordPiece) read without the `tokenizers`
    package: `text_to_ids` is its `encode(text).ids`, `ids_to_text` its
    `decode(ids)` (special tokens skipped)."""

    def __init__(self, path: str):
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        for key in ("truncation", "padding", "post_processor"):
            if spec.get(key) is not None:
                raise _unsupported(key.replace("_", "-"), spec[key] if key == "post_processor"
                                   else key)
        model = spec["model"]
        kind = model.get("type") or ("BPE" if "merges" in model else "WordPiece")
        if kind == "BPE":
            self.model = _BPE(model)
        elif kind == "WordPiece":
            self.model = _WordPiece(model)
        else:
            raise _unsupported("model", kind)
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.decoder = _decoder(spec.get("decoder"))
        self.added = {}  # content -> id
        self.special = set()
        for tok in spec.get("added_tokens") or []:
            for opt in ("single_word", "lstrip", "rstrip"):
                if tok.get(opt):
                    raise _unsupported("added-token option", opt)
            self.added[tok["content"]] = tok["id"]
            if tok.get("special"):
                self.special.add(tok["id"])
        raw = [t["content"] for t in spec.get("added_tokens") or [] if not t.get("normalized")]
        norm = [t["content"] for t in spec.get("added_tokens") or [] if t.get("normalized")]
        self._raw_re = self._alternation(raw)
        self._norm_re = self._alternation(norm)
        self.id_to_token = {i: t for t, i in self.model.vocab.items()}
        self.id_to_token.update({i: t for t, i in self.added.items()})
        self._vocab_size = len(set(self.model.vocab) | set(self.added))

    @staticmethod
    def _alternation(tokens: List[str]):
        if not tokens:
            return None  # leftmost-longest: the longest alternative first
        return re.compile("|".join(re.escape(t) for t in sorted(tokens, key=len, reverse=True)))

    @staticmethod
    def _segments(text: str, pattern, first: bool) -> List[tuple]:
        """-> [(text, is an added token, starts the input)]."""
        if pattern is None:
            return [(text, False, first)] if text else []
        out, pos = [], 0
        for m in pattern.finditer(text):
            if m.start() > pos:
                out.append((text[pos:m.start()], False, first and pos == 0))
            out.append((m.group(0), True, False))
            pos = m.end()
        if pos < len(text):
            out.append((text[pos:], False, first and pos == 0))
        return out

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    def text_to_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        for raw, is_added, first in self._segments(text, self._raw_re, True):
            if is_added:
                ids.append(self.added[raw])
                continue
            for seg, is_added2, first2 in self._segments(self.normalize(raw), self._norm_re,
                                                         first):
                if is_added2:
                    ids.append(self.added[seg])
                    continue
                for word, _ in self.pre_tokenize([(seg, first2)]):
                    ids.extend(self.model.tokenize(word))
        return ids

    def ids_to_tokens(self, ids: List[int]) -> List[str]:
        """Each id's token, added tokens included (ids outside the
        vocabulary are dropped)."""
        table = {**self.id_to_token, **{i: t for t, i in self.added.items()}}
        return [table[i] for i in ids if i in table]

    def ids_to_text(self, ids: List[int]) -> str:
        tokens = [self.id_to_token[i] for i in ids
                  if i in self.id_to_token and i not in self.special]
        if self.decoder is None:
            return " ".join(tokens)
        return "".join(self.decoder(tokens))
