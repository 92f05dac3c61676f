"""Tokenizers for decoding (port of conformer_nemo_tpu/data/tokenizers.py).

The slice needs `ids_to_text` only: a dependency-free SentencePiece model
reader (hand-rolled protobuf wire-format parse) and the char tokenizer for
`labels` configs. The HuggingFace `tokenizer.json` path waits for the
ROADMAP.md queue-1 item "HF tokenizer": it needs the `tokenizers` package.
"""

from __future__ import annotations

import os
import struct
from typing import List


class CharTokenizer:
    """Char-level vocabulary from a `labels` list (decode side of the JAX
    package's CharTokenizer)."""

    def __init__(self, labels: List[str]):
        self.labels = list(labels)

    @property
    def vocab_size(self) -> int:
        return len(self.labels)

    def ids_to_text(self, ids: List[int]) -> str:
        return "".join(self.labels[i] for i in ids if 0 <= i < len(self.labels))


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


def load_sentencepiece_pieces(model_path: str) -> list[tuple[str, float, int]]:
    """ModelProto field 1 = repeated SentencePiece{piece=1:str, score=2:float,
    type=3:enum} (types: 1=NORMAL, 2=UNK, 3=CONTROL, 4=USER_DEFINED, 6=BYTE)."""
    with open(model_path, "rb") as f:
        data = f.read()
    pieces = []
    for field, wire, val in _parse_protobuf_fields(data):
        if field != 1 or wire != 2:
            continue
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
    return pieces


_SP_SPACE = "▁"  # SentencePiece meta-space
_BYTE_PIECE = 6


def _byte_piece_value(piece: str):
    """'<0xNN>' byte-fallback piece -> int value, else None."""
    if len(piece) == 6 and piece.startswith("<0x") and piece.endswith(">"):
        try:
            return int(piece[3:5], 16)
        except ValueError:
            return None
    return None


class SentencePieceTokenizer:
    """Decode-only tokenizer over a SentencePiece model file."""

    def __init__(self, model_path: str):
        raw = load_sentencepiece_pieces(model_path)
        self.pieces = [p for p, _, _ in raw]
        self.types = [t for _, _, t in raw]

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

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


def build_tokenizer(cfg: dict):
    """Tokenizer from a config dict: {'labels': [...]} (char),
    {'model_file': path} or {'dir': d} with d/tokenizer.model."""
    if "labels" in cfg:
        return CharTokenizer(cfg["labels"])
    if cfg.get("model_file"):
        return SentencePieceTokenizer(cfg["model_file"])
    d = cfg["dir"]
    # same precedence as the JAX package: tokenizer.json before tokenizer.model
    if os.path.exists(os.path.join(d, "tokenizer.json")):
        raise NotImplementedError(
            f"{d}/tokenizer.json: HuggingFace tokenizers are not ported yet "
            "(ROADMAP.md queue 1, 'HF tokenizer')")
    sp_model = os.path.join(d, "tokenizer.model")
    if os.path.exists(sp_model):
        return SentencePieceTokenizer(sp_model)
    raise FileNotFoundError(f"no tokenizer.model found in {d}")
