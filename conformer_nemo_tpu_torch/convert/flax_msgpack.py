"""flax's msgpack tree format, read and written without flax or msgpack.

The JAX package writes its checkpoints and `.cntpu` weights with
`flax.serialization.to_bytes`; this module reads and writes the same bytes:

  - a msgpack map with str keys (lists and tuples become maps {"0": ...});
  - an array leaf as ext type 1 holding packb((shape, dtype name, C-order
    bytes)); a numpy scalar as ext type 3 (the same payload, 0-d);
  - a leaf over 2^30 bytes as {"__msgpack_chunked_array__": True, "shape":
    {...}, "chunks": {...}}, flat chunks of at most 2^30 bytes.

Leaves decode to numpy arrays, except bfloat16 (numpy has no such dtype
without ml_dtypes), which decodes by its name to a CPU torch.bfloat16
tensor. `dumps` takes numpy arrays and CPU torch tensors, packing each with
the type and width msgpack-python would choose, so a tree of numpy arrays
encodes to flax's bytes exactly.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def _int(v: int) -> bytes:
    if v >= 0:
        if v < 0x80:
            return struct.pack("B", v)
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if v <= top:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        if v >= -32:
            return struct.pack("b", v)
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000), (0xD3, ">q", -2**63)):
            if v >= low:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit msgpack")


def _sized(n: int, fix: tuple | None, codes: tuple) -> bytes:
    """The header of a str/bin/array/map/ext of length n: the fix form
    (base, limit) when it applies, else the 8-, 16- or 32-bit form."""
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"length {n} does not fit msgpack")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB)) + b


def _bin(b) -> list:
    return [_sized(len(b), None, (0xC4, 0xC5, 0xC6)), b]


def _ext(code: int, payload: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(payload) in fixed:
        head = bytes([fixed[len(payload)]])
    else:
        head = _sized(len(payload), None, (0xC7, 0xC8, 0xC9))
    return head + struct.pack("b", code) + payload


def _array_bytes(x) -> tuple:
    """(shape, dtype name, C-order bytes) of a numpy array or torch tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return tuple(x.shape), "bfloat16", x.view(torch.int16).numpy().tobytes()
        x = x.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return x.shape, x.dtype.name, x.tobytes("C")


def _ndarray_payload(x) -> bytes:
    shape, name, data = _array_bytes(x)
    head = _sized(len(shape), (0x90, 16), (None, 0xDC, 0xDD))
    return b"".join([b"\x93", head, *(_int(int(d)) for d in shape), _str(name), *_bin(data)])


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _chunked(x) -> dict:
    """flax's `_chunk`: the flat array cut into pieces of <= 2^30 bytes."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, MAX_CHUNK_SIZE // itemsize)
    flat = x.reshape(-1)
    chunks = [flat[i: i + size] for i in range(0, flat.shape[0], size)]
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(node: Any, out: list) -> None:
    if isinstance(node, dict):
        out.append(_sized(len(node), (0x80, 16), (None, 0xDE, 0xDF)))
        for k, v in node.items():
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str, got {type(k).__name__}")
            out.append(_str(k))
            _pack(v, out)
    elif isinstance(node, (list, tuple)):  # flax stores sequences as maps
        _pack({str(i): v for i, v in enumerate(node)}, out)
    elif isinstance(node, (np.ndarray, torch.Tensor)):
        if _nbytes(node) > MAX_CHUNK_SIZE:
            _pack(_chunked(node), out)
        else:
            out.append(_ext(_EXT_NDARRAY, _ndarray_payload(node)))
    elif isinstance(node, np.generic):
        out.append(_ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(node))))
    elif node is None:
        out.append(b"\xc0")
    elif node is True or node is False:
        out.append(b"\xc3" if node else b"\xc2")
    elif type(node) is int:
        out.append(_int(node))
    elif type(node) is float:
        out.append(b"\xcb" + struct.pack(">d", node))
    elif type(node) is str:
        out.append(_str(node))
    elif type(node) is bytes:
        out.extend(_bin(node))
    else:
        raise TypeError(f"cannot serialize {type(node).__name__}")


def dumps(tree: Any) -> bytes:
    """A tree of dicts (str keys), lists, tuples, scalars and array leaves
    -> flax msgpack bytes (`flax.serialization.msgpack_serialize`)."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw  # str as bytes (flax's array payloads are read raw)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos: self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def value(self) -> Any:
        c = self.unpack("B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return self.array(c & 0x0F)
        if 0xA0 <= c <= 0xBF:
            return self.str(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map"),
                 0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
        if c in sized:
            fmt, kind = sized[c]
            n = self.unpack(fmt)
            if kind == "bin":  # an array payload's bytes stay a view of the data
                return self.take(n) if self.raw else bytes(self.take(n))
            if kind == "ext":
                return self.ext(n)
            return getattr(self, kind)(n)
        if 0xD4 <= c <= 0xD8:
            return self.ext(1 << (c - 0xD4))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in numbers:
            return self.unpack(numbers[c])
        raise ValueError(f"unknown msgpack byte 0x{c:02x} at {self.pos - 1}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def ext(self, n: int):
        code = self.unpack("b")
        payload = self.take(n)
        if code == _EXT_NDARRAY:
            return _array_from_payload(payload)
        if code == _EXT_NPSCALAR:
            arr = _array_from_payload(payload)
            return arr[()] if isinstance(arr, np.ndarray) else arr
        if code == _EXT_COMPLEX:
            re, im = _Reader(payload).value()
            return complex(re, im)
        raise ValueError(f"unknown msgpack ext type {code}")


def _array_from_payload(payload: memoryview):
    shape, name, data = _Reader(payload, raw=True).value()
    shape = tuple(shape)
    if name == b"bfloat16":
        return torch.frombuffer(bytearray(data), dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(data, dtype=np.dtype(name.decode())).reshape(shape)


def _unchunk(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    if node.get(_CHUNKED):
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def loads(data) -> Any:
    """flax msgpack bytes -> the tree (`flax.serialization.msgpack_restore`).
    Array leaves are read-only views of `data` (bfloat16 leaves are copies)."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack tree")
    return _unchunk(tree)
