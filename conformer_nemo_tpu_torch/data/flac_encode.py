"""Minimal vectorised FLAC encoder (port of conformer_nemo_tpu/data/flac_encode.py):
mono, 16-bit, FIXED order-2 subframes with Rice-coded residuals.

It writes real FLAC fixtures without an external encoder. The stream has
the spec's shape (STREAMINFO, frame headers with UTF-8 frame numbers, FIXED
order-2 subframes with Rice residuals), so decoding it does the decoder's
real work (bit reading, Rice decode, fixed-predictor reconstruction) rather
than a VERBATIM shortcut. Header and frame CRCs are written as zero: the
port's decoder (data/csrc/flac_decoder.cpp) reads but does not verify
them, so these files are fixtures, not interchange.

Rice packing is vectorised with numpy (bit positions from a cumulative sum
of per-sample code lengths): over 1e6 samples/s.
"""

from __future__ import annotations

import numpy as np


def _bits_of(value: int, n: int) -> np.ndarray:
    return np.array([(value >> i) & 1 for i in range(n - 1, -1, -1)], dtype=np.uint8)


def _utf8_number(n: int) -> list[int]:
    """FLAC frame-number coding (UTF-8-style, values < 2^16 here)."""
    if n < 0x80:
        return [n]
    if n < 0x800:
        return [0xC0 | (n >> 6), 0x80 | (n & 0x3F)]
    if n < 0x10000:
        return [0xE0 | (n >> 12), 0x80 | ((n >> 6) & 0x3F), 0x80 | (n & 0x3F)]
    raise ValueError("frame number too large")


def _rice_bits(res: np.ndarray, k: int) -> np.ndarray:
    """Rice-code int64 residuals with parameter k into a 0/1 uint8 bit array."""
    v = res.astype(np.int64)
    u = np.where(v >= 0, v << 1, ((-v) << 1) - 1).astype(np.uint64)
    q = (u >> np.uint64(k)).astype(np.int64)
    lens = q + 1 + k
    total = int(lens.sum())
    off = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=off[1:])
    bits = np.zeros(total, np.uint8)
    stop = off + q
    bits[stop] = 1
    for j in range(k):
        bits[stop + 1 + j] = ((u >> np.uint64(k - 1 - j)) & np.uint64(1)).astype(np.uint8)
    return bits


def _best_rice_k(res: np.ndarray) -> int:
    v = res.astype(np.int64)
    u = np.where(v >= 0, v << 1, ((-v) << 1) - 1).astype(np.uint64)
    best_k, best_cost = 0, None
    for k in range(15):
        cost = int((u >> np.uint64(k)).sum()) + len(u) * (1 + k)
        if best_cost is None or cost < best_cost:
            best_k, best_cost = k, cost
    return best_k


def encode_flac(samples: np.ndarray, sr: int = 16000, block: int = 4096) -> bytes:
    """Encode mono int16 (or float in [-1,1]) samples to a FLAC byte stream."""
    if samples.dtype.kind == "f":
        x = np.clip(np.round(samples * 32768.0), -32768, 32767).astype(np.int64)
    else:
        x = samples.astype(np.int64)
    n = len(x)

    # STREAMINFO (34 bytes payload), last-metadata flag set
    si = [_bits_of(0x80, 8), _bits_of(34, 24),
          _bits_of(block, 16), _bits_of(block, 16),
          _bits_of(0, 24), _bits_of(0, 24),
          _bits_of(sr, 20), _bits_of(0, 3), _bits_of(15, 5),  # mono, 16 bps
          _bits_of(n, 36)] + [_bits_of(0, 8)] * 16  # md5 zero
    chunks = [np.concatenate(si)]

    for fno, start in enumerate(range(0, n, block)):
        blk = x[start : start + block]
        bs = len(blk)
        hdr = [_bits_of(0x3FFE, 14), _bits_of(0, 1), _bits_of(0, 1),
               _bits_of(7, 4),  # block size: 16-bit field at frame end
               _bits_of(0, 4),  # sample rate: from STREAMINFO
               _bits_of(0, 4),  # mono
               _bits_of(4, 3),  # 16-bit
               _bits_of(0, 1)]
        for b in _utf8_number(fno):
            hdr.append(_bits_of(b, 8))
        hdr.append(_bits_of(bs - 1, 16))
        hdr.append(_bits_of(0, 8))  # header CRC-8 (unverified by our decoder)

        if bs > 2:
            order = 2
            res = blk[2:] - 2 * blk[1:-1] + blk[:-2]
            k = _best_rice_k(res)
            sub = [_bits_of((8 + order) << 1, 8)]  # type FIXED|order, no wasted bits
            for s in blk[:order]:
                sub.append(_bits_of(int(s) & 0xFFFF, 16))
            sub += [_bits_of(0, 2), _bits_of(0, 4),  # rice method, partition order 0
                    _bits_of(k, 4), _rice_bits(res, k)]
        else:  # tiny tail frame: VERBATIM
            sub = [_bits_of(1 << 1, 8)]
            for s in blk:
                sub.append(_bits_of(int(s) & 0xFFFF, 16))

        frame = np.concatenate(hdr + sub)
        pad = (-len(frame)) % 8
        if pad:
            frame = np.concatenate([frame, np.zeros(pad, np.uint8)])
        frame = np.concatenate([frame, np.zeros(16, np.uint8)])  # frame CRC-16
        chunks.append(frame)

    allbits = np.concatenate(chunks)
    return b"fLaC" + np.packbits(allbits).tobytes()


def write_flac(path: str, samples: np.ndarray, sr: int = 16000, block: int = 4096):
    with open(path, "wb") as f:
        f.write(encode_flac(samples, sr, block))
