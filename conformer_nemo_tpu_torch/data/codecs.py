"""Lossy-codec audio IO over the system codec libraries (port of
conformer_nemo_tpu/data/codecs.py).

Decoders:
- MP3 -> libmpg123 through ctypes (its feed API works on in-memory bytes,
  so tar members decode too);
- Ogg/Vorbis -> the port's shim data/csrc/ogg_mem.c over libvorbisfile
  (ctypes cannot pass vorbisfile's by-value ov_callbacks struct, and a C
  memory cursor is faster than Python read callbacks);
- Ogg/Opus -> the port's shim data/csrc/opus_mem.c over libopus + libogg
  (always 48 kHz; `load_audio` resamples).

Encoders, to make fixtures: MP3 through libmp3lame, Ogg/Vorbis through
libvorbis + libvorbisenc + libogg, Ogg/Opus through the opus shim.

Libraries load at first use; the shims build then (ops/build.py). An
absent system library raises MissingSystemLibrary (a RuntimeError) naming
it, each time it is asked for; no decoder stands in for another.
"""

from __future__ import annotations

import ctypes

import numpy as np

from conformer_nemo_tpu_torch.ops.build import MissingSystemLibrary, host_library

# ---------------------------------------------------------------- lib loading


def _lib(sonames: tuple[str, ...]) -> ctypes.CDLL:
    """dlopen the first soname that loads (hosts often ship only the
    versioned runtime file)."""
    for name in sonames:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    raise MissingSystemLibrary(f"the codec library {sonames[0]} is not available on this host")


def have_codec(name: str) -> bool:
    """True if the decode path for `name` ('mp3' | 'ogg' | 'opus') loads
    here; False where a system library it needs is absent. A shim that
    fails to build raises."""
    loaders = {"mp3": _mpg123, "ogg": _oggshim, "opus": _opusshim}
    if name not in loaders:
        return False
    try:
        loaders[name]()
    except MissingSystemLibrary:
        return False
    return True


# ------------------------------------------------------------------ mp3 read

_MPG123_OK = 0
_MPG123_NEED_MORE = -10
_MPG123_NEW_FORMAT = -11
_MPG123_DONE = -12
_ENC_S16 = 0xD0  # MPG123_ENC_SIGNED_16
_ENC_F32 = 0x200  # MPG123_ENC_FLOAT_32
_ENC_S32 = 0x1100  # MPG123_ENC_SIGNED_32


def _mpg123() -> ctypes.CDLL:
    lib = _lib(("libmpg123.so.0", "libmpg123.so"))
    lib.mpg123_init.restype = ctypes.c_int
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_open_feed.restype = ctypes.c_int
    lib.mpg123_open_feed.argtypes = [ctypes.c_void_p]
    lib.mpg123_feed.restype = ctypes.c_int
    lib.mpg123_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.mpg123_read.restype = ctypes.c_int
    lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                                ctypes.POINTER(ctypes.c_size_t)]
    lib.mpg123_getformat.restype = ctypes.c_int
    lib.mpg123_getformat.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
                                     ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_close.argtypes = [ctypes.c_void_p]
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    lib.mpg123_init()  # a no-op since libmpg123 1.27, required before
    return lib


def read_mp3_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """Decode an in-memory MP3 stream -> (float32 [T] or [T, C], sr)."""
    lib = _mpg123()
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed (code {err.value})")
    try:
        if lib.mpg123_open_feed(h) != _MPG123_OK:
            raise ValueError("mpg123_open_feed failed")
        if lib.mpg123_feed(h, data, len(data)) != _MPG123_OK:
            raise ValueError("mpg123_feed failed")
        rate, channels, encoding = ctypes.c_long(0), ctypes.c_int(0), ctypes.c_int(0)
        chunks: list[bytes] = []
        buf = ctypes.create_string_buffer(1 << 18)
        done = ctypes.c_size_t(0)
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(buf.raw[: done.value])
            if rc == _MPG123_NEW_FORMAT:
                lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(channels),
                                     ctypes.byref(encoding))
            elif rc in (_MPG123_DONE, _MPG123_NEED_MORE):
                break  # NEED_MORE after the whole stream was fed: its end
            elif rc != _MPG123_OK:
                raise ValueError(f"mpg123_read failed (code {rc})")
        if rate.value == 0:
            raise ValueError("mp3 decode produced no format (corrupt stream?)")
        raw = b"".join(chunks)
        enc = encoding.value
        if enc == _ENC_S16:
            audio = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif enc == _ENC_F32:
            audio = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif enc == _ENC_S32:
            audio = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"unexpected mpg123 output encoding 0x{enc:x}")
        ch = channels.value
        if ch > 1:
            audio = audio[: (len(audio) // ch) * ch].reshape(-1, ch)
        return audio, int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


def read_mp3(path: str) -> tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        return read_mp3_bytes(f.read())


# ------------------------------------------------- ogg/vorbis and ogg/opus read

# the shims' decoders share one signature: (data, len, &out, &n, &ch, &sr)
_DECODE_S16_ARGTYPES = [
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
    ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]


def _oggshim() -> ctypes.CDLL:
    lib = host_library("ogg_mem")
    lib.ogg_vorbis_decode.restype = ctypes.c_int
    lib.ogg_vorbis_decode.argtypes = _DECODE_S16_ARGTYPES
    lib.ogg_vorbis_free.argtypes = [ctypes.POINTER(ctypes.c_int16)]
    return lib


def _opusshim() -> ctypes.CDLL:
    lib = host_library("opus_mem")
    lib.ogg_opus_decode.restype = ctypes.c_int
    lib.ogg_opus_decode.argtypes = _DECODE_S16_ARGTYPES
    lib.ogg_opus_free.argtypes = [ctypes.POINTER(ctypes.c_int16)]
    lib.ogg_opus_encode.restype = ctypes.c_int
    lib.ogg_opus_encode.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(ctypes.c_int64)]
    lib.ogg_opus_free_bytes.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    return lib


def _decode_s16(decode, free, what: str, data: bytes) -> tuple[np.ndarray, int]:
    """Run a shim decoder over `data` -> (float32 [T] or [T, C], sr)."""
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    out = ctypes.POINTER(ctypes.c_int16)()
    n, ch, sr = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int()
    rc = decode(buf, len(data), ctypes.byref(out), ctypes.byref(n), ctypes.byref(ch),
                ctypes.byref(sr))
    if rc != 0:
        raise ValueError(f"{what} decode failed (code {rc})")
    try:
        total = n.value * ch.value
        pcm = (np.ctypeslib.as_array(out, shape=(total,)).copy() if total
               else np.zeros((0,), np.int16))
    finally:
        free(out)
    audio = pcm.astype(np.float32) / 32768.0
    if ch.value > 1:
        audio = audio.reshape(-1, ch.value)
    return audio, sr.value


def read_ogg_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """Decode an in-memory Ogg/Vorbis stream -> (float32 [T] or [T, C], sr)."""
    lib = _oggshim()
    return _decode_s16(lib.ogg_vorbis_decode, lib.ogg_vorbis_free, "Ogg/Vorbis", data)


def read_ogg(path: str) -> tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        return read_ogg_bytes(f.read())


def read_opus_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """Decode an in-memory Ogg/Opus stream -> (float32 [T] or [T, C], 48000)."""
    lib = _opusshim()
    return _decode_s16(lib.ogg_opus_decode, lib.ogg_opus_free, "Ogg/Opus", data)


def read_opus(path: str) -> tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        return read_opus_bytes(f.read())


# ----------------------------------------------------------------- mp3 write


def _lame() -> ctypes.CDLL:
    lib = _lib(("libmp3lame.so.0", "libmp3lame.so"))
    lib.lame_init.restype = ctypes.c_void_p
    for fn in ("lame_set_in_samplerate", "lame_set_num_channels", "lame_set_brate",
               "lame_set_quality", "lame_set_mode", "lame_init_params", "lame_close"):
        f = getattr(lib, fn)
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p] + ([ctypes.c_int] if "set_" in fn else [])
    lib.lame_encode_buffer.restype = ctypes.c_int
    lib.lame_encode_buffer.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    lib.lame_encode_flush.restype = ctypes.c_int
    lib.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    return lib


def write_mp3(path: str, samples: np.ndarray, sr: int = 16000, bitrate_kbps: int = 128) -> None:
    """Encode mono float32 [-1, 1] -> MP3."""
    lib = _lame()
    gfp = lib.lame_init()
    if not gfp:
        raise RuntimeError("lame_init failed")
    try:
        lib.lame_set_in_samplerate(gfp, sr)
        lib.lame_set_num_channels(gfp, 1)
        lib.lame_set_mode(gfp, 3)  # MONO
        lib.lame_set_brate(gfp, bitrate_kbps)
        lib.lame_set_quality(gfp, 2)
        if lib.lame_init_params(gfp) < 0:
            raise RuntimeError("lame_init_params failed")
        pcm = (np.clip(np.asarray(samples, np.float32), -1.0, 1.0) * 32767.0).astype("<i2")
        out = ctypes.create_string_buffer(len(pcm) * 5 // 4 + 7200)
        n = lib.lame_encode_buffer(gfp, pcm.ctypes.data_as(ctypes.c_void_p),
                                   pcm.ctypes.data_as(ctypes.c_void_p), len(pcm), out, len(out))
        if n < 0:
            raise RuntimeError(f"lame_encode_buffer failed (code {n})")
        tail = ctypes.create_string_buffer(7200)
        m = lib.lame_encode_flush(gfp, tail, len(tail))
        with open(path, "wb") as f:
            f.write(out.raw[:n])
            if m > 0:
                f.write(tail.raw[:m])
    finally:
        lib.lame_close(gfp)


# ---------------------------------------------------------- ogg/vorbis write


class _OggPage(ctypes.Structure):
    _fields_ = [("header", ctypes.c_void_p), ("header_len", ctypes.c_long),
                ("body", ctypes.c_void_p), ("body_len", ctypes.c_long)]


def _vorbis_enc_libs():
    ogg = _lib(("libogg.so.0", "libogg.so"))
    vorbis = _lib(("libvorbis.so.0", "libvorbis.so"))
    venc = _lib(("libvorbisenc.so.2", "libvorbisenc.so"))
    vorbis.vorbis_analysis_buffer.restype = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))
    vorbis.vorbis_analysis_buffer.argtypes = [ctypes.c_void_p, ctypes.c_int]
    venc.vorbis_encode_init_vbr.restype = ctypes.c_int
    venc.vorbis_encode_init_vbr.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                                            ctypes.c_float]
    return ogg, vorbis, venc


def write_ogg(path: str, samples: np.ndarray, sr: int = 16000, quality: float = 0.4) -> None:
    """Encode mono float32 [-1, 1] -> Ogg/Vorbis: libvorbis's encode loop
    (analysis, blockout, bitrate, packetin, pageout), every struct held as
    an oversized opaque buffer."""
    ogg, vorbis, venc = _vorbis_enc_libs()
    vi = ctypes.create_string_buffer(256)  # vorbis_info (56 B)
    vc = ctypes.create_string_buffer(64)  # vorbis_comment (32 B)
    vd = ctypes.create_string_buffer(4096)  # vorbis_dsp_state
    vb = ctypes.create_string_buffer(4096)  # vorbis_block
    os_ = ctypes.create_string_buffer(4096)  # ogg_stream_state (~408 B)
    op = ctypes.create_string_buffer(64)  # ogg_packet (48 B)
    page = _OggPage()

    vorbis.vorbis_info_init(vi)
    inited = []
    try:
        if venc.vorbis_encode_init_vbr(vi, 1, sr, ctypes.c_float(quality)) != 0:
            raise RuntimeError("vorbis_encode_init_vbr failed")
        vorbis.vorbis_comment_init(vc)
        inited.append(lambda: vorbis.vorbis_comment_clear(vc))
        if vorbis.vorbis_analysis_init(vd, vi) != 0:
            raise RuntimeError("vorbis_analysis_init failed")
        inited.append(lambda: vorbis.vorbis_dsp_clear(vd))
        vorbis.vorbis_block_init(vd, vb)
        inited.append(lambda: vorbis.vorbis_block_clear(vb))
        ogg.ogg_stream_init(os_, 1)
        inited.append(lambda: ogg.ogg_stream_clear(os_))

        headers = [ctypes.create_string_buffer(64) for _ in range(3)]
        vorbis.vorbis_analysis_headerout(vd, vc, *headers)
        for h in headers:
            ogg.ogg_stream_packetin(os_, h)
        out = []

        def drain(flush: bool):
            fn = ogg.ogg_stream_flush if flush else ogg.ogg_stream_pageout
            while fn(os_, ctypes.byref(page)) != 0:
                out.append(ctypes.string_at(page.header, page.header_len))
                out.append(ctypes.string_at(page.body, page.body_len))

        drain(flush=True)  # the header pages precede the audio

        def encode_pending():
            while vorbis.vorbis_analysis_blockout(vd, vb) == 1:
                vorbis.vorbis_analysis(vb, None)
                vorbis.vorbis_bitrate_addblock(vb)
                while vorbis.vorbis_bitrate_flushpacket(vd, op) == 1:
                    ogg.ogg_stream_packetin(os_, op)
                    drain(flush=False)

        pcm = np.clip(np.ascontiguousarray(samples, np.float32), -1.0, 1.0)
        for start in range(0, len(pcm), 4096):
            block = pcm[start: start + 4096]
            bufpp = vorbis.vorbis_analysis_buffer(vd, len(block))
            ctypes.memmove(bufpp[0], block.ctypes.data, 4 * len(block))
            vorbis.vorbis_analysis_wrote(vd, len(block))
            encode_pending()
        vorbis.vorbis_analysis_wrote(vd, 0)  # end of stream
        encode_pending()
        drain(flush=True)
        with open(path, "wb") as f:
            f.write(b"".join(out))
    finally:
        for clear in reversed(inited):
            clear()
        vorbis.vorbis_info_clear(vi)


# ---------------------------------------------------------- ogg/opus write


def write_opus(path: str, samples: np.ndarray, sr: int = 16000, bitrate_bps: int = 64000) -> None:
    """Encode mono float32 [-1, 1] at sr in {8, 12, 16, 24, 48} kHz -> Ogg/Opus."""
    if sr not in (8000, 12000, 16000, 24000, 48000):
        raise ValueError(f"opus input rate must be 8/12/16/24/48 kHz, got {sr}")
    lib = _opusshim()
    pcm = (np.clip(np.ascontiguousarray(samples, np.float32), -1.0, 1.0) * 32767.0).astype(
        np.int16)
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_int64()
    rc = lib.ogg_opus_encode(pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), len(pcm), sr,
                             bitrate_bps, ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0:
        raise RuntimeError(f"Ogg/Opus encode failed (code {rc})")
    try:
        data = ctypes.string_at(out, out_len.value)
    finally:
        lib.ogg_opus_free_bytes(out)
    with open(path, "wb") as f:
        f.write(data)


# -------------------------------------------------------- container dispatch


def sniff_container(data: bytes) -> str:
    """An audio container from its magic bytes -> 'wav' | 'flac' | 'mp3' |
    'ogg' | 'opus' | 'unknown'."""
    if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return "wav"
    if data[:4] == b"fLaC":
        return "flac"
    if data[:4] == b"OggS":
        # the first packet starts after the 27-byte page header and the segment table
        if len(data) > 27:
            first = 27 + data[26]
            if data[first: first + 8] == b"OpusHead":
                return "opus"
        return "ogg"
    if data[:3] == b"ID3":
        return "mp3"
    if len(data) >= 2 and data[0] == 0xFF and (data[1] & 0xE0) == 0xE0:
        return "mp3"
    return "unknown"


def snr_db(ref: np.ndarray, decoded: np.ndarray, max_lag: int = 4096) -> tuple[float, int]:
    """SNR in dB of a lossy round trip against its source, after the
    decoder's delay (the lag, <= max_lag samples, that best correlates an
    8192-sample head) -> (snr_db, lag)."""
    head = ref[:8192].astype(np.float64)
    corr = np.correlate(decoded[: len(head) + max_lag].astype(np.float64), head, mode="valid")
    lag = int(np.argmax(corr))
    m = min(len(ref), len(decoded) - lag)
    err = decoded[lag: lag + m].astype(np.float64) - ref[:m]
    return float(10.0 * np.log10(np.sum(ref[:m].astype(np.float64) ** 2) / np.sum(err ** 2))), lag
