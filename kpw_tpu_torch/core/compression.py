"""Page compression codecs.

Mirrors the codec surface the reference exposes via parquet-mr
(``CompressionCodecName`` set at KafkaProtoParquetWriter.java:484, default
UNCOMPRESSED; the only native code in the reference system is the codec JNI —
SURVEY.md §2.2).  Preference order per codec:

1. the port's own C++ library (``kpw_tpu_torch.native``) — Snappy implemented
   from scratch (or the system libsnappy, which that library dispatches to
   when it finds one), ZSTD via libzstd;
2. system libraries via ctypes / stdlib fallbacks: libsnappy, zlib and the
   ``zstandard`` module (imported on first use, so a host without it can
   still write the other codecs).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import zlib

from .schema import Codec

_snappy_ct = None


def _native():
    from .. import native

    return native.lib()


def _load_snappy_ctypes():
    global _snappy_ct
    if _snappy_ct is not None:
        return _snappy_ct
    for name in ("libsnappy.so.1", "libsnappy.so", ctypes.util.find_library("snappy")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
            lib.snappy_max_compressed_length.restype = ctypes.c_size_t
            lib.snappy_max_compressed_length.argtypes = [ctypes.c_size_t]
            lib.snappy_compress.restype = ctypes.c_int
            lib.snappy_compress.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t),
            ]
            lib.snappy_uncompress.restype = ctypes.c_int
            lib.snappy_uncompress.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t),
            ]
            lib.snappy_uncompressed_length.restype = ctypes.c_int
            lib.snappy_uncompressed_length.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
            ]
            _snappy_ct = lib
            return lib
        except OSError:
            continue
    _snappy_ct = False
    return False


def snappy_compress(data: bytes) -> bytes:
    lib = _native()
    if lib is not None:
        return lib.snappy_compress(data)
    ct = _load_snappy_ctypes()
    if ct:
        max_len = ct.snappy_max_compressed_length(len(data))
        out = ctypes.create_string_buffer(max_len)
        out_len = ctypes.c_size_t(max_len)
        rc = ct.snappy_compress(data, len(data), out, ctypes.byref(out_len))
        if rc != 0:
            raise RuntimeError(f"snappy_compress failed rc={rc}")
        return out.raw[: out_len.value]
    raise RuntimeError("no snappy implementation available")


def snappy_decompress(data: bytes) -> bytes:
    lib = _native()
    if lib is not None:
        return lib.snappy_decompress(data)
    ct = _load_snappy_ctypes()
    if ct:
        out_len = ctypes.c_size_t(0)
        rc = ct.snappy_uncompressed_length(data, len(data), ctypes.byref(out_len))
        if rc != 0:
            raise RuntimeError("bad snappy stream")
        out = ctypes.create_string_buffer(out_len.value)
        rc = ct.snappy_uncompress(data, len(data), out, ctypes.byref(out_len))
        if rc != 0:
            raise RuntimeError("snappy_uncompress failed")
        return out.raw[: out_len.value]
    raise RuntimeError("no snappy implementation available")


def zstd_compress(data: bytes, level: int = 3) -> bytes:
    lib = _native()
    if lib is not None:
        out = lib.zstd_compress(data, level)
        if out is not None:
            return out
    import zstandard

    return zstandard.ZstdCompressor(level=level).compress(data)


def zstd_decompress(data: bytes) -> bytes:
    lib = _native()
    if lib is not None:
        out = lib.zstd_decompress(data)
        if out is not None:
            return out
    import zstandard

    return zstandard.ZstdDecompressor().decompress(data)


def compress(data: bytes, codec: int, level: int | None = None) -> bytes:
    """``level`` applies to level-capable codecs (zstd default 3, gzip
    default 6 — parquet-mr's codec configuration surface, exposed via
    Builder.compression_level); snappy has no level knob."""
    if codec == Codec.UNCOMPRESSED:
        return data
    if codec == Codec.SNAPPY:
        return snappy_compress(data)
    if codec == Codec.GZIP:
        co = zlib.compressobj(6 if level is None else level,
                              zlib.DEFLATED, 16 + 15)
        return co.compress(data) + co.flush()
    if codec == Codec.ZSTD:
        return zstd_compress(data, 3 if level is None else level)
    raise ValueError(f"unsupported codec {codec}")


def decompress(data: bytes, codec: int, uncompressed_size: int | None = None) -> bytes:
    if codec == Codec.UNCOMPRESSED:
        return data
    if codec == Codec.SNAPPY:
        return snappy_decompress(data)
    if codec == Codec.GZIP:
        return zlib.decompress(data, 16 + 15)
    if codec == Codec.ZSTD:
        return zstd_decompress(data)
    raise ValueError(f"unsupported codec {codec}")


_CODEC_NAMES = {
    "uncompressed": Codec.UNCOMPRESSED,
    "none": Codec.UNCOMPRESSED,
    "snappy": Codec.SNAPPY,
    "gzip": Codec.GZIP,
    "zstd": Codec.ZSTD,
}


def codec_from_name(name) -> int:
    if isinstance(name, int):
        return name
    return _CODEC_NAMES[name.lower()]
