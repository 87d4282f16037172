"""NativeChunkEncoder — the C++ host encode path at the pluggable boundary.

Same primitive-op boundary as ``core.pages.CpuChunkEncoder``, with the
dictionary builds, RLE/bit-pack, delta, BYTE_STREAM_SPLIT, codecs and page
assembly moved into the port's native library (``native/src``).  Output is
byte-identical to the Python encoder; what the native path does not cover
(narrow dtypes, codecs the assembler lacks, a failed build) falls through to
the superclass.  ``ops.backend.CudaChunkEncoder`` subclasses it, as the JAX
package's device encoder subclasses its own native encoder.
"""

from __future__ import annotations

import struct
import threading

import numpy as np

from ..core import encodings as enc
from ..core.bytecol import ByteColumn, lens_and_payload
from ..core.pages import CpuChunkEncoder, EncoderOptions
from ..core.schema import Codec, Encoding, PhysicalType
from . import assemble, lib


class NativeChunkEncoder(CpuChunkEncoder):
    """Byte-identical C++ implementation of the chunk encoder primitives.

    encode_many and the launch / assemble split ride the superclass; the
    hot primitives here are native calls that release the interpreter lock,
    so :meth:`_parallel_assembly_ok` lets page assembly shard columns
    across the shared assembly pool."""

    def __init__(self, options: EncoderOptions) -> None:
        super().__init__(options)
        self._lib = lib()
        self._asm = assemble() if options.native_assembly else None
        self._tl = threading.local()  # per-thread compression scratch

    def _parallel_assembly_ok(self) -> bool:
        return self._lib is not None

    def _native_assembler(self):
        """The nogil assembler when it covers this encoder's codec, else
        None (Python page loops).  SNAPPY also needs the ctypes library, so
        the fallback path compresses with the same object code; ZSTD needs
        zstd in both builds for the same reason.  GZIP and other codecs
        always take the Python loops."""
        asm = self._asm
        if asm is None or not self.options.native_assembly:
            return None
        codec = self.options.codec
        if codec == Codec.UNCOMPRESSED:
            return asm
        if codec == Codec.SNAPPY and self._lib is not None:
            return asm
        if (codec == Codec.ZSTD and asm.HAS_ZSTD
                and self._lib is not None and self._lib.has_zstd):
            return asm
        return None

    def _page_stats_min_max(self, chunk, va: int, vb: int, pt: int):
        """ByteColumn page statistics through the C++ lexicographic scan
        instead of a Python min/max over bytes objects."""
        v = chunk.values
        if self._lib is not None and isinstance(v, ByteColumn) and vb > va:
            sub = v[va:vb]
            mn, mx = self._lib.bytes_min_max(sub.data, sub.offsets)
            lo, hi = bytes(sub[mn]), bytes(sub[mx])
            return lo, hi, lo, hi
        return super()._page_stats_min_max(chunk, va, vb, pt)

    @staticmethod
    def _fixed_width_ok(values, pt: int) -> bool:
        """Fixed-width numeric columns: the ones the native primitives and
        the device dictionary build take."""
        return (
            isinstance(values, np.ndarray)
            and values.dtype.kind in "iuf"
            and values.dtype.itemsize in (4, 8)
            and pt not in (PhysicalType.BOOLEAN, PhysicalType.BYTE_ARRAY,
                           PhysicalType.FIXED_LEN_BYTE_ARRAY)
        )

    def _native_ok(self, values, pt: int) -> bool:
        return self._lib is not None and self._fixed_width_ok(values, pt)

    def _fixed_width_max_k(self, n: int, itemsize: int) -> int:
        """Largest dictionary that survives encode()'s rejection checks (the
        ratio bound and the dictionary-page byte budget) for a fixed-width
        column: the native early abort's bound."""
        opts = self.options
        return min(max(1, int(n * opts.max_dictionary_ratio)),
                   opts.dictionary_page_size_limit // itemsize)

    def _bytes_native_ok(self, values, pt: int) -> bool:
        return (self._lib is not None
                and pt in (PhysicalType.BYTE_ARRAY,
                           PhysicalType.FIXED_LEN_BYTE_ARRAY)
                and isinstance(values, (list, ByteColumn)))

    @staticmethod
    def _bytes_parts(values) -> tuple[bytes, np.ndarray]:
        if not isinstance(values, ByteColumn):
            values = ByteColumn.from_list(values)
        return values.data, values.offsets  # zero-copy, absolute offsets

    def _bytes_dictionary(self, values, max_k: int | None):
        data, offsets = self._bytes_parts(values)
        built = self._lib.dict_build_bytes(data, offsets, max_k)
        if built is None:
            return None
        uniq_pos, idx = built
        if isinstance(values, ByteColumn):
            return values.take(uniq_pos), idx
        return [values[p] for p in uniq_pos], idx

    def _dictionary_build(self, values, pt: int):
        if self._bytes_native_ok(values, pt):
            return self._bytes_dictionary(values, None)
        if not self._native_ok(values, pt):
            return super()._dictionary_build(values, pt)
        key = values.view(np.uint32 if values.dtype.itemsize == 4 else np.uint64)
        d, idx = self._lib.dict_build(key)
        return d.view(values.dtype), idx

    def _try_dictionary(self, chunk):
        values = chunk.values
        pt = chunk.column.leaf.physical_type
        # a column with a bloom filter needs the exact distinct set whatever
        # the dictionary verdict: finishing the build is cheaper than a
        # second distinct pass, so the ratio early abort is waived
        keep_distinct = self._bloom_wants_distinct(chunk)
        if self._bytes_native_ok(values, pt):
            # early abort at the ratio bound (the byte budget needs the
            # built dictionary, so encode() applies it afterwards)
            max_k = (None if keep_distinct else
                     max(1, int(len(values) * self.options.max_dictionary_ratio)))
            return self._bytes_dictionary(values, max_k)
        if not self._native_ok(values, pt):
            return super()._try_dictionary(chunk)
        n = len(values)
        max_k = (n if keep_distinct
                 else self._fixed_width_max_k(n, values.dtype.itemsize))
        key = values.view(np.uint32 if values.dtype.itemsize == 4 else np.uint64)
        built = self._lib.dict_build(key, max_k=max_k)
        if built is None:
            return None  # proven infeasible; encode() falls back to plain/delta
        d, idx = built
        return d.view(values.dtype), idx

    def _values_body(self, values, pt: int, encoding: int) -> bytes:
        L = self._lib
        if L is not None and encoding == Encoding.DELTA_BINARY_PACKED:
            bit_size = 32 if pt == PhysicalType.INT32 else 64
            return L.delta_binary_packed(np.asarray(values), bit_size)
        if L is not None and encoding == Encoding.DELTA_LENGTH_BYTE_ARRAY:
            lens, payload = lens_and_payload(values)
            return L.delta_binary_packed(lens, 32) + payload
        if (L is not None and encoding == Encoding.BYTE_STREAM_SPLIT
                and pt in enc._PLAIN_DTYPES):
            # the column's PLAIN dtype first, as the Python route: the
            # transpose must see the on-wire value bytes
            return L.byte_stream_split(
                np.ascontiguousarray(values, enc._PLAIN_DTYPES[pt]))
        return super()._values_body(values, pt, encoding)

    def _values_page_parts(self, chunk, va: int, vb: int, pt: int,
                           encoding: int) -> list:
        """DELTA_LENGTH_BYTE_ARRAY without building the concatenation:
        [the delta-of-lengths header, a zero-copy payload view], which the
        codec streams (page bytes unchanged)."""
        v = chunk.values
        if (self._lib is not None
                and encoding == Encoding.DELTA_LENGTH_BYTE_ARRAY
                and isinstance(v, ByteColumn)):
            o = v.offsets
            lens = np.diff(o[va:vb + 1])
            delta = self._lib.delta_binary_packed(lens, 32)
            payload = memoryview(v.data)[int(o[va]):int(o[vb])]
            return [delta, payload]
        return super()._values_page_parts(chunk, va, vb, pt, encoding)

    def _compress_parts(self, parts: list, body_len: int):
        """ZSTD and SNAPPY pages compress straight from the parts into
        per-thread scratch (no body concatenation, no compressed-bytes
        copy); other codecs take the base path."""
        opts = self.options
        if (self._lib is not None and opts.codec == Codec.ZSTD
                and self._lib.has_zstd):
            level = 3 if opts.compression_level is None else opts.compression_level
            res = self._lib.zstd_compress_parts(
                parts, level, getattr(self._tl, "zscratch", None))
            if res is not None:
                arr, n = res
                self._tl.zscratch = arr  # reused; the consumer copies at once
                return memoryview(arr)[:n], n
        if self._lib is not None and opts.codec == Codec.SNAPPY:
            arr, n = self._lib.snappy_compress_parts(
                parts, getattr(self._tl, "sscratch", None))
            self._tl.sscratch = arr  # reused; the consumer copies at once
            return memoryview(arr)[:n], n
        return super()._compress_parts(parts, body_len)

    def _stats_min_max(self, values, pt: int):
        if (self._lib is not None and isinstance(values, ByteColumn)
                and len(values)):
            mn, mx = self._lib.bytes_min_max(values.data, values.offsets)
            return values[mn], values[mx]
        return super()._stats_min_max(values, pt)

    def _plain_body(self, values, pt: int) -> bytes:
        if (self._lib is not None and isinstance(values, ByteColumn)
                and pt == PhysicalType.BYTE_ARRAY):
            return self._lib.byte_array_plain(values.data, values.offsets)
        return super()._plain_body(values, pt)

    def _indices_body(self, indices, va: int, vb: int, dict_size: int) -> bytes:
        L = self._lib
        if L is None or not isinstance(indices, np.ndarray):
            return super()._indices_body(indices, va, vb, dict_size)
        width = enc.bit_width(max(dict_size - 1, 0))
        return bytes([width]) + L.rle_hybrid(indices[va:vb], width)

    def _levels_body(self, levels: np.ndarray, max_level: int) -> bytes:
        L = self._lib
        if L is None:
            return super()._levels_body(levels, max_level)
        body = L.rle_hybrid(np.asarray(levels), enc.bit_width(max_level))
        return struct.pack("<I", len(body)) + body
