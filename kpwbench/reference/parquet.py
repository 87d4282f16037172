"""A plain Parquet reader in NumPy and Python.

It reads what the benchmark's configurations write: flat schemas of
required INT32, INT64, DOUBLE and BYTE_ARRAY columns, data pages (v1 and v2)
in PLAIN or dictionary encoding (PLAIN_DICTIONARY / RLE_DICTIONARY with a
PLAIN dictionary page), UNCOMPRESSED or SNAPPY.  Anything else raises
``ParquetError``.  It follows the format's specification (parquet-format's
``parquet.thrift`` and ``Encodings.md``, Snappy's ``format_description.txt``)
and shares no code with the program that wrote the files.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"PAR1"
# parquet.thrift enums
INT32, INT64, DOUBLE, BYTE_ARRAY = 1, 2, 5, 6
PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8
UNCOMPRESSED, SNAPPY = 0, 1
DATA_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = 0, 2, 3
NUMPY = {INT32: np.dtype("<i4"), INT64: np.dtype("<i8"), DOUBLE: np.dtype("<f8")}


class ParquetError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Thrift compact protocol: structs as {field id: value}
# ---------------------------------------------------------------------------

class _Compact:
    def __init__(self, buf, pos: int = 0) -> None:
        self.buf, self.pos = buf, pos

    def varint(self) -> int:
        out = shift = 0
        buf = self.buf
        while True:
            b = buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def value(self, t: int):
        if t == 1:
            return True
        if t == 2:
            return False
        if t == 3:
            v = self.buf[self.pos]
            self.pos += 1
            return v - 256 if v > 127 else v
        if t in (4, 5, 6):
            return self.zigzag()
        if t == 7:
            v = struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return v
        if t == 8:
            n = self.varint()
            v = bytes(self.buf[self.pos:self.pos + n])
            self.pos += n
            return v
        if t in (9, 10):
            head = self.buf[self.pos]
            self.pos += 1
            n, et = head >> 4, head & 0x0F
            if n == 15:
                n = self.varint()
            if et in (1, 2):  # booleans in a list take one byte each
                out = [self.buf[self.pos + i] == 1 for i in range(n)]
                self.pos += n
                return out
            return [self.value(et) for _ in range(n)]
        if t == 11:
            n = self.varint()
            if n == 0:
                return {}
            kv = self.buf[self.pos]
            self.pos += 1
            return {self.value(kv >> 4): self.value(kv & 0x0F) for _ in range(n)}
        if t == 12:
            return self.struct()
        raise ParquetError(f"thrift: unknown type {t}")

    def struct(self) -> dict:
        out, fid = {}, 0
        while True:
            head = self.buf[self.pos]
            self.pos += 1
            if head == 0:
                return out
            delta, t = head >> 4, head & 0x0F
            fid = fid + delta if delta else self.zigzag()
            out[fid] = self.value(t)


# ---------------------------------------------------------------------------
# Snappy
# ---------------------------------------------------------------------------

def snappy_decompress(src) -> bytes:
    src = memoryview(src).cast("B") if not isinstance(src, bytes) else src
    r = _Compact(src)
    want = r.varint()
    pos, n = r.pos, len(src)
    out = bytearray()
    while pos < n:
        t = src[pos]
        kind = t & 3
        if kind == 0:
            ln = t >> 2
            if ln < 60:
                pos += 1
            else:
                k = ln - 59
                ln = int.from_bytes(src[pos + 1:pos + 1 + k], "little")
                pos += 1 + k
            ln += 1
            out += src[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:
            ln = ((t >> 2) & 7) + 4
            off = (t >> 5) << 8 | src[pos + 1]
            pos += 2
        elif kind == 2:
            ln = (t >> 2) + 1
            off = src[pos + 1] | src[pos + 2] << 8
            pos += 3
        else:
            ln = (t >> 2) + 1
            off = int.from_bytes(src[pos + 1:pos + 5], "little")
            pos += 5
        m = len(out)
        if off == 0 or off > m:
            raise ParquetError("snappy: copy before the start of the output")
        if off >= ln:
            out += out[m - off:m - off + ln]
        else:
            pat = out[m - off:]
            out += (pat * (ln // off + 1))[:ln]
    if len(out) != want:
        raise ParquetError(f"snappy: {len(out)} bytes out, the header says {want}")
    return bytes(out)


# ---------------------------------------------------------------------------
# Encodings
# ---------------------------------------------------------------------------

def unpack_bits(data, start: int, count: int, width: int) -> np.ndarray:
    """``count`` values of ``width`` bits packed LSB first from byte
    ``start`` of ``data`` (a uint8 array padded by 8 bytes)."""
    if width == 0:
        return np.zeros(count, np.uint32)
    base = data[start:]
    words = np.ndarray((len(base) - 7,), "<u8", base, 0, (1,))  # unaligned view
    bit = np.arange(count, dtype=np.int64) * width
    v = words[bit >> 3] >> (bit & 7).astype(np.uint64)
    return (v & np.uint64((1 << width) - 1)).astype(np.uint32)


def rle_hybrid(data: np.ndarray, pos: int, end: int, width: int,
               count: int) -> np.ndarray:
    """The RLE / bit-packing hybrid: ``count`` values of ``width`` bits from
    ``data[pos:end]`` (``data`` padded by 8 bytes past ``end``)."""
    parts, got = [], 0
    vbytes = (width + 7) // 8
    while got < count:
        if pos >= end:
            raise ParquetError("rle: the page ends before its values")
        h = shift = 0
        while True:
            b = int(data[pos])
            pos += 1
            h |= (b & 0x7F) << shift
            if b < 0x80:
                break
            shift += 7
        if h & 1:
            n = (h >> 1) * 8
            take = min(n, count - got)
            parts.append(unpack_bits(data, pos, take, width))
            pos += (h >> 1) * width
        else:
            n = h >> 1
            take = min(n, count - got)
            v = int.from_bytes(data[pos:pos + vbytes].tobytes(), "little")
            pos += vbytes
            parts.append(np.full(take, v, np.uint32))
        got += take
    if pos > end:
        raise ParquetError("rle: a run overruns its page")
    return np.concatenate(parts) if len(parts) != 1 else parts[0]


def plain(buf: bytes, ptype: int, count: int):
    """``count`` PLAIN values: a numpy array, or a list of bytes."""
    if ptype in NUMPY:
        dt = NUMPY[ptype]
        if len(buf) < count * dt.itemsize:
            raise ParquetError("plain: the page is shorter than its values")
        return np.frombuffer(buf, dt, count)
    if ptype != BYTE_ARRAY:
        raise ParquetError(f"plain: physical type {ptype} is not read")
    out, pos = [], 0
    for _ in range(count):
        n = int.from_bytes(buf[pos:pos + 4], "little")
        out.append(buf[pos + 4:pos + 4 + n])
        pos += 4 + n
    if pos > len(buf):
        raise ParquetError("plain: a byte array overruns its page")
    return out


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------

class Column:
    """One column chunk's metadata."""

    def __init__(self, name: str, ptype: int, meta: dict) -> None:
        self.name, self.ptype = name, ptype
        self.codec = meta[4]
        self.data_offset = meta[9]
        self.dict_offset = meta.get(11)
        self.compressed_size = meta[7]

    @property
    def start(self) -> int:
        return self.dict_offset if self.dict_offset is not None else self.data_offset


class ParquetFile:
    """A file's footer: its schema, row groups and column chunks."""

    def __init__(self, data: bytes, path: str = "") -> None:
        self.path, self.data = path, data
        if len(data) < 12 or data[:4] != MAGIC or data[-4:] != MAGIC:
            raise ParquetError(f"{path}: no parquet magic")
        flen = int.from_bytes(data[-8:-4], "little")
        if flen + 12 > len(data):
            raise ParquetError(f"{path}: footer length {flen} too large")
        meta = _Compact(data, len(data) - 8 - flen).struct()
        schema = meta[2]
        leaves = [s for s in schema[1:] if not s.get(5)]
        if len(leaves) != len(schema) - 1:
            raise ParquetError(f"{path}: nested schemas are not read")
        if any(s.get(3, 0) != 0 for s in leaves):
            raise ParquetError(f"{path}: only required columns are read")
        self.names = [s[4].decode() for s in leaves]
        self.types = [s[1] for s in leaves]
        self.num_rows = meta[3]
        self.row_groups = []
        for rg in meta[4]:
            cols = [Column(name, t, cc[3])
                    for name, t, cc in zip(self.names, self.types, rg[1])]
            self.row_groups.append((rg[3], cols))
        if sum(n for n, _ in self.row_groups) != self.num_rows:
            raise ParquetError(f"{path}: row groups do not sum to the file's rows")

    def pages(self, col: Column):
        """The column chunk's pages: (header, uncompressed body)."""
        pos, end = col.start, col.start + col.compressed_size
        while pos < end:
            r = _Compact(self.data, pos)
            head = r.struct()
            body = self.data[r.pos:r.pos + head[3]]
            pos = r.pos + head[3]
            yield head, body
        if pos != end:
            raise ParquetError(f"{self.path}: {col.name}'s pages overrun the chunk")

    def _body(self, col: Column, head: dict, body: bytes) -> bytes:
        if head[1] == DATA_PAGE_V2 and not head[8].get(7, True):
            return body
        if col.codec == UNCOMPRESSED:
            out = body
        elif col.codec == SNAPPY:
            out = snappy_decompress(body)
        else:
            raise ParquetError(f"{self.path}: codec {col.codec} is not read")
        if len(out) != head[2]:
            raise ParquetError(f"{self.path}: {col.name}: a page inflates to "
                               f"{len(out)} bytes, its header says {head[2]}")
        return out

    def column(self, col: Column, rows: int, indices: bool = False):
        """The chunk's ``rows`` values.  With ``indices``, a dictionary-
        encoded chunk comes back as (dictionary, uint32 indices) and a PLAIN
        one as (None, values)."""
        dictionary, parts, dict_parts, got = None, [], [], 0
        for head, body in self.pages(col):
            kind = head[1]
            if kind == DICTIONARY_PAGE:
                if head[7].get(2, PLAIN) not in (PLAIN, PLAIN_DICTIONARY):
                    raise ParquetError(f"{self.path}: dictionary encoding "
                                       f"{head[7].get(2)} is not read")
                dictionary = plain(self._body(col, head, body), col.ptype, head[7][1])
                continue
            if kind == DATA_PAGE:
                n, enc = head[5][1], head[5][2]
                page = self._body(col, head, body)
            elif kind == DATA_PAGE_V2:
                h2 = head[8]
                n, enc = h2[1], h2[4]
                if h2.get(2, 0) or h2.get(5, 0) or h2.get(6, 0):
                    raise ParquetError(f"{self.path}: levels in a required column")
                page = self._body(col, head, body)
            else:
                continue  # index pages carry no values
            if enc == PLAIN:
                parts.append(plain(page, col.ptype, n))
                dict_parts.append(None)
            elif enc in (PLAIN_DICTIONARY, RLE_DICTIONARY):
                if dictionary is None:
                    raise ParquetError(f"{self.path}: {col.name}: no dictionary page")
                data = np.frombuffer(page + bytes(8), np.uint8)
                idx = rle_hybrid(data, 1, len(page), int(data[0]), n)
                if len(dictionary) and int(idx.max(initial=0)) >= len(dictionary):
                    raise ParquetError(f"{self.path}: {col.name}: index past the dictionary")
                parts.append(idx)
                dict_parts.append(dictionary)
            else:
                raise ParquetError(f"{self.path}: encoding {enc} is not read")
            got += n
        if got != rows:
            raise ParquetError(f"{self.path}: {col.name} holds {got} values, "
                               f"its row group {rows}")
        if indices:
            if all(d is dictionary and d is not None for d in dict_parts):
                return dictionary, np.concatenate(parts) if parts else np.zeros(0, np.uint32)
        values = [self._values(d, p) for d, p in zip(dict_parts, parts)]
        out = _concat(values, col.ptype)
        return (None, out) if indices else out

    @staticmethod
    def _values(dictionary, part):
        if dictionary is None:
            return part
        if isinstance(dictionary, list):
            return [dictionary[i] for i in part.tolist()]
        return dictionary[part]


def _concat(values: list, ptype: int):
    if ptype == BYTE_ARRAY:
        return [v for part in values for v in part]
    return np.concatenate(values) if values else np.zeros(0, NUMPY[ptype])


def read_footer(path: str) -> ParquetFile:
    with open(path, "rb") as f:
        return ParquetFile(f.read(), path)
