"""A plain protobuf wire decoder for flat messages of scalar fields, after
the encoding guide of protocol buffers: varint (wire type 0), 64-bit
(1), length-delimited (2) and 32-bit (5) fields.  It reads records one by
one in Python and shares no code with the program's shredders."""

from __future__ import annotations

import struct


class WireError(ValueError):
    pass


def _varint(buf, pos: int) -> tuple:
    out = shift = 0
    while True:
        if pos >= len(buf):
            raise WireError("varint runs past the record")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, pos
        shift += 7


def decode(record: bytes, schema: list) -> dict:
    """One record's fields by name: int64 and int32 as Python ints (two's
    complement), double as float, string as bytes."""
    by_number = {f["number"]: f for f in schema}
    out, pos = {}, 0
    while pos < len(record):
        key, pos = _varint(record, pos)
        number, wt = key >> 3, key & 7
        f = by_number.get(number)
        if wt == 0:
            v, pos = _varint(record, pos)
            if f is not None and f["type"] in ("int64", "int32"):
                v = v - (1 << 64) if v >> 63 else v
                if f["type"] == "int32":
                    v = (v + (1 << 31)) % (1 << 32) - (1 << 31)
        elif wt == 1:
            v = record[pos:pos + 8]
            pos += 8
            if f is not None and f["type"] == "double":
                v = struct.unpack("<d", v)[0]
        elif wt == 2:
            n, pos = _varint(record, pos)
            v = record[pos:pos + n]
            pos += n
        elif wt == 5:
            v = record[pos:pos + 4]
            pos += 4
        else:
            raise WireError(f"wire type {wt}")
        if pos > len(record):
            raise WireError("a field runs past the record")
        if f is not None:
            out[f["name"]] = v
    missing = [f["name"] for f in schema if f["name"] not in out]
    if missing:
        raise WireError(f"required fields missing: {missing}")
    return out
