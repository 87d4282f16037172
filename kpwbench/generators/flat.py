"""Flat protobuf records of required scalar fields, made from a seed.

A configuration's ``schema`` lists its fields in field-number order; each
field names its protobuf type and how its values are drawn:

- ``{"draw": "int", "low": a, "high": b, "scale": s}``: an integer drawn
  uniformly from [a, b), times s (int64, int32);
- ``{"draw": "ratio", "low": a, "high": b, "divisor": d}``: an integer
  drawn uniformly from [a, b), divided by d (double);
- ``{"draw": "choice", "format": "cat_%03d", "count": n}``: one of the n
  strings ``format % j`` (string).

:func:`make_pool` draws ``pool_records`` records from the seed and
serializes them as protobuf writes them (fields in number order, int64 and
int32 as varints, double as fixed64, string length-delimited).  The topic
cycles through the pool: partition ``p`` holds at offset ``o`` the record
``pool[(o + p * stride) % n]`` (``Pool.index``), so any committed record
can be recomputed from the seed, its partition and its offset.

The wire encoders (``varints``, ``encode_flat``) and the descriptor
stand-ins are copies of ``chip_smoke.py``'s, with fixed64 fields added.
Nothing here imports the program: the message class is a stand-in with the
attributes a protobuf descriptor has.
"""

from __future__ import annotations

import numpy as np

# descriptor.proto's type and label numbers
TYPE_DOUBLE, TYPE_INT64, TYPE_INT32, TYPE_STRING = 1, 3, 5, 9
LABEL_REQUIRED = 2
TYPES = {"double": TYPE_DOUBLE, "int64": TYPE_INT64, "int32": TYPE_INT32,
         "string": TYPE_STRING}
DTYPES = {"double": np.float64, "int64": np.int64, "int32": np.int32}


class WireField:
    """A protobuf field descriptor stand-in."""

    def __init__(self, name: str, number: int, ftype: int, label: int) -> None:
        self.name, self.number, self.type, self.label = name, number, ftype, label
        self.message_type = None
        self.enum_type = None


class WireFile:
    syntax = "proto2"


class WireDescriptor:
    def __init__(self, name: str, fields: list) -> None:
        self.name, self.fields, self.file = name, fields, WireFile()


def message_class(name: str, schema: list):
    """A message class stand-in: its ``DESCRIPTOR`` and a ``FromString``
    that refuses to parse (records take the wire path)."""

    class Message:
        DESCRIPTOR = WireDescriptor(name, [
            WireField(f["name"], f["number"], TYPES[f["type"]], LABEL_REQUIRED)
            for f in schema])

        @classmethod
        def FromString(cls, data):
            raise NotImplementedError(f"{name} is a descriptor stand-in")

    Message.__name__ = Message.__qualname__ = name
    return Message


def varints(v: np.ndarray) -> tuple:
    """Base-128 varints of int64 values (two's complement, as protobuf
    writes int64): an (n, w) byte matrix, w the longest varint among them,
    and each value's length."""
    u = np.asarray(v, np.int64).astype(np.uint64)
    top = int(u.max()) if len(u) else 0
    width = max(1, -(-top.bit_length() // 7))
    shifts = np.arange(width, dtype=np.uint64) * np.uint64(7)
    rest = u[:, None] >> shifts  # the value above each byte
    lens = np.maximum((rest != 0).sum(1), 1)
    more = np.arange(width) < (lens - 1)[:, None]
    body = (rest & np.uint64(0x7F)).astype(np.uint8)
    return body | (more * 0x80).astype(np.uint8), lens


def tag(number: int, wire_type: int) -> np.ndarray:
    """A field's key as varint bytes."""
    body, lens = varints(np.array([number << 3 | wire_type]))
    return body[0, :lens[0]]


def encode_flat(columns: list) -> tuple:
    """Serialize flat messages of required fields in the order given:
    ``columns`` holds (field number, values) with int64 values for varint
    fields, float64 values for fixed64 fields and a list of bytes for
    string fields.  Returns the records' concatenation and the (n + 1)
    offsets of their boundaries."""
    blocks, masks = [], []
    n = len(columns[0][1])
    for number, values in columns:
        if isinstance(values, np.ndarray) and values.dtype == np.float64:
            key = tag(number, 1)
            blocks += [np.broadcast_to(key, (n, len(key))),
                       values.astype("<f8").view(np.uint8).reshape(n, 8)]
            masks += [np.ones((n, len(key) + 8), bool)]
        elif isinstance(values, np.ndarray):
            key = tag(number, 0)
            body, lens = varints(values)
            blocks += [np.broadcast_to(key, (n, len(key))), body]
            masks += [np.ones((n, len(key)), bool),
                      np.arange(body.shape[1]) < lens[:, None]]
        else:
            key = tag(number, 2)
            sizes = np.fromiter(map(len, values), np.int64, n)
            head, head_lens = varints(sizes)
            width = int(sizes.max())
            data = np.zeros((n, width), np.uint8)
            data_mask = np.arange(width) < sizes[:, None]
            data[data_mask] = np.frombuffer(b"".join(values), np.uint8)
            blocks += [np.broadcast_to(key, (n, len(key))), head, data]
            masks += [np.ones((n, len(key)), bool),
                      np.arange(head.shape[1]) < head_lens[:, None], data_mask]
    mask = np.concatenate(masks, 1)
    buf = np.concatenate(blocks, 1)[mask].tobytes()
    offsets = np.concatenate([[0], np.cumsum(mask.sum(1))]).astype(np.int64)
    return buf, offsets


def draw_columns(schema: list, n: int, rng) -> dict:
    """The values of ``n`` records, field by field in schema order: numpy
    arrays for numbers, arrays of dictionary ids for strings (with the
    dictionary under ``"<name>.dict"``)."""
    cols = {}
    for f in schema:
        if f["draw"] == "int":
            v = rng.integers(f["low"], f["high"], n) * f.get("scale", 1)
            cols[f["name"]] = v.astype(DTYPES[f["type"]])
        elif f["draw"] == "ratio":
            cols[f["name"]] = rng.integers(f["low"], f["high"], n) / float(f["divisor"])
        elif f["draw"] == "choice":
            cols[f["name"]] = rng.integers(0, f["count"], n).astype(np.int32)
            cols[f["name"] + ".dict"] = [
                (f["format"] % j).encode() for j in range(f["count"])]
        else:
            raise ValueError(f"unknown draw {f['draw']!r} for {f['name']}")
    return cols


def serialize(schema: list, cols: dict, lo: int = 0, hi: int | None = None) -> tuple:
    """Records ``lo:hi`` of ``cols`` on the wire: (buffer, offsets)."""
    hi = len(cols[schema[0]["name"]]) if hi is None else hi
    wire = []
    for f in schema:
        v = cols[f["name"]][lo:hi]
        if f["type"] == "string":
            d = cols[f["name"] + ".dict"]
            wire.append((f["number"], [d[j] for j in v.tolist()]))
        elif f["type"] == "double":
            wire.append((f["number"], v))
        else:
            wire.append((f["number"], v.astype(np.int64)))
    return encode_flat(wire)


class Pool:
    """``n`` records drawn from a seed: their columns (``cols``) and their
    serialized forms, one after another in ``blob``, record ``i`` at
    ``blob[offs[i]:offs[i + 1]]``."""

    def __init__(self, schema: list, n: int, seed: int, partitions: int,
                 block: int = 65536) -> None:
        self.schema, self.n, self.partitions = schema, n, partitions
        self.stride = n // partitions
        self.cols = draw_columns(schema, n, np.random.default_rng(seed))
        bufs, offs, base = [], [np.zeros(1, np.int64)], 0
        for lo in range(0, n, block):
            buf, o = serialize(schema, self.cols, lo, min(n, lo + block))
            bufs.append(buf)
            offs.append(o[1:] + base)
            base += len(buf)
        self.blob = b"".join(bufs)
        self.offs = np.concatenate(offs)

    @property
    def payloads(self) -> list:
        """Every record's serialized form, one ``bytes`` each."""
        o = self.offs.tolist()
        return [self.blob[a:b] for a, b in zip(o[:-1], o[1:])]

    def index(self, partition, offset):
        """The pool index of the record at ``offset`` of ``partition``."""
        return (np.asarray(offset, np.int64)
                + np.asarray(partition, np.int64) * self.stride) % self.n

    def span(self, partition: int, first: int, count: int) -> tuple:
        """Offsets ``first ..`` of ``partition``, as many of ``count`` as lie
        in one stretch of the pool: (pool index of the first, how many)."""
        j = int(self.index(partition, first))
        return j, min(count, self.n - j)

    def records(self, partition: int, first: int, count: int) -> list:
        """The payloads of offsets ``first .. first + count`` of
        ``partition``, in order."""
        out, o = [], first
        while count > 0:
            j, take = self.span(partition, o, count)
            a = self.offs[j:j + take + 1].tolist()
            out += [self.blob[x:y] for x, y in zip(a[:-1], a[1:])]
            o += take
            count -= take
        return out

    def counts(self, ends) -> np.ndarray:
        """How often each pool record occurs among the offsets
        ``[0, ends[p])`` of every partition ``p``."""
        diff = np.zeros(self.n + 1, np.int64)
        for p, end in enumerate(ends):
            full, rest = divmod(int(end), self.n)
            diff[0] += full
            diff[self.n] -= full
            j = int(self.index(p, 0))
            a, b = j, j + rest
            if b <= self.n:
                diff[a] += 1
                diff[b] -= 1
            else:
                diff[a] += 1
                diff[self.n] -= 1
                diff[0] += 1
                diff[b - self.n] -= 1
        return np.cumsum(diff[:-1])


def message(config: dict):
    return message_class(config["message"], config["schema"])


def make_pool(config: dict, seed: int) -> Pool:
    return Pool(config["schema"], config["pool_records"], seed,
                config["partitions"])
