"""The port's proto bridge and wire shredders (``kpw_tpu_torch.models``,
``kpw_tpu_torch/native/src/{shred,shred_nested,pyshred}.cc``) against the
JAX package's on the same numpy-seeded messages, exactly.

Each case runs three routes in both packages — the wire path over a list
of payloads (the flat decoder for flat schemas, the fused nested decoder
otherwise), the same over one contiguous buffer (the batch-ingest
handoff), the nested decoder forced on flat schemas, and the Python
Dremel visitor over parsed messages — and compares schema, values and
rep/def levels.  A malformed payload must raise ``WireShredError`` at the
same record index in both.  The smoke run's descriptor stand-ins give the
same schema and batches as the real classes, and its hand-written wire
encoder the same bytes as ``SerializeToString``.
"""

import os
import sys

import numpy as np
import pytest

from kpw_tpu.models import proto_bridge as JB
from kpw_tpu_torch.models import proto_bridge as PB
from proto_helpers import _F, _field, build_classes, nested_message_classes, \
    sample_message_class

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


def fields_of(f):
    return (f.name, f.repetition, f.physical_type, f.converted_type,
            f.type_length, f.field_id, [fields_of(c) for c in f.children])


def as_plain(batch):
    """A ColumnBatch as plain Python data: per column, its path, values
    (bytes for byte arrays; dtype and list otherwise) and levels."""
    out = [batch.num_rows]
    for c in batch.chunks:
        vals = c.values
        if isinstance(vals, np.ndarray):
            vals = (str(vals.dtype), vals.tolist())
        else:
            vals = [bytes(v) for v in vals]
        levels = [None if x is None else np.asarray(x).astype(np.int64).tolist()
                  for x in (c.def_levels, c.rep_levels)]
        out.append((c.column.path, vals, levels))
    return out


# -- the messages ----------------------------------------------------------

def sample_msgs(rng, n):
    cls = sample_message_class()
    msgs = []
    for i in range(n):
        m = cls(query=f"q-{int(rng.integers(0, 50))}", timestamp=int(rng.integers(0, 1 << 40)))
        if rng.random() < 0.6:
            m.page_number = int(rng.integers(-5, 100))
        if rng.random() < 0.3:
            m.result_per_page = int(rng.integers(0, 1 << 31))
        msgs.append(m)
    return cls, msgs


def replay_class():
    fields = ([_field(f"i{k}", k + 1, _F.TYPE_INT64, _F.LABEL_REQUIRED)
               for k in range(8)]
              + [_field(f"s{k}", k + 9, _F.TYPE_STRING, _F.LABEL_REQUIRED)
                 for k in range(4)])
    return build_classes("replay", {"Replay": fields})["Replay"]


def replay_msgs(rng, n):
    """BASELINE config 1's streaming record (the cfg6 replay shape)."""
    cls = replay_class()
    ints = rng.integers(0, 1_000_000, (n, 8))
    sidx = rng.integers(0, 100, (n, 4))
    msgs = []
    for r in range(n):
        m = cls()
        for k in range(8):
            setattr(m, f"i{k}", int(ints[r, k]))
        for k in range(4):
            setattr(m, f"s{k}", f"cat_{int(sidx[r, k]):03d}")
        msgs.append(m)
    return cls, msgs


def order_msgs(rng, n):
    """BASELINE config 5's Order: repeated items with optional qty and
    repeated tags, an optional note."""
    cls = nested_message_classes()
    msgs = []
    for _ in range(n):
        o = cls(order_id=int(rng.integers(0, 1 << 40)))
        for _ in range(int(rng.integers(0, 4))):
            it = o.items.add()
            it.sku = f"sku{int(rng.integers(0, 30))}"
            if rng.random() < 0.7:
                it.qty = int(rng.integers(1, 99))
            for _ in range(int(rng.integers(0, 3))):
                it.tags.append(f"t{int(rng.integers(0, 5))}")
        if rng.random() < 0.3:
            o.note = f"n{int(rng.integers(0, 7))}"
        msgs.append(o)
    return cls, msgs


def proto3_msgs(rng, n):
    """Every wire-shreddable scalar type under proto3 (no presence, UTF-8
    checked strings), defaults left out of the wire."""
    types = [("i64", _F.TYPE_INT64), ("u64", _F.TYPE_UINT64), ("s64", _F.TYPE_SINT64),
             ("f64", _F.TYPE_FIXED64), ("sf64", _F.TYPE_SFIXED64),
             ("i32", _F.TYPE_INT32), ("u32", _F.TYPE_UINT32), ("s32", _F.TYPE_SINT32),
             ("f32", _F.TYPE_FIXED32), ("sf32", _F.TYPE_SFIXED32),
             ("b", _F.TYPE_BOOL), ("d", _F.TYPE_DOUBLE), ("fl", _F.TYPE_FLOAT),
             ("s", _F.TYPE_STRING), ("by", _F.TYPE_BYTES)]
    cls = build_classes("p3", {"P3": [_field(name, i + 1, t)
                                      for i, (name, t) in enumerate(types)]},
                        syntax="proto3")["P3"]
    msgs = []
    for i in range(n):
        m = cls()
        if rng.random() < 0.8:
            m.i64 = int(rng.integers(-1 << 62, 1 << 62))
            m.u64 = int(rng.integers(0, 1 << 63)) * 2 + int(rng.integers(0, 2))
            m.s64 = int(rng.integers(-1 << 62, 1 << 62))
            m.f64 = int(rng.integers(0, 1 << 63))
            m.sf64 = int(rng.integers(-1 << 62, 1 << 62))
            m.i32 = int(rng.integers(-1 << 31, 1 << 31))
            m.u32 = int(rng.integers(0, 1 << 32))
            m.s32 = int(rng.integers(-1 << 31, 1 << 31))
            m.f32 = int(rng.integers(0, 1 << 32))
            m.sf32 = int(rng.integers(-1 << 31, 1 << 31))
            m.b = bool(rng.integers(0, 2))
            m.d = float(rng.normal())
            m.fl = float(np.float32(rng.normal()))
            m.s = f"héllo-{i}"
            m.by = rng.bytes(int(rng.integers(0, 9)))
        msgs.append(m)
    return cls, msgs


def enum_msgs(rng, n):
    """A proto2 closed enum (unknown values dropped) and a repeated one."""
    enums = {"Status": [("OK", 1), ("ERR", 2), ("RETRY", 7)]}
    cls = build_classes("en", {"M": [
        _field("st", 1, _F.TYPE_ENUM, type_name=".kpwtest.Status"),
        _field("sts", 2, _F.TYPE_ENUM, _F.LABEL_REPEATED, ".kpwtest.Status"),
        _field("id", 3, _F.TYPE_INT64, _F.LABEL_REQUIRED)]}, enums=enums)["M"]
    msgs = []
    for i in range(n):
        m = cls(id=i)
        if rng.random() < 0.7:
            m.st = int(rng.choice([1, 2, 7]))
        m.sts.extend(int(v) for v in rng.choice([1, 2, 7], int(rng.integers(0, 3))))
        msgs.append(m)
    return cls, msgs


def open_enum_msgs(rng, n):
    """A proto3 open enum: unknown numbers survive as UNKNOWN_ENUM_{v}."""
    enums = {"Color": [("COLOR_UNSET", 0), ("RED", 1), ("BLUE", 5)]}
    cls = build_classes("en3", {"M": [
        _field("c", 1, _F.TYPE_ENUM, type_name=".kpwtest.Color"),
        _field("v", 2, _F.TYPE_INT64)]}, syntax="proto3", enums=enums)["M"]
    return cls, [cls(c=int(rng.choice([0, 1, 5, 9])), v=i) for i in range(n)]


CASES = {"sample": sample_msgs, "replay": replay_msgs, "order": order_msgs,
         "proto3": proto3_msgs, "enum": enum_msgs, "open_enum": open_enum_msgs}


def unknown_field_payloads(msgs):
    """Each payload with unknown fields of every wire type around it."""
    unk = (bytes([0xF8, 0x3E, 0x07])                   # field 999 varint
           + bytes([0xF9, 0x3E]) + b"\1" * 8           # field 999 fixed64
           + bytes([0xFA, 0x3E, 0x03]) + b"abc"        # field 999 bytes
           + bytes([0xFD, 0x3E]) + b"\2" * 4)          # field 999 fixed32
    return [unk + m.SerializeToString() + unk for m in msgs]


def routes(bridge, cls, payloads):
    """Every route of one package's columnarizer over ``payloads``."""
    out = {}
    col = bridge.ProtoColumnarizer(cls)
    assert col.wire_capable
    out["wire"] = as_plain(col.columnarize_payloads(payloads))
    offsets = np.concatenate([[0], np.cumsum([len(p) for p in payloads])])
    out["buffer"] = as_plain(col.columnarize_buffer(b"".join(payloads), offsets))
    nested = bridge.ProtoColumnarizer(cls)
    assert nested.wire_capable
    nested._wire = None  # the nested decoder on every schema
    assert nested.wire_capable and nested._nested is not None
    out["nested"] = as_plain(nested.columnarize_payloads(payloads))
    out["python"] = as_plain(col.columnarize([cls.FromString(p) for p in payloads]))
    return out


@pytest.mark.parametrize("unknown", [False, True], ids=["plain", "unknown_fields"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_columnarizer_equals_jax(case, unknown):
    cls, msgs = CASES[case](np.random.default_rng(7), 300)
    payloads = (unknown_field_payloads(msgs) if unknown
                else [m.SerializeToString() for m in msgs])
    assert fields_of(PB.proto_to_schema(cls).root) == \
        fields_of(JB.proto_to_schema(cls).root)
    got, want = routes(PB, cls, payloads), routes(JB, cls, payloads)
    assert got == want
    # every route of a package gives the same batch
    assert got["wire"] == got["buffer"] == got["nested"] == got["python"]


@pytest.mark.parametrize("route", ["wire", "nested"])
@pytest.mark.parametrize("case", ["sample", "replay", "order"])
def test_malformed_payload_raises_at_the_same_record(case, route):
    cls, msgs = CASES[case](np.random.default_rng(3), 40)
    payloads = [m.SerializeToString() for m in msgs]
    payloads[17] = payloads[17][:-1]  # truncated last field
    payloads[29] = b"\xff\xff\xff"
    for bridge in (PB, JB):
        col = bridge.ProtoColumnarizer(cls)
        assert col.wire_capable
        if route == "nested":
            col._wire = None
            assert col.wire_capable
        with pytest.raises(bridge.WireShredError) as err:
            col.columnarize_payloads(payloads)
        assert err.value.record_index == 17


def test_nested_has_one_route():
    """The port keeps the fused nested route only: no switch, and the
    nested plan needs the shred extension."""
    import inspect

    src = inspect.getsource(PB)
    assert "KPW_NESTED_FUSED" not in src and "os.environ" not in src


def test_stand_in_descriptors_give_the_same_schema_and_batches():
    """chip_smoke's descriptor stand-ins (no protobuf) give the port the
    same schema and wire batches as the real classes."""
    rng = np.random.default_rng(11)
    for stand_in, (cls, msgs) in ((chip_smoke.replay_class(), replay_msgs(rng, 200)),
                                  (chip_smoke.order_class(), order_msgs(rng, 200))):
        assert fields_of(PB.proto_to_schema(stand_in).root) == \
            fields_of(JB.proto_to_schema(cls).root)
        payloads = [m.SerializeToString() for m in msgs]
        got = PB.ProtoColumnarizer(stand_in).columnarize_payloads(payloads)
        want = JB.ProtoColumnarizer(cls).columnarize_payloads(payloads)
        assert as_plain(got) == as_plain(want)


def test_wire_encoder_equals_serialize_to_string():
    n = 500
    cls = replay_class()
    rng = np.random.default_rng(6)  # replay_payloads draws in this order
    ints = rng.integers(0, 1_000_000, (n, 8))
    sidx = rng.integers(0, 100, (n, 4))
    want = []
    for r in range(n):
        m = cls()
        for k in range(8):
            setattr(m, f"i{k}", int(ints[r, k]))
        for k in range(4):
            setattr(m, f"s{k}", f"cat_{int(sidx[r, k]):03d}")
        want.append(m.SerializeToString())
    assert chip_smoke.replay_payloads(n) == want
    # negative and wide varints too
    v = np.array([0, 1, 127, 128, 16383, 16384, -1, -(1 << 63), (1 << 63) - 1], np.int64)
    cls1 = build_classes("one", {"One": [
        _field("v", 1, _F.TYPE_INT64, _F.LABEL_REQUIRED),
        _field("s", 2, _F.TYPE_STRING, _F.LABEL_REQUIRED)]})["One"]
    strs = [b"x" * k for k in (0, 1, 127, 128, 300, 2, 3, 4, 5)]
    want = [cls1(v=int(a), s=s.decode()).SerializeToString() for a, s in zip(v, strs)]
    assert chip_smoke.encode_flat([(1, v), (2, strs)]) == want
    # config 5's orders: items with a sku and a qty, no tags, no note
    order_id, n_items, sku, qty = chip_smoke.order_rows(np.random.default_rng(2), 300)
    Order = nested_message_classes()
    want, at = [], 0
    for oid, k in zip(order_id, n_items):
        o = Order(order_id=int(oid))
        for _ in range(int(k)):
            it = o.items.add()
            it.sku = sku[at].decode()
            it.qty = int(qty[at])
            at += 1
        want.append(o.SerializeToString())
    assert chip_smoke.order_payloads(order_id, n_items, sku, qty) == want
