"""protobuf Message class -> parquet schema + Dremel columnarizer.

The reference's data model is "any com.google.protobuf.Message subclass"
(KafkaProtoParquetWriter.java:671-684) shredded by parquet-protobuf's
ProtoWriteSupport (ParquetFile.java:97-99).  Here the shredding is batched:
a list of parsed messages becomes one ColumnBatch (per-leaf value arrays +
repetition/definition levels), which the pluggable EncoderBackend turns into
pages — the boundary where the device path takes over.

The descriptor is read by duck typing: ``desc.fields``, ``desc.file`` and,
per field, ``type``, ``label``, ``number``, ``name``, ``message_type`` and
``enum_type`` (``has_presence``, ``fields_by_name`` and
``values_by_number`` are used where the descriptor has them and derived
otherwise).  The type and label numbers are ``descriptor.proto``'s own
(:class:`FD`).  So the wire path — serialized records shredded by the
native decoders, never a message object — runs without
``google.protobuf``; it is imported only where a message is parsed (the
caller's class) or where ``_file_syntax`` must serialize a descriptor that
hides its syntax.
"""

from __future__ import annotations

import numpy as np

from ..core.schema import (
    ColumnDescriptor,
    ConvertedType,
    Field,
    PhysicalType,
    Repetition,
    Schema,
)
from ..core.bytecol import ByteColumn
from ..core.writer import ColumnBatch
from ..core.pages import ColumnChunkData


class FD:
    """``FieldDescriptor``'s type and label numbers, as ``descriptor.proto``
    fixes them."""

    TYPE_DOUBLE, TYPE_FLOAT, TYPE_INT64, TYPE_UINT64 = 1, 2, 3, 4
    TYPE_INT32, TYPE_FIXED64, TYPE_FIXED32, TYPE_BOOL = 5, 6, 7, 8
    TYPE_STRING, TYPE_GROUP, TYPE_MESSAGE, TYPE_BYTES = 9, 10, 11, 12
    TYPE_UINT32, TYPE_ENUM, TYPE_SFIXED32, TYPE_SFIXED64 = 13, 14, 15, 16
    TYPE_SINT32, TYPE_SINT64 = 17, 18
    LABEL_OPTIONAL, LABEL_REQUIRED, LABEL_REPEATED = 1, 2, 3


# proto field type -> (physical type, converted type)
_SCALAR_MAP = {
    FD.TYPE_INT64: (PhysicalType.INT64, None),
    FD.TYPE_SINT64: (PhysicalType.INT64, None),
    FD.TYPE_SFIXED64: (PhysicalType.INT64, None),
    FD.TYPE_UINT64: (PhysicalType.INT64, ConvertedType.UINT_64),
    FD.TYPE_FIXED64: (PhysicalType.INT64, ConvertedType.UINT_64),
    FD.TYPE_INT32: (PhysicalType.INT32, None),
    FD.TYPE_SINT32: (PhysicalType.INT32, None),
    FD.TYPE_SFIXED32: (PhysicalType.INT32, None),
    FD.TYPE_UINT32: (PhysicalType.INT32, ConvertedType.UINT_32),
    FD.TYPE_FIXED32: (PhysicalType.INT32, ConvertedType.UINT_32),
    FD.TYPE_BOOL: (PhysicalType.BOOLEAN, None),
    FD.TYPE_FLOAT: (PhysicalType.FLOAT, None),
    FD.TYPE_DOUBLE: (PhysicalType.DOUBLE, None),
    FD.TYPE_STRING: (PhysicalType.BYTE_ARRAY, ConvertedType.UTF8),
    FD.TYPE_BYTES: (PhysicalType.BYTE_ARRAY, None),
    FD.TYPE_ENUM: (PhysicalType.BYTE_ARRAY, ConvertedType.ENUM),
}

from ..core.schema import NUMPY_DTYPES as _NUMPY_DTYPES  # noqa: E402


def _is_repeated(fd) -> bool:
    rep = getattr(fd, "is_repeated", None)
    return fd.label == FD.LABEL_REPEATED if rep is None else rep


def _is_required(fd) -> bool:
    req = getattr(fd, "is_required", None)
    return fd.label == FD.LABEL_REQUIRED if req is None else req


def _has_presence(fd) -> bool:
    """Whether a singular field tracks presence: the descriptor's own answer
    where it has one; otherwise every proto2 field, and a proto3 message
    field or oneof member."""
    presence = getattr(fd, "has_presence", None)
    if presence is not None:
        return presence
    if fd.type == FD.TYPE_MESSAGE or getattr(fd, "containing_oneof", None):
        return True
    return _file_syntax(getattr(fd, "file", None)) == "proto2"


def _fields_by_name(desc) -> dict:
    by_name = getattr(desc, "fields_by_name", None)
    return {fd.name: fd for fd in desc.fields} if by_name is None else by_name


def _values_by_number(enum_type) -> dict:
    by_number = getattr(enum_type, "values_by_number", None)
    if by_number is None:
        by_number = {v.number: v for v in enum_type.values}
    return by_number


def _repetition_for(fd) -> int:
    if _is_repeated(fd):
        return Repetition.REPEATED
    if _is_required(fd):
        return Repetition.REQUIRED
    # proto3 no-presence scalars always carry a value (the default), so they
    # map to REQUIRED; explicit-presence fields map to OPTIONAL
    if not _has_presence(fd):
        return Repetition.REQUIRED
    return Repetition.OPTIONAL


def _field_from_descriptor(fd) -> Field:
    rep = _repetition_for(fd)
    if fd.type == FD.TYPE_MESSAGE:
        children = [_field_from_descriptor(c) for c in fd.message_type.fields]
        return Field(name=fd.name, repetition=rep, children=children,
                     field_id=fd.number)
    if fd.type == FD.TYPE_GROUP:
        raise NotImplementedError("proto1 groups are not supported")
    phys, conv = _SCALAR_MAP[fd.type]
    return Field(name=fd.name, repetition=rep, physical_type=phys,
                 converted_type=conv, field_id=fd.number)


def proto_to_schema(msg_class) -> Schema:
    """Build the parquet schema for a protobuf message class."""
    desc = msg_class.DESCRIPTOR
    return Schema([_field_from_descriptor(fd) for fd in desc.fields],
                  name=desc.name)


def _file_syntax(file_desc) -> str:
    """'proto2' | 'proto3' (upb FileDescriptor hides .syntax; recover it
    from the serialized FileDescriptorProto).  Drives UTF-8 validation
    parity: proto3 parsers reject invalid UTF-8 in strings, proto2 parsers
    pass the raw bytes through.  A descriptor without a file reads as
    proto2, as one whose syntax cannot be recovered does."""
    syntax = getattr(file_desc, "syntax", None)
    if syntax:
        return syntax
    if file_desc is None:
        return "proto2"
    try:
        from google.protobuf import descriptor_pb2

        fdp = descriptor_pb2.FileDescriptorProto()
        file_desc.CopyToProto(fdp)
        return fdp.syntax or "proto2"
    except Exception:
        return "proto2"


class WireShredError(Exception):
    """The native wire-format shredder could not prove a record clean; the
    caller must re-parse the batch in Python (exact per-record semantics,
    including the poison-pill policies)."""

    def __init__(self, record_index: int) -> None:
        super().__init__(f"wire shred failed at record {record_index}")
        self.record_index = record_index


# field kinds — mirrored in kpw_tpu_torch/native/src/shred.cc enum Kind
_K_VARINT64, _K_VARINT32, _K_SINT64, _K_SINT32 = 0, 1, 2, 3
_K_FIXED64, _K_FIXED32, _K_BOOL, _K_SPAN, _K_SPAN_UTF8 = 4, 5, 6, 7, 8
_F_REQUIRED = 1

# proto type -> (kind, numpy slot dtype or None for spans)
_WIRE_KINDS = {
    FD.TYPE_INT64: (_K_VARINT64, np.int64),
    FD.TYPE_UINT64: (_K_VARINT64, np.int64),   # raw bits = UINT_64 wrap
    FD.TYPE_SINT64: (_K_SINT64, np.int64),
    FD.TYPE_FIXED64: (_K_FIXED64, np.int64),
    FD.TYPE_SFIXED64: (_K_FIXED64, np.int64),
    FD.TYPE_INT32: (_K_VARINT32, np.int32),
    FD.TYPE_UINT32: (_K_VARINT32, np.int32),   # raw bits = UINT_32 wrap
    FD.TYPE_SINT32: (_K_SINT32, np.int32),
    FD.TYPE_FIXED32: (_K_FIXED32, np.int32),
    FD.TYPE_SFIXED32: (_K_FIXED32, np.int32),
    FD.TYPE_BOOL: (_K_BOOL, np.bool_),
    FD.TYPE_DOUBLE: (_K_FIXED64, np.float64),
    FD.TYPE_FLOAT: (_K_FIXED32, np.float32),
    FD.TYPE_STRING: (_K_SPAN, None),
    FD.TYPE_BYTES: (_K_SPAN, None),
    # TYPE_ENUM deliberately absent: proto2 closed-enum semantics (unknown
    # values land in unknown fields) need the Python path
}


class _WirePlan:
    """Precomputed arrays driving kpw_proto_shred for a flat schema."""

    __slots__ = ("fnum", "kinds", "flags", "dtypes", "optional", "_cont")

    def __init__(self, fnum, kinds, flags, dtypes, optional) -> None:
        self.fnum = fnum          # uint32 (n_fields,)
        self.kinds = kinds        # uint8
        self.flags = flags        # uint8
        self.dtypes = dtypes      # numpy dtype or None (span) per field
        self.optional = optional  # bool per field (needs presence/def levels)
        self._cont = None         # cached (fnum, kinds, flags) buffer forms
        #                           for the C-extension shred_flat_buf entry


# nested-plan kinds/flags — mirrored in kpw_tpu_torch/native/src/shred_nested.cc
_K_MESSAGE, _K_ENUM = 9, 10
_FN_REQUIRED, _FN_REPEATED, _FN_DEF_INC = 1, 2, 4
_FN_EMIT_DEFAULT, _FN_CLOSED_ENUM = 8, 16


class _NestedPlan:
    """Node-table arrays driving kpw_proto_shred_nested: the schema tree
    flattened breadth-first (children contiguous), per-message-node direct
    field-number tables, closed-enum membership tables, and per-message
    descendant-leaf lists for absence emission."""

    __slots__ = ("n_nodes", "n_leaves", "fnum", "kind", "flags",
                 "child_begin", "child_end", "leaf_idx", "ftab", "ftab_off",
                 "max_fn", "enum_vals", "enum_off", "enum_len",
                 "null_leaves", "null_off", "null_len",
                 "leaf_kinds", "leaf_dtypes", "enum_names", "_cont")

    _TAB_NAMES = ("child_begin", "child_end", "leaf_idx", "ftab",
                  "ftab_off", "max_fn", "enum_vals", "enum_off", "enum_len",
                  "null_leaves", "null_off", "null_len")

    def cont(self):
        """Cached contiguous buffer forms for the C-extension fused entry
        (shred_nested_buf): (fnum u32, kind bytes, flags bytes, 12 int32
        table buffers) — built once per columnarizer, like _WirePlan._cont."""
        c = getattr(self, "_cont", None)
        if c is None:
            c = self._cont = (
                np.ascontiguousarray(self.fnum, np.uint32),
                bytes(np.ascontiguousarray(self.kind, np.uint8)),
                bytes(np.ascontiguousarray(self.flags, np.uint8)),
                tuple(np.ascontiguousarray(getattr(self, name), np.int32)
                      for name in self._TAB_NAMES))
        return c


class _LeafBuffer:
    __slots__ = ("values", "defs", "reps")

    def __init__(self) -> None:
        self.values: list = []
        self.defs: list[int] = []
        self.reps: list[int] = []


class ProtoColumnarizer:
    """Shreds batches of parsed proto messages into a ColumnBatch.

    Implements the Dremel record-shredding algorithm over the proto object
    tree; one Python pass per record (the CPU ingest cost the TPU encode path
    amortizes behind — SURVEY.md §2.4 pipeline parallel analog).
    """

    def __init__(self, msg_class, schema: Schema | None = None) -> None:
        self.msg_class = msg_class
        self.schema = schema or proto_to_schema(msg_class)
        # plan: walk descriptor parallel to schema columns, precomputing
        # (leaf order, per-field presence semantics)
        self._leaf_index: dict[tuple[str, ...], int] = {
            c.path: i for i, c in enumerate(self.schema.columns)
        }

    # -- shredding ---------------------------------------------------------
    def _flat_plan(self):
        """Per-column (field descriptor, optional?, converter) when the
        message is flat (top-level scalar leaves only) — the common case
        (reference test schema, BASELINE flat configs), worth a tight loop
        instead of the generic Dremel visitor (~2.5x shredding throughput)."""
        desc = self.msg_class.DESCRIPTOR
        if any(_is_repeated(fd) or fd.type == FD.TYPE_MESSAGE
               for fd in desc.fields):
            return None
        plan = []
        for col in self.schema.columns:
            fd = _fields_by_name(desc)[col.path[0]]
            if fd.type == FD.TYPE_STRING:
                # proto2 runtimes surface invalid-UTF-8 strings as bytes;
                # pass them through unchanged (same output as the wire path)
                conv = lambda v: v.encode("utf-8") if isinstance(v, str) else bytes(v)
            elif fd.type == FD.TYPE_ENUM:
                values_by_number = _values_by_number(fd.enum_type)

                def conv(v, _vb=values_by_number):
                    ev = _vb.get(v)
                    return (ev.name if ev is not None
                            else f"UNKNOWN_ENUM_{v}").encode("ascii")
            elif fd.type in (FD.TYPE_UINT64, FD.TYPE_FIXED64):
                conv = lambda v: v - (1 << 64) if v >= 1 << 63 else v
            elif fd.type in (FD.TYPE_UINT32, FD.TYPE_FIXED32):
                conv = lambda v: v - (1 << 32) if v >= 1 << 31 else v
            else:
                conv = None
            plan.append((fd, _repetition_for(fd) == Repetition.OPTIONAL, conv))
        return plan

    def _columnarize_flat(self, records, plan) -> ColumnBatch:
        n = len(records)
        chunks = []
        for col, (fd, optional, conv) in zip(self.schema.columns, plan):
            name = fd.name
            if optional:
                defs = np.empty(n, np.int32)
                values = []
                for i, m in enumerate(records):
                    if m.HasField(name):
                        defs[i] = 1
                        values.append(getattr(m, name))
                    else:
                        defs[i] = 0
            else:
                defs = None
                values = [getattr(m, name) for m in records]
            if conv is not None:
                values = [conv(v) for v in values]
            chunks.append(ColumnChunkData(
                col, self._finalize_values(col, values), defs, None, n))
        return ColumnBatch(chunks, n)

    # -- native wire-format fast path --------------------------------------
    def _wire_plan(self):
        """Build (once) the kpw_proto_shred plan, or None when the schema or
        environment disqualifies the fast path (non-flat schema, enum
        fields, native lib unavailable)."""
        desc = self.msg_class.DESCRIPTOR
        if any(_is_repeated(fd) or fd.type in (FD.TYPE_MESSAGE, FD.TYPE_GROUP,
                                               FD.TYPE_ENUM)
               for fd in desc.fields):
            return None
        from ..native import lib as _native_lib

        if _native_lib() is None:
            return None
        syntax = _file_syntax(desc.file)
        if syntax not in ("proto2", "proto3"):
            # editions (and anything newer): per-field UTF-8/presence
            # semantics this plan does not model — Python path only
            return None
        fnum, kinds, flags, dtypes, optional = [], [], [], [], []
        by_name = _fields_by_name(desc)
        for col in self.schema.columns:
            fd = by_name[col.path[0]]
            kd = _WIRE_KINDS.get(fd.type)
            if kd is None:
                return None
            if fd.number > 65535:
                # beyond the C++ decoder's direct-address field table;
                # legal in proto (up to 2^29-1) but rare — Python path
                return None
            kind, dtype = kd
            if kind == _K_SPAN and fd.type == FD.TYPE_STRING and syntax == "proto3":
                kind = _K_SPAN_UTF8  # proto3 parsers reject invalid UTF-8
            fnum.append(fd.number)
            kinds.append(kind)
            flags.append(_F_REQUIRED if _is_required(fd) else 0)
            dtypes.append(dtype)
            optional.append(_repetition_for(fd) == Repetition.OPTIONAL)
        return _WirePlan(np.asarray(fnum, np.uint32),
                         np.asarray(kinds, np.uint8),
                         np.asarray(flags, np.uint8),
                         dtypes, optional)

    def _nested_plan(self):
        """Build (once) the kpw_proto_shred_nested node tables, or None when
        the schema or environment disqualifies the nested fast path.  Covers
        everything the flat plan covers plus repeated fields, nested /
        repeated submessages, and enums — the reference's full Message
        surface (KafkaProtoParquetWriter.java:671-684 accepts any subclass;
        ParquetFile.java:97-99 shreds it through ProtoWriteSupport).  It
        runs through the shred extension's fused entries alone, so it needs
        that extension as well as the library."""
        desc = self.msg_class.DESCRIPTOR
        from ..native import lib as _native_lib, pyshred as _pyshred

        if _native_lib() is None or _pyshred() is None:
            return None
        if any(c.max_def > 254 or c.max_rep > 254
               for c in self.schema.columns):
            return None  # uint8 level outputs (no real schema nests so deep)

        def syntax_of(fd_or_desc):
            f = getattr(fd_or_desc, "file", None)
            return _file_syntax(f if f is not None else desc.file)

        fnum, kind, flags = [0], [_K_MESSAGE], [0]
        child_begin, child_end, leaf_idx = [0], [0], [-1]
        node_desc = {0: desc}
        node_queue = [0]
        enum_tables: dict[int, list[int]] = {}  # node -> sorted numbers
        enum_names: dict[int, dict[int, bytes]] = {}  # leaf -> num -> name
        leaf_kinds = [None] * len(self.schema.columns)
        leaf_dtypes = [None] * len(self.schema.columns)
        node_path = {0: ()}
        # A finite schema's node tree is bounded by its leaf count; a
        # self-recursive message type (message Tree { Tree child = 1; })
        # would otherwise grow the BFS forever — guard locally instead of
        # relying on proto_to_schema's RecursionError upstream.
        max_nodes = 8 * max(len(self.schema.columns), 1) + 256
        while node_queue:
            m = node_queue.pop(0)
            if len(fnum) > max_nodes:
                return None  # recursive (or pathologically deep) schema
            d = node_desc[m]
            child_begin[m] = len(fnum)
            for fd in d.fields:
                idx = len(fnum)
                path = node_path[m] + (fd.name,)
                if fd.number > 65535:
                    return None  # beyond the direct-address field tables
                # editions gate covers EVERY field kind (message, enum,
                # scalar): per-field presence/UTF-8/enum-closedness features
                # this plan does not model — Python path only
                if syntax_of(fd) not in ("proto2", "proto3"):
                    return None
                rep = _repetition_for(fd)
                fl = 0
                if _is_repeated(fd):
                    fl |= _FN_REPEATED
                if _is_required(fd):
                    fl |= _FN_REQUIRED
                if rep == Repetition.OPTIONAL:
                    fl |= _FN_DEF_INC
                if (not _is_repeated(fd) and rep == Repetition.REQUIRED
                        and not _is_required(fd)):
                    fl |= _FN_EMIT_DEFAULT  # proto3 no-presence default
                if fd.type == FD.TYPE_MESSAGE:
                    k, dtype = _K_MESSAGE, None
                    node_desc[idx] = fd.message_type
                    node_path[idx] = path
                    node_queue.append(idx)
                    leaf_idx.append(-1)
                elif fd.type == FD.TYPE_GROUP:
                    return None
                elif fd.type == FD.TYPE_ENUM:
                    k, dtype = _K_ENUM, None
                    li = self._leaf_index[path]
                    leaf_idx.append(li)
                    # open/closed follows the file DEFINING the enum
                    enum_syn = syntax_of(fd.enum_type)
                    if enum_syn not in ("proto2", "proto3"):
                        return None  # editions-defined enum: unmodeled
                    closed = enum_syn == "proto2"
                    by_number = _values_by_number(fd.enum_type)
                    if closed:
                        fl |= _FN_CLOSED_ENUM
                        enum_tables[idx] = sorted(by_number)
                    enum_names[li] = {
                        num: ev.name.encode("ascii")
                        for num, ev in by_number.items()}
                    leaf_kinds[li] = k
                else:
                    kd = _WIRE_KINDS.get(fd.type)
                    if kd is None:
                        return None
                    k, dtype = kd
                    if (k == _K_SPAN and fd.type == FD.TYPE_STRING
                            and syntax_of(fd) == "proto3"):
                        k = _K_SPAN_UTF8
                    li = self._leaf_index[path]
                    leaf_idx.append(li)
                    leaf_kinds[li] = k
                    leaf_dtypes[li] = dtype
                fnum.append(fd.number)
                kind.append(k)
                flags.append(fl)
                child_begin.append(0)
                child_end.append(0)
            child_end[m] = len(fnum)
        n_nodes = len(fnum)

        # per-message-node direct field tables
        ftab: list[int] = []
        ftab_off = [0] * n_nodes
        max_fn = [0] * n_nodes
        for m in range(n_nodes):
            if kind[m] != _K_MESSAGE:
                continue
            kids = range(child_begin[m], child_end[m])
            mfn = max((fnum[c] for c in kids), default=0)
            ftab_off[m] = len(ftab)
            max_fn[m] = mfn
            table = [-1] * (mfn + 1)
            for c in kids:
                table[fnum[c]] = c
            ftab.extend(table)
            if len(ftab) > (1 << 20):
                return None  # sparse giant field numbers: tables too big
        # closed-enum membership tables
        enum_vals: list[int] = []
        enum_off = [0] * n_nodes
        enum_len = [0] * n_nodes
        for m, nums in enum_tables.items():
            enum_off[m] = len(enum_vals)
            enum_len[m] = len(nums)
            enum_vals.extend(nums)
        # descendant leaves per message node (absence emission)
        null_leaves: list[int] = []
        null_off = [0] * n_nodes
        null_len = [0] * n_nodes

        def leaves_under(m) -> list[int]:
            out = []
            for c in range(child_begin[m], child_end[m]):
                if kind[c] == _K_MESSAGE:
                    out.extend(leaves_under(c))
                else:
                    out.append(leaf_idx[c])
            return out

        for m in range(n_nodes):
            if kind[m] != _K_MESSAGE:
                continue
            ls = leaves_under(m)
            null_off[m] = len(null_leaves)
            null_len[m] = len(ls)
            null_leaves.extend(ls)

        p = _NestedPlan()
        p.n_nodes = n_nodes
        p.n_leaves = len(self.schema.columns)
        p.fnum = np.asarray(fnum, np.uint32)
        p.kind = np.asarray(kind, np.uint8)
        p.flags = np.asarray(flags, np.uint8)
        p.child_begin = np.asarray(child_begin, np.int32)
        p.child_end = np.asarray(child_end, np.int32)
        p.leaf_idx = np.asarray(leaf_idx, np.int32)
        p.ftab = np.asarray(ftab or [0], np.int32)
        p.ftab_off = np.asarray(ftab_off, np.int32)
        p.max_fn = np.asarray(max_fn, np.int32)
        p.enum_vals = np.asarray(enum_vals or [0], np.int32)
        p.enum_off = np.asarray(enum_off, np.int32)
        p.enum_len = np.asarray(enum_len, np.int32)
        p.null_leaves = np.asarray(null_leaves or [0], np.int32)
        p.null_off = np.asarray(null_off, np.int32)
        p.null_len = np.asarray(null_len, np.int32)
        p.leaf_kinds = leaf_kinds
        p.leaf_dtypes = leaf_dtypes
        p.enum_names = enum_names
        return p

    @property
    def wire_capable(self) -> bool:
        """True when columnarize_payloads can take a native path (flat
        decoder for flat scalar schemas, nested decoder otherwise)."""
        plan = getattr(self, "_wire", False)
        if plan is False:
            plan = self._wire = self._wire_plan()
        if plan is not None:
            return True
        nplan = getattr(self, "_nested", False)
        if nplan is False:
            nplan = self._nested = self._nested_plan()
        return nplan is not None

    def _alloc_flat_outputs(self, plan: "_WirePlan", n: int):
        """Per-field output arrays for one flat wire-shred call."""
        out_vals, out_pos, out_len, out_pres = [], [], [], []
        for f in range(len(plan.fnum)):
            dt = plan.dtypes[f]
            if dt is None:
                out_vals.append(None)
                out_pos.append(np.zeros(n, np.int64))
                out_len.append(np.zeros(n, np.int32))
            else:
                out_vals.append(np.zeros(n, dt))
                out_pos.append(None)
                out_len.append(None)
            out_pres.append(np.zeros(n, np.uint8) if plan.optional[f] else None)
        return out_vals, out_pos, out_len, out_pres

    def _flat_chunks(self, plan: "_WirePlan", n: int, out_vals, out_pos,
                     out_len, out_pres, pys, payloads, buf, L,
                     gather_buf=None) -> list:
        """Assemble ColumnChunkData from flat shredder outputs.  With
        ``pys`` the span positions are record-relative and strings gather
        from the payload objects (gather_iov); on the contiguous path
        (``pys=None``) positions are absolute into ``buf`` and strings
        gather with ``gather_buf`` (the C extension's GIL-releasing
        gather) or ctypes gather_spans.  One shared implementation: the
        RecordBatch buffer path and the payload-list path must stay
        byte-identical by construction."""
        all_recs = None
        chunks = []
        for f, col in enumerate(self.schema.columns):
            pres = out_pres[f]
            def_levels = None
            if pres is not None:
                mask = pres.view(np.bool_)
                def_levels = pres.astype(np.int32)
            if plan.dtypes[f] is None:
                pos, ln = out_pos[f], out_len[f]
                rec_idx = None
                if pres is not None:
                    pos, ln = pos[mask], ln[mask]
                    if pys is not None:
                        rec_idx = np.nonzero(mask)[0].astype(np.int32)
                elif pys is not None:
                    if all_recs is None:
                        all_recs = np.arange(n, dtype=np.int32)
                    rec_idx = all_recs
                offsets = np.zeros(len(ln) + 1, np.int64)
                np.cumsum(ln, out=offsets[1:])
                if pys is not None:
                    payload = pys.gather_iov(payloads, rec_idx, pos, ln)
                elif gather_buf is not None:
                    payload = gather_buf(
                        buf, np.ascontiguousarray(pos, np.int64),
                        np.ascontiguousarray(ln, np.int32))
                else:
                    payload = L.gather_spans(buf, pos, ln)
                values = ByteColumn(payload, offsets)
            else:
                values = out_vals[f]
                if pres is not None:
                    values = values[mask]
            chunks.append(ColumnChunkData(col, values, def_levels, None, n))
        return chunks

    def columnarize_payloads(self, payloads: list) -> ColumnBatch:
        """Shred serialized (un-parsed) messages straight to a ColumnBatch
        via the C++ wire decoders — no Python message objects.  Flat scalar
        schemas ride kpw_proto_shred; anything else (repeated / nested /
        enum) rides kpw_proto_shred_nested.  Raises WireShredError when any
        record needs the Python fallback; raises ValueError when the schema
        is not wire-capable (check :attr:`wire_capable` first)."""
        if not self.wire_capable:
            raise ValueError("schema is not wire-shreddable")
        n = len(payloads)
        if self._wire is None:
            lens = np.fromiter(map(len, payloads), np.int64, count=n)
            offs = np.zeros(n + 1, np.int64)
            np.cumsum(lens, out=offs[1:])
            return self._shred_nested(b"".join(payloads), offs)
        plan: _WirePlan = self._wire
        from ..native import lib as _native_lib, pyshred as _pyshred

        L = _native_lib()
        out_vals, out_pos, out_len, out_pres = \
            self._alloc_flat_outputs(plan, n)

        # zero-copy C-extension entry: reads the payload bytes objects in
        # place (no b"".join, no fromiter length walk — ~35 ms per 300k
        # records on the streaming hot path); span positions come back
        # record-relative and strings gather straight into their final
        # ByteColumn payload (one copy total)
        pys = _pyshred()
        buf = None
        if pys is not None:
            try:
                err, total = pys.shred_flat(
                    payloads, plan.fnum, plan.kinds, plan.flags,
                    tuple(out_vals), tuple(out_pos), tuple(out_len),
                    tuple(out_pres))
            except TypeError:
                pys = None  # non-bytes payloads: ctypes join path below
        if pys is None:
            lens = np.fromiter(map(len, payloads), np.int64, count=n)
            offs = np.zeros(n + 1, np.int64)
            np.cumsum(lens, out=offs[1:])
            buf = b"".join(payloads)
            total = int(offs[-1])
            err = L.proto_shred(buf, offs, len(plan.fnum), plan.fnum,
                                plan.kinds, plan.flags, out_vals, out_pos,
                                out_len, out_pres)
        if err >= 0:
            raise WireShredError(int(err))
        chunks = self._flat_chunks(plan, n, out_vals, out_pos, out_len,
                                   out_pres, pys, payloads, buf, L)
        batch = ColumnBatch(chunks, n)
        batch.wire_bytes = int(total)  # payload bytes, for byte metering
        return batch

    def columnarize_buffer(self, buf, offsets) -> ColumnBatch:
        """Batch-native zero-copy intake: shred serialized records that
        already live in ONE contiguous buffer (record i =
        ``buf[offsets[i]:offsets[i+1]]``; int64 offsets of length n+1,
        ascending, ``offsets[0]`` may be nonzero — a RecordBatch slice
        shares its parent's buffer) straight to a ColumnBatch.  This is
        the :class:`~kpw_tpu_torch.ingest.broker.RecordBatch` handoff's
        consumer: no per-record ``bytes`` objects, no join — the broker's
        fetch buffer goes to the C++ shredder as-is.  Output is
        byte-identical to :meth:`columnarize_payloads` over the same
        records (shared assembly, pinned by test_batch_ingest).  Raises
        WireShredError / ValueError exactly like
        :meth:`columnarize_payloads`."""
        if not self.wire_capable:
            raise ValueError("schema is not wire-shreddable")
        offs = np.ascontiguousarray(offsets, np.int64)
        n = len(offs) - 1
        # validate the caller-supplied offset table before any decoder
        # (C entries re-check too, but the ctypes and nested routes read
        # it raw): one malformed interior offset is an out-of-bounds read
        if n > 0 and (int(offs[0]) < 0 or int(offs[-1]) > len(buf)
                      or not bool((np.diff(offs) >= 0).all())):
            raise ValueError(
                "offsets must be ascending and within the buffer")
        if self._wire is None:
            # the fused entry takes any buffer (a RecordBatch / ring-slot
            # memoryview stays zero-copy); only the ctypes fallback inside
            # _shred_nested materializes bytes
            return self._shred_nested(buf, offs)
        plan: _WirePlan = self._wire
        from ..native import lib as _native_lib, pyshred as _pyshred

        L = _native_lib()
        # prefer the C-extension entry (shred_flat_buf/gather_buf): decode
        # and gather run with the GIL RELEASED, so the encode pipeline
        # thread overlaps them — the ctypes route's per-call marshalling
        # was measurable GIL pressure on the 2-core streaming path
        pys = _pyshred()
        shred_buf = getattr(pys, "shred_flat_buf", None)
        gather_buf = getattr(pys, "gather_buf", None)
        if shred_buf is None or gather_buf is None:
            # ctypes fallback route needs real bytes; the C entries take
            # any buffer (a memoryview of a shared-memory ring slot stays
            # zero-copy — the process-workers handoff depends on it)
            buf = bytes(buf)
        out_vals, out_pos, out_len, out_pres = \
            self._alloc_flat_outputs(plan, n)
        if shred_buf is not None:
            if not plan._cont:
                plan._cont = (np.ascontiguousarray(plan.fnum, np.uint32),
                              bytes(np.ascontiguousarray(plan.kinds, np.uint8)),
                              bytes(np.ascontiguousarray(plan.flags, np.uint8)))
            fnum_c, kinds_c, flags_c = plan._cont
            err, _ = shred_buf(buf, offs, fnum_c, kinds_c, flags_c,
                               tuple(out_vals), tuple(out_pos),
                               tuple(out_len), tuple(out_pres))
        else:
            err = L.proto_shred(buf, offs, len(plan.fnum), plan.fnum,
                                plan.kinds, plan.flags, out_vals, out_pos,
                                out_len, out_pres)
        if err >= 0:
            raise WireShredError(int(err))
        chunks = self._flat_chunks(plan, n, out_vals, out_pos, out_len,
                                   out_pres, None, None, buf, L,
                                   gather_buf=gather_buf)
        batch = ColumnBatch(chunks, n)
        batch.wire_bytes = int(offs[-1] - offs[0])
        return batch

    def _shred_nested(self, buf, offs: np.ndarray) -> ColumnBatch:
        """Nested/repeated/enum wire shred over a contiguous buffer +
        record offsets; the output (values for present entries + per-visit
        def/rep levels) is element-identical to :meth:`columnarize` over
        the parsed messages.  ONE GIL-released decode
        (``shred_nested_buf``) plus ONE GIL-released materialization
        (``nested_fill``) land every leaf in its final packed form: span
        payloads gathered straight into their ByteColumn payload bytes with
        the int64 offset table built in the same pass, def/rep levels
        widened to the uint32 the nogil page assembler's RLE ops slice with
        zero further copies.  Accepts any buffer (a RecordBatch view stays
        zero-copy)."""
        from ..native import pyshred as _pyshred

        n = len(offs) - 1
        batch = self._shred_nested_fused(_pyshred(), buf, offs, self._nested, n)
        batch.wire_bytes = int(offs[-1] - offs[0]) if n else 0
        return batch

    def _shred_nested_fused(self, pys, buf, offs: np.ndarray,
                            plan: "_NestedPlan", n: int) -> ColumnBatch:
        """The fused decode+materialize route (see :meth:`_shred_nested`),
        with levels arriving as uint32 (the dtype every downstream consumer
        treats numerically; the RLE lowering in core/pages.py slices them
        with no conversion copy at all)."""
        from ..native import lib as _native_lib

        fnum_c, kind_c, flags_c, tabs = plan.cont()
        rc, cap, sizes_b = pys.shred_nested_buf(
            buf, offs, plan.n_nodes, plan.n_leaves, fnum_c, kind_c, flags_c,
            tabs)
        if cap is None:
            raise WireShredError(int(rc))
        sizes = np.frombuffer(sizes_b, np.int64)
        cols = self.schema.columns
        vals_t, offsets_t, defs_t, reps_t = [], [], [], []
        for li, col in enumerate(cols):
            k = plan.leaf_kinds[li]
            row = 4 * li
            nlev = int(sizes[row + 3])
            if k in (_K_SPAN, _K_SPAN_UTF8):
                vals_t.append(None)
                offsets_t.append(np.empty(int(sizes[row + 1]) + 1, np.int64))
            else:
                dt = np.dtype(np.int32 if k == _K_ENUM
                              else plan.leaf_dtypes[li])
                vals_t.append(np.empty(int(sizes[row]) // dt.itemsize, dt))
                offsets_t.append(None)
            defs_t.append(np.empty(nlev, np.uint32)
                          if col.max_def > 0 else None)
            reps_t.append(np.empty(nlev, np.uint32)
                          if col.max_rep > 0 else None)
        payloads = pys.nested_fill(cap, buf, tuple(vals_t), tuple(offsets_t),
                                   tuple(defs_t), tuple(reps_t))
        chunks = []
        for li, col in enumerate(cols):
            k = plan.leaf_kinds[li]
            if k in (_K_SPAN, _K_SPAN_UTF8):
                values = ByteColumn(payloads[li], offsets_t[li])
            elif k == _K_ENUM:
                values = self._enum_bytecol(_native_lib(), vals_t[li],
                                            plan.enum_names[li])
            else:
                values = vals_t[li]
            chunks.append(ColumnChunkData(col, values, defs_t[li],
                                          reps_t[li], n))
        return ColumnBatch(chunks, n)

    @staticmethod
    def _enum_bytecol(L, nums: np.ndarray, names: dict) -> ByteColumn:
        """Enum numbers -> name ByteColumn without a per-record Python loop:
        unique the numbers (small cardinality), render each unique name once
        (open-enum unknowns as UNKNOWN_ENUM_{v}, proto_bridge._emit_value
        parity), and gather the payload by inverse index."""
        if len(nums) == 0:
            return ByteColumn.from_list([])
        uniq, inverse = np.unique(nums, return_inverse=True)
        rendered = [names.get(int(v), b"") or f"UNKNOWN_ENUM_{int(v)}".encode("ascii")
                    for v in uniq]
        ulens = np.fromiter(map(len, rendered), np.int32, count=len(rendered))
        upos = np.zeros(len(rendered), np.int64)
        np.cumsum(ulens[:-1], out=upos[1:])
        blob = b"".join(rendered)
        out_lens = ulens[inverse]
        payload = L.gather_spans(blob, upos[inverse], out_lens)
        offsets = np.zeros(len(nums) + 1, np.int64)
        np.cumsum(out_lens, out=offsets[1:])
        return ByteColumn(payload, offsets)

    def columnarize(self, records) -> ColumnBatch:
        plan = getattr(self, "_flat", False)
        if plan is False:
            plan = self._flat = self._flat_plan()
        if plan is not None:
            return self._columnarize_flat(records, plan)
        cols = self.schema.columns
        buffers = [_LeafBuffer() for _ in cols]
        # map descriptor walk to leaf indices via path
        desc = self.msg_class.DESCRIPTOR

        def emit_nulls(fd_path_prefix, sub_fields, r, d) -> None:
            """Record absence for every leaf under a subtree."""
            for fd in sub_fields:
                path = fd_path_prefix + (fd.name,)
                if fd.type == FD.TYPE_MESSAGE:
                    emit_nulls(path, fd.message_type.fields, r, d)
                else:
                    buf = buffers[self._leaf_index[path]]
                    buf.defs.append(d)
                    buf.reps.append(r)

        def visit_fields(msg, fields, path_prefix, r0, d0, rep_depth) -> None:
            for fd in fields:
                path = path_prefix + (fd.name,)
                if _is_repeated(fd):
                    items = getattr(msg, fd.name)
                    if len(items) == 0:
                        if fd.type == FD.TYPE_MESSAGE:
                            emit_nulls(path, fd.message_type.fields, r0, d0)
                        else:
                            buf = buffers[self._leaf_index[path]]
                            buf.defs.append(d0)
                            buf.reps.append(r0)
                        continue
                    # repetition level of items after the first is the depth
                    # of *this* repeated field (Dremel), not the leaf's max
                    item_rep = rep_depth + 1
                    d1 = d0 + 1
                    for i, item in enumerate(items):
                        r = r0 if i == 0 else item_rep
                        if fd.type == FD.TYPE_MESSAGE:
                            visit_fields(item, fd.message_type.fields, path,
                                         r, d1, item_rep)
                        else:
                            self._emit_value(buffers[self._leaf_index[path]],
                                             fd, item, r, d1)
                elif fd.type == FD.TYPE_MESSAGE:
                    if msg.HasField(fd.name):
                        d1 = d0 + (1 if _repetition_for(fd) == Repetition.OPTIONAL else 0)
                        visit_fields(getattr(msg, fd.name),
                                     fd.message_type.fields, path, r0, d1,
                                     rep_depth)
                    else:
                        emit_nulls(path, fd.message_type.fields, r0, d0)
                else:
                    rep = _repetition_for(fd)
                    if rep == Repetition.OPTIONAL and not msg.HasField(fd.name):
                        buf = buffers[self._leaf_index[path]]
                        buf.defs.append(d0)
                        buf.reps.append(r0)
                    else:
                        d1 = d0 + (1 if rep == Repetition.OPTIONAL else 0)
                        self._emit_value(buffers[self._leaf_index[path]],
                                         fd, getattr(msg, fd.name), r0, d1)

        for rec in records:
            visit_fields(rec, desc.fields, (), 0, 0, 0)

        chunks = []
        n = len(records)
        for col, buf in zip(cols, buffers):
            values = self._finalize_values(col, buf.values)
            def_levels = (np.asarray(buf.defs, np.int32)
                          if col.max_def > 0 else None)
            rep_levels = (np.asarray(buf.reps, np.int32)
                          if col.max_rep > 0 else None)
            chunks.append(ColumnChunkData(col, values, def_levels, rep_levels, n))
        return ColumnBatch(chunks, n)

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _emit_value(buf: _LeafBuffer, fd, value, r: int, d: int) -> None:
        if fd.type == FD.TYPE_STRING:
            value = (value.encode("utf-8") if isinstance(value, str)
                     else bytes(value))
        elif fd.type == FD.TYPE_ENUM:
            ev = _values_by_number(fd.enum_type).get(value)
            # open enums (proto3): unknown numbers survive parsing; encode a
            # stable placeholder instead of killing the worker
            value = (ev.name if ev is not None
                     else f"UNKNOWN_ENUM_{value}").encode("ascii")
        elif fd.type in (FD.TYPE_UINT64, FD.TYPE_FIXED64) and value >= 1 << 63:
            value = value - (1 << 64)  # store as wrapped int64 per UINT_64
        elif fd.type in (FD.TYPE_UINT32, FD.TYPE_FIXED32) and value >= 1 << 31:
            value = value - (1 << 32)  # store as wrapped int32 per UINT_32
        buf.values.append(value)
        buf.defs.append(d)
        buf.reps.append(r)

    @staticmethod
    def _finalize_values(col: ColumnDescriptor, values: list):
        pt = col.leaf.physical_type
        dtype = _NUMPY_DTYPES.get(pt)
        if dtype is not None:
            return np.asarray(values, dtype)
        if pt in (PhysicalType.BYTE_ARRAY, PhysicalType.FIXED_LEN_BYTE_ARRAY):
            return ByteColumn.from_list(values)
        return values
