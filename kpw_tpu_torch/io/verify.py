"""Independent structural verifier for parquet files — no pyarrow, no
shared write-path code beyond the thrift decoder.

The write side (core/writer.py, core/pages.py) emits page CRCs and a
thrift footer, but until this module nothing in the repo could *check* a
published file: a torn final (kill -9 between a page-cache write and the
fsync that never happened) or a bit-flipped page body was invisible until
some downstream reader choked.  This verifier walks the physical layout
from the bytes alone:

* ``PAR1`` magic at both ends,
* footer-length sanity (the 4-byte little-endian length must frame a
  region inside the file),
* thrift-compact footer parse (bounds-checked ``core.thrift.CompactReader``
  — corruption raises ``ThriftDecodeError``, never an IndexError),
* row-group / column-chunk offsets and sizes in-bounds and non-overlapping
  with the footer,
* a full page-header walk of every column chunk (header parse, body
  in-bounds, page-type sanity, per-chunk byte accounting),
* CRC-32 (gzip polynomial, PARQUET-1539) check of every page body that
  carries the optional crc field — the write side's
  ``Builder.page_checksums(True)`` checksums verified on read,
* row/value-count consistency (row-group rows sum to the footer's
  ``num_rows``; each chunk's data-page values sum to its meta's
  ``num_values``),
* the query-ready footer sections (PARQUET-922 page indexes, split-block
  bloom filters, ``sorting_columns`` — the write side is
  ``core/index.py``): index offsets/lengths in-bounds and thrift-parsable,
  OffsetIndex page locations matching the walked pages one for one,
  ColumnIndex list lengths consistent with the page count and its
  declared boundary order consistent with the page min/max stats, bloom
  headers sane with in-bounds bitsets, and every declared sorting column
  consistent with its column index's ordering (a file CLAIMING sortedness
  its pages contradict fails verification — sort-on-compact publishes
  through this check).

It deliberately does NOT decode values: the contract is "structurally
valid parquet whose every byte is where the footer says it is", which is
what the recovery pass (runtime/writer.py ``recover``) needs to decide
publish-vs-quarantine, and what the crash harness (tests/test_crash.py,
``bench.py --crash``) asserts for every acked offset's file.

CLI: ``python -m kpw_tpu_torch.io.verify <file-or-dir> [...]`` — exit 0 iff
every file verifies; ``--json`` dumps the reports as one JSON array;
``--summary`` replaces the per-file report with ONE JSON rollup
(files/rows/row groups/pages/failing paths) so a compaction run can
assert directory-level integrity in a single call.
"""

from __future__ import annotations

import json
import os
import struct
import sys
import zlib
from dataclasses import dataclass, field

from ..core.schema import Codec, PageType
from ..core.thrift import CompactReader, ThriftDecodeError
from .fs import FileSystem, LocalFileSystem

MAGIC = b"PAR1"
# trailing frame: 4-byte little-endian footer length + magic
_TAIL = 8
# FileMetaData field ids (parquet.thrift; mirrors core/metadata.py's writer)
_FMD_VERSION, _FMD_SCHEMA, _FMD_NUM_ROWS, _FMD_ROW_GROUPS = 1, 2, 3, 4
# SchemaElement
_SE_TYPE, _SE_NUM_CHILDREN = 1, 5
_SE_REPETITION, _SE_NAME, _SE_CONVERTED = 3, 4, 6
# RowGroup
_RG_COLUMNS, _RG_NUM_ROWS, _RG_SORTING = 1, 3, 4
# SortingColumn
_SC_COLUMN_IDX = 1
# ColumnChunk / ColumnMetaData
_CC_META = 3
_CC_OI_OFF, _CC_OI_LEN, _CC_CI_OFF, _CC_CI_LEN = 4, 5, 6, 7
_CM_TYPE = 1
_CM_CODEC, _CM_NUM_VALUES = 4, 5
_CM_TOTAL_COMPRESSED = 7
_CM_DATA_PAGE_OFFSET, _CM_DICT_PAGE_OFFSET = 9, 11
_CM_BLOOM_OFF, _CM_BLOOM_LEN = 14, 15
# PageHeader
_PH_TYPE, _PH_UNCOMPRESSED, _PH_COMPRESSED, _PH_CRC = 1, 2, 3, 4
_PH_DATA_HEADER, _PH_DICT_HEADER, _PH_V2_HEADER = 5, 7, 8
_DPH_NUM_VALUES = 1  # in both v1 and v2 data-page headers
# ColumnIndex / OffsetIndex / PageLocation (PARQUET-922)
_CI_NULL_PAGES, _CI_MIN, _CI_MAX, _CI_ORDER, _CI_NULL_COUNTS = 1, 2, 3, 4, 5
_OI_LOCATIONS = 1
_PL_OFFSET, _PL_SIZE, _PL_FIRST_ROW = 1, 2, 3
_BO_UNORDERED, _BO_ASCENDING, _BO_DESCENDING = 0, 1, 2
# BloomFilterHeader
_BFH_NUM_BYTES, _BFH_ALGO, _BFH_HASH, _BFH_COMP = 1, 2, 3, 4
# physical types whose stats decode to numbers (parquet.thrift Type)
_PT_STRUCT_FMT = {1: "<i", 2: "<q", 4: "<f", 5: "<d"}


@dataclass
class FileReport:
    """Structured verdict for one file.  ``ok`` iff ``errors`` is empty;
    every failed check appends one human-readable entry (the walk keeps
    going where it safely can, so one report carries every independent
    defect it could reach)."""

    path: str
    size: int = 0
    ok: bool = False
    errors: list = field(default_factory=list)
    num_rows: int | None = None
    row_groups: int = 0
    columns: int = 0
    pages: int = 0
    pages_crc_checked: int = 0
    footer_bytes: int = 0
    # query-ready sections (core/index.py write side): structurally
    # validated page-index/bloom/sorting counts
    column_indexes: int = 0
    offset_indexes: int = 0
    pages_indexed: int = 0
    bloom_filters: int = 0
    sorted_row_groups: int = 0

    def to_dict(self) -> dict:
        return {
            "path": self.path,
            "size": self.size,
            "ok": self.ok,
            "errors": list(self.errors),
            "num_rows": self.num_rows,
            "row_groups": self.row_groups,
            "columns": self.columns,
            "pages": self.pages,
            "pages_crc_checked": self.pages_crc_checked,
            "footer_bytes": self.footer_bytes,
            "column_indexes": self.column_indexes,
            "offset_indexes": self.offset_indexes,
            "pages_indexed": self.pages_indexed,
            "bloom_filters": self.bloom_filters,
            "sorted_row_groups": self.sorted_row_groups,
        }


def _require_int(report: FileReport, container: dict, fid: int,
                 what: str) -> int | None:
    v = container.get(fid)
    if not isinstance(v, int) or isinstance(v, bool):
        report.errors.append(f"{what} missing or not an integer")
        return None
    return v


def _walk_chunk(data: bytes, report: FileReport, rg_i: int, col_i: int,
                meta: dict, footer_start: int) -> list | None:
    """Page-header walk of one column chunk: every page header must parse,
    every body must lie inside the chunk, the bytes must account exactly
    for total_compressed_size, data-page values must sum to num_values,
    and any page carrying a crc field must match its body's CRC-32.
    Returns the walked data pages as [(header_pos, total_size), ...] —
    what the OffsetIndex cross-check matches location by location — or
    None when the walk had to stop early."""
    where = f"row group {rg_i} column {col_i}"
    num_values = _require_int(report, meta, _CM_NUM_VALUES,
                              f"{where}: num_values")
    total = _require_int(report, meta, _CM_TOTAL_COMPRESSED,
                         f"{where}: total_compressed_size")
    data_off = _require_int(report, meta, _CM_DATA_PAGE_OFFSET,
                            f"{where}: data_page_offset")
    if num_values is None or total is None or data_off is None:
        return None
    dict_off = meta.get(_CM_DICT_PAGE_OFFSET)
    if dict_off is not None and (not isinstance(dict_off, int)
                                 or isinstance(dict_off, bool)):
        # same int discipline as the required fields: a corrupt footer can
        # flip field 11's type nibble, and the verifier must diagnose that,
        # not crash computing offsets with bytes
        report.errors.append(
            f"{where}: dictionary_page_offset is not an integer")
        return None
    start = dict_off if dict_off is not None else data_off
    end = start + total
    if start < len(MAGIC) or total < 0 or end > footer_start:
        report.errors.append(
            f"{where}: chunk [{start}, {end}) outside data region "
            f"[{len(MAGIC)}, {footer_start})")
        return None
    if not start <= data_off < end:
        report.errors.append(
            f"{where}: data_page_offset {data_off} outside chunk "
            f"[{start}, {end})")
        return None
    codec = meta.get(_CM_CODEC, Codec.UNCOMPRESSED)
    pos = start
    values_seen = 0
    first = True
    first_data_pos = None
    data_pages: list = []
    while pos < end:
        r = CompactReader(data, pos, limit=end)
        try:
            ph = r.read_struct()
        except ThriftDecodeError as e:
            report.errors.append(
                f"{where}: page header at byte {pos} unreadable: {e}")
            return None
        ptype = ph.get(_PH_TYPE)
        comp = ph.get(_PH_COMPRESSED)
        uncomp = ph.get(_PH_UNCOMPRESSED)
        if not isinstance(comp, int) or not isinstance(uncomp, int) \
                or comp < 0 or uncomp < 0:
            report.errors.append(
                f"{where}: page at byte {pos} has invalid sizes "
                f"(compressed={comp!r}, uncompressed={uncomp!r})")
            return None
        body_start = r.pos
        body_end = body_start + comp
        if body_end > end:
            report.errors.append(
                f"{where}: page body [{body_start}, {body_end}) overruns "
                f"chunk end {end} — torn page")
            return None
        if ptype == PageType.DICTIONARY_PAGE:
            if not first or dict_off != pos:
                report.errors.append(
                    f"{where}: dictionary page at byte {pos} not the "
                    f"chunk's first page at dictionary_page_offset")
        elif ptype in (PageType.DATA_PAGE, PageType.DATA_PAGE_V2):
            if first_data_pos is None:
                first_data_pos = pos
            hdr_fid = (_PH_DATA_HEADER if ptype == PageType.DATA_PAGE
                       else _PH_V2_HEADER)
            hdr = ph.get(hdr_fid)
            nv = hdr.get(_DPH_NUM_VALUES) if isinstance(hdr, dict) else None
            if not isinstance(nv, int):
                report.errors.append(
                    f"{where}: data page at byte {pos} missing its "
                    f"num_values header")
                return None
            values_seen += nv
            data_pages.append((pos, body_end - pos))
        else:
            report.errors.append(
                f"{where}: page at byte {pos} has unknown type {ptype!r}")
            return None
        if codec == Codec.UNCOMPRESSED and comp != uncomp:
            report.errors.append(
                f"{where}: uncompressed page at byte {pos} has "
                f"compressed={comp} != uncompressed={uncomp}")
        crc = ph.get(_PH_CRC)
        if isinstance(crc, int):
            got = zlib.crc32(data[body_start:body_end])
            if got != crc & 0xFFFFFFFF:
                report.errors.append(
                    f"{where}: page at byte {pos} CRC mismatch "
                    f"(header {crc & 0xFFFFFFFF:#010x}, body {got:#010x})")
            report.pages_crc_checked += 1
        report.pages += 1
        first = False
        pos = body_end
    if pos != end:
        report.errors.append(
            f"{where}: pages account for {pos - start} bytes, footer says "
            f"{total}")
    if first_data_pos is not None and first_data_pos != data_off:
        report.errors.append(
            f"{where}: first data page at byte {first_data_pos}, footer "
            f"says {data_off}")
    if values_seen != num_values:
        report.errors.append(
            f"{where}: data pages carry {values_seen} values, footer says "
            f"{num_values}")
    return data_pages


def _decode_stat(value, physical_type):
    """Plain-encoded ColumnIndex min/max bytes -> comparable value, or
    None when empty/undecodable (the verifier then skips the compare
    rather than guessing)."""
    if not isinstance(value, (bytes, bytearray)) or not value:
        return None
    fmt = _PT_STRUCT_FMT.get(physical_type)
    if fmt is None:
        return bytes(value)
    if len(value) != struct.calcsize(fmt):
        return None
    return struct.unpack(fmt, value)[0]


def _leaf_types(fmd: dict) -> list:
    """Schema leaves' physical types, in column order (a SchemaElement
    without num_children is a leaf; the writer mirrors this rule)."""
    out = []
    for el in (fmd.get(_FMD_SCHEMA) or [])[1:]:
        if isinstance(el, dict) and not el.get(_SE_NUM_CHILDREN):
            out.append(el.get(_SE_TYPE))
    return out


def _section_in_bounds(report: FileReport, where: str, what: str,
                       off, length, footer_start: int) -> bool:
    """Offset/length pair sanity for one index/bloom section: both ints,
    non-negative, and the region inside the data area before the footer."""
    if not isinstance(off, int) or isinstance(off, bool) \
            or not isinstance(length, int) or isinstance(length, bool):
        report.errors.append(f"{where}: {what} offset/length not integers")
        return False
    if off < len(MAGIC) or length <= 0 or off + length > footer_start:
        report.errors.append(
            f"{where}: {what} [{off}, {off + length}) outside data region "
            f"[{len(MAGIC)}, {footer_start})")
        return False
    return True


def _computed_orders(mins: list, maxs: list, null_pages: list,
                     leaf_type) -> tuple[bool, bool]:
    """(ascending_consistent, descending_consistent) of the non-null
    pages' decoded min/max sequences — what a declared boundary order (or
    a declared sorting column) is checked against."""
    keys = []
    for i, (lo, hi) in enumerate(zip(mins, maxs)):
        if i < len(null_pages) and null_pages[i]:
            continue
        dlo, dhi = _decode_stat(lo, leaf_type), _decode_stat(hi, leaf_type)
        if dlo is None or dhi is None:
            continue  # undecodable entry: checked elsewhere, not here
        keys.append((dlo, dhi))
    asc = all(a[0] <= b[0] and a[1] <= b[1]
              for a, b in zip(keys, keys[1:]))
    desc = all(a[0] >= b[0] and a[1] >= b[1]
               for a, b in zip(keys, keys[1:]))
    return asc, desc


def _walk_index_sections(data: bytes, report: FileReport, rg_i: int,
                         col_i: int, cc: dict, meta: dict,
                         footer_start: int, leaf_type,
                         data_pages: list | None):
    """Structural walk of one chunk's query-ready sections: OffsetIndex
    locations must match the walked pages one for one, ColumnIndex lists
    must be page-count-consistent with a boundary order the stats support,
    and a bloom header must frame an in-bounds bitset.  Returns the
    ColumnIndex's computed (asc_ok, desc_ok) for the sorting-declaration
    cross-check, or None when no ColumnIndex parsed."""
    where = f"row group {rg_i} column {col_i}"
    orders = None
    oi_off, oi_len = cc.get(_CC_OI_OFF), cc.get(_CC_OI_LEN)
    ci_off, ci_len = cc.get(_CC_CI_OFF), cc.get(_CC_CI_LEN)
    n_pages = None
    if (oi_off is None) != (oi_len is None):
        report.errors.append(
            f"{where}: offset index offset/length must come as a pair")
    elif oi_off is not None and _section_in_bounds(
            report, where, "offset index", oi_off, oi_len, footer_start):
        r = CompactReader(data, oi_off, limit=oi_off + oi_len)
        try:
            oi = r.read_struct()
        except ThriftDecodeError as e:
            report.errors.append(f"{where}: offset index unreadable: {e}")
            oi = None
        if oi is not None:
            locs = oi.get(_OI_LOCATIONS)
            if not isinstance(locs, list):
                report.errors.append(
                    f"{where}: offset index has no page_locations list")
            else:
                report.offset_indexes += 1
                n_pages = len(locs)
                report.pages_indexed += n_pages
                last_row = -1
                for p_i, loc in enumerate(locs):
                    trip = (loc.get(_PL_OFFSET), loc.get(_PL_SIZE),
                            loc.get(_PL_FIRST_ROW)) \
                        if isinstance(loc, dict) else (None, None, None)
                    if not all(isinstance(v, int) and not isinstance(v, bool)
                               for v in trip):
                        report.errors.append(
                            f"{where}: page location {p_i} malformed")
                        break
                    off, size, first_row = trip
                    if data_pages is not None:
                        if p_i >= len(data_pages):
                            report.errors.append(
                                f"{where}: offset index lists {len(locs)} "
                                f"pages, chunk walk found "
                                f"{len(data_pages)}")
                            break
                        wpos, wsize = data_pages[p_i]
                        if off != wpos or size != wsize:
                            report.errors.append(
                                f"{where}: page location {p_i} says "
                                f"[{off}, +{size}), walked page at "
                                f"[{wpos}, +{wsize})")
                    if first_row <= last_row or (p_i == 0 and first_row):
                        report.errors.append(
                            f"{where}: page location {p_i} first_row_index "
                            f"{first_row} not increasing from 0")
                        break
                    last_row = first_row
                else:
                    if data_pages is not None and len(locs) != len(
                            data_pages):
                        report.errors.append(
                            f"{where}: offset index lists {len(locs)} "
                            f"pages, chunk walk found {len(data_pages)}")
    if (ci_off is None) != (ci_len is None):
        report.errors.append(
            f"{where}: column index offset/length must come as a pair")
    elif ci_off is not None and _section_in_bounds(
            report, where, "column index", ci_off, ci_len, footer_start):
        r = CompactReader(data, ci_off, limit=ci_off + ci_len)
        try:
            ci = r.read_struct()
        except ThriftDecodeError as e:
            report.errors.append(f"{where}: column index unreadable: {e}")
            ci = None
        if ci is not None:
            null_pages = ci.get(_CI_NULL_PAGES)
            mins, maxs = ci.get(_CI_MIN), ci.get(_CI_MAX)
            order = ci.get(_CI_ORDER)
            null_counts = ci.get(_CI_NULL_COUNTS)
            if not (isinstance(null_pages, list) and isinstance(mins, list)
                    and isinstance(maxs, list)):
                report.errors.append(
                    f"{where}: column index missing a required page list")
            elif not len(null_pages) == len(mins) == len(maxs):
                report.errors.append(
                    f"{where}: column index page lists disagree "
                    f"({len(null_pages)}/{len(mins)}/{len(maxs)})")
            elif n_pages is not None and len(mins) != n_pages:
                report.errors.append(
                    f"{where}: column index covers {len(mins)} pages, "
                    f"offset index {n_pages}")
            elif null_counts is not None and (
                    not isinstance(null_counts, list)
                    or len(null_counts) != len(mins)):
                report.errors.append(
                    f"{where}: column index null_counts length mismatch")
            elif order not in (_BO_UNORDERED, _BO_ASCENDING,
                               _BO_DESCENDING):
                report.errors.append(
                    f"{where}: column index boundary_order {order!r} "
                    f"invalid")
            elif isinstance(null_counts, list) and any(
                    flag and isinstance(nc, int) and not isinstance(nc, bool)
                    and nc == 0
                    for flag, nc in zip(null_pages, null_counts)):
                # null_pages=true claims EVERY value on the page is null;
                # a zero null_count on the same page is a contradiction a
                # pruning reader would act on
                report.errors.append(
                    f"{where}: column index declares a null page with "
                    f"null_count 0")
            else:
                report.column_indexes += 1
                orders = _computed_orders(mins, maxs, null_pages, leaf_type)
                if ((order == _BO_ASCENDING and not orders[0])
                        or (order == _BO_DESCENDING and not orders[1])):
                    report.errors.append(
                        f"{where}: boundary_order "
                        f"{'ASCENDING' if order == _BO_ASCENDING else 'DESCENDING'}"
                        f" contradicted by the page min/max stats")
    bloom_off = meta.get(_CM_BLOOM_OFF)
    if bloom_off is not None:
        if not isinstance(bloom_off, int) or isinstance(bloom_off, bool) \
                or not len(MAGIC) <= bloom_off < footer_start:
            report.errors.append(
                f"{where}: bloom_filter_offset {bloom_off!r} invalid")
        else:
            r = CompactReader(data, bloom_off, limit=footer_start)
            try:
                hdr = r.read_struct()
            except ThriftDecodeError as e:
                report.errors.append(
                    f"{where}: bloom filter header unreadable: {e}")
                hdr = None
            if hdr is not None:
                nb = hdr.get(_BFH_NUM_BYTES)
                bad = None
                if not isinstance(nb, int) or isinstance(nb, bool) \
                        or nb < 32 or nb % 32:
                    bad = f"numBytes {nb!r} (need a multiple of 32 >= 32)"
                elif r.pos + nb > footer_start:
                    bad = (f"bitset [{r.pos}, {r.pos + nb}) overruns the "
                           f"data region")
                else:
                    for fid, what in ((_BFH_ALGO, "algorithm"),
                                      (_BFH_HASH, "hash"),
                                      (_BFH_COMP, "compression")):
                        union = hdr.get(fid)
                        if not isinstance(union, dict) or 1 not in union:
                            bad = f"{what} union missing variant 1"
                            break
                bloom_len = meta.get(_CM_BLOOM_LEN)
                if bad is None and isinstance(bloom_len, int) \
                        and not isinstance(bloom_len, bool) \
                        and bloom_len != (r.pos - bloom_off) + nb:
                    bad = (f"bloom_filter_length {bloom_len} != header + "
                           f"bitset {(r.pos - bloom_off) + nb}")
                if bad is not None:
                    report.errors.append(
                        f"{where}: bloom filter header: {bad}")
                else:
                    report.bloom_filters += 1
    return orders


def verify_bytes(data: bytes, path: str = "<bytes>") -> FileReport:
    """Structurally verify one parquet file given its full contents."""
    report = FileReport(path=path, size=len(data))
    if len(data) < len(MAGIC) * 2 + 4:
        report.errors.append(
            f"file of {len(data)} bytes cannot frame magic + footer")
        return report
    if data[: len(MAGIC)] != MAGIC:
        report.errors.append("leading PAR1 magic missing")
    if data[-len(MAGIC):] != MAGIC:
        report.errors.append("trailing PAR1 magic missing — torn tail")
        return report  # without the tail frame nothing below is anchored
    footer_len = int.from_bytes(data[-_TAIL:-len(MAGIC)], "little")
    report.footer_bytes = footer_len
    footer_start = len(data) - _TAIL - footer_len
    if footer_len <= 0 or footer_start < len(MAGIC):
        report.errors.append(
            f"footer length {footer_len} does not fit the file "
            f"({len(data)} bytes)")
        return report
    r = CompactReader(data, footer_start, limit=len(data) - _TAIL)
    try:
        fmd = r.read_struct()
    except ThriftDecodeError as e:
        report.errors.append(f"footer thrift parse failed: {e}")
        return report
    if r.pos != len(data) - _TAIL:
        report.errors.append(
            f"footer parse consumed {r.pos - footer_start} bytes, "
            f"frame says {footer_len}")
    if not isinstance(fmd.get(_FMD_SCHEMA), list) or not fmd.get(_FMD_SCHEMA):
        report.errors.append("footer has no schema elements")
    num_rows = _require_int(report, fmd, _FMD_NUM_ROWS, "footer num_rows")
    report.num_rows = num_rows
    rgs = fmd.get(_FMD_ROW_GROUPS)
    if not isinstance(rgs, list):
        report.errors.append("footer has no row-group list")
        return report
    report.row_groups = len(rgs)
    leaf_types = _leaf_types(fmd)
    rows_sum = 0
    for rg_i, rg in enumerate(rgs):
        if not isinstance(rg, dict):
            report.errors.append(f"row group {rg_i} is not a struct")
            continue
        rg_rows = _require_int(report, rg, _RG_NUM_ROWS,
                               f"row group {rg_i} num_rows")
        if rg_rows is not None:
            rows_sum += rg_rows
        cols = rg.get(_RG_COLUMNS)
        if not isinstance(cols, list) or not cols:
            report.errors.append(f"row group {rg_i} has no column chunks")
            continue
        col_orders: dict[int, tuple] = {}
        for col_i, cc in enumerate(cols):
            meta = cc.get(_CC_META) if isinstance(cc, dict) else None
            if not isinstance(meta, dict):
                report.errors.append(
                    f"row group {rg_i} column {col_i} has no metadata")
                continue
            report.columns += 1
            pages = _walk_chunk(data, report, rg_i, col_i, meta,
                                footer_start)
            orders = _walk_index_sections(
                data, report, rg_i, col_i, cc, meta, footer_start,
                leaf_types[col_i] if col_i < len(leaf_types) else None,
                pages)
            if orders is not None:
                col_orders[col_i] = orders
        # sorting_columns declarations: structurally sane, and consistent
        # with the declared column's page-index ordering when one exists
        sorting = rg.get(_RG_SORTING)
        if sorting is not None:
            if not isinstance(sorting, list):
                report.errors.append(
                    f"row group {rg_i}: sorting_columns is not a list")
            else:
                ok = True
                for s_i, sc in enumerate(sorting):
                    idx = sc.get(_SC_COLUMN_IDX) if isinstance(sc, dict) \
                        else None
                    if not isinstance(idx, int) or isinstance(idx, bool) \
                            or not 0 <= idx < len(cols):
                        report.errors.append(
                            f"row group {rg_i}: sorting column {s_i} "
                            f"ordinal {idx!r} out of range")
                        ok = False
                        continue
                    descending = bool(sc.get(2))
                    orders = col_orders.get(idx)
                    # only the PRIMARY sort key's page order is globally
                    # implied by the declaration (secondary keys order
                    # only within equal primary prefixes)
                    if s_i == 0 and orders is not None and \
                            not orders[1 if descending else 0]:
                        report.errors.append(
                            f"row group {rg_i}: declared "
                            f"{'descending' if descending else 'ascending'}"
                            f" sort on column {idx} contradicted by its "
                            f"column index page stats")
                        ok = False
                if ok:
                    report.sorted_row_groups += 1
    if num_rows is not None and rows_sum != num_rows:
        report.errors.append(
            f"row groups sum to {rows_sum} rows, footer says {num_rows}")
    report.ok = not report.errors
    return report


def verify_file(fs: FileSystem, path: str) -> FileReport:
    """Read ``path`` through ``fs`` and structurally verify it.  A file
    that cannot even be read reports that as its (only) error."""
    try:
        with fs.open_read(path) as f:
            data = f.read()
    except (OSError, KeyError) as e:  # KeyError: MemoryFileSystem miss
        report = FileReport(path=path)
        report.errors.append(f"unreadable: {e!r}")
        return report
    return verify_bytes(data, path)


def verify_dir(fs: FileSystem, target_dir: str,
               extension: str = ".parquet",
               exclude_dirs: tuple = ("tmp", "quarantine",
                                      "compacted")) -> list[FileReport]:
    """Verify every published ``extension`` file under ``target_dir``,
    excluding the writer's working subtrees (``tmp/`` holds open files
    that are legitimately incomplete; ``quarantine/`` holds files already
    condemned; ``compacted/`` holds retired compaction inputs — tombstoned
    duplicates whose rows live on in a merged published file)."""
    target = target_dir.rstrip("/")
    skips = tuple(f"{target}/{d}/" for d in exclude_dirs)
    out = []
    for p in fs.list_files(target, extension=extension):
        if any(p.startswith(s) for s in skips):
            continue
        out.append(verify_file(fs, p))
    return out


def schema_leaves_from_bytes(data: bytes,
                             path: str = "<bytes>") -> dict[str, tuple]:
    """The leaf schema of one parquet file from its bytes: dotted column
    path -> ``(physical_type, repetition, converted_type)`` thrift ints.
    Raises ``ValueError`` on anything whose footer cannot be parsed —
    callers auditing a tree route unreadable files through the
    structural verifier instead of guessing a schema for them."""
    if len(data) < _TAIL + len(MAGIC) or data[-len(MAGIC):] != MAGIC:
        raise ValueError(f"{path}: trailing PAR1 magic missing")
    footer_len = int.from_bytes(data[-_TAIL:-len(MAGIC)], "little")
    footer_start = len(data) - _TAIL - footer_len
    if footer_len <= 0 or footer_start < len(MAGIC):
        raise ValueError(
            f"{path}: footer length {footer_len} does not fit the file")
    r = CompactReader(data, footer_start, limit=len(data) - _TAIL)
    try:
        fmd = r.read_struct()
    except ThriftDecodeError as e:
        raise ValueError(f"{path}: footer thrift parse failed: {e}")
    elems = fmd.get(_FMD_SCHEMA)
    if not isinstance(elems, list) or not elems:
        raise ValueError(f"{path}: footer has no schema elements")
    leaves: dict[str, tuple] = {}
    pos = [0]

    def walk(prefix: str) -> None:
        if pos[0] >= len(elems):
            raise ValueError(f"{path}: schema element list truncated")
        el = elems[pos[0]]
        pos[0] += 1
        if not isinstance(el, dict):
            raise ValueError(f"{path}: schema element is not a struct")
        name = el.get(_SE_NAME)
        name = (name.decode("utf-8", "replace")
                if isinstance(name, bytes) else str(name))
        dotted = f"{prefix}.{name}" if prefix else name
        nchildren = el.get(_SE_NUM_CHILDREN)
        if isinstance(nchildren, int) and nchildren > 0:
            for _ in range(nchildren):
                walk(dotted)
        else:
            leaves[dotted] = (el.get(_SE_TYPE), el.get(_SE_REPETITION),
                              el.get(_SE_CONVERTED))

    root = elems[pos[0]]
    pos[0] += 1
    n_top = root.get(_SE_NUM_CHILDREN) if isinstance(root, dict) else None
    if not isinstance(n_top, int) or n_top <= 0:
        raise ValueError(f"{path}: schema root has no children")
    for _ in range(n_top):
        walk("")
    return leaves


def file_schema(fs: FileSystem, path: str) -> dict[str, tuple]:
    """Read ``path`` through ``fs`` and return its leaf schema (see
    :func:`schema_leaves_from_bytes`)."""
    with fs.open_read(path) as f:
        data = f.read()
    return schema_leaves_from_bytes(data, path)


#: the writer's working subtrees a schema verdict must never read from:
#: ``tmp/`` holds open files, ``quarantine/`` condemned ones,
#: ``compacted/`` tombstoned duplicates, ``deadletter/`` raw frames
SCHEMA_EXCLUDE_DIRS = ("tmp", "quarantine", "compacted", "deadletter")


def tree_schemas(fs: FileSystem, target_dir: str,
                 extension: str = ".parquet",
                 exclude_dirs: tuple = SCHEMA_EXCLUDE_DIRS,
                 ) -> tuple[dict, list]:
    """Walk one partition tree's published files and collect each one's
    leaf schema: ``(per_file, unreadable)`` where ``per_file`` maps path
    -> the :func:`file_schema` leaf dict and ``unreadable`` lists files
    whose footer could not be parsed (the structural verifier's problem,
    not a schema verdict).  The ONE tree-walk the schema audit and the
    route-level schema guard share — the exclude set and the
    unreadable-file policy cannot diverge between them."""
    target = target_dir.rstrip("/")
    skips = tuple(f"{target}/{d}/" for d in exclude_dirs)
    per_file: dict[str, dict] = {}
    unreadable: list[dict] = []
    try:
        files = fs.list_files(target, extension=extension)
    except FileNotFoundError:
        return per_file, unreadable
    for p in files:
        if any(p.startswith(s) for s in skips):
            continue
        try:
            per_file[p] = file_schema(fs, p)
        except (ValueError, OSError, KeyError) as e:
            unreadable.append({"path": p, "error": repr(e)})
    return per_file, unreadable


def audit_schema_consistency(
        fs: FileSystem, target_dir: str, extension: str = ".parquet",
        exclude_dirs: tuple = SCHEMA_EXCLUDE_DIRS) -> dict:
    """Cross-file schema-consistency audit over one partition tree — the
    schema half of the structural verifier, grown for schema
    evolution (multi-tenant routes write one tree per tenant over a
    proto lineage that changes additively over time):

    * a **conflict** is one dotted leaf path carrying more than one
      physical type across the tree's published files — a merged-schema
      reader (pyarrow dataset schema unification) cannot reconcile
      ``int64`` and ``byte_array`` under one name, so this is the shape
      the route-level schema guard dead-letters and this audit flags;
    * **additive columns** (present in some files, absent in others) are
      the EXPECTED evolution shape — merged reads surface them as nulls
      for the older files — and are reported, never flagged;
    * unreadable/unparsable files are listed separately (they are the
      structural verifier's problem, not a schema verdict).

    Returns ``{"files", "consistent", "conflicts", "additive_columns",
    "by_partition", "unreadable"}`` with each conflict naming the column,
    its observed types, and up to 3 carrier files per type."""
    target = target_dir.rstrip("/")
    per_file, unreadable = tree_schemas(fs, target_dir, extension,
                                        exclude_dirs)
    # column -> physical type -> carrier files
    types: dict[str, dict[int, list]] = {}
    by_partition: dict[str, int] = {}
    for p, leaves in per_file.items():
        rel_dir = p[len(target) + 1:].rsplit("/", 1)
        by_partition[rel_dir[0] if len(rel_dir) == 2 else "."] = (
            by_partition.get(rel_dir[0] if len(rel_dir) == 2 else ".", 0) + 1)
        for col, (pt, _rep, _conv) in leaves.items():
            types.setdefault(col, {}).setdefault(pt, []).append(p)
    conflicts = []
    for col in sorted(types):
        if len(types[col]) > 1:
            conflicts.append({
                "column": col,
                "types": {str(pt): sorted(files)[:3]
                          for pt, files in sorted(types[col].items(),
                                                  key=lambda kv: str(kv[0]))},
            })
    additive = sorted(
        col for col, by_type in types.items()
        if sum(len(f) for f in by_type.values()) < len(per_file))
    return {
        "files": len(per_file),
        "consistent": not conflicts,
        "conflicts": conflicts,
        "additive_columns": additive,
        "by_partition": by_partition,
        "unreadable": unreadable,
    }


def summarize(reports: list[FileReport]) -> dict:
    """Directory-level rollup of many reports: file/row/page totals plus
    the failing paths — the one-call integrity verdict compaction runs
    assert on (``--summary``)."""
    bad = [r for r in reports if not r.ok]
    return {
        "files": len(reports),
        "ok": len(reports) - len(bad),
        "failed": len(bad),
        "rows": sum(r.num_rows or 0 for r in reports if r.ok),
        "row_groups": sum(r.row_groups for r in reports),
        "pages": sum(r.pages for r in reports),
        "pages_crc_checked": sum(r.pages_crc_checked for r in reports),
        # query-readiness counters: how much of the directory a selective
        # reader can prune (pages under a validated page index), how many
        # bloom filters were header-checked, and how many row groups
        # declare a sort order the index stats support
        "pages_indexed": sum(r.pages_indexed for r in reports),
        "column_indexes": sum(r.column_indexes for r in reports),
        "bloom_filters_checked": sum(r.bloom_filters for r in reports),
        "sorted_row_groups": sum(r.sorted_row_groups for r in reports),
        "bytes": sum(r.size for r in reports),
        "failures": [r.path for r in bad],
    }


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    as_json = "--json" in argv
    as_summary = "--summary" in argv
    paths = [a for a in argv if a not in ("--json", "--summary")]
    if not paths:
        print("usage: python -m kpw_tpu_torch.io.verify [--json] [--summary] "
              "<file-or-dir> [...]", file=sys.stderr)
        return 2
    fs = LocalFileSystem()
    reports: list[FileReport] = []
    for p in paths:
        if os.path.isdir(p):
            reports.extend(verify_dir(fs, p))
        else:
            reports.append(verify_file(fs, p))
    if as_summary:
        print(json.dumps(summarize(reports), indent=1))
    elif as_json:
        print(json.dumps([r.to_dict() for r in reports], indent=1))
    else:
        for r in reports:
            if r.ok:
                print(f"OK   {r.path}  rows={r.num_rows} "
                      f"row_groups={r.row_groups} pages={r.pages} "
                      f"crc_checked={r.pages_crc_checked} "
                      f"pages_indexed={r.pages_indexed} "
                      f"bloom_filters={r.bloom_filters}")
            else:
                print(f"FAIL {r.path}")
                for e in r.errors:
                    print(f"     - {e}")
    bad = sum(1 for r in reports if not r.ok)
    print(f"{len(reports) - bad}/{len(reports)} file(s) structurally valid",
          file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
