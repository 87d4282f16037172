"""CudaChunkEncoder — the port's device encoder backend.

A drop-in for the CPU reference encoder at the pluggable boundary (the
writer calls ``encode``/``encode_many`` or the ``launch_many`` /
``assemble_many`` halves).  Output bytes are identical to
``core.pages.CpuChunkEncoder``; a row group runs on the device in two
syncs, as ``kpw_tpu/ops/backend.py:TpuChunkEncoder`` does:

- phase A: every rep/def level page's run statistics, each packed in the
  same fused launch, one per (bucket, width) group (``_LevelPlanner``);
  every delta page of a statically delta-encoded column, one launch per
  ring that writes the pages' finished block streams (``_DeltaPlanner``,
  the ``csrc/delta.cu`` kernel on a card); every eligible column's
  dictionary build, batched (``ops.dictionary.build_dictionaries``);
- sync 1: the unique counts and the level statistics, from which the
  dictionary-vs-plain and bit-pack-vs-RLE decisions follow, and the delta
  pages' byte offsets;
- phase B: every dictionary data page's window slice, mask, long-run sum
  and bit-pack, one fused launch per (batch, bucket, width) job
  (``ops.packing.pack_pages_multi``), and the run lists of the run-heavy
  level pages (``ops.levels.level_runs_multi``), launched for all columns
  before anything is read;
- sync 2: one bulk readback of the packed pages, run statistics,
  dictionary keys, level pages and the delta pages' bytes;
- sync 3 (rare): the dictionary pages whose long runs need the exact mixed
  RLE stream fetch their index windows (``gather_index_slices``).

String (BYTE_ARRAY) dictionaries are built on the host by the native C++
hash, after the numeric builds are launched so that the two overlap; their
indices are integers like any other dictionary column's, so their pages
join the fused pack jobs (``_StringDictPlanner``) and sync 2.

The delta pages the planner could not see ahead (dictionary-rejected
columns, adaptive row group 1) go through the device one page at a time
(``_values_body``), and so do BYTE_STREAM_SPLIT pages where the native
assembler does not transpose them inside its own call (codecs it does not
cover, values not in the column's PLAIN dtype).  Everything else goes
through the superclass, the port's C++ host encoder
(``native.encoder.NativeChunkEncoder``), as ``TpuChunkEncoder`` subclasses
the JAX package's: chunks below ``min_device_rows``, the codecs, and page
assembly, which the nogil assembler does one column chunk a call (level
pages from their run tables included).
"""

from __future__ import annotations

import contextlib
import struct

import numpy as np
import torch

from .. import native
from ..core import encodings as enc
from ..core.bytecol import ByteColumn
from ..core.pages import ColumnChunkData, EncoderOptions, PreparedRowGroup
from ..core.schema import Encoding, PhysicalType
from ..core.thrift import varint_bytes
from ..device import resolve_device, to_device, to_host
from ..native.encoder import NativeChunkEncoder
from ..utils.tracing import stage, transfer_counts
from .bss import byte_stream_split_device
from .delta import (check_budget, delta_binary_packed_device, delta_bits_bucket,
                    delta_length_byte_array_device, delta_page_streams,
                    page_parts)
from .dictionary import DictBuildHandle, build_dictionaries
from .levels import level_runs_multi, level_stats_multi
from .packing import gather_index_slices, pack_page_host, pack_pages_multi, pad_bucket


class _DeviceIndices:
    """Dictionary indices living on the device; the fused pack reads any
    (start, bucket) page window of them in place."""

    def __init__(self, dev: torch.Tensor, n: int):
        self.dev = dev  # (pad_bucket(n),) int32
        self.n = n
        self._host = None  # lazy host copy for the mixed-RLE fallback

    def host(self) -> np.ndarray:
        if self._host is None:
            (host,) = to_host([self.dev[: self.n]])
            self._host = host.view(np.uint32)
        return self._host

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, sl):  # CPU-path compatibility (unused in hot path)
        return self.host()[sl]


class _PageBodies:
    """Fully-resolved data-page value bodies for one dictionary column,
    keyed by the page's (va, vb) present-value range.  Stands in for the
    ``indices`` object in encode(): len() is the present-value count the
    dictionary ratio check needs."""

    __slots__ = ("n", "bodies")

    def __init__(self, n: int) -> None:
        self.n = n
        self.bodies: dict[tuple[int, int], object] = {}

    def __len__(self) -> int:
        return self.n


def _trivial_body(width: int, count: int) -> bytes | None:
    """Data-page index body for the no-device-job cases — empty page (just
    the width byte) and width-0 single-value dictionary (one RLE run header,
    no value bytes)."""
    if count == 0:
        return bytes([width])
    if width == 0:
        return bytes([0]) + varint_bytes(count << 1)
    return None


# (width, count) -> the constant pure-bit-pack page prefix
# `width byte + varint((groups << 1) | 1)`, shared by every page of the
# same geometry
_BP_PREFIXES: dict[tuple[int, int], bytes] = {}


def _bitpack_page_prefix(width: int, count: int) -> bytes:
    key = (width, count)
    pre = _BP_PREFIXES.get(key)
    if pre is None:
        if len(_BP_PREFIXES) > 4096:  # page geometries are few; cap anyway
            _BP_PREFIXES.clear()
        groups_n = (count + 7) // 8
        pre = _BP_PREFIXES[key] = (bytes([width])
                                   + varint_bytes((groups_n << 1) | 1))
    return pre


def _hybrid_body(packed_row, long_sum: int, count: int, width: int,
                 idx_fallback):
    """One definition of a data page's index body: the device bit-pack
    bytes when the oracle's RLE-vs-bitpack decision
    (``core.encodings.rle_hybrid_encode``: long-run mass < max(8, n//10))
    says pure bit-pack — as a parts list [shared prefix, packed view], no
    copy — else the exact mixed host RLE over ``idx_fallback()``."""
    if long_sum < max(8, count // 10):
        groups_n = (count + 7) // 8
        return [_bitpack_page_prefix(width, count),
                packed_row[: groups_n * width]]
    return bytes([width]) + enc.rle_hybrid_encode(idx_fallback(), width)


class _LevelPages:
    """One page's planned rep+def level streams as op descriptors —
    ``("raw", part)`` (bytes or a readback view, its v1 length prefix
    already included) and ``("runs", vals u32, lens i32, width)`` (a
    compact run table, for an assembler's RLE-from-runs op).  ``blob()``
    composes the bytes on the host through
    ``core.encodings.rle_hybrid_from_runs``, the page loop's consumer."""

    __slots__ = ("ops", "_blob")

    def __init__(self, ops: list) -> None:
        self.ops = ops
        self._blob: bytes | None = None

    def blob(self) -> bytes:
        if self._blob is None:
            out = []
            for d in self.ops:
                if d[0] == "raw":
                    p = d[1]
                    out.append(p if isinstance(p, bytes)
                               else np.asarray(p).tobytes())
                else:
                    _, rv, rl, width = d
                    payload = enc.rle_hybrid_from_runs(
                        rv.astype(np.uint64), rl, width)
                    out.append(struct.pack("<I", len(payload)) + payload)
            self._blob = b"".join(out)
        return self._blob


class _LevelPlanner:
    """Device encoding of every rep/def level stream of a row group
    (BASELINE config 5), inside the planner's two syncs:

    phase A (joins sync 1): one fused pack launch per (bucket, width) group
    gives every level page's long-run mass (the oracle's bit-pack-vs-mixed
    decision, ``core.encodings.rle_hybrid_encode``), its run count (sizing
    the phase-B extraction) and its bit-packed bytes, which stay on the
    card; sync 2 reads back only the rows of the pages the decision sends
    to bit-packing;
    phase B (joins sync 2): run-heavy pages get their compact run list
    extracted on the device and replayed on the host by the native
    assembler's RLE-from-runs op (``rle_hybrid_from_runs`` in the Python
    page loop), byte-identical by construction; bit-packed pages need no
    second launch.
    """

    def __init__(self, encoder: "CudaChunkEncoder", chunks) -> None:
        streams = []  # level ndarrays, one row of the stacked batch each
        pages = []  # (stream_row, chunk_idx, kind, a, b, width)
        for i, chunk in enumerate(chunks):
            col = chunk.column
            if chunk.num_slots < encoder.min_device_rows:
                continue
            kinds = []
            if col.max_rep > 0:
                kinds.append(("rep", chunk.rep_levels, enc.bit_width(col.max_rep)))
            if col.max_def > 0:
                kinds.append(("def", chunk.def_levels, enc.bit_width(col.max_def)))
            ranges = encoder._slot_ranges(chunk) if kinds else []
            for kind, levels, width in kinds:
                row = len(streams)
                streams.append(np.asarray(levels))
                pages += [(row, i, kind, a, b, width) for a, b in ranges if b > a]
        self.empty = not pages
        self.plans: dict[int, tuple] = {}
        self._chunks = chunks
        self._a_groups = []  # (pages, packed, long_sum, n_runs) on the device
        self._b_groups = []  # (mode, pages, device outputs)
        if self.empty:
            return
        # levels are 1-3 bit values: one uint8 upload (a quarter of int32),
        # widened on the card for the kernels
        stacked = np.zeros((len(streams), max(map(len, streams))), np.uint8)
        for r, s in enumerate(streams):
            stacked[r, : len(s)] = s
        self._dev = to_device(stacked, encoder.device).to(torch.int32)
        # by width as well as bucket: rep and def streams differ in width
        by_key: dict[tuple[int, int], list] = {}
        for page in pages:
            _, _, _, a, b, width = page
            by_key.setdefault((pad_bucket(b - a), width), []).append(page)
        for (bucket, width), rows in by_key.items():
            long_sum, n_runs, packed = level_stats_multi(
                self._dev, [p[0] for p in rows], [p[3] for p in rows],
                [p[4] - p[3] for p in rows], bucket, width)
            self._a_groups.append((rows, packed, long_sum, n_runs))

    def stats_device(self) -> list:
        """Phase A's statistics for sync 1: (long_sum, n_runs) per group."""
        return [t for _, _, long_sum, n_runs in self._a_groups
                for t in (long_sum, n_runs)]

    def launch_phase_b(self, stats_host: list) -> None:
        """Classify pages from phase A's statistics and launch the run
        extraction of the run-heavy ones."""
        slow: dict[int, list] = {}  # bucket -> [(page, n_runs)]
        for g, (rows, packed, _, _) in enumerate(self._a_groups):
            long_h, runs_h = stats_host[2 * g], stats_host[2 * g + 1]
            fast = []
            for r, page in enumerate(rows):
                count = page[4] - page[3]
                if int(long_h[r]) < max(8, count // 10):
                    fast.append((r, page))
                else:
                    slow.setdefault(pad_bucket(count), []).append(
                        (page, int(runs_h[r])))
            if fast:  # phase A already packed them: fetch only their rows
                if len(fast) < len(rows):
                    packed = packed[to_device(
                        np.array([r for r, _ in fast], np.int64), packed.device)]
                self._b_groups.append(("fast", [p for _, p in fast], (packed,)))
        for bucket, entries in slow.items():
            run_bucket = pad_bucket(max(n for _, n in entries))
            runs = level_runs_multi(
                self._dev, [p[0] for p, _ in entries], [p[3] for p, _ in entries],
                [p[4] - p[3] for p, _ in entries], bucket, run_bucket)
            self._b_groups.append(("slow", entries, runs))

    def phase_b_device(self) -> list:
        return [t for _, _, outs in self._b_groups for t in outs]

    def assemble(self, fetched: list) -> None:
        """Fold the fetched outputs into per-(chunk, page) level plans of op
        descriptors: bit-packed pages as [v1 length + bit-pack header,
        packed row view] raw parts, run-heavy pages as their run tables."""
        parts: dict[tuple[int, int, int], dict] = {}  # (i, a, b) -> kind -> ops
        at = 0
        for mode, items, outs in self._b_groups:
            host = fetched[at:at + len(outs)]
            at += len(outs)
            if mode == "fast":
                (packed_h,) = host
                for r, (row, i, kind, a, b, width) in enumerate(items):
                    groups = (b - a + 7) // 8
                    head = varint_bytes((groups << 1) | 1)
                    hdr = struct.pack("<I", len(head) + groups * width) + head
                    parts.setdefault((i, a, b), {})[kind] = [
                        ("raw", hdr), ("raw", packed_h[r, : groups * width])]
            else:
                vals_h, lens_h = host
                for r, ((row, i, kind, a, b, width), n_runs) in enumerate(items):
                    parts.setdefault((i, a, b), {})[kind] = [
                        ("runs",
                         np.ascontiguousarray(vals_h[r, :n_runs], np.uint32),
                         np.ascontiguousarray(lens_h[r, :n_runs], np.int32),
                         width)]
        for (i, a, b), kinds in parts.items():
            chunk = self._chunks[i]
            col = chunk.column
            ops: list = []
            for kind, max_level in (("rep", col.max_rep), ("def", col.max_def)):
                if max_level > 0:
                    ops.extend(kinds[kind])
            # entries carry the chunk itself so a consumer can identity-check
            # against id() reuse
            self.plans.setdefault(id(chunk), (chunk, {}))[1][(a, b)] = \
                _LevelPages(ops)


class _StringDictPlanner:
    """Byte-array dictionary columns in the row-group batch: the dictionary
    itself builds on the host (the native C++ hash; variable-length bytes
    have no device build on the encoder path), but the indices are integers
    like any other dictionary column's, so their pages join the planner's
    fused pack jobs instead of being encoded page by page on the host."""

    def __init__(self, encoder: "CudaChunkEncoder", chunks) -> None:
        self._items = []  # (i, chunk, dict_values, idx, width, pages)
        self._rejected = []  # (i, dict_values, idx): budget-rejected builds
        self._groups = []  # (rows, width, (packed, long_sum) on the device)
        opts = encoder.options
        self.empty = True
        if encoder._lib is None or not opts.enable_dictionary:
            return
        for i, chunk in enumerate(chunks):
            pt = chunk.column.leaf.physical_type
            values = chunk.values
            if (not encoder._dictionary_viable(chunk)
                    or not encoder.chooser.dictionary_wanted(chunk.column)
                    or not encoder._bytes_native_ok(values, pt)
                    or len(values) < encoder.min_device_rows):
                continue
            n = len(values)
            max_k = max(1, int(n * opts.max_dictionary_ratio))
            built = encoder._bytes_dictionary(values, max_k)
            if built is None:
                continue  # ratio abort: encode() re-derives it cheaply
            dict_values, idx = built
            k = len(dict_values)
            plain_len = sum(map(len, dict_values))
            if pt == PhysicalType.BYTE_ARRAY:
                plain_len += 4 * k  # FLBA PLAIN has no length prefixes
            if plain_len > opts.dictionary_page_size_limit:
                # byte-budget rejection: the built dictionary goes through
                # the slot, so encode() re-derives the rejection without a
                # second build
                self._rejected.append((i, dict_values, idx))
                continue
            width = enc.bit_width(max(k - 1, 0))
            pages = encoder._page_value_ranges(chunk)
            self._items.append((i, chunk, dict_values, idx, width, pages))
        self.empty = not self._items and not self._rejected
        if not self._items:
            return
        # one upload of the stacked uint32 indices, as int32 bit patterns
        stacked = np.zeros((len(self._items), max(len(t[3]) for t in self._items)),
                           np.uint32)
        for r, (_, _, _, idx, _, _) in enumerate(self._items):
            stacked[r, : len(idx)] = idx
        dev = to_device(stacked.view(np.int32), encoder.device)
        by_key: dict[tuple[int, int], list] = {}
        for r, (_, _, _, _, width, pages) in enumerate(self._items):
            if width == 0:
                continue  # single-value dictionaries have no packed body
            for va, vb in pages:
                if vb > va:
                    by_key.setdefault((pad_bucket(vb - va), width), []).append(
                        (r, va, vb))
        for (bucket, width), rows in by_key.items():
            outs = pack_pages_multi(dev, [r for r, _, _ in rows],
                                    [va for _, va, _ in rows],
                                    [vb - va for _, va, vb in rows], bucket, width)
            self._groups.append((rows, width, outs))

    def device_outputs(self) -> list:
        return [t for _, _, outs in self._groups for t in outs]

    def fill_slots(self, fetched: list, slots) -> None:
        """Assemble the page bodies (the device bit-pack, or the exact host
        RLE over the host-resident indices for long-run pages) and install
        (dict_values, _PageBodies) in the planner slots; budget-rejected
        builds go through their slots as they are."""
        for i, dict_values, idx in self._rejected:
            slots[i] = (dict_values, idx)  # encode() re-derives the rejection
        bodies: dict[int, _PageBodies] = {}
        for r, (i, chunk, dict_values, idx, width, pages) in enumerate(self._items):
            pb = bodies[r] = _PageBodies(len(idx))
            for va, vb in pages:  # width-0 / empty pages have no device job
                body = _trivial_body(width, vb - va)
                if body is not None:
                    pb.bodies[(va, vb)] = body
            slots[i] = (dict_values, pb)
        for g, (rows, width, _) in enumerate(self._groups):
            packed_h, long_h = fetched[2 * g], fetched[2 * g + 1]
            longs = long_h.tolist()
            for row, (r, va, vb) in enumerate(rows):
                bodies[r].bodies[(va, vb)] = _hybrid_body(
                    packed_h[row], longs[row], vb - va, width,
                    lambda r=r, va=va, vb=vb: self._items[r][3][va:vb])


class _DeltaPlanner:
    """Batched device delta encoding of a row group's non-dictionary pages
    (BASELINE config 3): one ``delta_page_streams`` launch per ring with
    pages (at most two a row group), in phase A.  Each launch writes the
    finished block stream of every page of its ring back to back, so a
    page is its header (known on the host) and a view of the readback.

    Covers chunks whose encoding is known before the row group is encoded
    (dictionary disabled or not wanted, decision pinned or forced):
    INT32/INT64 columns pack their values, byte-array columns the length
    vector of DELTA_LENGTH_BYTE_ARRAY, whose page is then [header, length
    stream view, payload view] with no copy of the payload.

    Readback: each launch's page offsets and width flag join sync 1, so
    that sync 2 copies exactly the bytes written (as fast as copying the
    whole output capacity at sync 2, measured on the H100, with a fifth of
    the bytes)."""

    def __init__(self, encoder: "CudaChunkEncoder", chunks) -> None:
        # id(chunk) -> (chunk, {(va, vb): page parts})
        self.plans: dict[int, tuple] = {}
        self._jobs = []  # (ring row, chunk, bit_size, pages)
        self._launches = []  # (ring, items, max_bits, (out, offsets, over))
        self._fetch: list = []  # sync 2's tensors: the bytes written
        self._offsets: list = []  # host offsets per launch
        self.empty = True
        opts = encoder.options
        if not (opts.delta_fallback or opts.adaptive_encodings or opts.encodings):
            return  # every column resolves to PLAIN: nothing here
        streams = {32: [], 64: []}  # ring -> value streams in the ring's type
        for chunk in chunks:
            col = chunk.column
            if (encoder._dictionary_viable(chunk)
                    and encoder.chooser.dictionary_wanted(col)):
                continue  # dictionary path (or rejected later: per-page route)
            pt = col.leaf.physical_type
            if encoder.chooser.peek(col) is None:
                # adaptive and not yet pinned: decided inside encode() from
                # row group 1, which may not have run yet; the per-page
                # route covers it
                continue
            enc_kind = encoder._fallback_encoding(pt, col)
            values = chunk.values
            if len(values) < encoder.min_device_rows:
                continue
            if (enc_kind == Encoding.DELTA_BINARY_PACKED
                    and isinstance(values, np.ndarray)):
                bit_size = 32 if pt == PhysicalType.INT32 else 64
                # the ring's type, as the oracle casts: an int32 array in an
                # INT64 column sign-extends
                stream = np.ascontiguousarray(
                    values, np.int32 if bit_size == 32 else np.int64)
            elif (enc_kind == Encoding.DELTA_LENGTH_BYTE_ARRAY
                  and isinstance(values, ByteColumn)):
                stream = np.ascontiguousarray(values.lens(), np.int32)
                bit_size = 32  # lengths ride the 32-bit ring per the spec
            else:
                continue
            pages = [(va, vb) for va, vb in encoder._page_value_ranges(chunk)
                     if vb - va >= 2]
            if pages:
                self._jobs.append((len(streams[bit_size]), chunk, bit_size, pages))
                streams[bit_size].append(stream)
        self.empty = not self._jobs
        if self.empty:
            return
        self._streams = streams
        dev = {}
        for ring, rows in streams.items():
            if rows:
                stacked = np.zeros((len(rows), max(map(len, rows))),
                                   np.int32 if ring == 32 else np.int64)
                for r, s in enumerate(rows):
                    stacked[r, : len(s)] = s
                dev[ring] = to_device(stacked, encoder.device)
        # the host-known value range of each stream bounds its miniblock
        # widths, and so the output a block needs
        row_bits = {(ring, r): delta_bits_bucket(
            int(s.max()) - int(s.min()) if len(s) else 0, ring)
            for ring, rows in streams.items() for r, s in enumerate(rows)}
        by_ring: dict[int, list] = {}
        for row, chunk, bit_size, pages in self._jobs:
            by_ring.setdefault(bit_size, []).extend(
                (row, chunk, va, vb) for va, vb in pages)
        for ring, items in by_ring.items():
            # the launch's budget is its widest stream's
            max_bits = max(row_bits[ring, row] for row, _, _, _ in items)
            table = np.array([(row, va, vb - va) for row, _, va, vb in items],
                             np.int64)
            outs = delta_page_streams(dev[ring], table, ring, max_bits)
            self._launches.append((ring, items, max_bits, outs))

    def sync1_device(self) -> list:
        """Each launch's offsets and width flag, for sync 1."""
        return [t for *_, (_, offsets, over) in self._launches
                for t in (offsets, over)]

    def after_sync1(self, host: list) -> None:
        """Refuse a launch whose width bound was wrong, and cut each
        launch's output to the bytes written for sync 2."""
        for g, (_, _, max_bits, (out, _, _)) in enumerate(self._launches):
            offsets, over = host[2 * g], host[2 * g + 1]
            check_budget(over, max_bits)
            self._offsets.append(offsets)
            self._fetch.append(out[:int(offsets[-1])])

    def device_outputs(self) -> list:
        return self._fetch

    def assemble(self, fetched: list) -> None:
        """Every planned page as parts: [header, view of its block stream]
        (and the payload view of a DELTA_LENGTH_BYTE_ARRAY page)."""
        for g, (ring, items, _, _) in enumerate(self._launches):
            out_h = fetched[g]
            offs = self._offsets[g].tolist()
            rows = self._streams[ring]
            for p, (row, chunk, va, vb) in enumerate(items):
                parts = page_parts(rows[row][va], vb - va, out_h, offs[p],
                                   offs[p + 1])
                values = chunk.values
                if isinstance(values, ByteColumn):
                    o = values.offsets
                    parts.append(memoryview(values.data)[int(o[va]):int(o[vb])])
                self.plans.setdefault(id(chunk), (chunk, {}))[1][(va, vb)] = parts


class CudaChunkEncoder(NativeChunkEncoder):
    """Byte-identical device implementation of the chunk encoder.
    ``device="cuda"`` (the default) raises when no card is available;
    ``device="cpu"`` runs the same plan with the plain PyTorch versions of
    the kernels.  Either way it raises when the port's native library or
    assembler did not build: the host work it leaves to the superclass must
    not fall back to the Python page loops.

    On the card each encoder has a stream of its own, and its uploads,
    launches and readbacks run on it: several writer workers, each with
    its encoder, then neither queue behind each other's work nor wait on
    it at a readback."""

    def __init__(self, options: EncoderOptions, min_device_rows: int = 4096,
                 device="cuda") -> None:
        self.device = resolve_device(device)
        if native.lib() is None or native.assemble() is None:
            raise RuntimeError(
                "CudaChunkEncoder needs the port's native library and assembler "
                f"(kpw_tpu_torch/native), which did not build: {native.errors}")
        super().__init__(options)
        self.min_device_rows = min_device_rows
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def _on_stream(self):
        """The context that makes this encoder's stream current in the
        calling thread (nothing on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def encode(self, chunk: ColumnChunkData, base_offset: int, pre=None):
        with self._on_stream():
            return super().encode(chunk, base_offset, pre)

    # -- eligibility -------------------------------------------------------
    def _device_eligible(self, values, pt: int) -> bool:
        return (self._fixed_width_ok(values, pt)
                and len(values) >= self.min_device_rows)

    # -- split row-group encode (pipelined via launch_many/assemble_many) --
    # encode_many itself is inherited (launch + assemble inline).  The
    # writer's overlapped pipeline calls the halves from different threads:
    # row group N+1's launch_many (device work + the two bulk readbacks)
    # runs while row group N is still in assemble_many (host page building).

    split_launch_overlaps = True  # launch = real device work (see base)

    def launch_many(self, chunks: list[ColumnChunkData]) -> PreparedRowGroup:
        """Device phase only: the planner's launches and the bulk readbacks.
        All results travel in the handle — nothing lands on ``self``, so a
        concurrent assemble_many of the PREVIOUS row group never sees this
        one's state."""
        slots: list = [None] * len(chunks)
        with stage("encode.launch"), self._on_stream():
            launched = self._launch_all(chunks, slots)
        return PreparedRowGroup(slots, state=launched)

    def assemble_many(self, chunks: list[ColumnChunkData],
                      prepared: PreparedRowGroup, base_offset: int):
        """Host phase: post-fetch body assembly (``encode.bodies``) and the
        page/blob/stats loop (``encode.assemble``)."""
        launched = prepared.state
        prepared.state = None  # plans are consumed exactly once
        if launched is not None:
            with stage("encode.bodies"), self._on_stream():
                self._assemble_bodies(chunks, prepared.pres, *launched)
        with stage("encode.assemble"):
            try:
                return super().assemble_many(chunks, prepared, base_offset)
            finally:
                # keyed by id(chunk) — must not outlive the chunk objects;
                # pop only THIS row group's ranges (the launch thread may
                # already have cached the next group's)
                self._level_plans = {}
                self._delta_plans = {}
                cache = getattr(self, "_ranges_cache", None)
                if cache:
                    for c in chunks:
                        cache.pop(id(c), None)

    def _slot_ranges(self, chunk: ColumnChunkData) -> list[tuple[int, int]]:
        cache = getattr(self, "_ranges_cache", None)
        if cache is None:
            cache = self._ranges_cache = {}
        hit = cache.get(id(chunk))
        if hit is not None and hit[0] is chunk:  # guard against id() reuse
            return hit[1]
        if len(cache) > 1024:  # direct encode() callers never clear
            cache.clear()
        ranges = super()._slot_ranges(chunk)
        cache[id(chunk)] = (chunk, ranges)
        return ranges

    def _page_value_ranges(self, chunk: ColumnChunkData) -> list[tuple[int, int]]:
        """The (va, vb) present-value range of every data page, mirroring
        the slot->value mapping in CpuChunkEncoder.encode exactly (page
        bodies are keyed by these ranges at assembly time)."""
        col = chunk.column
        def_levels = chunk.def_levels
        if def_levels is not None:
            present = np.asarray(def_levels) == col.max_def
            value_offsets = np.concatenate([[0], np.cumsum(present)])
        out = []
        for a, b in self._slot_ranges(chunk):
            if def_levels is not None:
                out.append((int(value_offsets[a]), int(value_offsets[b])))
            else:
                out.append((a, b))
        return out

    def _launch_all(self, chunks, slots):
        """Phase A, sync 1, phase B and sync 2.  Returns None when nothing
        is device-eligible, else the argument pack for
        :meth:`_assemble_bodies`.  While a traced span counts transfers,
        ``device_ms`` joins its counts: the stream's time from before the
        first device operation to the end of sync 2, when the stream is
        idle, so that the wait on the end event returns at once."""
        counts = transfer_counts()
        timing = None
        if counts is not None and self.stream is not None:
            timing = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            timing[0].record(self.stream)
        lvl = _LevelPlanner(self, chunks)  # phase A launched here
        dlt = _DeltaPlanner(self, chunks)  # delta pages launched here
        eligible = [
            (i, chunk) for i, chunk in enumerate(chunks)
            if self._dictionary_viable(chunk)
            and self.chooser.dictionary_wanted(chunk.column)
            and self._device_eligible(chunk.values, chunk.column.leaf.physical_type)
        ]
        opts = self.options
        handles = (build_dictionaries([chunk.values for _, chunk in eligible],
                                      self.device) if eligible else [])
        # after the numeric launches, so that the host string hashing
        # overlaps the device dictionary builds
        sdp = _StringDictPlanner(self, chunks)
        if not eligible and lvl.empty and dlt.empty and sdp.empty:
            return None
        batches: list = []
        for batch, _ in handles:
            if batch not in batches:
                batches.append(batch)
        lvl_stats = lvl.stats_device()
        fetched = to_host(  # sync 1: unique counts, level stats, delta offsets
            [b.counts_device() for b in batches] + lvl_stats + dlt.sync1_device())
        for b, kv in zip(batches, fetched):
            b._k_host = kv
        at = len(batches) + len(lvl_stats)
        if not lvl.empty:
            lvl.launch_phase_b(fetched[len(batches):at])
        dlt.after_sync1(fetched[at:])

        col_plans = []
        jobs: dict = {}  # (batch_id, bucket, width) -> (batch, [page rows])
        accepted_kmax: dict = {}
        for (i, chunk), (batch, j) in zip(eligible, handles):
            k = int(batch.unique_counts()[j])
            n = len(chunk.values)
            itemsize = chunk.values.dtype.itemsize
            ok_ratio = k <= max(1, int(n * opts.max_dictionary_ratio))
            will = ok_ratio and k * itemsize <= opts.dictionary_page_size_limit
            width = enc.bit_width(max(k - 1, 0))
            pages = self._page_value_ranges(chunk)
            col_plans.append((i, chunk, batch, j, k, width, will, pages))
            if will:
                accepted_kmax[id(batch)] = max(accepted_kmax.get(id(batch), 1), k)
                if width > 0:
                    for va, vb in pages:
                        count = vb - va
                        if count <= 0:
                            continue
                        bucket = pad_bucket(count)
                        jobs.setdefault((id(batch), bucket, width),
                                        (batch, []))[1].append((i, j, va, vb, count))

        group_meta = []
        group_dev = []
        for (_, bucket, width), (batch, rows) in jobs.items():
            packed, long_sum = pack_pages_multi(
                batch.indices, [r[1] for r in rows], [r[2] for r in rows],
                [r[4] for r in rows], bucket, width)
            group_meta.append((rows, width, batch))
            group_dev += [packed, long_sum]
        table_batches = [b for b in batches if id(b) in accepted_kmax]
        tables_dev = [b.key_tables_device(pad_bucket(accepted_kmax[id(b)]))
                      for b in table_batches]
        lvl_dev = lvl.phase_b_device() if not lvl.empty else []
        dlt_dev = dlt.device_outputs()
        sdp_dev = sdp.device_outputs()
        fetched = to_host(  # sync 2
            group_dev + tables_dev + lvl_dev + dlt_dev + sdp_dev)
        if timing is not None:
            # after sync 2 even when it read nothing back from the card
            # (every dictionary rejected, no level, delta or string pages)
            timing[1].record(self.stream)
            timing[1].synchronize()
            counts["device_ms"] = timing[0].elapsed_time(timing[1])
        groups_host = list(zip(fetched[0:len(group_dev):2],
                               fetched[1:len(group_dev):2]))
        at = len(group_dev)
        tables_host = {id(b): t for b, t in
                       zip(table_batches, fetched[at:at + len(tables_dev)])}
        at += len(tables_dev)
        lvl_host = fetched[at:at + len(lvl_dev)]
        at += len(lvl_dev)
        dlt_host = fetched[at:at + len(dlt_dev)]
        sdp_host = fetched[at + len(dlt_dev):]
        return (lvl, dlt, sdp, col_plans, group_meta, groups_host, tables_host,
                lvl_host, dlt_host, sdp_host)

    def _assemble_bodies(self, chunks, slots, lvl, dlt, sdp, col_plans,
                         group_meta, groups_host, tables_host, lvl_host,
                         dlt_host, sdp_host):
        """Post-fetch host body assembly, including the rare sync-3
        long-run gather: installs the level and delta plans for this row
        group's ``encode`` calls and (dict_values, _PageBodies) in the
        slots, string dictionaries' included."""
        if not lvl.empty:
            lvl.assemble(lvl_host)
            self._level_plans = lvl.plans
        if not dlt.empty:
            dlt.assemble(dlt_host)
            self._delta_plans = dlt.plans
        if not sdp.empty:
            sdp.fill_slots(sdp_host, slots)
        bodies_by_slot: dict[int, _PageBodies] = {}

        def bodies_for(i: int, n: int) -> _PageBodies:
            pb = bodies_by_slot.get(i)
            if pb is None:
                pb = bodies_by_slot[i] = _PageBodies(n)
            return pb

        fallback: dict = {}  # batch_id -> (batch, [(i, j, va, vb, count, width)])
        for (rows, width, batch), (packed_h, long_h) in zip(group_meta, groups_host):
            longs = long_h.tolist()  # one bulk convert, not per-page int()
            for row, (i, j, va, vb, count) in enumerate(rows):
                # oracle decision (core.encodings.rle_hybrid_encode): pure
                # bit-pack unless long-run mass reaches max(8, n // 10)
                if longs[row] < max(8, count // 10):
                    groups_n = (count + 7) // 8
                    # parts list: shared prefix + zero-copy packed view; the
                    # view pins the padded readback until the row group is
                    # written
                    body = [_bitpack_page_prefix(width, count),
                            packed_h[row, : groups_n * width]]
                    bodies_for(i, len(chunks[i].values)).bodies[(va, vb)] = body
                else:
                    fallback.setdefault(id(batch), (batch, []))[1].append(
                        (i, j, va, vb, count, width))

        if fallback:  # sync 3 (rare): long-run pages need exact host RLE
            fb_dev = []
            fb_meta = []
            for batch, rows in fallback.values():
                bucket = pad_bucket(max(r[4] for r in rows))
                fb_dev.append(gather_index_slices(
                    batch.indices, [r[1] for r in rows], [r[2] for r in rows],
                    bucket))
                fb_meta.append(rows)
            for rows, sl in zip(fb_meta, to_host(fb_dev)):
                sl = sl.view(np.uint32)
                for row, (i, j, va, vb, count, width) in enumerate(rows):
                    body = bytes([width]) + enc.rle_hybrid_encode(
                        sl[row, :count], width)
                    bodies_for(i, len(chunks[i].values)).bodies[(va, vb)] = body

        for i, chunk, batch, j, k, width, will, pages in col_plans:
            pb = bodies_for(i, len(chunk.values))
            if will:
                dict_values = batch.values_from_tables(j, k, tables_host[id(batch)])
                for va, vb in pages:  # width-0 / empty pages have no device job
                    body = _trivial_body(width, vb - va)
                    if body is not None:
                        pb.bodies.setdefault((va, vb), body)
            else:
                # Rejected dictionary: encode() only needs len()/dtype to
                # re-derive the rejection, so skip the key-table transfer.
                dict_values = np.zeros(k, chunk.values.dtype)
            slots[i] = (dict_values, pb)
        return slots

    # -- primitive overrides ----------------------------------------------
    def _values_body(self, values, pt: int, encoding: int) -> bytes:
        """Delta and BYTE_STREAM_SPLIT bodies of large chunks on the device,
        one page at a time: the route of pages the planner could not see
        ahead (dictionary-rejected columns, adaptive row group 1); small
        chunks and everything else take the host path."""
        if len(values) >= self.min_device_rows:
            if (encoding == Encoding.DELTA_BINARY_PACKED
                    and isinstance(values, np.ndarray)):
                bit_size = 32 if pt == PhysicalType.INT32 else 64
                return delta_binary_packed_device(values, bit_size, self.device)
            if encoding == Encoding.DELTA_LENGTH_BYTE_ARRAY:
                return delta_length_byte_array_device(values, self.device)
            if (encoding == Encoding.BYTE_STREAM_SPLIT
                    and pt in enc._PLAIN_DTYPES):
                # the PLAIN dtype first, as the host route: the transpose
                # must see the on-wire value bytes
                return byte_stream_split_device(
                    np.ascontiguousarray(values, enc._PLAIN_DTYPES[pt]),
                    self.device)
        return super()._values_body(values, pt, encoding)

    @staticmethod
    def _plan_entry(plans, chunk, key):
        """The one id()-keyed plan lookup, with its identity re-check."""
        if plans:
            hit = plans.get(id(chunk))
            if hit is not None and hit[0] is chunk:  # guard against id() reuse
                return hit[1].get(key)
        return None

    def _planned_parts(self, chunk, va: int, vb: int) -> list | None:
        """The delta planner's parts of page (va, vb), or None."""
        return self._plan_entry(getattr(self, "_delta_plans", None), chunk,
                                (va, vb))

    def _values_page_body(self, chunk, va: int, vb: int, pt: int,
                          encoding: int) -> bytes:
        """The planner's delta page joined, else the per-page route."""
        parts = self._planned_parts(chunk, va, vb)
        if parts is not None:
            return b"".join(parts)
        return super()._values_page_body(chunk, va, vb, pt, encoding)

    def _values_page_parts(self, chunk, va: int, vb: int, pt: int,
                           encoding: int) -> list:
        """Planned pages first, as their parts (a fresh list: callers
        insert the level blob in front): without this, the native
        superclass's DELTA_LENGTH_BYTE_ARRAY parts route would re-encode on
        the host what the device plan already produced."""
        parts = self._planned_parts(chunk, va, vb)
        if parts is not None:
            return list(parts)
        return super()._values_page_parts(chunk, va, vb, pt, encoding)

    def _planned_level_entry(self, chunk, a: int, b: int):
        """The planner's :class:`_LevelPages` entry for slots [a, b), or
        None."""
        return self._plan_entry(getattr(self, "_level_plans", None), chunk,
                                (a, b))

    def _planned_levels_blob(self, chunk, a: int, b: int) -> bytes | None:
        entry = self._planned_level_entry(chunk, a, b)
        return entry.blob() if entry is not None else None

    def _planned_level_ops(self, chunk, a: int, b: int) -> list | None:
        entry = self._planned_level_entry(chunk, a, b)
        return entry.ops if entry is not None else None

    def _levels_page_blob(self, chunk, a: int, b: int) -> bytes:
        body = self._planned_levels_blob(chunk, a, b)
        if body is not None:
            return body
        return super()._levels_page_blob(chunk, a, b)

    def _dictionary_build(self, values, pt: int):
        if not self._device_eligible(values, pt):
            return super()._dictionary_build(values, pt)
        handle = DictBuildHandle(values, self.device)
        dict_values, indices_dev = handle.result()
        return dict_values, _DeviceIndices(indices_dev, handle.n)

    def _indices_body(self, indices, va: int, vb: int, dict_size: int):
        if isinstance(indices, _PageBodies):
            body = indices.bodies.get((va, vb))
            if body is None:
                raise RuntimeError(
                    f"page ({va},{vb}) missing from row-group plan — page "
                    "geometry drifted between planning and assembly")
            return body
        if not isinstance(indices, _DeviceIndices):
            return super()._indices_body(indices, va, vb, dict_size)
        width = enc.bit_width(max(dict_size - 1, 0))
        count = vb - va
        trivial = _trivial_body(width, count)
        if trivial is not None:
            return trivial
        bucket = pad_bucket(count)
        packed, long_sum, _ = pack_page_host(indices.dev, va, count, width,
                                             bucket)
        return _hybrid_body(packed, long_sum, count, width,
                            lambda: indices.host()[va:vb])
