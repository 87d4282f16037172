"""CudaChunkEncoder — the port's device encoder backend (dictionary slice).

A drop-in for the CPU reference encoder at the pluggable boundary (the
writer calls ``encode``/``encode_many`` or the ``launch_many`` /
``assemble_many`` halves).  Output bytes are identical to
``core.pages.CpuChunkEncoder``; the dictionary path of a row group runs on
the device in two syncs, as ``kpw_tpu/ops/backend.py:TpuChunkEncoder``
does:

- phase A: every eligible column's dictionary build, batched
  (``ops.dictionary.build_dictionaries``);
- sync 1: the unique counts, from which the dictionary-vs-plain decisions
  follow (fixed-width plain size is k * itemsize);
- phase B: every data page's window slice, mask, long-run sum and bit-pack,
  one fused launch per (batch, bucket, width) job
  (``ops.packing.pack_pages_multi``, the CUDA kernel on a card), launched
  for all columns before anything is read;
- sync 2: one bulk readback of the packed pages, run statistics and
  dictionary keys;
- sync 3 (rare): the pages whose long runs need the exact mixed RLE stream
  fetch their index windows (``gather_index_slices``) for host RLE.

Everything else goes through the superclass, the port's
``CpuChunkEncoder``: dictionary columns below ``min_device_rows``, string
columns, and the level, delta and BYTE_STREAM_SPLIT encodings, which the
port does not carry on the device yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import encodings as enc
from ..core.pages import (ColumnChunkData, CpuChunkEncoder, EncoderOptions,
                          PreparedRowGroup)
from ..core.schema import PhysicalType
from ..core.thrift import varint_bytes
from ..device import resolve_device
from ..utils.tracing import stage
from .dictionary import DictBuildHandle, build_dictionaries
from .packing import gather_index_slices, pack_page_host, pack_pages_multi, pad_bucket


def _to_host(tensors: list) -> list:
    """Bring device tensors to the host behind ONE wait: every copy is
    queued (into pinned memory) before the stream is synchronised."""
    cuda = [t for t in tensors if t.is_cuda]
    if not cuda:
        return [t.numpy() for t in tensors]
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    torch.cuda.current_stream(cuda[0].device).synchronize()
    return [h.numpy() for h in host]


class _DeviceIndices:
    """Dictionary indices living on the device; the fused pack reads any
    (start, bucket) page window of them in place."""

    def __init__(self, dev: torch.Tensor, n: int):
        self.dev = dev  # (pad_bucket(n),) int32
        self.n = n
        self._host = None  # lazy host copy for the mixed-RLE fallback

    def host(self) -> np.ndarray:
        if self._host is None:
            self._host = self.dev[: self.n].cpu().numpy().view(np.uint32)
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


class CudaChunkEncoder(CpuChunkEncoder):
    """Byte-identical device implementation of the chunk encoder's
    dictionary path.  ``device="cuda"`` (the default) raises when no card
    is available; ``device="cpu"`` runs the same plan with the plain
    PyTorch versions of the kernels."""

    def __init__(self, options: EncoderOptions, min_device_rows: int = 4096,
                 device="cuda") -> None:
        super().__init__(options)
        self.device = resolve_device(device)
        self.min_device_rows = min_device_rows

    # -- eligibility -------------------------------------------------------
    @staticmethod
    def _fixed_width_ok(values, pt: int) -> bool:
        """Fixed-width numeric columns: the ones whose keys the device build
        takes."""
        return (
            isinstance(values, np.ndarray)
            and values.dtype.kind in "iuf"
            and values.dtype.itemsize in (4, 8)
            and pt not in (PhysicalType.BOOLEAN, PhysicalType.BYTE_ARRAY,
                           PhysicalType.FIXED_LEN_BYTE_ARRAY)
        )

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
        with stage("encode.launch"):
            launched = self._launch_all(chunks, slots)
        return PreparedRowGroup(slots, state=launched)

    def assemble_many(self, chunks: list[ColumnChunkData],
                      prepared: PreparedRowGroup, base_offset: int):
        """Host phase: post-fetch body assembly (``encode.bodies``) and the
        page/blob/stats loop (``encode.assemble``)."""
        launched = prepared.state
        prepared.state = None  # plans are consumed exactly once
        if launched is not None:
            with stage("encode.bodies"):
                self._assemble_bodies(chunks, prepared.pres, *launched)
        with stage("encode.assemble"):
            try:
                return super().assemble_many(chunks, prepared, base_offset)
            finally:
                # keyed by id(chunk) — must not outlive the chunk objects;
                # pop only THIS row group's ranges (the launch thread may
                # already have cached the next group's)
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
        """Phase A, sync 1, phase B and sync 2.  Returns None when no chunk
        is device-eligible, else the argument pack for
        :meth:`_assemble_bodies`."""
        eligible = [
            (i, chunk) for i, chunk in enumerate(chunks)
            if self._dictionary_viable(chunk)
            and self.chooser.dictionary_wanted(chunk.column)
            and self._device_eligible(chunk.values, chunk.column.leaf.physical_type)
        ]
        if not eligible:
            return None
        opts = self.options
        handles = build_dictionaries([chunk.values for _, chunk in eligible],
                                     self.device)
        batches: list = []
        for batch, _ in handles:
            if batch not in batches:
                batches.append(batch)
        for b, kv in zip(batches, _to_host(  # sync 1: unique counts
                [b.counts_device() for b in batches])):
            b._k_host = kv

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
        fetched = _to_host(group_dev + tables_dev)  # sync 2: bulk
        groups_host = list(zip(fetched[0:len(group_dev):2],
                               fetched[1:len(group_dev):2]))
        tables_host = {id(b): t for b, t in
                       zip(table_batches, fetched[len(group_dev):])}
        return col_plans, group_meta, groups_host, tables_host

    def _assemble_bodies(self, chunks, slots, col_plans, group_meta,
                         groups_host, tables_host):
        """Post-fetch host body assembly, including the rare sync-3
        long-run gather; installs (dict_values, _PageBodies) in the slots."""
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
            for rows, sl in zip(fb_meta, _to_host(fb_dev)):
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
