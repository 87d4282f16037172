"""Mesh-global encoder backend: the multi-shard encode path, reachable from
the writer runtime.

The reference scales out with one consumer-group instance per host
(KafkaProtoParquetWriter.java:72-76), so records from different Kafka
partitions always land in different files.  Here partitions instead SHARE
a row group (SURVEY §2.4 / BASELINE config 4): a row batch is split over
the shards of a :class:`~.mesh.ShardMesh` and every eligible column's
dictionary is built mesh-globally — for a bounded integer column, one psum
of per-shard histograms (the hist and rank kernels, once per shard); for
any other fixed-width column, per-shard sort-unique, an ``all_gather`` of
the unique sets, a merged sort-unique and each shard's rows ranked against
the merged dictionary (parallel/dict_merge.py).  The gathered or summed
payload is, on this port, a device-to-device copy when the shards share a
card or sit on the cards of one process, and a gloo or NCCL transfer when
the mesh spans processes — what ``ici_stats`` and ``route_log`` count
under the JAX package's key names.

The merged dictionary is the ascending-bit-pattern unique set of ALL rows —
exactly what every single-device builder produces — so with the default
(adaptive) shard capacity, files written through this backend are
byte-identical to the cpu/native/cuda backends (an explicit undersized
``cap`` trades identity for payload, see class docstring).  Page assembly,
levels, non-dictionary encodings, strings and compression ride the native
host path unchanged.

Select with ``Builder.encoder_backend(MeshChunkEncoder(options))`` or the
string ``"mesh"`` (runtime/select.py); ``"auto"`` never picks it —
sharing row groups across partitions is a topology decision, not a
link-speed one.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import numpy as np
import torch

from ..native.encoder import NativeChunkEncoder
from .dict_merge import DictionaryOverflow, global_dictionary_encode
from .mesh import make_mesh

# One collective launch at a time, process-wide: multiple writer workers
# (thread_count > 1) each own a MeshChunkEncoder, and concurrent
# multi-device dispatch from different host threads can interleave
# collective enqueue order across devices — a deadlock class between
# processes (every rank must enter the same collectives in the same
# order).  Passed INTO the merges so it covers only the device section
# (uploads + the shards' launches + collectives + readback); each worker's
# host-side key splitting, shard padding, and index reassembly run
# outside it and overlap freely.
_DISPATCH_LOCK = threading.Lock()


class MeshChunkEncoder(NativeChunkEncoder):
    """Chunk encoder whose dictionary build runs mesh-globally on device.

    ``mesh`` defaults to ``make_mesh(device=device)``: one shard per
    visible card (raises without one), or one CPU shard with
    ``device="cpu"``.  ``cap`` bounds each shard's local unique capacity
    (the gather payload is ``n_shards * cap`` keys).  The default (None)
    lets ``global_dictionary_encode`` size it to the padded per-shard row
    block — a shard can never hold more uniques than rows, so overflow is
    impossible and byte-identity with the host backends holds
    unconditionally.  Passing an explicit ``cap`` trades that guarantee
    for a smaller payload: a column whose per-shard cardinality overflows
    it falls back to plain/delta (which the host backends may not do for
    the same column).

    On cards each encoder has a CUDA stream of its own on every device of
    its mesh, and its uploads, launches and readbacks run on them, as
    ``CudaChunkEncoder``'s do."""

    def __init__(self, options, mesh=None, cap: int | None = None,
                 device="cuda") -> None:
        super().__init__(options)
        self.mesh = mesh if mesh is not None else make_mesh(device=device)
        self.cap = cap
        self._streams = [torch.cuda.Stream(d) for d in self.mesh.distinct_devices()
                         if d.type == "cuda"]
        # Cumulative payload accounting (filled by the merges: gathered
        # bytes, max cardinality, gather capacity, column count; the
        # bounded route's psum bytes)
        self.ici_stats: dict = {}
        # String-dictionary merge accounting (per-shard host hash + sorted
        # union): exchanged payload bytes, global/local cardinalities, wall
        # time.
        self.string_stats: dict = {}
        # Per-column routing record: which merge each dictionary column
        # actually rode, with its payload.  Bounded: a shared long-lived
        # encoder appends one entry per dict column per row group, so an
        # unbounded list would leak on a streaming writer.
        self.route_log: collections.deque = collections.deque(maxlen=512)
        # Workers can SHARE one encoder instance (runtime/writer.py passes
        # the same backend object to every worker): stats accumulate from
        # per-call local dicts under this lock, never by unlocked
        # read-modify-writes on the shared dicts.
        self._stats_lock = threading.Lock()

    def _on_streams(self):
        """The context that makes this encoder's streams current in the
        calling thread (nothing on the CPU)."""
        stack = contextlib.ExitStack()
        for s in self._streams:
            stack.enter_context(torch.cuda.stream(s))
        return stack

    def _merge_stats(self, col_stats: dict) -> None:
        with self._stats_lock:
            for k, v in col_stats.items():
                if k in ("k_max", "gather_cap", "bounded_nhi_max"):
                    self.ici_stats[k] = max(self.ici_stats.get(k, 0), v)
                else:  # byte/column counters sum
                    self.ici_stats[k] = self.ici_stats.get(k, 0) + v

    def _merge_string_stats(self, col_stats: dict) -> None:
        """string_stats counterpart of :meth:`_merge_stats`: per-call
        locals merge under the lock — a shared multi-worker encoder must
        never read-modify-write the shared dict unlocked, or concurrent
        BYTE_ARRAY encodes drop counter updates."""
        with self._stats_lock:
            for k, v in col_stats.items():
                if k in ("k_global_max", "k_local_max"):
                    self.string_stats[k] = max(self.string_stats.get(k, 0), v)
                elif k == "merge_ms":
                    self.string_stats[k] = round(
                        self.string_stats.get(k, 0.0) + v, 3)
                else:  # column/byte counters sum
                    self.string_stats[k] = self.string_stats.get(k, 0) + v

    def _mesh_string_dictionary(self, values, max_k: int | None):
        """Byte-array dictionary built the way a mesh over hosts would:
        each shard hashes ITS rows locally (the GIL-releasing C++ hash,
        native/src/encode.cc), the shards' sorted unique sets merge by
        k-way union, and each shard's local indices remap through a
        per-shard lookup table.  Exactly the two-phase numeric merge's
        shape with the collective replaced by a host exchange — only the
        per-shard UNIQUE payload crosses, recorded in ``string_stats``.
        Output (ascending bytes) is byte-identical to the single-hash
        native build.

        Returns None on ratio overflow (counted in
        ``self.string_stats['overflow_columns']`` so callers can tell abort
        from ineligibility, mirroring ``_bytes_dictionary``'s contract).
        A shard whose LOCAL unique count already exceeds max_k aborts
        inside the C++ hash (local k is a lower bound on global k), and
        the k-way union bails as soon as the running merge crosses max_k —
        an overflowing column never pays a full Python-level merge."""
        import heapq
        import time as _time

        from ..core.bytecol import ByteColumn

        n_shards = self.mesh.size
        if n_shards == 1:
            # nothing to merge on a 1-shard mesh — the single C++ hash
            # build IS the per-shard step, with no remap/union overhead
            return self._bytes_dictionary(values, max_k)
        t0 = _time.perf_counter()
        if not isinstance(values, ByteColumn):
            values = ByteColumn.from_list(values)
        data, offsets = values.data, values.offsets
        n = len(values)
        rows_per = max((n + n_shards - 1) // n_shards, 1)
        shard_uniqs: list[list[bytes]] = []
        shard_idx: list = []
        bounds: list[tuple[int, int]] = []
        exchanged = 0
        overflow = False
        for s in range(n_shards):
            a = min(s * rows_per, n)
            b = min(a + rows_per, n)
            bounds.append((a, b))
            if b == a:
                shard_uniqs.append([])
                shard_idx.append(None)
                continue
            built = self._lib.dict_build_bytes(data, offsets[a:b + 1], max_k)
            if built is None:  # local k > max_k => global k > max_k
                overflow = True
                break
            uniq_pos, idx = built  # ascending lexicographic within the shard
            uniqs = values.take(uniq_pos + a)
            shard_uniqs.append(uniqs)
            shard_idx.append(idx)
            exchanged += sum(map(len, uniqs)) + 4 * len(uniqs)
        # k-way sorted union -> the global ascending dictionary (the oracle
        # order, core.encodings.dictionary_build)
        merged: list[bytes] = []
        if not overflow:
            for v in heapq.merge(*shard_uniqs):
                if not merged or v != merged[-1]:
                    merged.append(v)
                    if max_k is not None and len(merged) > max_k:
                        overflow = True
                        break
        gk = len(merged)
        # per-call local accumulation, merged under the stats lock at the
        # exits — the same protocol as the numeric routes' _merge_stats,
        # so a shared multi-worker encoder stays exact
        col_stats = {
            "columns": 1,
            "exchanged_payload_bytes": exchanged,
            "k_global_max": gk,
            "k_local_max": max([0] + [len(u) for u in shard_uniqs]),
        }
        if overflow:
            col_stats["overflow_columns"] = 1
            col_stats["merge_ms"] = round(
                (_time.perf_counter() - t0) * 1e3, 3)
            self._merge_string_stats(col_stats)
            return None  # ratio abort: encode() falls back like the oracle
        slot = {v: i for i, v in enumerate(merged)}
        out_idx = np.empty(n, np.uint32)
        for s, (a, b) in enumerate(bounds):
            if b == a:
                continue
            lut = np.fromiter((slot[v] for v in shard_uniqs[s]), np.uint32,
                              len(shard_uniqs[s]))
            out_idx[a:b] = lut[shard_idx[s][: b - a]]
        col_stats["merge_ms"] = round((_time.perf_counter() - t0) * 1e3, 3)
        self._merge_string_stats(col_stats)
        return merged, out_idx

    def _parallel_assembly_ok(self) -> bool:
        """Sequential page assembly, always: each eligible column launches
        the mesh's shards and collectives from inside encode(), and
        concurrent multi-device dispatch from a host thread pool adds
        contention without parallelism (device work serializes on the same
        devices anyway) — so the native backend's column-threaded assembly
        is deliberately disabled."""
        return False

    def _try_dictionary(self, chunk):
        from ..core.bytecol import ByteColumn
        from ..core.schema import PhysicalType

        values = chunk.values
        pt = chunk.column.leaf.physical_type
        if (pt == PhysicalType.BYTE_ARRAY and self._lib is not None
                and isinstance(values, (list, ByteColumn)) and len(values)):
            # strings join the shared-row-group story too: per-shard host
            # hash + a sorted-union merge
            max_k = max(1, int(len(values)
                               * self.options.max_dictionary_ratio))
            if self._bloom_wants_distinct(chunk):
                # bloom population (core/index.py) needs the exact
                # distinct set whatever the dictionary verdict — and here
                # the completed merge is the MESH-GLOBAL set, so the
                # ratio abort is waived and the filter covers every
                # shard's values for free
                max_k = len(values)
            # returns None only on ratio overflow -> encode() falls back to
            # plain/delta, the same escape hatch as _bytes_dictionary
            return self._mesh_string_dictionary(values, max_k)
        if not (self._fixed_width_ok(values, pt) and len(values) > 0):
            # bool / exotic value containers ride the native host dictionary
            return super()._try_dictionary(chunk)
        max_k = self._fixed_width_max_k(len(values), values.dtype.itemsize)
        bounded = self._bounded_route(values)
        if bounded is not None:
            # globally-bounded column: the merge is one constant-payload
            # psum of per-shard histograms instead of the
            # cardinality-proportional unique-set gather.  The bound comes
            # from min/max/gcd over ALL rows, so it is globally valid
            # across every shard, and k <= value_bound <= 2^13 can never
            # overflow a cap.
            vmin, stride, vb = bounded
            from .sharded import (bounded_global_dictionary_encode,
                                  bounded_psum_payload_bytes)

            col_stats: dict = {}
            with self._on_streams():
                d, idx = bounded_global_dictionary_encode(
                    values, self.mesh, vmin=vmin, stride=stride,
                    value_bound=vb, dispatch_lock=_DISPATCH_LOCK,
                    stats_out=col_stats,
                    trusted=True)  # vmin/stride/vb come from the exact stats
            self._merge_stats(col_stats)
            accepted = len(d) <= max_k
            self.route_log.append({
                "column": chunk.column.name, "route": "bounded-psum",
                "value_bound": vb, "stride": stride, "k": len(d),
                "accepted": accepted,  # False: encode() falls back to plain
                "ici_payload_bytes": bounded_psum_payload_bytes(vb)})
            if not accepted:
                return None  # encode() would reject it; skip wasted pages
            return d, idx
        col_stats = {}
        try:
            with self._on_streams():
                d, idx = global_dictionary_encode(
                    values, self.mesh, cap=self.cap,
                    dispatch_lock=_DISPATCH_LOCK, stats_out=col_stats)
        except DictionaryOverflow:
            self._merge_stats(col_stats)
            # the rejection is part of the routing record too: without it
            # the log would list fewer columns than the file has
            # dict-eligible ones, with no indication why
            self.route_log.append({
                "column": chunk.column.name, "route": "two-phase-gather",
                "accepted": False, "overflow": True})
            return None  # per-shard cardinality overflow (explicit cap)
        self._merge_stats(col_stats)
        accepted = len(d) <= max_k
        self.route_log.append({
            "column": chunk.column.name, "route": "two-phase-gather",
            "k": len(d), "accepted": accepted,
            "ici_payload_bytes": col_stats.get("ici_gathered_bytes", 0)})
        if not accepted:
            return None  # encode() would reject it; skip the wasted pages
        return d, idx

    @staticmethod
    def _bounded_route(values) -> tuple[int, int, int] | None:
        """(vmin, stride, value_bound) when the column's min/max/gcd prove
        its offsets fit the histogram-psum design bound (<= 2^13), else
        None.  ``vmin >= 0`` is load-bearing: ascending offsets
        reconstruct to ascending bit-pattern dictionary order — identical
        to the gather merge and the host oracle — only for non-negative
        values (a negative int64's bit pattern sorts ABOVE the
        positives)."""
        from ..ops.dictionary import _int_stats, affine_stride
        from .sharded import _BOUNDED_MAX

        if values.dtype.kind not in "iu" or not len(values):
            return None
        vmin, vmax, g_all = _int_stats(values)
        if vmin < 0:
            return None
        span = vmax - vmin
        g = affine_stride(values, vmin, span, g_all, _BOUNDED_MAX)
        if g:
            return vmin, g, span // g + 1
        return None
