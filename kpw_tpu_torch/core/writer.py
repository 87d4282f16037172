"""Parquet file writer: row-group assembly + footer.

Owns the whole physical file layout ("PAR1" magic, page blobs, thrift footer)
— the role parquet-mr's ``ParquetFileWriter`` plays underneath the reference's
``ParquetFile`` wrapper (ParquetFile.java:36-68).  Batch-oriented: callers
append :class:`ColumnBatch`es; a row group is flushed when its accumulated
size crosses ``row_group_size`` (the reference's ``blockSize``,
KafkaProtoParquetWriter.java:473).
"""

from __future__ import annotations

import io
import itertools
import json
import os
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from .bytecol import ByteColumn
from .index import serialize_column_index, serialize_offset_index
from .metadata import (ColumnChunk, FileMetaData, RowGroup, SortingColumn)
from .pages import ColumnChunkData, CpuChunkEncoder, EncoderOptions
from .schema import PhysicalType, Schema
from ..utils.tracing import count_transfers, get_span_recorder, record_span, stage

# numbers each writer of the process, for the ``rg`` attribute that ties a
# row group's spans together across the pipeline's threads
_writer_seq = itertools.count()

MAGIC = b"PAR1"


class PipelineError(RuntimeError):
    """A pipeline stage failed after its row group was detached from the
    pending buffer: the data cannot be recovered by retrying, so the writer
    is poisoned — every subsequent operation re-raises.  Deliberately NOT an
    OSError: the runtime's infinite-IO-retry must not spin on it; the worker
    dies un-acked and the records are redelivered (at-least-once)."""


class StatQueue(queue.Queue):
    """Bounded stage queue with backpressure instrumentation: live depth,
    high watermark, and cumulative blocked-on-put / blocked-on-get stall
    seconds.  Put stall = the producer stage waiting on a full queue (the
    downstream stage is the bottleneck); get stall = the consumer stage
    starved (the upstream stage is).  The non-blocking fast path costs one
    extra try per operation and only the SLOW path (already sleeping on
    the queue's condition) takes the stats lock around a timer read — the
    un-contended hot path's overhead is a counter bump."""

    def __init__(self, maxsize: int = 0) -> None:
        super().__init__(maxsize)
        self._stat_lock = threading.Lock()
        self.high_watermark = 0
        self.put_stall_s = 0.0
        self.get_stall_s = 0.0
        self.puts = 0
        self.gets = 0

    def put(self, item, block: bool = True, timeout=None) -> None:
        try:
            super().put(item, block=False)
        except queue.Full:
            if not block:
                raise
            t0 = time.perf_counter()
            try:
                super().put(item, block=True, timeout=timeout)
            finally:
                # a timed-out Full still stalled the producer: count it
                with self._stat_lock:
                    self.put_stall_s += time.perf_counter() - t0
        depth = self.qsize()
        with self._stat_lock:
            self.puts += 1
            if depth > self.high_watermark:
                self.high_watermark = depth

    def get(self, block: bool = True, timeout=None):
        try:
            item = super().get(block=False)
        except queue.Empty:
            if not block:
                raise
            t0 = time.perf_counter()
            try:
                item = super().get(block=True, timeout=timeout)
            finally:
                with self._stat_lock:
                    self.get_stall_s += time.perf_counter() - t0
        with self._stat_lock:
            self.gets += 1
        return item

    def stats(self) -> dict:
        with self._stat_lock:
            return {
                "depth": self.qsize(),
                "high_watermark": self.high_watermark,
                "put_stall_s": round(self.put_stall_s, 6),
                "get_stall_s": round(self.get_stall_s, 6),
                "puts": self.puts,
                "gets": self.gets,
            }


@dataclass
class WriterProperties:
    """Mirrors the reference's ParquetProperties (ParquetFile.java:105-122):
    blockSize, pageSize, codec, enableDictionary — plus encoder backend."""

    row_group_size: int = 128 * 1024 * 1024
    data_page_size: int = 1024 * 1024
    codec: int = 0
    compression_level: int | None = None
    enable_dictionary: bool = True
    write_statistics: bool = True
    # LEGACY SPELLING (see core/select_encoding.py): a forced per-type
    # override rule inside the encoding chooser — kept for back-compat;
    # prefer adaptive_encodings / the encodings override map below
    delta_fallback: bool = False
    # adaptive per-column encodings: decide from row group 1's observed
    # stats, pinned per file (reader coherence); encodings maps column
    # name/dotted path -> Encoding and takes precedence over everything
    adaptive_encodings: bool = False
    encodings: dict | None = None
    encoder_threads: int = 0
    page_checksums: bool = False
    key_value_metadata: dict = field(default_factory=dict)
    # query-ready files (core/index.py): PARQUET-922 page indexes on by
    # default (parquet-mr 1.11 parity), bloom filters opt-in (None = off,
    # () = auto: string/dictionary columns, tuple = explicit columns),
    # sorting declarations as (column_name, descending, nulls_first)
    write_page_index: bool = True
    bloom_columns: tuple | None = None
    bloom_fpp: float = 0.01
    bloom_max_bytes: int = 128 * 1024
    sorting_columns: tuple = ()
    # nogil batch page assembly (native/src/assemble.cc): on by default
    # where a backend supports it; False restores the pure-Python page
    # loops byte-identically (tests/test_assemble.py pins the identity)
    native_assembly: bool = True

    def encoder_options(self) -> EncoderOptions:
        return EncoderOptions(
            codec=self.codec,
            compression_level=self.compression_level,
            enable_dictionary=self.enable_dictionary,
            data_page_size=self.data_page_size,
            write_statistics=self.write_statistics,
            delta_fallback=self.delta_fallback,
            adaptive_encodings=self.adaptive_encodings,
            encodings=self.encodings,
            encoder_threads=self.encoder_threads,
            page_checksums=self.page_checksums,
            write_page_index=self.write_page_index,
            bloom_columns=self.bloom_columns,
            bloom_fpp=self.bloom_fpp,
            bloom_max_bytes=self.bloom_max_bytes,
            native_assembly=self.native_assembly,
        )


class ColumnBatch:
    """A batch of rows in columnar form: list of ColumnChunkData, one per
    schema leaf, all covering the same rows."""

    # serialized-payload bytes this batch was shredded from (set by the wire
    # shredder; None for batches built from parsed records/arrays) — lets
    # the worker meter written bytes without re-walking the records
    wire_bytes: int | None = None

    def __init__(self, chunks: list[ColumnChunkData], num_rows: int) -> None:
        self.chunks = chunks
        self.num_rows = num_rows

    def estimated_bytes(self) -> int:
        return sum(c.estimated_bytes() for c in self.chunks)


class ParquetFileWriter:
    """Writes a parquet file to a binary file object.

    The encoder is pluggable (EncoderBackend boundary): anything with an
    ``encode(ColumnChunkData, base_offset) -> EncodedChunk`` method.
    """

    def __init__(self, sink, schema: Schema, properties: WriterProperties | None = None,
                 encoder=None, pipeline: bool = False,
                 retry_policy=None, heartbeat=None) -> None:
        self.sink = sink
        self.schema = schema
        self.properties = properties or WriterProperties()
        self.encoder = encoder or CpuChunkEncoder(self.properties.encoder_options())
        # adaptive encoding decisions are pinned PER FILE (reader
        # coherence): a shared encoder (custom Builder backend across
        # rotated files) must re-decide from this file's first row group
        if hasattr(self.encoder, "begin_file"):
            self.encoder.begin_file()
        # IO-retry classification for the pipelined IO thread (duck-typed
        # runtime.retry.RetryPolicy: is_fatal + next_sleep).  None keeps the
        # historical fixed-100ms retry-every-OSError loop.
        self._retry_policy = retry_policy
        # IO-progress publisher (duck-typed runtime.watchdog.Heartbeat:
        # io_started/io_finished/beat).  The pipelined IO thread stalls
        # *off* the worker thread, so the hung-IO watchdog can only see it
        # through this seam; None (the default) publishes nothing.
        self._heartbeat = heartbeat
        self._pos = 0
        # query-ready-files state (core/index.py): resolved sorting
        # declarations, whether footer fragments must be recomposed at
        # close (index/bloom sections add ColumnChunk fields the
        # commit-time precompute cannot know yet), the section anchor a
        # retried close() overwrites instead of appending twice, and the
        # counters index_info() reports
        self._sorting = self._resolve_sorting(self.properties.sorting_columns)
        self._defer_cc_bytes = (self.properties.write_page_index
                                or self.properties.bloom_columns is not None)
        self._index_section_start: int | None = None
        self._index_counts = {"pages_indexed": 0, "column_indexes": 0,
                              "index_bytes": 0, "bloom_filters": 0,
                              "bloom_bytes": 0}
        self._row_groups: list[RowGroup] = []
        self._pending: list[ColumnChunkData] | None = None
        self._pending_rows = 0
        self._pending_bytes = 0
        self._size_ratio = 1.0  # EWMA of on-disk bytes / raw-estimate bytes
        self._num_rows = 0
        self._closed = False
        # Overlapped pipeline (SURVEY.md §2.4): caller accumulates batch
        # N+3 while the dispatch thread launches row group N+2's encode
        # (device programs + readbacks in the TPU backend), the assembly
        # thread page-assembles/serializes row group N+1 on the host, and
        # the IO thread writes row group N.  Bounded queues (depth 1 each)
        # cap in-flight memory at ~4 row groups and backpressure the
        # producer naturally.  The assembly stage only exists when the
        # encoder supports the launch||assemble split AND a second core is
        # available to overlap onto (auto-inlined into the dispatch thread
        # otherwise — the classic 3-stage shape).
        self._pipeline = pipeline
        self._enc_q: queue.Queue | None = None
        self._asm_q: queue.Queue | None = None
        self._io_q: queue.Queue | None = None
        self._enc_thread: threading.Thread | None = None
        self._asm_thread: threading.Thread | None = None
        self._io_thread: threading.Thread | None = None
        # detached but not yet ENCODED (raw estimate, ratio-scaled by
        # estimated_size); once a stage finishes encoding, the row group
        # moves to _encoded_inflight at its EXACT byte size — the deeper
        # 4-stage pipe holds more in-flight groups, and scaling known
        # sizes by the EWMA ratio would skew size-based rotation
        self._inflight_bytes = 0
        self._encoded_inflight = 0  # encoded but not yet durable (exact)
        self._inflight_lock = threading.Lock()  # += / -= across stage threads
        self._pipe_error: BaseException | None = None
        self._abandoned = threading.Event()
        self._used_assembly_stage = False
        # per-stage busy seconds of the pipeline threads (zeros on the
        # sync path): each key is written by exactly one stage thread and
        # read approximately — the overlap evidence the bench breakdown
        # and the runtime metrics surface without a global tracer
        self.stage_busy_s = {"dispatch": 0.0, "assemble": 0.0, "io": 0.0}
        # row groups detached so far (on the sync path: written)
        self._seq = next(_writer_seq)
        self._rg_detached = 0
        self._write(MAGIC)

    def _resolve_sorting(self, spec) -> list[SortingColumn]:
        """(name, descending, nulls_first) declarations -> SortingColumn
        entries with leaf ordinals; an unknown column name fails here, at
        construction, not in a published footer."""
        if not spec:
            return []
        cols = self.schema.columns
        out = []
        for name, descending, nulls_first in spec:
            idx = next((i for i, c in enumerate(cols)
                        if c.name == name or ".".join(c.path) == name), None)
            if idx is None:
                raise ValueError(
                    f"sort_order column {name!r} is not a schema leaf "
                    f"(have {[c.name for c in cols]})")
            out.append(SortingColumn(idx, bool(descending),
                                     bool(nulls_first)))
        return out

    def _split_assembly_capable(self) -> bool:
        """True when the encoder can split a row group into launch_many
        (device dispatch) + assemble_many (host page building) halves that
        are safe to run on different threads for different row groups, AND
        its launch actually overlaps real asynchronous work
        (``split_launch_overlaps`` — a no-op launch would only deepen the
        pipe and skew first-file rotation estimates, see pages.py).
        Conservative by construction: an encoder that overrode encode_many
        itself (a custom backend, a test double) keeps its override on the
        single encode stage — the split path would silently bypass it."""
        cls = type(self.encoder)
        return (getattr(cls, "split_launch_overlaps", False)
                and getattr(cls, "encode_many", None)
                is CpuChunkEncoder.encode_many
                and hasattr(cls, "launch_many")
                and hasattr(cls, "assemble_many"))

    @staticmethod
    def _available_cores() -> int:
        """Cores this process may actually use (affinity mask respects
        cgroup/taskset limits; same rule as the Builder's pipeline auto)."""
        try:
            return len(os.sched_getaffinity(0))
        except (AttributeError, OSError):
            return os.cpu_count() or 1

    # -- low level ---------------------------------------------------------
    def _write(self, data: bytes) -> None:
        self._write_parts([data])

    def _write_parts(self, parts: list) -> int:
        """Positioned write of one or more buffers without concatenation: on
        retry after a partially-failed earlier write, seek back to the
        logical position so garbage bytes are overwritten and footer/page
        offsets stay true (at-least-once: a transient IO failure must never
        silently drop or shift data).  _pos only advances after every part
        is written.  Returns the bytes written."""
        if hasattr(self.sink, "seek"):
            try:
                self.sink.seek(self._pos)
            except (OSError, io.UnsupportedOperation):
                pass
        # NOTE (measured): do NOT pre-size the sink with a seek-ahead
        # end-marker — BytesIO's growth is already amortized-efficient,
        # and the marker write measured ~1.5x SLOWER than plain appends
        # at the 20 MB row-group shape; the profile cost attributed to
        # sink writes is cache-cold source traffic, not reallocation.
        if len(parts) > 8 and hasattr(self.sink, "writelines"):
            # writev-style gather: the parts list is now per PAGE BUFFER
            # (EncodedChunk.parts), thousands of entries per row group —
            # writelines loops in C, one Python call for the lot.  Raises
            # partway => _pos unmoved, the retry seeks back (same contract
            # as the per-part loop).
            written = sum(map(len, parts))
            self.sink.writelines(parts)
        else:
            written = 0
            for p in parts:
                self.sink.write(p)
                written += len(p)
        self._pos += written
        return written

    # -- public ------------------------------------------------------------
    @property
    def bytes_written(self) -> int:
        return self._pos

    @property
    def has_assembly_stage(self) -> bool:
        """Whether the overlapped host-assembly stage ran on its own
        thread (False until the first pipelined flush, on the sync path,
        and when auto-inlined — split-incapable encoder or single core).
        Sticky across close() so post-run stats stay readable."""
        return self._asm_thread is not None or self._used_assembly_stage

    def pipeline_stats(self) -> dict:
        """Pull-based pipeline observability snapshot: per-stage busy
        seconds plus each stage queue's depth / high-watermark / stall
        accounting (the queue is named for the stage that CONSUMES it:
        ``dispatch`` feeds the encode-dispatch thread, ``assembly`` the
        host-assembly thread when split, ``io`` the IO thread).  Queues
        survive :meth:`close`/:meth:`abandon`, so post-run stats stay
        readable; empty ``queues`` means the sync (non-pipelined) path."""
        out: dict = {
            "split_assembly": self.has_assembly_stage,
            "stage_busy_s": {k: round(v, 6)
                             for k, v in self.stage_busy_s.items()},
            "queues": {},
        }
        for name, q in (("dispatch", self._enc_q),
                        ("assembly", self._asm_q),
                        ("io", self._io_q)):
            if q is not None:
                out["queues"][name] = q.stats()
        return out

    @property
    def size_ratio(self) -> float:
        """Measured on-disk/raw-estimate byte ratio of encoded row groups
        (1.0 until the first row group finishes encoding — the pipelined
        paths fold the exact encoded size in as soon as it is known,
        before the IO commit)."""
        return self._size_ratio

    def estimated_size(self) -> int:
        """In-flight size estimate: bytes on disk + buffered batch estimate
        + row groups queued in the pipeline.  The reference's rotation check
        reads in-flight ParquetWriter getDataSize() (ParquetFile.java:77-79);
        this is the equivalent.  Buffered/in-flight raw bytes are scaled by
        the measured encoded/raw ratio of already-committed row groups so
        size-based rotation tracks what will actually land on disk
        (dictionary/RLE/compression can shrink — or stats can grow — the
        raw columnar estimate substantially).  Row groups already through
        the encode stage count at their exact encoded size."""
        return self._pos + self._encoded_inflight + int(
            self._size_ratio * (self._pending_bytes + self._inflight_bytes))

    def append_batch(self, batch: ColumnBatch) -> None:
        """Pure-memory append: buffers the batch, never touches the sink
        (cannot raise transient IO).  Pair with :meth:`maybe_flush_row_group`
        — the seam the streaming worker retries independently."""
        if self._closed:
            raise ValueError("writer closed")
        if self._pending is None:
            self._pending = [[c] for c in batch.chunks]
        else:
            if len(batch.chunks) != len(self._pending):
                raise ValueError("batch schema mismatch")
            for bucket, chunk in zip(self._pending, batch.chunks):
                bucket.append(chunk)
        self._pending_rows += batch.num_rows
        self._pending_bytes += batch.estimated_bytes()

    def maybe_flush_row_group(self) -> int:
        """Flush iff the pending bytes crossed row_group_size (idempotent,
        retry-safe).  In pipeline mode the flush is handed to the encode/IO
        threads and this returns as soon as the detach is queued.  Returns
        the rows flushed, 0 when none."""
        if self._pending_bytes >= self.properties.row_group_size:
            if self._pipeline:
                return self._launch_flush()
            return self.flush_row_group()
        return 0

    # -- pipelined flush ---------------------------------------------------
    def _check_pipe_error(self) -> None:
        """Poisoned-writer check: once a stage failed with detached data the
        error is permanent (never cleared) — retrying cannot recover the
        dropped row group, and acking its offsets would break at-least-once."""
        if self._pipe_error is not None:
            raise PipelineError(
                "row-group pipeline failed; file must be abandoned"
            ) from self._pipe_error

    def _ensure_pipe(self) -> None:
        if self._enc_thread is not None:
            return
        self._enc_q = StatQueue(maxsize=1)
        self._io_q = StatQueue(maxsize=1)
        # the assembly stage earns its thread only when the encoder can
        # split AND there is a second core to overlap onto; otherwise it
        # auto-inlines into the dispatch thread (3-stage shape, identical
        # behavior to the pre-split pipeline)
        if self._split_assembly_capable() and self._available_cores() > 1:
            self._asm_q = StatQueue(maxsize=1)
            self._asm_thread = threading.Thread(
                target=self._assembly_loop, name="kpw-rg-assemble",
                daemon=True)
            self._used_assembly_stage = True
            self._asm_thread.start()
        self._enc_thread = threading.Thread(
            target=self._encode_loop, name="kpw-rg-encode", daemon=True)
        self._io_thread = threading.Thread(
            target=self._io_loop, name="kpw-rg-io", daemon=True)
        self._enc_thread.start()
        self._io_thread.start()

    def _trace_detach(self):
        """(rg, detach time) for the row group being detached, while a
        span recorder is installed, else None.  ``rg`` is
        ``"<writer seq>:<ordinal>"``, the attribute every span of the row
        group carries; the time starts its ``rowgroup.latency`` span."""
        if get_span_recorder() is None:
            return None
        return f"{self._seq}:{self._rg_detached}", time.perf_counter()

    def _launch_flush(self) -> int:
        """Detach the pending row group and queue it for encode+IO.  Blocks
        (bounded queue) when two row groups are already in flight.  Returns
        the rows detached, 0 when nothing was pending."""
        self._check_pipe_error()
        if not self._pending or self._pending_rows == 0:
            return 0
        self._ensure_pipe()
        tr = self._trace_detach()
        parts, rows = self._pending, self._pending_rows
        est = self._pending_bytes
        self._pending = None
        self._pending_rows = 0
        self._pending_bytes = 0
        self._rg_detached += 1
        with self._inflight_lock:
            self._inflight_bytes += est
        self._enc_q.put((parts, rows, est, tr))
        return rows

    def _merge_all(self, parts, rg) -> list[ColumnChunkData]:
        with stage("rowgroup.merge", rg=rg):
            return [self._merge_chunks(p) for p in parts]

    def _encode_chunks(self, chunks: list[ColumnChunkData], rg=None):
        """Encode merged chunks at base offset 0 (absolute offsets are
        assigned at commit time) — shared by the sync and pipelined paths."""
        with stage("rowgroup.encode",
                   rows=chunks[0].num_rows if chunks else 0,
                   rg=rg) as span, count_transfers(span):
            if hasattr(self.encoder, "encode_many"):
                return self.encoder.encode_many(chunks, 0)
            encoded, off = [], 0
            for chunk in chunks:
                e = self.encoder.encode(chunk, off)
                off += e.length
                encoded.append(e)
            return encoded

    def _relay_sentinel(self, q: queue.Queue) -> None:
        """Tell the next stage's thread to exit; never blocks forever (the
        downstream thread may already be gone after an abandon)."""
        while True:
            try:
                q.put(None, timeout=0.2)
                return
            except queue.Full:
                if self._abandoned.is_set():
                    return  # downstream drains or exits on its own timeout

    def _next_stage_q(self) -> queue.Queue:
        """The queue the dispatch stage feeds: the assembly stage when it
        exists, else straight to IO."""
        return self._asm_q if self._asm_q is not None else self._io_q

    def _encode_loop(self) -> None:
        """Stage B (dispatch): merge one row group at a time and either
        launch its encode through the split API — so the device leg of row
        group N+1 runs while the assembly thread still owns row group N's
        host leg — or, without an assembly stage, encode it whole.  Either
        way the encode is at base offset 0 (absolute offsets are assigned
        by the IO stage — the native encoder does the same shift for its
        column-parallel path)."""
        while True:
            try:
                item = self._enc_q.get(timeout=0.2)
            except queue.Empty:
                if self._abandoned.is_set():
                    self._relay_sentinel(self._next_stage_q())
                    return
                continue
            if item is None:
                self._relay_sentinel(self._next_stage_q())
                return
            if self._abandoned.is_set() or self._pipe_error is not None:
                continue  # drain without work (abandoned or poisoned)
            parts, rows, est, tr = item
            rg = tr and tr[0]
            try:
                t0 = time.perf_counter()
                chunks = self._merge_all(parts, rg)
                if self._asm_q is not None:
                    with stage("rowgroup.launch", rows=rows,
                               rg=rg) as span, count_transfers(span):
                        prepared = self.encoder.launch_many(chunks)
                    self.stage_busy_s["dispatch"] += time.perf_counter() - t0
                    self._asm_q.put((chunks, prepared, rows, est, tr))
                else:
                    encoded = self._encode_chunks(chunks, rg)
                    enc_len = self._mark_encoded(encoded, est)
                    self.stage_busy_s["dispatch"] += time.perf_counter() - t0
                    self._io_q.put((encoded, rows, enc_len, tr))
            except BaseException as e:  # noqa: BLE001 - poisons the writer
                self._pipe_error = e
                with self._inflight_lock:
                    self._inflight_bytes -= est

    def _assembly_loop(self) -> None:
        """Stage B': column-parallel host assembly (page building, blob
        serialization, stats) of one row group at a time, overlapped with
        the NEXT row group's dispatch in stage B.  Owns its own queue and
        the same poison protocol as the other stages: an assembly failure
        after detach is unrecoverable (the rows left the pending buffer),
        so it poisons the writer instead of dying silently."""
        while True:
            try:
                item = self._asm_q.get(timeout=0.2)
            except queue.Empty:
                if self._abandoned.is_set():
                    self._relay_sentinel(self._io_q)
                    return
                continue
            if item is None:
                self._relay_sentinel(self._io_q)
                return
            if self._abandoned.is_set() or self._pipe_error is not None:
                continue  # drain without work (abandoned or poisoned)
            chunks, prepared, rows, est, tr = item
            try:
                t0 = time.perf_counter()
                with stage("rowgroup.assemble", rows=rows,
                           rg=tr and tr[0]) as span, count_transfers(span):
                    encoded = self.encoder.assemble_many(chunks, prepared, 0)
                enc_len = self._mark_encoded(encoded, est)
                self.stage_busy_s["assemble"] += time.perf_counter() - t0
                self._io_q.put((encoded, rows, enc_len, tr))
            except BaseException as e:  # noqa: BLE001 - poisons the writer
                self._pipe_error = e
                with self._inflight_lock:
                    self._inflight_bytes -= est

    def _io_loop(self) -> None:
        """Stage C: sequential positioned writes + footer bookkeeping.
        Transient IO failures retry forever (reference tryUntilSucceeds,
        KPW.java:410-428) unless the file is abandoned; anything else
        poisons the writer rather than killing this thread silently."""
        while True:
            try:
                item = self._io_q.get(timeout=0.2)
            except queue.Empty:
                if self._abandoned.is_set():
                    return
                continue
            if item is None:
                return
            if self._abandoned.is_set():
                continue
            encoded, rows, enc_len, tr = item
            sleep = None
            attempt = 0
            started = time.monotonic()
            # heartbeat around the whole commit-with-retry: a write that
            # never returns parks this thread here, and the pending
            # "rowgroup.io_write" op is what the hung-IO watchdog ages.  Each
            # retry attempt that RETURNS re-stamps it (beat) — a live
            # backoff loop is the retry policy's business, not a hang.
            hb = self._heartbeat
            hb_token = (hb.io_started("rowgroup.io_write")
                        if hb is not None else None)
            while not self._abandoned.is_set() and self._pipe_error is None:
                try:
                    attempt += 1
                    t0 = time.perf_counter()
                    # raw_estimate=0: _mark_encoded already folded this
                    # row group's exact encoded size into the ratio EWMA
                    # (one stage earlier than a commit-time update — the
                    # deeper pipeline must not delay ratio learning)
                    self._commit_encoded(encoded, rows, rg=tr and tr[0])
                    t1 = time.perf_counter()
                    self.stage_busy_s["io"] += t1 - t0
                    if tr is not None:
                        record_span("rowgroup.latency", tr[1], t1,
                                    rg=tr[0], rows=rows)
                    break
                except OSError as e:
                    if hb is not None:
                        hb.beat()
                    pol = self._retry_policy
                    if pol is None:
                        sleep = 0.1  # historical fixed retry-everything
                    elif pol.is_fatal(e):
                        # non-transient errno (ENOSPC/EROFS/...): retrying
                        # in place cannot heal it — poison the writer so
                        # the owning worker dies un-acked and the records
                        # are redelivered instead of spinning forever
                        self._pipe_error = e
                        break
                    else:
                        sleep = pol.next_sleep(sleep)
                        # honor the policy's attempt/deadline budget: a
                        # bounded policy must cap this seam too, not spin
                        if ((pol.max_attempts is not None
                             and attempt >= pol.max_attempts)
                                or (pol.deadline is not None
                                    and time.monotonic() + sleep - started
                                    > pol.deadline)):
                            self._pipe_error = e
                            break
                    if self._abandoned.wait(sleep):
                        break
                except BaseException as e:  # noqa: BLE001 - poison, don't die
                    self._pipe_error = e
            if hb is not None:
                hb.io_finished(hb_token)
            with self._inflight_lock:
                self._encoded_inflight -= enc_len

    def _mark_encoded(self, encoded_chunks, raw_estimate: int) -> int:
        """Account one row group the moment its encode finishes: fold the
        EXACT encoded size into the encoded/raw ratio EWMA (the pipelined
        commit happens a queue hop — or two, with the assembly stage —
        later, and size-based rotation must not keep estimating with a
        stale ratio) and move the group from the ratio-scaled raw-estimate
        pool to the exact encoded-inflight pool.  Returns the encoded
        size, which replaces the raw estimate on the IO queue."""
        actual = sum(e.length for e in encoded_chunks)
        if raw_estimate > 0 and actual > 0:
            self._size_ratio += 0.5 * (actual / raw_estimate
                                       - self._size_ratio)
        with self._inflight_lock:
            self._inflight_bytes -= raw_estimate
            self._encoded_inflight += actual
        return actual

    def _commit_encoded(self, encoded_chunks, num_rows: int,
                        raw_estimate: int = 0, rg=None) -> None:
        """Write encoded-at-offset-0 chunks at the current position and
        record the row group.  Raises before any state change on IO failure
        (the positioned _write seeks back on retry).  ``raw_estimate`` is the
        pre-encode pending-bytes estimate for this row group; it feeds the
        encoded/raw size-ratio EWMA behind :meth:`estimated_size`."""
        rg_start = self._pos
        parts: list = []
        columns: list[ColumnChunk] = []
        total_byte_size = 0
        total_compressed = 0
        for e in encoded_chunks:
            m = e.meta
            parts.extend(e.parts)
            total_byte_size += m.total_uncompressed_size
            total_compressed += m.total_compressed_size
        with stage("rowgroup.io_write", rowgroup=len(self._row_groups),
                   rows=num_rows, rg=rg):
            # one seek, then a writev-style gather of every chunk's page
            # buffers: the page bytes go from the encoder's parts straight
            # into the sink — no per-chunk blob join, no whole-row-group
            # b"".join bounce (tens of MB at default block size);
            # raises => nothing mutated yet (_pos only advances at the end)
            actual = self._write_parts(parts)
        if raw_estimate > 0 and actual > 0:
            self._size_ratio += 0.5 * (actual / raw_estimate
                                       - self._size_ratio)
        for e in encoded_chunks:
            # metas carry running offsets based at 0 (encode_many's base);
            # shift the whole row group to its absolute file position
            m = e.meta
            if m.dictionary_page_offset is not None:
                m.dictionary_page_offset += rg_start
            m.data_page_offset += rg_start
            columns.append(ColumnChunk(file_offset=m.data_page_offset,
                                       meta_data=m,
                                       page_stats=getattr(e, "pages", None),
                                       bloom=getattr(e, "bloom", None)))
        rg = RowGroup(
            columns=columns,
            total_byte_size=total_byte_size,
            num_rows=num_rows,
            sorting_columns=list(self._sorting) or None,
            file_offset=rg_start,
            total_compressed_size=total_compressed,
            ordinal=len(self._row_groups),
        )
        # offsets are absolute now: serialize the footer fragments here —
        # on the pipelined path this runs in the IO thread, overlapped
        # with later row groups' encode, so close() only splices bytes.
        # With index/bloom sections enabled the fragments gain fields only
        # known at close (section offsets), so serialization defers there.
        if not self._defer_cc_bytes:
            rg.precompute_column_bytes()
        self._row_groups.append(rg)
        self._num_rows += num_rows

    def _drain_pipe(self) -> None:
        """Flush the tail through the pipeline and join every stage thread
        (the sentinel relays stage to stage, in order)."""
        if self._enc_thread is None:
            return
        self._enc_q.put(None)
        self._enc_thread.join()
        if self._asm_thread is not None:
            self._asm_thread.join()
        self._io_thread.join()
        self._enc_thread = self._asm_thread = self._io_thread = None
        self._check_pipe_error()

    def abandon(self) -> None:
        """Stop pipeline threads without finishing the file (the reference
        abandons the open tmp on close — KPW.java:381-398)."""
        self._abandoned.set()
        if self._enc_thread is not None:
            for q, t in ((self._enc_q, self._enc_thread),
                         (self._asm_q, self._asm_thread),
                         (self._io_q, self._io_thread)):
                if t is None:
                    continue
                try:
                    q.put_nowait(None)
                except queue.Full:
                    pass
                t.join(timeout=10)
            self._enc_thread = self._asm_thread = self._io_thread = None
        self._closed = True

    def write_batch(self, batch: ColumnBatch) -> int:
        """Append a batch; flushes a row group when the threshold crosses.
        Returns the rows flushed, 0 when none.

        Ownership contract: the batch is owned by the writer as soon as this
        is called — the append itself cannot fail.  If the internal flush
        raises (transient IO), the data is safely buffered; retry by calling
        :meth:`flush_row_group` (or just :meth:`close`), do NOT re-submit the
        batch."""
        self.append_batch(batch)
        return self.maybe_flush_row_group()

    @staticmethod
    def _merge_chunks(parts: list[ColumnChunkData]) -> ColumnChunkData:
        if len(parts) == 1:
            return parts[0]
        first = parts[0]
        if isinstance(first.values, np.ndarray):
            values = np.concatenate([p.values for p in parts])
        elif all(isinstance(p.values, ByteColumn) for p in parts):
            datas = [p.values.payload() for p in parts]
            offsets = [np.zeros(1, np.int64)]
            base = 0
            for p in parts:
                o = p.values.offsets
                offsets.append(o[1:] - o[0] + base)
                base += p.values.payload_bytes()
            values = ByteColumn(b"".join(datas), np.concatenate(offsets))
        else:
            values = [v for p in parts for v in p.values]

        def cat(attr):
            arrs = [getattr(p, attr) for p in parts]
            if arrs[0] is None:
                return None
            return np.concatenate(arrs)

        return ColumnChunkData(
            column=first.column,
            values=values,
            def_levels=cat("def_levels"),
            rep_levels=cat("rep_levels"),
            num_rows=sum(p.num_rows for p in parts),
        )

    def flush_row_group(self) -> int:
        """Transactional: encode everything, then write, and only then mutate
        writer state — so a transient IO failure leaves ``_pending`` intact
        and a retried flush re-encodes and overwrites (no dropped rows, no
        desynced offsets).  Same encode-at-0 + commit path the pipeline
        threads use (one bookkeeping implementation, byte-identical).
        Returns the rows written, 0 when nothing was pending."""
        if not self._pending or self._pending_rows == 0:
            return 0
        tr = self._trace_detach()
        rg = tr and tr[0]
        chunks = self._merge_all(self._pending, rg)
        num_rows = self._pending_rows
        encoded_chunks = self._encode_chunks(chunks, rg)
        # raises => retry safe (state mutates only after a successful write)
        self._commit_encoded(encoded_chunks, num_rows,
                             raw_estimate=self._pending_bytes, rg=rg)
        self._pending = None
        self._pending_rows = 0
        self._pending_bytes = 0
        self._rg_detached += 1
        if tr is not None:
            record_span("rowgroup.latency", tr[1], time.perf_counter(),
                        rg=rg, rows=num_rows)
        return num_rows

    def _write_index_sections(self) -> None:
        """Query-ready footer sections (core/index.py), laid out between
        the last row group and the footer: every chunk's bloom filter
        (header + bitset), then all ColumnIndexes, then all OffsetIndexes
        (the PARQUET-922 recommended grouping) — each section's offset and
        length recorded into the footer fields that point at it.  Retry-
        safe like the footer itself: the first call anchors the section
        start, and a retried close() seeks back and overwrites rather than
        appending a second copy."""
        if self._index_section_start is None:
            self._index_section_start = self._pos
        else:
            self._pos = self._index_section_start
        counts = self._index_counts = {
            "pages_indexed": 0, "column_indexes": 0, "index_bytes": 0,
            "bloom_filters": 0, "bloom_bytes": 0}
        with stage("encode.page_index", row_groups=len(self._row_groups)):
            for rg in self._row_groups:
                for cc in rg.columns:
                    if cc.bloom is None:
                        continue
                    blob = cc.bloom.serialize()
                    cc.meta_data.bloom_filter_offset = self._pos
                    cc.meta_data.bloom_filter_length = len(blob)
                    self._write(blob)
                    counts["bloom_filters"] += 1
                    counts["bloom_bytes"] += len(blob)
            for rg in self._row_groups:
                for cc in rg.columns:
                    if not cc.page_stats:
                        continue
                    blob = serialize_column_index(cc.page_stats)
                    cc.column_index_offset = self._pos
                    cc.column_index_length = len(blob)
                    self._write(blob)
                    counts["column_indexes"] += 1
                    counts["index_bytes"] += len(blob)
            for rg in self._row_groups:
                for cc in rg.columns:
                    if not cc.page_stats:
                        continue
                    m = cc.meta_data
                    chunk_start = (m.dictionary_page_offset
                                   if m.dictionary_page_offset is not None
                                   else m.data_page_offset)
                    blob = serialize_offset_index(cc.page_stats, chunk_start)
                    cc.offset_index_offset = self._pos
                    cc.offset_index_length = len(blob)
                    self._write(blob)
                    counts["pages_indexed"] += len(cc.page_stats)
                    counts["index_bytes"] += len(blob)

    def index_info(self) -> dict:
        """Counters of the query-ready sections this file carries (zeros
        until close, and with the features off): pages indexed, column
        indexes, index/bloom bytes, bloom filter count, plus the declared
        sorting columns."""
        return {**self._index_counts,
                "sorting_columns": [(s.column_idx, s.descending,
                                     s.nulls_first) for s in self._sorting]}

    def encoding_info(self) -> dict:
        """Per-column value-encoding decisions of this file's encoder
        (core/select_encoding.py): dotted column path -> the chosen
        encoding, whether dictionary was kept, the trigger reason, and
        the row-group-1 stats that drove it.  Empty for custom backends
        without the chooser, and until the first row group encodes."""
        chooser = getattr(self.encoder, "chooser", None)
        if chooser is None:
            return {}
        return chooser.report()

    def assembly_info(self) -> dict:
        """Nogil-assembly accounting of this file's encoder: column chunks
        and pages whose assembly ran as one GIL-released native call
        (native/src/assemble.cc) instead of the Python page loops.  Zeros
        for backends without the extension (and with the knob off)."""
        e = self.encoder
        return {"native_chunks": getattr(e, "native_asm_chunks", 0),
                "native_pages": getattr(e, "native_asm_pages", 0)}

    def close(self) -> None:
        if self._closed:
            return
        if self._pipeline and self._enc_thread is not None:
            try:
                self._launch_flush()  # tail row group rides the pipe, in order
                self._drain_pipe()
            except Exception:
                # poisoned: stop the threads, then surface.  Deliberately NOT
                # BaseException — a KeyboardInterrupt mid-drain leaves state
                # intact so a retried close() can still finish the file.
                self.abandon()
                raise
        self.flush_row_group()  # no-op unless something is still pending
        if self._defer_cc_bytes and self._row_groups:
            self._write_index_sections()
        kv = list(self.properties.key_value_metadata.items())
        # surface the chooser's per-column choice + trigger stats in the
        # footer (readers see the encoding itself in each ColumnMetaData's
        # encodings list; this records WHY, for audit/debug tooling)
        if self.properties.adaptive_encodings or self.properties.encodings:
            einfo = self.encoding_info()
            if einfo:
                kv.append(("kpw.encoding_decisions",
                           json.dumps(einfo, sort_keys=True)))
        meta = FileMetaData(
            schema_fields=self.schema.flatten(),
            num_rows=self._num_rows,
            row_groups=self._row_groups,
            key_value_metadata=kv,
        )
        footer = meta.serialize()
        # one positioned write so a retried close() can't append twice
        self._write(footer + len(footer).to_bytes(4, "little") + MAGIC)
        self._closed = True


def columns_from_arrays(schema: Schema, arrays: dict[str, object]) -> ColumnBatch:
    """Build a flat-schema ColumnBatch from {column_name: ndarray | list[bytes]}.
    Optional columns may pass a (values, validity_mask) tuple."""
    chunks = []
    num_rows = None
    for col in schema.columns:
        data = arrays[col.name]
        def_levels = None
        if isinstance(data, tuple):
            values, valid = data
            valid = np.asarray(valid, bool)
            def_levels = valid.astype(np.int32) * col.max_def
            if isinstance(values, np.ndarray):
                values = values[valid]
            else:
                values = [v for v, ok in zip(values, valid) if ok]
            n = len(valid)
        else:
            values = data
            n = len(values)
            if col.max_def > 0:
                def_levels = np.full(n, col.max_def, np.int32)
        if isinstance(values, list) and col.leaf.physical_type in (
                PhysicalType.BYTE_ARRAY, PhysicalType.FIXED_LEN_BYTE_ARRAY):
            values = ByteColumn.from_list(values)
        if num_rows is None:
            num_rows = n
        elif num_rows != n:
            raise ValueError("ragged column lengths")
        chunks.append(ColumnChunkData(col, values, def_levels, None, n))
    return ColumnBatch(chunks, num_rows or 0)
