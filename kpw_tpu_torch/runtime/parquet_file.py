"""One open parquet output file, record-at-a-time API with batched encode.

API parity with the reference's ``ParquetFile`` wrapper (ParquetFile.java:
24-123: ctor, write(T), close(), getDataSize(), getCreationDate(),
getNumWrittenRecords()) — but where the reference funnels each record
straight into parquet-mr's column writers (PF.java:59-62), this wrapper
buffers records and shreds/encodes them in columnar *batches*, which is what
lets the encode hop to vmapped TPU kernels (the north-star EncoderBackend
boundary)."""

from __future__ import annotations

import time

from ..core.writer import ParquetFileWriter, WriterProperties
from ..io.fs import FileSystem
from ..models.proto_bridge import ProtoColumnarizer


class ParquetFile:
    """Not thread-safe; thread-confined to one worker (reference PF.java:20)."""

    def __init__(
        self,
        fs: FileSystem,
        path: str,
        columnarizer: ProtoColumnarizer,
        properties: WriterProperties,
        batch_size: int = 4096,
        encoder=None,
        pipeline: bool = False,
        est_record_bytes: float = 64.0,
        retry_policy=None,
        heartbeat=None,
    ) -> None:
        self.path = path
        self._fs = fs
        self._sink = fs.open_write(path)
        self._writer = ParquetFileWriter(self._sink, columnarizer.schema,
                                         properties, encoder=encoder,
                                         pipeline=pipeline,
                                         retry_policy=retry_policy,
                                         heartbeat=heartbeat)
        self._columnarizer = columnarizer
        self._batch: list = []
        self._batch_size = batch_size
        self._num_records = 0
        # EWMA of encoded bytes per record; seedable so a rotated-away
        # file's measured estimate carries into its successor (tight
        # size-based rotation needs a warm estimate from record one)
        self._est_record_bytes = float(est_record_bytes)
        # snapshot for assembly_info()'s per-FILE delta (the encoder may
        # be shared across rotated files by a custom Builder backend)
        self._asm_baseline = self._writer.assembly_info()
        self._creation_time = time.time()
        self._closed = False
        # why this file left service: "size" (crossed max_file_size),
        # "time" (max_file_open_duration), "close" (writer shutdown
        # abandoned the open tmp), "error" (worker died), or None while
        # still open.  Set by the worker at the rotation decision point;
        # feeds the rotation-cause meters and per-file observability
        self.rotation_reason: str | None = None

    # -- reference API -----------------------------------------------------
    def write(self, record) -> None:
        """Buffer one parsed record; encodes when the batch fills.

        NOT retry-safe as a whole (a retry would re-append the record); the
        worker runtime uses :meth:`append_record` + :meth:`flush_if_full` so
        only the idempotent flush is retried."""
        self.append_record(record)
        self.flush_if_full()

    def append_record(self, record) -> None:
        """Pure-memory append; cannot fail."""
        self._batch.append(record)
        self._num_records += 1

    def append_records(self, records: list) -> None:
        """Bulk pure-memory append; cannot fail."""
        self._batch.extend(records)
        self._num_records += len(records)

    def append_batch(self, batch) -> None:
        """Pure-memory append of an already-columnarized ColumnBatch (the
        wire-shred fast path: records never exist as Python messages).
        Cannot fail; pair with :meth:`maybe_flush_row_group` for the
        retryable IO step.

        Callers interleaving this with the record-buffer path must drain the
        record buffer first (:meth:`flush_buffered`) or rows would reorder:
        buffered records only reach the writer at the next threshold flush,
        which would land them AFTER this batch."""
        self._writer.append_batch(batch)
        self._observe_record_bytes(batch)
        self._num_records += batch.num_rows

    def flush_buffered(self) -> None:
        """Columnarize + hand over any buffered records now (regardless of
        the batch threshold).  Row-order seam between the record-buffer path
        and :meth:`append_batch`.  Safe to retry: records move out of the
        buffer before any IO can raise; a retried call re-runs only the
        pending row-group flush."""
        self._flush_batch()

    def maybe_flush_row_group(self) -> None:
        """Idempotent, retry-safe row-group flush for the fast path."""
        self._writer.maybe_flush_row_group()

    def flush_if_full(self) -> None:
        """Idempotent: encodes the pending batch when it crossed the
        threshold; safe to retry after transient IO failures (records are
        never re-appended, see ParquetFileWriter.write_batch ownership)."""
        if len(self._batch) >= self._batch_size:
            self._flush_batch()

    def close(self) -> None:
        """Flush pages + footer.  File contents are durable in the sink after
        this (the rename/publish is the caller's job, as in the reference)."""
        if self._closed:
            return
        self._flush_batch()
        self._writer.close()
        self._sink.close()
        self._closed = True

    def abandon(self) -> None:
        """Drop the file without footer or publish (reference close-time
        semantics: the open tmp is abandoned, KPW.java:381-398).  Stops any
        pipeline threads so a rotated-away worker leaks nothing."""
        if self._closed:
            return
        self._writer.abandon()
        self._sink.close()
        self._closed = True

    def get_data_size(self) -> int:
        """In-flight size estimate for rotation (reference getDataSize,
        PF.java:77-79): bytes already written + estimate for buffered rows."""
        return self._writer.estimated_size() + int(
            len(self._batch) * self._est_record_bytes)

    def _observe_record_bytes(self, batch) -> None:
        """Fold one columnar batch into the bytes/record EWMA.  Uses the
        batch's raw estimate scaled by the writer's measured encoded/raw
        ratio — NOT a before/after diff of estimated_size(), which the
        pipeline's IO thread mutates concurrently (a row-group commit
        between the two reads would inject its estimate-vs-actual delta
        into this sample)."""
        n = batch.num_rows
        grew = self._writer.size_ratio * batch.estimated_bytes()
        if n and grew > 0:
            self._est_record_bytes += 0.5 * (grew / n - self._est_record_bytes)

    @property
    def est_record_bytes(self) -> float:
        """Live EWMA of encoded bytes per record — the worker's rotation
        poll cap reads this to stop polling just past the size threshold."""
        return self._est_record_bytes

    def index_info(self) -> dict:
        """Query-ready-section counters of the underlying writer (pages
        indexed, index/bloom bytes, sorting declarations) — populated at
        close; the worker's publish path reads this to mark the
        ``parquet.writer.indexed`` / ``parquet.writer.bloom.bytes``
        meters."""
        return self._writer.index_info()

    def encoding_info(self) -> dict:
        """Per-column value-encoding decisions of the underlying writer
        (core/select_encoding.py): dotted path -> chosen encoding,
        dictionary verdict, trigger reason and the row-group-1 stats.
        Per-FILE by construction — the writer resets the chooser's pins
        at open even when a custom Builder backend shares one encoder
        across rotated files."""
        return self._writer.encoding_info()

    def assembly_info(self) -> dict:
        """Nogil-assembly counters for THIS file (chunks/pages assembled
        by the GIL-released native call) — the worker's publish path reads
        this to mark the ``parquet.writer.assembly.native.chunks`` /
        ``.pages`` meters.  Reported as the delta from the counters at
        open: encoder counters are per-encoder-lifetime, and a custom
        Builder backend hands the SAME encoder object to every rotated
        file (cumulative readings would double-count across rotations)."""
        now = self._writer.assembly_info()
        return {k: now[k] - self._asm_baseline.get(k, 0) for k in now}

    def get_creation_time(self) -> float:
        return self._creation_time

    def get_num_written_records(self) -> int:
        return self._num_records

    def writer_overlap_stats(self) -> dict:
        """Per-stage busy seconds of the underlying writer's overlapped
        row-group pipeline (dispatch / assemble / io, zeros on the sync
        path) plus whether the host-assembly stage is split onto its own
        thread — the evidence the bench's ``hostasm_overlap`` breakdown
        and the runtime metrics read, without installing a tracer."""
        w = self._writer
        return {"split_assembly": w.has_assembly_stage, **w.stage_busy_s}

    def pipeline_stats(self) -> dict:
        """Full pipeline observability snapshot of the underlying writer:
        per-stage busy seconds plus each stage queue's depth /
        high-watermark / blocked-on-put / blocked-on-get stall accounting
        (core.writer.StatQueue).  Readable after close/abandon — the
        worker folds rotated-away files' stats into its running totals."""
        out = self._writer.pipeline_stats()
        out["rotation_reason"] = self.rotation_reason
        out["records"] = self._num_records
        return out

    # -- internals ---------------------------------------------------------
    def _flush_batch(self) -> None:
        if not self._batch:
            return
        batch = self._columnarizer.columnarize(self._batch)
        self._batch = []
        self._writer.write_batch(batch)
        self._observe_record_bytes(batch)
