"""Writer orchestrator + worker runtime: the reference's L4/L3 layers.

``KafkaProtoParquetWriter`` owns one smart-commit consumer and N workers
(KafkaProtoParquetWriter.java:63-214); each worker runs the poll → parse →
write → rotate → publish → ack loop (:253-292) with size/time rotation
(:297-308), tmp→rename atomic publish (:359-378), deferred acks strictly
after publish (:347-350 — the at-least-once anchor), policy-driven IO
retry (runtime/retry.py — reference :410-443 semantics by default, plus
fatal-errno classification), and close semantics that abandon the open tmp
file so unacked records are redelivered (:381-398).

Beyond the reference (robustness PR): worker death is observable
(``healthy()``, the failed meter, per-worker exit reasons in ``stats()``),
and ``Builder.supervise`` adds a supervisor that re-injects a dead
worker's never-acked offsets into the shared queue and restarts the slot
with capped, backed-off restarts — terminal exhaustion raises
``WriterFailedError`` at ``close()``.
"""

from __future__ import annotations

import logging
import random
import re
import struct
import threading
import time
from datetime import datetime

from ..core.select_encoding import encoding_name
from ..core.writer import PipelineError
from ..io.compact import Compactor
from ..io.fs import publish_file
from ..io.verify import verify_dir, verify_file
from ..ingest.autotune import IngestAutotuner
from ..ingest.broker import RecordBatch, StaleGenerationError
from ..ingest.consumer import SmartCommitConsumer
from ..ingest.offsets import PartitionOffset
from ..models.proto_bridge import ProtoColumnarizer, WireShredError
from ..utils import tracing
from ..utils.tracing import stage
from . import metrics as M
from .export import registry_to_json
from .parquet_file import ParquetFile
from .partition import normalize_partition_path
from .procworkers import ProcessWorkerPool
from .retry import RetryInterrupted, RetryPolicy
from .telemetry import ChildTelemetry, FlightRecorder
from .watchdog import Heartbeat, Watchdog

logger = logging.getLogger(__name__)


class WriterFailedError(Exception):
    """Terminal writer failure: every worker died and (with supervision
    enabled) the restart budget is exhausted.  Raised by ``close()`` so a
    writer that silently stopped making progress cannot masquerade as a
    clean shutdown; the unacked records are redelivered to the next
    instance (at-least-once)."""


class PublishVerificationError(Exception):
    """A closed tmp file failed the independent structural verifier at
    publish time (``Builder.durability(verify_on_publish=True)``).  The
    file was quarantined, never published; deliberately NOT an OSError —
    the bytes are wrong, so the IO retry loop must not spin on it.  The
    worker dies un-acked and the records are redelivered."""


def _format_now(pattern: str) -> str:
    """strftime of now, plus ``%3f`` = zero-padded milliseconds — the
    reference's file-name pattern is yyyyMMdd-HHmmssSSS (KPW.java:486-487)
    and strftime has no millisecond directive (%f is microseconds)."""
    now = datetime.now()
    if "%3f" in pattern:
        pattern = pattern.replace("%3f", f"{now.microsecond // 1000:03d}")
    return now.strftime(pattern)


def publish_rename(fs, retried, tmp_path: str, dest_dir: str, name: str,
                   durable: bool) -> str:
    """The publish tail shared by the thread worker and the process-mode
    child (procworkers._ChildWorker) so the protocol cannot drift:

    * millisecond timestamps can collide when one worker finalizes twice
      in the same tick; rename overwrites (os.replace / HDFS-adapter
      replace), which would silently destroy an already-acked published
      file — disambiguate with a numeric suffix instead (the suffix only
      ever appears under collision);
    * the destination is computed ONCE, outside the retried closure: a
      durable publish can fail AFTER its rename landed (the trailing dir
      fsync), and the retry must resume the SAME (src, dst) pair —
      recomputing a fresh timestamped name would orphan the renamed file
      and spin on the vanished tmp.

    ``retried(fn, label)`` is the caller's retry seam.  Returns the
    published destination path.

    The protocol itself is the target filesystem's capability
    (``io/fs.py`` ``publish_file``, the one decision point): a
    rename-capable sink gets the (durable) tmp→rename protocol — fsync
    tmp → atomic rename → fsync dest dir when ``durable``, so the ack
    that follows can never point at a file the disk forgot — while an
    object-store sink (``supports_rename`` False) publishes by
    completing its staged multipart upload at the destination key.
    Both are retry-safe for the fixed (src, dest) pair."""
    dest = f"{dest_dir}/{name}"
    seq = 0
    while fs.exists(dest):
        seq += 1
        stem, ext = (name.rsplit(".", 1) + [""])[:2]
        dest = (f"{dest_dir}/{stem}-{seq}.{ext}" if ext
                else f"{dest_dir}/{stem}-{seq}")

    def do() -> None:
        publish_file(fs, tmp_path, dest, durable=durable)
        logger.info("Published %s", dest)

    retried(do, "publish")
    return dest


def _rotation_batch_cap(max_file_size: int,
                        est_record_bytes: float = 64.0) -> int:
    """Rotation granularity: get_data_size() only moves per flushed batch,
    so both the poll batch and the encode batch are capped at ~1/16 of the
    size threshold (keeps the reference's ~1% overshoot bound at small
    maxFileSize without giving up vectorized encode at the 1 GiB default).
    One definition, used by the worker loop and the file opener."""
    return max(64, int(max_file_size / 16 / est_record_bytes))


class _RebalanceListener:
    """Writer-side cooperative-revocation hooks, fired on the consumer's
    fetcher thread (``SmartCommitConsumer.set_rebalance_listener``
    documents the surface + threading contract: nothing here may block).

    The revocation drain is a fetcher→worker seam: ``on_partitions_revoked``
    posts a fence request to every worker; each worker services it at its
    next loop iteration by flushing-and-publishing its open file early when
    the file holds a revoked partition's rows (the drain window keeps this
    member's commits for those partitions acceptable).  The consumer polls
    ``revocation_drained`` and only confirms the handoff once no worker
    holds revoked runs.  LOST partitions (session expiry) and drain
    timeouts switch to abandon: publishing would only earn a fenced
    commit, so the open file is dropped and the new owner redelivers."""

    def __init__(self, writer: "KafkaProtoParquetWriter") -> None:
        self._w = writer

    def _note(self, kind: str, **fields) -> None:
        rec = self._w._flightrec
        if rec is not None:
            rec.note(kind, **fields)

    def on_generation(self, gen: int, revoked, added) -> None:
        self._w._rebalances.mark()
        self._note("rebalance_generation", generation=gen,
                   revoked=sorted(revoked), added=sorted(added))

    def on_partitions_revoked(self, parts) -> None:
        self._note("rebalance_revoke_begin", partitions=sorted(parts))
        ps = frozenset(parts)
        for wk in self._w._workers:
            wk.request_fence(ps)

    def revocation_drained(self, parts) -> bool:
        ps = set(parts)
        for wk in self._w._workers:
            try:
                held = wk.held_runs()
            # lint: swallowed-exceptions ok — held_runs scrapes worker-
            # mutated lists lock-free (the ack-lag precedent); a torn read
            # just means "not drained yet", re-polled a tick later
            except RuntimeError:
                return False
            if any(p in ps for p, _, _ in held):
                return False
        for wk in self._w._workers:
            wk.fence_clear(ps)
        self._note("rebalance_drain_complete", partitions=sorted(parts))
        return True

    def on_revocation_timeout(self, parts) -> None:
        self._note("rebalance_drain_timeout", partitions=sorted(parts))
        ps = frozenset(parts)
        for wk in self._w._workers:
            wk.request_abandon(ps)

    def on_partitions_lost(self, parts) -> None:
        self._note("rebalance_partitions_lost", partitions=sorted(parts))
        ps = frozenset(parts)
        for wk in self._w._workers:
            wk.request_abandon(ps)


class KafkaProtoParquetWriter:
    """Streaming writer: Kafka topic -> rotated parquet files.  Construct via
    ``kpw_tpu_torch.Builder``; lifecycle = ``start()`` / ``close()`` (Closeable
    parity, KPW.java:171-196)."""

    def __init__(self, b) -> None:  # b: runtime.builder.Builder
        self._b = b
        self.fs = b._filesystem
        self.target_dir = b._target_dir.rstrip("/")
        self.columnarizer = ProtoColumnarizer(b._proto_class)
        self.properties = b.writer_properties()
        self._encoder_factory = self._make_encoder_factory(
            b._backend, b._backend_device)
        # one retry policy instance for the writer's IO seams (workers +
        # consumer broker IO): infinite-attempt backoff with fatal-errno
        # classification by default; Builder.retry_policy overrides
        self.retry_policy = b._retry_policy or RetryPolicy()
        # backpressure autotuning (opt-in): one tuner shared by the
        # consumer's fetch loop (fetch size, queue depth) and the workers'
        # poll sizing, all derived from measured stage rates
        self.autotuner = (IngestAutotuner(b._fetch_max_records,
                                          b._max_queued_records)
                          if b._autotune else None)
        self.consumer = SmartCommitConsumer(
            broker=b._broker,
            group_id=b._group_id,
            page_size=b._offset_tracker_page_size,
            max_open_pages_per_partition=b._offset_tracker_max_open_pages,
            max_queued_records=b._max_queued_records,
            fetch_max_records=b._fetch_max_records,
            retry_policy=self.retry_policy,
            batch_ingest=b._batch_ingest,
            autotuner=self.autotuner,
            queue_listener=getattr(b, "_queue_listener", None),
            drain_deadline_s=getattr(b, "_rebalance_drain_deadline", 5.0),
        )
        self.consumer.subscribe(b._topic)
        # cooperative-rebalance seam: revocations fence the workers' open
        # files through the drain window before the consumer confirms the
        # handoff.  Registered unconditionally — the consumer only fires
        # it when the broker runs group coordination.  Process mode uses
        # the same listener: _ProcWorkerSlot duck-types the fence surface
        # (request_fence / request_abandon / fence_clear / held_runs) and
        # forwards the fence as a `revoke` ring-protocol descriptor; the
        # coordinated heartbeat stays parent-owned — children never talk
        # to the broker.
        self.consumer.set_rebalance_listener(_RebalanceListener(self))
        self._workers: list = []
        self._started = False
        self._closed = False
        # process-parallel mode (Builder.process_workers): the pool owns
        # the shared-memory ring + dispatcher/collector threads; its
        # slots ARE self._workers, so supervision/watchdog/stats operate
        # on process slots through the same surface as threads
        self._procpool: ProcessWorkerPool | None = None
        # supervision state: restart counts per worker index (kept across
        # replacements), the death-notice the supervisor sleeps on, and the
        # terminal verdict once every restart budget is exhausted
        self._restart_counts: list[int] = (
            [0] * (b._proc_workers or b._thread_count))
        self._dead_notice = threading.Event()
        self._close_event = threading.Event()
        self._supervisor: threading.Thread | None = None
        self._terminal: WriterFailedError | None = None
        # metrics (registered iff a registry is supplied — KPW.java:144-151 —
        # but always counted for the programmatic getters :201-210)
        reg = b._metric_registry
        self._written_records = reg.meter(M.WRITTEN_RECORDS_METER) if reg else M.Meter()
        self._written_bytes = reg.meter(M.WRITTEN_BYTES_METER) if reg else M.Meter()
        self._flushed_records = reg.meter(M.FLUSHED_RECORDS_METER) if reg else M.Meter()
        self._flushed_bytes = reg.meter(M.FLUSHED_BYTES_METER) if reg else M.Meter()
        self._file_size_histogram = (reg.histogram(M.FILE_SIZE_HISTOGRAM)
                                     if reg else M.Histogram())
        # rotation-cause meters + pull-sampled gauges (observability layer;
        # the reference has neither — its only rotation evidence is the
        # published file names).  The gauges are function-backed: the live
        # structures are read only when the registry is scraped.
        self._rotated_size = reg.meter(M.ROTATED_SIZE_METER) if reg else M.Meter()
        self._rotated_time = reg.meter(M.ROTATED_TIME_METER) if reg else M.Meter()
        # consumer-group rebalance meters: generation bumps seen, files
        # rotated early to drain a revoked partition, acks the broker
        # fenced (stale generation), open files abandoned for LOST
        # partitions
        self._rebalances = reg.meter(M.REBALANCES_METER) if reg else M.Meter()
        self._rotated_revoke = (reg.meter(M.ROTATED_REVOKE_METER)
                                if reg else M.Meter())
        self._fenced_acks = reg.meter(M.FENCED_ACKS_METER) if reg else M.Meter()
        self._fence_abandons = (reg.meter(M.FENCE_ABANDONS_METER)
                                if reg else M.Meter())
        # robustness meters — always counted (satellite: worker death must
        # be visible even without supervision enabled)
        self._retries = reg.meter(M.RETRIES_METER) if reg else M.Meter()
        self._retry_backoff_ms = (reg.meter(M.RETRY_BACKOFF_MS_METER)
                                  if reg else M.Meter())
        self._failed = reg.meter(M.FAILED_METER) if reg else M.Meter()
        self._restarts = reg.meter(M.RESTARTS_METER) if reg else M.Meter()
        self._tmp_swept = reg.meter(M.TMP_SWEPT_METER) if reg else M.Meter()
        # durability meters + the recovery manifest (what the startup pass
        # verified/quarantined, surfaced verbatim in stats()["recovery"])
        # query-ready-files meters: published files carrying page-index
        # sections, and serialized bloom bytes landed in them
        self._indexed = reg.meter(M.INDEXED_METER) if reg else M.Meter()
        self._bloom_bytes_meter = (reg.meter(M.BLOOM_BYTES_METER)
                                   if reg else M.Meter())
        # nogil-assembly meters: chunks/pages assembled by the GIL-released
        # native call (native/src/assemble.cc) across published files
        self._native_asm_chunks = (reg.meter(M.NATIVE_ASM_CHUNKS_METER)
                                   if reg else M.Meter())
        self._native_asm_pages = (reg.meter(M.NATIVE_ASM_PAGES_METER)
                                  if reg else M.Meter())
        # adaptive-encoding observability: the most recent published
        # file's per-column chooser decisions (core/select_encoding.py) —
        # dotted path -> chosen encoding + trigger stats, per-file pinned
        self._last_encoding_info: dict = {}
        self._verified = reg.meter(M.VERIFIED_METER) if reg else M.Meter()
        self._verify_failed = (reg.meter(M.VERIFY_FAILED_METER)
                               if reg else M.Meter())
        self._quarantined = (reg.meter(M.QUARANTINED_METER)
                             if reg else M.Meter())
        self._recovery_manifest: dict = {"verified_files": 0,
                                         "quarantined_files": []}
        # degraded-operation state: the hung-IO watchdog (started at
        # start() when configured), and the fatal-errno pause bookkeeping
        # (worker index -> {cause, since}; workers enter/exit under _b's
        # degraded_mode, the paused gauge counts the live set)
        self._watchdog_obj: Watchdog | None = None
        self._stalled = reg.meter(M.STALLED_METER) if reg else M.Meter()
        # partitioned output: records route to per-partition open files
        # ahead of file assignment (runtime/partition.py); evictions count
        # LRU close-and-publish past the open-partitions bound.  The
        # compaction service (io/compact.py) is built at start() when
        # Builder.compaction is configured.
        self.partitioner = b._partitioner
        self._partitions_evicted = (reg.meter(M.PARTITIONS_EVICTED_METER)
                                    if reg else M.Meter())
        # multi-tenant bulkhead seam (runtime/multiwriter.py): the tenant
        # name + shared quota ledger a MultiWriter binds via bind_tenant
        # (None on a plain single-route writer — zero cost), the
        # open-file-budget eviction meter, and the dead-letter meters —
        # the canonical one aggregates across routes on a shared
        # registry, the local one keeps this route's own count
        self._tenant: str | None = None
        self._tenant_ledger = None
        self._tenant_files_evicted = (reg.meter(M.TENANT_FILES_EVICTED_METER)
                                      if reg else M.Meter())
        self._deadlettered = (reg.meter(M.DEADLETTER_METER)
                              if reg else M.Meter())
        self._deadletter_route = M.Meter()
        # end-to-end ack latency: batch-ingest wall time -> durable ack,
        # observed on the consumer's ack path (the ingest stamp rides the
        # queue and, in process mode, the ring unit descriptor).  Dual
        # histograms like the dead-letter meters: the canonical one
        # merges every route on a shared registry, the local one keeps
        # this route's own distribution for the per-tenant block.
        self._ack_latency = (reg.histogram(M.ACK_LATENCY_HISTOGRAM)
                             if reg else M.Histogram())
        self._ack_latency_route = M.Histogram()
        self.consumer.set_latency_observer(self._observe_ack_latency)
        self._compactor: Compactor | None = None
        self._paused: dict[int, dict] = {}
        self._pause_lock = threading.Lock()
        self._pause_count = 0
        self._resume_count = 0
        self._paused_total_s = 0.0
        self._last_close_report: dict | None = None
        # cross-process telemetry plane (runtime/telemetry.py): the
        # merged child-counter view + multi-pid trace merger are built
        # at start() in process mode; the crash flight recorder is built
        # HERE so pre-start faults (startup-verify quarantines) land in
        # the black box too
        self._child_telemetry: ChildTelemetry | None = None
        self.trace_merger: tracing.MultiProcessTrace | None = None
        self._flightrec: FlightRecorder | None = None
        if b._flightrec:
            self._flightrec = FlightRecorder(
                b._flightrec_dir or self.target_dir,
                b._instance_name,
                meter=(reg.meter(M.FLIGHTREC_DUMPS_METER)
                       if reg else M.Meter()))
            self._flightrec.set_gather(self._flightrec_gather)
        # object-store sink: bind the canonical request/byte/part meters
        # + the bandwidth gauge to the registry so both generic exporters
        # render them (io/objectstore.py holds and marks them)
        if reg and hasattr(self.fs, "bind_registry"):
            self.fs.bind_registry(reg)
        if reg:
            reg.gauge(M.PAUSED_GAUGE, lambda: len(self._paused))
            reg.gauge(M.ACK_LAG_GAUGE,
                      lambda: self.ack_lag()["unacked_records"])
            reg.gauge(M.ACK_AGE_GAUGE,
                      lambda: self.ack_lag()["oldest_unacked_age_s"])
            reg.gauge(M.CONSUMER_QUEUE_DEPTH_GAUGE, self.consumer.queue_depth)
            reg.gauge(M.WORKERS_ALIVE_GAUGE,
                      lambda: sum(1 for w in self._workers if w.alive()))
            reg.gauge(M.PARTITIONS_OPEN_GAUGE,
                      lambda: sum(len(w._part_files) for w in self._workers))
        # tracing owned by this writer when the Builder asked for it
        # (installed at start(), uninstalled at close() iff still ours)
        self.stage_timer: tracing.StageTimer | None = None
        self.span_recorder: tracing.SpanRecorder | None = None

    def bind_tenant(self, tenant: str, ledger) -> None:
        """Join this writer to a multi-tenant quota ledger
        (``runtime/multiwriter.py``) as ``tenant``: the open-file-budget
        enforcement (``_file_budget_exceeded``) starts consulting the
        ledger, and the tenant block appears in stats()."""
        self._tenant = tenant
        self._tenant_ledger = ledger

    def _file_budget_exceeded(self) -> bool:
        """True when this writer's tenant is at its open-file budget
        (the LRU bound generalized across the route's workers) —
        the worker about to open one more file evicts its own LRU
        first.  Always False on an unbound (single-route) writer."""
        led = self._tenant_ledger
        return led is not None and led.files_over_budget(self._tenant)

    def _make_encoder_factory(self, backend, device="cuda"):
        self.encoder_choice = None
        if backend == "cpu" or backend is None:
            return lambda: None  # ParquetFileWriter builds the CPU encoder
        if backend in ("cuda", "native", "auto", "mesh"):
            from .select import AutoChoice, check_backend, make_encoder

            # fail fast at construction, not in a worker: a worker-thread
            # ImportError or RuntimeError (no card, no native build) is
            # not retried and would kill workers silently
            check_backend(backend, device)
            opts = self.properties.encoder_options()
            if backend == "auto":  # one decision for all files and workers
                self.encoder_choice = AutoChoice(device)
            return lambda: make_encoder(opts, backend, device, self.encoder_choice)
        if callable(getattr(backend, "encode", None)):
            return lambda: backend
        raise ValueError(f"unknown encoder backend: {backend!r}")

    # -- lifecycle (KPW.java:171-196) --------------------------------------
    def start(self) -> None:
        if self._started:
            raise ValueError("already started")
        self._started = True
        logger.info("Starting parquet writer '%s'", self._b._instance_name)
        if self._b._tracing:
            # process-wide install (the stage() seam is global); the writer
            # owns these instances and removes them at close() unless
            # something else replaced them first
            self.stage_timer = tracing.StageTimer()
            self.span_recorder = tracing.SpanRecorder(
                capacity=self._b._trace_span_capacity)
            tracing.set_tracer(self.stage_timer)
            tracing.set_span_recorder(self.span_recorder)
        if self._b._clean_abandoned_tmp:
            self._gc_abandoned_tmp()
        if self._b._verify_on_startup:
            self._verify_published()
        self.consumer.start()
        if self._b._proc_workers:
            self._procpool = ProcessWorkerPool(self)
            self._workers = self._procpool.slots
            self._procpool.start()
            pool = self._procpool
            # merged child-counter view over the pool's shm TM cells:
            # every slot index stays a readable cell (dead-but-unbanked
            # cells keep counting until respawn/finalize banks them, so
            # the merged totals are monotonic across child restarts)
            self._child_telemetry = ChildTelemetry(
                pool.ring, lambda: range(len(pool.slots)))
            if self.span_recorder is not None:
                # multi-pid timeline: children drain their span rings over
                # the ack channel; the merger aligns them on epoch_wall
                self.trace_merger = tracing.MultiProcessTrace(
                    self.span_recorder)
            reg = self._b._metric_registry
            if reg:
                reg.gauge(M.PROC_RING_SLOTS_GAUGE, lambda: pool.ring.slots)
                reg.gauge(M.PROC_RING_FREE_GAUGE, pool.ring_free)
                reg.gauge(M.PROC_INFLIGHT_GAUGE,
                          lambda: sum(s.inflight_units()
                                      for s in pool.slots))
                reg.gauge(M.PROC_RSS_GAUGE,
                          lambda: sum(s.rss_bytes() for s in pool.slots))
                reg.gauge(M.PROC_ALIVE_GAUGE,
                          lambda: sum(1 for s in pool.slots if s.alive()))
                # child-origin counters, merged banked+live at scrape
                # time: one parent-side registry_to_prometheus() /
                # registry_to_json() call covers the whole process tree
                ct = self._child_telemetry
                reg.gauge(M.CHILD_WRITTEN_RECORDS_GAUGE,
                          lambda: ct.field("written_records"))
                reg.gauge(M.CHILD_FLUSHED_RECORDS_GAUGE,
                          lambda: ct.field("flushed_records"))
                reg.gauge(M.CHILD_STAGE_SECONDS_GAUGE,
                          lambda: ct.field("stage_time_us") / 1e6)
                reg.gauge(M.CHILD_SPANS_GAUGE,
                          lambda: ct.field("spans_recorded"))
                reg.gauge(M.CHILD_SPANS_DROPPED_GAUGE,
                          lambda: ct.field("spans_dropped"))
                # child-side rebalance activity in the same merged scrape
                reg.gauge(M.CHILD_REBALANCE_FENCED_GAUGE,
                          lambda: ct.field("rebalance_fenced"))
                reg.gauge(M.CHILD_REBALANCE_ABANDONED_GAUGE,
                          lambda: ct.field("rebalance_abandoned"))
        else:
            for i in range(self._b._thread_count):
                w = _Worker(self, i)
                self._workers.append(w)
                w.start()
        if self._b._supervise:
            self._supervisor = threading.Thread(
                target=self._supervise_loop,
                name=f"KPW-supervisor-{self._b._instance_name}",
                daemon=True)
            self._supervisor.start()
        if self._b._watchdog:
            self._watchdog_obj = Watchdog(
                lambda: list(self._workers),
                deadline_s=self._b._io_stall_deadline,
                poll_interval_s=self._b._watchdog_poll,
                on_stall=self._on_watchdog_stall)
            self._watchdog_obj.start()
        if self._b._compaction:
            self._compactor = Compactor(
                self.fs, self.target_dir, self._b._proto_class,
                self.properties, registry=self._b._metric_registry,
                instance_name=self._b._instance_name,
                **self._b._compaction)
            self._compactor.start()

    def _gc_abandoned_tmp(self) -> None:
        """Remove .tmp files left by a previous run of THIS instance name
        (the reference never GCs these — SURVEY.md §3.5; opt-in because a
        second live writer sharing the instance name would lose its open
        file).  Scoped to the ``{instance}_`` prefix so other instances
        writing to the same target directory are untouched."""
        tmp_dir = f"{self.target_dir}/tmp"
        # strict tmp-name shape '{instance}_{worker}_{rand}.tmp' — a bare
        # prefix test would also match instance names that extend ours
        # (e.g. 'ingest' deleting live 'ingest_backup_0_*.tmp')
        pat = re.compile(
            re.escape(self._b._instance_name) + r"_\d+_\d+\.tmp$")
        try:
            # recursive: partitioned mode keeps its tmps under per-partition
            # subdirs (tmp/{partition}/...); the basename pattern still
            # scopes the sweep to THIS instance's worker files
            stale = [p for p in self.fs.list_files(tmp_dir, extension=".tmp",
                                                   recursive=True)
                     if pat.fullmatch(p.rsplit("/", 1)[-1])]
        except FileNotFoundError:
            return
        swept = 0
        for p in stale:
            try:
                self.fs.delete(p)
                self._tmp_swept.mark()
                swept += 1
                logger.info("Removed abandoned tmp file %s", p)
            except OSError:
                logger.warning("Could not remove abandoned tmp file %s", p)
        if swept and self._flightrec is not None:
            # rebalance-drill evidence: a restarted instance aborting the
            # dead instance's debris (incl. SIGKILLed proc-mode children's
            # tmps — their '{instance}_{worker}_{rand}.tmp' names match)
            self._flightrec.note("rebalance_orphan_swept", files=swept)

    def _verify_published(self) -> None:
        """Startup recovery, the read-back half of the durability story:
        structurally verify every published ``.parquet`` under the target
        dir (``tmp/`` and ``quarantine/`` excluded) with the independent
        verifier and move every failure to ``{target_dir}/quarantine/`` —
        moved, NEVER deleted: a torn final may still hold recoverable row
        groups, and deleting data on a heuristic is how recovery tools
        destroy evidence.  A verify failure here is expected exactly once
        per torn publish (power cut mid-rename with durability off, a
        crash-window tear); the quarantined records were by construction
        never acked OR are redelivered duplicates, so removing the file
        from the published set preserves at-least-once.  The manifest of
        what happened lands in ``stats()['recovery']``."""
        reports = verify_dir(self.fs, self.target_dir)
        for rep in reports:
            if rep.ok:
                self._verified.mark()
            else:
                self._verify_failed.mark()
                qpath = self._quarantine(rep.path)
                self._recovery_manifest["quarantined_files"].append({
                    "path": rep.path,
                    "quarantined_to": qpath,
                    "errors": list(rep.errors[:5]),
                })
        self._recovery_manifest["verified_files"] = sum(
            1 for r in reports if r.ok)

    def _quarantine(self, path: str) -> str:
        """Move a condemned file to ``{target_dir}/quarantine/`` (same
        filesystem, atomic rename; name collisions get a numeric suffix).
        Returns the quarantine path."""
        qdir = f"{self.target_dir}/quarantine"
        self.fs.mkdirs(qdir)
        name = path.rsplit("/", 1)[-1]
        dest = f"{qdir}/{name}"
        seq = 0
        while self.fs.exists(dest):
            seq += 1
            dest = f"{qdir}/{name}.{seq}"
        self.fs.rename(path, dest)
        self._quarantined.mark()
        logger.warning("Quarantined structurally-invalid file %s -> %s",
                       path, dest)
        if self._flightrec is not None:
            self._flightrec.note("quarantine", path=path,
                                 quarantined_to=dest)
            self._flightrec.dump("quarantine", path=path,
                                 quarantined_to=dest)
        return dest

    # -- degraded operation: watchdog + pause/resume -------------------------
    def _on_watchdog_stall(self, index: int, worker: "_Worker",
                           age: float, label: str | None) -> None:
        """One stall episode crossed the deadline: meter it, and — opt-in
        — condemn the stuck worker so the supervisor restarts the slot
        (redelivery preserves at-least-once) and tell a failover
        filesystem its primary hangs (a hang never raises an errno, so
        the composite cannot see it on its own)."""
        self._stalled.mark()
        if self._flightrec is not None:
            self._flightrec.note("watchdog_stall", worker=index,
                                 stalled_stage=label or "io",
                                 stall_age_s=round(age, 3))
        logger.error(
            "watchdog: worker %d stalled %.1fs in %s (deadline %.1fs)",
            index, age, label or "io", self._b._io_stall_deadline)
        if not self._b._abandon_stalled:
            return
        if hasattr(self.fs, "declare_primary_down"):
            self.fs.declare_primary_down(
                f"worker {index} IO hung {age:.1f}s in {label or 'io'}")
        self._condemn_worker(index, worker, age, label)

    def _condemn_worker(self, index: int, w: "_Worker", age: float,
                        label: str | None) -> None:
        # condemn the worker the watchdog actually SCANNED: if the slot
        # was replaced meanwhile (hung call returned, worker died for
        # real, supervisor restarted it), condemning the fresh occupant
        # would burn a restart on a healthy worker
        if (index >= len(self._workers) or self._workers[index] is not w
                or w.failed or w.condemned):
            return
        w.condemn(f"stalled: IO hung {age:.1f}s in {label or 'io'} "
                  f"(> io_stall_deadline "
                  f"{self._b._io_stall_deadline}s); abandoned by watchdog")
        self._failed.mark()
        if self._flightrec is not None:
            # the black box: what was the tree doing when the watchdog
            # abandoned this slot, and which stage was it stuck in
            self._flightrec.dump("watchdog_stall_kill",
                                 stalled_stage=label or "io",
                                 worker=index, stall_age_s=round(age, 3))
        self._notify_worker_death()

    def _enter_pause(self, index: int, exc: BaseException) -> None:
        with self._pause_lock:
            self._paused[index] = {"cause": repr(exc),
                                   "since": time.monotonic()}
            self._pause_count += 1
        logger.error(
            "worker %d PAUSED on fatal sink condition (%r); intake stops, "
            "probing for recovery", index, exc)
        if self._flightrec is not None:
            # best-effort stage attribution: a sink OSError's message
            # often names the failing op ("injected fault: write call
            # #6", "flush of ..."); a bare errno degrades to "sink"
            stage_name = "sink"
            text = str(exc)
            for op in ("open", "write", "flush", "close", "publish",
                       "rename"):
                if op in text:
                    stage_name = op
                    break
            self._flightrec.note("fatal_sink_pause", worker=index,
                                 stalled_stage=stage_name, cause=repr(exc))
            self._flightrec.dump("fatal_sink_pause",
                                 stalled_stage=stage_name, worker=index,
                                 cause=repr(exc))

    def _exit_pause(self, index: int) -> None:
        with self._pause_lock:
            info = self._paused.pop(index, None)
            if info is not None:
                self._paused_total_s += time.monotonic() - info["since"]
                self._resume_count += 1
        logger.warning("worker %d resumed from pause", index)

    def _probe_sink(self, index: int) -> bool:
        """One write-path probe against the sink: the paused worker's
        recovery test.  Create + write + close + delete under the tmp dir
        — the same op mix whose fatal failure caused the pause."""
        path = (f"{self.target_dir}/tmp/"
                f".probe_{self._b._instance_name}_{index}")
        try:
            self.fs.mkdirs(f"{self.target_dir}/tmp")
            with self.fs.open_write(path) as f:
                f.write(b"kpw pause probe")
            self.fs.delete(path)
            return True
        except OSError:
            return False

    # -- cross-process telemetry plane (runtime/telemetry.py) ----------------
    def _observe_ack_latency(self, seconds: float, count: int) -> None:
        """Consumer ack-path callback: one contiguous run of ``count``
        records became durable ``seconds`` after its batch was ingested.
        One histogram update per run, not per record — runs are the
        consumer's ack granularity, and per-record updates would just
        replicate one latency value ``count`` times into the reservoir.
        Never raises into the ack path."""
        try:
            self._ack_latency.update(seconds)
            self._ack_latency_route.update(seconds)
        except Exception:
            logger.exception("ack-latency observation failed (ignored)")

    def _bank_child_telemetry(self, index: int) -> None:
        """Fold a dead child's final shm counter cell into the banked
        totals (procworkers calls this before clearing the cell for the
        slot's successor, and at pool finalize).  No-op outside process
        mode."""
        if self._child_telemetry is not None:
            self._child_telemetry.bank(index)

    def _absorb_child_telemetry(self, widx: int, payload: dict) -> None:
        """One low-rate side-channel snapshot from child ``widx`` (the
        ``("telemetry", widx, payload)`` ack-queue descriptor): keep the
        registry view for stats() and merge the drained span batch into
        the multi-pid trace.  Never raises into the collector thread."""
        try:
            if self._child_telemetry is not None:
                self._child_telemetry.absorb_snapshot(widx, payload)
            spans = (payload.get("spans")
                     if isinstance(payload, dict) else None)
            if spans and self.trace_merger is not None:
                self.trace_merger.absorb(spans)
        except Exception:
            logger.exception("child telemetry absorb failed (ignored)")

    def _flightrec_gather(self) -> dict:
        """The flight recorder's live-state hook: recent spans (a
        non-draining snapshot — the final trace still gets them), merged
        child counters, ack lag, per-worker observability, the
        watchdog's stall set, and the full registry snapshot —
        everything a post-mortem needs to say what the tree was doing
        when the fault fired.  Exceptions here are the recorder's
        problem: dump() degrades to the event ring."""
        out: dict = {"ack": self.ack_lag(),
                     "workers": [w.observability() for w in self._workers]}
        rec = self.span_recorder
        if rec is not None:
            out["recent_spans"] = [
                {"name": n, "thread": tname, "tid": tid,
                 "start_s": round(st, 6), "duration_s": round(du, 6),
                 "attrs": at}
                for n, tname, tid, st, du, at in rec.snapshot()[-128:]]
        if self._child_telemetry is not None:
            out["children_merged"] = self._child_telemetry.totals()
        if self._watchdog_obj is not None:
            out["watchdog"] = self._watchdog_obj.snapshot()
        reg = self._b._metric_registry
        if reg is not None:
            out["metrics"] = registry_to_json(reg)
        return out

    # -- supervision (beyond the reference: a dead reference worker is a
    # silent log line until process restart) ---------------------------------
    def _notify_worker_death(self, index: int | None = None,
                             reason: str | None = None) -> None:
        """Wake the supervisor.  When the caller knows WHICH worker died
        unexpectedly (process mode: kill -9 / OOM leaves no goodbye
        message), the black box is dumped too, with the stalled stage
        read from the dead child's heartbeat cell — the cell survives
        the death and is only cleared later by the respawn, so the dump
        can name the op the child was inside when it was killed."""
        if self._flightrec is not None:
            if index is None:
                self._flightrec.note("worker_death")
            else:
                stage_name = "idle"
                try:
                    if self._procpool is not None:
                        stage_name = (self._procpool.ring.hb_label(index)
                                      or "idle")
                except Exception:
                    logger.exception(
                        "heartbeat attribution failed (stage=idle)")
                self._flightrec.note("worker_death", worker=index,
                                     reason=reason,
                                     stalled_stage=stage_name)
                self._flightrec.dump("worker_death",
                                     stalled_stage=stage_name,
                                     worker=index, reason=reason)
        self._dead_notice.set()

    def _make_worker(self, i: int):
        """Replace worker slot ``i`` with a fresh (not yet started) one —
        a thread ``_Worker`` or, in process mode, a respawned
        ``_ProcWorkerSlot`` (the pool reclaims the dead child's un-drained
        ring slots first).  Both land in ``self._workers[i]``."""
        if self._procpool is not None:
            return self._procpool.respawn_slot(i)
        nw = _Worker(self, i)
        self._workers[i] = nw
        return nw

    def _supervise_loop(self) -> None:
        """Detect dead workers and restart them with capped restarts +
        exponential backoff.  A restarted worker's held (unacked) offsets
        are re-injected into the shared queue first — the records were never
        acked, so redelivery-by-restart preserves at-least-once.  When every
        worker is dead with its budget exhausted, the writer is terminally
        failed: close() raises WriterFailedError."""
        try:
            self._supervise_loop_inner()
        except RetryInterrupted:
            pass  # close() interrupted a redelivery retry
        except Exception:
            logger.exception("supervisor thread died; no further restarts")

    def _supervise_loop_inner(self) -> None:
        b = self._b
        while not self._close_event.is_set():
            if not self._dead_notice.wait(0.2):
                continue
            self._dead_notice.clear()
            for i in range(len(self._workers)):
                if self._close_event.is_set():
                    return
                w = self._workers[i]
                if not w.failed:
                    continue
                if self._restart_counts[i] >= b._max_worker_restarts:
                    self._check_terminal()
                    continue
                # let the dying worker finish its cleanup (file abandon)
                # before reading its held runs — unless it is HUNG in an
                # IO call that may never return (watchdog condemnation):
                # waiting 10 s per restart would serialize recovery behind
                # the very stall being recovered from.  Process slots join
                # the child process; a condemned one was SIGKILLed, so the
                # short join suffices either way.
                w.join(timeout=0.2 if w.condemned else 10)
                delay = min(b._restart_backoff
                            * (2 ** self._restart_counts[i]), 5.0)
                if self._close_event.wait(delay):
                    return
                self._restart_counts[i] += 1
                self._restarts.mark()
                # replacement FIRST, then redelivery: re-injection blocks
                # on the bounded queue when it is full, and with
                # thread_count=1 the replacement is the only consumer that
                # can make space — the reverse order deadlocks
                nw = self._make_worker(i)
                nw.start()
                try:
                    for part, start, end in w.held_runs():
                        self.consumer.redeliver_run(
                            part, start, end - start,
                            stop_event=self._close_event)
                except RetryInterrupted:
                    return  # close() during redelivery: clean exit
                logger.warning(
                    "supervisor: restarted worker %d (restart %d/%d) after "
                    "%s", i, self._restart_counts[i], b._max_worker_restarts,
                    w.exit_reason)
                # re-arm: another worker may have died while we restarted
                self._dead_notice.set()

    def _check_terminal(self) -> None:
        b = self._b
        exhausted = all(
            w.failed and self._restart_counts[i] >= b._max_worker_restarts
            for i, w in enumerate(self._workers))
        if exhausted and self._terminal is None:
            self._terminal = WriterFailedError(
                f"writer '{b._instance_name}': all {len(self._workers)} "
                f"worker(s) dead, restart budget "
                f"({b._max_worker_restarts}) exhausted; last errors: "
                f"{[w.exit_reason for w in self._workers]}")
            logger.error("%s", self._terminal)

    def healthy(self) -> bool:
        """Liveness verdict for callers that never read stats(): True while
        the writer is started, not closed, not terminally failed, every
        worker thread is alive and neither stalled past the watchdog
        deadline nor paused on a fatal sink condition, and the consumer's
        fetcher is running.  False during a supervised restart window (a
        worker is down until its replacement starts), while degraded
        (stalled/paused), and permanently once anything died for good."""
        if not self._started or self._closed or self._terminal is not None:
            return False
        if self._watchdog_obj is not None and self._watchdog_obj.any_stalled():
            return False
        if self._paused:
            return False
        if self._procpool is not None and not self._procpool.healthy():
            return False
        return (all(w.alive() and not w.failed for w in self._workers)
                and self.consumer.fetcher_alive())

    def close(self, deadline: float | None = None) -> dict | None:
        """Stop the writer.  ``deadline=None`` (the default) keeps the
        historical semantics exactly: wait up to the fixed per-component
        timeouts, abandon every open tmp un-acked, raise the terminal
        verdict if there is one.

        ``deadline=<seconds>`` bounds the WHOLE shutdown: each join gets
        only the remaining budget, a worker still parked in a hung IO
        call past its slice is left behind (daemon thread; its open tmp
        is NOT touched — the hung thread owns the sink — and stays
        un-published/un-acked, swept and redelivered on the next start),
        and close() returns a report of what was flushed vs abandoned
        instead of blocking forever behind a stuck pipeline.  Un-hangable
        by construction: no step waits longer than the remaining budget
        (pinned by ``test_close_deadline_returns_under_hung_write``).

        A terminally-failed writer still raises ``WriterFailedError``
        (the contract: terminal failure must never masquerade as a
        clean shutdown) — deadline or not; the report, including its
        ``terminal`` field, remains retrievable from a second ``close()``
        call, which returns it without re-raising.
        """
        if self._closed:
            return self._last_close_report
        t0 = time.monotonic()
        t_end = None if deadline is None else t0 + max(0.0, deadline)

        def rem(default: float) -> float:
            if t_end is None:
                return default
            return max(0.0, min(default, t_end - time.monotonic()))

        self._closed = True
        self._close_event.set()
        if self._watchdog_obj is not None:
            self._watchdog_obj.close(timeout=rem(5))
        if self._compactor is not None:
            # pending merges are crash-recoverable by the plan protocol;
            # nothing to flush here beyond stopping the scan loop
            self._compactor.close(timeout=rem(5))
        if self._supervisor is not None:
            self._supervisor.join(timeout=rem(30))
        if self._procpool is not None:
            # stop dispatch FIRST: no new units reach the ring while the
            # children drain their queues and exit on poison
            self._procpool.close(timeout=rem(10))
        hung_workers: list[int] = []
        for w in self._workers:
            # deadline mode never abandons a file whose (possibly hung)
            # thread may still be inside the sink — the default mode keeps
            # the historical behavior verbatim
            clean = w.close(timeout=rem(30),
                            abandon_if_hung=(deadline is None))
            if not clean:
                hung_workers.append(w.index)
        if self._procpool is not None:
            # children are joined (or killed): drain the last acks, stop
            # the collector, unlink the shared-memory ring
            self._procpool.finalize(timeout=rem(5))
        self.consumer.close(timeout=rem(10))
        report = {
            "deadline_s": deadline,
            "duration_s": round(time.monotonic() - t0, 3),
            "deadline_met": (t_end is None
                             or time.monotonic() <= t_end + 0.05),
            "flushed_records": self._flushed_records.count,
            "flushed_bytes": self._flushed_bytes.count,
            "hung_workers": hung_workers,
            "abandoned_unacked_records":
                self.ack_lag()["unacked_records"],
            # a worker hung before its first write still holds its polled
            # batch: those records are abandoned too (redelivered next
            # start), and the written-but-unacked gauge alone would say 0
            "abandoned_held_records": sum(
                e - s
                for w in self._workers if w.index in hung_workers
                for _, s, e in w.held_runs()),
            "terminal": (str(self._terminal)
                         if self._terminal is not None else None),
        }
        self._last_close_report = report
        if hung_workers:
            logger.error(
                "close(deadline=%s): worker(s) %s still hung in IO at the "
                "deadline; their open tmp files were left un-published "
                "(%d written-but-unacked record(s) will be redelivered)",
                deadline, hung_workers, report["abandoned_unacked_records"])
        if self.span_recorder is not None:
            if self._b._trace_path:
                try:
                    # the multi-pid merger (process mode) writes ONE
                    # timeline covering parent + children, aligned on
                    # epoch_wall; child span batches were absorbed by the
                    # collector up through finalize() above
                    sink = self.trace_merger or self.span_recorder
                    sink.write_chrome_trace(self._b._trace_path)
                    logger.info("Wrote span timeline to %s",
                                self._b._trace_path)
                except OSError:
                    logger.exception("Could not write trace to %s",
                                     self._b._trace_path)
            # uninstall only what is still ours: a second writer (or the
            # user) may have installed its own tracer meanwhile
            if tracing.get_span_recorder() is self.span_recorder:
                tracing.set_span_recorder(None)
            if tracing.get_tracer() is self.stage_timer:
                tracing.set_tracer(None)
        logger.info("Writer '%s' closed", self._b._instance_name)
        if self._terminal is not None:
            # a writer whose every worker died with the restart budget
            # exhausted must not report a clean shutdown — the caller is
            # the only one left who can act (alert, restart the process)
            raise self._terminal
        return report

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()

    def hard_kill(self) -> None:
        """In-process kill -9 analog AT THE PROTOCOL LEVEL (the real
        SIGKILL drill is tests/crash_child.py): stop every thread without
        flushing, publishing, or leaving the group — the broker learns of
        the death only through the missed heartbeat window (session
        expiry), exactly like a machine that dropped off the network.
        Open tmp files stay on disk un-published, held runs are never
        acked (the surviving group members redeliver them after the
        expiry rebalance).  Python threads cannot be preempted
        mid-bytecode, so an ack already in flight completes atomically
        with its publish — a real SIGKILL could tear between rename and
        commit (an at-least-once duplicate); this analog cannot, and a
        straggler ack landing AFTER the session expired is fenced by the
        broker's generation check and un-published by the backstop."""
        if self._closed:
            return
        self._closed = True
        self._close_event.set()
        if self._watchdog_obj is not None:
            self._watchdog_obj.close(timeout=1)
        if self._procpool is not None:
            # whole-instance kill, process edition: the children get a
            # REAL SIGKILL (orphaned mid-file, tmps left on disk for the
            # restarted instance's startup sweep), the dispatcher and
            # collector stop abruptly (units in the ring abandoned
            # un-acked), and the ring is torn down for shm hygiene — the
            # segment is parent-owned and a dead instance must not leak
            # it.  No leave_group, no final commit: the group
            # coordinator must discover the death by session timeout.
            self._procpool._stop.set()
            for s in self._workers:
                try:
                    s._proc.kill()
                except (OSError, ValueError):
                    pass
            self.consumer.hard_kill()
            self._procpool._closed = True
            self._procpool._dispatcher.join(timeout=5)
            self._procpool._collector.join(timeout=5)
            for s in self._workers:
                s.join(timeout=5)
            self._procpool.ring.close()
            self._procpool.ring.unlink()
        else:
            for w in self._workers:
                w._stop.set()
            # no leave_group, no final commit: the group coordinator must
            # discover the death by session timeout
            self.consumer.hard_kill()
            for w in self._workers:
                w.join(timeout=5)
            for w in self._workers:
                # free pipeline threads + sinks; tmps stay un-published
                w._abandon_open_files("error")
        if self._flightrec is not None:
            self._flightrec.note("hard_kill",
                                 instance=self._b._instance_name)

    # -- observability (beyond the reference: SURVEY.md §5 had only
    # lifecycle logging) ----------------------------------------------------
    def ack_lag(self) -> dict:
        """The load-bearing at-least-once observable: records accepted
        (written into an open file) whose offsets have NOT been durably
        acked yet — they would be redelivered on a crash right now — and
        the age of the oldest such record's first write.  Zero lag means
        every accepted record's file has been published and its offsets
        committed."""
        now = time.time()
        lag = 0
        oldest: float | None = None
        for w in self._workers:
            lag += w._unacked_count
            ts = w._oldest_unacked_ts
            if ts is not None and (oldest is None or ts < oldest):
                oldest = ts
        return {
            "unacked_records": lag,
            "oldest_unacked_age_s": (round(now - oldest, 6)
                                     if oldest is not None else 0.0),
        }

    def stats(self) -> dict:
        """One pull-based snapshot of the whole pipeline, JSON-serializable
        by construction: meters (keyed by their canonical metric names),
        the file-size histogram, rotation-cause counts, ack lag, the
        health verdict + supervision block (worker liveness, death and
        restart counts, terminal failure), the recovery sweep count, the
        consumer's queue/tracker state, per-worker row-group pipeline
        gauges (stage busy seconds + queue depth / high-watermark / stall)
        plus per-worker retry/last-error accounting, and — when tracing is
        installed — the cumulative stage timers and span-buffer occupancy.
        written ≠ flushed ≠ acked: written counts records buffered into an
        open file, flushed counts records in published files, acked means
        the offsets are committed."""
        b = self._b
        out: dict = {
            "meters": {
                M.WRITTEN_RECORDS_METER: self._written_records.snapshot(),
                M.WRITTEN_BYTES_METER: self._written_bytes.snapshot(),
                M.FLUSHED_RECORDS_METER: self._flushed_records.snapshot(),
                M.FLUSHED_BYTES_METER: self._flushed_bytes.snapshot(),
                M.RETRIES_METER: self._retries.snapshot(),
                M.RETRY_BACKOFF_MS_METER: self._retry_backoff_ms.snapshot(),
                M.FAILED_METER: self._failed.snapshot(),
                M.RESTARTS_METER: self._restarts.snapshot(),
                M.TMP_SWEPT_METER: self._tmp_swept.snapshot(),
                M.VERIFIED_METER: self._verified.snapshot(),
                M.VERIFY_FAILED_METER: self._verify_failed.snapshot(),
                M.QUARANTINED_METER: self._quarantined.snapshot(),
                M.STALLED_METER: self._stalled.snapshot(),
                M.PARTITIONS_EVICTED_METER:
                    self._partitions_evicted.snapshot(),
                M.INDEXED_METER: self._indexed.snapshot(),
                M.BLOOM_BYTES_METER: self._bloom_bytes_meter.snapshot(),
                M.NATIVE_ASM_CHUNKS_METER:
                    self._native_asm_chunks.snapshot(),
                M.NATIVE_ASM_PAGES_METER:
                    self._native_asm_pages.snapshot(),
                M.DEADLETTER_METER: self._deadlettered.snapshot(),
            },
            "file_size": self._file_size_histogram.snapshot(),
            # end-to-end time-to-durable (seconds): batch ingest ->
            # published+acked, one reservoir update per acked run.  The
            # route-local histogram (this writer's own distribution,
            # independent of registry sharing) — the canonical
            # ACK_LATENCY_HISTOGRAM merges routes on a shared registry
            "ack_latency": self._ack_latency_route.snapshot(),
            "rotations": {
                "size": self._rotated_size.count,
                "time": self._rotated_time.count,
            },
            "ack": self.ack_lag(),
            "healthy": self.healthy(),
            "supervision": {
                "enabled": b._supervise,
                "max_restarts": b._max_worker_restarts,
                "workers_alive": sum(1 for w in self._workers if w.alive()),
                "workers_dead": sum(1 for w in self._workers if w.failed),
                "restart_counts": list(self._restart_counts),
                "restarts_total": sum(self._restart_counts),
                "terminal_failure": (str(self._terminal)
                                     if self._terminal is not None else None),
            },
            "recovery": {
                "tmp_swept": self._tmp_swept.count,
                "verified": self._verified.count,
                "verify_failed": self._verify_failed.count,
                "quarantined": self._quarantined.count,
                "manifest": {
                    "verified_files":
                        self._recovery_manifest["verified_files"],
                    "quarantined_files": [
                        dict(q) for q in
                        self._recovery_manifest["quarantined_files"]],
                },
            },
            "consumer": self.consumer.stats(),
            "workers": [w.observability() for w in self._workers],
        }
        # degraded-operation block: pause/resume accounting always (cheap,
        # and "not degraded" is itself load-bearing evidence), the
        # watchdog's live stall set when one is running, and the failover
        # composite's spill/reconcile snapshot when the sink is one
        now = time.monotonic()
        with self._pause_lock:
            out["degraded"] = {
                "enabled": b._degraded_mode,
                "paused_workers": [
                    {"worker": i, "cause": info["cause"],
                     "paused_age_s": round(now - info["since"], 3)}
                    for i, info in sorted(self._paused.items())],
                "pause_count": self._pause_count,
                "resume_count": self._resume_count,
                "paused_total_s": round(
                    self._paused_total_s
                    + sum(now - info["since"]
                          for info in self._paused.values()), 3),
            }
        if self._watchdog_obj is not None:
            out["watchdog"] = self._watchdog_obj.snapshot()
        if hasattr(self.fs, "failover_stats"):
            out["failover"] = self.fs.failover_stats()
        # object-store sink block (mirrors failover: only when the sink
        # is one): store request/byte accounting + the upload-pipelining
        # overlap breakdown (upload hidden under encode vs exposed at
        # close) — the evidence bench.py --objstore commits
        if hasattr(self.fs, "objectstore_stats"):
            out["objectstore"] = self.fs.objectstore_stats()
        # partitioned-output block always (like degraded: "not partitioned"
        # is itself evidence); the compactor block only when the service
        # is configured, mirroring watchdog/failover
        # query-ready-files block always (like partitions: "not indexed"
        # is itself evidence an operator wants visible)
        # nogil-assembly block always (same rationale: "assembly stayed in
        # Python" is itself evidence — e.g. an unsupported codec or a
        # missing extension on a box expected to have it)
        out["assembly"] = {
            "native_enabled": self.properties.native_assembly,
            "native_chunks": self._native_asm_chunks.count,
            "native_pages": self._native_asm_pages.count,
        }
        out["index"] = {
            "page_index": self.properties.write_page_index,
            "bloom_columns": (list(self.properties.bloom_columns)
                              if self.properties.bloom_columns is not None
                              else None),
            "sorting_columns": [list(s) for s in
                                self.properties.sorting_columns],
            "files_indexed": self._indexed.count,
            "bloom_bytes": self._bloom_bytes_meter.count,
        }
        # adaptive-encoding block always (same rationale: "everything
        # stayed PLAIN/dictionary" is itself evidence): the chooser config
        # plus the most recent published file's per-column decisions
        out["encodings"] = {
            "adaptive": self.properties.adaptive_encodings,
            "overrides": {k: encoding_name(v) for k, v in
                          (self.properties.encodings or {}).items()},
            "delta_fallback": self.properties.delta_fallback,  # legacy
            "last_file": self._last_encoding_info,
        }
        out["partitions"] = {
            "enabled": self.partitioner is not None,
            "max_open_per_worker": b._max_open_partitions,
            "open": sum(len(w._part_files) for w in self._workers),
            "evicted": self._partitions_evicted.count,
            "open_by_worker": [w.open_partitions() for w in self._workers],
        }
        if self._compactor is not None:
            out["compactor"] = self._compactor.compactor_stats()
        # multi-tenant block only when a MultiWriter bound this writer to
        # a shared quota ledger (mirrors watchdog/failover/compactor):
        # this route's tenant name, its quota snapshot, and its own
        # dead-letter count (the canonical meter aggregates across
        # routes on a shared registry)
        if self._tenant_ledger is not None:
            out["tenant"] = {
                "name": self._tenant,
                "quota": self._tenant_ledger.tenant_snapshot(self._tenant),
                "deadletter_records": self._deadletter_route.count,
            }
        # process-mode block only when the pool exists (mirrors
        # watchdog/failover/compactor): ring occupancy, per-child rss +
        # in-flight units + restart counts, dispatcher/collector counters
        if self._procpool is not None:
            out["procs"] = self._procpool.snapshot()
        # cross-process telemetry block (process mode): the merged
        # banked+live child counters plus each child's last side-channel
        # snapshot; and the flight recorder's state whenever one exists
        # ("no dumps yet" is itself evidence)
        if self._child_telemetry is not None:
            out["telemetry"] = self._child_telemetry.snapshot()
        if self._flightrec is not None:
            out["flightrec"] = self._flightrec.snapshot()
        # writer-OWNED tracing only: the process-global seam may hold a
        # different writer's (or the user's) instruments, and attributing
        # their timings to this writer would be misdirection — users who
        # installed their own tracer already hold its handle
        if self.stage_timer is not None:
            out["stages"] = self.stage_timer.summary()
        if self.span_recorder is not None:
            out["spans"] = {"buffered": len(self.span_recorder),
                            "dropped": self.span_recorder.dropped,
                            "capacity": self.span_recorder.capacity}
            if self.trace_merger is not None:
                # every pid the merged timeline covers (parent + every
                # child that shipped at least one span batch)
                out["spans"]["merged_pids"] = self.trace_merger.pids()
        return out

    def write_trace(self, path: str) -> None:
        """Dump the span timeline recorded so far as Chrome-trace JSON
        (requires Builder.tracing; close() also writes it when a
        trace_path was configured)."""
        if self.span_recorder is None:
            raise ValueError("tracing not enabled on this writer "
                             "(Builder.tracing)")
        (self.trace_merger or self.span_recorder).write_chrome_trace(path)

    # -- programmatic metrics (KPW.java:201-210) ---------------------------
    @property
    def total_written_records(self) -> int:
        return self._written_records.count

    @property
    def total_written_bytes(self) -> int:
        return self._written_bytes.count

    @property
    def total_flushed_records(self) -> int:
        return self._flushed_records.count

    @property
    def total_flushed_bytes(self) -> int:
        return self._flushed_bytes.count


class _Worker:
    """One writer thread: private current file, shared consumer
    (KPW.java:216-399)."""

    def __init__(self, parent: KafkaProtoParquetWriter, index: int) -> None:
        self.p = parent
        self.index = index
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run,
            name=f"KafkaProtoParquetWriter-{parent._b._instance_name}-{index}",
            daemon=True,
        )
        self.current_file: ParquetFile | None = None
        # partitioned mode (Builder.partition_by): partition path -> open
        # file, insertion order == LRU order (reinserted on every write);
        # bounded by max_open_partitions with close-and-publish eviction.
        # Mutated by this worker thread only; scrapes read it lock-free
        self._part_files: dict[str, ParquetFile] = {}
        # death visibility (satellite: a dead worker must be observable
        # even without supervision): set in the _run except path before the
        # thread exits, read by healthy()/stats()/the supervisor
        self.failed = False
        self.exit_reason: str | None = None
        # hung-IO visibility: every IO seam of this slot (the worker
        # thread's _retry calls AND the current file's pipelined IO
        # thread) publishes into this heartbeat; the watchdog ages the
        # oldest pending op.  `condemned` flips when the watchdog abandons
        # a hung slot: the thread may still be parked in the stuck call,
        # but it is already declared dead (failed=True), its held runs
        # redelivered and its slot restarted — if the hung call ever
        # returns, the zombie sees its stop event and exits WITHOUT
        # acking (duplicates allowed, loss impossible)
        self.heartbeat = Heartbeat()
        self.condemned = False
        # per-worker retry accounting fed by the policy's on_retry hook
        self.retries = 0
        self.backoff_s = 0.0
        self.last_error: str | None = None
        # acks held until publish, as contiguous runs [partition, start, end)
        # — poll batches arrive as runs, and per-record PartitionOffset
        # bookkeeping was a measurable slice of the hot loop
        self._written_runs: list[list[int]] = []
        # the poll batch currently being processed, as (partition, start,
        # count) runs: consumed from the queue but not yet folded into
        # _written_runs — on death these must be redelivered too, or the
        # commit frontier stalls behind them forever
        self._inflight_runs: list = []
        self._file_records = 0
        # encoded-bytes/record estimate carried across rotations so every
        # file (not just the first's successors) rotates tightly
        self._carry_est = 64.0
        # measured shred+append rate (records/s EWMA) and the poll batch
        # it produced — the worker half of backpressure autotuning
        self._proc_rate = 0.0
        self._last_poll_batch = 0
        # ack-lag accounting: records in _written_runs (written, not yet
        # acked) and when the oldest of them was first written.  Written by
        # this worker thread only; the parent's ack_lag() reads them
        # lock-free (a slightly stale int is fine for a gauge)
        self._unacked_count = 0
        self._oldest_unacked_ts: float | None = None
        # cumulative pipeline stats of rotated-away files, folded at each
        # finalize/abandon so high watermarks and stall time survive
        # rotation (a per-file snapshot alone would reset every ~1 GiB)
        self._pipe_totals: dict = {"files": 0, "split_assembly": False,
                                   "stage_busy_s": {}, "queues": {}}
        # cooperative-rebalance fence requests (ingest/consumer.py drain
        # protocol): frozensets of partition ids posted by the fetcher
        # thread's _RebalanceListener, serviced by THIS thread at the next
        # loop iteration (GIL-atomic reference swaps — same lock-free
        # single-writer discipline as the ack-lag fields).  ``_fence_req``
        # = flush-and-publish early (the drain window still accepts our
        # commits); ``_fence_abandon_req`` = the partitions are LOST, drop
        # the open file un-published (a publish would only earn a fenced
        # commit)
        self._fence_req: frozenset | None = None
        self._fence_abandon_req: frozenset | None = None

    def start(self) -> None:
        self._thread.start()

    def alive(self) -> bool:
        return self._thread.is_alive()

    def join(self, timeout: float | None = None) -> None:
        """Common slot surface with the process-mode worker: the
        supervisor joins a dead slot before reading its held runs."""
        self._thread.join(timeout)

    def held_runs(self) -> list[tuple[int, int, int]]:
        """Every offset run this worker consumed but never acked, as
        (partition, start, end) — written-but-unpublished runs plus the
        in-flight poll batch.  Read by the supervisor AFTER joining the
        dead thread (single-writer discipline: only the worker thread
        mutates these)."""
        runs = [(p, s, e) for p, s, e in self._written_runs]
        runs.extend((p, s, s + c) for p, s, c in self._inflight_runs)
        return runs

    # -- cooperative-revocation fence (fetcher-thread setters) ---------------
    def request_fence(self, parts: frozenset) -> None:
        """Revoked partitions entered their drain window: flush-and-publish
        this worker's open file at the next loop iteration if it holds any
        of their rows."""
        cur = self._fence_req
        self._fence_req = parts if cur is None else frozenset(cur | parts)

    def request_abandon(self, parts: frozenset) -> None:
        """The partitions are LOST (session expiry / drain timeout):
        abandon their rows un-published — and supersede any pending flush
        request for them, which could no longer commit anyway."""
        cur = self._fence_abandon_req
        self._fence_abandon_req = (parts if cur is None
                                   else frozenset(cur | parts))
        req = self._fence_req
        if req is not None:
            self._fence_req = frozenset(req - parts) or None

    def fence_clear(self, parts) -> None:
        """Drain complete for ``parts``: retire their fence requests."""
        ps = frozenset(parts)
        req = self._fence_req
        if req is not None:
            self._fence_req = frozenset(req - ps) or None
        aband = self._fence_abandon_req
        if aband is not None:
            self._fence_abandon_req = frozenset(aband - ps) or None

    def _service_fence(self) -> None:
        """Service pending cooperative-revocation fence requests (posted
        by the fetcher thread's _RebalanceListener, drained here so only
        this thread ever touches the file/run state).

        Abandon first: LOST partitions' rows must not publish — drop the
        open file(s) un-published, clear every held run, and redeliver the
        runs this member still owns from a side thread (this worker is the
        queue consumer; the _pause_until_recovered precedent).  Then the
        flush flavor: revoked partitions with rows already in the open
        file force an early "revoke" rotation — publish + ack NOW, inside
        the drain window where the broker still accepts this member's
        commits for them — which is what lets the consumer confirm the
        handoff with zero lost and zero duplicated rows."""
        aband = self._fence_abandon_req
        if aband:
            held = self.held_runs()
            if any(p in aband for p, _, _ in held):
                retained = [(p, s, e) for p, s, e in held if p not in aband]
                dropped = sum(e - s for p, s, e in held if p in aband)
                self.p._fence_abandons.mark()
                rec = self.p._flightrec
                if rec is not None:
                    rec.note("rebalance_abandon", worker=self.index,
                             partitions=sorted(aband),
                             dropped_records=dropped,
                             retained_runs=len(retained))
                self._abandon_open_files("revoke")
                self._written_runs.clear()
                self._inflight_runs = []
                self._unacked_count = 0
                self._oldest_unacked_ts = None
                if retained:
                    threading.Thread(
                        target=self._redeliver_runs, args=(retained,),
                        name=f"KPW-fence-redeliver-{self.index}",
                        daemon=True).start()
            self._fence_abandon_req = None
        req = self._fence_req
        if req and any(r[0] in req for r in self._written_runs):
            if self.p.partitioner is not None:
                self._finalize_partitions("revoke")
            else:
                self._finalize_current_file("revoke")

    def _retry(self, fn, label: str = ""):
        """Policy-driven retry for this worker's IO: stop-aware, metered
        (retry count, backoff time, last error) via the on_retry hook.
        The whole call publishes a heartbeat-pending op — a call that
        never returns is a hang the watchdog can age; each retry attempt
        that DOES return re-stamps it via the hook (a live backoff loop
        is the retry policy's business, never a hang)."""
        hb_token = self.heartbeat.io_started(label or "io")
        try:
            return self.p.retry_policy.call(fn, stop_event=self._stop,
                                            on_retry=self._on_retry,
                                            label=label)
        finally:
            self.heartbeat.io_finished(hb_token)

    def _on_retry(self, attempt: int, exc: BaseException,
                  sleep_s: float) -> None:
        self.heartbeat.beat()
        self.retries += 1
        self.backoff_s += sleep_s
        self.last_error = repr(exc)
        self.p._retries.mark()
        self.p._retry_backoff_ms.mark(max(1, int(sleep_s * 1000)))

    def condemn(self, reason: str) -> None:
        """Watchdog abandon: declare this worker dead while its thread is
        (probably) still parked in a hung IO call.  The stop event makes
        an eventually-returning zombie exit without acking; `failed`
        makes the supervisor treat the slot exactly like a crashed
        worker (join times out fast, held runs redelivered, slot
        restarted).  The stuck tmp file is left alone — the hung thread
        owns the sink — and is swept un-acked on the next start."""
        self.condemned = True
        self.exit_reason = reason
        self.failed = True
        self._stop.set()

    def close(self, timeout: float = 30.0,
              abandon_if_hung: bool = True) -> bool:
        """Stop; the open tmp file is abandoned, its offsets never acked —
        those records are redelivered on restart (at-least-once;
        KPW.java:381-398 + SURVEY §3.5 note).  Abandoning also stops the
        file's pipeline threads.  Returns False when the thread is still
        alive after ``timeout`` (hung in IO); with
        ``abandon_if_hung=False`` (the deadline-bounded close) the open
        file is then left untouched — the hung thread owns the sink."""
        self._stop.set()
        self._thread.join(timeout=timeout)
        hung = self._thread.is_alive()
        if abandon_if_hung or not hung:
            for f in self._open_files():
                f.rotation_reason = "close"
                f.abandon()
                self._fold_pipe_stats(f)
            self.current_file = None
            self._part_files.clear()
        return not hung

    # -- loop (KPW.java:253-292) -------------------------------------------
    def _run(self) -> None:
        b = self.p._b
        try:
            # one appended batch must stay well under max_file_size or size
            # rotation loses its ~1% bound (same cap as the flush batch)
            poll_batch_base = max(64, b._batch_size)
            # wire fast path: flat schemas shred serialized payloads straight
            # to columnar via the C++ decoder — no Python message objects
            # (the round-1 streaming bottleneck); errors fall back to the
            # exact per-record Python path below, which owns the poison-pill
            # policies.  Only valid when the payload IS the serialized
            # message — a custom parser() transforms payloads, so it
            # disqualifies the raw-bytes path.
            # partitioning also disqualifies the wire path: routing needs
            # the parsed message, which the wire shredder never builds
            use_wire = (getattr(b, "_parser_is_default", False)
                        and self.p.columnarizer.wire_capable
                        and self.p.partitioner is None)
            # batch-native poll: drain RecordBatch views (contiguous buffer
            # + offsets, no Record materialization) straight into the wire
            # shredder — only meaningful when the wire path is live, since
            # the Python parse path needs Records anyway
            use_batch = use_wire and getattr(b, "_batch_ingest", True)
            while not self._stop.is_set():
                try:
                    self._loop_once(b, poll_batch_base, use_wire, use_batch)
                except (OSError, PipelineError) as e:
                    # degraded_mode: a fatal-classified sink condition
                    # (full disk, read-only remount) pauses this worker —
                    # probe until it heals, then resume — instead of dying
                    # into a restart that cannot fix it.  Anything else
                    # keeps the historical death semantics.
                    cause = self._pause_cause(e)
                    if cause is None:
                        raise
                    self._pause_until_recovered(cause)
        except RetryInterrupted:
            pass
        except Exception as e:
            self.exit_reason = repr(e)
            logger.exception("worker %d terminated", self.index)
            # a dying worker must not leak its open files' pipeline threads
            # or sinks; the tmps stay on disk un-published (at-least-once:
            # their offsets were never acked)
            try:
                self._abandon_open_files("error")
            finally:
                # visibility LAST: `failed` flips only after cleanup, so
                # the supervisor's join-then-read of held_runs() is safe.
                # A condemned (watchdog-abandoned) worker was already
                # declared dead and its slot restarted: the zombie must
                # not count a second death or wake the supervisor again
                if not self.condemned:
                    self.p._failed.mark()
                    self.failed = True
                    self.p._notify_worker_death()
        finally:
            # a condemned zombie that eventually escaped its hung call
            # exits through here holding open (unpublishable) files:
            # free their pipeline threads and sinks best-effort — the
            # slot's replacement is long since running
            if self.condemned:
                self._abandon_open_files("error")

    def _loop_once(self, b, poll_batch_base: int, use_wire: bool,
                   use_batch: bool = False) -> None:
        """One poll→parse→write→rotate iteration (the body of the
        reference's worker loop, KPW.java:253-292), extracted so the
        degraded-mode pause seam can wrap exactly one iteration."""
        if (self._fence_req is not None
                or self._fence_abandon_req is not None):
            self._service_fence()
        if self.p.partitioner is not None:
            return self._loop_once_partitioned(b, poll_batch_base)
        if (self.current_file is not None
                and self._is_file_timed_out(self.current_file)):
            self._finalize_current_file("time")
        # batch granularity follows the LIVE bytes/record estimate,
        # not the static 64 B guess: small-record streams (nested
        # cfg7-shaped, ~10 B/record encoded) were capped at 1/16 of
        # the 64 B-based record count — 4-5x smaller batches than
        # the size band needs, and per-batch shred/append overhead
        # dominated the measured rate (VERDICT r3 next #8)
        tuner = self.p.autotuner
        if tuner is not None:
            # autotuned poll sizing: this worker's own measured
            # processing rate over the tuner's poll horizon, instead of
            # the fixed batch_size constant
            poll_batch_base = tuner.poll_batch(self._proc_rate)
        poll_batch = min(poll_batch_base, _rotation_batch_cap(
            b._max_file_size, max(8.0, self._carry_est)))
        self._last_poll_batch = poll_batch
        if use_batch:
            items, runs = self.p.consumer.poll_many_batches(
                self._poll_cap(poll_batch))
            if not items:
                time.sleep(0.001)
                return
            t0 = time.perf_counter()
            # consumed from the queue: from here until these runs are
            # folded into _written_runs (or individually acked) they
            # are redeliverable only through held_runs()
            self._inflight_runs = runs
            if self._try_wire_items(items, runs):
                self._inflight_runs = []
                self._note_proc_rate(sum(c for _, _, c in runs), t0)
                if self._is_file_full(self.current_file):
                    self._finalize_current_file()
                return
            # wire fallback (a record the shredder could not prove clean):
            # materialize Records and re-run the batch on the exact
            # per-record path below, which owns the poison-pill policies
            recs = [r for it in items
                    for r in (it.to_records()
                              if isinstance(it, RecordBatch) else it)]
        else:
            recs, runs = self.p.consumer.poll_many_runs(
                self._poll_cap(poll_batch))
            if not recs:
                time.sleep(0.001)
                return
            t0 = time.perf_counter()
            self._inflight_runs = runs
            if use_wire and self._try_wire_items([recs], runs):
                self._inflight_runs = []
                self._note_proc_rate(len(recs), t0)
                if self._is_file_full(self.current_file):
                    self._finalize_current_file()
                return
        parsed = []  # (record, message) — parsed in bulk so the
        # per-record loop overhead amortizes (design capacity is
        # 300k rec/s/instance, KPW.java:463)
        nbytes = 0
        for rec in recs:
            try:
                parsed.append((rec, b._parser(rec.value)))
                nbytes += len(rec.value)
            except Exception:
                self._handle_record_error(rec, "unparseable")
        if not parsed:
            self._inflight_runs = []  # every record was acked above
            return
        if self.current_file is None:
            self._open_file()
        # append is pure memory; only the (idempotent) flush retries
        self.current_file.append_records([m for _, m in parsed])
        self._retry(self.current_file.flush_if_full, "flush")
        self._note_written(r for r, _ in parsed)
        self._inflight_runs = []
        self.p._written_records.mark(len(parsed))
        self.p._written_bytes.mark(nbytes)
        self._file_records += len(parsed)
        if self._is_file_full(self.current_file):
            self._finalize_current_file()

    def _handle_record_error(self, rec, what: str) -> None:
        """One record the pipeline cannot place — unparseable bytes, or a
        partitioner that raised/returned garbage — under the
        ``on_parse_error`` policy (reference poison-pill parity,
        KPW.java:271-275).  Call from inside the except handler: the
        ``raise`` policy re-raises the active exception."""
        b = self.p._b
        if b._on_parse_error == "dead_letter":
            logger.exception("Dead-lettering %s record %s/%s", what,
                             rec.partition, rec.offset)
            # durability first, like the main path: the raw payload lands
            # in the dead-letter file before ack
            self._retry(lambda: self._dead_letter(rec), "dead_letter")
            self.p._deadlettered.mark()
            self.p._deadletter_route.mark()
            self.p.consumer.ack(PartitionOffset(rec.partition, rec.offset))
        elif b._on_parse_error == "skip":
            logger.exception("Skipping %s record %s/%s", what,
                             rec.partition, rec.offset)
            # no durability dependency: ack now
            self.p.consumer.ack(PartitionOffset(rec.partition, rec.offset))
        else:
            logger.exception(
                "Can not place record; worker %d dies (reference "
                "poison-pill parity, KPW.java:271-275)", self.index)
            raise

    # -- partitioned mode (Builder.partition_by) -----------------------------
    def _loop_once_partitioned(self, b, poll_batch_base: int) -> None:
        """One poll→parse→route→write→rotate iteration of the partitioned
        mode: each record routes to its partition's open file, size
        rotation is per partition, and time rotation is a CHECKPOINT —
        the oldest open file crossing ``max_file_open_duration`` closes
        every open partition file at once.  Per-file time rotation alone
        could defer acks indefinitely under steady multi-partition
        traffic (some open file always holds fresh records, and a poll
        batch's offsets are only coverable by the union of the files it
        scattered into); the checkpoint guarantees an ack point at least
        once per duration window."""
        if self._part_files and any(self._is_file_timed_out(f)
                                    for f in self._part_files.values()):
            self._finalize_partitions("time")
        tuner = self.p.autotuner
        if tuner is not None:
            poll_batch_base = tuner.poll_batch(self._proc_rate)
        poll_batch = min(poll_batch_base, _rotation_batch_cap(
            b._max_file_size, max(8.0, self._carry_est)))
        self._last_poll_batch = poll_batch
        recs, runs = self.p.consumer.poll_many_runs(
            self._poll_cap(poll_batch))
        if not recs:
            time.sleep(0.001)
            return
        t0 = time.perf_counter()
        self._inflight_runs = runs
        groups: dict[str, list] = {}
        written = []
        nbytes = 0
        for rec in recs:
            try:
                msg = b._parser(rec.value)
                pkey = normalize_partition_path(
                    self.p.partitioner.partition_for(rec, msg))
            except Exception:
                self._handle_record_error(rec, "unroutable")
                continue
            groups.setdefault(pkey, []).append(msg)
            written.append(rec)
            nbytes += len(rec.value)
        if not groups:
            self._inflight_runs = []  # every record was acked above
            return
        for pkey, msgs in groups.items():
            f = self._partition_file(pkey)
            f.append_records(msgs)  # pure memory
            self._retry(f.flush_if_full, "flush")
        self._note_written(written)
        self._inflight_runs = []
        self.p._written_records.mark(len(written))
        self.p._written_bytes.mark(nbytes)
        self._note_proc_rate(len(written), t0)
        for pkey in [k for k, f in self._part_files.items()
                     if self._is_file_full(f)]:
            self._finalize_partition(pkey, "size")

    def _partition_file(self, pkey: str) -> ParquetFile:
        """The open file for ``pkey``, moved to most-recently-written;
        opening a NEW partition past the open-files bound first
        closes-and-publishes the least-recently-written one (LRU
        eviction, ``parquet.writer.partitions.evicted``)."""
        f = self._part_files.pop(pkey, None)
        if f is not None:
            self._part_files[pkey] = f  # dict order == LRU order
            return f
        while len(self._part_files) >= self.p._b._max_open_partitions:
            self._finalize_partition(next(iter(self._part_files)), "evict")
        # per-tenant open-file budget (runtime/multiwriter.py — the
        # LRU bound generalized across the route's workers): at the
        # budget, opening a NEW partition first closes-and-publishes
        # this worker's LRU open file.  Backpressure lands on the
        # offending route (it pays the publish), siblings never see it,
        # and nothing is dropped.  A worker with nothing left to evict
        # proceeds — bounded overshoot of one file per worker, and the
        # next open re-checks.
        while self._part_files and self.p._file_budget_exceeded():
            self.p._tenant_files_evicted.mark()
            self._finalize_partition(next(iter(self._part_files)), "evict")
        f = self._open_new_file(subdir=pkey)
        self._part_files[pkey] = f
        return f

    def _finalize_partitions(self, reason: str) -> None:
        for pkey in list(self._part_files):
            self._finalize_partition(pkey, reason)

    def _finalize_partition(self, pkey: str, reason: str) -> None:
        """Close → publish one partition's open file (``size`` rotation,
        ``time`` checkpoint, or LRU ``evict``), then ack via
        :meth:`_maybe_ack_all`.  The file stays in ``_part_files`` until
        the publish lands: a close/verify/publish failure propagates to
        the worker's death path, whose ``_abandon_open_files`` must still
        find the file to stop its pipeline threads and sink (the flat
        path keeps ``current_file`` set for exactly the same reason)."""
        f = self._part_files[pkey]
        f.rotation_reason = reason
        self._carry_est = f.est_record_bytes
        if f.get_num_written_records() == 0:
            # never publish empty files; just drop the tmp
            self._retry(f.close, "close")
            self._retry(lambda: self.p.fs.delete(f.path), "delete")
            self._fold_pipe_stats(f)
            del self._part_files[pkey]
            return
        self._retry(f.close, "close")
        size = self.p.fs.size(f.path)
        self.p._flushed_records.mark(f.get_num_written_records())
        self.p._flushed_bytes.mark(size)
        self.p._file_size_histogram.update(size)
        self._mark_index_meters(f)
        if reason == "evict":
            self.p._partitions_evicted.mark()
        else:
            (self.p._rotated_time if reason == "time"
             else self.p._rotated_revoke if reason == "revoke"
             else self.p._rotated_size).mark()
        self._rename_and_move(f.path, subdir=pkey)
        self._fold_pipe_stats(f)
        del self._part_files[pkey]
        # ack strictly after durable publish (KPW.java:347-350),
        # generalized to scattered partitions by the checkpoint rule
        self._maybe_ack_all()

    def _mark_index_meters(self, f: ParquetFile) -> None:
        """Per-closed-file accounting: mark ``parquet.writer.indexed``
        when it carries page-index sections, ``parquet.writer.bloom.bytes``
        by the bloom bytes it landed, and the nogil-assembly chunk/page
        meters by what its encoder assembled natively."""
        info = f.index_info()
        if info.get("pages_indexed"):
            self.p._indexed.mark()
        if info.get("bloom_bytes"):
            self.p._bloom_bytes_meter.mark(info["bloom_bytes"])
        asm = f.assembly_info()
        if asm.get("native_chunks"):
            self.p._native_asm_chunks.mark(asm["native_chunks"])
            self.p._native_asm_pages.mark(asm["native_pages"])
        einfo = f.encoding_info()
        if einfo:
            # last published file's chooser decisions (stats()["encodings"])
            self.p._last_encoding_info = einfo

    def _maybe_ack_all(self) -> None:
        """Commit the held offset runs iff NO open file still holds
        unacked records: one poll batch scatters across partitions, so a
        run is durably covered only by the union of the files it landed
        in — all of them must have published."""
        if any(f.get_num_written_records() > 0
               for f in self._part_files.values()):
            return
        pending = list(self._written_runs)
        self._written_runs.clear()
        self._unacked_count = 0
        self._oldest_unacked_ts = None
        for partition, start, end in pending:
            try:
                self.p.consumer.ack_run(partition, start, end - start)
            except StaleGenerationError as e:
                # partitioned files scatter many runs per file, so a
                # fenced run cannot un-publish anything here — drop it
                # (the new owner's redelivery makes its rows
                # at-least-once duplicates) and keep acking the rest
                self.p._fenced_acks.mark()
                rec = self.p._flightrec
                if rec is not None:
                    rec.note("rebalance_fenced_ack_dropped",
                             worker=self.index, partition=partition,
                             run=[start, end], error=repr(e))

    def open_partitions(self) -> list[str]:
        """Scrape-safe snapshot of this worker's open partition keys."""
        try:
            return sorted(self._part_files)
        # lint: swallowed-exceptions ok — lock-free scrape racing the
        # worker thread's dict mutation; a dropped snapshot beats taking
        # down the stats() scrape
        except RuntimeError:
            return []

    def _open_files(self) -> list[ParquetFile]:
        """Every open file this worker owns (flat current file and/or the
        partitioned map) — the cleanup paths' iteration target."""
        out = list(self._part_files.values())
        if self.current_file is not None:
            out.append(self.current_file)
        return out

    def _abandon_open_files(self, reason: str) -> None:
        """Abandon every open file: pipeline threads stopped, sinks
        closed, tmps left un-published and un-acked (swept + redelivered
        later).  Never raises — callers are death/pause/zombie cleanup
        paths that must complete."""
        for f in self._open_files():
            try:
                f.rotation_reason = reason
                f.abandon()
            except Exception:
                logger.exception("worker %d: abandon of %s failed "
                                 "(ignored)", self.index, f.path)
            finally:
                self._fold_pipe_stats(f)
        self.current_file = None
        self._part_files.clear()

    # -- pause/resume (degraded_mode) ---------------------------------------
    def _pause_cause(self, e: BaseException):
        """The fatal OSError behind ``e`` when degraded_mode should pause
        on it, else None.  Covers the direct seam (a fatal errno escaping
        the retry policy) and the pipelined one (a poisoned pipe whose
        cause was a fatal errno in the row-group IO thread)."""
        if not self.p._b._degraded_mode or self._stop.is_set():
            return None
        cand = e
        if isinstance(e, PipelineError):
            cand = e.__cause__
        if not isinstance(cand, OSError):
            return None
        return cand if self.p.retry_policy.is_fatal(cand) else None

    def _pause_until_recovered(self, cause: OSError) -> None:
        """Fatal-errno pause: abandon the open (unpublishable) file
        un-acked, stop intake — the shared queue fills and the fetcher's
        bounded put blocks, so backpressure reaches the consumer while its
        broker session stays alive — and probe the sink with exponential
        backoff until it heals.  On resume the held offset runs are
        re-injected (redelivery; they were never acked) from a side
        thread, because this worker is the consumer that makes queue
        space.  ``max_pause_seconds`` exceeded converts the pause into
        the normal fatal death (supervision semantics take over)."""
        b = self.p._b
        # abandon flushes the sinks and can hit the SAME full-disk
        # condition that triggered the pause — the helper swallows that,
        # which is the whole point of degraded_mode (the tmps are garbage
        # either way)
        self._abandon_open_files("error")
        held = self.held_runs()
        self._written_runs = []
        self._inflight_runs = []
        self._unacked_count = 0
        self._oldest_unacked_ts = None
        self.last_error = repr(cause)
        self.p._enter_pause(self.index, cause)
        try:
            backoff = b._pause_probe_interval
            t0 = time.monotonic()
            while True:
                if self._stop.wait(backoff):
                    raise RetryInterrupted() from cause
                if self.p._probe_sink(self.index):
                    break
                backoff = min(backoff * 2.0, b._pause_probe_max)
                if (b._max_pause is not None
                        and time.monotonic() - t0 > b._max_pause):
                    logger.error(
                        "worker %d: pause exceeded max_pause_seconds "
                        "(%.1fs); converting to fatal death",
                        self.index, b._max_pause)
                    raise cause
        finally:
            self.p._exit_pause(self.index)
        if held:
            threading.Thread(
                target=self._redeliver_runs, args=(held,),
                name=f"KPW-resume-redeliver-{self.index}",
                daemon=True).start()

    def _redeliver_runs(self, runs) -> None:
        try:
            for part, start, end in runs:
                self.p.consumer.redeliver_run(part, start, end - start,
                                              stop_event=self._stop)
        except RetryInterrupted:
            pass
        except Exception:
            logger.exception(
                "resume redelivery failed; the offsets stay un-acked and "
                "redeliver on the next start")

    def _try_wire_items(self, items, runs) -> bool:
        """Shred a poll's worth of queue chunks through the native wire
        decoder and append them columnar.  ``items`` mixes zero-copy
        RecordBatch views (batch-native ingest: buffer + offsets straight
        to the C++ shredder, no per-record bytes lists) and plain Record
        lists (the compatibility route / redelivered runs); ``runs`` is
        the whole poll as (partition, start, count) ack runs — bookkeeping
        and byte metering fold whole runs instead of walking 150k records
        per second in Python.  Returns False when any record needs the
        Python fallback (the whole poll re-runs there; shredder outputs
        are discarded — nothing was appended yet)."""
        col = self.p.columnarizer
        batches = []
        nrecs = 0
        nbytes = 0
        try:
            with stage("worker.shred"):
                for it in items:
                    if isinstance(it, RecordBatch):
                        cb = col.columnarize_buffer(it.payload, it.offsets)
                    else:
                        cb = col.columnarize_payloads([r.value for r in it])
                    batches.append(cb)
                    nrecs += cb.num_rows
                    nbytes += (cb.wire_bytes if cb.wire_bytes is not None
                               else sum(len(r.value) for r in it))
        except WireShredError:
            return False
        if self.current_file is None:
            self._open_file()
        # row order: records a fallback batch left in the file's record
        # buffer are OLDER than this batch — hand them to the writer first
        self._retry(self.current_file.flush_buffered, "flush_buffered")
        with stage("worker.append"):
            for cb in batches:
                self.current_file.append_batch(cb)  # pure memory
        self._retry(self.current_file.maybe_flush_row_group, "flush")
        self._note_written_runs(runs)
        self.p._written_records.mark(nrecs)
        self.p._written_bytes.mark(nbytes)
        self._file_records += nrecs
        return True

    def _note_proc_rate(self, n: int, t0: float) -> None:
        """EWMA of this worker's shred+append processing rate (records/s,
        poll-to-appended) — the autotuner's poll-sizing input."""
        dt = time.perf_counter() - t0
        if dt <= 0 or n <= 0:
            return
        self._proc_rate += 0.3 * (n / dt - self._proc_rate)

    def _note_written(self, records) -> None:
        """Fold records into the held ack runs (extends the last run when
        contiguous in the same partition — the common case, since poll
        batches are fetch-batch slices)."""
        runs = self._written_runs
        run = runs[-1] if runs else None
        n = 0
        for r in records:
            n += 1
            if run is not None and run[0] == r.partition and run[2] == r.offset:
                run[2] += 1
            else:
                run = [r.partition, r.offset, r.offset + 1]
                runs.append(run)
        self._note_unacked(n)

    def _note_written_runs(self, polled_runs) -> None:
        """Fold (partition, start, count) runs from poll_many_runs into the
        held ack runs — O(runs), not O(records)."""
        runs = self._written_runs
        last = runs[-1] if runs else None
        n = 0
        for part, start, count in polled_runs:
            n += count
            if last is not None and last[0] == part and last[2] == start:
                last[2] = start + count
            else:
                last = [part, start, start + count]
                runs.append(last)
        self._note_unacked(n)

    def _note_unacked(self, n: int) -> None:
        """Ack-lag bookkeeping: n more records written but not yet acked;
        stamp the oldest-unacked clock on the 0 -> n transition."""
        if n <= 0:
            return
        if self._oldest_unacked_ts is None:
            self._oldest_unacked_ts = time.time()
        self._unacked_count += n

    def _poll_cap(self, base: int) -> int:
        """Shrink the poll batch as the open file nears its size threshold:
        never ask for more records than the live bytes/record estimate says
        fit in the remaining budget (plus one).  This is what restores the
        reference's ~1% rotation overshoot (KafkaProtoParquetWriterTest.java:
        166-173) without giving up large batches far from the threshold."""
        f = self.current_file
        if f is None and self._part_files:
            # partitioned mode: cap against the FULLEST open partition
            # file — the one that decides the next size rotation
            f = max(self._part_files.values(),
                    key=lambda x: x.get_data_size())
        if f is None:
            return base
        remaining = self.p._b._max_file_size - f.get_data_size()
        if remaining <= 0:
            return 1  # next append rotates immediately
        est = max(f.est_record_bytes, 1.0)
        return max(1, min(base, int(remaining / est) + 1))

    def _is_file_timed_out(self, f: ParquetFile) -> bool:
        return (time.time() - f.get_creation_time()
                >= self.p._b._max_file_open_duration)

    def _is_file_full(self, f: ParquetFile) -> bool:
        return f.get_data_size() >= self.p._b._max_file_size

    def _dead_letter(self, rec) -> None:
        """Append the raw payload to this worker's dead-letter file:
        ``targetDir/deadletter/{instance}_{worker}.bin`` as length-prefixed
        frames of (partition int32, offset int64, payload_len uint32,
        payload).  Real append (never truncate): a failed write can only
        tear the new tail, and frames are self-delimiting so a torn tail is
        detectable; durability-before-ack is delegated to the filesystem's
        close."""
        d = f"{self.p.target_dir}/deadletter"
        self.p.fs.mkdirs(d)
        path = f"{d}/{self.p._b._instance_name}_{self.index}.bin"
        frame = (struct.pack("<iqI", rec.partition, rec.offset,
                             len(rec.value)) + rec.value)
        with self.p.fs.open_append(path) as f:
            f.write(frame)

    # -- observability -----------------------------------------------------
    def _fold_pipe_stats(self, f: ParquetFile) -> None:
        """Fold a finished file's pipeline stats into the worker's running
        totals (stall seconds and put/get counts sum; high watermarks
        max).  Never raises: observability must not take down the
        rotation path."""
        try:
            self._fold_into(self._pipe_totals, f.pipeline_stats())
        except Exception:
            logger.exception("pipeline-stat fold failed (ignored)")

    @staticmethod
    def _fold_into(tot: dict, ps: dict) -> None:
        tot["files"] += 1
        tot["split_assembly"] = (tot["split_assembly"]
                                 or ps.get("split_assembly", False))
        busy = tot["stage_busy_s"]
        for k, v in ps.get("stage_busy_s", {}).items():
            busy[k] = round(busy.get(k, 0.0) + v, 6)
        for qname, qs in ps.get("queues", {}).items():
            agg = tot["queues"].setdefault(
                qname, {"high_watermark": 0, "put_stall_s": 0.0,
                        "get_stall_s": 0.0, "puts": 0, "gets": 0})
            agg["high_watermark"] = max(agg["high_watermark"],
                                        qs.get("high_watermark", 0))
            for k in ("put_stall_s", "get_stall_s"):
                agg[k] = round(agg[k] + qs.get(k, 0.0), 6)
            for k in ("puts", "gets"):
                agg[k] += qs.get(k, 0)

    def observability(self) -> dict:
        """This worker's pull-based snapshot: ack-lag contribution plus
        pipeline totals (rotated-away files folded + the live file's
        stats merged in)."""
        tot = {
            "files": self._pipe_totals["files"],
            "split_assembly": self._pipe_totals["split_assembly"],
            "stage_busy_s": dict(self._pipe_totals["stage_busy_s"]),
            "queues": {q: dict(v)
                       for q, v in self._pipe_totals["queues"].items()},
        }
        try:
            open_files = self._open_files()
        # lint: swallowed-exceptions ok — lock-free scrape racing the
        # worker thread's partition-map mutation; a dropped snapshot
        # beats taking down the stats() scrape
        except RuntimeError:
            open_files = []
        for f in open_files:
            try:
                self._fold_into(tot, f.pipeline_stats())
            # lint: swallowed-exceptions ok — observability fold over
            # files that may be rotating away under us; a racing snapshot
            # is droppable, and raising would take down the stats() scrape
            except Exception:
                pass  # file may be rotating away under us
        ts = self._oldest_unacked_ts
        stall_age, stall_label = self.heartbeat.stall()
        return {
            "worker": self.index,
            "alive": self.alive(),
            "failed": self.failed,
            "condemned": self.condemned,
            "stall_age_s": round(stall_age, 3),
            "stalled_in": stall_label,
            "exit_reason": self.exit_reason,
            "restarts": self.p._restart_counts[self.index],
            "retries": self.retries,
            "retry_backoff_s": round(self.backoff_s, 6),
            "last_error": self.last_error,
            "unacked_records": self._unacked_count,
            "oldest_unacked_age_s": (round(time.time() - ts, 6)
                                     if ts is not None else 0.0),
            "open_partitions": self.open_partitions(),
            "proc_rate_rps": round(self._proc_rate, 1),
            "poll_batch": self._last_poll_batch,
            "pipeline": tot,
        }

    # -- file management ---------------------------------------------------
    def _tmp_path(self, subdir: str | None = None) -> str:
        # targetDir/tmp/{instance}_{idx}_{rand}.tmp (KPW.java:236-239);
        # partitioned files keep their tmp under tmp/{partition}/ so the
        # sweep and a human ls can attribute debris to its partition
        rand = random.getrandbits(63)
        tmp_dir = f"{self.p.target_dir}/tmp" + (f"/{subdir}" if subdir
                                                else "")
        return (f"{tmp_dir}/"
                f"{self.p._b._instance_name}_{self.index}_{rand}.tmp")

    def _open_new_file(self, subdir: str | None = None) -> ParquetFile:
        # flush-batch granularity follows the live bytes/record estimate,
        # same as the poll batch in _run (small-record streams would
        # otherwise split each poll batch into undersized encode batches)
        batch = min(self.p._b._batch_size,
                    _rotation_batch_cap(self.p._b._max_file_size,
                                        max(8.0, self._carry_est)))

        def make() -> ParquetFile:
            self.p.fs.mkdirs(f"{self.p.target_dir}/tmp"
                             + (f"/{subdir}" if subdir else ""))
            return ParquetFile(
                self.p.fs,
                self._tmp_path(subdir),
                self.p.columnarizer,
                self.p.properties,
                batch_size=batch,
                encoder=self.p._encoder_factory(),
                pipeline=self.p._b._pipeline,
                est_record_bytes=self._carry_est,
                retry_policy=self.p.retry_policy,
                heartbeat=self.heartbeat,
            )

        return self._retry(make, "open")

    def _open_file(self) -> None:
        self.current_file = self._open_new_file()
        self._file_records = 0

    def _new_file_name(self) -> str:
        # {timestamp}_{instance}_{workerIdx}{ext} (KPW.java:313-318)
        ts = _format_now(self.p._b._file_date_time_pattern)
        return f"{ts}_{self.p._b._instance_name}_{self.index}{self.p._b._file_extension}"

    def _finalize_current_file(self, reason: str = "size") -> None:
        """Close (flush+footer) -> rename/publish -> ack.  Order is the
        correctness protocol (KPW.java:325-351).  ``reason`` records why
        the file rotated ("size" | "time") for the rotation-cause
        meters."""
        f = self.current_file
        if f is None:
            return
        f.rotation_reason = reason
        self._carry_est = f.est_record_bytes
        if f.get_num_written_records() == 0:
            # never publish empty files; just drop the tmp
            self._retry(f.close, "close")
            self._retry(lambda: self.p.fs.delete(f.path), "delete")
            self._fold_pipe_stats(f)
            self.current_file = None
            return
        self._retry(f.close, "close")
        # pre-publish fence check (side-effect-free broker predicate): a
        # run whose partition this member can no longer commit — the drain
        # window lapsed, or the session expired under us — must not
        # publish, or the new owner's redelivery of those rows becomes a
        # duplicate.  Abandon the closed tmp instead: fenced runs drop
        # (the new owner republishes them), still-owned runs redeliver.
        fenced_parts = {r[0] for r in self._written_runs
                        if not self.p.consumer.commit_allowed(r[0])}
        if fenced_parts:
            self._fence_abandon_closed(f, fenced_parts)
            return
        size = self.p.fs.size(f.path)
        self.p._flushed_records.mark(self._file_records)
        self.p._flushed_bytes.mark(size)
        self.p._file_size_histogram.update(size)
        self._mark_index_meters(f)
        (self.p._rotated_time if reason == "time"
         else self.p._rotated_revoke if reason == "revoke"
         else self.p._rotated_size).mark()
        dest = self._rename_and_move(f.path)
        self._fold_pipe_stats(f)
        self.current_file = None
        # ack strictly after durable publish (KPW.java:347-350).  A fenced
        # commit HERE means ownership moved between the pre-publish check
        # and the ack (the zombie window): with nothing acked yet the file
        # is un-published again and exactly-once is restored.
        pending = list(self._written_runs)
        self._written_runs.clear()
        self._unacked_count = 0
        self._oldest_unacked_ts = None
        i = 0
        try:
            while i < len(pending):
                partition, start, end = pending[i]
                self.p.consumer.ack_run(partition, start, end - start)
                i += 1
        except StaleGenerationError as e:
            self._fenced_ack_cleanup(dest, pending, i, e)

    def _fence_abandon_closed(self, f: ParquetFile,
                              fenced_parts: set) -> None:
        """The pre-publish fence tripped: ``f`` is closed but must not be
        published.  Delete the tmp, drop the fenced partitions' runs (the
        new owner redelivers them), and redeliver the still-owned runs
        whose rows just vanished with the file."""
        retained = [(p, s, e) for p, s, e in self._written_runs
                    if p not in fenced_parts]
        dropped = sum(e - s for p, s, e in self._written_runs
                      if p in fenced_parts)
        self.p._fence_abandons.mark()
        rec = self.p._flightrec
        if rec is not None:
            rec.note("rebalance_fence_abandon", worker=self.index,
                     partitions=sorted(fenced_parts),
                     dropped_records=dropped, retained_runs=len(retained))
        self._retry(lambda: self.p.fs.delete(f.path), "delete")
        self._fold_pipe_stats(f)
        self.current_file = None
        self._written_runs.clear()
        self._unacked_count = 0
        self._oldest_unacked_ts = None
        if retained:
            threading.Thread(
                target=self._redeliver_runs, args=(retained,),
                name=f"KPW-fence-redeliver-{self.index}",
                daemon=True).start()

    def _fenced_ack_cleanup(self, dest: str | None, pending: list,
                            acked: int, exc: Exception) -> None:
        """An ack commit came back fenced (StaleGenerationError) AFTER the
        file published — the zombie backstop.  With zero runs acked the
        published file vouches for nothing: delete it (un-publish) and
        exactly-once is restored — fenced runs redeliver through the new
        owner, still-owned runs through our own side-thread re-injection.
        With some runs already acked the file must stay (those offsets
        point into it); ack what this member still owns and drop the
        fenced rest — their rows become at-least-once duplicates, noted in
        the flight recorder."""
        con = self.p.consumer
        rest = pending[acked:]
        fenced = [r for r in rest if not con.commit_allowed(r[0])]
        retained = [r for r in rest if con.commit_allowed(r[0])]
        self.p._fenced_acks.mark()
        rec = self.p._flightrec
        if acked == 0 and dest is not None:
            self._retry(lambda: self.p.fs.delete(dest), "unpublish")
            if rec is not None:
                rec.note("rebalance_fenced_unpublish", worker=self.index,
                         file=dest,
                         fenced_partitions=sorted({r[0] for r in fenced}),
                         error=repr(exc))
            retained.extend(fenced)  # un-published: every run redelivers
            if retained:
                threading.Thread(
                    target=self._redeliver_runs,
                    args=([(p, s, e) for p, s, e in retained],),
                    name=f"KPW-fence-redeliver-{self.index}",
                    daemon=True).start()
            return
        for p, s, e in retained:
            try:
                con.ack_run(p, s, e - s)
            except StaleGenerationError:
                fenced.append([p, s, e])
        if rec is not None:
            rec.note("rebalance_fenced_ack_dropped", worker=self.index,
                     file=dest, dropped_runs=len(fenced), error=repr(exc))

    def _rename_and_move(self, tmp_path: str,
                         subdir: str | None = None) -> str:
        # (KPW.java:359-378); spanned as one publish stage so the e2e
        # stall breakdown can attribute verify+rename time per file.
        # ``subdir`` = the partition path in partitioned mode.  Returns
        # the published destination path (the fenced-ack un-publish
        # backstop needs the exact dest the rename landed on).
        with stage("worker.publish"):
            return self._rename_and_move_inner(tmp_path, subdir)

    def _rename_and_move_inner(self, tmp_path: str,
                               subdir: str | None = None) -> str:
        if self.p._b._verify_on_publish:
            # independent read-back BEFORE the rename: a structurally
            # invalid tmp (bad encode, torn write a retry never healed)
            # must never become a published file.  Verify failure is a
            # data error, not an IO error — quarantine the tmp and die
            # un-acked (redelivery), instead of retrying a rename that
            # would publish garbage
            rep = verify_file(self.p.fs, tmp_path)
            if rep.ok:
                self.p._verified.mark()
            else:
                self.p._verify_failed.mark()
                qpath = self.p._quarantine(tmp_path)
                raise PublishVerificationError(
                    f"tmp file failed structural verification and was "
                    f"quarantined to {qpath}: {rep.errors[:3]}")

        dest_dir = self.p.target_dir
        if subdir:
            # partition subtree first, then the optional date pattern —
            # readers prune on the partition keys, so they must own the
            # outer directory levels
            dest_dir = f"{dest_dir}/{subdir}"
            self._retry(lambda d=dest_dir: self.p.fs.mkdirs(d), "publish")
        pattern = self.p._b._directory_date_time_pattern
        if pattern:
            dest_dir = f"{dest_dir}/{_format_now(pattern)}"
            self._retry(lambda d=dest_dir: self.p.fs.mkdirs(d), "publish")
        return publish_rename(self.p.fs, self._retry, tmp_path, dest_dir,
                              self._new_file_name(),
                              self.p._b._durable_publish)
