"""Fluent, validated Builder — the framework's L5 public config surface.

Setter-for-setter parity with the reference Builder (KafkaProtoParquetWriter.
java:450-749) including defaults, the 100 KiB max-file-size floor (:453,564),
required-field validation (:729-733), and the offset-tracker open-page
auto-derivation / equation check (:735-746).  Deliberate divergences, per
SURVEY.md §5: `max_file_size=0` is rejected loudly (the reference's javadoc
falsely promises "no limit"), and the parquet page size defaults to 1 MiB
rather than inheriting the 128 MiB block size (a reference quirk).
"""

from __future__ import annotations

import math
import os
import socket

from ..core.compression import codec_from_name
from ..core.writer import WriterProperties
from ..io.fs import FileSystem, LocalFileSystem
from ..io.objectstore import ObjectStoreFileSystem

MIN_MAX_FILE_SIZE = 100 * 1024  # reference MIN_MAX_FILE_SIZE (KPW.java:453)


class Builder:
    def __init__(self) -> None:
        # required
        self._broker = None
        self._topic: str | None = None
        self._proto_class = None
        self._parser = None
        self._target_dir: str | None = None
        # defaults mirror KPW.java:455-490
        self._instance_name = f"{socket.gethostname()}-{os.getpid()}"
        self._thread_count = 1
        self._max_file_open_duration = 900.0  # seconds (:461)
        self._max_file_size = 1 << 30  # 1 GiB (:462)
        self._max_expected_throughput = 300_000  # records/s (:463)
        self._offset_tracker_page_size = 300_000  # (:466)
        self._offset_tracker_max_open_pages: int | None = None  # derived (:735-746)
        self._max_queued_records = 100_000  # (:468)
        self._fetch_max_records = 2000  # per broker fetch (seed when autotuned)
        # batch-native ingest: RecordBatch handoff broker -> queue -> wire
        # shredder (contiguous buffer + offsets, no per-record objects);
        # engages automatically when the broker offers fetch_batch AND the
        # wire fast path is live, else the per-record Record route runs
        self._batch_ingest = True
        # backpressure autotuning: derive fetch size / queue depth / poll
        # batch from measured stage rates (off = reference's fixed knobs)
        self._autotune = False
        self._block_size = 128 * 1024 * 1024  # (:473)
        self._page_size = 1024 * 1024  # sane default; NOT the reference quirk
        self._codec = 0  # UNCOMPRESSED (:484)
        self._compression_level: int | None = None  # codec default
        self._consumer_config: dict | None = None  # KPW.java:627-631 analog
        self._filesystem_config: dict | None = None  # KPW.java:662-666 analog
        self._enable_dictionary = True  # (:489)
        self._delta_fallback = False  # BASELINE config 3 opt-in (legacy)
        # adaptive per-column encodings (core/select_encoding.py):
        # stats-driven chooser pinned per file + explicit override map
        self._adaptive_encodings = False
        self._encodings: dict | None = None
        self._encoder_threads = 0  # native column-parallel encode (0 = auto)
        self._page_checksums = False  # parquet-mr 1.10 parity: no page CRCs
        # query-ready files (core/index.py): PARQUET-922 page indexes on
        # by default (parquet-mr 1.11 parity), bloom filters + sort-order
        # declarations opt-in
        self._page_index = True
        self._native_assembly = True  # nogil page assembly (native builds)
        self._bloom_columns: tuple | None = None
        self._bloom_fpp = 0.01
        self._bloom_max_bytes = 128 * 1024
        self._sorting_columns: tuple = ()
        # reference default yyyyMMdd-HHmmssSSS (:486-487): %3f is this
        # framework's millisecond token (strftime has none; %f would be
        # 6-digit microseconds and change the file-name shape)
        self._file_date_time_pattern = "%Y%m%d-%H%M%S%3f"
        self._directory_date_time_pattern: str | None = None
        self._file_extension = ".parquet"  # (:488)
        self._group_id: str | None = None
        self._metric_registry = None
        self._filesystem: FileSystem | None = None
        # the port's entry points run on the card unless asked otherwise
        self._backend = "cuda"
        self._backend_device = "cuda"
        # 3-stage ingest/encode/flush overlap; None = auto (on for
        # multicore hosts, inline when there is only one core to share —
        # thread hand-offs between stages then cost ~5-10% and add
        # run-to-run variance instead of overlapping anything)
        self._pipeline: bool | None = None
        self._batch_size = 4096
        self._on_parse_error = "raise"  # parity: poison pill kills the worker
        self._clean_abandoned_tmp = False  # opt-in tmp GC at start()
        # robustness: IO retry policy (None = default RetryPolicy — infinite
        # attempts, backoff+jitter, fatal-errno classification) and opt-in
        # worker supervision (the reference never restarts a dead worker)
        self._retry_policy = None
        self._supervise = False
        self._max_worker_restarts = 5
        self._restart_backoff = 0.1  # seconds; doubles per restart, cap 5 s
        # degraded operation (all opt-in; the reference has no answer to a
        # hung write, a full-then-cleared disk, or an unbounded close):
        # hung-IO watchdog, and fatal-errno pause/resume
        self._watchdog = False
        self._io_stall_deadline = 30.0
        self._watchdog_poll: float | None = None  # derived from the deadline
        self._abandon_stalled = False
        self._degraded_mode = False
        self._pause_probe_interval = 0.5
        self._pause_probe_max = 5.0
        self._max_pause: float | None = None  # None = pause indefinitely
        # durability: crash-consistent publish (fsync-before-rename +
        # dir-fsync) and independent structural verification.  All off by
        # default — fsync costs real milliseconds per publish (measured in
        # bench.py --crash) and the reference never fsyncs
        self._durable_publish = False
        self._verify_on_publish = False
        self._verify_on_startup = False
        # observability: span-timeline tracing (utils/tracing.py).  Off by
        # default — the disabled stage() path is a true no-op
        self._tracing = False
        self._trace_span_capacity = 65536
        self._trace_path: str | None = None
        # crash flight recorder (runtime/telemetry.py): bounded black box
        # of fault-path events, dumped as one JSON post-mortem on watchdog
        # kills, fatal-sink pauses, and poison quarantines.  ON by default
        # — it costs nothing until a fault path actually fires
        self._flightrec = True
        self._flightrec_dir: str | None = None  # None = <target_dir>
        # partitioned output (opt-in; the reference emits one flat stream):
        # record -> relative partition dir ahead of file assignment, with a
        # bound on concurrently open partition files per worker (LRU
        # close-and-publish eviction past it)
        self._partitioner = None
        self._max_open_partitions = 8
        # small-file compaction service (opt-in): background merge of
        # published under-size files into ~target-size files (io/compact.py)
        self._compaction: dict | None = None
        # process-parallel workers (opt-in): N spawned worker subprocesses
        # fed batches zero-copy through a shared-memory ring
        # (runtime/procworkers.py); 0 = thread workers (thread_count)
        self._proc_workers = 0
        self._proc_ring_slots = 16
        self._proc_slot_bytes = 1 << 20
        self._proc_max_inflight = 8
        # multi-tenant routes (runtime/multiwriter.py): route() specs;
        # build() returns a MultiWriter when any exist.  _queue_listener
        # is the consumer's queue-occupancy seam the MultiWriter wires
        # per route (the shared quota ledger's charge/credit source).
        self._routes: list[dict] = []
        self._queue_listener = None
        # consumer-group cooperative rebalance (ingest/broker.py group
        # coordination): how long a revocation may wait for in-flight
        # files holding revoked partitions' rows to flush+publish+ack
        # before the consumer confirms the handoff anyway (the abandoned
        # rows redeliver through the new owner — at-least-once either way)
        self._rebalance_drain_deadline = 5.0

    # -- required ----------------------------------------------------------
    def broker(self, broker) -> "Builder":
        """Record source: a FakeBroker or any object with the same interface
        (the reference requires `consumerConfig`; the broker client carries
        that role here)."""
        self._broker = broker
        return self

    def topic(self, topic: str) -> "Builder":
        self._topic = topic
        return self

    def proto_class(self, cls) -> "Builder":
        self._proto_class = cls
        return self

    def parser(self, fn) -> "Builder":
        """bytes -> message.  Defaults to proto_class.FromString."""
        self._parser = fn
        return self

    def target_dir(self, path: str) -> "Builder":
        self._target_dir = path
        return self

    # -- identity / scale --------------------------------------------------
    def instance_name(self, name: str) -> "Builder":
        self._instance_name = name
        return self

    def thread_count(self, n: int) -> "Builder":
        self._thread_count = n
        return self

    def group_id(self, gid: str) -> "Builder":
        self._group_id = gid
        return self

    def rebalance_drain_deadline_seconds(self, seconds: float) -> "Builder":
        """Cooperative-rebalance drain bound: how long a revocation may
        wait for this instance's in-flight files holding revoked
        partitions' rows to flush, publish and ack before the consumer
        confirms the handoff anyway (the still-open rows are then
        abandoned un-acked and redeliver through the new owner —
        at-least-once either way).  Only meaningful against a broker
        running group coordination (``FakeBroker(session_timeout_s=...)``
        or a real cluster)."""
        if seconds <= 0:
            raise ValueError("rebalance drain deadline must be > 0 "
                             f"(got {seconds})")
        self._rebalance_drain_deadline = seconds
        return self

    # -- rotation ----------------------------------------------------------
    def max_file_open_duration_seconds(self, seconds: float) -> "Builder":
        self._max_file_open_duration = seconds
        return self

    def max_file_size(self, nbytes: int) -> "Builder":
        self._max_file_size = nbytes
        return self

    # -- consumer sizing ---------------------------------------------------
    def max_expected_throughput_per_second(self, rps: int) -> "Builder":
        self._max_expected_throughput = rps
        return self

    def offset_tracker_page_size(self, n: int) -> "Builder":
        self._offset_tracker_page_size = n
        return self

    def offset_tracker_max_open_pages_per_partition(self, n: int) -> "Builder":
        self._offset_tracker_max_open_pages = n
        return self

    def max_queued_records_in_consumer(self, n: int) -> "Builder":
        self._max_queued_records = n
        return self

    def fetch_max_records(self, n: int) -> "Builder":
        """Records per broker fetch round (the reference's fetch sizing is
        Kafka client config; here it is explicit).  With :meth:`autotune`
        this is only the seed — the live value follows the measured drain
        rate."""
        if n < 1:
            raise ValueError("fetch_max_records must be >= 1")
        self._fetch_max_records = n
        return self

    def batch_ingest(self, flag: bool) -> "Builder":
        """Batch-native zero-copy ingest (default ON): the consumer fetches
        ``RecordBatch`` pages (one contiguous payload buffer + offset
        table per fetch, no per-record ``Record`` construction), the
        bounded queue carries them intact, acks ride their (partition,
        start, count) runs, and the wire shredder consumes buffer+offsets
        directly.  Requires a batch-capable broker (``fetch_batch``) and
        the wire fast path; anything else silently rides the per-record
        compatibility route, which also remains the poison-pill fallback.
        Pin False to force the per-record ``Record`` path everywhere
        (byte-identical output — pinned by test_batch_ingest)."""
        self._batch_ingest = flag
        return self

    def autotune(self, flag: bool = True) -> "Builder":
        """Backpressure autotuning (default OFF — reference parity is the
        fixed constants): derive the ingest knobs from measured stage
        rates instead of ``fetch_max_records`` / ``max_queued_records`` /
        ``batch_size`` as configured.  The fetcher sizes each fetch to
        ~50 ms of the queue's measured drain rate and the queue bound to
        ~0.5 s of it (never above the configured ``max_queued_records`` —
        that stays a hard ceiling); each worker sizes its poll batch to
        ~50 ms of its own measured shred+append rate, still clipped by
        the rotation-overshoot cap.  Tuned values and the rates that
        produced them are surfaced in ``stats()['consumer']['autotune']``
        and per-worker ``poll_batch``/``proc_rate_rps``."""
        self._autotune = flag
        return self

    # -- parquet properties ------------------------------------------------
    def block_size(self, nbytes: int) -> "Builder":
        self._block_size = nbytes
        return self

    def page_size(self, nbytes: int) -> "Builder":
        self._page_size = nbytes
        return self

    def compression(self, codec) -> "Builder":
        """name ('snappy', 'zstd', 'gzip', 'uncompressed') or Codec value."""
        self._codec = codec_from_name(codec)
        return self

    def compression_level(self, level: int | None) -> "Builder":
        """Codec compression level for level-capable codecs (zstd -22..22,
        default 3; gzip 0-9, default 6).  None = codec default.  Setting a
        level with snappy/uncompressed is rejected at build() (those codecs
        have no level knob; a silently-ignored setting would mask a config
        mistake) — parity with parquet-mr's codec-level configuration
        surface."""
        self._compression_level = level  # validated against the codec in build()
        return self

    def enable_dictionary(self, flag: bool) -> "Builder":
        self._enable_dictionary = flag
        return self

    def page_checksums(self, flag: bool) -> "Builder":
        """Write the optional CRC-32 field (gzip polynomial, PARQUET-1539)
        in every page header so readers that verify checksums (e.g. pyarrow
        page_checksum_verification) detect torn/corrupt pages.  Off by
        default — parity with parquet-mr 1.10, which doesn't write page
        CRCs."""
        self._page_checksums = flag
        return self

    def page_index(self, flag: bool) -> "Builder":
        """Emit PARQUET-922 ColumnIndex/OffsetIndex sections (per-page
        min/max/null-count + page locations, ``core/index.py``) in every
        published file, so selective readers prune pages without reading
        them.  ON by default (parquet-mr 1.11 parity); off restores the
        exact pre-index file bytes."""
        self._page_index = flag
        return self

    def native_assembly(self, flag: bool) -> "Builder":
        """Nogil batch page assembly (native/src/assemble.cc): the native
        and TPU backends lower each chunk's resolved page plan to flat
        tables and assemble (gather + RLE + compress + CRC + page stats)
        in ONE GIL-released native call per column, so the shared assembly
        pool and worker threads scale across real cores.  ON by default
        wherever the extension loads and the codec is covered
        (uncompressed / snappy / zstd); ``False`` opts out, restoring the
        pure-Python page loops byte-identically (the output file bytes are
        pinned equal either way)."""
        self._native_assembly = flag
        return self

    def bloom_filters(self, columns=(), *, fpp: float = 0.01,
                      max_bytes: int = 128 * 1024) -> "Builder":
        """Split-block bloom filters (parquet SBBF, xxhash64) per column
        chunk.  ``columns=()`` (the default when called) auto-selects
        string columns plus any column whose chunk dictionary-encoded —
        the dictionary build's exact distinct set makes population a
        k-hash pass; a tuple of field names pins the set; ``None``
        disables (the Builder default).  ``fpp`` sizes the filter
        (parquet-mr's bits formula), ``max_bytes`` caps it (rounded down
        to a power of two).  Off by default: filters cost file bytes and
        the reference writes none."""
        if columns is not None:
            if isinstance(columns, str):
                columns = (columns,)
            columns = tuple(columns)
            if not 0.0 < fpp < 1.0:
                raise ValueError("fpp must be in (0, 1)")
            if max_bytes < 32:
                raise ValueError("max_bytes must be >= 32")
        self._bloom_columns = columns
        self._bloom_fpp = fpp
        self._bloom_max_bytes = max_bytes
        return self

    def sort_order(self, *columns, descending: bool = False,
                   nulls_first: bool = False) -> "Builder":
        """Declare ``sorting_columns`` row-group metadata: every published
        row group claims its rows are ordered by these schema leaves (in
        the given precedence).  A DECLARATION, not a sort — the writer
        streams records in arrival order, so use this when the upstream
        feed is ordered (or let sort-on-compact, ``io/compact.py``,
        physically sort and declare on merge).  The structural verifier
        cross-checks the declaration against the page index's boundary
        order, so a false claim fails verify-on-publish instead of
        poisoning downstream readers."""
        if not columns:
            raise ValueError("sort_order needs at least one column name")
        self._sorting_columns = tuple(
            (c, descending, nulls_first) for c in columns)
        return self

    def delta_fallback(self, flag: bool) -> "Builder":
        """Use DELTA_BINARY_PACKED / DELTA_LENGTH_BYTE_ARRAY instead of
        PLAIN when a column's dictionary is rejected (high cardinality).

        LEGACY SPELLING: since the adaptive-encoding chooser landed
        (core/select_encoding.py) this is a forced per-type override rule
        inside it, kept for back-compat (same bytes as before).  Prefer
        :meth:`encodings` — ``adaptive=True`` for the stats-driven
        chooser, or an explicit per-column map."""
        self._delta_fallback = flag
        return self

    def encodings(self, mapping: dict | None = None, *,
                  adaptive: bool | None = None) -> "Builder":
        """Per-column value encodings (core/select_encoding.py).

        ``mapping`` pins columns explicitly: ``{column_name_or_dotted_path:
        Encoding-or-name}`` — e.g. ``{"price": "byte_stream_split",
        "seq": Encoding.DELTA_BINARY_PACKED}``.  A pinned column skips the
        dictionary attempt entirely.  ``adaptive=True`` turns on the
        stats-driven chooser for everything else: the first row group's
        observed stats (cardinality, delta width, value width, null
        density) pick among PLAIN / dictionary / DELTA_BINARY_PACKED /
        DELTA_LENGTH_BYTE_ARRAY / BYTE_STREAM_SPLIT, and the decision is
        pinned for the rest of the file (reader coherence).  Encoding
        values validate here; column names validate against the proto
        schema at :meth:`build` (like sort_order / bloom_filters)."""
        if mapping is not None:
            from ..core.select_encoding import _normalize_overrides

            mapping = _normalize_overrides(mapping)  # raises on bad values
        self._encodings = mapping
        if adaptive is not None:
            self._adaptive_encodings = bool(adaptive)
        return self

    def encoder_threads(self, n: int) -> "Builder":
        """Column-parallel encode threads in the native backend per worker
        (0 = one per core, 1 = sequential).  Orthogonal to thread_count,
        which parallelizes across files like the reference."""
        if n < 0:
            raise ValueError("encoder_threads must be >= 0")
        self._encoder_threads = n
        return self

    # -- naming / placement ------------------------------------------------
    def file_date_time_pattern(self, strftime_pattern: str) -> "Builder":
        """strftime pattern for the published file-name timestamp; ``%3f``
        expands to zero-padded milliseconds (the reference's ``SSS``,
        KPW.java:486-487 — plain strftime has no millisecond token)."""
        self._file_date_time_pattern = strftime_pattern
        return self

    def directory_date_time_pattern(self, strftime_pattern: str | None) -> "Builder":
        self._directory_date_time_pattern = strftime_pattern
        return self

    def file_extension(self, ext: str) -> "Builder":
        self._file_extension = ext
        return self

    # -- pass-through config maps (KPW.java:627-631, :662-666) --------------
    def consumer_config(self, config: dict) -> "Builder":
        """Raw Kafka consumer config map, pass-through parity with the
        reference's ``consumerConfig`` (KafkaProtoParquetWriter.java:627-631).
        When no ``broker()`` is supplied, ``build()`` constructs a real
        ``KafkaBrokerClient`` from it — ``bootstrap.servers`` (or
        ``bootstrap_servers``) is then required; every other key is handed to
        the kafka-python consumer verbatim (dotted Kafka names are translated
        to kafka-python's underscore kwargs)."""
        self._consumer_config = dict(config)
        return self

    def filesystem_config(self, config: dict) -> "Builder":
        """Raw filesystem config map, pass-through parity with the
        reference's ``hadoopConf`` (KafkaProtoParquetWriter.java:662-666).
        When no ``filesystem()`` is supplied, ``build()`` resolves the sink
        from ``fs.defaultFS`` exactly like the reference (KPW.java:137-141):
        ``hdfs://host:port`` -> HdfsFileSystem (remaining keys passed as
        libhdfs extra_conf), ``file://`` or absent -> LocalFileSystem."""
        self._filesystem_config = dict(config)
        return self

    # -- plumbing ----------------------------------------------------------
    def metric_registry(self, registry) -> "Builder":
        self._metric_registry = registry
        return self

    def filesystem(self, fs: FileSystem) -> "Builder":
        self._filesystem = fs
        return self

    def object_store(self, store, bucket: str = "kpw", *,
                     part_size: int = 8 * 1024 * 1024,
                     pipeline_uploads: bool = True,
                     spill_threshold_bytes: int | None = None) -> "Builder":
        """Publish to an S3/GCS-class object store (``io/objectstore.py``):
        the sink becomes an :class:`~kpw_tpu_torch.io.objectstore.
        ObjectStoreFileSystem` over ``store``/``bucket``, whose atomic
        publish is multipart-complete instead of ``durable_rename`` (the
        capability seam — no rename, no fsync on an object store).
        Encoded row groups stream to the store as ``part_size`` parts
        *while each file is still open* (``pipeline_uploads``; upload
        hides under encode — overlap surfaced in
        ``stats()['objectstore']``), so closing a file costs one tail
        part and the publish is one ``complete`` call.  Request/byte
        accounting and the observed-bandwidth gauge ride the canonical
        ``parquet.writer.objstore.*`` names.  ``spill_threshold_bytes``
        bounds each write handle's retained buffer: past it the retained
        file bytes roll to an anonymous local tmp file (seek-back
        re-upload and close-time re-ship stay byte-perfect), so memory
        stays bounded at GiB-rotation scale."""
        self._filesystem = ObjectStoreFileSystem(
            store, bucket, part_size=part_size,
            pipeline_uploads=pipeline_uploads,
            spill_threshold_bytes=spill_threshold_bytes)
        return self

    def encoder_backend(self, backend, device="cuda") -> "Builder":
        """'cuda' (the default: ``CudaChunkEncoder`` on ``device``) |
        'native' | 'cpu' | 'auto' (chosen by ``runtime/select.py``) |
        'mesh' (``parallel/mesh_encoder.py``: a ``MeshChunkEncoder`` over
        ``make_mesh(device=device)``, one shard per visible card, whose
        dictionaries are merged across the shards), or an object with
        encode(chunk, offset).  'cuda', 'auto' and 'mesh' raise at
        ``build()`` when ``device`` is 'cuda' and there is no card; pass
        ``device='cpu'`` to run the card's encoders on the CPU."""
        self._backend = backend
        self._backend_device = device
        return self

    def batch_size(self, n: int) -> "Builder":
        self._batch_size = n
        return self

    def pipeline(self, flag: bool) -> "Builder":
        """Overlap ingest/shred, row-group encode, and IO in three stages
        per worker (SURVEY.md §2.4 pipeline parallelism — the reference's
        hot loop is serial).  Default is automatic: on when the host has
        more than one core, inline on single-core hosts (the stages then
        contend for the one core instead of overlapping).  Set explicitly
        to pin either mode."""
        self._pipeline = flag
        return self

    def retry_policy(self, policy) -> "Builder":
        """IO retry policy for every write-path seam (worker flush/close/
        publish/dead-letter, consumer fetch/commit).  Default: infinite
        attempts with exponential backoff + decorrelated jitter and
        fatal-by-default classification of non-transient errnos (ENOSPC /
        EROFS / EDQUOT kill the worker instead of spinning).  Pass
        ``RetryPolicy.reference()`` to restore the reference's pure
        fixed-100ms retry-everything loop, or a bounded policy
        (``max_attempts`` / ``deadline``) to cap the spin."""
        from .retry import RetryPolicy

        if policy is not None and not isinstance(policy, RetryPolicy):
            raise TypeError("retry_policy expects a RetryPolicy instance")
        self._retry_policy = policy
        return self

    def supervise(self, flag: bool = True, max_restarts: int = 5,
                  restart_backoff_seconds: float = 0.1) -> "Builder":
        """Supervised worker recovery: detect a dead worker, re-inject its
        never-acked offsets into the shared queue, and restart it — up to
        ``max_restarts`` times per worker slot with exponential backoff
        starting at ``restart_backoff_seconds``.  Redelivery-by-restart
        preserves at-least-once (the dead worker's records were never
        acked).  When every worker is dead with its budget exhausted the
        writer is terminally failed and ``close()`` raises
        ``WriterFailedError``.  Off by default (reference parity: a dead
        worker stays dead until process restart — but death is still
        visible via ``healthy()`` / ``stats()`` / the failed meter)."""
        if max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        if restart_backoff_seconds < 0:
            raise ValueError("restart_backoff_seconds must be >= 0")
        self._supervise = flag
        self._max_worker_restarts = max_restarts
        self._restart_backoff = restart_backoff_seconds
        return self

    def watchdog(self, flag: bool = True, *,
                 io_stall_deadline_seconds: float = 30.0,
                 poll_interval_seconds: float | None = None,
                 abandon_stalled: bool = False) -> "Builder":
        """Hung-IO watchdog (``runtime/watchdog.py``): workers and the
        pipelined row-group IO thread publish a progress heartbeat around
        every IO seam, and a supervisor-owned scanner flags any worker
        whose oldest in-flight IO op is older than
        ``io_stall_deadline_seconds`` — storage that HANGS rather than
        errors is otherwise invisible (no errno, no dead thread, no retry
        fires).  A stall flips ``healthy()`` false, marks the
        ``parquet.writer.stalled`` meter once per episode, and surfaces
        per-worker stall age + seam label in ``stats()``.

        With ``abandon_stalled=True`` the stalled worker is condemned:
        declared failed while its thread is still parked in the hung call,
        so the supervisor (``Builder.supervise`` — required for the
        restart half) restarts the slot and re-injects the held un-acked
        offset runs.  Redelivery preserves at-least-once; the stuck tmp is
        left un-published and swept on the next start.  An abandon
        consumes a supervisor restart, never a retry budget — the hung
        call never returned, so the policy never saw an attempt fail.  A
        *progressing* retry loop (attempts returning, backoff between
        them) re-stamps the heartbeat and is never treated as a hang.
        Off by default: zero threads, zero heartbeat cost beyond a dict
        store per IO call."""
        if io_stall_deadline_seconds <= 0:
            raise ValueError("io_stall_deadline_seconds must be positive")
        if (poll_interval_seconds is not None
                and poll_interval_seconds <= 0):
            raise ValueError("poll_interval_seconds must be positive")
        self._watchdog = flag
        self._io_stall_deadline = io_stall_deadline_seconds
        self._watchdog_poll = poll_interval_seconds
        self._abandon_stalled = abandon_stalled
        return self

    def degraded_mode(self, flag: bool = True, *,
                      probe_interval_seconds: float = 0.5,
                      probe_backoff_max_seconds: float = 5.0,
                      max_pause_seconds: float | None = None) -> "Builder":
        """Fatal-errno pause/resume: a worker hitting a fatal-classified
        errno (ENOSPC/EROFS/EDQUOT — conditions a restart cannot fix but
        an operator or time often does) PAUSES instead of dying.  The open
        file is abandoned un-acked, intake stops (the shared queue fills,
        the fetcher blocks on the bounded put — backpressure reaches the
        broker session without dropping it), and a probe loop retests the
        sink with exponential backoff (``probe_interval_seconds`` →
        ``probe_backoff_max_seconds``).  On a successful probe the worker
        re-injects its held offset runs (redelivery — the records were
        never acked) and resumes cleanly.  Pause cause/age land in
        ``stats()['degraded']`` and the ``parquet.writer.paused`` gauge
        counts paused workers.  ``max_pause_seconds`` bounds the wait:
        past it the pause converts into the normal fatal worker death
        (supervision/terminal semantics take over).  Off by default —
        reference parity is fatal-errno death, which burns the supervisor
        restart budget on a condition restarting cannot fix."""
        if probe_interval_seconds <= 0:
            raise ValueError("probe_interval_seconds must be positive")
        if probe_backoff_max_seconds < probe_interval_seconds:
            raise ValueError("probe_backoff_max_seconds must be >= "
                             "probe_interval_seconds")
        if max_pause_seconds is not None and max_pause_seconds <= 0:
            raise ValueError("max_pause_seconds must be positive")
        self._degraded_mode = flag
        self._pause_probe_interval = probe_interval_seconds
        self._pause_probe_max = probe_backoff_max_seconds
        self._max_pause = max_pause_seconds
        return self

    def durability(self, fsync: bool = True, *,
                   verify_on_publish: bool = False,
                   verify_on_startup: bool = False) -> "Builder":
        """Crash-consistency discipline for the publish protocol, three
        independent opt-ins (all default off — each costs time on the hot
        rotation path, measured by ``bench.py --crash``):

        * ``fsync`` — publish via durable rename: fsync the tmp file
          BEFORE the atomic rename, fsync the destination directory AFTER
          (``FileSystem.durable_rename``).  Without it a published-then-
          acked file can vanish in a power cut (the rename lived only in
          the page cache) — a plain process ``kill -9`` is already safe
          either way, because the page cache survives process death and
          the ack happens after rename returns.
        * ``verify_on_publish`` — run the independent structural verifier
          (``kpw_tpu_torch.io.verify``) over the closed tmp file before the
          rename.  A file that fails is moved to
          ``{target_dir}/quarantine/`` (never published, never deleted)
          and the worker dies un-acked, so the records are redelivered —
          a corrupt encode can then never be acked.
        * ``verify_on_startup`` — ``start()`` verifies every published
          ``.parquet`` under the target dir and quarantines structural
          failures (torn finals from a previous crash) before new work
          begins; the sweep's manifest lands in ``stats()['recovery']``.
        """
        self._durable_publish = fsync
        self._verify_on_publish = verify_on_publish
        self._verify_on_startup = verify_on_startup
        return self

    def clean_abandoned_tmp(self, flag: bool) -> "Builder":
        """Delete this instance's stale .tmp files at start() (crash
        leftovers the reference never GCs, SURVEY.md §3.5).  Off by default:
        only safe when at most one live writer uses this instance name."""
        self._clean_abandoned_tmp = flag
        return self

    def tracing(self, flag: bool = True,
                span_capacity: int = 65536) -> "Builder":
        """Record per-stage spans while the writer runs: start() installs a
        process-wide StageTimer + SpanRecorder (a bounded ring buffer of
        ``span_capacity`` spans, oldest evicted first) that every
        ``stage(...)`` site feeds; close() uninstalls them.  Read the
        results via ``writer.stats()`` (cumulative stage timers) and
        ``writer.write_trace(path)`` (Chrome/Perfetto timeline JSON).
        Process-wide: two concurrently-started tracing writers would share
        one recorder — enable it on the writer under investigation."""
        self._tracing = flag
        if span_capacity <= 0:
            raise ValueError("span_capacity must be positive")
        self._trace_span_capacity = span_capacity
        return self

    def trace_path(self, path: str | None) -> "Builder":
        """Write the span timeline as Chrome-trace JSON to ``path`` at
        close().  Implies :meth:`tracing`."""
        self._trace_path = path
        if path:
            self._tracing = True
        return self

    def flight_recorder(self, flag: bool = True, *,
                        path: str | None = None) -> "Builder":
        """The crash black box (``runtime/telemetry.py``): a bounded ring
        of fault-path events (stalls, pauses, quarantines, child deaths)
        dumped as one JSON post-mortem — naming the trigger and the
        stalled stage — when the watchdog kills a hung worker, a worker
        pauses on a fatal sink condition, or a file is quarantined.  ON
        by default (zero cost until a fault fires); ``path`` overrides
        the dump directory (default ``<target_dir>/flightrec/`` on the
        LOCAL filesystem — a black box that publishes through the
        possibly-failing sink would lose exactly the crashes it exists
        to explain)."""
        self._flightrec = flag
        self._flightrec_dir = path
        return self

    def partition_by(self, spec, *, time_pattern: str | None = None,
                     time_unit: str = "s",
                     max_open_partitions: int = 8) -> "Builder":
        """Hive-style partitioned output: route each record into a
        partition subdirectory of the target dir ahead of file
        assignment, with per-partition open files and per-partition
        size/time rotation accounting (``runtime/partition.py``).

        ``spec`` is one of:

        * a protobuf **field name** (or tuple of them) — Hive
          ``{field}={value}`` segments from the parsed message; with
          ``time_pattern`` the single named field is instead read as an
          epoch (``time_unit``: ``s``/``ms``/``us``) and bucketed through
          the strftime pattern in UTC (e.g. ``"dt=%Y%m%d/hour=%H"``),
        * a **callable** ``(record, message) -> relative_path``,
        * a prebuilt :class:`~kpw_tpu_torch.runtime.partition.Partitioner`.

        ``max_open_partitions`` bounds the partition files each worker
        holds open at once; routing to a new partition past the bound
        closes-and-publishes the least-recently-written one (metered as
        ``parquet.writer.partitions.evicted``).  Ack granularity becomes
        the checkpoint: offsets commit when every open partition file has
        published (at the latest, each ``max_file_open_duration_seconds``
        — a record's file must be durable before its offset is acked, and
        one poll batch scatters across partitions).  A partitioner that
        raises is handled under the :meth:`on_parse_error` policy.
        Partitioning disqualifies the wire-shred fast path (routing needs
        the parsed message)."""
        from .partition import EventTimePartitioner, make_partitioner

        if max_open_partitions < 1:
            raise ValueError("max_open_partitions must be >= 1")
        if time_pattern is not None:
            if not isinstance(spec, str):
                raise ValueError("time_pattern needs a single epoch field "
                                 "name as the partition spec")
            self._partitioner = EventTimePartitioner(
                spec, pattern=time_pattern, unit=time_unit)
        else:
            self._partitioner = make_partitioner(spec)
        self._max_open_partitions = max_open_partitions
        return self

    def compaction(self, target_size: int, *,
                   scan_interval_seconds: float = 5.0,
                   min_files: int = 2,
                   small_file_ratio: float = 0.5,
                   sort_by=None,
                   bandwidth_bytes_per_s: float | None = None,
                   request_budget_per_round: int | None = None,
                   partition_quota: int | None = None) -> "Builder":
        """Background small-file compaction (``kpw_tpu_torch.io.compact``):
        start() launches a :class:`~kpw_tpu_torch.io.compact.Compactor` over the
        target dir that merges published files smaller than
        ``small_file_ratio * target_size`` (per partition directory, name
        order, >= ``min_files`` per merge) into ~``target_size`` outputs —
        rewritten through the writer's own encode machinery, structurally
        verified BEFORE the ``durable_rename`` publish, inputs then
        retired into the ``compacted/`` tombstone tree (moved, never
        deleted) so a kill -9 at any instant leaves every row in at least
        one verified published file.  ``sort_by`` (a proto field name, or
        ``(field, descending)``) turns on sort-on-compact: merged outputs
        are physically re-sorted by the field and declare
        ``sorting_columns`` row-group metadata, verified against the page
        index's boundary order before publish — streaming output acquires
        its reader-exploitable sort order here, in the background tier.
        Stats land in ``stats()['compactor']``; meters are
        ``parquet.compactor.merged|retired|failed``.  Off by default —
        compaction is a second read+write of every small byte, a cost the
        flat reference never pays.

        The REMOTE tier (object-store targets): ``bandwidth_bytes_per_s``
        throttles merge reads and merge-output writes through one shared
        token bucket so the compactor's traffic stays under the budget;
        ``request_budget_per_round`` defers further merges once a round
        issued that many filesystem requests (per-request cost control);
        ``partition_quota`` caps merges per partition directory per round
        (per-partition fairness).  All None by default (local tier)."""
        if target_size <= 0:
            raise ValueError("target_size must be positive")
        if scan_interval_seconds <= 0:
            raise ValueError("scan_interval_seconds must be positive")
        if min_files < 2:
            raise ValueError("min_files must be >= 2")
        if not 0.0 < small_file_ratio <= 1.0:
            raise ValueError("small_file_ratio must be in (0, 1]")
        if bandwidth_bytes_per_s is not None and bandwidth_bytes_per_s <= 0:
            raise ValueError("bandwidth_bytes_per_s must be positive")
        if (request_budget_per_round is not None
                and request_budget_per_round < 1):
            raise ValueError("request_budget_per_round must be >= 1")
        if partition_quota is not None and partition_quota < 1:
            raise ValueError("partition_quota must be >= 1")
        self._compaction = {
            "target_size": target_size,
            "scan_interval_s": scan_interval_seconds,
            "min_files": min_files,
            "small_file_ratio": small_file_ratio,
            "sort_by": sort_by,
            "bandwidth_bytes_per_s": bandwidth_bytes_per_s,
            "request_budget_per_round": request_budget_per_round,
            "partition_quota": partition_quota,
        }
        return self

    def process_workers(self, n: int, *, ring_slots: int = 16,
                        slot_bytes: int = 1 << 20,
                        max_inflight_units: int = 8) -> "Builder":
        """Process-parallel workers (``runtime/procworkers.py``): run the
        shred → encode → assemble → publish leg in ``n`` **spawned**
        subprocesses instead of ``thread_count`` threads, escaping the
        single-interpreter GIL ceiling.  Batches cross the process
        boundary zero-copy through a ``multiprocessing.shared_memory``
        ring of ``ring_slots`` × ``slot_bytes`` batch slots (parent
        stages the poll batch with one memcpy — the same single copy the
        thread path pays out of the broker log — and the child shreds the
        slot's buffer in place); offsets stay tracked and acked in the
        parent, committed only on the child's published-file
        acknowledgment, so at-least-once is unchanged.  The supervisor
        (``supervise``), watchdog (``watchdog`` — a condemned child is
        SIGKILLed and its slot restarted) and ``stats()`` operate on
        process slots exactly as on threads; per-child rss / ring
        occupancy / restart counts land in ``stats()['procs']``.

        ``max_inflight_units`` bounds un-acked dispatched units per child
        (bounds redelivery work after a kill).  Constraints (validated at
        ``build()``): spawn start method only (fork with live CUDA and
        encoder threads is unsafe), a ``LocalFileSystem`` sink, a message
        class with a descriptor (children rebuild it: a protobuf class
        from its ``FileDescriptorProto`` closure, a descriptor stand-in
        from a plain-data snapshot, without protobuf), no
        ``partition_by``, and a cpu/native/auto/cuda encoder backend.
        With ``"cuda"`` each child runs its own ``CudaChunkEncoder`` on
        the builder's device, on a CUDA stream of its own; the JAX
        package's children reach the card only through ``"auto"``.
        ``n=0`` restores thread workers."""
        if n < 0:
            raise ValueError("process_workers must be >= 0")
        if ring_slots < 2:
            raise ValueError("ring_slots must be >= 2")
        if slot_bytes < 4096:
            raise ValueError("slot_bytes must be >= 4096")
        if max_inflight_units < 1:
            raise ValueError("max_inflight_units must be >= 1")
        self._proc_workers = n
        self._proc_ring_slots = ring_slots
        self._proc_slot_bytes = slot_bytes
        self._proc_max_inflight = max_inflight_units
        return self

    def route(self, topic: str, proto_class, target_dir: str, *,
              name: str | None = None, queue_quota: int | None = None,
              open_file_budget: int | None = None,
              ack_sla_seconds: float | None = None,
              **overrides) -> "Builder":
        """Declare one multi-tenant route (``runtime/multiwriter.py``):
        a (topic, proto, target_dir) triple that shares this builder's
        broker session, encoder pool and compaction service with every
        other route but lives in its own BULKHEAD — its own workers,
        consumer queue, ack frontier and fault domain.  With any route
        declared, ``build()`` returns a
        :class:`~kpw_tpu_torch.runtime.multiwriter.MultiWriter` instead of a
        single writer (the base builder's ``topic``/``proto_class``/
        ``target_dir`` are then unused).

        * ``name`` — the tenant name (defaults to the topic); keys the
          per-tenant stats/quota/status surfaces.
        * ``queue_quota`` — this tenant's queue share: the records it
          may hold in its consumer queue before its OWN fetch gate
          parks (backpressure on the offender, never drop; stall
          episodes metered as ``parquet.writer.tenant.queue.stalls``).
        * ``open_file_budget`` — the LRU bound generalized across
          the route's workers: at the budget, opening one more
          partition file first closes-and-publishes the route's own LRU
          open file (``parquet.writer.tenant.files.evicted``).
        * ``ack_sla_seconds`` — the route's declared ack-lag SLA,
          surfaced (and checked live as ``sla_violated``) in
          ``stats()['tenants']`` — the observable ``bench.py --tenants``
          proves noisy neighbors cannot violate.
        * ``**overrides`` — any Builder setter by name, applied to this
          route's cloned builder: a scalar for one-argument setters
          (``thread_count=2``, ``on_parse_error="dead_letter"``), a
          tuple for positional args, a dict for keyword args
          (``durability={"fsync": False, "verify_on_publish": True}``).
        """
        for key in overrides:
            setter = getattr(Builder, key, None)
            if not callable(setter):
                raise ValueError(
                    f"route override {key!r} is not a Builder setter")
        if queue_quota is not None and queue_quota < 1:
            raise ValueError("queue_quota must be >= 1")
        if open_file_budget is not None and open_file_budget < 1:
            raise ValueError("open_file_budget must be >= 1")
        if ack_sla_seconds is not None and ack_sla_seconds <= 0:
            raise ValueError("ack_sla_seconds must be positive")
        rname = name or topic
        if any(r["name"] == rname for r in self._routes):
            raise ValueError(f"duplicate route name {rname!r}")
        self._routes.append({
            "name": rname,
            "topic": topic,
            "proto_class": proto_class,
            "target_dir": target_dir,
            "queue_quota": queue_quota,
            "open_file_budget": open_file_budget,
            "ack_sla_seconds": ack_sla_seconds,
            "overrides": dict(overrides),
        })
        return self

    def on_parse_error(self, policy: str) -> "Builder":
        """'raise' (reference parity: poison pill kills the worker,
        KPW.java:271-275), 'skip' (log + ack), or 'dead_letter' (raw payload
        appended to targetDir/deadletter/{instance}_{worker}.bin, then
        ack)."""
        if policy not in ("raise", "skip", "dead_letter"):
            raise ValueError(
                "on_parse_error must be 'raise', 'skip' or 'dead_letter'")
        self._on_parse_error = policy
        return self

    # -- build -------------------------------------------------------------
    def _broker_from_consumer_config(self):
        """Construct a real KafkaBrokerClient from the pass-through map
        (the reference builds its consumer from consumerConfig the same way,
        KPW.java:153-163)."""
        cfg = {k.replace(".", "_"): v for k, v in self._consumer_config.items()}
        servers = cfg.pop("bootstrap_servers", None)
        if servers is None:
            raise ValueError(
                "consumer_config needs 'bootstrap.servers' when no broker() "
                "is supplied")
        # group.id in the map names the consumer group (KPW.java:158 only
        # defaults it when absent) — route it to the writer's group id, which
        # is what join_group hands the Kafka client; a conflicting explicit
        # group_id() is a config error, not a silent override
        cfg_group = cfg.pop("group_id", None)
        if cfg_group is not None:
            if self._group_id is not None and self._group_id != cfg_group:
                raise ValueError(
                    f"conflicting consumer groups: group_id({self._group_id!r})"
                    f" vs consumer_config group.id {cfg_group!r}")
            self._group_id = cfg_group
        from ..ingest.kafka_client import KafkaBrokerClient

        return KafkaBrokerClient(servers, client_config=cfg)

    def _filesystem_from_config(self):
        """Resolve the sink from fs.defaultFS (KPW.java:137-141 parity)."""
        cfg = dict(self._filesystem_config)
        default_fs = cfg.pop("fs.defaultFS", cfg.pop("fs_defaultFS", ""))
        if default_fs.startswith("hdfs://"):
            from urllib.parse import urlparse

            from ..io.hdfs import HdfsFileSystem

            u = urlparse(default_fs)
            return HdfsFileSystem(host=u.hostname or "default",
                                  port=u.port or 8020,
                                  extra_conf=cfg or None)
        if default_fs and not default_fs.startswith("file://"):
            raise ValueError(f"unsupported fs.defaultFS scheme: {default_fs}")
        return LocalFileSystem()

    def build(self):
        if self._broker is None and self._consumer_config is not None:
            self._broker = self._broker_from_consumer_config()
        if self._routes:
            # multi-tenant mode: the MultiWriter clones this builder per
            # route (topic/proto/target applied there) and shares the
            # broker session, encoder pool and compaction service
            from .multiwriter import MultiWriter

            return MultiWriter(self)
        if self._filesystem is None and self._filesystem_config is not None:
            self._filesystem = self._filesystem_from_config()
        # required fields (reference :729-733)
        missing = [name for name, v in [
            ("broker", self._broker),
            ("topic", self._topic),
            ("proto_class", self._proto_class),
            ("target_dir", self._target_dir),
        ] if v is None]
        if missing:
            raise ValueError(f"missing required builder fields: {missing}")
        if self._compression_level is not None:
            from ..core.schema import Codec

            lo, hi = {Codec.GZIP: (0, 9), Codec.ZSTD: (-22, 22)}.get(
                self._codec, (None, None))
            if lo is None:
                raise ValueError(
                    "compression_level is only meaningful for gzip/zstd "
                    f"(codec={self._codec})")
            if not lo <= self._compression_level <= hi:
                raise ValueError(
                    f"compression_level {self._compression_level} outside "
                    f"[{lo}, {hi}] for this codec")
        if self._max_file_size < MIN_MAX_FILE_SIZE:
            raise ValueError(
                f"max_file_size must be >= {MIN_MAX_FILE_SIZE} bytes "
                f"(got {self._max_file_size})")
        if self._pipeline is None:
            # auto: stage overlap needs a second core to overlap onto —
            # counted from the process's affinity mask (cgroup/taskset
            # limits), not the host's physical core count
            try:
                avail = len(os.sched_getaffinity(0))
            except (AttributeError, OSError):
                avail = os.cpu_count() or 1
            self._pipeline = avail > 1
        if self._thread_count < 1:
            raise ValueError("thread_count must be >= 1")
        # offset tracker sizing (reference :735-746): open pages must cover
        # max_throughput * max_open_duration outstanding offsets
        need = self._max_expected_throughput * self._max_file_open_duration
        if self._offset_tracker_max_open_pages is None:
            self._offset_tracker_max_open_pages = max(
                1, math.ceil(need / self._offset_tracker_page_size))
        elif (self._offset_tracker_max_open_pages
              * self._offset_tracker_page_size) < need:
            raise ValueError(
                "offset_tracker_max_open_pages_per_partition * page_size must "
                "cover max_expected_throughput * max_file_open_duration "
                f"({self._offset_tracker_max_open_pages} * "
                f"{self._offset_tracker_page_size} < {int(need)})")
        # a custom parser (envelope stripping, transforms) disqualifies the
        # wire-shred fast path: the raw payload is then NOT the message
        # bytes.  Passing the class's own FromString/parser explicitly IS
        # the default parse (README quickstart does exactly that), so it
        # keeps the fast path — ~4x streaming throughput.
        # identity-based: never invokes a user callable's __eq__ (a loose
        # or raising __eq__ must not silently flip the fast path)
        self._parser_is_default = (
            self._parser is None
            or (getattr(self._parser, "__self__", None)
                is self._proto_class
                and getattr(self._parser, "__name__", None) == "FromString"))
        if self._parser is None:
            self._parser = self._proto_class.FromString
        # resolve sort/bloom column names against the proto schema HERE:
        # ParquetFileWriter._resolve_sorting would otherwise first raise
        # inside every worker's background file-open (a supervised
        # restart storm, not a config error), and a misspelled pinned
        # bloom column would silently never match any chunk
        if self._sorting_columns or self._bloom_columns or self._encodings:
            from ..models.proto_bridge import proto_to_schema

            cols = proto_to_schema(self._proto_class).columns
            names = {c.name for c in cols} | {
                ".".join(c.path) for c in cols}
            for name, _, _ in (self._sorting_columns or ()):
                if name not in names:
                    raise ValueError(
                        f"sort_order column {name!r} is not a schema "
                        f"leaf (have {sorted(names)})")
            for name in (self._bloom_columns or ()):
                if name not in names:
                    raise ValueError(
                        f"bloom_filters column {name!r} is not a schema "
                        f"leaf (have {sorted(names)})")
            for name in (self._encodings or ()):
                if name not in names:
                    raise ValueError(
                        f"encodings column {name!r} is not a schema "
                        f"leaf (have {sorted(names)})")
        if self._group_id is None:
            # reference default group id pattern (KPW.java:158)
            self._group_id = f"KafkaProtoParquetWriter-{self._instance_name}"
        if self._filesystem is None:
            self._filesystem = LocalFileSystem()
        if self._proc_workers:
            # process mode crosses an interpreter boundary: everything a
            # child needs must be reconstructible from picklable config.
            # Fail here, at build(), not inside a spawned child.
            if isinstance(self._filesystem, ObjectStoreFileSystem):
                raise ValueError(
                    "process_workers does not support an object-store "
                    "target yet: the multipart upload handle (the staged "
                    "pending uploads + part-uploader thread) lives in the "
                    "parent's adapter and cannot cross the spawn boundary "
                    "— each child would need its own upload session per "
                    "file.  Use thread workers for object-store sinks.")
            if type(self._filesystem) is not LocalFileSystem:
                raise ValueError(
                    "process_workers requires a plain LocalFileSystem sink "
                    "(children open their own file handles; in-memory and "
                    "composite filesystems do not cross a process boundary)")
            if self._partitioner is not None:
                raise ValueError(
                    "process_workers does not support partition_by yet "
                    "(routing needs the parsed message in the parent)")
            # "cuda" is accepted: an H100 gives every process a context of
            # its own, so each child runs its own CudaChunkEncoder.  The
            # JAX package refuses its card backend here, most likely
            # because a TPU host's chips open in one process at a time;
            # there a child reaches the device only through "auto".
            if self._backend not in (None, "cpu", "native", "auto", "cuda"):
                raise ValueError(
                    f"process_workers supports cpu/native/auto/cuda encoder "
                    f"backends, not {self._backend!r}")
            if not self._parser_is_default:
                raise ValueError(
                    "process_workers does not support a custom parser(): "
                    "spawned children decode payloads with the wire "
                    "shredder / proto_class.FromString, so a transforming "
                    "parser would be silently ignored")
            from .procworkers import _proto_spec

            _proto_spec(self._proto_class)  # raises if not descriptor-backed
            # a coordinated broker (session_timeout_s set) is SUPPORTED in
            # process mode: the parent owns the group membership and
            # heartbeat (children never talk to the broker) and forwards
            # revocations across the ring as `revoke` fence descriptors —
            # see runtime/procworkers.py.
        from .writer import KafkaProtoParquetWriter

        return KafkaProtoParquetWriter(self)

    def writer_properties(self) -> WriterProperties:
        return WriterProperties(
            row_group_size=self._block_size,
            data_page_size=self._page_size,
            codec=self._codec,
            compression_level=self._compression_level,
            enable_dictionary=self._enable_dictionary,
            delta_fallback=self._delta_fallback,
            adaptive_encodings=self._adaptive_encodings,
            encodings=self._encodings,
            encoder_threads=self._encoder_threads,
            page_checksums=self._page_checksums,
            write_page_index=self._page_index,
            native_assembly=self._native_assembly,
            bloom_columns=self._bloom_columns,
            bloom_fpp=self._bloom_fpp,
            bloom_max_bytes=self._bloom_max_bytes,
            sorting_columns=self._sorting_columns,
        )
