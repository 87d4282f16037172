"""Metrics: written-vs-flushed meters + file size histogram.

Mirrors the reference's Dropwizard registration (KafkaProtoParquetWriter.java:
111-119,144-151,337-341): ``parquet.writer.written.records|bytes`` mark on
every accepted record (buffered), ``flushed.*`` only after a file is durably
published, ``parquet.writer.file.size`` histogram per finalized file.  The
written≠flushed distinction (buffered vs durable) is load-bearing and kept.
"""

from __future__ import annotations

import math
import random
import threading
import time

_TICK_INTERVAL = 5.0  # seconds per EWMA tick (Dropwizard's constant)


class _EWMA:
    """One exponentially-weighted moving average over a fixed window,
    advanced in discrete 5-second ticks (Dropwizard EWMA semantics: the
    first tick seeds the rate with the instantaneous value; later ticks
    blend with alpha = 1 - e^(-interval/window))."""

    def __init__(self, window_minutes: float) -> None:
        self._alpha = 1.0 - math.exp(-_TICK_INTERVAL / (window_minutes * 60.0))
        self._rate = 0.0
        self._initialized = False
        self._uncounted = 0

    def update(self, n: int) -> None:
        self._uncounted += n

    def tick(self) -> None:
        inst = self._uncounted / _TICK_INTERVAL
        self._uncounted = 0
        if self._initialized:
            self._rate += self._alpha * (inst - self._rate)
        else:
            self._rate = inst
            self._initialized = True

    @property
    def rate(self) -> float:
        return self._rate


class Meter:
    """Monotonic counter + Dropwizard-fidelity moving-average rates.

    The reference registers Dropwizard ``Meter``s (KafkaProtoParquetWriter.
    java:111-119): a count plus 1/5/15-minute exponentially-weighted rates
    ticked every 5 seconds, and a lifetime mean rate.  Rates advance lazily
    (on mark or read) like Dropwizard's ``tickIfNecessary``; an idle gap
    replays the missed ticks so rates decay exactly as if ticked on time."""

    def __init__(self, clock=time.monotonic) -> None:
        self._clock = clock
        self._count = 0
        self._lock = threading.Lock()
        self._start = clock()
        self._last_tick = self._start
        self._m1 = _EWMA(1.0)
        self._m5 = _EWMA(5.0)
        self._m15 = _EWMA(15.0)

    def _tick_if_necessary(self) -> None:
        age = self._clock() - self._last_tick
        if age < _TICK_INTERVAL:
            return
        ticks = int(age // _TICK_INTERVAL)
        self._last_tick += ticks * _TICK_INTERVAL
        for _ in range(ticks):
            self._m1.tick()
            self._m5.tick()
            self._m15.tick()

    def mark(self, n: int = 1) -> None:
        with self._lock:
            self._tick_if_necessary()
            self._count += n
            self._m1.update(n)
            self._m5.update(n)
            self._m15.update(n)

    @property
    def count(self) -> int:
        # locked like the rate getters: a bare int read is atomic in
        # CPython, but a reader racing mark() could otherwise observe the
        # count before the EWMA update it belongs with — take the same
        # lock so concurrent readers see a consistent counter
        with self._lock:
            return self._count

    def _rate(self, ewma: _EWMA) -> float:
        with self._lock:
            self._tick_if_necessary()
            return ewma.rate

    @property
    def one_minute_rate(self) -> float:
        return self._rate(self._m1)

    @property
    def five_minute_rate(self) -> float:
        return self._rate(self._m5)

    @property
    def fifteen_minute_rate(self) -> float:
        return self._rate(self._m15)

    @property
    def mean_rate(self) -> float:
        with self._lock:
            elapsed = self._clock() - self._start
            return self._count / elapsed if elapsed > 0 else 0.0

    def snapshot(self) -> dict:
        """Count + all rates in one lock round (a stats() scrape reading
        the four properties separately would tick four times and could
        interleave with a concurrent mark)."""
        with self._lock:
            self._tick_if_necessary()
            elapsed = self._clock() - self._start
            return {
                "count": self._count,
                "mean_rate": self._count / elapsed if elapsed > 0 else 0.0,
                "m1_rate": self._m1.rate,
                "m5_rate": self._m5.rate,
                "m15_rate": self._m15.rate,
            }


_RESCALE_SECONDS = 3600.0  # Dropwizard ExponentiallyDecayingReservoir


class Histogram:
    """File-size histogram with Dropwizard's exponentially-decaying
    reservoir (KPW.java:118 registers a default ``Histogram``, whose
    reservoir is ``ExponentiallyDecayingReservoir(1028, 0.015)``): samples
    carry forward-decay weights ``e^(alpha*(t-landmark))`` with priority
    ``weight/uniform()``, the lowest-priority sample is evicted at
    capacity, and the landmark rescales hourly so priorities never
    overflow.  Snapshot quantiles are weight-based (Dropwizard
    ``WeightedSnapshot``), which biases toward the most recent ~5 minutes
    of data under load instead of the uniform all-history view."""

    def __init__(self, reservoir: int = 1028, alpha: float = 0.015,
                 clock=time.monotonic) -> None:
        self._size = reservoir
        self._alpha = alpha
        self._clock = clock
        self._count = 0
        self._lock = threading.Lock()
        # priority -> (value, weight); kept small (<= size+1), so O(n)
        # min-eviction beats a heap's constant factor at n ~ 1k
        self._samples: dict[float, tuple[float, float]] = {}
        self._start = clock()
        self._next_rescale = self._start + _RESCALE_SECONDS

    def _rescale_if_needed(self, now: float) -> None:
        if now < self._next_rescale:
            return
        old_start, self._start = self._start, now
        self._next_rescale = now + _RESCALE_SECONDS
        factor = math.exp(-self._alpha * (now - old_start))
        self._samples = {
            k * factor: (v, w * factor)
            for k, (v, w) in self._samples.items() if w * factor > 0.0
        }

    def update(self, value: float) -> None:
        with self._lock:
            now = self._clock()
            self._rescale_if_needed(now)
            self._count += 1
            weight = math.exp(self._alpha * (now - self._start))
            priority = weight / max(random.random(), 1e-12)
            if len(self._samples) < self._size:
                self._samples[priority] = (value, weight)
            else:
                lowest = min(self._samples)
                if priority > lowest:
                    # on a priority collision, overwrite the incumbent —
                    # Dropwizard's ExponentiallyDecayingReservoir keeps one
                    # of the two rather than dropping the new sample
                    if priority not in self._samples:
                        del self._samples[lowest]
                    self._samples[priority] = (value, weight)

    @property
    def count(self) -> int:
        return self._count

    def snapshot(self) -> dict:
        with self._lock:
            self._rescale_if_needed(self._clock())
            entries = sorted(self._samples.values())  # by value
            count = self._count  # same lock round: count matches quantiles
        if not entries:
            return {"min": 0, "max": 0, "mean": 0, "p50": 0, "p95": 0,
                    "p99": 0, "count": count}
        total_w = sum(w for _, w in entries)

        def q(p: float) -> float:
            # Dropwizard WeightedSnapshot: first value whose cumulative
            # normalized weight crosses the quantile
            acc = 0.0
            for v, w in entries:
                acc += w / total_w
                if acc >= p:
                    return v
            return entries[-1][0]

        return {
            "min": entries[0][0],
            "max": entries[-1][0],
            "mean": sum(v * w for v, w in entries) / total_w,
            "p50": q(0.5),
            "p95": q(0.95),
            # file-size tails: rotation-band verification needs the p99
            # (one oversized file in a hundred is exactly what the ~1%
            # overshoot bound is about)
            "p99": q(0.99),
            "count": count,
        }


class Gauge:
    """Point-in-time value: either set explicitly (``set``) or backed by a
    callable sampled at read time (``set_function`` — the pull-based shape:
    the live structure is read only when something scrapes the registry).
    Dropwizard registers gauges the same two ways."""

    def __init__(self, fn=None) -> None:
        self._fn = fn
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._fn = None
            self._value = float(value)

    def set_function(self, fn) -> None:
        """Back the gauge with a zero-arg callable, sampled on read."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:
            # a dying provider (e.g. a closed writer's structures) must
            # never take the scrape down with it
            return float("nan")


class MetricRegistry:
    """Name -> metric; the registry users may pass to the Builder."""

    def __init__(self) -> None:
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def meter(self, name: str) -> Meter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Meter()
                self._metrics[name] = m
            return m

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._metrics.get(name)
            if h is None:
                h = Histogram()
                self._metrics[name] = h
            return h

    def gauge(self, name: str, fn=None) -> Gauge:
        """Get-or-create a gauge; ``fn`` (optional zero-arg callable)
        installs/replaces the read-time provider."""
        with self._lock:
            g = self._metrics.get(name)
            if g is None:
                g = Gauge()
                self._metrics[name] = g
            elif not isinstance(g, Gauge):
                # fail intelligibly, not with an AttributeError later
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(g).__name__}, not Gauge")
        if fn is not None:
            g.set_function(fn)
        return g

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> list[str]:
        return sorted(self._metrics)


# metric names (reference KPW.java:111-119)
WRITTEN_RECORDS_METER = "parquet.writer.written.records"
FLUSHED_RECORDS_METER = "parquet.writer.flushed.records"
WRITTEN_BYTES_METER = "parquet.writer.written.bytes"
FLUSHED_BYTES_METER = "parquet.writer.flushed.bytes"
FILE_SIZE_HISTOGRAM = "parquet.writer.file.size"
# observability layer (beyond the reference, which has no gauges):
# at-least-once ack lag — records accepted (written) but not yet durably
# acked, and the age of the oldest unacked offset — plus rotation-cause
# meters and the shared consumer queue's live depth
ACK_LAG_GAUGE = "parquet.writer.ack.lag.records"
ACK_AGE_GAUGE = "parquet.writer.ack.oldest.age.seconds"
ROTATED_SIZE_METER = "parquet.writer.rotated.size"
ROTATED_TIME_METER = "parquet.writer.rotated.time"
CONSUMER_QUEUE_DEPTH_GAUGE = "consumer.queue.depth"
# robustness layer: retry/backoff accounting, worker deaths + supervised
# restarts, live-worker gauge, and the startup recovery sweep's GC count
RETRIES_METER = "parquet.writer.retries"
RETRY_BACKOFF_MS_METER = "parquet.writer.retry.backoff.ms"
FAILED_METER = "parquet.writer.failed"
RESTARTS_METER = "parquet.writer.worker.restarts"
WORKERS_ALIVE_GAUGE = "parquet.writer.workers.alive"
TMP_SWEPT_METER = "parquet.writer.tmp.swept"
# durability layer: independent structural verification (io/verify.py) of
# published files — verified counts clean passes (startup recovery +
# publish-time), verify.failed counts files the verifier condemned, and
# quarantined counts condemned finals moved to {target_dir}/quarantine/
# (moved, never deleted)
VERIFIED_METER = "parquet.writer.verified"
VERIFY_FAILED_METER = "parquet.writer.verify.failed"
QUARANTINED_METER = "parquet.writer.quarantined"
# degraded-operation layer: hung-IO watchdog stall episodes, workers
# currently paused on a fatal-but-healable sink condition (gauge), and the
# spillover failover filesystem's spill/reconcile accounting (finals
# published onto the fallback, spills migrated back to the primary, and
# verify-failures-quarantined + migration retries)
STALLED_METER = "parquet.writer.stalled"
PAUSED_GAUGE = "parquet.writer.paused"
SPILLED_METER = "parquet.writer.spilled"
RECONCILED_METER = "parquet.writer.reconciled"
RECONCILE_FAILED_METER = "parquet.writer.reconcile.failed"
# partitioned-output layer: partition files currently open across workers
# (gauge, bounded by max_open_partitions per worker) and LRU
# close-and-publish evictions of the least-recently-written partition
PARTITIONS_OPEN_GAUGE = "parquet.writer.partitions.open"
PARTITIONS_EVICTED_METER = "parquet.writer.partitions.evicted"
# compaction layer (io/compact.py): merged counts published merge outputs,
# retired counts input files tombstoned to {target_dir}/compacted/ (moved,
# never deleted), failed counts verify failures + aborted merge rounds
COMPACTOR_MERGED_METER = "parquet.compactor.merged"
COMPACTOR_RETIRED_METER = "parquet.compactor.retired"
COMPACTOR_FAILED_METER = "parquet.compactor.failed"
# query-ready-files layer (core/index.py): indexed counts published files
# carrying PARQUET-922 page-index sections; bloom.bytes counts serialized
# split-block bloom filter bytes (header + bitset) landed in those files
INDEXED_METER = "parquet.writer.indexed"
BLOOM_BYTES_METER = "parquet.writer.bloom.bytes"
# nogil-assembly layer (native/src/assemble.cc): column chunks and pages
# whose page assembly ran as one GIL-released native call instead of the
# Python page loops — the evidence the assembly pool actually shards
# columns across cores (zero on backends without the extension or with
# Builder.native_assembly(False))
NATIVE_ASM_CHUNKS_METER = "parquet.writer.assembly.native.chunks"
NATIVE_ASM_PAGES_METER = "parquet.writer.assembly.native.pages"
# object-store layer (io/objectstore.py): every store request the sink
# served (create/put/get/head/list/copy/delete + the multipart trio),
# bytes moved in+out across them, multipart parts uploaded (the
# upload-hidden-under-encode pipeline's unit), multipart uploads aborted
# (orphan recovery + staged-tmp sweeps), and the store's observed rolling
# bandwidth in bytes/s (gauge, 5 s trailing window)
OBJSTORE_REQUESTS_METER = "parquet.writer.objstore.requests"
OBJSTORE_BYTES_METER = "parquet.writer.objstore.bytes"
OBJSTORE_PARTS_METER = "parquet.writer.objstore.parts"
OBJSTORE_ABORTED_METER = "parquet.writer.objstore.aborted"
OBJSTORE_BANDWIDTH_GAUGE = "parquet.writer.objstore.bandwidth"
# process-parallel-workers layer (runtime/procworkers.py): the
# shared-memory batch ring's slot count and live free slots, records
# dispatched-but-unacked across children, aggregate child rss, and live
# child process count — registered when Builder.process_workers is on
PROC_RING_SLOTS_GAUGE = "worker.proc.ring.slots"
PROC_RING_FREE_GAUGE = "worker.proc.ring.free"
PROC_INFLIGHT_GAUGE = "worker.proc.inflight.records"
PROC_RSS_GAUGE = "worker.proc.rss.bytes"
PROC_ALIVE_GAUGE = "worker.proc.alive"
# multi-tenant layer (runtime/multiwriter.py): the shared-session quota
# ledger's backpressure evidence — quota-stall episodes (one fetch gate
# blocked because its tenant was at its queue share) and the cumulative
# stall milliseconds across them, open files evicted because a tenant hit
# its open-file budget (the generalized LRU bound), records appended
# to dead-letter files (poison payloads + schema-incompatible routes),
# plus live route counts: total routes and routes currently degraded
# (paused / dead-lettering / failed) — marked across tenants (per-tenant
# breakdowns ride stats()['tenants'], names stay canonical)
TENANT_QUEUE_STALLS_METER = "parquet.writer.tenant.queue.stalls"
TENANT_QUEUE_STALL_MS_METER = "parquet.writer.tenant.queue.stall.ms"
TENANT_FILES_EVICTED_METER = "parquet.writer.tenant.files.evicted"
DEADLETTER_METER = "parquet.writer.deadletter.records"
TENANT_ROUTES_GAUGE = "parquet.writer.tenant.routes"
TENANT_ROUTES_DEGRADED_GAUGE = "parquet.writer.tenant.routes.degraded"
# telemetry-plane layer (runtime/telemetry.py): end-to-end ack latency —
# seconds from a batch's ingest into the shared queue to its offsets
# being durably acked (the time-to-durable histogram the cluster bench
# needs: percentiles in SECONDS, not record-count lag proxies) — plus the
# cross-process aggregation gauges: child-origin written/flushed record
# counts summed over the live shm telemetry cells PLUS the banked totals
# of dead children (a respawn banks the dead child's final counts first,
# so the merged scrape is monotonic and a dead cell never poisons it),
# cumulative child stage-time seconds, child span counts (recorded /
# dropped), and the crash flight recorder's dump count
ACK_LATENCY_HISTOGRAM = "parquet.writer.ack.latency"
CHILD_WRITTEN_RECORDS_GAUGE = "worker.proc.child.written.records"
CHILD_FLUSHED_RECORDS_GAUGE = "worker.proc.child.flushed.records"
CHILD_STAGE_SECONDS_GAUGE = "worker.proc.child.stage.seconds"
CHILD_SPANS_GAUGE = "worker.proc.child.spans"
CHILD_SPANS_DROPPED_GAUGE = "worker.proc.child.spans.dropped"
FLIGHTREC_DUMPS_METER = "parquet.writer.flightrec.dumps"
# consumer-group rebalance layer (ingest/broker.py group coordination +
# ingest/consumer.py cooperative revocation): generation bumps observed by
# this instance's consumer, files rotated early because their open file held
# a revoked partition's rows (the drain-window flush), ack commits the
# broker rejected with a stale-generation fence (the zombie backstop), and
# open files abandoned unpublished because their partitions were LOST
# (session expiry / drain timeout — publishing would only earn a fenced
# commit)
REBALANCES_METER = "parquet.writer.rebalances"
ROTATED_REVOKE_METER = "parquet.writer.rotated.revoke"
FENCED_ACKS_METER = "parquet.writer.rebalance.fenced.acks"
FENCE_ABANDONS_METER = "parquet.writer.rebalance.abandons"
# process-mode rebalance (runtime/procworkers.py): child-side fence
# activity folded into the merged scrape through the child telemetry
# cells — files a child flushed under a revoke fence and open files it
# abandoned on revoke/lost, summed live + banked like the other
# worker.proc.child.* gauges
CHILD_REBALANCE_FENCED_GAUGE = "worker.proc.child.rebalance.fenced"
CHILD_REBALANCE_ABANDONED_GAUGE = "worker.proc.child.rebalance.abandoned"

# the canonical registry of metric names, which docs cite from
METRIC_NAMES = (
    WRITTEN_RECORDS_METER,
    FLUSHED_RECORDS_METER,
    WRITTEN_BYTES_METER,
    FLUSHED_BYTES_METER,
    FILE_SIZE_HISTOGRAM,
    ACK_LAG_GAUGE,
    ACK_AGE_GAUGE,
    ROTATED_SIZE_METER,
    ROTATED_TIME_METER,
    CONSUMER_QUEUE_DEPTH_GAUGE,
    RETRIES_METER,
    RETRY_BACKOFF_MS_METER,
    FAILED_METER,
    RESTARTS_METER,
    WORKERS_ALIVE_GAUGE,
    TMP_SWEPT_METER,
    VERIFIED_METER,
    VERIFY_FAILED_METER,
    QUARANTINED_METER,
    STALLED_METER,
    PAUSED_GAUGE,
    SPILLED_METER,
    RECONCILED_METER,
    RECONCILE_FAILED_METER,
    PARTITIONS_OPEN_GAUGE,
    PARTITIONS_EVICTED_METER,
    COMPACTOR_MERGED_METER,
    COMPACTOR_RETIRED_METER,
    COMPACTOR_FAILED_METER,
    INDEXED_METER,
    BLOOM_BYTES_METER,
    NATIVE_ASM_CHUNKS_METER,
    NATIVE_ASM_PAGES_METER,
    OBJSTORE_REQUESTS_METER,
    OBJSTORE_BYTES_METER,
    OBJSTORE_PARTS_METER,
    OBJSTORE_ABORTED_METER,
    OBJSTORE_BANDWIDTH_GAUGE,
    PROC_RING_SLOTS_GAUGE,
    PROC_RING_FREE_GAUGE,
    PROC_INFLIGHT_GAUGE,
    PROC_RSS_GAUGE,
    PROC_ALIVE_GAUGE,
    TENANT_QUEUE_STALLS_METER,
    TENANT_QUEUE_STALL_MS_METER,
    TENANT_FILES_EVICTED_METER,
    DEADLETTER_METER,
    TENANT_ROUTES_GAUGE,
    TENANT_ROUTES_DEGRADED_GAUGE,
    ACK_LATENCY_HISTOGRAM,
    CHILD_WRITTEN_RECORDS_GAUGE,
    CHILD_FLUSHED_RECORDS_GAUGE,
    CHILD_STAGE_SECONDS_GAUGE,
    CHILD_SPANS_GAUGE,
    CHILD_SPANS_DROPPED_GAUGE,
    FLIGHTREC_DUMPS_METER,
    REBALANCES_METER,
    ROTATED_REVOKE_METER,
    FENCED_ACKS_METER,
    FENCE_ABANDONS_METER,
    CHILD_REBALANCE_FENCED_GAUGE,
    CHILD_REBALANCE_ABANDONED_GAUGE,
)
