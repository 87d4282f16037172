"""Smart-commit consumer: bounded shared queue + paged offset tracking +
open-page backpressure.

Interface parity with the external library the reference wires at
KafkaProtoParquetWriter.java:153-163: ``subscribe(topic)``, ``start()``,
``poll()`` (non-blocking, many workers concurrently), ``ack(PartitionOffset)``,
``close()``; auto-commit is never used — the committed offset only advances
over acked pages (at-least-once anchor, README.MD:6).  A single fetcher
thread owns broker I/O (the reference's consumer thread), workers share the
bounded queue (``maxQueuedRecordsInConsumer``, KPW.java:468).
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from collections import deque

from ..runtime.retry import RetryInterrupted, RetryPolicy
from ..utils.tracing import stage
from .autotune import IngestAutotuner
from .broker import FakeBroker, Record, RecordBatch, StaleGenerationError
from .offsets import PagedOffsetTracker, PartitionOffset

logger = logging.getLogger(__name__)


class SmartCommitConsumer:
    def __init__(
        self,
        broker: FakeBroker,
        group_id: str,
        page_size: int = 300_000,
        max_open_pages_per_partition: int = 1,
        max_queued_records: int = 100_000,
        fetch_max_records: int = 2000,
        member_id: str | None = None,
        retry_policy: RetryPolicy | None = None,
        batch_ingest: bool = False,
        autotuner: IngestAutotuner | None = None,
        queue_listener=None,
        drain_deadline_s: float = 5.0,
        rebalance_listener=None,
    ) -> None:
        self.broker = broker
        self.group_id = group_id
        self.member_id = member_id or f"member-{uuid.uuid4().hex[:8]}"
        self.tracker = PagedOffsetTracker(page_size, max_open_pages_per_partition)
        # Batch-native bounded buffer: a deque of record *batches* under one
        # condition, so the fetcher pays one lock round per fetch and
        # workers one per poll_many — the per-record queue.Queue handoff was
        # the throughput ceiling (~2 us/record each side).  Entries are
        # either plain ``list[Record]`` (compatibility route, redelivery)
        # or zero-copy :class:`RecordBatch` fetch slices (``batch_ingest``:
        # contiguous payload buffer + offsets, no per-record objects).  The
        # record-count bound is hard (reference BlockingQueue capacity
        # semantics): oversized batches are admitted in slices, see
        # _put_batch.
        self._buf: "deque[list[Record] | RecordBatch]" = deque()
        self._head_pos = 0  # consumed prefix of _buf[0]
        self._buf_count = 0
        self._buf_max = max_queued_records
        self._buf_cond = threading.Condition()
        # queue observability (all mutated under _buf_cond, so a stats()
        # reader sees a consistent snapshot): live depth is _buf_count;
        # high watermark + cumulative fetcher blocked-on-put / worker
        # blocked-on-get stall seconds are the backpressure evidence
        self._buf_hwm = 0
        self._put_stall_s = 0.0
        self._get_stall_s = 0.0
        self._records_in = 0
        self._records_out = 0
        # fetch-loop skips because a partition hit the open-page bound
        # (reference offsetTrackerMaxOpenPagesPerPartition backpressure);
        # only the fetcher thread writes it
        self._backpressure_skips = 0
        self._fetch_max = fetch_max_records
        self._topic: str | None = None
        self._thread: threading.Thread | None = None
        self._running = False
        self._positions: dict[int, int] = {}  # partition -> next fetch offset
        self._assigned: list[int] = []
        self._generation = -1
        self._commit_lock = threading.Lock()
        # broker-IO retry: transient fetch/commit failures (a sick broker,
        # an injected chaos fault) back off and retry instead of killing the
        # fetcher thread / the acking worker.  Default policy = infinite
        # attempts with backoff (reference delivery semantics).
        self._retry = retry_policy or RetryPolicy()
        self._stop_event = threading.Event()
        self._broker_retries = 0   # fetch+commit retry count (stats)
        self._redelivered = 0      # records re-injected by redeliver_run
        self._fetcher_error: str | None = None
        # batch-native ingest: ride broker.fetch_batch (contiguous buffer +
        # offsets, no per-record Record construction) when the broker has
        # one; falls back to the per-record fetch path silently otherwise
        self._batch_ingest = batch_ingest
        self._batch_fetches = 0    # fetch_batch calls that delivered (stats)
        # backpressure autotuning (owned by the writer; ticked from the
        # fetch loop): None = fixed knobs, reference parity
        self._autotune = autotuner
        # queue-occupancy listener (the multi-tenant quota ledger's
        # charge/credit seam, runtime/multiwriter.py): ``on_enqueued(n)``
        # fires per admitted slice, ``on_drained(n)`` per drain round,
        # both under the buffer condition so charge and credit see the
        # same admission the queue accounting saw.  The listener must not
        # block and may only take its OWN lock (buffer-cond -> listener
        # lock is the one ordering; the ledger never takes this one).
        self._listener = queue_listener
        # end-to-end ack-latency plane: per-partition deques of
        # (start_offset, end_offset, ingest_wall_ts) stamped at queue
        # admission and popped when acks cover them — the writer's
        # observer receives time-to-durable seconds per covered stamp.
        # Own leaf lock (the buffer condition may be held when stamping;
        # the ack path takes only this lock — acyclic).  Bounded per
        # partition: if acks never come, old stamps age out silently
        # rather than growing without bound.
        self._stamp_lock = threading.Lock()
        self._stamps: dict[int, deque] = {}
        self._stamp_cap = 4096
        self._latency_observer = None
        self._lat_runs = 0
        self._lat_records = 0
        # group coordination: the consumer runs the full
        # protocol — heartbeats, cooperative incremental rebalance, fenced
        # commits — only against a coordination-enabled broker (one with a
        # heartbeat surface AND a session timeout configured); every other
        # broker keeps the legacy full-reset-on-generation-change path.
        _st = getattr(broker, "session_timeout_s", None)
        self._coordinated = (callable(getattr(broker, "heartbeat", None))
                             and _st is not None)
        self._hb_interval_s = (max(0.02, _st / 4.0)
                               if self._coordinated else None)
        self._last_hb = 0.0  # monotonic
        self._drain_deadline_s = drain_deadline_s
        self._rejoin_drain_timeouts = 0  # hard-bounded rejoin waits
        self._rebalance_listener = rebalance_listener
        # in-progress cooperative revocation: {"parts": set[int],
        # "deadline": monotonic} — only the fetcher thread touches it
        self._revoke_pending: dict | None = None
        # SIGSTOP analog for the zombie drill: a suspended fetcher stops
        # heartbeating/fetching but the thread stays parked (resumable)
        self._suspended = False
        self._killed = False  # hard_kill(): no leave_group on close
        self._cooperative_rebalances = 0
        self._full_resets = 0
        self._rejoins = 0
        self._fenced_commits = 0
        self._revoked_purged = 0

    # -- lifecycle ---------------------------------------------------------
    def subscribe(self, topic: str) -> None:
        if self._topic is not None:
            raise ValueError("already subscribed")
        self._topic = topic

    def start(self) -> None:
        if self._topic is None:
            raise ValueError("subscribe() before start()")
        if self._thread is not None:
            raise ValueError("already started")
        self.broker.join_group(self.group_id, self._topic, self.member_id)
        self._running = True
        self._thread = threading.Thread(target=self._fetch_loop,
                                        name=f"smart-consumer-{self.member_id}",
                                        daemon=True)
        self._thread.start()

    def close(self, timeout: float = 10.0) -> None:
        self._running = False
        self._stop_event.set()
        # wake a fetcher blocked in a put-stall NOW (full buffer, worker
        # gone or slow): _put_batch re-checks _running on wake and bails,
        # so close never deadlocks behind a wedged producer — without the
        # notify it still exits, but only at the next 50 ms wait tick
        # (pinned by test_consumer_close_releases_blocked_put)
        with self._buf_cond:
            self._buf_cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        if self._topic is not None and not self._killed:
            self.broker.leave_group(self.group_id, self._topic, self.member_id)

    def hard_kill(self) -> None:
        """kill -9 analog at the protocol level: stop without
        ``leave_group`` — the broker learns of the death only through the
        missed session window, exactly like a SIGKILLed process's silent
        socket drop.  The chaos drill's victim path."""
        self._killed = True
        self.close()

    def suspend(self, flag: bool) -> None:
        """SIGSTOP/SIGCONT analog: a suspended fetcher stops heartbeating
        and fetching but stays parked and resumable — the zombie drill
        pauses an instance through a full rebalance this way."""
        self._suspended = bool(flag)

    def set_rebalance_listener(self, listener) -> None:
        """Bind the cooperative-revocation listener (the writer).  Surface:
        ``on_generation(gen, revoked, added)``,
        ``on_partitions_revoked(parts)`` (begin fencing in-flight files),
        ``revocation_drained(parts) -> bool`` (polled until True or the
        drain deadline), ``on_revocation_timeout(parts)`` (deadline lapsed:
        abandon what is still in flight), ``on_partitions_lost(parts)``
        (non-cooperative loss — expelled from the group).  Every callback
        fires on the fetcher thread and must not block."""
        self._rebalance_listener = listener

    # -- worker API --------------------------------------------------------
    def poll(self, timeout: float | None = None) -> Record | None:
        """Non-blocking by default (reference workers sleep 1 ms on null,
        KPW.java:260-263).  With a timeout, waits under the buffer condition
        (wait_for: no check-then-wait race, no spurious early None)."""
        with self._buf_cond:
            if timeout is not None and not self._buf:
                t0 = time.perf_counter()
                self._buf_cond.wait_for(lambda: bool(self._buf), timeout)
                self._get_stall_s += time.perf_counter() - t0
            got = self._drain_locked(1)
        return got[0] if got else None

    def poll_many(self, max_records: int) -> list[Record]:
        """Drain up to ``max_records`` without blocking — one lock round for
        the whole batch (the batch counterpart of :meth:`poll`)."""
        with self._buf_cond:
            return self._drain_locked(max_records)

    def poll_many_runs(self, max_records: int):
        """Like :meth:`poll_many` but also returns the drained records as
        contiguous (partition, start_offset, count) runs, in record order.
        Buffered batches are single-partition fetch slices, so runs come out
        O(1) per slice instead of the caller re-deriving them per record —
        the ack-bookkeeping fast path for the streaming worker.  A gapped
        batch (compacted topic) falls back to exact per-record runs: the
        run shortcut must never claim an offset that was not delivered."""
        runs: list[tuple[int, int, int]] = []
        with self._buf_cond:
            recs = self._drain_locked(max_records, runs)
        return recs, runs

    def poll_many_batches(self, max_records: int):
        """Batch-native drain: up to ``max_records`` without blocking,
        returned as the raw queue chunks — zero-copy :class:`RecordBatch`
        views of the fetcher's contiguous fetch slices and/or plain
        ``list[Record]`` chunks (redelivered runs, record-mode leftovers)
        — plus the (partition, start, count) ack runs, in record order.
        The streaming worker's fast path: payload buffers go straight to
        the wire shredder, Records are never materialized."""
        runs: list[tuple[int, int, int]] = []
        items: list = []
        with self._buf_cond:
            self._drain_locked(max_records, runs, items)
        return items, runs

    def _drain_locked(self, max_records: int, runs: list | None = None,
                      items: list | None = None) -> list[Record]:
        """Drain up to ``max_records`` under the buffer condition.  Returns
        the drained records materialized (the poll/poll_many surface);
        with ``items`` supplied the raw chunks (RecordBatch views / Record
        lists) are appended there instead and the return list stays empty.
        ``runs`` collects the drained ack runs either way."""
        out: list[Record] = []
        taken = 0
        while self._buf and taken < max_records:
            head = self._buf[0]
            avail = len(head) - self._head_pos
            want = max_records - taken
            take = avail if want >= avail else want
            if isinstance(head, RecordBatch):
                # zero-copy window; a RecordBatch is contiguous by contract
                # so its run is O(1)
                chunk = (head if take == len(head)
                         else head.slice(self._head_pos, take))
                if runs is not None:
                    runs.append(chunk.run)
            else:
                # partial drain: advance an index into the head batch (O(1)
                # per-record consumption for poll() users; no reslicing)
                chunk = (head[self._head_pos: self._head_pos + take]
                         if (self._head_pos or take < len(head)) else head)
                if runs is not None and chunk:
                    first, last = chunk[0], chunk[-1]
                    if last.offset - first.offset == len(chunk) - 1:
                        runs.append((first.partition, first.offset,
                                     len(chunk)))
                    else:  # gap inside a batch (compacted topic): exact
                        runs.extend((r.partition, r.offset, 1)
                                    for r in chunk)
            if take == avail:
                self._buf.popleft()
                self._head_pos = 0
            else:
                self._head_pos += take
            self._buf_count -= take
            self._records_out += take
            taken += take
            if items is not None:
                items.append(chunk)
            elif isinstance(chunk, RecordBatch):
                out.extend(chunk.to_records())
            else:
                out.extend(chunk)
        if taken:
            if self._listener is not None:
                self._listener.on_drained(taken)
            self._buf_cond.notify_all()
        return out

    def _put_batch(self, records: "list[Record] | RecordBatch",
                   stop_event: threading.Event | None = None) -> bool:
        """Fetcher side: enqueue one tracked batch (a Record list or a
        zero-copy RecordBatch), blocking while the record-count bound is
        reached.  The bound is HARD (the reference's
        maxQueuedRecordsInConsumer is a BlockingQueue capacity): an
        oversized batch is admitted in slices as space opens, never
        overshooting ``max_queued_records``.  Returns False when shut down
        (or ``stop_event`` fires — the supervisor's redelivery must not
        stay wedged on a full queue through close) before everything was
        admitted (caller must not advance its fetch position;
        already-admitted slices may be redelivered — at-least-once allows
        the duplicates)."""
        pos = 0
        n = len(records)
        is_batch = isinstance(records, RecordBatch)
        with self._buf_cond:
            while pos < n:
                space = self._buf_max - self._buf_count
                if space <= 0:
                    if not self._running or (stop_event is not None
                                             and stop_event.is_set()):
                        return False
                    t0 = time.perf_counter()
                    self._buf_cond.wait(0.05)
                    self._put_stall_s += time.perf_counter() - t0
                    continue
                take = min(space, n - pos)
                if pos == 0 and take == n:
                    part = records
                elif is_batch:
                    part = records.slice(pos, take)
                else:
                    part = records[pos: pos + take]
                self._buf.append(part)
                self._buf_count += take
                self._records_in += take
                if self._buf_count > self._buf_hwm:
                    self._buf_hwm = self._buf_count
                if self._listener is not None:
                    self._listener.on_enqueued(take)
                if is_batch:
                    self._stamp_ingest(part.partition, part.start_offset,
                                       part.start_offset + take,
                                       part.timestamp)
                elif part:
                    self._stamp_ingest(part[0].partition, part[0].offset,
                                       part[-1].offset + 1,
                                       part[0].timestamp)
                pos += take
                self._buf_cond.notify_all()
        return True

    # -- end-to-end ack latency --------------------------------------------
    def set_latency_observer(self, fn) -> None:
        """``fn(seconds, records)`` fires per ingest stamp an ack covers
        — the writer binds the ``parquet.writer.ack.latency`` Histogram
        here.  The observer must be cheap and must not raise."""
        self._latency_observer = fn

    def _stamp_ingest(self, partition: int, start: int, end: int,
                      ts: float = 0.0) -> None:
        # the broker's record-append timestamp when the source carries one
        # (FakeBroker batches do): the latency origin then SURVIVES a
        # partition handoff — the new owner's re-fetch of an unacked run
        # carries the same append stamp the dead owner saw, so the
        # measured time-to-durable spans the rebalance blackout instead
        # of restarting at redelivery.  Wall clock deliberately (not
        # monotonic): the stamp crosses process boundaries (ring
        # descriptor) and renders as operator-facing seconds; sources
        # without record timestamps fall back to ingest wall time.
        if not ts:
            ts = time.time()
        with self._stamp_lock:
            dq = self._stamps.get(partition)
            if dq is None:
                dq = self._stamps[partition] = deque(maxlen=self._stamp_cap)
            dq.append((start, end, ts))

    def ingest_stamp(self, partition: int, offset: int) -> float | None:
        """The ingest wall-time of the stamp covering ``offset`` (None
        when unknown) — the dispatcher reads it to stamp ring unit
        descriptors.  Front-of-deque hits dominate (the oldest unacked
        run is the one being dispatched)."""
        with self._stamp_lock:
            dq = self._stamps.get(partition)
            if not dq:
                return None
            for s, e, ts in dq:
                if s <= offset < e:
                    return ts
        return None

    def _observe_ack(self, partition: int, start: int, end: int) -> None:
        """Pop every stamp the acked run [start, end) covers and feed the
        observer its time-to-durable.  Handles out-of-order acks (runs
        ack at file granularity across workers): stamps entirely below
        the run are kept for their own later ack; a stamp the run only
        partially covers is split, its tail re-queued.  Redelivered runs
        re-stamp at redelivery but carry the broker's ORIGINAL append
        timestamp, so duplicates measure the true end-to-end latency
        (clamped at zero for sources whose stamps fall back to ingest
        wall time)."""
        obs = self._latency_observer
        hits: list[tuple[float, int]] = []
        now = time.time()
        with self._stamp_lock:
            dq = self._stamps.get(partition)
            if not dq:
                return
            keep: list[tuple[int, int, float]] = []
            while dq and dq[0][0] < end:
                s, e, ts = dq.popleft()
                if e <= start:
                    keep.append((s, e, ts))  # earlier run, not ours
                    continue
                hits.append((max(0.0, now - ts),
                             min(e, end) - max(s, start)))
                if e > end:  # tail extends past the ack: re-stamp it
                    keep.append((end, e, ts))
            for item in reversed(keep):
                dq.appendleft(item)
            if hits:
                self._lat_runs += len(hits)
                self._lat_records += sum(n for _, n in hits)
        if obs is not None:
            for lat_s, n in hits:
                obs(lat_s, n)

    def queue_depth(self) -> int:
        """Live record count in the shared bounded buffer."""
        with self._buf_cond:
            return self._buf_count

    def fetcher_alive(self) -> bool:
        """True while the fetcher thread is running and has not died to an
        unretryable broker error — the consumer half of writer.healthy()."""
        return (self._thread is not None and self._thread.is_alive()
                and self._fetcher_error is None)

    def redeliver_run(self, partition: int, start: int, count: int,
                      stop_event: threading.Event | None = None) -> int:
        """Re-inject the already-tracked offset run [start, start+count)
        into the shared buffer by re-fetching it from the broker.

        The supervised-restart redelivery path: a dead worker's held
        (written-but-unacked and polled-but-unwritten) offsets were consumed
        from the queue and will never be acked by anyone — without
        re-injection the commit frontier stalls behind them forever.  The
        run is NOT tracked again (its pages are already open in the
        tracker); duplicates with a survivor's output are allowed by the
        at-least-once contract.  ``stop_event`` (e.g. the supervisor's
        close signal) aborts promptly — the consumer's own stop is honored
        too.  Returns the number of records re-injected."""
        if self._coordinated and partition not in self._assigned:
            return 0  # revoked/handed off: the NEW owner redelivers from
            #           the committed frontier — re-injecting here would
            #           write rows this member can no longer ack (fenced)
        stop = stop_event or self._stop_event
        end = start + count
        off = start
        while (off < end and not stop.is_set()
               and not self._stop_event.is_set()):
            recs = self._retry.call(
                lambda off=off: self.broker.fetch(
                    self._topic, partition, off,
                    min(self._fetch_max, end - off)),
                stop_event=stop,
                on_retry=self._count_retry, label="broker.refetch")
            recs = [r for r in recs if r.offset < end]
            if not recs:
                break  # run no longer materializable (compacted away)
            if not self._put_batch(recs, stop_event=stop):
                break  # shutting down
            self._redelivered += len(recs)
            off = recs[-1].offset + 1
        return off - start

    def stats(self) -> dict:
        """Pull-based consumer observability snapshot: the shared queue's
        depth / high-watermark / stall accounting, the fetcher's
        open-page-backpressure skip count, and the offset tracker's
        per-partition ack frontier (the delivered-but-uncommitted records
        behind the at-least-once commit)."""
        with self._buf_cond:
            q = {
                "depth": self._buf_count,
                "capacity": self._buf_max,
                "high_watermark": self._buf_hwm,
                "put_stall_s": round(self._put_stall_s, 6),
                "get_stall_s": round(self._get_stall_s, 6),
                "records_in": self._records_in,
                "records_out": self._records_out,
            }
        return {
            "queue": q,
            "backpressure_skips": self._backpressure_skips,
            "fetcher_alive": self.fetcher_alive(),
            "fetcher_error": self._fetcher_error,
            "broker_retries": self._broker_retries,
            "redelivered_records": self._redelivered,
            "batch_ingest": self._batch_ingest,
            "batch_fetches": self._batch_fetches,
            "autotune": (self._autotune.snapshot()
                         if self._autotune is not None
                         else {"enabled": False}),
            "ack_latency": self.latency_snapshot(),
            "rebalance": {
                "coordinated": self._coordinated,
                "generation": self._generation,
                "assigned": sorted(self._assigned),
                "cooperative_rebalances": self._cooperative_rebalances,
                "full_resets": self._full_resets,
                "rejoins": self._rejoins,
                "fenced_commits": self._fenced_commits,
                "revoked_purged_records": self._revoked_purged,
                "revoke_pending": (sorted(self._revoke_pending["parts"])
                                   if self._revoke_pending else []),
            },
            "tracker": self.tracker.snapshot(),
        }

    def latency_snapshot(self) -> dict:
        with self._stamp_lock:
            return {
                "observed_runs": self._lat_runs,
                "observed_records": self._lat_records,
                "stamps_pending": sum(len(d) for d in
                                      self._stamps.values()),
            }

    def ack(self, po: PartitionOffset) -> None:
        # observe BEFORE the commit round: durability happened at
        # publish, and a commit retry backing off for seconds must not
        # inflate the measured time-to-durable
        self._observe_ack(po.partition, po.offset, po.offset + 1)
        new_commit = self.tracker.ack(po)
        if new_commit is not None:
            self._commit_with_retry(po.partition, new_commit)

    def ack_run(self, partition: int, start: int, count: int) -> None:
        """Batch ack of a contiguous offset run — one tracker round and at
        most one broker commit for a whole published batch (the worker acks
        whole files' worth of offsets at publish time)."""
        if count <= 0:
            return
        self._observe_ack(partition, start, start + count)
        new_commit = self.tracker.ack_run(partition, start, count)
        if new_commit is not None:
            self._commit_with_retry(partition, new_commit)

    def _commit_with_retry(self, partition: int, offset: int) -> None:
        """Commit the advanced frontier, retrying transient broker errors.
        Safe to retry indefinitely: commit is idempotent and the records it
        covers are already durably published — losing the commit only costs
        redelivery (at-least-once), never data.  Each attempt re-reads the
        tracker's (monotonic) frontier: a retry that backed off for seconds
        must not push a stale lower offset over a newer commit another
        worker made meanwhile (FakeBroker guards monotonicity; a real
        Kafka commit does not)."""
        def do() -> None:
            with self._commit_lock:
                cur = self.tracker.committed(partition)
                if self._coordinated:
                    # fenced commit: carry our identity so a stale member
                    # (zombie through a rebalance) is rejected broker-side.
                    # lint: lock-discipline ok — the lock exists precisely
                    # to make frontier-read + broker commit one atomic
                    # step: a real Kafka broker does NOT guard commit
                    # monotonicity, so committing outside it lets a
                    # backed-off retry push a stale lower offset over a
                    # newer one.  Retry sleeps happen in _retry.call,
                    # outside this closure/lock.
                    self.broker.commit(self.group_id, self._topic, partition,
                                       max(offset, cur),
                                       generation=self._generation,
                                       member_id=self.member_id)
                else:
                    # lint: lock-discipline ok — same atomic
                    # frontier-read + commit step as the fenced branch
                    self.broker.commit(self.group_id, self._topic, partition,
                                       max(offset, cur))
        try:
            self._retry.call(do, stop_event=self._stop_event,
                             on_retry=self._count_retry,
                             label="broker.commit")
        except StaleGenerationError:
            # typed, NOT retried (not an OSError): the caller — a worker
            # acking a just-published file — must unpublish and drop the
            # fenced runs, never spin
            self._fenced_commits += 1
            raise

    def commit_allowed(self, partition: int) -> bool:
        """Would an ack-commit for ``partition`` from this member be
        accepted right now?  The writer's PRE-publish fence check: a file
        about to be renamed into the tree whose runs can no longer be
        acked is abandoned instead (the new owner redelivers)."""
        if not self._coordinated:
            return True
        fn = getattr(self.broker, "commit_allowed", None)
        if not callable(fn):
            return True
        return bool(fn(self.group_id, self._topic, partition,
                       generation=self._generation,
                       member_id=self.member_id))

    def _count_retry(self, attempt, exc, sleep_s) -> None:
        self._broker_retries += 1

    # -- internals ---------------------------------------------------------
    def _track_batch(self, partition: int, records: list[Record]) -> list[Record]:
        """Track a fetch batch in contiguous runs, chunked at offset-tracker
        page boundaries with a backpressure re-check per chunk (granularity:
        the open-page bound may be exceeded by at most the one page that
        trips it, mirroring the per-record loop this replaces at page
        resolution instead of record resolution)."""
        tr = self.tracker
        page = tr.page_size
        accepted_until = 0  # index into records
        i = 0
        n = len(records)
        # a partition fetch is one contiguous offset run in the common case
        # (gaps only on compacted topics): one O(1) check replaces the
        # per-record walk below — offsets are strictly increasing, so
        # last-first == n-1 proves contiguity
        contiguous = n > 0 and (records[-1].offset - records[0].offset
                                == n - 1)
        while i < n:
            if tr.is_backpressured(partition):
                break
            # contiguous run starting at i, clipped at the next page boundary
            start = records[i].offset
            if i > 0 and start > records[i - 1].offset + 1:
                # compacted-topic gap INSIDE the batch: those offsets can
                # never be delivered or acked, and an un-ackable hole would
                # park the commit frontier forever — skip them (marked
                # delivered+acked; Kafka semantics: the committed offset may
                # pass compacted-away offsets).  Any frontier advance rides
                # the next real ack's broker commit.
                tr.skip_run(partition, records[i - 1].offset + 1,
                            start - records[i - 1].offset - 1)
            page_end_off = (start // page + 1) * page
            if contiguous:
                j = i + min(n - i, page_end_off - start)
            else:
                j = i + 1
                while (j < n and records[j].offset == records[j - 1].offset + 1
                       and records[j].offset < page_end_off):
                    j += 1
            tr.track_run(partition, start, records[j - 1].offset - start + 1)
            accepted_until = j
            i = j
        return records[:accepted_until] if accepted_until < n else records

    def _track_run_batch(self, partition: int, pos: int,
                         rb: RecordBatch) -> RecordBatch | None:
        """Track one contiguous RecordBatch run, chunked at offset-tracker
        page boundaries with a backpressure re-check per chunk — the batch
        analog of :meth:`_track_batch` at the same granularity (the
        open-page bound may be exceeded by at most the one page that trips
        it).  A head gap (the batch starts past the fetch position:
        offsets compacted away at the source) is pre-acked so the commit
        frontier can cross it — the ack-correctness seam the RecordBatch
        contiguity contract must honor.  Returns the accepted prefix as a
        zero-copy slice, or None when backpressure admitted nothing."""
        tr = self.tracker
        start = rb.start_offset
        if start > pos:
            tr.skip_run(partition, pos, start - pos)
        page = tr.page_size
        end = start + len(rb)
        off = start
        while off < end:
            if tr.is_backpressured(partition):
                break
            take = min(end, (off // page + 1) * page) - off
            tr.track_run(partition, off, take)
            off += take
        accepted = off - start
        if accepted == 0:
            return None
        return rb if accepted == len(rb) else rb.slice(0, accepted)

    def _refresh_assignment(self) -> None:
        gen = self.broker.generation(self.group_id, self._topic)
        if gen == self._generation:
            return
        if not self._coordinated or self._generation < 0:
            # legacy brokers (and the first assignment after a join/
            # rejoin): FULL reset — every partition rewinds to the
            # committed frontier and delivered-but-unacked records
            # redeliver (at-least-once allows the duplicates)
            if self._generation >= 0:
                self._full_resets += 1
            self._generation = gen
            self._assigned = self.broker.assignment(self.group_id,
                                                    self._topic,
                                                    self.member_id)
            self._positions = {}
            for p in self._assigned:
                base = self.broker.committed(self.group_id, self._topic, p)
                self._positions[p] = base
                self.tracker.reset_partition(p, base)
            return
        # cooperative (incremental) rebalance: only the delta moves.
        # Retained partitions keep their queue contents, tracker pages and
        # fetch positions — unaffected flow never stalls.
        self._cooperative_rebalances += 1
        new_assigned = self.broker.assignment(self.group_id, self._topic,
                                              self.member_id)
        old, new = set(self._assigned), set(new_assigned)
        revoked = sorted(old - new)
        added = sorted(new - old)
        self._generation = gen
        self._assigned = new_assigned
        lis = self._rebalance_listener
        if lis is not None:
            try:
                lis.on_generation(gen, revoked, added)
            # lint: swallowed-exceptions ok — listener callbacks are
            # observability hooks on the fetcher thread; a raising hook
            # must not kill the fetch loop mid-rebalance
            except Exception:
                logger.exception("rebalance listener on_generation raised")
        if revoked:
            self._begin_revocation(revoked)
        for p in added:
            base = self.broker.committed(self.group_id, self._topic, p)
            self._positions[p] = base
            self.tracker.reset_partition(p, base)

    def _begin_revocation(self, revoked: list[int]) -> None:
        """Fetcher thread: stop serving ``revoked`` — purge their queued-
        but-unpolled records (a worker must not write rows this member can
        no longer ack), drop their fetch positions, tell the writer to
        fence its in-flight files, and open the drain window
        :meth:`_poll_revocation` completes."""
        rev = set(revoked)
        dropped = 0
        with self._buf_cond:
            kept: deque = deque()
            for i, chunk in enumerate(self._buf):
                part = (chunk.partition if isinstance(chunk, RecordBatch)
                        else (chunk[0].partition if chunk else None))
                if part in rev:
                    n = len(chunk) - (self._head_pos if i == 0 else 0)
                    dropped += n
                    self._buf_count -= n
                    if i == 0:
                        self._head_pos = 0
                else:
                    kept.append(chunk)
            self._buf = kept
            if dropped:
                self._revoked_purged += dropped
                if self._listener is not None:
                    # credit the queue-occupancy ledger: purged records
                    # left the queue exactly like a drain round
                    self._listener.on_drained(dropped)
                self._buf_cond.notify_all()
        for p in revoked:
            self._positions.pop(p, None)
        lis = self._rebalance_listener
        if lis is not None:
            try:
                lis.on_partitions_revoked(list(revoked))
            # lint: swallowed-exceptions ok — same contract as
            # on_generation: a raising hook must not kill the fetcher
            except Exception:
                logger.exception("rebalance listener on_revoked raised")
        deadline = time.monotonic() + self._drain_deadline_s
        pend = self._revoke_pending
        if pend is None:
            self._revoke_pending = {"parts": rev, "deadline": deadline}
        else:  # back-to-back rebalances: merge, keep the later deadline
            pend["parts"] |= rev
            pend["deadline"] = max(pend["deadline"], deadline)

    def _poll_revocation(self) -> None:
        """Fetcher thread: complete an open drain window once the writer
        reports its in-flight files for the revoked partitions are
        published-and-acked (or the deadline lapses — then whatever is
        still in flight is abandoned and the new owner redelivers it)."""
        pend = self._revoke_pending
        if pend is None:
            return
        parts = sorted(pend["parts"])
        lis = self._rebalance_listener
        drained = True
        if lis is not None:
            try:
                drained = bool(lis.revocation_drained(parts))
            # lint: swallowed-exceptions ok — a raising drain probe must
            # not wedge the window open forever; treat as drained and let
            # at-least-once redelivery cover whatever was in flight
            except Exception:
                logger.exception("rebalance listener drain probe raised")
        timed_out = time.monotonic() >= pend["deadline"]
        if not drained and not timed_out:
            return
        if not drained and lis is not None:
            try:
                lis.on_revocation_timeout(parts)
            # lint: swallowed-exceptions ok — observability hook, same
            # fetcher-thread contract as the callbacks above
            except Exception:
                logger.exception("rebalance listener timeout hook raised")
        for p in parts:
            # this member is done with p: clear its tracker state down to
            # the committed frontier (whatever did not get acked in the
            # window is the new owner's redelivery)
            self.tracker.reset_partition(
                p, self.broker.committed(self.group_id, self._topic, p))
        self._retry.call(
            lambda: self.broker.confirm_revocation(
                self.group_id, self._topic, self.member_id, parts),
            stop_event=self._stop_event,
            on_retry=self._count_retry, label="broker.confirm_revocation")
        self._revoke_pending = None

    def _heartbeat_tick(self) -> None:
        """Fetcher thread, throttled to a quarter of the session window:
        stamp liveness; a ``rejoin`` response means this member missed its
        window and was expelled — everything it held is LOST."""
        now = time.monotonic()
        if now - self._last_hb < self._hb_interval_s:
            return
        self._last_hb = now
        resp = self._retry.call(
            lambda: self.broker.heartbeat(self.group_id, self._topic,
                                          self.member_id),
            stop_event=self._stop_event,
            on_retry=self._count_retry, label="broker.heartbeat")
        if resp.get("rejoin"):
            self._rejoin()

    def _rejoin(self) -> None:
        """Expelled (missed session window — the zombie path): drop every
        held partition as LOST, then WAIT until the writer has resolved
        its in-flight files for them BEFORE rejoining.  The wait is the
        exactly-once keystone: a worker blocked mid-publish must finish,
        take its fenced-commit rejection, and unpublish while this member
        is still an outsider — rejoining first would make it an owner
        again and its stale ack would be accepted."""
        self._rejoins += 1
        lost = sorted(self._assigned)
        lis = self._rebalance_listener
        if lost:
            self._begin_revocation(lost)  # purge queue + writer fencing
            self._revoke_pending = None   # not a drain window: LOST, no
            #                               confirm_revocation to send
            self._assigned = []
            self._positions = {}
            if lis is not None:
                try:
                    lis.on_partitions_lost(lost)
                # lint: swallowed-exceptions ok — observability hook on
                # the fetcher thread; the rejoin must proceed regardless
                except Exception:
                    logger.exception("rebalance listener on_lost raised")
        if lis is not None and lost:
            warned = False
            deadline = time.monotonic() + self._drain_deadline_s
            # hard bound at 4x the drain deadline: a worker that can no
            # longer respond (a SIGKILL-orphaned or parked child process
            # whose abandon descriptor it will never service) must not
            # wedge the rejoin forever — its runs were never acked, so
            # proceeding costs only at-least-once redelivery, while a
            # member that never rejoins starves its share of the topic
            hard_stop = deadline + 3 * self._drain_deadline_s
            while not self._stop_event.is_set():
                try:
                    if lis.revocation_drained(lost):
                        break
                # lint: swallowed-exceptions ok — a raising drain probe
                # treated as drained: at-least-once redelivery covers it
                except Exception:
                    logger.exception("drain probe raised during rejoin")
                    break
                now = time.monotonic()
                if not warned and now > deadline:
                    warned = True
                    logger.warning(
                        "rejoin of %s waiting on in-flight files for lost "
                        "partitions %s past the drain deadline",
                        self.member_id, lost)
                if now > hard_stop:
                    self._rejoin_drain_timeouts += 1
                    logger.error(
                        "rejoin of %s abandoning the drain wait for lost "
                        "partitions %s (4x drain deadline): in-flight "
                        "files stay un-acked and redeliver",
                        self.member_id, lost)
                    break
                time.sleep(0.005)
        self.broker.join_group(self.group_id, self._topic, self.member_id)
        self._generation = -1  # force a FULL reset on the next refresh

    def _fetch_loop(self) -> None:
        try:
            self._fetch_loop_inner()
        except RetryInterrupted:
            pass  # close() during a fetch retry: clean shutdown
        except Exception as e:
            self._fetcher_error = repr(e)
            logger.exception(
                "consumer fetcher thread died; poll() will starve")
            raise

    def _fetch_loop_inner(self) -> None:
        # feature-detect ONCE: batch-native fetch needs a broker with
        # fetch_batch (FakeBroker, a batch-capable client, or a fault
        # wrapper mirroring one); anything else rides the Record path
        use_batch = (self._batch_ingest
                     and callable(getattr(self.broker, "fetch_batch", None)))
        while self._running:
            if self._suspended:
                time.sleep(0.005)  # SIGSTOP analog: no heartbeat, no fetch
                continue
            if self._coordinated:
                self._heartbeat_tick()
                self._poll_revocation()
            self._refresh_assignment()
            if self._autotune is not None:
                self._apply_autotune()
            fetched = 0
            for p in list(self._assigned):
                if not self._running:
                    break
                if self.tracker.is_backpressured(p):
                    # open-page backpressure (KPW.java:596-611): counted so
                    # a stalled partition is visible from stats(), not just
                    # inferred from a flat-lining consumer rate
                    self._backpressure_skips += 1
                    continue
                pos = self._positions.get(p, 0)
                if use_batch:
                    with stage("consumer.fetch"):
                        rb = self._retry.call(
                            lambda: self.broker.fetch_batch(
                                self._topic, p, pos, self._fetch_max),
                            stop_event=self._stop_event,
                            on_retry=self._count_retry, label="broker.fetch")
                    if rb is None or len(rb) == 0:
                        continue
                    self._batch_fetches += 1
                    with stage("consumer.track"):
                        rb = self._track_run_batch(p, pos, rb)
                    if rb is None:
                        continue
                    if not self._put_batch(rb):
                        break  # shutting down: position not advanced
                    self._positions[p] = rb.start_offset + len(rb)
                    fetched += len(rb)
                    continue
                with stage("consumer.fetch"):
                    # transient poll errors back off and retry in place;
                    # only a fatal-classified error (or retry-budget
                    # exhaustion on a bounded policy) kills the fetcher
                    records = self._retry.call(
                        lambda: self.broker.fetch(self._topic, p, pos,
                                                  self._fetch_max),
                        stop_event=self._stop_event,
                        on_retry=self._count_retry, label="broker.fetch")
                with stage("consumer.track"):
                    if records and records[0].offset > pos:
                        # head gap (offsets compacted away at the source):
                        # pre-ack so the frontier can cross it, mirroring
                        # the interior-gap handling in _track_batch
                        self.tracker.skip_run(p, pos,
                                              records[0].offset - pos)
                    accepted = self._track_batch(p, records)
                if not accepted:
                    continue
                if not self._put_batch(accepted):
                    break  # shutting down: position not advanced, redelivered
                self._positions[p] = accepted[-1].offset + 1
                fetched += len(accepted)
            if fetched == 0:
                time.sleep(0.001)

    def _apply_autotune(self) -> None:
        """Tick the autotuner with the queue's cumulative counters and
        apply the tuned knobs.  Raising the queue bound must wake a
        fetcher/redelivery blocked on the old (smaller) bound — they
        re-read ``_buf_max`` under the condition."""
        tun = self._autotune
        tun.observe(time.perf_counter(), self._records_in, self._records_out)
        self._fetch_max = tun.fetch_max
        if tun.queue_cap != self._buf_max:
            with self._buf_cond:
                self._buf_max = tun.queue_cap
                self._buf_cond.notify_all()
