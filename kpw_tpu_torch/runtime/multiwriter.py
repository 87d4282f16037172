"""Multi-tenant writer service: N (topic, proto, target) routes sharing
one broker session, one encoder/assembly pool, and one compaction
service — isolated by per-tenant BULKHEADS.

ROADMAP's top open item: millions of users means many producers with
*different* protos, where the failure mode that matters is a noisy
neighbor, not a dead disk.  ``Builder.route(topic, proto_class,
target_dir, **overrides)`` called N times builds a :class:`MultiWriter`
instead of a single :class:`~kpw_tpu_torch.runtime.writer.
KafkaProtoParquetWriter`; each route is a full writer (its own workers,
consumer queue, offset tracker, ack frontier, target tree) wired into
three SHARED seams:

* **one broker session** — every route's consumer fetches through a
  :class:`_TenantBrokerView` over one shared broker client
  (``_SharedBrokerSession``), so the framework holds one connection
  however many topics it drains (group fan-in: one consumer group, N
  topic memberships);
* **one encoder pool** — the native assembly/encode pool is process-wide
  already (``core/writer.py`` shares its ``assemble_many`` executor per
  encoder options), so routes contend for cores through one pool instead
  of N oversubscribed ones;
* **one compaction service** — :class:`_SharedCompactionService` drives
  every route's Compactor from ONE background thread (round-robin, per
  route cadence preserved) with an optionally SHARED bandwidth budget,
  so background rewrite traffic cannot multiply per tenant.

The BULKHEADS:

* **Per-tenant quotas** (:class:`TenantQuotaLedger`): each route gets a
  queue share (records it may hold in its consumer queue, charged at the
  fetcher's enqueue and credited at worker drain through the consumer's
  ``queue_listener`` seam) and an open-file budget (the LRU bound
  generalized across the route's workers).  Enforcement is
  BACKPRESSURE-ON-THE-OFFENDER, never drop: a tenant at its queue share
  parks its own fetch gate (``tenant.quota.wait`` stage, stall episodes
  metered as ``parquet.writer.tenant.queue.stalls``) while sibling
  fetchers proceed; a tenant at its file budget closes-and-publishes its
  own LRU open file (``parquet.writer.tenant.files.evicted``) before
  opening another.  The ledger's per-tenant counters and its global
  total are updated under one lock with a schedcheck preemption point
  between them and an invariant probe (``note_quota_ledger``) at every
  charge/credit — a torn multi-route update raises with both stacks.
* **Per-tenant fault domains**: a route whose sink fails pauses or dies
  ALONE (its own retry policy / degraded-mode pause / supervisor — the
  supervision seams, instantiated per route); a poison stream dead-letters or
  kills only its own route's workers; a schema turned incompatible
  dead-letters the whole route with a typed reason
  (:class:`SchemaIncompatibleError`) — and in every case sibling routes
  keep their workers, their ack cadence, and their quota headroom.
* **Per-tenant observability**: ``stats()['tenants'][name]`` carries
  each route's ack-lag, worker liveness, quota snapshot, dead-letter
  count and typed status; the canonical tenant-layer meters/gauges
  (``runtime/metrics.py``) render in both generic exporters with no
  per-metric wiring.
* **Schema evolution, the way parquet readers expect**: at ``start()``
  each route's proto schema is diffed against its published tree
  (``io/verify.py`` ``file_schema``).  Additive fields (new columns) are
  the expected shape — merged-schema reads stay consistent, the
  cross-file audit (``audit_schema_consistency``) reports them without
  flagging; an INCOMPATIBLE change (one dotted leaf path, two physical
  types) flips the route to ``dead_lettering``: every record lands in
  the route's dead-letter file (then acks — the stream keeps draining,
  nothing is lost, nothing poisons the tree) and the typed reason is
  surfaced in the route's status.
"""

from __future__ import annotations

import copy
import logging
import threading
import time

from ..utils import schedcheck
from ..utils.tracing import stage
from . import metrics as M

logger = logging.getLogger(__name__)


class SchemaIncompatibleError(TypeError):
    """A route's proto schema conflicts with its already-published tree
    (one dotted leaf path carrying two physical types): new files would
    break merged-schema readers, so the route dead-letters instead of
    writing.  Deliberately a TypeError subclass, not OSError — the
    bytes are wrong for this tree, and no IO retry can fix that."""


class TenantQuotaLedger:
    """The shared-session quota ledger: per-tenant queue occupancy +
    open-file budgets, with backpressure-on-the-offender enforcement.

    Charges ride the consumer's ``queue_listener`` seam (``on_enqueued``
    under the buffer condition, per admitted slice) and credits ride the
    drain (``on_drained``); the fetch gate (:meth:`wait_turn`) parks the
    offending tenant's fetcher while it is at its share.  Per-tenant
    counters and the global total are updated under ONE lock with a
    schedcheck preemption point between the two writes and the
    ``note_quota_ledger`` invariant probe after them — the torn-update
    bug class is mechanized, not hoped away.  Lock ordering: callers may
    hold their consumer's buffer condition when charging/crediting; the
    ledger only ever takes its own lock (and the meters' leaf locks), so
    the graph stays acyclic."""

    def __init__(self, registry=None) -> None:
        self._cv = threading.Condition()
        self._queued: dict[str, int] = {}
        self._queued_total = 0
        self._quota: dict[str, int | None] = {}
        self._file_budget: dict[str, int | None] = {}
        self._open_files_fn: dict[str, object] = {}
        self._stalls: dict[str, int] = {}
        self._stall_s: dict[str, float] = {}
        self._closed = False
        self._m_stalls = (registry.meter(M.TENANT_QUEUE_STALLS_METER)
                          if registry else M.Meter())
        self._m_stall_ms = (registry.meter(M.TENANT_QUEUE_STALL_MS_METER)
                            if registry else M.Meter())

    def register(self, tenant: str, queue_quota: int | None = None,
                 file_budget: int | None = None,
                 open_files_fn=None) -> None:
        """Declare a tenant's shares.  ``queue_quota`` bounds the records
        it may hold in its consumer queue (None = unquotaed);
        ``file_budget`` bounds its concurrently open partition files
        across workers, counted live through ``open_files_fn`` (a
        zero-arg callable — no incr/decr bookkeeping to drift)."""
        if queue_quota is not None and queue_quota < 1:
            raise ValueError("queue_quota must be >= 1")
        if file_budget is not None and file_budget < 1:
            raise ValueError("open_file_budget must be >= 1")
        with self._cv:
            self._queued.setdefault(tenant, 0)
            self._quota[tenant] = queue_quota
            self._file_budget[tenant] = file_budget
            if open_files_fn is not None:
                self._open_files_fn[tenant] = open_files_fn
            self._stalls.setdefault(tenant, 0)
            self._stall_s.setdefault(tenant, 0.0)

    # -- charge/credit (the consumer queue_listener seam) --------------------
    def on_enqueued(self, tenant: str, n: int) -> None:
        with self._cv:
            self._queued[tenant] = self._queued.get(tenant, 0) + n
            schedcheck.point("tenant.ledger.charge")
            self._queued_total += n
            schedcheck.note_quota_ledger(
                id(self), sum(self._queued.values()), self._queued_total)

    def on_drained(self, tenant: str, n: int) -> None:
        with self._cv:
            take = min(n, self._queued.get(tenant, 0))
            self._queued[tenant] = self._queued.get(tenant, 0) - take
            schedcheck.point("tenant.ledger.credit")
            self._queued_total -= take
            schedcheck.note_quota_ledger(
                id(self), sum(self._queued.values()), self._queued_total)
            self._cv.notify_all()

    # -- enforcement ---------------------------------------------------------
    def _over_quota(self, tenant: str) -> bool:
        q = self._quota.get(tenant)
        return q is not None and self._queued.get(tenant, 0) >= q

    def wait_turn(self, tenant: str, tick_s: float = 0.05) -> float:
        """The fetch gate: park while ``tenant`` is at its queue share.
        Returns seconds stalled (0.0 on the fast path).  Backpressure on
        the offender only — the gate runs in the offending route's own
        fetcher thread, siblings never enter it."""
        with self._cv:
            if self._closed or not self._over_quota(tenant):
                return 0.0
        t0 = time.perf_counter()
        self._m_stalls.mark()
        with stage("tenant.quota.wait"):
            with self._cv:
                self._stalls[tenant] = self._stalls.get(tenant, 0) + 1
                while not self._closed and self._over_quota(tenant):
                    self._cv.wait(tick_s)
                dt = time.perf_counter() - t0
                self._stall_s[tenant] = self._stall_s.get(tenant, 0.0) + dt
        self._m_stall_ms.mark(max(1, int(dt * 1000)))
        return dt

    def files_over_budget(self, tenant: str | None) -> bool:
        """Live verdict for the open-file budget: True when the tenant's
        open-file count (counted through its registered callable —
        lock-free scrape of worker-owned maps, same contract as the
        gauges) has reached its budget.  The caller (the worker about to
        open one more) evicts its own LRU first."""
        if tenant is None:
            return False
        with self._cv:
            budget = self._file_budget.get(tenant)
            fn = self._open_files_fn.get(tenant)
        if budget is None or fn is None:
            return False
        try:
            return fn() >= budget
        # lint: swallowed-exceptions ok — lock-free scrape racing worker
        # dict mutation; a missed enforcement round beats killing the
        # write path, and the next open re-checks
        except Exception:
            return False

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    # -- observability -------------------------------------------------------
    def tenant_snapshot(self, tenant: str) -> dict:
        with self._cv:
            fn = self._open_files_fn.get(tenant)
            out = {
                "queued_records": self._queued.get(tenant, 0),
                "queue_quota": self._quota.get(tenant),
                "open_file_budget": self._file_budget.get(tenant),
                "quota_stalls": self._stalls.get(tenant, 0),
                "quota_stall_s": round(self._stall_s.get(tenant, 0.0), 6),
            }
        if fn is not None:
            try:
                out["open_files"] = int(fn())
            # lint: swallowed-exceptions ok — observability scrape racing
            # worker teardown; the quota fields above are still valid
            except Exception:
                out["open_files"] = None
        return out

    def snapshot(self) -> dict:
        with self._cv:
            tenants = sorted(self._queued)
            total = self._queued_total
        return {
            "queued_total": total,
            "tenants": {t: self.tenant_snapshot(t) for t in tenants},
        }


class _LedgerQueueListener:
    """Binds one route's consumer-queue traffic to its tenant name on
    the shared ledger (the consumer's ``queue_listener`` seam)."""

    __slots__ = ("_ledger", "_tenant")

    def __init__(self, ledger: TenantQuotaLedger, tenant: str) -> None:
        self._ledger = ledger
        self._tenant = tenant

    def on_enqueued(self, n: int) -> None:
        self._ledger.on_enqueued(self._tenant, n)

    def on_drained(self, n: int) -> None:
        self._ledger.on_drained(self._tenant, n)


class _SharedBrokerSession:
    """One broker client shared by every route's consumer — the
    'one session, N topics' seam.  Tracks per-tenant fetch/record
    accounting so the session's traffic split is observable."""

    def __init__(self, broker) -> None:
        self.broker = broker
        self._mu = threading.Lock()
        self._fetches: dict[str, int] = {}
        self._records: dict[str, int] = {}

    def view(self, tenant: str, ledger: TenantQuotaLedger):
        return _TenantBrokerView(self, tenant, ledger)

    def note_fetch(self, tenant: str, n: int) -> None:
        with self._mu:
            self._fetches[tenant] = self._fetches.get(tenant, 0) + 1
            self._records[tenant] = self._records.get(tenant, 0) + n

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "fetches_by_tenant": dict(sorted(self._fetches.items())),
                "records_by_tenant": dict(sorted(self._records.items())),
            }


class _TenantBrokerView:
    """One route's window onto the shared broker session: fetches pass
    the tenant's quota gate first (blocking the OFFENDER's fetcher only),
    everything else delegates.  ``fetch_batch`` is surfaced only when the
    underlying broker has one, so the consumer's batch-ingest feature
    detection keeps working through the view."""

    def __init__(self, session: _SharedBrokerSession, tenant: str,
                 ledger: TenantQuotaLedger) -> None:
        self._session = session
        self._inner = session.broker
        self._tenant = tenant
        self._ledger = ledger
        if callable(getattr(self._inner, "fetch_batch", None)):
            # instance attribute, not a class method: a broker without
            # fetch_batch must keep raising AttributeError through the
            # view (the consumer's feature detection)
            self.fetch_batch = self._gated_fetch_batch

    def fetch(self, topic, partition, offset, max_records):
        self._ledger.wait_turn(self._tenant)
        recs = self._inner.fetch(topic, partition, offset, max_records)
        if recs:
            self._session.note_fetch(self._tenant, len(recs))
        return recs

    def _gated_fetch_batch(self, topic, partition, offset, max_records):
        self._ledger.wait_turn(self._tenant)
        rb = self._inner.fetch_batch(topic, partition, offset, max_records)
        if rb is not None and len(rb):
            self._session.note_fetch(self._tenant, len(rb))
        return rb

    def __getattr__(self, name):
        # join_group/commit/committed/generation/assignment/... delegate;
        # a missing attribute raises AttributeError from the inner broker,
        # preserving feature detection
        return getattr(self._inner, name)


class _Route:
    """One tenant's slot: its spec, its writer, and its typed status."""

    __slots__ = ("name", "spec", "writer", "forced_state", "reason_type",
                 "reason")

    def __init__(self, name: str, spec: dict, writer) -> None:
        self.name = name
        self.spec = spec
        self.writer = writer
        # "dead_lettering" once the schema guard condemned the route;
        # None = derive the live state from the writer
        self.forced_state: str | None = None
        self.reason_type: str | None = None
        self.reason: str | None = None

    def condemn(self, exc: BaseException, state: str) -> None:
        self.forced_state = state
        self.reason_type = type(exc).__name__
        self.reason = str(exc)

    def state(self) -> str:
        if self.forced_state is not None:
            return self.forced_state
        w = self.writer
        if w._terminal is not None:
            return "failed"
        if w._paused:
            return "paused"
        if not w._started:
            return "built"
        if w._closed:
            return "closed"
        return "running"

    def status(self) -> dict:
        return {"state": self.state(), "reason_type": self.reason_type,
                "reason": self.reason}


class _SharedCompactionService:
    """ONE background thread driving every route's Compactor round-robin
    (``recover()`` + ``compact_once()``), each route at ITS OWN
    configured cadence (per-route next-due clocks — a route that chose a
    long ``scan_interval_seconds`` to bound remote request/bandwidth
    cost is never scanned on a sibling's faster schedule), with a fault
    bulkhead per round — one route's compaction failure is logged and
    contained, siblings' rounds still run — and an optionally SHARED
    bandwidth budget: when any route's compaction config names
    ``bandwidth_bytes_per_s``, ONE token bucket throttles every route's
    merge traffic (background rewrite cost cannot multiply per tenant)."""

    def __init__(self, compactors: dict[str, object],
                 intervals: dict[str, float]) -> None:
        self._compactors = compactors
        self._intervals = intervals
        self._tick = min(intervals.values())
        self._closed = threading.Event()
        self._errors: dict[str, str] = {}
        self._thread = threading.Thread(
            target=self._loop, name="KPW-tenant-compaction", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def close(self, timeout: float = 5.0) -> None:
        self._closed.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)

    def _loop(self) -> None:
        next_due = {name: 0.0 for name in self._compactors}
        while not self._closed.is_set():
            for name, c in self._compactors.items():
                if self._closed.is_set():
                    return
                if time.monotonic() < next_due[name]:
                    continue
                next_due[name] = time.monotonic() + self._intervals[name]
                try:
                    # one traced round per route: the compaction legs were
                    # the longest untraced gap in the e2e timeline
                    with stage("compactor.round", tenant=name):
                        c.recover()
                        c.compact_once()
                    self._errors.pop(name, None)
                except Exception as e:  # bulkhead: contain per route
                    self._errors[name] = repr(e)
                    logger.exception(
                        "tenant %s compaction round failed (contained; "
                        "sibling rounds continue)", name)
            if self._closed.wait(self._tick):
                return

    def snapshot(self) -> dict:
        return {
            "routes": sorted(self._compactors),
            "last_errors": dict(self._errors),
            "by_tenant": {n: c.compactor_stats()
                          for n, c in self._compactors.items()},
        }


def _tree_physical_types(fs, target_dir: str) -> dict[str, set]:
    """Union of leaf physical types per dotted column path across the
    tree's published files — the ``io/verify.py`` ``tree_schemas`` walk
    (ONE exclude-set/unreadable policy shared with the audit), folded to
    the union the route-level guard compares against."""
    from ..io.verify import tree_schemas

    per_file, _unreadable = tree_schemas(fs, target_dir)
    types: dict[str, set] = {}
    for leaves in per_file.values():
        for col, (pt, _rep, _conv) in leaves.items():
            types.setdefault(col, set()).add(pt)
    return types


class MultiWriter:
    """N per-tenant routes over one broker session, one encoder pool and
    one compaction service — constructed by ``Builder.build()`` when
    ``Builder.route(...)`` was called (see the module docstring for the
    bulkhead contract).  Lifecycle mirrors the single writer: ``start()``
    / ``close()`` / context manager; per-tenant surfaces are
    ``stats()['tenants']``, :meth:`route_stats`, :meth:`ack_lag` and the
    canonical tenant meters."""

    def __init__(self, b) -> None:  # b: runtime.builder.Builder (with routes)
        if not b._routes:
            raise ValueError("MultiWriter needs at least one route()")
        if b._broker is None:
            raise ValueError("routes need a broker (Builder.broker or "
                             "consumer_config)")
        if b._proc_workers:
            raise ValueError(
                "process_workers is not supported with route() yet: the "
                "shared-memory ring and per-child ledgers are per-writer "
                "(one pool per route would multiply rings per tenant); "
                "use thread workers for multi-tenant routes")
        self._b = b
        reg = b._metric_registry
        self.ledger = TenantQuotaLedger(registry=reg)
        self.session = _SharedBrokerSession(b._broker)
        self._routes: dict[str, _Route] = {}
        self._started = False
        self._closed = False
        self._last_close_report: dict | None = None
        self._compaction_svc: _SharedCompactionService | None = None
        compaction_cfgs: dict[str, dict] = {}
        for spec in b._routes:
            name = spec["name"]
            if name in self._routes:
                raise ValueError(f"duplicate route name {name!r}")
            rb = copy.copy(b)
            rb._routes = []
            rb._topic = spec["topic"]
            rb._proto_class = spec["proto_class"]
            rb._target_dir = spec["target_dir"]
            # a base-builder parser cannot apply across different protos;
            # routes re-derive the default (FromString) unless the
            # override re-sets one
            rb._parser = None
            for key, args in spec["overrides"].items():
                setter = getattr(rb, key)
                if isinstance(args, dict):
                    setter(**args)
                elif isinstance(args, tuple):
                    setter(*args)
                else:
                    setter(args)
            rb._broker = self.session.view(name, self.ledger)
            rb._queue_listener = _LedgerQueueListener(self.ledger, name)
            cfg = rb._compaction
            rb._compaction = None  # owned by the shared service, not start()
            if cfg:
                compaction_cfgs[name] = cfg
            writer = rb.build()
            writer.bind_tenant(name, self.ledger)
            route = _Route(name, spec, writer)
            self._routes[name] = route
            self.ledger.register(
                name, queue_quota=spec.get("queue_quota"),
                file_budget=spec.get("open_file_budget"),
                open_files_fn=self._open_files_counter(writer))
        if compaction_cfgs:
            self._compaction_svc = self._build_compaction(compaction_cfgs)
        if reg:
            self._register_aggregate_gauges(reg)

    @staticmethod
    def _open_files_counter(writer):
        def count() -> int:
            n = 0
            for w in writer._workers:
                n += len(w._part_files)
                if w.current_file is not None:
                    n += 1
            return n
        return count

    def _build_compaction(self, cfgs: dict[str, dict]):
        from ..io.compact import Compactor

        shared_budget = None
        for cfg in cfgs.values():
            if cfg.get("bandwidth_bytes_per_s"):
                from ..io.objectstore import BandwidthBudget

                # ONE bucket for every route's merge traffic: the first
                # route naming a budget sets the shared cap
                shared_budget = BandwidthBudget(cfg["bandwidth_bytes_per_s"])
                break
        compactors = {}
        intervals = {name: cfg["scan_interval_s"]
                     for name, cfg in cfgs.items()}
        for name, cfg in cfgs.items():
            route = self._routes[name]
            w = route.writer
            compactors[name] = Compactor(
                w.fs, w.target_dir, route.spec["proto_class"], w.properties,
                target_size=cfg["target_size"],
                small_file_ratio=cfg["small_file_ratio"],
                min_files=cfg["min_files"],
                scan_interval_s=cfg["scan_interval_s"],
                registry=self._b._metric_registry,
                instance_name=f"{self._b._instance_name}-{name}",
                sort_by=cfg["sort_by"],
                request_budget_per_round=cfg["request_budget_per_round"],
                partition_quota=cfg["partition_quota"],
                bandwidth_budget=shared_budget)
        return _SharedCompactionService(compactors, intervals)

    def _register_aggregate_gauges(self, reg) -> None:
        """Re-point the writer-level gauges each route's constructor
        registered (last-one-wins on a shared registry) at AGGREGATE
        providers, and add the tenant-layer gauges."""
        routes = self._routes

        def writers():
            return [r.writer for r in routes.values()]

        reg.gauge(M.ACK_LAG_GAUGE,
                  lambda: sum(w.ack_lag()["unacked_records"]
                              for w in writers()))
        reg.gauge(M.ACK_AGE_GAUGE,
                  lambda: max((w.ack_lag()["oldest_unacked_age_s"]
                               for w in writers()), default=0.0))
        reg.gauge(M.CONSUMER_QUEUE_DEPTH_GAUGE,
                  lambda: sum(w.consumer.queue_depth() for w in writers()))
        reg.gauge(M.WORKERS_ALIVE_GAUGE,
                  lambda: sum(1 for w in writers()
                              for wk in w._workers if wk.alive()))
        reg.gauge(M.PARTITIONS_OPEN_GAUGE,
                  lambda: sum(len(wk._part_files) for w in writers()
                              for wk in w._workers))
        reg.gauge(M.PAUSED_GAUGE,
                  lambda: sum(len(w._paused) for w in writers()))
        reg.gauge(M.TENANT_ROUTES_GAUGE, lambda: len(routes))
        reg.gauge(M.TENANT_ROUTES_DEGRADED_GAUGE,
                  lambda: sum(1 for r in routes.values()
                              if r.state() not in ("running", "built")
                              or not r.writer.healthy()))

    # -- schema evolution guard ----------------------------------------------
    def _schema_guard(self, route: _Route) -> None:
        """Diff the route's proto schema against its published tree.
        Additive columns pass (merged-schema reads stay consistent); a
        physical-type conflict on one dotted leaf path condemns the
        route to ``dead_lettering``: its parser is replaced with a
        :class:`SchemaIncompatibleError` raiser and its parse-error
        policy forced to ``dead_letter``, so every record lands in the
        route's dead-letter file (then acks) instead of poisoning the
        tree — and the wire fast path is disqualified (the flag the
        worker loop reads), so nothing bypasses the raiser."""
        from ..models.proto_bridge import proto_to_schema

        w = route.writer
        try:
            with stage("tenant.schema.audit", tenant=route.name):
                existing = _tree_physical_types(w.fs, w.target_dir)
        except OSError as e:
            logger.warning("route %s: schema guard could not list the "
                           "tree (%r); guard skipped", route.name, e)
            return
        if not existing:
            return
        new = {c.name: c.leaf.physical_type
               for c in proto_to_schema(route.spec["proto_class"]).columns}
        conflicts = [
            (col, sorted(existing[col]), pt)
            for col, pt in sorted(new.items())
            if col in existing and pt not in existing[col]
        ]
        if not conflicts:
            return
        detail = "; ".join(
            f"column {col!r}: published physical type(s) {have} vs proto "
            f"{want}" for col, have, want in conflicts[:3])
        err = SchemaIncompatibleError(
            f"route {route.name!r} ({route.spec['topic']} -> "
            f"{route.spec['target_dir']}): proto schema incompatible with "
            f"the published tree — {detail}")
        route.condemn(err, "dead_lettering")

        def _poison_parser(payload, _e=err):
            raise _e

        b = w._b
        b._parser = _poison_parser
        b._parser_is_default = False  # disqualify the wire fast path
        b._on_parse_error = "dead_letter"
        logger.error("%s — route dead-letters with its typed reason; "
                     "sibling routes unaffected", err)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self._started:
            raise ValueError("already started")
        self._started = True
        for route in self._routes.values():
            self._schema_guard(route)
        started: list[_Route] = []
        try:
            for route in self._routes.values():
                with stage("tenant.route.start", tenant=route.name):
                    route.writer.start()
                started.append(route)
        except Exception:
            # a route that cannot even START is a config error, not a
            # runtime fault: unwind the siblings cleanly and surface it.
            # Ledger first — a sibling's fetcher may already be parked
            # in the quota gate, and close() alone never drains the
            # queue that parked it, so without this the daemon thread
            # (and its writer) leak for the life of the process
            self.ledger.close()
            for route in started:
                try:
                    route.writer.close()
                except Exception:  # lint: swallowed-exceptions ok —
                    # best-effort unwind on the construction error path
                    logger.exception("unwind close of route %s failed",
                                     route.name)
            raise
        if self._compaction_svc is not None:
            self._compaction_svc.start()

    def close(self, deadline: float | None = None) -> dict | None:
        """Close every route.  A terminally-failed route NEVER blocks a
        sibling's clean shutdown (the bulkhead holds through close): its
        ``WriterFailedError`` is captured into the report's
        ``terminal_routes`` and re-raised only when EVERY route failed
        terminally.  ``deadline`` bounds the whole shutdown; each route
        gets the remaining budget."""
        if self._closed:
            return self._last_close_report
        self._closed = True
        t0 = time.monotonic()
        t_end = None if deadline is None else t0 + max(0.0, deadline)
        if self._compaction_svc is not None:
            self._compaction_svc.close()
        # quotas stop binding first: a gated fetcher must not park
        # through its consumer's close join
        self.ledger.close()
        reports: dict[str, dict | None] = {}
        terminals: dict[str, str] = {}
        for name, route in self._routes.items():
            rem = (None if t_end is None
                   else max(0.0, t_end - time.monotonic()))
            try:
                with stage("tenant.route.close", tenant=name):
                    reports[name] = route.writer.close(deadline=rem)
            except Exception as e:  # WriterFailedError and kin: contained
                terminals[name] = repr(e)
        report = {
            "deadline_s": deadline,
            "duration_s": round(time.monotonic() - t0, 3),
            "routes": reports,
            "terminal_routes": terminals,
        }
        self._last_close_report = report
        if terminals and len(terminals) == len(self._routes):
            from .writer import WriterFailedError

            raise WriterFailedError(
                f"every route failed terminally: {terminals}")
        return report

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()

    # -- per-tenant surface ---------------------------------------------------
    @property
    def routes(self) -> dict:
        """name -> the route's underlying writer (read-only use)."""
        return {n: r.writer for n, r in self._routes.items()}

    def route(self, name: str):
        return self._routes[name].writer

    def route_status(self, name: str) -> dict:
        return self._routes[name].status()

    def route_stats(self, name: str) -> dict:
        """The full single-writer stats() of one route."""
        return self._routes[name].writer.stats()

    def healthy(self) -> bool:
        if not self._started or self._closed:
            return False
        return all(r.writer.healthy() for r in self._routes.values())

    def ack_lag(self) -> dict:
        """Aggregate plus per-tenant ack lag (the per-tenant halves are
        each route's SLA observable)."""
        per = {n: r.writer.ack_lag() for n, r in self._routes.items()}
        return {
            "unacked_records": sum(p["unacked_records"]
                                   for p in per.values()),
            "oldest_unacked_age_s": max(
                (p["oldest_unacked_age_s"] for p in per.values()),
                default=0.0),
            "by_tenant": per,
        }

    def stats(self) -> dict:
        # ONE ledger snapshot per scrape: the per-tenant quota dicts are
        # shared into each tenant block instead of re-snapshotting per
        # route (a 25 ms sampling loop would otherwise double the ledger
        # lock traffic against the hot charge/credit path)
        ledger = self.ledger.snapshot()
        tenants = {}
        for name, route in self._routes.items():
            w = route.writer
            sla = route.spec.get("ack_sla_seconds")
            lag = w.ack_lag()
            tenants[name] = {
                "topic": route.spec["topic"],
                "target_dir": route.spec["target_dir"],
                **route.status(),
                "healthy": w.healthy(),
                "ack": lag,
                "ack_sla_seconds": sla,
                "sla_violated": (sla is not None
                                 and lag["oldest_unacked_age_s"] > sla),
                "workers_alive": sum(1 for wk in w._workers if wk.alive()),
                "workers_dead": sum(1 for wk in w._workers if wk.failed),
                "restarts_total": sum(w._restart_counts),
                "deadletter_records": w._deadletter_route.count,
                # this route's OWN time-to-durable distribution (seconds,
                # p50/p99): the route-local histogram, not the canonical
                # one a shared registry merges across tenants
                "ack_latency": w._ack_latency_route.snapshot(),
                "quota": ledger["tenants"].get(name, {}),
            }
        out = {
            "healthy": self.healthy(),
            "tenants": tenants,
            "quota_ledger": ledger,
            "session": self.session.snapshot(),
        }
        if self._compaction_svc is not None:
            out["compaction"] = self._compaction_svc.snapshot()
        return out
