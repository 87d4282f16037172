"""Cross-process telemetry plane: the shm counter-cell field layout,
the parent-side child-metric aggregator, and the crash flight recorder.

Under ``process_workers(n)`` the children run in their own interpreters:
their stage timers, span buffers, and per-worker counters are invisible
to the parent's :class:`~kpw_tpu_torch.runtime.metrics.MetricRegistry` unless
something carries them across the process boundary.  This module is
that carrier's *data plane*, built on the heartbeat-cell pattern
(``procworkers.ShmBatchRing`` owns the bytes; this module owns the
meaning):

* **TM cells** — one fixed 16-slot int64 vector per child in the shared
  ring (``TM_FIELDS`` names the slots).  The child overwrites its cell
  from the heartbeat publisher thread (~20 Hz); the parent reads it on
  every scrape.  Single-writer, torn reads benign: every field is a
  monotonic counter or a cheap gauge, so a half-updated cell is merely
  a counter a tick stale, never garbage.
* **Dead-child banking** (:class:`ChildTelemetry`) — before a dead
  child's slot is respawned (and its cell cleared for the successor),
  the parent *banks* the final cell values.  Merged totals are
  ``banked + sum(live cells)``: monotonic across restarts, and a dead
  or half-torn cell can never poison the scrape (reads never raise —
  they degrade to the banked totals).
* **Flight recorder** (:class:`FlightRecorder`) — a bounded black box
  of recent fault-path events (heartbeat stalls, pauses, quarantines,
  child deaths) plus a gather hook for live state (recent spans, metric
  snapshot, worker/watchdog observability).  ``dump()`` writes one JSON
  post-mortem naming the trigger and the stalled stage; it is wired to
  the three fatal paths (watchdog SIGKILL, fatal-sink pause, poison
  quarantine) and NEVER raises into them.  Dumps go to the LOCAL
  filesystem under ``<target_dir>/flightrec/`` deliberately — a black
  box that publishes through the (possibly failing) sink would lose
  exactly the crashes it exists to explain.

The side channel for full snapshots (child registry view + drained span
buffers) rides the existing ack queue as ``("telemetry", widx, payload)``
descriptors — low-rate, sent at rotation/seal boundaries and child exit,
absorbed by the parent into :class:`~kpw_tpu_torch.utils.tracing.
MultiProcessTrace` and ``stats()['telemetry']``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque

logger = logging.getLogger(__name__)

# The per-child shm telemetry cell layout: index in this tuple = int64
# slot in the child's TM cell (procworkers sizes the cell at 16 slots;
# trailing slots are spare headroom for future fields — the layout is
# shared memory, so append-only).  Every field is child-cumulative.
TM_FIELDS = (
    "written_records",     # records shredded+appended into open files
    "written_bytes",       # payload bytes of those records
    "flushed_records",     # records in durably published files
    "flushed_bytes",       # file bytes of those publishes
    "files_published",     # published file count
    "units_processed",     # ring units consumed
    "retries",             # sink-retry attempts
    "backoff_ms",          # cumulative retry backoff
    "deadletter_records",  # records routed to the dead-letter file
    "rotations_size",      # size-triggered file rotations
    "rotations_time",      # time-triggered file rotations
    "spans_recorded",      # spans the child's SpanRecorder accepted
    "spans_dropped",       # spans its ring buffer overwrote
    "stage_time_us",       # cumulative stage() wall-time, microseconds
    "rebalance_fenced",    # files flushed under a revoke fence
    "rebalance_abandoned",  # open files abandoned on revoke/lost
)

TM_INDEX = {name: i for i, name in enumerate(TM_FIELDS)}


class ChildTelemetry:
    """Parent-side merged view over the children's TM cells.

    ``ring`` duck-types ``tm_read(widx)`` / ``tm_clear(widx)``;
    ``live_indices`` is a zero-arg callable yielding the worker indices
    whose cells are currently owned by a live child.  ``bank(widx)``
    folds a dead child's final cell into the banked totals and clears
    the cell for its successor — call it before respawn and at pool
    close so :meth:`totals` stays monotonic across the whole tree's
    lifetime."""

    def __init__(self, ring, live_indices) -> None:
        self._ring = ring
        self._live = live_indices
        self._lock = threading.Lock()
        self._banked = [0] * len(TM_FIELDS)
        self._snapshots: dict[int, dict] = {}

    # -- banking -------------------------------------------------------------
    def bank(self, widx: int) -> None:
        """Fold worker ``widx``'s final cell into the banked totals and
        clear the cell (the successor starts from zero)."""
        try:
            vals = self._ring.tm_read(widx)
        # lint: swallowed-exceptions ok — banking races pool teardown
        # (ring views already nulled); losing one dead child's tail
        # counters beats raising into respawn/close
        except Exception:
            logger.exception("telemetry bank of worker %d failed (ignored)",
                             widx)
            return
        with self._lock:
            for i in range(len(TM_FIELDS)):
                self._banked[i] += int(vals[i])
        try:
            self._ring.tm_clear(widx)
        # lint: swallowed-exceptions ok — same teardown race as the read;
        # the cell is about to be recycled or unmapped either way
        except Exception:
            logger.exception("telemetry clear of worker %d failed (ignored)",
                             widx)

    # -- side-channel snapshots ---------------------------------------------
    def absorb_snapshot(self, widx: int, payload: dict) -> None:
        """Store a child's low-rate registry snapshot (the ``telemetry``
        ack-queue descriptor payload) for ``stats()``."""
        if not isinstance(payload, dict):
            return
        with self._lock:
            self._snapshots[int(widx)] = payload

    def snapshots(self) -> dict[int, dict]:
        with self._lock:
            return dict(self._snapshots)

    # -- merged reads --------------------------------------------------------
    def totals(self) -> dict[str, int]:
        """banked + sum over live cells, per field.  Never raises: a
        dead ring view degrades to the banked totals (the dead-child
        cell can never poison the scrape)."""
        with self._lock:
            out = list(self._banked)
        for widx in tuple(self._live()):
            try:
                vals = self._ring.tm_read(widx)
            # lint: swallowed-exceptions ok — scrape racing ring close /
            # child respawn; the banked half of the sum is still valid
            # and the next scrape re-reads
            except Exception:
                continue
            for i in range(len(TM_FIELDS)):
                out[i] += int(vals[i])
        return {name: out[i] for i, name in enumerate(TM_FIELDS)}

    def field(self, name: str) -> int:
        return self.totals()[name]

    def snapshot(self) -> dict:
        """The ``stats()['telemetry']`` block: merged totals plus the
        last side-channel snapshot per child."""
        return {"children_merged": self.totals(),
                "child_snapshots": self.snapshots()}


class FlightRecorder:
    """Bounded black box for the fault paths: :meth:`note` appends
    timestamped events to a ring of ``capacity``; :meth:`dump` writes
    one JSON post-mortem combining those events with whatever the
    ``gather`` hook can still collect (recent spans, metric snapshot,
    worker/watchdog observability) — naming the ``trigger`` and, when
    the watchdog attributed one, the ``stalled_stage``.

    Dumps never raise and never publish through the writer's sink: they
    go to the local filesystem under ``<base_dir>/flightrec/``."""

    def __init__(self, base_dir: str, instance: str, capacity: int = 256,
                 meter=None, keep: int = 16) -> None:
        self.dir = os.path.join(base_dir, "flightrec")
        self._instance = instance
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._meter = meter
        self._gather = None
        self._seq = 0
        self._recent: deque = deque(maxlen=keep)

    def set_gather(self, fn) -> None:
        """``fn() -> dict`` of extra sections folded into every dump
        (the writer wires spans/metrics/worker observability here)."""
        self._gather = fn

    # -- the event ring ------------------------------------------------------
    def note(self, kind: str, **fields) -> None:
        """Append one fault-path event.  Cheap and exception-free by
        construction — called from watchdog/collector hot paths."""
        evt = {"wall_time_unix_s": round(time.time(), 6), "kind": kind}
        evt.update(fields)
        with self._lock:
            self._events.append(evt)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    # -- the post-mortem -----------------------------------------------------
    def dump(self, trigger: str, stalled_stage: str | None = None,
             **detail) -> str | None:
        """Write one JSON post-mortem; returns its path, or None when
        the write itself failed (logged, never raised — the fault paths
        that call this are already handling a worse problem)."""
        try:
            sections = self._gather() if self._gather is not None else {}
        # lint: swallowed-exceptions ok — the gather hook walks live
        # writer state mid-fault; a partial black box with the trigger
        # and event ring beats no black box
        except Exception as e:
            logger.exception("flight recorder gather failed (degraded dump)")
            sections = {"gather_error": repr(e)}
        with self._lock:
            self._seq += 1
            seq = self._seq
        doc = {
            "flight_recorder": 1,
            "instance": self._instance,
            "trigger": trigger,
            "stalled_stage": stalled_stage,
            "wall_time_unix_s": round(time.time(), 6),
            "detail": detail,
            "events": self.events(),
        }
        doc.update(sections)
        path = os.path.join(
            self.dir, f"flightrec_{self._instance}_{seq:03d}_{trigger}.json")
        try:
            os.makedirs(self.dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=2, sort_keys=True, default=repr)
            os.replace(tmp, path)
        # lint: swallowed-exceptions ok — dump runs inside the watchdog
        # condemn / fatal-pause / quarantine paths; a failed post-mortem
        # write must never worsen the fault it documents
        except OSError:
            logger.exception("flight recorder dump to %s failed (ignored)",
                             path)
            return None
        if self._meter is not None:
            self._meter.mark()
        with self._lock:
            self._recent.append(path)
        logger.error("flight recorder: %s dump (stalled_stage=%s) -> %s",
                     trigger, stalled_stage, path)
        return path

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "dir": self.dir,
                "events_buffered": len(self._events),
                "dumps_written": self._seq,
                "recent_dumps": list(self._recent),
            }
