"""Per-stage tracing/profiling for the encode pipeline.

The reference has no tracing — only lifecycle logging (SURVEY.md §5,
KafkaProtoParquetWriter.java:172-197).  The port needs real stage
attribution because the pipeline is host ingest / device encode / host
flush: a slowdown can hide in device dispatch, host assembly, or IO.

Three layers, all zero-cost when disabled:

- :class:`StageTimer` — cumulative wall-clock + call counts + min/max per
  stage, queryable programmatically (the metrics analog of the reference's
  written/flushed meters, KPW.java:144-151, but for time).
- :class:`SpanRecorder` — a bounded, thread-safe ring buffer of individual
  spans (name, thread, start, duration, optional attrs like row-group
  ordinal or file path), exportable as Chrome/Perfetto ``trace_event``
  JSON so dispatch-vs-assembly-vs-IO overlap is visually inspectable on
  a timeline instead of inferred from cumulative sums.
- ``torch.profiler.record_function`` — when a PyTorch profiler trace is
  being captured, the same ``stage(...)`` spans show up on its timeline
  against the CUDA kernel activity.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from contextlib import contextmanager

# Canonical stage-name registry: every name ``stage(...)`` is called with
# anywhere in the codebase, equal to the JAX package's.  Docs cite these
# names.  Grouped by pipeline leg:
#   consumer.* — the smart-commit fetcher thread (ingest/consumer.py)
#   worker.*   — the per-worker poll loop (runtime/writer.py)
#   rowgroup.* — the row-group pipeline stages (core/writer.py)
#   encode.*   — the encoder's internal phases (ops/backend.py)
#   compactor.* — the small-file compaction service (io/compact.py)
#   upload.*   — the object-store part uploader (io/objectstore.py)
#   tenant.*   — the multi-tenant routing legs (runtime/multiwriter.py)
STAGE_NAMES = (
    "consumer.fetch",
    "consumer.track",
    "worker.shred",
    "worker.append",
    "worker.publish",
    "worker.proc.dispatch",
    "worker.proc.ack",
    "rowgroup.encode",
    "rowgroup.launch",
    "rowgroup.assemble",
    "rowgroup.io_write",
    "encode.launch",
    "encode.bodies",
    "encode.assemble",
    "assemble.native",
    "encode.bloom",
    "encode.page_index",
    "compactor.merge",
    "compactor.round",
    "upload.part",
    "tenant.quota.wait",
    "tenant.route.start",
    "tenant.route.close",
    "tenant.schema.audit",
)


class StageTimer:
    """Thread-safe cumulative timer keyed by stage name."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._total: dict[str, float] = {}
        self._count: dict[str, int] = {}
        self._min: dict[str, float] = {}
        self._max: dict[str, float] = {}

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self._total[name] = self._total.get(name, 0.0) + seconds
            self._count[name] = self._count.get(name, 0) + 1
            if seconds < self._min.get(name, float("inf")):
                self._min[name] = seconds
            if seconds > self._max.get(name, float("-inf")):
                self._max[name] = seconds

    def summary(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {
                name: {"seconds": self._total[name],
                       "calls": self._count[name],
                       "min": self._min[name],
                       "max": self._max[name]}
                for name in sorted(self._total)
            }

    def reset(self) -> None:
        with self._lock:
            self._total.clear()
            self._count.clear()
            self._min.clear()
            self._max.clear()


class SpanRecorder:
    """Bounded thread-safe ring buffer of per-event spans.

    Each span is (name, thread_name, thread_id, start_s, duration_s,
    attrs) with ``start_s`` relative to the recorder's creation.  The
    buffer is a ``deque(maxlen=capacity)``: at capacity the OLDEST spans
    are evicted, so a long run keeps the most recent window — the part a
    live investigation actually wants — at O(capacity) memory.  Append is
    one lock round per span; spans here are stage-granular (row groups,
    fetch batches), not per record, so the hot path never sees more than
    a few thousand appends per second."""

    def __init__(self, capacity: int = 65536, pid: int | None = None) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        # real process identity: every exported event carries the pid that
        # recorded it, so a merged multi-process trace keeps its rows
        # separable (and a single-process trace is honest about which
        # process it came from)
        self.pid = os.getpid() if pid is None else pid
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=capacity)
        self._dropped = 0
        # wall-clock anchor + monotonic epoch: spans are timed with
        # perf_counter (monotonic, ns resolution) but anchored to an
        # absolute wall time so multiple recorders/processes can be lined up
        self.epoch_wall = time.time()
        self._epoch = time.perf_counter()

    def now(self) -> float:
        """Seconds since the recorder's epoch (span clock)."""
        return time.perf_counter() - self._epoch

    def record(self, name: str, thread_name: str, thread_id: int,
               start_s: float, duration_s: float,
               attrs: dict | None = None) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._dropped += 1
            self._spans.append(
                (name, thread_name, thread_id, start_s, duration_s, attrs))

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    @property
    def dropped(self) -> int:
        """Spans evicted by the ring bound (oldest-first)."""
        with self._lock:
            return self._dropped

    def snapshot(self) -> list[tuple]:
        """Consistent copy of the buffered spans, oldest first."""
        with self._lock:
            return list(self._spans)

    def drain(self) -> list[tuple]:
        """Pop every buffered span (oldest first), leaving the buffer
        empty.  The cross-process shipping primitive: a child drains its
        ring at rotation/seal boundaries and at exit, sends the batch to
        the parent over the ack channel, and keeps recording — the
        bounded buffer never has to hold a whole run's spans."""
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
            return out

    def to_chrome_trace(self) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON (the ``chrome://tracing``
        / https://ui.perfetto.dev object format): one complete event
        (``ph: "X"``) per span, microsecond ``ts``/``dur``, ``tid`` =
        recording thread.  Thread names ride ``thread_name`` metadata
        events so the timeline rows are labeled kpw-rg-encode /
        kpw-rg-assemble / kpw-rg-io / worker threads."""
        events = _span_events(self.snapshot(), self.pid, 0.0)
        events.append({
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "args": {"name": f"kpw pid {self.pid}"},
        })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "recorder_epoch_unix_s": self.epoch_wall,
                "spans_dropped": self.dropped,
                "span_capacity": self.capacity,
            },
        }

    def write_chrome_trace(self, path: str) -> None:
        """Serialize :meth:`to_chrome_trace` to ``path`` (open the file in
        chrome://tracing or ui.perfetto.dev)."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    def export_payload(self, process_name: str | None = None) -> dict:
        """Drain the buffer into the picklable cross-process shipping
        shape :meth:`MultiProcessTrace.absorb` takes: spans + this
        recorder's pid and wall-clock epoch (the alignment anchor)."""
        return {
            "pid": self.pid,
            "epoch_wall": self.epoch_wall,
            "process_name": process_name or f"kpw pid {self.pid}",
            "spans": self.drain(),
            "dropped": self.dropped,
        }


def _span_events(spans, pid: int, shift_s: float) -> list[dict]:
    """Span tuples -> Chrome ``trace_event`` complete events (+ one
    ``thread_name`` metadata event per thread), all stamped ``pid`` with
    start times shifted by ``shift_s`` (the epoch-alignment delta)."""
    events: list[dict] = []
    thread_names: dict[int, str] = {}
    for name, tname, tid, start_s, dur_s, attrs in spans:
        thread_names.setdefault(tid, tname)
        ev = {
            "name": name,
            "ph": "X",
            "ts": round((start_s + shift_s) * 1e6, 3),
            "dur": round(dur_s * 1e6, 3),
            "pid": pid,
            "tid": tid,
            "cat": name.split(".", 1)[0],
        }
        if attrs:
            ev["args"] = attrs
        events.append(ev)
    for tid, tname in thread_names.items():
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": tname},
        })
    return events


class MultiProcessTrace:
    """Parent-side merger: one Chrome/Perfetto timeline spanning every
    process the writer tree owns.

    The parent's own :class:`SpanRecorder` is the alignment anchor; each
    child ships ``{pid, epoch_wall, spans, ...}`` payloads
    (:meth:`SpanRecorder.export_payload`, drained over the ack side
    channel at rotation/seal boundaries and at exit).  Child span clocks
    are relative to the CHILD's epoch, so the merge shifts them by
    ``child.epoch_wall - parent.epoch_wall`` — both processes anchored
    their monotonic span clock to wall time at recorder creation, which
    is exactly the cross-process hook ``epoch_wall`` was left for.
    Per-child span storage is bounded by the parent recorder's capacity
    (oldest evicted), so a chatty child cannot grow the parent without
    bound."""

    def __init__(self, recorder: SpanRecorder) -> None:
        self._recorder = recorder
        self._lock = threading.Lock()
        # pid -> {"epoch_wall", "process_name", "spans": deque, "dropped"}
        self._children: dict[int, dict] = {}

    def absorb(self, payload: dict) -> None:
        """Merge one child payload; safe from any thread, never raises
        on a malformed payload (observability must not take down the ack
        collector)."""
        try:
            pid = int(payload["pid"])
            epoch_wall = float(payload["epoch_wall"])
            spans = payload.get("spans") or []
            with self._lock:
                entry = self._children.get(pid)
                if entry is None:
                    entry = {
                        "epoch_wall": epoch_wall,
                        "process_name": str(
                            payload.get("process_name") or f"pid {pid}"),
                        "spans": deque(maxlen=self._recorder.capacity),
                        "dropped": 0,
                    }
                    self._children[pid] = entry
                entry["dropped"] = max(entry["dropped"],
                                       int(payload.get("dropped") or 0))
                entry["spans"].extend(tuple(s) for s in spans)
        except (KeyError, TypeError, ValueError):
            logging.getLogger(__name__).warning(
                "dropping malformed child span payload", exc_info=True)

    def pids(self) -> list[int]:
        with self._lock:
            return sorted([self._recorder.pid, *self._children])

    def to_chrome_trace(self) -> dict:
        trace = self._recorder.to_chrome_trace()
        events = trace["traceEvents"]
        with self._lock:
            children = {pid: (e["epoch_wall"], e["process_name"],
                              list(e["spans"]), e["dropped"])
                        for pid, e in self._children.items()}
        child_dropped = 0
        for pid, (epoch_wall, pname, spans, dropped) in children.items():
            shift = epoch_wall - self._recorder.epoch_wall
            events.extend(_span_events(spans, pid, shift))
            events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": pname},
            })
            child_dropped += dropped
        trace["otherData"]["processes"] = self.pids()
        trace["otherData"]["child_spans_dropped"] = child_dropped
        return trace

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)


_tracer: StageTimer | None = None
_recorder: SpanRecorder | None = None


def set_tracer(tracer: StageTimer | None) -> None:
    """Install (or remove) the process-wide stage timer."""
    global _tracer
    _tracer = tracer


def get_tracer() -> StageTimer | None:
    return _tracer


def set_span_recorder(recorder: SpanRecorder | None) -> None:
    """Install (or remove) the process-wide span ring buffer.  Orthogonal
    to :func:`set_tracer`: either, both, or neither may be installed."""
    global _recorder
    _recorder = recorder


def get_span_recorder() -> SpanRecorder | None:
    return _recorder


@contextmanager
def stage(name: str, **attrs):
    """Span a pipeline stage: feeds the installed StageTimer and/or
    SpanRecorder and annotates the PyTorch profiler timeline.  A true no-op
    (just a yield) when neither is installed, so the hot path pays nothing
    by default.  ``attrs`` (row-group ordinal, file path, batch rows, ...)
    are only consumed when a SpanRecorder is installed."""
    tracer = _tracer
    recorder = _recorder
    if tracer is None and recorder is None:
        yield
        return
    import torch.profiler

    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        if tracer is not None:
            tracer.record(name, dt)
        if recorder is not None:
            t = threading.current_thread()
            recorder.record(name, t.name, t.ident or 0,
                            t0 - recorder._epoch, dt, attrs or None)
