"""Hung-IO watchdog: detect workers whose storage stalls instead of erroring.

The retry/supervision layers (runtime/retry.py, the supervisor) only
see failures that *return* — an errno, an exception, a dead thread.  The
failure shape that dominates long-running production ingest is different:
a write into a wedged HDFS pipeline or a hung NFS mount simply never
comes back.  The worker blocks inside the IO call forever, `healthy()`
stays true (the thread is alive), ack-lag grows silently, and no retry
policy ever fires because nothing ever raised.

This module closes that blind spot with two small pieces:

* :class:`Heartbeat` — a monotonic progress publisher each worker (and
  the pipelined row-group IO thread, via ``ParquetFileWriter``) updates
  around every IO seam: ``io_started(label)`` before a potentially
  blocking call, ``io_finished()`` after, ``beat()`` from the retry
  loop's ``on_retry`` hook so a *progressing* backoff loop is never
  mistaken for a hang.  Pending ops are keyed by publishing thread, so
  one worker slot's heartbeat covers both its own thread and its open
  file's IO stage.
* :class:`Watchdog` — a supervisor-owned scanner thread that flags any
  worker whose oldest pending IO op is older than ``io_stall_deadline``:
  the stall flips ``writer.healthy()`` false, marks the
  ``parquet.writer.stalled`` meter (once per stall episode), and surfaces
  the per-worker stall age + seam label in ``writer.stats()``.  With
  ``abandon_stalled=True`` it goes further: the stuck worker is
  *condemned* — declared failed while its thread is still parked in the
  hung call — so the existing supervisor restarts the slot and
  re-injects the held (never-acked) offset runs.  Redelivery preserves
  at-least-once; if the hung call eventually returns, the zombie thread
  sees its stop event and exits without acking (duplicates allowed, loss
  impossible).  The stuck tmp file is left un-published and is swept on
  the next start.

A watchdog abandon consumes a SUPERVISOR restart, never a retry budget:
the hung call never returned, so the retry policy never saw an attempt
fail (pinned by ``test_watchdog_abandon_consumes_no_retry_budget``).
"""

from __future__ import annotations

import logging
import threading
import time

logger = logging.getLogger(__name__)


class Heartbeat:
    """Monotonic IO-progress publisher for one worker slot.

    Pending ops are keyed by the publishing thread's ident: the worker
    thread and its current file's pipelined IO thread share the slot's
    heartbeat without coordinating.  All methods are safe to call from
    any thread; the watchdog reads :meth:`stall` concurrently.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pending: dict[int, tuple[str, float]] = {}
        self.beats = 0
        self.last_progress = time.monotonic()

    def io_started(self, label: str) -> int:
        """Record a potentially-blocking IO op starting on this thread;
        returns the token :meth:`io_finished` takes (the thread ident —
        returned rather than re-derived so a finally block can't pop a
        different thread's entry after an executor hand-off)."""
        tid = threading.get_ident()
        with self._lock:
            self._pending[tid] = (label, time.monotonic())
        return tid

    def io_finished(self, token: int) -> None:
        with self._lock:
            self._pending.pop(token, None)
            self.beats += 1
            self.last_progress = time.monotonic()

    def beat(self) -> None:
        """Re-stamp this thread's pending op: the op is still failing but
        the retry loop around it is PROGRESSING (attempt returned, backoff
        chosen).  A retrying seam is a retry-policy problem, not a hang —
        the watchdog must not abandon a worker the policy is handling."""
        tid = threading.get_ident()
        with self._lock:
            entry = self._pending.get(tid)
            if entry is not None:
                self._pending[tid] = (entry[0], time.monotonic())
            self.beats += 1
            self.last_progress = time.monotonic()

    def stall(self) -> tuple[float, str | None]:
        """(age_seconds, seam_label) of the OLDEST pending IO op, or
        ``(0.0, None)`` when nothing is in flight — no pending op means
        the slot is computing or idle, which is never a hang."""
        now = time.monotonic()
        with self._lock:
            if not self._pending:
                return 0.0, None
            label, t0 = min(self._pending.values(), key=lambda e: e[1])
            return now - t0, label


class Watchdog:
    """Scanner thread over every worker slot's heartbeat.

    Owned by the writer (created at ``start()`` when
    ``Builder.watchdog(...)`` was configured, stopped at ``close()``).
    ``on_stall(index, worker, age, label)`` fires once per stall episode
    — the writer uses it to meter, log, optionally condemn the worker
    and declare a failover filesystem's primary down.
    """

    def __init__(self, workers_fn, deadline_s: float,
                 poll_interval_s: float | None = None,
                 on_stall=None) -> None:
        if deadline_s <= 0:
            raise ValueError("deadline_s must be positive")
        self.deadline_s = deadline_s
        self.poll_interval_s = (poll_interval_s if poll_interval_s is not None
                                else max(0.02, min(1.0, deadline_s / 4.0)))
        self._workers_fn = workers_fn  # () -> list of worker slots
        self._on_stall = on_stall
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # index -> {"since", "age_s", "label"} for currently-stalled slots
        self._stalled: dict[int, dict] = {}
        self.stalls_total = 0
        self._thread = threading.Thread(target=self._run,
                                        name="KPW-watchdog", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)

    def any_stalled(self) -> bool:
        with self._lock:
            return bool(self._stalled)

    def snapshot(self) -> dict:
        """stats() block: the live stalled set + episode count."""
        with self._lock:
            return {
                "deadline_s": self.deadline_s,
                "stalled_workers": [
                    {"worker": i, **dict(info)}
                    for i, info in sorted(self._stalled.items())],
                "stalls_total": self.stalls_total,
            }

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self._scan()
            except Exception:
                logger.exception("watchdog scan failed (ignored)")

    def _scan(self) -> None:
        now = time.monotonic()
        for i, w in enumerate(self._workers_fn()):
            hb = getattr(w, "heartbeat", None)
            if hb is None:
                continue
            age, label = hb.stall()
            with self._lock:
                cur = self._stalled.get(i)
                if age >= self.deadline_s:
                    new_episode = cur is None
                    self._stalled[i] = {
                        "since": (cur["since"] if cur else now - age),
                        "age_s": round(age, 3),
                        "label": label,
                    }
                    if new_episode:
                        self.stalls_total += 1
                else:
                    new_episode = False
                    if cur is not None:
                        del self._stalled[i]
            if age >= self.deadline_s and new_episode \
                    and self._on_stall is not None:
                try:
                    self._on_stall(i, w, age, label)
                except Exception:
                    logger.exception("watchdog on_stall hook failed "
                                     "(ignored)")
