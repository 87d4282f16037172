"""Backpressure autotuning: ingest knobs derived from measured stage rates.

The fixed constants the reference exposes (``fetch_max_records=2000``,
``maxQueuedRecordsInConsumer=100_000`` — KafkaProtoParquetWriter.java:468)
encode one assumed throughput.  This module generalizes the worker loop's
EWMA carry-estimate pattern (the live bytes/record rotation estimate in
``runtime/writer.py``) to the whole ingest leg: measure how fast records
actually move through each stage, then size the knobs as *time horizons*
of those rates —

* **fetch batch** — ``fetch_horizon_s`` of the queue's drain rate: big
  enough to amortize a broker round-trip + one tracker round over
  thousands of records, small enough that one fetch never represents more
  than a few tens of milliseconds of redeliverable work.
* **queue depth** — ``queue_horizon_s`` of the drain rate: deep enough to
  ride out a publish stall without starving the workers, shallow enough
  to bound memory and crash redelivery.  The configured
  ``max_queued_records`` stays a HARD ceiling (the reference's
  BlockingQueue capacity semantics): autotuning only ever shrinks below
  it, never overshoots it.
* **poll batch** (worker side) — ``poll_horizon_s`` of that worker's own
  measured shred+append rate, still clipped by the rotation-overshoot cap
  (``_rotation_batch_cap``) that bounds file-size error.

Tuned values are surfaced via :meth:`IngestAutotuner.snapshot` into
``SmartCommitConsumer.stats()`` / ``writer.stats()`` so a reader can see
what the system chose and from which measured rates.
"""

from __future__ import annotations


def _clamp(v: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, v))


class IngestAutotuner:
    """EWMA rate observer feeding the tuned ingest knobs.

    Owned by the writer, ticked by the consumer's fetcher thread
    (:meth:`observe` with the queue's cumulative in/out counters), read by
    the fetcher (``fetch_max``, ``queue_cap``) and by workers
    (:meth:`poll_batch` with their own processing rate).  Single-writer
    per field; readers tolerate a stale int (they re-read every loop).
    """

    def __init__(self, fetch_max0: int, queue_max0: int, *,
                 interval_s: float = 0.25, alpha: float = 0.3,
                 fetch_horizon_s: float = 0.05,
                 queue_horizon_s: float = 0.5,
                 poll_horizon_s: float = 0.05,
                 min_fetch: int = 256, max_fetch: int = 65536,
                 min_queue: int = 4096) -> None:
        self.fetch_max = fetch_max0          # live tuned values (start at
        self.queue_cap = queue_max0          # the configured constants)
        self._fetch_max0 = fetch_max0
        self._queue_max0 = queue_max0        # hard ceiling, never exceeded
        self.interval_s = interval_s
        self.alpha = alpha
        self.fetch_horizon_s = fetch_horizon_s
        self.queue_horizon_s = queue_horizon_s
        self.poll_horizon_s = poll_horizon_s
        self.min_fetch = min_fetch
        self.max_fetch = max_fetch
        self.min_queue = min(min_queue, queue_max0)
        self._fetch_rate = 0.0  # rec/s INTO the queue (EWMA)
        self._drain_rate = 0.0  # rec/s OUT of the queue (EWMA)
        self._last: tuple[float, int, int] | None = None
        self._retunes = 0

    def observe(self, now: float, records_in: int, records_out: int) -> None:
        """Fold one (time, cumulative in, cumulative out) sample; recomputes
        the knobs at most once per ``interval_s``."""
        if self._last is None:
            self._last = (now, records_in, records_out)
            return
        t0, in0, out0 = self._last
        dt = now - t0
        if dt < self.interval_s:
            return
        self._last = (now, records_in, records_out)
        a = self.alpha
        self._fetch_rate += a * ((records_in - in0) / dt - self._fetch_rate)
        self._drain_rate += a * ((records_out - out0) / dt - self._drain_rate)
        if self._drain_rate <= 0:
            return  # nothing drained yet: keep the configured seeds
        self.fetch_max = _clamp(int(self._drain_rate * self.fetch_horizon_s),
                                self.min_fetch, self.max_fetch)
        self.queue_cap = _clamp(int(self._drain_rate * self.queue_horizon_s),
                                self.min_queue, self._queue_max0)
        self._retunes += 1

    def poll_batch(self, proc_rate: float, floor: int = 64) -> int:
        """Worker-side poll batch: ``poll_horizon_s`` of the worker's own
        measured processing rate (caller still clips by the rotation
        cap)."""
        if proc_rate <= 0:
            return max(floor, self._fetch_max0)
        return _clamp(int(proc_rate * self.poll_horizon_s), floor,
                      self.max_fetch)

    def snapshot(self) -> dict:
        return {
            "enabled": True,
            "fetch_max_records": self.fetch_max,
            "max_queued_records": self.queue_cap,
            "configured_fetch_max_records": self._fetch_max0,
            "configured_max_queued_records": self._queue_max0,
            "fetch_rate_rps": round(self._fetch_rate, 1),
            "drain_rate_rps": round(self._drain_rate, 1),
            "retunes": self._retunes,
            "horizons_s": {"fetch": self.fetch_horizon_s,
                           "queue": self.queue_horizon_s,
                           "poll": self.poll_horizon_s},
        }
