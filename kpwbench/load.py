"""The load generator: one thread that produces the pool's records into the
broker as a traffic file says.

A traffic file (``traffic/<name>.json``) picks a ``mode``:

- ``"backlog"``: the topic is kept ahead of the writer's commits by
  ``lead_records`` records in all, topped up in whole chunks of
  ``chunk_records`` a partition every ``tick_ms``, so that the writer never
  waits for input (a writer catching up after downtime or a replay).
- ``"open_loop"``: independent producers.  Batches of
  ``rate_per_s * interval_ms / 1000`` records fall due every
  ``interval_ms``, whatever the writer does; as a Kafka producer's batches
  are, each batch is for one partition, batch ``k`` for partition
  ``k % partitions``.  A batch produced late keeps its due time.

Either mode may set ``warmup_s``: the harness then starts the window no
sooner than that many seconds after the load starts, so that the backlog
the writer's start-up leaves behind drains before the window.

Partition ``p`` holds at offset ``o`` the pool record ``pool.index(p, o)``;
the broker (``broker.py``) serves it from the pool, so a produce moves only
the partition's end offset.
"""

from __future__ import annotations

import threading
import time

import numpy as np


class Load:
    def __init__(self, traffic: dict, broker, topic: str, group: str, pool) -> None:
        self.t, self.broker, self.topic, self.group = traffic, broker, topic, group
        self.pool = pool
        self.parts = pool.partitions
        self.ends = [0] * self.parts
        self.mode = traffic["mode"]
        if self.mode not in ("backlog", "open_loop"):
            raise ValueError(f"unknown traffic mode {self.mode!r}")
        if self.mode == "open_loop":
            batch = traffic["rate_per_s"] * traffic["interval_ms"] / 1000.0
            if batch != int(batch) or batch < 1:
                raise ValueError("rate_per_s * interval_ms / 1000 must be a whole number")
            self.batch = int(batch)
            self.interval = traffic["interval_ms"] / 1000.0
        self.t0 = None       # the first batch's due time (open loop)
        self.batches = 0     # batches produced (open loop)
        self.stop_at = None  # no batch due at or after this time is produced
        self.max_lag_s = 0.0
        self.cpu_s = 0.0
        self.error = None
        self._stop = threading.Event()
        self._thread = None

    # -- backlog -----------------------------------------------------------
    def _produce(self, p: int, n: int) -> None:
        got = self.broker.append(p, n)
        if got != self.ends[p]:
            raise RuntimeError(f"partition {p}: produced at {got}, expected {self.ends[p]}")
        self.ends[p] += n

    def _top_up(self) -> None:
        lead = self.t["lead_records"] // self.parts
        chunk = self.t["chunk_records"]
        for p in range(self.parts):
            while self.ends[p] - self.broker.committed(self.group, self.topic, p) < lead:
                self._produce(p, chunk)

    # -- open loop ---------------------------------------------------------
    def _batches_due(self, now: float) -> None:
        k = int((now - self.t0) / self.interval) + 1  # batches due by now
        if self.stop_at is not None:
            k = min(k, int(np.ceil((self.stop_at - self.t0) / self.interval)))
        if k > self.batches:
            self.max_lag_s = max(self.max_lag_s,
                                 now - (self.t0 + self.batches * self.interval))
        while self.batches < k:
            self._produce(self.batches % self.parts, self.batch)
            self.batches += 1

    def due(self, w0: float, w1: float):
        """The records due in [w0, w1): their partitions, offsets and due
        times (open loop only)."""
        k0 = max(0, int(np.ceil((w0 - self.t0) / self.interval)))
        k1 = min(self.batches, int(np.ceil((w1 - self.t0) / self.interval)))
        ks = np.arange(k0, max(k0, k1), dtype=np.int64)
        first = (ks // self.parts) * self.batch
        offs = (first[:, None] + np.arange(self.batch, dtype=np.int64)).ravel()
        return (np.repeat(ks % self.parts, self.batch), offs,
                np.repeat(self.t0 + ks * self.interval, self.batch))

    # -- thread ------------------------------------------------------------
    def prime(self) -> None:
        """Set-up: the backlog before the writer starts."""
        if self.mode == "backlog":
            self._top_up()

    def start(self) -> None:
        if self.mode == "open_loop":
            self.t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._loop, name="kpwbench-load",
                                        daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        c0 = time.thread_time()
        try:
            tick = self.t.get("tick_ms", 1) / 1000.0
            while not self._stop.is_set():
                now = time.perf_counter()
                if self.mode == "backlog":
                    self._top_up()
                else:
                    self._batches_due(now)
                    if self.stop_at is not None and now >= self.stop_at:
                        break
                self._stop.wait(tick if self.mode == "backlog"
                                else max(0.0, self.t0 + self.batches * self.interval
                                         - time.perf_counter()))
        except Exception as exc:  # reported by the harness, which fails the run
            self.error = repr(exc)
        finally:
            self.cpu_s = time.thread_time() - c0

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
