"""The benchmark's broker: the port's ``FakeBroker``, its topic served from
the record pool.

A deployed writer fetches from Kafka, and the records it reads were stored
by another process.  ``FakeBroker`` stores every produced payload in the
writer's own process: a 45 s window of catch-up is some 6 GB of fresh
memory, copied in by the load generator's thread beside the writer's.
Here the topic cycles through the pool (offset ``o`` of partition ``p``
holds ``pool.index(p, o)``), so a produce only moves the partition's end
offset, and a fetch copies its records out of the pool's one serialized
buffer, one contiguous slice with its offset table, as
``FakeBroker.fetch_batch`` copies them out of its log.  Group membership,
assignment and commits are ``FakeBroker``'s; each accepted commit is
logged with its time on the ``time.perf_counter`` clock.
"""

from __future__ import annotations

import bisect
import threading
import time


def make(pool, topic: str):
    """A broker whose topic ``topic`` is served from ``pool``."""
    from kpw_tpu_torch import FakeBroker
    from kpw_tpu_torch.ingest.broker import RecordBatch

    class PoolBroker(FakeBroker):
        def __init__(self) -> None:
            super().__init__()
            self.commit_log = []    # (time, partition, next offset)
            self._ends = []         # records produced, per partition
            self._stamps = []       # per partition: first offsets of its produces
            self._times = []        # and their wall-clock times
            self._append_lock = threading.Lock()

        def create_topic(self, name: str, partitions: int = 1) -> None:
            super().create_topic(name, partitions)
            if name == topic:
                self._ends = [0] * partitions
                self._stamps = [[] for _ in range(partitions)]
                self._times = [[] for _ in range(partitions)]

        def append(self, partition: int, count: int) -> int:
            """Produce the next ``count`` records of ``partition``; returns
            the offset of the first."""
            with self._append_lock:
                first = self._ends[partition]
                self._stamps[partition].append(first)
                self._times[partition].append(time.time())
                self._ends[partition] = first + count
                return first

        def _stamp(self, partition: int, offset: int) -> float:
            k = bisect.bisect_right(self._stamps[partition], offset) - 1
            return self._times[partition][k]

        def fetch_batch(self, name, partition, offset, max_records=2000):
            if name != topic:
                return super().fetch_batch(name, partition, offset, max_records)
            end = self._ends[partition]
            if offset >= end:
                return None
            j, take = pool.span(partition, offset, min(max_records, end - offset))
            a, b = int(pool.offs[j]), int(pool.offs[j + take])
            offsets = pool.offs[j:j + take + 1] - a
            return RecordBatch(name, partition, offset, pool.blob[a:b], offsets,
                               self._stamp(partition, offset))

        def fetch(self, name, partition, offset, max_records=500):
            if name != topic:
                return super().fetch(name, partition, offset, max_records)
            rb = self.fetch_batch(name, partition, offset, max_records)
            return [] if rb is None else rb.to_records()

        def end_offset(self, name, partition):
            if name != topic:
                return super().end_offset(name, partition)
            return self._ends[partition]

        def commit(self, group, name, partition, offset, generation=None,
                   member_id=None):
            super().commit(group, name, partition, offset, generation=generation,
                           member_id=member_id)
            self.commit_log.append((time.perf_counter(), partition, offset))

    return PoolBroker()
