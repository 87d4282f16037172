"""Broker-seam fault injection: the ingest counterpart of
:class:`kpw_tpu_torch.io.faults.FaultInjectingFileSystem`.

Wraps any broker (FakeBroker or a real client behind the same surface) and
consults a shared :class:`~kpw_tpu_torch.io.faults.FaultSchedule` on the two IO
paths the smart-commit consumer drives — ``fetch`` (the fetcher thread's
poll) and ``commit`` (the post-publish ack) — plus a scheduled ``rebalance``
event that revokes every partition mid-batch the way a real group rebalance
does: the generation number jumps, the consumer re-resolves its assignment
and rewinds each partition to the committed frontier, and everything
delivered-but-unacked is redelivered (at-least-once allows the duplicates).

Opt-in at the Builder seam only: a writer built without the wrapper never
consults a schedule, so the disabled hot-path cost is zero.
"""

from __future__ import annotations

from ..io.faults import FaultSchedule


class FaultInjectingBroker:
    """Delegating broker wrapper with schedule-driven fetch/commit faults
    and forced rebalances.

    ``rebalance_on_fetch`` lists fetch-call ordinals at which the
    generation bumps (partition revocation mid-batch); each firing is
    recorded into the shared schedule's fault log so the chaos artifact
    carries one merged timeline.
    """

    def __init__(self, inner, schedule: FaultSchedule,
                 rebalance_on_fetch: tuple = ()) -> None:
        import threading

        self.inner = inner
        self.schedule = schedule
        self._gen_extra = 0
        self._rebalance_at = set(rebalance_on_fetch)
        self._fetch_n = 0
        self._lock = threading.Lock()
        if not callable(getattr(inner, "fetch_batch", None)):
            # shadow the class method so feature detection
            # (callable(getattr(broker, "fetch_batch", None))) sees exactly
            # what the inner broker offers
            self.fetch_batch = None

    # -- faulted surface -----------------------------------------------------
    def _fetch_gate(self) -> None:
        """Shared ordinal counting + rebalance/fault firing for both fetch
        shapes: the schedule sees ONE stream of fetch ops, so an ordinal
        fires regardless of which path the consumer rides."""
        with self._lock:
            self._fetch_n += 1
            n = self._fetch_n
        if n in self._rebalance_at:
            self._gen_extra += 1
            self.schedule.note("rebalance", n)
        self.schedule.check("fetch")

    def fetch(self, topic: str, partition: int, offset: int,
              max_records: int = 500):
        self._fetch_gate()
        return self.inner.fetch(topic, partition, offset, max_records)

    def fetch_batch(self, topic: str, partition: int, offset: int,
                    max_records: int = 2000):
        """Batch-native fetch rides the same fault gate as :meth:`fetch`
        (instances wrapping a broker without ``fetch_batch`` shadow this
        method with None in ``__init__`` so feature detection matches the
        inner broker)."""
        self._fetch_gate()
        return self.inner.fetch_batch(topic, partition, offset, max_records)

    def commit(self, group: str, topic: str, partition: int, offset: int,
               generation: int | None = None,
               member_id: str | None = None) -> None:
        self.schedule.check("commit")
        if generation is not None or member_id is not None:
            self.inner.commit(group, topic, partition, offset,
                              generation=generation, member_id=member_id)
        else:
            self.inner.commit(group, topic, partition, offset)

    def generation(self, group: str, topic: str) -> int:
        return self.inner.generation(group, topic) + self._gen_extra

    def force_rebalance(self) -> None:
        """Bump the generation so every consumer in the group re-resolves
        its assignment and rewinds to the committed frontier — partition
        revocation mid-batch without changing membership."""
        self._gen_extra += 1

    # -- passthrough ---------------------------------------------------------
    def __getattr__(self, name):
        return getattr(self.inner, name)
