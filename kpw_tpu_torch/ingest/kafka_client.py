"""Real-Kafka broker client behind the same surface as the in-process
``FakeBroker`` (SURVEY.md §7 step 3: "Real-broker client optional behind the
same interface").

``SmartCommitConsumer`` consumes the broker through seven methods —
``join_group / leave_group / generation / assignment / committed / fetch /
commit`` — so pointing the writer at a real cluster is just

    broker = KafkaBrokerClient(bootstrap_servers="host:9092")
    Builder().broker(broker)...

The adapter maps that surface onto ``kafka-python`` (the same wire client
family the reference uses from the JVM, KafkaProtoParquetWriter.java:30-32):

- group membership and rebalancing ride Kafka's own consumer-group protocol
  via one subscribed ``KafkaConsumer`` per (group, member), with auto-commit
  forced off exactly like the reference forcing ``enable.auto.commit=false``
  (KPW.java:156);
- ``KafkaConsumer`` is not thread-safe, so every touch of a member's
  consumer happens under that member's lock — the writer's fetcher thread
  (fetch) and worker threads (commit on ack) serialize here;
- ``fetch``/``commit`` route to the member that *owns* the partition (the
  assignment can be split across several members of the same client);
- the group join needs poll() calls to make progress, so ``generation()`` —
  which the smart consumer's fetch loop calls every iteration — drives a
  short poll on any member that still has no assignment.

``kafka-python`` is an optional dependency — constructing the client without
it raises ImportError with install guidance; nothing here is imported at
package import time.  No broker exists in the test image, but every branch
here (join/pump/assign/fetch/seek/pause/resume/commit/rebalance) is driven
by a scripted fake ``kafka.KafkaConsumer`` in tests/test_real_adapters.py
(see tests/fake_kafka.py); the FakeBroker-backed integration suite drives
the identical consumer surface (tests/test_ingest.py,
test_writer_integration.py).
"""

from __future__ import annotations

import threading

from .broker import Record


class _Member:
    __slots__ = ("consumer", "lock", "generation", "closed")

    def __init__(self, consumer) -> None:
        self.consumer = consumer
        self.lock = threading.Lock()
        self.generation = 0
        # set (under lock) by leave_group before consumer.close(): a closed
        # kafka-python consumer can still report its last assignment, so
        # liveness cannot be inferred from assignment() alone
        self.closed = False


class KafkaBrokerClient:
    """FakeBroker-compatible consumer surface over a real Kafka cluster."""

    def __init__(self, bootstrap_servers: str | list[str],
                 client_config: dict | None = None,
                 poll_timeout_ms: int = 100) -> None:
        try:
            import kafka  # noqa: F401
        except ImportError as e:  # pragma: no cover - exercised without dep
            raise ImportError(
                "KafkaBrokerClient needs the 'kafka-python' package "
                "(pip install kafka-python); for broker-less operation use "
                "kpw_tpu_torch.ingest.FakeBroker") from e
        self._bootstrap = bootstrap_servers
        self._config = dict(client_config or {})
        self._poll_timeout_ms = poll_timeout_ms
        self._reg_lock = threading.Lock()  # guards the member registry only
        self._members: dict[tuple[str, str], _Member] = {}
        # generation() must be MONOTONE per group: a departing member takes
        # its rebalance count out of the sum, which could cancel a
        # survivor's increment and hide the rebalance from the smart
        # consumer — fold removed members' counts (plus one for the leave
        # itself) into a per-group base
        self._gen_base: dict[str, int] = {}
        # last known (group, TopicPartition) -> owning member; a pure
        # accelerator for _owner() — every hit is re-validated against the
        # member's live assignment, so stale entries only cost a rescan
        self._owner_cache: dict[tuple, _Member] = {}

    # -- group membership --------------------------------------------------
    def join_group(self, group: str, topic: str, member_id: str) -> None:
        from kafka import ConsumerRebalanceListener, KafkaConsumer

        key = (group, member_id)
        with self._reg_lock:
            if key in self._members:
                return
            cfg = dict(self._config)
            # Smart-commit invariant: the broker-side offset only moves via
            # our explicit commit() after durable publish (KPW.java:156).
            cfg.update(enable_auto_commit=False, group_id=group,
                       auto_offset_reset="earliest",
                       key_deserializer=None, value_deserializer=None)
            consumer = KafkaConsumer(bootstrap_servers=self._bootstrap, **cfg)
            member = _Member(consumer)

            class _Listener(ConsumerRebalanceListener):
                def on_partitions_revoked(self, revoked):
                    pass

                def on_partitions_assigned(self, assigned):
                    member.generation += 1  # fires inside member's poll()

            consumer.subscribe([topic], listener=_Listener())
            self._members[key] = member

    def leave_group(self, group: str, topic: str, member_id: str) -> None:
        with self._reg_lock:
            member = self._members.pop((group, member_id), None)
            if member is not None:
                self._gen_base[group] = (self._gen_base.get(group, 0)
                                         + member.generation + 1)
                # a closed kafka-python consumer can still report its old
                # assignment, so the cache's validity check would pass and
                # route commits to a dead consumer — drop its entries now
                for key in [k for k, m in self._owner_cache.items()
                            if m is member]:
                    self._owner_cache.pop(key, None)
        if member is not None:
            with member.lock:
                member.closed = True
                member.consumer.close()

    def _group_members(self, group: str) -> list[_Member]:
        with self._reg_lock:
            return [m for (g, _), m in self._members.items() if g == group]

    def generation(self, group: str, topic: str) -> int:
        """Sum of rebalance counts — changes whenever any member's
        assignment changes.  Also pumps the group protocol: a member that
        has no assignment yet only completes its join inside poll(), and the
        smart consumer calls generation() every fetch-loop iteration."""
        with self._reg_lock:
            # base + snapshot under ONE lock round: a concurrent leave_group
            # folds the departed member's count into the base, and reading
            # them separately could transiently dip below the last reported
            # value — the exact hidden-rebalance window this base closes
            total = self._gen_base.get(group, 0)
            members = [m for (g, _), m in self._members.items() if g == group]
        for member in members:
            with member.lock:
                if not member.consumer.assignment():
                    member.consumer.poll(timeout_ms=self._poll_timeout_ms,
                                         max_records=1, update_offsets=False)
                total += member.generation
        return total

    def assignment(self, group: str, topic: str, member_id: str) -> list[int]:
        with self._reg_lock:
            member = self._members.get((group, member_id))
        if member is None:
            return []
        with member.lock:
            return sorted(tp.partition for tp in member.consumer.assignment()
                          if tp.topic == topic)

    def _owner(self, group: str, topic: str, partition: int) -> _Member | None:
        from kafka import TopicPartition

        tp = TopicPartition(topic, partition)
        # Fast path: the last known owner, validated with one O(1)
        # assignment lookup under its own lock.  commit() runs per ack round
        # — a full members scan (locking every consumer) per commit is
        # O(members) of lock traffic that this cache avoids; a rebalance
        # invalidates the entry naturally (the membership check fails).
        cached = self._owner_cache.get((group, tp))
        if cached is not None:
            try:
                with cached.lock:
                    # closed check under the SAME lock as the assignment
                    # probe: an entry fetched just before leave_group's
                    # purge would otherwise pass the assignment check
                    # against a closed consumer whose assignment() persists
                    if not cached.closed and tp in cached.consumer.assignment():
                        return cached
            # lint: swallowed-exceptions ok — probing a cached owner that
            # may be mid-close: kafka-python raises client-internal types
            # here; any failure just invalidates the cache and the full
            # member scan below re-resolves authoritatively
            except Exception:
                pass  # closed/leaving consumer: fall through to the scan
        for member in self._group_members(group):
            with member.lock:
                # same closed check as the fast path: the members snapshot
                # can include one that leave_group closed a moment later
                if not member.closed and tp in member.consumer.assignment():
                    self._owner_cache[(group, tp)] = member
                    return member
        self._owner_cache.pop((group, tp), None)
        return None

    # -- offsets -----------------------------------------------------------
    def committed(self, group: str, topic: str, partition: int) -> int:
        from kafka import TopicPartition
        from kafka.structs import OffsetAndMetadata

        members = self._group_members(group)
        if not members:
            return 0
        member = self._owner(group, topic, partition) or members[0]
        with member.lock:
            got = member.consumer.committed(TopicPartition(topic, partition))
        if isinstance(got, OffsetAndMetadata):
            got = got.offset
        return int(got or 0)

    def commit(self, group: str, topic: str, partition: int, offset: int,
               generation: int | None = None,
               member_id: str | None = None) -> None:
        """Commit via the partition's owning member.  During a rebalance the
        ownership snapshot can go stale between resolve and commit — the
        broker then rejects the commit (CommitFailedError).  That window is
        retriable, not fatal: re-resolve the owner and try again for a
        bounded number of rounds before surfacing (a raise here would kill
        the worker mid-rebalance for a transient condition).

        ``generation``/``member_id`` are accepted for FakeBroker signature
        parity but unused: a real cluster runs Kafka's own generation
        fencing — a zombie's commit is rejected broker-side as
        CommitFailedError by the group coordinator itself."""
        import time as _time

        from kafka import TopicPartition
        from kafka.errors import CommitFailedError
        from kafka.structs import OffsetAndMetadata

        last_err: Exception | None = None
        for attempt in range(8):
            member = self._owner(group, topic, partition)
            if member is None:
                members = self._group_members(group)
                if not members:
                    raise RuntimeError(f"no consumer joined for group {group}")
                member = members[0]
            try:
                with member.lock:
                    # lint: lock-discipline ok — kafka-python KafkaConsumer
                    # is not thread-safe; member.lock IS the serialization
                    # of every call into it, so the (network-blocking)
                    # commit must run under it by the client's contract
                    member.consumer.commit({TopicPartition(topic, partition):
                                            OffsetAndMetadata(offset, None, -1)})
                return
            except CommitFailedError as e:  # the rebalance window; anything
                last_err = e                # else is not retriable here
                # let the group protocol make progress before re-resolving
                _time.sleep(0.05 * (attempt + 1))
        raise RuntimeError(
            f"commit of {topic}/{partition}@{offset} kept failing across "
            "rebalance retries") from last_err

    # -- records -----------------------------------------------------------
    def fetch(self, topic: str, partition: int, offset: int,
              max_records: int) -> list[Record]:
        from kafka import TopicPartition

        # group is not part of the FakeBroker fetch signature; all members
        # of this client share the data path, so route by ownership across
        # every registered member.
        with self._reg_lock:
            members = list(self._members.values())
        tp = TopicPartition(topic, partition)
        for member in members:
            with member.lock:
                consumer = member.consumer
                if tp not in consumer.assignment():
                    continue
                if consumer.position(tp) != offset:
                    consumer.seek(tp, offset)
                # Steady state keeps every partition except the fetch target
                # paused, issuing pause/resume only for the DELTA vs the
                # consumer's current pause set — consecutive fetches of the
                # same partition cost zero calls, round-robining costs two,
                # versus 2*(n-1) for pause-all/resume-all per fetch.  A
                # rebalance self-heals: revoked partitions drop out of
                # paused(), newly assigned ones arrive unpaused and land in
                # want_paused on the next call.
                assigned = set(consumer.assignment())
                cur_paused = set(consumer.paused())
                want_paused = assigned - {tp}
                to_pause = want_paused - cur_paused
                if to_pause:
                    consumer.pause(*to_pause)
                to_resume = cur_paused - want_paused
                if to_resume:
                    consumer.resume(*to_resume)
                batch = consumer.poll(timeout_ms=self._poll_timeout_ms,
                                      max_records=max_records)
                return [Record(topic=topic, partition=partition,
                               offset=r.offset, key=r.key, value=r.value,
                               timestamp=r.timestamp / 1000.0)
                        for r in batch.get(tp, [])]
        return []
