"""In-process broker: partitioned append logs + consumer groups + committed
offsets.

Test-infra analog of the reference's embedded ``KafkaRule`` broker
(KafkaProtoParquetWriterTest.java:58-59) promoted to a first-class component:
the framework's default record source in tests and benchmarks, and the
interface a real Kafka wire client can implement later.  Scale-out data
parallelism (multiple writer instances sharing a consumer group —
KafkaProtoParquetWriter.java:72-76) is modeled with range partition
assignment and rebalance-on-membership-change.

Storage is batch-native: each partition log is ONE contiguous payload
buffer plus a record-offset table (record i = ``buf[offs[i]:offs[i+1]]``),
guarded by its own lock — the wire-page layout a real broker hands a fetch
response in.  ``fetch_batch`` returns that layout directly as a
:class:`RecordBatch` (one buffer copy per batch, no per-record objects);
``fetch`` is the compatibility surface that materializes one frozen
:class:`Record` dataclass per payload, the per-record cost the batch path
exists to avoid.  Group membership / committed offsets stay under one
metadata lock; produce/fetch never contend across partitions.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

from ..utils import schedcheck


class StaleGenerationError(RuntimeError):
    """A commit was rejected by the group-coordination fence: it came from
    a member that no longer owns the partition (expired, superseded, or
    carrying a generation the coordinator never issued).  The committer is
    a zombie — paused or partitioned through a rebalance while another
    instance took over.  Typed, and deliberately NOT an OSError: the IO
    retry loop must not spin on it — the only correct reaction is to drop
    the in-flight state and rejoin the group."""


@dataclass(frozen=True)
class Record:
    topic: str
    partition: int
    offset: int
    key: bytes | None
    value: bytes
    timestamp: float = 0.0


class RecordBatch:
    """Batch-native ingest handoff: ``count`` serialized payloads in one
    contiguous immutable buffer plus an int64 offset table (record i =
    ``payload[offsets[i]:offsets[i+1]]``; ``offsets[0]`` may be nonzero —
    a :meth:`slice` shares the parent's buffer) and the
    ``(partition, start_offset, count)`` run metadata the run-native ack
    machinery (``poll_many_runs``/``ack_run``) consumes directly.

    Offsets within a batch are contiguous BY CONTRACT (``start_offset + i``
    is record i's offset): a source with offset gaps (a compacted real
    topic) must deliver per-record ``Record`` lists instead — the batch
    run shortcut would otherwise ack offsets that were never delivered.
    Record keys do not ride the batch path (the writer never reads them);
    :meth:`to_records` materializes keyless Records for the per-record
    compatibility route.
    """

    __slots__ = ("topic", "partition", "start_offset", "payload", "offsets",
                 "timestamp")

    def __init__(self, topic: str, partition: int, start_offset: int,
                 payload: bytes, offsets: np.ndarray,
                 timestamp: float = 0.0) -> None:
        self.topic = topic
        self.partition = partition
        self.start_offset = start_offset
        self.payload = payload
        self.offsets = offsets  # int64, len == count + 1, ascending
        self.timestamp = timestamp

    def __len__(self) -> int:
        return len(self.offsets) - 1

    @property
    def run(self) -> tuple[int, int, int]:
        """The batch as one contiguous (partition, start_offset, count)
        ack run."""
        return (self.partition, self.start_offset, len(self))

    def payload_at(self, i: int) -> bytes:
        o = self.offsets
        return self.payload[int(o[i]): int(o[i + 1])]

    def slice(self, start: int, count: int) -> "RecordBatch":
        """Zero-copy window [start, start+count): shares the payload
        buffer, the offset table is a numpy view."""
        return RecordBatch(self.topic, self.partition,
                           self.start_offset + start, self.payload,
                           self.offsets[start: start + count + 1],
                           self.timestamp)

    def to_records(self) -> list[Record]:
        """Materialize per-record frozen ``Record`` dataclasses — the
        compatibility/fallback route (poison-pill reparse, dead-letter)."""
        o, pl = self.offsets, self.payload
        t, p, base, ts = (self.topic, self.partition, self.start_offset,
                          self.timestamp)
        return [Record(t, p, base + i, None, pl[int(o[i]): int(o[i + 1])], ts)
                for i in range(len(o) - 1)]


class _PartitionLog:
    """One partition's contiguous append log, under its own lock.  The
    offset table is a growable int64 numpy array (``offs[0..n]`` valid)
    so a fetch slices it in C instead of converting a Python list per
    batch."""

    __slots__ = ("lock", "buf", "offs", "n", "keys", "ts")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.buf = bytearray()
        self.offs = np.zeros(64, np.int64)  # byte offsets; offs[0..n] valid
        self.n = 0  # record count
        self.keys: dict[int, bytes] = {}  # record offset -> key (sparse)
        self.ts: list[float] = []

    def _ensure(self, extra: int) -> None:
        need = self.n + 1 + extra
        if need > len(self.offs):
            new = np.empty(max(need, 2 * len(self.offs)), np.int64)
            new[: self.n + 1] = self.offs[: self.n + 1]
            self.offs = new

    def append_one(self, value: bytes, key, now: float) -> int:
        with self.lock:
            self._ensure(1)
            off = self.n
            self.buf += value
            self.offs[off + 1] = self.offs[off] + len(value)
            self.n = off + 1
            self.ts.append(now)
            if key is not None:
                self.keys[off] = key
            return off

    def append_many(self, values, now: float) -> tuple[int, int]:
        """One lock round for the whole batch; returns (first_offset, n)."""
        if not values:
            return self.n, 0
        lens = np.fromiter(map(len, values), np.int64, count=len(values))
        blob = b"".join(values)
        with self.lock:
            first = self.n
            self._ensure(len(values))
            self.buf += blob
            base = self.offs[first]
            np.cumsum(lens, out=self.offs[first + 1: first + 1 + len(values)])
            self.offs[first + 1: first + 1 + len(values)] += base
            self.n = first + len(values)
            self.ts.extend([now] * len(values))
            return first, len(values)


class FakeBroker:
    """Thread-safe in-memory broker (sharded per-partition log locks).

    With ``session_timeout_s`` set the broker runs the full group
    coordination protocol: members heartbeat to stay live, a
    missed session window expels them, every membership change bumps the
    group **generation**, partitions moving between two live members pass
    through a cooperative **drain window** (withheld from the new owner
    until the old owner confirms revocation or ``revocation_drain_s``
    lapses), and commits carrying a member identity are **fenced** — a
    zombie's stale commit raises :class:`StaleGenerationError` instead of
    clobbering the new owner's offset state.  ``session_timeout_s=None``
    (the default) keeps the legacy instant-reassignment broker: no expiry,
    no drain windows, unfenced commits.
    """

    def __init__(self, session_timeout_s: float | None = None,
                 revocation_drain_s: float = 5.0) -> None:
        # metadata lock: topic map shape, consumer groups, committed
        # offsets, the round-robin cursor.  Payload appends/reads take only
        # the owning partition's log lock.
        self._lock = threading.RLock()
        self._logs: dict[str, list[_PartitionLog]] = {}
        self._committed: dict[tuple[str, str, int], int] = {}  # (group, topic, part) -> next offset
        self._groups: dict[tuple[str, str], list[str]] = {}  # (group, topic) -> member ids
        self._generation: dict[tuple[str, str], int] = {}
        self._rr = 0
        # group coordination: heartbeat stamps (monotonic — liveness
        # bookkeeping must not expire members on a wall-clock step),
        # in-drain partitions awaiting cooperative handoff
        # (partition -> {owner, deadline, old_gen}), and the per-group
        # protocol counters group_stats() reports.
        self.session_timeout_s = session_timeout_s
        self.revocation_drain_s = revocation_drain_s
        self._hb: dict[tuple[str, str], dict[str, float]] = {}
        self._revoking: dict[tuple[str, str], dict[int, dict]] = {}
        self._fenced: dict[tuple[str, str], int] = {}
        self._rebalances: dict[tuple[str, str], int] = {}
        self._expired: dict[tuple[str, str], int] = {}

    # -- topics / produce --------------------------------------------------
    def create_topic(self, topic: str, partitions: int = 1) -> None:
        with self._lock:
            if topic in self._logs:
                raise ValueError(f"topic exists: {topic}")
            self._logs[topic] = [_PartitionLog() for _ in range(partitions)]

    def num_partitions(self, topic: str) -> int:
        with self._lock:
            return len(self._logs[topic])

    def _route(self, topic: str, key: bytes | None, partition: int | None,
               advance_rr: int = 1) -> tuple[list[_PartitionLog], int, int]:
        """Resolve (logs, partition, rr_base) under the metadata lock;
        auto-creates a 1-partition topic on first produce."""
        with self._lock:
            if topic not in self._logs:
                self._logs[topic] = [_PartitionLog()]
            parts = self._logs[topic]
            rr_base = self._rr
            if partition is None:
                if key is not None:
                    partition = hash(key) % len(parts)
                else:
                    partition = self._rr % len(parts)
                    self._rr += advance_rr
            return parts, partition, rr_base

    def produce(self, topic: str, value: bytes, key: bytes | None = None,
                partition: int | None = None) -> tuple[int, int]:
        parts, partition, _ = self._route(topic, key, partition)
        return partition, parts[partition].append_one(value, key, time.time())

    def produce_many(self, topic: str, values,
                     partition: int | None = None) -> dict[int, tuple[int, int]]:
        """Append a whole batch of payloads with ONE lock round per
        partition touched (vs one per record via :meth:`produce`) — the
        topic-priming fast path for benchmarks and chaos tests.

        ``partition=None`` stripes round-robin exactly like a
        ``produce()`` loop would (value i lands on partition
        ``(rr + i) % n``), so indexed-identity checks built on the loop's
        placement hold unchanged.  Returns ``{partition: (first_offset,
        count)}``."""
        values = list(values)
        if not values:
            return {}
        parts, part0, rr_base = self._route(topic, None, partition,
                                            advance_rr=len(values))
        now = time.time()
        if partition is not None or len(parts) == 1:
            first, n = parts[part0].append_many(values, now)
            return {part0: (first, n)}
        out: dict[int, tuple[int, int]] = {}
        nparts = len(parts)
        for i in range(nparts):
            p = (rr_base + i) % nparts
            sub = values[i::nparts]
            if sub:
                out[p] = parts[p].append_many(sub, now)
        return out

    # -- fetch -------------------------------------------------------------
    def fetch(self, topic: str, partition: int, offset: int,
              max_records: int = 500) -> list[Record]:
        """Per-record compatibility fetch: materializes one frozen
        ``Record`` per payload (the cost :meth:`fetch_batch` avoids)."""
        with self._lock:
            parts = self._logs.get(topic)
            if parts is None or partition >= len(parts):
                return []
            log = parts[partition]
        with log.lock:
            if offset >= log.n:
                return []
            j = min(offset + max_records, log.n)
            mv = memoryview(log.buf)
            offs = log.offs
            keys, ts = log.keys, log.ts
            return [Record(topic, partition, i, keys.get(i),
                           bytes(mv[offs[i]: offs[i + 1]]), ts[i])
                    for i in range(offset, j)]

    def fetch_batch(self, topic: str, partition: int, offset: int,
                    max_records: int = 2000) -> RecordBatch | None:
        """Batch-native fetch: up to ``max_records`` payloads as ONE
        contiguous buffer + offset table (a single copy out of the log
        page, no per-record object construction).  Returns None when
        nothing is available at ``offset``."""
        with self._lock:
            parts = self._logs.get(topic)
            if parts is None or partition >= len(parts):
                return None
            log = parts[partition]
        with log.lock:
            if offset >= log.n:
                return None
            j = min(offset + max_records, log.n)
            a = int(log.offs[offset])
            payload = bytes(memoryview(log.buf)[a: int(log.offs[j])])
            offsets = log.offs[offset: j + 1].copy()  # C slice copy
            ts = log.ts[offset]
        if a:
            offsets -= a
        return RecordBatch(topic, partition, offset, payload, offsets, ts)

    def end_offset(self, topic: str, partition: int) -> int:
        with self._lock:
            log = self._logs[topic][partition]
        with log.lock:
            return log.n

    # -- consumer groups ---------------------------------------------------
    @staticmethod
    def _range_map(members: list[str], n_parts: int) -> dict[int, str]:
        """partition -> owner under range assignment (``members`` already
        sorted) — the single source of truth :meth:`assignment` and the
        commit fence share."""
        out: dict[int, str] = {}
        if not members:
            return out
        per = n_parts // len(members)
        extra = n_parts % len(members)
        for idx, m in enumerate(members):
            start = idx * per + min(idx, extra)
            count = per + (1 if idx < extra else 0)
            for p in range(start, start + count):
                out[p] = m
        return out

    def _owner_map(self, key: tuple[str, str]) -> dict[int, str]:
        group, topic = key
        if topic not in self._logs:
            return {}
        return self._range_map(sorted(self._groups.get(key, [])),
                               len(self._logs[topic]))

    def _membership_changed(self, key: tuple[str, str],
                            old_members: list[str]) -> None:
        """Caller holds the lock; membership already mutated.  Bump the
        generation and diff the old/new range maps: a partition moving
        between two LIVE members enters a cooperative drain window
        (coordination-enabled brokers only); every other movement hands
        off instantly."""
        group, topic = key
        self._generation[key] = self._generation.get(key, 0) + 1
        self._rebalances[key] = self._rebalances.get(key, 0) + 1
        live = self._groups.get(key, [])
        if topic not in self._logs:
            return  # no partitions yet: nothing can move
        n_parts = len(self._logs[topic])
        old_map = self._range_map(sorted(old_members), n_parts)
        new_map = self._range_map(sorted(live), n_parts)
        rev = self._revoking.setdefault(key, {})
        coop = self.session_timeout_s is not None
        now = time.monotonic()
        for p, owner in new_map.items():
            prev = old_map.get(p)
            if prev == owner:
                continue
            if coop and prev is not None and prev in live and p not in rev:
                # cooperative handoff: withhold the partition from the new
                # owner until the old owner confirms its drain (or the
                # window lapses)
                rev[p] = {"owner": prev,
                          "deadline": now + self.revocation_drain_s,
                          "old_gen": self._generation[key] - 1}
            else:
                schedcheck.note_partition_owner(id(self), key + (p,), owner)
        # drain entries whose recorded owner died, or whose current target
        # IS the recorded owner again (membership flapped back), resolve
        # instantly — nobody is left to confirm them
        stale = [p for p, e in rev.items()
                 if e["owner"] not in live or new_map.get(p) == e["owner"]]
        for p in stale:
            del rev[p]
            owner = new_map.get(p)
            if owner is not None:
                schedcheck.note_partition_owner(id(self), key + (p,), owner)

    def _complete_handoffs(self, key: tuple[str, str],
                           parts: list[int]) -> None:
        """Caller holds the lock.  Pop drain entries and make the handoff
        visible: ONE generation bump (when anything completed) so the new
        owners' next refresh picks the partitions up."""
        rev = self._revoking.get(key)
        if not rev:
            return
        done = [p for p in parts if p in rev]
        if not done:
            return
        for p in done:
            del rev[p]
        self._generation[key] = self._generation.get(key, 0) + 1
        new_map = self._owner_map(key)
        for p in done:
            owner = new_map.get(p)
            if owner is not None:
                schedcheck.note_partition_owner(id(self), key + (p,), owner)

    def _sweep_locked(self, key: tuple[str, str]) -> None:
        """Caller holds the lock: expel members that missed their session
        window, then complete drain windows whose deadline lapsed."""
        st = self.session_timeout_s
        now = time.monotonic()
        if st is not None:
            hb = self._hb.get(key, {})
            members = self._groups.get(key, [])
            dead = [m for m in members if now - hb.get(m, now) > st]
            if dead:
                old = list(members)
                for m in dead:
                    members.remove(m)
                    hb.pop(m, None)
                self._expired[key] = self._expired.get(key, 0) + len(dead)
                self._membership_changed(key, old)
        rev = self._revoking.get(key)
        if rev:
            lapsed = [p for p, e in rev.items() if now >= e["deadline"]]
            if lapsed:
                self._complete_handoffs(key, lapsed)

    def join_group(self, group: str, topic: str, member_id: str) -> None:
        with self._lock:
            key = (group, topic)
            members = self._groups.setdefault(key, [])
            self._hb.setdefault(key, {})[member_id] = time.monotonic()
            if member_id not in members:
                old = list(members)
                members.append(member_id)
                self._membership_changed(key, old)

    def leave_group(self, group: str, topic: str, member_id: str) -> None:
        with self._lock:
            key = (group, topic)
            members = self._groups.get(key, [])
            if member_id in members:
                old = list(members)
                members.remove(member_id)
                self._hb.get(key, {}).pop(member_id, None)
                self._membership_changed(key, old)

    def heartbeat(self, group: str, topic: str, member_id: str) -> dict:
        """Stamp the member's liveness and run the expiry/drain sweep.
        Returns the current generation plus ``rejoin=True`` when the
        member missed its session window and was expelled — its only way
        back in is :meth:`join_group` (a fresh assignment epoch)."""
        with self._lock:
            key = (group, topic)
            if member_id in self._groups.get(key, []):
                self._hb.setdefault(key, {})[member_id] = time.monotonic()
            self._sweep_locked(key)
            return {"generation": self._generation.get(key, 0),
                    "rejoin": member_id not in self._groups.get(key, [])}

    def generation(self, group: str, topic: str) -> int:
        with self._lock:
            self._sweep_locked((group, topic))
            return self._generation.get((group, topic), 0)

    def assignment(self, group: str, topic: str, member_id: str) -> list[int]:
        """Range assignment over the current membership (sorted member
        ids).  Partitions inside a cooperative drain window are withheld
        — the new owner sees them only after the old owner confirms (or
        the window lapses)."""
        with self._lock:
            key = (group, topic)
            self._sweep_locked(key)
            members = sorted(self._groups.get(key, []))
            if member_id not in members or topic not in self._logs:
                return []  # unknown topic: no partitions until first produce
            n_parts = len(self._logs[topic])
            idx = members.index(member_id)
            per = n_parts // len(members)
            extra = n_parts % len(members)
            start = idx * per + min(idx, extra)
            count = per + (1 if idx < extra else 0)
            rev = self._revoking.get(key, {})
            return [p for p in range(start, start + count) if p not in rev]

    def confirm_revocation(self, group: str, topic: str, member_id: str,
                           partitions) -> None:
        """The old owner finished draining ``partitions``: complete their
        handoff now instead of waiting out the drain window."""
        with self._lock:
            key = (group, topic)
            rev = self._revoking.get(key, {})
            mine = [p for p in partitions
                    if p in rev and rev[p]["owner"] == member_id]
            if mine:
                self._complete_handoffs(key, mine)

    def group_stats(self, group: str, topic: str) -> dict:
        """Protocol observability for tests/bench: membership, generation,
        and the rebalance/fence/expiry counters."""
        with self._lock:
            key = (group, topic)
            self._sweep_locked(key)
            return {
                "members": sorted(self._groups.get(key, [])),
                "generation": self._generation.get(key, 0),
                "rebalances": self._rebalances.get(key, 0),
                "fenced_commits": self._fenced.get(key, 0),
                "expired_members": self._expired.get(key, 0),
                "revoking": sorted(self._revoking.get(key, {})),
            }

    # -- offsets -----------------------------------------------------------
    def _commit_allowed_locked(self, key: tuple[str, str], partition: int,
                               generation: int, member_id: str) -> bool:
        """Caller holds the lock: the fence predicate.  Accept the old
        owner through its drain window; otherwise ownership under the
        CURRENT range map is authoritative (strict generation equality
        would spuriously fence live owners of retained partitions across
        handoff-completion bumps)."""
        rev = self._revoking.get(key, {})
        e = rev.get(partition)
        if e is not None and e["owner"] == member_id:
            return True  # drain window: the old owner flushing in-flight
        if generation > self._generation.get(key, 0):
            return False  # a generation the coordinator never issued
        owners = self._owner_map(key)
        if owners:
            return owners.get(partition) == member_id
        # topic unknown (commit before first produce): membership is the
        # best fence available
        return member_id in self._groups.get(key, [])

    def commit(self, group: str, topic: str, partition: int, offset: int,
               generation: int | None = None,
               member_id: str | None = None) -> None:
        """offset = next offset to consume (Kafka convention).

        When the committer identifies itself (``generation`` +
        ``member_id``, the coordinated path), the commit is FENCED: it
        must come from the partition's current owner — or, during a
        cooperative drain window, from the old owner finishing its
        in-flight files.  A zombie (expired or superseded member) gets
        the typed :class:`StaleGenerationError` instead of silently
        clobbering the new owner's offset state."""
        # deliberately outside the metadata lock: a schedule-explorer
        # delay here must let the rebalance/handoff parties run, not
        # block them behind a held lock
        schedcheck.point("broker.commit.fence")
        with self._lock:
            key = (group, topic)
            self._sweep_locked(key)
            if generation is not None and member_id is not None:
                if not self._commit_allowed_locked(key, partition,
                                                  generation, member_id):
                    self._fenced[key] = self._fenced.get(key, 0) + 1
                    raise StaleGenerationError(
                        f"fenced commit: member {member_id!r} gen "
                        f"{generation} is not the owner of "
                        f"{topic}[{partition}] (current gen "
                        f"{self._generation.get(key, 0)})")
                schedcheck.note_commit_accepted(id(self), key + (partition,),
                                                member_id)
            ckey = (group, topic, partition)
            if offset > self._committed.get(ckey, 0):
                self._committed[ckey] = offset

    def commit_allowed(self, group: str, topic: str, partition: int,
                       generation: int | None = None,
                       member_id: str | None = None) -> bool:
        """The commit fence as a side-effect-free predicate: would a
        commit from this member at this generation be accepted right
        now?  The writer consults it before PUBLISHING a file whose
        runs it may no longer be allowed to ack."""
        with self._lock:
            key = (group, topic)
            self._sweep_locked(key)
            if generation is None or member_id is None:
                return True
            return self._commit_allowed_locked(key, partition, generation,
                                               member_id)

    def committed(self, group: str, topic: str, partition: int) -> int:
        with self._lock:
            return self._committed.get((group, topic, partition), 0)
