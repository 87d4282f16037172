"""Deterministic fault injection for the write path.

The at-least-once contract (tmp→rename publish, ack strictly after rename —
KafkaProtoParquetWriter.java:38-62) is only worth anything if it holds while
the filesystem misbehaves.  This module makes misbehavior *reproducible*:
:class:`FaultSchedule` is a seeded, schedule-driven plan of which operation
ordinals fail (or stall), and :class:`FaultInjectingFileSystem` is a wrapper
over any :class:`~kpw_tpu_torch.io.fs.FileSystem` that consults the plan on every
IO call.  Injection is strictly opt-in at the seam where a filesystem (or
broker) is handed to the Builder: unless a wrapper is installed there,
no write-path code ever consults a schedule, so the disabled hot-path
cost is zero (the module itself is exported from the package for
discoverability, but constructing a writer never touches it).

Operation names checked by the filesystem wrapper:

``open`` (open_write/open_append/open_read), ``write`` (write/writelines),
``flush``, ``close``, ``rename``, ``sync`` (sync/sync_dir — the legs of a
durable publish), ``delete``, ``mkdirs``, ``list``.

The broker-side counterpart (``fetch`` / ``commit`` / forced ``rebalance``)
lives in :mod:`kpw_tpu_torch.ingest.faults` and shares the same schedule object,
so one seed drives the whole chaos run.

The OBJECT-STORE persona (``io/objectstore.py``): an
:class:`~kpw_tpu_torch.io.objectstore.EmulatedObjectStore` constructed with a
schedule consults it once per request under op names
``objstore.put|get|head|delete|copy|list|create_multipart|upload_part|
complete|abort``.  The store-shaped failure modes compose from the same
rule builders — a 503/SlowDown throttle is ``fail_nth("objstore.
upload_part", n, err=errno.EAGAIN)`` (EAGAIN classifies retried-not-fatal
under the default RetryPolicy, exactly like a real throttle response), a
slow part is ``delay_nth``, a failed commit is ``fail_nth("objstore.
complete", ...)`` — or ready-made via :func:`objectstore_persona`.
"""

from __future__ import annotations

import errno as _errno
import random
import threading
import time

from .fs import FileSystem


class InjectedFault(OSError):
    """The injected error type: an OSError with a configurable errno, so
    retry classification sees exactly what a real failure would carry."""


class _Rule:
    __slots__ = ("op", "ordinals", "errno", "latency_s", "partial", "drop",
                 "hang", "hang_timeout_s", "heal_after", "healable",
                 "healed", "fired_count")

    def __init__(self, op: str, ordinals: set, errno: int | None,
                 latency_s: float, partial: float,
                 drop: bool = False, hang: bool = False,
                 hang_timeout_s: float | None = None,
                 heal_after: int | None = None,
                 healable: bool = False) -> None:
        self.op = op
        self.ordinals = ordinals  # 1-based call numbers this rule covers
        self.errno = errno        # None = latency-only (or drop/hang) rule
        self.latency_s = latency_s
        self.partial = partial    # fraction of a write to land before failing
        self.drop = drop          # crash window: swallow the op, no error
        self.hang = hang          # block until released (or hang_timeout_s)
        self.hang_timeout_s = hang_timeout_s
        # recover_after bookkeeping: a healable rule stops firing once it
        # fired heal_after times (None = only an explicit heal() heals it)
        self.heal_after = heal_after
        self.healable = healable
        self.healed = False
        self.fired_count = 0


class FaultSchedule:
    """Seeded plan: which call ordinals of which operations fail/stall.

    Deterministic by construction — random placement (:meth:`fail_random`)
    draws ordinals from the seeded RNG at *schedule-build* time, so the
    fired set depends only on the seed and per-op call counts, never on
    thread interleaving across different operations.  Every fired fault is
    recorded (op, ordinal, errno) for the chaos artifact.
    """

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self._rng = random.Random(seed)
        self._rules: dict[str, list[_Rule]] = {}
        self._counts: dict[str, int] = {}
        self._fired: list[dict] = []
        self._lock = threading.Lock()
        self._active = True
        # hung ops park on this event (hang_nth); release_hangs()/stop()
        # set it, letting every parked caller proceed
        self._hang_release = threading.Event()

    # -- building ------------------------------------------------------------
    def fail_nth(self, op: str, nth: int, *, count: int = 1,
                 err: int = _errno.EIO, latency_s: float = 0.0,
                 partial: float = 0.0) -> "FaultSchedule":
        """Fail calls ``nth .. nth+count-1`` (1-based) of ``op`` with an
        :class:`InjectedFault` carrying ``err``.  ``partial`` (0..1, write
        ops only) lands that fraction of the payload before raising — a torn
        write the retry protocol must overwrite, not append after."""
        if nth < 1 or count < 1:
            raise ValueError("nth and count must be >= 1")
        ordinals = set(range(nth, nth + count))
        self._rules.setdefault(op, []).append(
            _Rule(op, ordinals, err, latency_s, partial))
        return self

    def fail_forever_from(self, op: str, nth: int, *,
                          err: int = _errno.EIO) -> "FaultSchedule":
        """Every call of ``op`` from ordinal ``nth`` on fails — the
        persistent-failure shape (dead disk) that exhausts restart budgets.
        (Encoded as a negative sentinel ordinal: ``n >= nth`` matches.)"""
        if nth < 1:
            raise ValueError("nth must be >= 1")
        self._rules.setdefault(op, []).append(
            _Rule(op, {-nth}, err, 0.0, 0.0))
        return self

    def drop_writes_from(self, nth: int) -> "FaultSchedule":
        """Crash window: every ``write`` op from ordinal ``nth`` on is
        silently SWALLOWED — the caller is told it succeeded, but nothing
        lands in the file.  This is the kill -9 / power-cut shape (bytes the
        process believed written never reached the disk) made reproducible
        in-process: the writer happily finalizes and publishes a file whose
        tail was never written, producing exactly the torn PUBLISHED state
        the recovery verifier must catch and quarantine.  Open-ended, like
        :meth:`fail_forever_from`."""
        if nth < 1:
            raise ValueError("nth must be >= 1")
        self._rules.setdefault("write", []).append(
            _Rule("write", {-nth}, None, 0.0, 0.0, drop=True))
        return self

    def hang_nth(self, op: str, nth: int, *, count: int = 1,
                 timeout_s: float | None = None) -> "FaultSchedule":
        """HANG calls ``nth .. nth+count-1`` of ``op``: the call blocks —
        it never returns and never raises — until :meth:`release_hangs`
        (or :meth:`stop`) fires, after which the operation proceeds
        normally.  This is the storage failure shape a finite ``latency``
        stall cannot model: a wedged NFS/HDFS pipeline that neither
        errors nor completes, invisible to errno-classified retry and
        curable only by a watchdog or a bounded ``close(deadline=...)``.
        ``timeout_s`` bounds the park (the op then proceeds) so tests
        can't wedge forever on a missed release."""
        if nth < 1 or count < 1:
            raise ValueError("nth and count must be >= 1")
        self._rules.setdefault(op, []).append(
            _Rule(op, set(range(nth, nth + count)), None, 0.0, 0.0,
                  hang=True, hang_timeout_s=timeout_s))
        return self

    def release_hangs(self) -> None:
        """Release every op parked (and any future op that would park) on
        a ``hang`` rule; the released operations proceed normally."""
        self._hang_release.set()

    def recover_after(self, op: str, nth: int = 1, *,
                      err: int = _errno.ENOSPC,
                      heal_after_ops: int | None = None) -> "FaultSchedule":
        """Dead-disk-that-heals: every call of ``op`` from ordinal ``nth``
        fails with ``err`` until the rule HEALS — after it has fired
        ``heal_after_ops`` times, or when :meth:`heal` is called
        (``heal_after_ops=None`` = only the explicit call heals).  Unlike
        ``fail_forever_from`` this models ENOSPC/EROFS conditions that an
        operator (or time) fixes: the disk fills, spills divert, the disk
        is cleared, and the same filesystem starts working again — the
        deterministic schedule behind pause/resume and failover
        reconciliation tests."""
        if nth < 1:
            raise ValueError("nth must be >= 1")
        if heal_after_ops is not None and heal_after_ops < 1:
            raise ValueError("heal_after_ops must be >= 1")
        self._rules.setdefault(op, []).append(
            _Rule(op, {-nth}, err, 0.0, 0.0,
                  heal_after=heal_after_ops, healable=True))
        return self

    def heal(self) -> None:
        """Heal every :meth:`recover_after` rule now: the dead disk is
        back.  Chaos/degrade runs call this at the scripted recovery
        moment; rules with ``heal_after_ops`` also heal on their own."""
        with self._lock:
            for rules in self._rules.values():
                for r in rules:
                    if r.healable:
                        r.healed = True

    def delay_nth(self, op: str, nth: int, latency_s: float,
                  count: int = 1) -> "FaultSchedule":
        """Stall (but do not fail) calls ``nth .. nth+count-1`` of ``op``."""
        if nth < 1 or count < 1:
            raise ValueError("nth and count must be >= 1")
        self._rules.setdefault(op, []).append(
            _Rule(op, set(range(nth, nth + count)), None, latency_s, 0.0))
        return self

    def fail_random(self, op: str, n_faults: int, window: int, *,
                    err: int = _errno.EIO,
                    latency_s: float = 0.0) -> "FaultSchedule":
        """Place ``n_faults`` failures uniformly (seeded RNG) over the first
        ``window`` calls of ``op`` — schedule-time draw, so the plan is
        fixed before the run starts."""
        if n_faults > window:
            raise ValueError("n_faults must be <= window")
        picked = set(self._rng.sample(range(1, window + 1), n_faults))
        self._rules.setdefault(op, []).append(
            _Rule(op, picked, err, latency_s, 0.0))
        return self

    def stop(self) -> None:
        """Disarm the schedule: no further faults fire (chaos runs call this
        to let the system drain and prove recovery).  Also releases every
        parked ``hang`` — a drained system must not hold hostages."""
        with self._lock:
            self._active = False
        self._hang_release.set()

    # -- plan/evidence --------------------------------------------------------
    def plan(self) -> list[dict]:
        """The full schedule as data (for the committed chaos artifact)."""
        out = []
        for op, rules in sorted(self._rules.items()):
            for r in rules:
                open_ended = any(o < 0 for o in r.ordinals)
                out.append({
                    "op": op,
                    "ordinals": ("open-ended" if open_ended
                                 else sorted(r.ordinals)),
                    "from": (-min(r.ordinals) if open_ended else None),
                    "errno": r.errno,
                    "latency_s": r.latency_s,
                    "partial": r.partial,
                    "drop": r.drop,
                    "hang": r.hang,
                    "heal_after_ops": r.heal_after,
                    "healable": r.healable,
                })
        return out

    def note(self, op: str, ordinal: int) -> None:
        """Record a non-error chaos event (e.g. a forced rebalance) in the
        fired log so the artifact carries the full timeline."""
        with self._lock:
            self._fired.append({"op": op, "ordinal": ordinal, "errno": None})

    def fired(self) -> list[dict]:
        with self._lock:
            return list(self._fired)

    def counts(self) -> dict:
        with self._lock:
            return dict(self._counts)

    # -- runtime check --------------------------------------------------------
    def check(self, op: str, payload_writer=None) -> str | None:
        """Advance ``op``'s call count; stall and/or raise when a rule
        covers this ordinal.  ``payload_writer`` (write ops) is a callable
        ``fraction -> None`` that lands a torn prefix before the raise.
        Returns ``"drop"`` when a crash-window rule covers this ordinal —
        the caller must then swallow the operation (report success, write
        nothing); returns None otherwise."""
        rule = None
        with self._lock:
            n = self._counts.get(op, 0) + 1
            self._counts[op] = n
            if self._active:
                for r in self._rules.get(op, ()):
                    if r.healed:
                        continue
                    hit = (n in r.ordinals
                           or any(o < 0 and n >= -o for o in r.ordinals))
                    if hit:
                        rule = r
                        break
            if rule is not None:
                rule.fired_count += 1
                if (rule.heal_after is not None
                        and rule.fired_count >= rule.heal_after):
                    rule.healed = True  # this firing is the rule's last
            if rule is not None and (rule.errno is not None or rule.drop
                                     or rule.hang):
                entry = {"op": op, "ordinal": n, "errno": rule.errno}
                if rule.drop:
                    entry["drop"] = True
                if rule.hang:
                    entry["hang"] = True
                self._fired.append(entry)
        if rule is None:
            return None
        if rule.hang:
            # park OUTSIDE the lock: other ops (and release_hangs itself)
            # must keep flowing while this caller is wedged
            self._hang_release.wait(rule.hang_timeout_s)
            return None  # released (or timed out): the op proceeds
        if rule.latency_s > 0.0:
            time.sleep(rule.latency_s)
        if rule.drop:
            return "drop"
        if rule.errno is None:
            return None  # latency-only rule
        if rule.partial > 0.0 and payload_writer is not None:
            payload_writer(rule.partial)
        raise InjectedFault(rule.errno, f"injected fault: {op} call #{n}")


class _FaultFile:
    """File wrapper consulting the schedule on write/flush/close.  A torn
    write (``partial``) lands a prefix through the inner file before
    raising, so retry protocols are tested against garbage-on-disk, not
    just clean no-ops."""

    def __init__(self, inner, schedule: FaultSchedule) -> None:
        self._inner = inner
        self._schedule = schedule

    def write(self, data) -> int:
        def torn(fraction: float) -> None:
            self._inner.write(data[: int(len(data) * fraction)])
        if self._schedule.check("write", torn) == "drop":
            return len(data)  # crash window: lie like a lost page cache
        return self._inner.write(data)

    def writelines(self, parts) -> None:
        parts = list(parts)

        def torn(fraction: float) -> None:
            self._inner.writelines(parts[: int(len(parts) * fraction)])
        if self._schedule.check("write", torn) == "drop":
            return  # crash window: swallowed
        self._inner.writelines(parts)

    def flush(self) -> None:
        self._schedule.check("flush")
        self._inner.flush()

    def close(self) -> None:
        self._schedule.check("close")
        self._inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __getattr__(self, name):  # seek/tell/read/… pass through
        return getattr(self._inner, name)


def objectstore_persona(seed: int = 0, *, n_throttles: int = 4,
                        window: int = 200, slow_part_nth: int = 3,
                        slow_parts: int = 2, slow_s: float = 0.05,
                        complete_fail_nth: int | None = 1) -> FaultSchedule:
    """The object-store failure persona, ready-made: ``n_throttles``
    503/SlowDown responses (EAGAIN — retried, never fatal) scattered over
    the first ``window`` part uploads, ``slow_parts`` slow parts from
    ordinal ``slow_part_nth``, and (unless None) one failed
    multipart-complete at ordinal ``complete_fail_nth`` — the crash
    window between parts and complete.  Feed the returned schedule to
    ``EmulatedObjectStore(schedule=...)``."""
    sched = FaultSchedule(seed)
    if n_throttles:
        sched.fail_random("objstore.upload_part", n_throttles, window,
                          err=_errno.EAGAIN)
    if slow_parts:
        sched.delay_nth("objstore.upload_part", slow_part_nth, slow_s,
                        count=slow_parts)
    if complete_fail_nth is not None:
        sched.fail_nth("objstore.complete", complete_fail_nth,
                       err=_errno.EAGAIN)
    return sched


class FaultInjectingFileSystem(FileSystem):
    """Schedule-consulting wrapper over any FileSystem.  Read-only probes
    (``exists``/``size``) pass through unchecked — they are rotation/ack
    bookkeeping, and failing them tests nothing the write-path ops don't."""

    def __init__(self, inner: FileSystem, schedule: FaultSchedule) -> None:
        self.inner = inner
        self.schedule = schedule

    @property
    def supports_rename(self) -> bool:
        # capability pass-through: wrapping an object-store sink must not
        # silently flip its publish protocol back to rename
        return getattr(self.inner, "supports_rename", True)

    def publish_commit(self, src: str, dst: str) -> None:
        # the multipart publish is the rename protocol's analog: consult
        # the same op name so existing publish-fault rules translate
        self.schedule.check("rename")
        self.inner.publish_commit(src, dst)

    def __getattr__(self, name):
        # observability/extra-surface pass-through (bind_registry,
        # objectstore_stats, failover_stats, declare_primary_down, ...):
        # the writer gates those wirings on hasattr(fs, ...), and a
        # fault wrapper must not hide the inner sink's surfaces — only
        # the explicitly-defined IO ops above consult the schedule
        if name == "inner":  # uninitialized instance: no self-recursion
            raise AttributeError(name)
        return getattr(self.inner, name)

    def mkdirs(self, path: str) -> None:
        self.schedule.check("mkdirs")
        self.inner.mkdirs(path)

    def open_write(self, path: str):
        self.schedule.check("open")
        return _FaultFile(self.inner.open_write(path), self.schedule)

    def open_append(self, path: str):
        self.schedule.check("open")
        return _FaultFile(self.inner.open_append(path), self.schedule)

    def open_read(self, path: str):
        self.schedule.check("open")
        return self.inner.open_read(path)

    def rename(self, src: str, dst: str) -> None:
        self.schedule.check("rename")
        self.inner.rename(src, dst)

    def sync(self, path: str) -> None:
        self.schedule.check("sync")
        self.inner.sync(path)

    def sync_dir(self, path: str) -> None:
        self.schedule.check("sync")
        self.inner.sync_dir(path)

    # durable_rename deliberately NOT forwarded to inner: the base-class
    # composition (sync -> rename -> sync_dir) runs HERE, so each leg
    # consults the schedule — an fsync-failure rule fires inside the
    # durable publish exactly where a real fsync would fail

    def exists(self, path: str) -> bool:
        return self.inner.exists(path)

    def delete(self, path: str) -> None:
        self.schedule.check("delete")
        self.inner.delete(path)

    def size(self, path: str) -> int:
        return self.inner.size(path)

    def list_files(self, path: str, extension: str | None = None,
                   recursive: bool = True) -> list[str]:
        self.schedule.check("list")
        return self.inner.list_files(path, extension=extension,
                                     recursive=recursive)
