"""Deterministic concurrency-schedule explorer runtime: the dynamic half
of the cross-process protocol tooling (the static half is the
``protocol-exhaustiveness`` / ``resource-pairing`` lint passes; the
single-interpreter analog is ``utils/lockcheck.py``).

Process workers and the object-store uploader bring bug classes no
lock-order graph can see: the shared-memory ring slot double-free that
needs two exact interleavings of a stale ``free`` ack against a
supervisor respawn, the heartbeat torn read that condemns a healthy
child, and the uploader-thread spawn race.  Found by imagining the
schedule, they are easy to miss.  This module makes the schedules
mechanical:

* **Seeded preemption points.**  Production code marks its racy edges
  with :func:`point` (free of cost when nothing is installed — one
  global ``is None`` check).  :func:`install` arms them: each point
  consults a deterministic per-``(seed, label, occurrence)`` coin and
  either passes through or parks the calling thread for a bounded delay,
  systematically perturbing the interleaving.  ``install`` also patches
  ``threading.Thread.start`` so every KPW-named thread's spawn edge is a
  preemption point (the uploader race lives exactly there), and the same
  seed replays the same perturbation schedule — a failing schedule is
  re-run by re-running its seed (``tools/schedx`` commits the seed
  sets).
* **Invariant probes registered alongside the code they guard.**  The
  ring free pool (``note_slot_taken``/``note_slot_recycled`` — a slot
  recycled while already free is the double-free, whichever of the
  stale-ack/respawn interleavings produced it), the heartbeat cells
  (``note_hb_sample`` — ``pending`` observed with a cleared
  ``started_at`` is the torn read that ages into a false condemnation),
  the background uploader singleton (``note_uploader_spawn`` — a second
  live drainer on one adapter reorders dirty part re-uploads), and the
  death-notice pid check (``note_death_notice`` — acting on a stale
  notice condemns the replacement child).  A violated probe raises AND
  records on the active checker (a raise inside a worker thread kills
  the thread, not the test), and every report carries the seed plus BOTH
  participating stacks — the observing one and the first-actor one
  recorded when the guarded state was created.
* **Virtual-delay option.**  ``install(virtual=True)`` replaces wall
  sleeps at preemption points with bounded yield loops, so wide seed
  walks explore quickly; the committed regression seeds use wall delays
  (deterministic on a loaded box: a parked thread stays parked while the
  racing thread's whole critical region completes).

Opt-in exactly like lockcheck: the ``schedcheck_checker`` pytest fixture
or ``KPW_SCHEDCHECK=1`` (whole-suite autouse; the chaos/procworkers/
objectstore suites run their unchanged assertions under the live probes
and must record zero violations).
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback

# injected delays are INSTRUMENTATION, not production blocking calls:
# they must run even while the perturbed thread holds a production lock,
# so they go through the true stdlib sleep, not lockcheck's guarded
# patch (lockcheck captured it at ITS import and never patches itself)
from .lockcheck import _REAL_SLEEP

_REAL_THREAD_START = threading.Thread.start

# clock-discipline: every timestamp in this module is monotonic — the
# probes reason about liveness windows, never wall time


class ScheduleViolation(RuntimeError):
    """Base of every probe violation: message carries the replay seed
    and both participating stacks."""


class DoubleRecycleError(ScheduleViolation):
    """A ring slot entered the free pool while already free — two units
    would be staged into the same shared memory (the stale-free /
    respawn double-free, either interleaving)."""


class HeartbeatTornReadError(ScheduleViolation):
    """A heartbeat sample showed ``pending`` with a cleared
    ``started_at`` — the torn read a watchdog ages into condemning a
    healthy child."""


class UploaderDuplicateError(ScheduleViolation):
    """A second background part-uploader was spawned for one adapter —
    two drainers can reorder a dirty re-upload behind its stale
    original."""


class StaleDeathNoticeError(ScheduleViolation):
    """A death notice was acted on for a process that did not send it —
    a delayed notice from a previous occupant condemns the healthy
    replacement."""


class QuotaLedgerTornError(ScheduleViolation):
    """A multi-tenant quota ledger's per-tenant counters diverged from
    its global total — a torn multi-route update (one side of the
    charge/credit pair landed without the other, i.e. an update escaped
    the ledger lock) would let one tenant's accounting leak into a
    sibling's quota headroom."""


class RevokedCommitError(ScheduleViolation):
    """The commit fence accepted a commit for a partition AFTER its
    ownership handed off to a different member — a revoked run was acked
    past the generation bump, i.e. a zombie clobbered the new owner's
    offset state.  The fenced broker makes this impossible (ownership is
    checked under the metadata lock at commit time); the un-fenced shape
    (a monotonic-only ``commit``) lets a delayed stale commit land after
    the handoff completes."""


def _stack(skip: int = 2, limit: int = 14) -> str:
    while skip > 0:
        try:
            frame = sys._getframe(skip)
            break
        except ValueError:  # shallow caller (direct probe use in tests)
            skip -= 1
    else:
        frame = sys._getframe(0)
    return "".join(traceback.format_stack(frame, limit=limit))


class SchedCheck:
    """One install's shared state: the seeded perturbation schedule, the
    probe state tables, and the violation log."""

    def __init__(self, seed: int = 0, delay_prob: float = 0.5,
                 max_delay_s: float = 0.02, virtual: bool = False,
                 labels: tuple[str, ...] | None = None) -> None:
        self.seed = int(seed)
        self.delay_prob = float(delay_prob)
        self.max_delay_s = float(max_delay_s)
        self.virtual = bool(virtual)
        self.labels = labels  # None = perturb every point
        self._mu = threading.RLock()
        self._occurrence: dict[str, int] = {}
        self.points_hit = 0
        self.delays_injected = 0
        self.violations: list[BaseException] = []
        # probe state -------------------------------------------------------
        # ring free pools: pool key -> {slot idx -> recycling stack}
        self._free_slots: dict[int, dict[int, str]] = {}
        # uploader singletons: adapter key -> spawning stack
        self._uploaders: dict[int, str] = {}
        # heartbeat writers: worker idx -> last hb_publish stack
        self._hb_writers: dict[int, str] = {}
        # quota ledgers: ledger key -> last consistent-update stack
        self._ledger_writers: dict[int, str] = {}
        # partition ownership: (broker key, group, topic, partition) ->
        # (owner member id, handoff stack) — written when a handoff
        # COMPLETES (never during a drain window, so the old owner's
        # drain commits pass)
        self._part_owners: dict[tuple, tuple[str, str]] = {}

    # -- perturbation ---------------------------------------------------------
    def _coin(self, label: str) -> tuple[bool, float]:
        """Deterministic per-(seed, label, occurrence) decision.  Each
        label keeps its own occurrence counter, so two threads running
        DISTINCT point labels consume independent streams — the replay
        does not depend on which thread reached the shared RNG first.
        The RNG is seeded from a STRING (random.seed hashes str via
        sha512, stable everywhere) — seeding from a tuple would go
        through hash(), which PYTHONHASHSEED randomizes per process and
        the replay seed would stop replaying across runs."""
        import random

        with self._mu:
            n = self._occurrence.get(label, 0)
            self._occurrence[label] = n + 1
            self.points_hit += 1
        rng = random.Random(f"{self.seed}:{label}:{n}")
        if rng.random() >= self.delay_prob:
            return False, 0.0
        return True, rng.uniform(0.5, 1.0) * self.max_delay_s

    def _point(self, label: str) -> None:
        if self.labels is not None and label not in self.labels:
            return
        delay, seconds = self._coin(label)
        if not delay:
            return
        with self._mu:
            self.delays_injected += 1
        if self.virtual:
            # virtual-delay mode: bounded yield quanta instead of wall
            # time, so wide seed walks stay fast
            for _ in range(int(seconds * 5000) + 1):
                _REAL_SLEEP(0)
        else:
            _REAL_SLEEP(seconds)

    # -- violation plumbing ---------------------------------------------------
    def _record(self, exc: BaseException) -> BaseException:
        with self._mu:
            self.violations.append(exc)
        return exc

    def _report(self, what: str, first_stack: str | None) -> str:
        return (f"{what}\n[replay: schedcheck seed {self.seed}]\n"
                f"--- this observation ---\n{_stack(2)}"
                f"--- first participant ---\n"
                f"{first_stack or '<stack unavailable>'}")

    # -- probe: ring slot free pool ------------------------------------------
    def note_pool_reset(self, pool_key: int, slots: int) -> None:
        """A fresh ring free pool: every slot starts free (no stack — a
        double recycle against the initial state names only one side)."""
        with self._mu:
            self._free_slots[pool_key] = {i: "<initial free pool>"
                                          for i in range(slots)}

    def note_slot_taken(self, pool_key: int, slot_idx: int) -> None:
        with self._mu:
            self._free_slots.setdefault(pool_key, {}).pop(slot_idx, None)

    def note_slot_recycled(self, pool_key: int, slot_idx: int) -> None:
        """Raises when ``slot_idx`` is already in the free pool: two
        recyclers raced (stale free ack vs. respawn reclaim) and two
        future units would share one slot's memory."""
        with self._mu:
            pool = self._free_slots.setdefault(pool_key, {})
            prior = pool.get(slot_idx)
            if prior is None:
                pool[slot_idx] = _stack(2)
                return
        raise self._record(DoubleRecycleError(self._report(
            f"ring slot {slot_idx} recycled while already free "
            f"(double-free: two units would be staged into the same "
            f"shared memory)", prior)))

    # -- probe: heartbeat cells ----------------------------------------------
    def note_hb_write(self, widx: int) -> None:
        with self._mu:
            self._hb_writers[widx] = _stack(2)

    def note_hb_sample(self, widx: int, pending: bool,
                       started_at: float) -> None:
        """Guards the stall-age COMPUTATION: ``pending`` about to be aged
        from a cleared (or absurd) ``started_at`` is the torn-read shape
        — a watchdog computing ``monotonic() - 0.0`` sees an enormous
        stall and condemns a healthy child.  A transient raw sample of
        (pending, 0.0) out of ``hb_read`` is benign BY DESIGN (the
        reader's own field reads can tear); the invariant is that no
        consumer ever turns one into an age."""
        if pending and (started_at == 0.0
                        or time.monotonic() - started_at > 3600.0):
            with self._mu:
                writer = self._hb_writers.get(widx)
            raise self._record(HeartbeatTornReadError(self._report(
                f"heartbeat cell {widx}: stall age computed from a "
                f"cleared/garbage started_at ({started_at!r}) — a torn "
                f"read is about to condemn a healthy child", writer)))

    # -- probe: uploader singleton -------------------------------------------
    def note_uploader_spawn(self, fs_key: int) -> None:
        with self._mu:
            prior = self._uploaders.get(fs_key)
            if prior is None:
                self._uploaders[fs_key] = _stack(2)
                prior = None
        if prior is not None:
            raise self._record(UploaderDuplicateError(self._report(
                "second background part-uploader spawned for one "
                "object-store adapter (two drainers reorder dirty part "
                "re-uploads)", prior)))

    # -- probe: multi-tenant quota ledger ------------------------------------
    def note_quota_ledger(self, ledger_key: int, per_tenant_sum: int,
                          global_total: int) -> None:
        """Guards the shared-session quota ledger's pairing invariant:
        at every charge/credit the sum of the per-tenant counters must
        equal the global total (both are updated under one lock, with a
        preemption point between them — an update that escapes the lock
        tears here).  The caller computes both sums INSIDE its critical
        section, so a violation is a real torn update, never reader-side
        tearing."""
        if per_tenant_sum != global_total:
            with self._mu:
                first = self._ledger_writers.get(ledger_key)
            raise self._record(QuotaLedgerTornError(self._report(
                f"quota ledger {ledger_key:#x}: per-tenant counters sum to "
                f"{per_tenant_sum} but the global total reads "
                f"{global_total} — a multi-route update tore", first)))
        with self._mu:
            self._ledger_writers[ledger_key] = _stack(2)

    # -- probe: revocation-vs-in-flight-publish fence ------------------------
    def note_partition_owner(self, broker_key: int, part_key: tuple,
                             member: str) -> None:
        """A partition handoff COMPLETED: ``member`` is now the
        authoritative owner of ``part_key`` (= (group, topic,
        partition)).  The broker notes this only when the transfer is
        final — instant reassignments and drain-window completions —
        never at drain BEGIN, so the old owner's in-window flush commits
        don't trip the probe."""
        with self._mu:
            self._part_owners[(broker_key,) + part_key] = (member, _stack(2))

    def note_commit_accepted(self, broker_key: int, part_key: tuple,
                             member: str) -> None:
        """Guards the fence itself: a commit the broker ACCEPTED from a
        member that is not the recorded owner means a revoked run was
        acked after the generation bump — the exactly-once handoff is
        broken.  The fenced commit path cannot reach here in that state
        (ownership is re-checked under the same lock); the ``--revert``
        monotonic-only shape lands here with the zombie's identity."""
        with self._mu:
            rec = self._part_owners.get((broker_key,) + part_key)
        if rec is not None and rec[0] != member:
            raise self._record(RevokedCommitError(self._report(
                f"commit for {part_key} accepted from member {member!r} "
                f"after ownership handed off to {rec[0]!r} — a revoked "
                f"run was acked past the generation bump", rec[1])))

    # -- probe: death-notice pid check ---------------------------------------
    def note_death_notice(self, slot_pid: int | None, msg_pid: int,
                          acted: bool) -> None:
        if acted and slot_pid != msg_pid:
            raise self._record(StaleDeathNoticeError(self._report(
                f"death notice from pid {msg_pid} acted on a slot now "
                f"occupied by pid {slot_pid} (stale notice condemns the "
                f"replacement child)", None)))

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "seed": self.seed,
                "points_hit": self.points_hit,
                "delays_injected": self.delays_injected,
                "violations": [repr(v) for v in self.violations],
            }


# -- module-level seams (cheap when inactive) ---------------------------------

_active: SchedCheck | None = None


def point(label: str) -> None:
    """A seeded preemption point.  Costs one global ``is None`` check
    when no checker is installed."""
    c = _active
    if c is not None:
        c._point(label)


def note_pool_reset(pool_key: int, slots: int) -> None:
    c = _active
    if c is not None:
        c.note_pool_reset(pool_key, slots)


def note_slot_taken(pool_key: int, slot_idx: int) -> None:
    c = _active
    if c is not None:
        c.note_slot_taken(pool_key, slot_idx)


def note_slot_recycled(pool_key: int, slot_idx: int) -> None:
    c = _active
    if c is not None:
        c.note_slot_recycled(pool_key, slot_idx)


def note_hb_write(widx: int) -> None:
    c = _active
    if c is not None:
        c.note_hb_write(widx)


def note_hb_sample(widx: int, pending: bool, started_at: float) -> None:
    c = _active
    if c is not None:
        c.note_hb_sample(widx, pending, started_at)


def note_uploader_spawn(fs_key: int) -> None:
    c = _active
    if c is not None:
        c.note_uploader_spawn(fs_key)


def note_partition_owner(broker_key: int, part_key: tuple,
                         member: str) -> None:
    c = _active
    if c is not None:
        c.note_partition_owner(broker_key, part_key, member)


def note_commit_accepted(broker_key: int, part_key: tuple,
                         member: str) -> None:
    c = _active
    if c is not None:
        c.note_commit_accepted(broker_key, part_key, member)


def note_death_notice(slot_pid: int | None, msg_pid: int,
                      acted: bool) -> None:
    c = _active
    if c is not None:
        c.note_death_notice(slot_pid, msg_pid, acted)


def note_quota_ledger(ledger_key: int, per_tenant_sum: int,
                      global_total: int) -> None:
    c = _active
    if c is not None:
        c.note_quota_ledger(ledger_key, per_tenant_sum, global_total)


def _patched_thread_start(self: threading.Thread) -> None:
    """Spawn edges of KPW-named threads are preemption points too — the
    uploader spawn race lives exactly in the window between a thread
    object's creation and its start."""
    c = _active
    if c is not None and self.name.upper().startswith("KPW"):
        c._point(f"thread.start:{self.name}")
    _REAL_THREAD_START(self)


def install(seed: int = 0, delay_prob: float = 0.5,
            max_delay_s: float = 0.02, virtual: bool = False,
            labels: tuple[str, ...] | None = None) -> SchedCheck:
    """Arm the preemption points and probes.  ``labels`` restricts the
    perturbation to a targeted point set (probes always stay live);
    ``virtual`` trades wall delays for yield loops."""
    global _active
    if _active is not None:
        raise RuntimeError("schedcheck already installed")
    checker = SchedCheck(seed=seed, delay_prob=delay_prob,
                         max_delay_s=max_delay_s, virtual=virtual,
                         labels=labels)
    _active = checker
    threading.Thread.start = _patched_thread_start
    return checker


def uninstall() -> None:
    global _active
    threading.Thread.start = _REAL_THREAD_START
    _active = None


def active() -> SchedCheck | None:
    return _active


def env_requested() -> bool:
    return os.environ.get("KPW_SCHEDCHECK") == "1"
