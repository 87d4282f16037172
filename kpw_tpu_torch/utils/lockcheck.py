"""Runtime lock-order detector: the dynamic half of the correctness
tooling (the static half is ``tools/analyze``'s lock-discipline pass).

The static pass only sees syntactic nesting inside one function; the
deadlocks that actually ship cross function and module boundaries — a
worker thread holding the writer's inflight lock calls into a consumer
method that takes the buffer condition, while the fetcher does the
reverse.  This module catches that class LIVE, in the test suites that
already exercise the riskiest interleavings (chaos, degrade,
batch-ingest), without changing a single assertion there.

Three capabilities, all opt-in (``install()`` / the ``KPW_LOCKCHECK=1``
env var via the pytest fixture in tests/conftest.py):

* **Lock-order graph.**  Every ``threading.Lock/RLock/Condition``
  created by ``kpw_tpu_torch`` code after install is instrumented: acquiring B
  while holding A records the edge A→B (with the acquiring stack, which
  still shows A's ``with`` frame).  An acquisition that would close a
  cycle raises :class:`LockOrderError` *before* blocking, carrying both
  edges' stacks — the seeded-inversion test asserts exactly that report.
* **Blocking-call guard.**  ``time.sleep`` is patched for the install
  window (and arbitrary callables can be wrapped via
  :func:`wrap_blocking`): a registered blocking call made while this
  thread holds any instrumented lock raises :class:`LockHeldBlockingError`.
  Waiting on a held Condition stays legal — the wrapper releases the
  held-bookkeeping around the real ``wait``.
* **Guarded-state probe.**  :func:`guard_mutations` wraps a dict so
  every mutation asserts a specific instrumented lock is held by the
  mutating thread — :class:`UnguardedMutationError` otherwise.  This is
  the exact shape of the ``string_stats`` race (unlocked
  read-modify-write on a shared stats dict), pinned as a regression by
  tests/test_lockcheck.py reintroducing the original pattern.

Only locks created by modules whose ``__name__`` starts with one of the
instrumented prefixes (default: ``kpw_tpu_torch``) are wrapped; stdlib
internals (queue.Queue's mutex, threading.Event's condition) keep real
primitives, so install() cannot destabilize the interpreter.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition
_REAL_SLEEP = time.sleep


class LockOrderError(RuntimeError):
    """Acquiring this lock here closes a cycle in the observed
    lock-order graph — two threads can deadlock.  The message carries
    the stack of this acquisition AND the stack that recorded the
    reverse edge."""


class LockHeldBlockingError(RuntimeError):
    """A registered blocking call (time.sleep, a wrapped broker/fs op)
    ran while the calling thread held an instrumented lock."""


class UnguardedMutationError(RuntimeError):
    """A guarded mapping was mutated without its lock held — the
    ``string_stats`` race shape."""


def _stack(skip: int = 2, limit: int = 14) -> str:
    return "".join(traceback.format_stack(sys._getframe(skip), limit=limit))


def _site(skip: int = 3) -> str:
    f = sys._getframe(skip)
    return f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno}"


class Detector:
    """One install's shared state: the order graph, per-thread held
    stacks, and the violation log (every raise is also recorded here so
    a violation inside a worker thread — where the raise kills the
    thread, not the test — stays assertable)."""

    def __init__(self, prefixes: tuple[str, ...] = ("kpw_tpu_torch",)) -> None:
        self.prefixes = prefixes
        # guards the graph + violation log; reentrant because _record
        # runs inside note_acquire's critical section when a cycle raises
        self._mu = _REAL_RLOCK()
        self._edges: dict[tuple[int, int], str] = {}   # (idA,idB) -> stack
        self._names: dict[int, str] = {}               # lock id -> label
        self._tls = threading.local()
        self.violations: list[BaseException] = []
        self.locks_created = 0

    # -- per-thread held list ---------------------------------------------
    def _held(self) -> list:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    def held_labels(self) -> list[str]:
        return [self._names.get(id(lk), "?") for lk in self._held()]

    # -- graph -------------------------------------------------------------
    def _record(self, exc: BaseException) -> BaseException:
        with self._mu:
            self.violations.append(exc)
        return exc

    def note_acquire(self, lock: "_InstrumentedBase") -> None:
        """Called BEFORE the real acquire: record edges held→lock and
        raise if any edge closes a cycle (so the report fires instead of
        the deadlock)."""
        held = self._held()
        if held:
            lid = id(lock)
            with self._mu:
                for h in held:
                    hid = id(h)
                    if hid == lid:
                        continue  # reentrant RLock
                    edge = (hid, lid)
                    if edge in self._edges:
                        continue
                    back = self._path(lid, hid)
                    if back is not None:
                        reverse_stack = self._edges.get(
                            (back[0], back[1]),
                            "<edge stack unavailable>")
                        raise self._record(LockOrderError(
                            f"lock-order cycle: acquiring "
                            f"{self._names.get(lid)} while holding "
                            f"{self._names.get(hid)}, but the reverse "
                            f"order was already observed.\n"
                            f"--- this acquisition ---\n{_stack(3)}"
                            f"--- first acquisition of the reverse edge "
                            f"({self._names.get(back[0])} -> "
                            f"{self._names.get(back[1])}) ---\n"
                            f"{reverse_stack}"))
                    self._edges[edge] = _stack(3)
        held.append(lock)

    def _path(self, src: int, dst: int):
        """First edge of a path src→…→dst in the edge graph, or None."""
        adj: dict[int, list[int]] = {}
        for (a, b) in self._edges:
            adj.setdefault(a, []).append(b)
        stack = [(src, (src,))]
        seen = {src}
        while stack:
            node, path = stack.pop()
            for nxt in adj.get(node, ()):
                if nxt == dst:
                    full = path + (nxt,)
                    return (full[0], full[1])
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + (nxt,)))
        return None

    def note_release(self, lock: "_InstrumentedBase") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                return

    def check_blocking(self, label: str) -> None:
        held = self._held()
        if held:
            raise self._record(LockHeldBlockingError(
                f"blocking call {label} while holding instrumented "
                f"lock(s) {self.held_labels()}\n{_stack(3)}"))

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "locks_created": self.locks_created,
                "edges": [(self._names.get(a, "?"), self._names.get(b, "?"))
                          for (a, b) in self._edges],
                "violations": [repr(v) for v in self.violations],
            }


class _InstrumentedBase:
    """Shared acquire/release bookkeeping over a real primitive."""

    def __init__(self, det: Detector, real, label: str) -> None:
        self._det = det
        self._real = real
        self._label = label
        self._owner: int | None = None
        self._count = 0
        det._names[id(self)] = label
        det.locks_created += 1

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking:
            self._det.note_acquire(self)
        got = (self._real.acquire(blocking, timeout)
               if timeout != -1 else self._real.acquire(blocking))
        if not blocking and got:
            self._det.note_acquire(self)
        if got:
            self._owner = threading.get_ident()
            self._count += 1
        elif blocking:
            self._det.note_release(self)
        return got

    def release(self) -> None:
        self._count -= 1
        if self._count <= 0:
            self._owner = None
        self._real.release()
        self._det.note_release(self)

    def held_by_current_thread(self) -> bool:
        return self._owner == threading.get_ident() and self._count > 0

    def locked(self) -> bool:
        return self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<lockcheck {type(self).__name__} {self._label}>"


class InstrumentedLock(_InstrumentedBase):
    pass


class InstrumentedRLock(_InstrumentedBase):
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._owner == threading.get_ident():
            # reentrant re-acquire: no ordering edge, no held push
            got = (self._real.acquire(blocking, timeout)
                   if timeout != -1 else self._real.acquire(blocking))
            if got:
                self._count += 1
            return got
        return super().acquire(blocking, timeout)

    def release(self) -> None:
        if self._count > 1:
            self._count -= 1
            self._real.release()
            return
        super().release()


class InstrumentedCondition(_InstrumentedBase):
    """Condition wrapper: ordering/held bookkeeping on the underlying
    lock; ``wait`` releases the held-bookkeeping for its duration (the
    real wait releases the real lock), so a waiter is never reported as
    holding the condition it sleeps on."""

    def __init__(self, det: Detector, label: str, lock=None) -> None:
        if isinstance(lock, _InstrumentedBase):
            lock = lock._real
        super().__init__(det, _REAL_CONDITION(lock), label)

    def wait(self, timeout: float | None = None) -> bool:
        self._det.note_release(self)
        owner, count = self._owner, self._count
        self._owner, self._count = None, 0
        try:
            return self._real.wait(timeout)
        finally:
            self._owner, self._count = owner, count
            self._det.note_acquire(self)

    def wait_for(self, predicate, timeout: float | None = None):
        self._det.note_release(self)
        owner, count = self._owner, self._count
        self._owner, self._count = None, 0
        try:
            return self._real.wait_for(predicate, timeout)
        finally:
            self._owner, self._count = owner, count
            self._det.note_acquire(self)

    def notify(self, n: int = 1) -> None:
        self._real.notify(n)

    def notify_all(self) -> None:
        self._real.notify_all()


class GuardedMapping(dict):
    """Dict whose mutations must run with ``lock`` held by the mutating
    thread (``lock`` must be an instrumented lock so ownership is
    knowable).  Reads are unrestricted — the probe targets the race
    shape: concurrent read-modify-WRITE without the guard."""

    def __init__(self, det: Detector, lock: _InstrumentedBase,
                 *args, **kw) -> None:
        super().__init__(*args, **kw)
        self._det = det
        self._guard = lock

    def _check(self, op: str) -> None:
        if not self._guard.held_by_current_thread():
            raise self._det._record(UnguardedMutationError(
                f"GuardedMapping.{op} without holding "
                f"{self._guard._label}\n{_stack(3)}"))

    def __setitem__(self, k, v) -> None:
        self._check("__setitem__")
        super().__setitem__(k, v)

    def __delitem__(self, k) -> None:
        self._check("__delitem__")
        super().__delitem__(k)

    def update(self, *a, **kw) -> None:
        self._check("update")
        super().update(*a, **kw)

    def setdefault(self, k, default=None):
        self._check("setdefault")
        return super().setdefault(k, default)

    def pop(self, *a):
        self._check("pop")
        return super().pop(*a)

    def clear(self) -> None:
        self._check("clear")
        super().clear()


# -- install / uninstall -----------------------------------------------------

_active: Detector | None = None


def _caller_is_instrumented(det: Detector) -> bool:
    # the factory's caller's caller is the code running Lock()/RLock()/
    # Condition(); one frame probe per lock CREATION (rare), zero cost
    # per acquire
    mod = sys._getframe(2).f_globals.get("__name__", "")
    return any(mod == p or mod.startswith(p + ".") for p in det.prefixes)


def _lock_factory():
    det = _active
    if det is None or not _caller_is_instrumented(det):
        return _REAL_LOCK()
    return InstrumentedLock(det, _REAL_LOCK(), f"Lock@{_site(2)}")


def _rlock_factory():
    det = _active
    if det is None or not _caller_is_instrumented(det):
        return _REAL_RLOCK()
    return InstrumentedRLock(det, _REAL_RLOCK(), f"RLock@{_site(2)}")


def _condition_factory(lock=None):
    det = _active
    if det is None or not _caller_is_instrumented(det):
        if isinstance(lock, _InstrumentedBase):
            lock = lock._real
        return _REAL_CONDITION(lock)
    return InstrumentedCondition(det, f"Condition@{_site(2)}", lock)


def _guarded_sleep(seconds: float) -> None:
    det = _active
    if det is not None:
        det.check_blocking(f"time.sleep({seconds!r})")
    _REAL_SLEEP(seconds)


def install(prefixes: tuple[str, ...] = ("kpw_tpu_torch",)) -> Detector:
    """Instrument lock creation for ``prefixes`` modules and guard
    ``time.sleep``.  Returns the live :class:`Detector`.  Locks created
    BEFORE install stay real (install early — the pytest fixture
    installs before the writer under test is constructed)."""
    global _active
    if _active is not None:
        raise RuntimeError("lockcheck already installed")
    det = Detector(prefixes)
    _active = det
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _condition_factory
    time.sleep = _guarded_sleep
    return det


def uninstall() -> None:
    """Restore the real primitives.  Locks already handed out keep
    working (they wrap real primitives); only creation reverts."""
    global _active
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    threading.Condition = _REAL_CONDITION
    time.sleep = _REAL_SLEEP
    _active = None


def active() -> Detector | None:
    return _active


def wrap_blocking(fn, label: str | None = None):
    """Wrap any callable as a registered blocking call: invoking it with
    an instrumented lock held raises LockHeldBlockingError (and records
    the violation on the detector)."""
    name = label or getattr(fn, "__qualname__", repr(fn))

    def wrapper(*a, **kw):
        det = _active
        if det is not None:
            det.check_blocking(name)
        return fn(*a, **kw)

    wrapper.__name__ = f"blocking[{name}]"
    return wrapper


def guard_mutations(lock: _InstrumentedBase, initial=None) -> GuardedMapping:
    """A dict whose mutations assert ``lock`` is held — the regression
    probe for the ``string_stats`` unguarded-merge race."""
    det = _active
    if det is None:
        raise RuntimeError("lockcheck not installed")
    if not isinstance(lock, _InstrumentedBase):
        raise TypeError("guard_mutations needs an instrumented lock "
                        "(create it after install())")
    return GuardedMapping(det, lock, initial or {})
