"""Retry policy for the write path's IO seams.

Reference ``tryUntilSucceeds`` (KafkaProtoParquetWriter.java:410-443): retry
forever on IOException with a fixed 100 ms sleep, propagate interruption,
wrap other checked failures.  That loop has two production problems the
robustness PR hardens away:

* **No error classification** — a full disk (``ENOSPC``) or a read-only
  remount (``EROFS``) is retried forever at 100 ms with only a warning log;
  the writer spins silently degraded instead of surfacing a worker death the
  supervisor (or operator) can act on.
* **Fixed sleep** — a transiently sick sink gets hammered every 100 ms by
  every worker in lockstep; exponential backoff with decorrelated jitter
  (the AWS architecture-blog variant: ``sleep = min(cap, uniform(base,
  prev*3))``) spreads the herd and backs off hard failures.

:class:`RetryPolicy` keeps the reference's *default delivery semantics* —
infinite attempts, so a transient outage never drops records — while adding
fatal-by-default classification of non-transient errnos and optional
attempt/deadline budgets.  ``RetryPolicy.reference()`` restores the pure
reference loop (fixed 100 ms, no classification, no budget) as the escape
hatch.  ``try_until_succeeds`` remains as the thin compatibility wrapper all
existing call sites keep using.
"""

from __future__ import annotations

import errno
import logging
import random
import threading
import time

logger = logging.getLogger(__name__)

RETRY_SLEEP_SECONDS = 0.1

#: errnos that almost never heal by retrying in place: disk full, read-only
#: filesystem, quota exceeded.  A worker hitting one dies loudly (and the
#: supervisor, when enabled, surfaces/restarts it) instead of spinning.
FATAL_ERRNOS = frozenset({errno.ENOSPC, errno.EROFS, errno.EDQUOT})


class RetryInterrupted(Exception):
    """Raised when a stop event fires while retrying."""


class RetryBudgetExceeded(Exception):
    """Raised when a bounded policy runs out of attempts or deadline; the
    last underlying error is chained as ``__cause__``."""


class RetryPolicy:
    """Classify-and-backoff retry loop.

    Parameters
    ----------
    base_sleep:
        First backoff sleep (seconds); also the jitter floor.
    max_sleep:
        Backoff cap.  With the default decorrelated jitter each sleep is
        drawn from ``uniform(base_sleep, prev*3)`` then clamped here.
    max_attempts:
        Total call budget (``None`` = unbounded, the reference semantics).
        Exhaustion raises :class:`RetryBudgetExceeded`.
    deadline:
        Wall-clock budget in seconds from the first attempt (``None`` =
        unbounded).  Checked before sleeping: the loop never starts a sleep
        it knows will overrun.
    retry_on:
        Exception types that are retry *candidates*; anything else
        propagates immediately.
    fatal_errnos:
        Within ``retry_on``, OSErrors whose ``errno`` is listed here are
        re-raised immediately (fatal, not transient).  Pass an empty set to
        restore pure reference behavior.
    jitter:
        ``True`` = decorrelated jitter; ``False`` = deterministic
        exponential doubling (used by tests that assert exact sleeps).
    rng:
        Seedable ``random.Random`` for deterministic chaos runs.
    """

    def __init__(self,
                 base_sleep: float = RETRY_SLEEP_SECONDS,
                 max_sleep: float = 5.0,
                 max_attempts: int | None = None,
                 deadline: float | None = None,
                 retry_on: tuple = (OSError,),
                 fatal_errnos: frozenset = FATAL_ERRNOS,
                 jitter: bool = True,
                 rng: random.Random | None = None) -> None:
        if base_sleep <= 0:
            raise ValueError("base_sleep must be positive")
        if max_sleep < base_sleep:
            raise ValueError("max_sleep must be >= base_sleep")
        if max_attempts is not None and max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.base_sleep = base_sleep
        self.max_sleep = max_sleep
        self.max_attempts = max_attempts
        self.deadline = deadline
        self.retry_on = retry_on
        self.fatal_errnos = frozenset(fatal_errnos)
        self.jitter = jitter
        self._rng = rng or random.Random()

    @classmethod
    def reference(cls) -> "RetryPolicy":
        """Pure reference semantics (KPW.java:410-443): retry *every*
        OSError forever at a fixed 100 ms — no classification, no backoff
        growth, no budget."""
        return cls(base_sleep=RETRY_SLEEP_SECONDS,
                   max_sleep=RETRY_SLEEP_SECONDS,
                   max_attempts=None, deadline=None,
                   fatal_errnos=frozenset(), jitter=False)

    # -- classification ------------------------------------------------------
    def is_fatal(self, exc: BaseException) -> bool:
        """True when ``exc`` should NOT be retried despite matching
        ``retry_on`` (non-transient errno class)."""
        return (isinstance(exc, OSError)
                and exc.errno in self.fatal_errnos)

    # -- backoff -------------------------------------------------------------
    def next_sleep(self, prev: float | None) -> float:
        """Next backoff sleep given the previous one (``None`` on the first
        failure)."""
        if prev is None:
            return self.base_sleep
        if self.jitter:
            # decorrelated jitter: uniform over [base, prev*3], capped
            hi = max(self.base_sleep, min(prev * 3.0, self.max_sleep))
            return self._rng.uniform(self.base_sleep, hi)
        return min(prev * 2.0, self.max_sleep)

    # -- the loop ------------------------------------------------------------
    def call(self, fn, stop_event: threading.Event | None = None,
             on_retry=None, label: str = ""):
        """Call ``fn`` until it returns.

        Retries ``retry_on`` failures with backoff; fatal-classified errors
        and budget exhaustion raise instead of spinning.  ``on_retry`` (if
        given) is invoked as ``on_retry(attempt, exc, sleep_s)`` before each
        backoff sleep — the metrics seam (retry counts, backoff seconds,
        last error) without coupling this module to the registry.
        """
        attempt = 0
        sleep: float | None = None
        started = time.monotonic()
        while True:
            attempt += 1
            try:
                return fn()
            except self.retry_on as e:
                if stop_event is not None and stop_event.is_set():
                    raise RetryInterrupted() from e
                if self.is_fatal(e):
                    logger.error("fatal (non-retryable) IO failure%s: %r",
                                 f" in {label}" if label else "", e)
                    raise
                if (self.max_attempts is not None
                        and attempt >= self.max_attempts):
                    raise RetryBudgetExceeded(
                        f"gave up after {attempt} attempts"
                        f"{f' in {label}' if label else ''}") from e
                sleep = self.next_sleep(sleep)
                if (self.deadline is not None
                        and time.monotonic() + sleep - started > self.deadline):
                    raise RetryBudgetExceeded(
                        f"deadline {self.deadline}s exceeded after "
                        f"{attempt} attempts"
                        f"{f' in {label}' if label else ''}") from e
                if on_retry is not None:
                    try:
                        on_retry(attempt, e, sleep)
                    except Exception:
                        logger.exception("on_retry hook failed (ignored)")
                logger.warning("IO failure%s, retrying in %.0f ms: %r",
                               f" in {label}" if label else "",
                               sleep * 1000, e)
                if stop_event is not None:
                    if stop_event.wait(sleep):
                        raise RetryInterrupted() from e
                else:
                    time.sleep(sleep)


def try_until_succeeds(fn, stop_event: threading.Event | None = None,
                       retry_on: tuple = (OSError,),
                       sleep: float = RETRY_SLEEP_SECONDS,
                       policy: RetryPolicy | None = None,
                       on_retry=None, label: str = ""):
    """Call ``fn`` until it returns; retry on ``retry_on`` failures.

    Compatibility wrapper over :class:`RetryPolicy`.  Without an explicit
    ``policy`` it builds the default one (infinite attempts, exponential
    backoff + decorrelated jitter from ``sleep``, fatal errno
    classification) — reference delivery semantics with modern backoff."""
    if policy is None:
        policy = RetryPolicy(base_sleep=sleep, retry_on=retry_on)
    return policy.call(fn, stop_event=stop_event, on_retry=on_retry,
                       label=label)
