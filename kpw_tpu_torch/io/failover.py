"""Spillover failover filesystem: keep publishing while the primary is down.

The retry layer heals *transient* primary failures and the fatal-errno
classification turns *persistent* ones (disk full, read-only remount) into
worker deaths — but death is the wrong answer when a perfectly good local
disk is sitting right there.  :class:`FailoverFileSystem` is a
primary/fallback composite over any two :class:`~kpw_tpu_torch.io.fs.FileSystem`
implementations:

* **Healthy**: every operation routes to the primary; the fallback is idle.
* **Degrade**: a fatal-classified errno from a primary mutating op (or an
  explicit :meth:`declare_primary_down` — the hung-IO watchdog's verdict)
  flips the composite into degraded mode.  The failing creation op is
  transparently redone on the fallback, so the calling worker never sees
  the fatal error; publishes (tmp→rename) now land on the fallback and are
  recorded as *spilled*.
* **Reconcile**: a background reconciler probes the primary on an interval;
  once a probe write succeeds, every spilled final is migrated back —
  verified with the independent structural verifier (``kpw_tpu_torch.io.verify``)
  FIRST, copied, then published on the primary via ``durable_rename``
  semantics (tmp copy → fsync → atomic rename → dir fsync).  A spill that
  fails verification is quarantined on the fallback (moved, NEVER deleted:
  unverified data is evidence); a migration IO failure is metered and retried on the
  next probe round.  When nothing spilled remains, the composite flips
  back to the primary.

The at-least-once contract is preserved throughout: an ack only ever
follows a successful (possibly spilled) publish, and reconciliation moves
bytes that were already durable on the fallback — it deletes a fallback
copy only after the primary copy is durably renamed into place.

Meters (registered when a ``MetricRegistry`` is supplied, always counted):
``parquet.writer.spilled`` (finals published onto the fallback),
``parquet.writer.reconciled`` (spills migrated back to the primary),
``parquet.writer.reconcile.failed`` (verify failures → quarantine, and
migration IO errors → retried).  :meth:`failover_stats` returns the full
pull-based snapshot; ``writer.stats()["failover"]`` surfaces it when the
writer's filesystem is this composite.
"""

from __future__ import annotations

import logging
import threading
import time

from .fs import FileSystem

logger = logging.getLogger(__name__)

_PROBE_NAME = ".kpw_failover_probe"


def _parent(path: str) -> str:
    return path.rsplit("/", 1)[0] if "/" in path else "."


class _PrimaryWriteObserver:
    """Thin wrapper over a primary-opened write handle: a fatal errno from
    ``write``/``flush``/``close`` flips the composite into degraded mode
    *before* re-raising — the bytes already written to this handle cannot
    be replayed here (the caller's retry/supervision/pause layer owns
    that), but the NEXT open must route to the fallback immediately."""

    def __init__(self, fs: "FailoverFileSystem", inner) -> None:
        self._fs = fs
        self._inner = inner

    def _guard(self, fn, *args):
        try:
            return fn(*args)
        except OSError as e:
            if self._fs._is_fatal(e):
                self._fs._degrade(f"primary {fn.__name__} failed: {e!r}")
            raise

    def write(self, data):
        return self._guard(self._inner.write, data)

    def writelines(self, parts):
        return self._guard(self._inner.writelines, parts)

    def flush(self):
        return self._guard(self._inner.flush)

    def close(self):
        return self._guard(self._inner.close)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __getattr__(self, name):  # seek/tell/... pass through
        return getattr(self._inner, name)


# lint: protocol-exhaustiveness ok — rename-based by contract: the
# constructor REJECTS rename-less sides (supports_rename False raises
# ValueError below), so the inherited supports_rename=True /
# publish_commit TypeError defaults are correct for every constructible
# instance; the spill/reconcile protocol itself is rename-based
class FailoverFileSystem(FileSystem):
    """Primary/fallback composite with background reconciliation.

    Parameters
    ----------
    primary, fallback:
        Any two FileSystems.  The fallback is typically a local spill
        directory standing in for the HDFS/remote primary.
    probe_interval_s:
        How often the reconciler probes a downed primary.
    registry:
        Optional ``MetricRegistry``; the spill/reconcile meters register
        under their canonical names when given.
    fatal_errnos:
        Which errnos flip failover (default: the retry layer's
        ``FATAL_ERRNOS`` — ENOSPC/EROFS/EDQUOT).
    probe_dir:
        Directory on the primary the recovery probe writes into; defaults
        to the first directory ``mkdirs`` is asked for (the writer's tmp
        dir), so zero-config wiring through ``Builder.filesystem`` works.
    """

    def __init__(self, primary: FileSystem, fallback: FileSystem, *,
                 probe_interval_s: float = 1.0, registry=None,
                 fatal_errnos=None, probe_dir: str | None = None) -> None:
        from ..runtime import metrics as M
        from ..runtime.retry import FATAL_ERRNOS

        # capability guard: the spill/reconcile protocol is built on the
        # RENAME publish discipline (durable_rename onto the fallback,
        # salvage renames, migrate-then-rename reconciliation).  A
        # rename-less side (an object-store adapter) would silently fall
        # back to non-atomic copy+delete mid-protocol — reject loudly at
        # construction instead of drifting at the first degraded publish
        for side, fs in (("primary", primary), ("fallback", fallback)):
            if not getattr(fs, "supports_rename", True):
                raise ValueError(
                    f"FailoverFileSystem requires rename-capable "
                    f"filesystems; the {side} is a rename-less "
                    f"(object-store) sink — the failover tier does not "
                    f"support the multipart publish protocol yet")
        self.primary = primary
        self.fallback = fallback
        self.probe_interval_s = probe_interval_s
        self._fatal_errnos = frozenset(
            fatal_errnos if fatal_errnos is not None else FATAL_ERRNOS)
        self._probe_dir = probe_dir
        self._degraded = threading.Event()
        self._lock = threading.Lock()
        self._cause: str | None = None
        self._degraded_since: float | None = None
        self._failover_count = 0
        self._recovered_count = 0
        self._spilled: list[str] = []       # fallback finals awaiting migration
        self._quarantined: list[dict] = []  # spills that failed verification
        self._spill_sources: list[str] = []  # primary tmps a spilled rename
        # could not remove (best-effort cleanup once the primary heals)
        self._spilled_meter = (registry.meter(M.SPILLED_METER)
                               if registry else M.Meter())
        self._reconciled_meter = (registry.meter(M.RECONCILED_METER)
                                  if registry else M.Meter())
        self._reconcile_failed_meter = (
            registry.meter(M.RECONCILE_FAILED_METER)
            if registry else M.Meter())
        self._closed = threading.Event()
        self._reconciler = threading.Thread(
            target=self._reconcile_loop, name="KPW-failover-reconciler",
            daemon=True)
        self._reconciler.start()

    # -- state -------------------------------------------------------------
    def degraded(self) -> bool:
        return self._degraded.is_set()

    def declare_primary_down(self, reason: str) -> None:
        """External verdict (the hung-IO watchdog, an operator) that the
        primary is unusable even though it never returned an errno."""
        self._degrade(f"declared down: {reason}")

    def _is_fatal(self, e: OSError) -> bool:
        return e.errno in self._fatal_errnos

    def _degrade(self, cause: str) -> None:
        with self._lock:
            if self._degraded.is_set():
                return
            self._cause = cause
            self._degraded_since = time.monotonic()
            self._failover_count += 1
            self._degraded.set()
        logger.error("failover: primary filesystem degraded (%s); "
                     "publishes spill to the fallback", cause)

    def _recover(self) -> None:
        with self._lock:
            if not self._degraded.is_set():
                return
            self._recovered_count += 1
            self._cause = None
            self._degraded_since = None
            self._degraded.clear()
        logger.warning("failover: primary recovered and every spill "
                       "reconciled; routing back to the primary")

    def failover_stats(self) -> dict:
        with self._lock:
            since = self._degraded_since
            return {
                "degraded": self._degraded.is_set(),
                "cause": self._cause,
                "degraded_age_s": (round(time.monotonic() - since, 3)
                                   if since is not None else 0.0),
                "failovers": self._failover_count,
                "recoveries": self._recovered_count,
                "spilled": self._spilled_meter.count,
                "spilled_pending": list(self._spilled),
                "reconciled": self._reconciled_meter.count,
                "reconcile_failed": self._reconcile_failed_meter.count,
                "quarantined_spills": [dict(q) for q in self._quarantined],
            }

    def close(self, timeout: float = 5.0) -> None:
        """Stop the reconciler thread.  Spills still pending stay on the
        fallback (durable, verified-before-migration on the next run).
        Routing state is untouched: closing a healthy composite must not
        make it look degraded."""
        self._closed.set()
        if self._reconciler.is_alive():
            self._reconciler.join(timeout=timeout)

    # -- routed operations ---------------------------------------------------
    def mkdirs(self, path: str) -> None:
        if self._probe_dir is None:
            # first dir the writer asks for (its tmp dir): a known-writable
            # location on the primary for the recovery probe
            self._probe_dir = path
        if self._degraded.is_set():
            self.fallback.mkdirs(path)
            return
        try:
            self.primary.mkdirs(path)
        except OSError as e:
            if not self._is_fatal(e):
                raise
            self._degrade(f"primary mkdirs failed: {e!r}")
            self.fallback.mkdirs(path)

    def open_write(self, path: str):
        if self._degraded.is_set():
            return self.fallback.open_write(path)
        try:
            return _PrimaryWriteObserver(self, self.primary.open_write(path))
        except OSError as e:
            if not self._is_fatal(e):
                raise
            self._degrade(f"primary open_write failed: {e!r}")
            return self.fallback.open_write(path)

    def open_append(self, path: str):
        if self._degraded.is_set():
            return self.fallback.open_append(path)
        try:
            return _PrimaryWriteObserver(self, self.primary.open_append(path))
        except OSError as e:
            if not self._is_fatal(e):
                raise
            self._degrade(f"primary open_append failed: {e!r}")
            return self.fallback.open_append(path)

    def open_read(self, path: str):
        first, second = self._route_order()
        try:
            return first.open_read(path)
        except (OSError, KeyError):
            return second.open_read(path)

    def rename(self, src: str, dst: str) -> None:
        if not self._degraded.is_set():
            try:
                # the bring-home check only matters after a degraded
                # window has existed — guarding on the failover count
                # keeps the never-degraded hot path at parity with a
                # plain filesystem (no extra stat RPC per publish)
                if (self._failover_count > 0
                        and not self.primary.exists(src)
                        and self.fallback.exists(src)):
                    # src was written during a degraded window and is
                    # publishing AFTER recovery: bring it home first, then
                    # publish on the primary directly — no spill, no
                    # reconciliation debt
                    self.primary.mkdirs(_parent(src))
                    _copy_file(self.fallback, src, self.primary, src)
                    try:
                        self.fallback.delete(src)
                    except OSError:
                        pass  # duplicate tmp on the fallback, never wrong
                self.primary.rename(src, dst)
                return
            except OSError as e:
                if not self._is_fatal(e):
                    raise
                self._degrade(f"primary rename failed: {e!r}")
        # degraded: the publish must land on the fallback.  The tmp may
        # live on the PRIMARY (degradation flipped mid-publish): salvage
        # by copying it over — a full disk usually still reads fine — then
        # rename on the fallback.
        if not self.fallback.exists(src) and self.primary.exists(src):
            self.fallback.mkdirs(_parent(src))
            try:
                _copy_file(self.primary, src, self.fallback, src)
            except OSError:
                # the tmp cannot be read back (a worker's finisher can
                # publish after its next file's open degraded the route):
                # publish it in place, where it would have gone anyway,
                # and leave no partial copy for a retry to rename
                try:
                    self.fallback.delete(src)
                except OSError:
                    pass
                self.primary.rename(src, dst)
                return
            try:
                self.primary.delete(src)
            except OSError:
                with self._lock:
                    self._spill_sources.append(src)
        self.fallback.mkdirs(_parent(dst))
        self.fallback.rename(src, dst)
        if "/quarantine/" not in dst and not dst.endswith(".tmp"):
            # a rename onto the fallback outside tmp/quarantine is a
            # spilled PUBLISH: the reconciler owes it to the primary
            with self._lock:
                self._spilled.append(dst)
            self._spilled_meter.mark()
            logger.warning("failover: published %s on the FALLBACK "
                           "(spill #%d)", dst, self._spilled_meter.count)

    def sync(self, path: str) -> None:
        fs = self._fs_holding(path)
        try:
            fs.sync(path)
        except OSError as e:
            # an fsync leg cannot be transparently redone (the bytes live
            # on the failing side), but a fatal errno must still flip the
            # route so the caller's NEXT attempt spills
            if fs is self.primary and self._is_fatal(e):
                self._degrade(f"primary sync failed: {e!r}")
            raise

    def sync_dir(self, path: str) -> None:
        if self._degraded.is_set():
            self.fallback.sync_dir(path)
            return
        try:
            self.primary.sync_dir(path)
        except OSError as e:
            if self._is_fatal(e):
                self._degrade(f"primary sync_dir failed: {e!r}")
            raise

    def exists(self, path: str) -> bool:
        # routed side first; the NON-routed (possibly sick) side is
        # consulted second and tolerated if it raises — while degraded, a
        # dead primary whose stat calls error must not take down publish
        # bookkeeping (the collision probe, durable_rename's src check)
        first, second = self._route_order()
        if first.exists(path):
            return True
        try:
            return second.exists(path)
        except OSError:
            return False

    def delete(self, path: str) -> None:
        self._fs_holding(path).delete(path)

    def size(self, path: str) -> int:
        return self._fs_holding(path).size(path)

    def list_files(self, path: str, extension: str | None = None,
                   recursive: bool = True) -> list[str]:
        out = set()
        for fs in (self.primary, self.fallback):
            try:
                out.update(fs.list_files(path, extension=extension,
                                         recursive=recursive))
            except OSError:
                continue  # a sick side contributes nothing, not an error
        return sorted(out)

    def _route_order(self) -> tuple[FileSystem, FileSystem]:
        if self._degraded.is_set():
            return self.fallback, self.primary
        return self.primary, self.fallback

    def _fs_holding(self, path: str) -> FileSystem:
        first, second = self._route_order()
        if first.exists(path):
            return first
        try:
            if second.exists(path):
                return second
        except OSError:
            pass  # sick non-routed side holds nothing we can use
        return first  # let the routed side raise its native not-found

    # -- reconciliation ------------------------------------------------------
    def _reconcile_loop(self) -> None:
        while not self._closed.is_set():
            # bounded wait, NOT a bare event hijackable by close(): the
            # loop notices either a degrade or a close within one tick
            if not self._degraded.wait(timeout=0.2):
                continue
            if self._closed.wait(self.probe_interval_s):
                return
            try:
                if not self._probe_primary():
                    continue
                if self._reconcile_round():
                    self._recover()
            except Exception:
                logger.exception("failover reconciler round failed "
                                 "(will retry)")

    def _probe_primary(self) -> bool:
        """One write-path probe against the primary: mkdirs + create +
        write + close + delete.  Only a full round trip counts as healthy
        — a read-only remount happily lists files."""
        d = self._probe_dir
        if d is None:
            return False  # nothing was ever written; nowhere safe to probe
        path = f"{d}/{_PROBE_NAME}"
        try:
            self.primary.mkdirs(d)
            with self.primary.open_write(path) as f:
                f.write(b"kpw failover probe")
            self.primary.delete(path)
            return True
        except OSError:
            return False

    def reconcile_now(self) -> bool:
        """Synchronous probe + reconcile round (deterministic tests, an
        operator forcing the issue).  Returns True when the primary is
        healthy and no spilled final remains."""
        if not self._probe_primary():
            return False
        if self._reconcile_round():
            self._recover()
            return True
        return False

    def _reconcile_round(self) -> bool:
        """Migrate every spilled final fallback → primary.  Returns True
        when the spill list drained (quarantined entries excluded — they
        are out of the published set by design)."""
        from .verify import verify_file

        with self._lock:
            pending = list(self._spilled)
        for path in pending:
            if self._closed.is_set():
                return False
            if not self.fallback.exists(path):
                self._drop_spilled(path)  # already migrated (racing round)
                continue
            rep = verify_file(self.fallback, path)
            if not rep.ok:
                # verification failed: quarantine ON the fallback — moved,
                # never deleted (unverified data is evidence, not
                # garbage) — and out of the migration set
                qpath = self._quarantine_spill(path, rep.errors[:3])
                self._reconcile_failed_meter.mark()
                self._drop_spilled(path)
                logger.error("failover: spilled file %s failed structural "
                             "verification; quarantined to %s (NOT "
                             "migrated, NOT deleted)", path, qpath)
                continue
            try:
                self._migrate(path)
            except OSError as e:
                # primary sickened again mid-migration: meter, keep the
                # spill, abort the round — the probe loop will retry
                self._reconcile_failed_meter.mark()
                logger.warning("failover: migration of %s failed (%r); "
                               "will retry next probe round", path, e)
                return False
            self._drop_spilled(path)
            self._reconciled_meter.mark()
            logger.info("failover: reconciled %s back to the primary", path)
        self._cleanup_spill_sources()
        with self._lock:
            return not self._spilled

    def _migrate(self, path: str) -> None:
        """Copy one verified spill to the primary and publish it there
        with durable_rename semantics; delete the fallback copy only after
        the primary copy is durably in place."""
        tmp = f"{path}.reconcile.tmp"
        self.primary.mkdirs(_parent(path))
        _copy_file(self.fallback, path, self.primary, tmp)
        self.primary.durable_rename(tmp, path)
        try:
            self.fallback.delete(path)
        except OSError:
            logger.warning("failover: fallback copy of %s not deletable; "
                           "left in place (duplicate, never wrong)", path)

    def _quarantine_spill(self, path: str, errors) -> str:
        qdir = f"{_parent(path)}/quarantine"
        self.fallback.mkdirs(qdir)
        name = path.rsplit("/", 1)[-1]
        dest = f"{qdir}/{name}"
        seq = 0
        while self.fallback.exists(dest):
            seq += 1
            dest = f"{qdir}/{name}.{seq}"
        self.fallback.rename(path, dest)
        with self._lock:
            self._quarantined.append({"path": path, "quarantined_to": dest,
                                      "errors": list(errors)})
        return dest

    def _drop_spilled(self, path: str) -> None:
        with self._lock:
            try:
                self._spilled.remove(path)
            except ValueError:
                pass

    def _cleanup_spill_sources(self) -> None:
        """Best-effort removal of primary-side tmps a mid-publish salvage
        copy left behind (their contents were republished via the
        fallback, so they are plain duplicates)."""
        with self._lock:
            sources = list(self._spill_sources)
        for src in sources:
            try:
                if self.primary.exists(src):
                    self.primary.delete(src)
            except OSError:
                continue
            with self._lock:
                try:
                    self._spill_sources.remove(src)
                except ValueError:
                    pass


def _copy_file(src_fs: FileSystem, src: str, dst_fs: FileSystem,
               dst: str) -> None:
    with src_fs.open_read(src) as fin:
        data = fin.read()
    with dst_fs.open_write(dst) as fout:
        fout.write(data)
