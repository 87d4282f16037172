"""Filesystem abstraction: the subset of the Hadoop ``FileSystem`` API the
reference uses (mkdirs / create / atomic rename / list — KPW.java:359-378,
test utils HdfsTestUtil.java:79-91), with two implementations:

* :class:`LocalFileSystem` — posix dirs/files; `os.replace` is the atomic
  publish.
* :class:`MemoryFileSystem` — in-process page store standing in for HDFS the
  way MiniDFSCluster does in the reference tests (SURVEY.md §4 rebuild
  mapping), with the same atomic-rename semantics.
"""

from __future__ import annotations

import io
import os
import threading


class FileSystem:
    # capability seam: rename-capable filesystems (posix, HDFS, the
    # in-memory analog) publish via (durable_)rename; an object-store
    # sink has no rename — it flips this False and implements
    # publish_commit (multipart-complete / atomic PUT at the destination
    # key).  publish_file() below is the ONE decision point every
    # publish path (worker, process child, compactor) routes through.
    supports_rename = True

    def mkdirs(self, path: str) -> None:
        raise NotImplementedError

    def publish_commit(self, src: str, dst: str) -> None:
        """Atomic publish for rename-less filesystems (object stores):
        make the staged file at ``src`` visible at ``dst`` in one store
        operation.  Only meaningful when ``supports_rename`` is False —
        NOT an abstract member of the surface: rename-capable
        filesystems never implement it (publish_file routes them through
        the rename protocol), so calling it on one is a caller bug, not
        a missing override.  Deliberately not an OSError: the retry
        layer must never spin on a protocol-dispatch mistake."""
        raise TypeError(
            "this filesystem publishes by rename (supports_rename=True); "
            "publish via io.fs.publish_file, which dispatches on the "
            "capability")

    def open_write(self, path: str):
        """Create (overwrite) a file for binary writing."""
        raise NotImplementedError

    def open_append(self, path: str):
        """Open for binary appending (creating if missing) — existing
        contents are never truncated, so a failed append can lose at most
        the new tail (the dead-letter durability requirement)."""
        raise NotImplementedError

    def open_read(self, path: str):
        raise NotImplementedError

    def rename(self, src: str, dst: str) -> None:
        """Atomic move; parent of dst must exist."""
        raise NotImplementedError

    def sync(self, path: str) -> None:
        """Force ``path``'s contents to stable storage (fsync).  A plain
        close() only hands the bytes to the OS page cache — they survive a
        process kill but NOT a machine crash/power cut.  Implementations
        whose close IS durable (MemoryFileSystem's atomic store publish,
        HDFS pipeline close) no-op."""
        raise NotImplementedError

    def sync_dir(self, path: str) -> None:
        """Force the DIRECTORY ENTRY updates under ``path`` (a rename's new
        name, a create) to stable storage.  POSIX makes this a separate
        fsync on the directory fd; filesystems without that distinction
        no-op."""
        raise NotImplementedError

    def durable_rename(self, src: str, dst: str) -> None:
        """Crash-consistent publish: fsync the file, atomically rename it,
        then fsync the destination's parent directory — the full
        fsync-before-rename + dir-fsync discipline, so after this returns
        the published file survives kill -9 AND power loss.  One default
        composition over the three primitives; wrappers that intercept
        sync/rename (fault injection) inherit the decomposed ops.

        Retry-safe for the SAME (src, dst) pair: unlike a bare rename, this
        can fail AFTER the rename landed (the trailing dir fsync), so a
        retried call finds src gone and dst present — it resumes at the
        pending dir fsync instead of raising ENOENT on the fsync of a file
        that was already published."""
        if self.exists(src):
            self.sync(src)
            self.rename(src, dst)
        elif not self.exists(dst):
            raise FileNotFoundError(src)
        self.sync_dir(dst.rsplit("/", 1)[0] if "/" in dst else ".")

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def size(self, path: str) -> int:
        raise NotImplementedError

    def list_files(self, path: str, extension: str | None = None,
                   recursive: bool = True) -> list[str]:
        raise NotImplementedError


def publish_file(fs: FileSystem, src: str, dst: str,
                 durable: bool = True) -> None:
    """THE publish decision point (the capability seam): every
    publish path — thread worker, process-mode child, compactor merge,
    compactor write-ahead plan — calls this, so the protocol choice
    cannot drift between them.

    * ``fs.supports_rename`` (posix/HDFS/memory): the historical
      tmp→rename protocol — ``durable_rename`` (fsync + rename + dir
      fsync) when ``durable``, plain atomic ``rename`` otherwise.
    * object-store sinks (``supports_rename = False``): multipart
      ``publish_commit`` — visibility flips when the store completes the
      staged upload at the destination key; there is no fsync to issue,
      so ``durable`` is moot (complete IS the durability point).

    Both branches are retry-safe for the same (src, dst) pair: the
    rename branch resumes at the pending dir fsync, the commit branch
    returns when the destination already materialized."""
    if getattr(fs, "supports_rename", True):
        if durable:
            fs.durable_rename(src, dst)
        else:
            fs.rename(src, dst)
    else:
        fs.publish_commit(src, dst)


class LocalFileSystem(FileSystem):
    def mkdirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def open_write(self, path: str):
        return open(path, "wb")

    def open_append(self, path: str):
        return open(path, "ab")

    def open_read(self, path: str):
        return open(path, "rb")

    def rename(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def sync(self, path: str) -> None:
        # O_RDONLY is enough to fsync file DATA on linux; no O_RDWR needed
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def sync_dir(self, path: str) -> None:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def delete(self, path: str) -> None:
        os.remove(path)

    def size(self, path: str) -> int:
        return os.path.getsize(path)

    def list_files(self, path: str, extension: str | None = None,
                   recursive: bool = True) -> list[str]:
        out = []
        if not os.path.isdir(path):
            return out
        if recursive:
            for root, _dirs, files in os.walk(path):
                for f in files:
                    out.append(os.path.join(root, f))
        else:
            out = [os.path.join(path, f) for f in os.listdir(path)
                   if os.path.isfile(os.path.join(path, f))]
        if extension is not None:
            out = [f for f in out if f.endswith(extension)]
        return sorted(out)


class _MemFile(io.BytesIO):
    """BytesIO that publishes its contents to the store on close.  In
    append mode the buffer is seeded with the existing contents and the
    whole value republishes atomically under the store lock."""

    def __init__(self, fs: "MemoryFileSystem", path: str,
                 append: bool = False) -> None:
        super().__init__()
        self._fs = fs
        self._path = path
        if append:
            existing = fs._store_get(path)
            if existing:
                self.write(existing)

    def close(self) -> None:
        self._fs._store_put(self._path, self.getvalue())
        super().close()


class MemoryFileSystem(FileSystem):
    """In-memory FS with directory semantics and atomic rename."""

    def __init__(self) -> None:
        self._files: dict[str, bytes] = {}
        self._dirs: set[str] = {"/"}
        self._lock = threading.RLock()

    @staticmethod
    def _norm(path: str) -> str:
        out = os.path.normpath("/" + path.lstrip("/"))
        return out

    def _store_put(self, path: str, data: bytes) -> None:
        with self._lock:
            self._files[self._norm(path)] = data

    def _store_get(self, path: str) -> bytes:
        with self._lock:
            return self._files.get(self._norm(path), b"")

    def mkdirs(self, path: str) -> None:
        with self._lock:
            p = self._norm(path)
            while p not in self._dirs:
                self._dirs.add(p)
                p = os.path.dirname(p)

    def open_write(self, path: str):
        return _MemFile(self, path)

    def open_append(self, path: str):
        return _MemFile(self, path, append=True)

    def open_read(self, path: str):
        with self._lock:
            return io.BytesIO(self._files[self._norm(path)])

    def rename(self, src: str, dst: str) -> None:
        with self._lock:
            s, d = self._norm(src), self._norm(dst)
            if s not in self._files:
                raise FileNotFoundError(src)
            if os.path.dirname(d) not in self._dirs:
                raise FileNotFoundError(f"parent dir missing: {dst}")
            self._files[d] = self._files.pop(s)

    def sync(self, path: str) -> None:
        # the store IS stable storage here; still raise on a missing file so
        # durability bugs (sync before close, wrong path) surface in tests
        with self._lock:
            if self._norm(path) not in self._files:
                raise FileNotFoundError(path)

    def sync_dir(self, path: str) -> None:
        with self._lock:
            p = self._norm(path)
            if p not in self._dirs:
                raise FileNotFoundError(path)

    def exists(self, path: str) -> bool:
        with self._lock:
            p = self._norm(path)
            return p in self._files or p in self._dirs

    def delete(self, path: str) -> None:
        with self._lock:
            p = self._norm(path)
            if p not in self._files:
                raise FileNotFoundError(path)  # match LocalFileSystem
            del self._files[p]

    def size(self, path: str) -> int:
        with self._lock:
            return len(self._files[self._norm(path)])

    def list_files(self, path: str, extension: str | None = None,
                   recursive: bool = True) -> list[str]:
        with self._lock:
            prefix = self._norm(path).rstrip("/") + "/"
            out = []
            for p in self._files:
                if not p.startswith(prefix):
                    continue
                rest = p[len(prefix):]
                if not recursive and "/" in rest:
                    continue
                if extension is not None and not p.endswith(extension):
                    continue
                out.append(p)
            return sorted(out)
