"""Object-store tier: emulated S3/GCS-class store + multipart FileSystem
adapter with upload-hidden-under-encode pipelining.

Production fleets publish to object stores, not local disks, and object
stores have none of the primitives the posix publish protocol leans on:
no atomic rename, no fsync, no append — what they have instead is
*multipart upload* (create → upload parts → complete), whose ``complete``
is the atomic visibility point, plus per-request costs and throttling
("Towards an Arrow-native Storage System", PAPERS.md).  This module makes
that target real enough to prove the writer's contracts against:

* :class:`EmulatedObjectStore` — an in-process store with buckets,
  objects, multipart create/upload-part/complete/abort, list-with-prefix,
  request + byte accounting, configurable per-request latency, and an
  optional fault schedule consulted per request (op names
  ``objstore.put|get|head|delete|copy|list|create_multipart|upload_part|
  complete|abort`` — the 503/throttle/slow-part/complete-fails persona of
  ``io/faults.py`` fires here).
* :class:`ObjectStoreFileSystem` — a :class:`~kpw_tpu_torch.io.fs.FileSystem`
  adapter whose "atomic publish" is **multipart-complete instead of
  rename** (``supports_rename = False`` + :meth:`publish_commit`, routed
  through the single ``io/fs.py`` ``publish_file`` decision point shared
  by the worker and the compactor).  ``open_write`` streams full parts to
  a background part-uploader **while the file is still open** (the
  ``upload.part`` stage; the same overlap trick as ``--hostasm``), so on
  close only the tail part remains and the publish is one ``complete``
  call.  Generic ``rename`` (compactor retire/tombstone/quarantine) is
  server-side copy + delete — it works, it is just not atomic and costs
  two requests, which the accounting makes visible.
* :class:`BandwidthBudget` / :class:`BandwidthBudgetedFileSystem` — a
  token-bucket bytes/s budget shared across reads and writes plus
  request-count accounting, the Compactor's remote tier
  (``Builder.compaction(bandwidth_bytes_per_s=...)``).

Emulator relaxations vs real S3, both documented where they matter: (1)
``complete_multipart`` accepts the final key at *complete* time (S3 fixes
it at create; a real adapter names the upload at file-open from the same
publish-name pattern — the protocol is otherwise identical), and (2) a
sealed-but-uncompleted upload's bytes can be read back
(:meth:`EmulatedObjectStore.pending_part_bytes`) so verify-before-publish
works; a production adapter verifies its local staging buffer instead.
The write handle retains the file bytes until it seals (the seek-back
retry protocol of ``core/writer.py`` can rewind into already-shipped
parts, which are then re-uploaded under the same part number — last
upload of a part number wins, exactly S3's semantics).  Retention is
spill-bounded: past ``spill_threshold_bytes`` the retained bytes roll
to an anonymous local tmp file (:class:`_RetainedBuffer`) so handle
memory stays bounded at GiB-rotation scale, released at seal.
"""

from __future__ import annotations

import io
import logging
import os
import queue
import threading
import time
from collections import deque

from ..utils import schedcheck
from ..utils.tracing import stage
from .fs import FileSystem

logger = logging.getLogger(__name__)


class _Upload:
    """One in-progress multipart upload, server side."""

    __slots__ = ("upload_id", "bucket", "key", "parts")

    def __init__(self, upload_id: str, bucket: str, key: str) -> None:
        self.upload_id = upload_id
        self.bucket = bucket
        self.key = key
        self.parts: dict[int, bytes] = {}  # part number (1-based) -> bytes


class EmulatedObjectStore:
    """In-process S3/GCS-class object store.

    Parameters
    ----------
    latency_s:
        Simulated per-request latency (every request sleeps this long
        before touching store state) — the knob that makes the network
        leg cost real time in benchmarks.
    min_part_size:
        Multipart parts below this size are rejected at ``complete``
        unless they are the last part (S3's 5 MiB rule; 0 disables).
    schedule:
        Optional fault schedule (duck-typed ``check(op)`` — an
        ``io/faults.py`` ``FaultSchedule``) consulted once per request
        under op names ``objstore.<op>``; a raising rule models a 503 /
        throttle response, a delay rule a slow part.
    """

    def __init__(self, *, latency_s: float = 0.0, min_part_size: int = 0,
                 schedule=None) -> None:
        self.latency_s = latency_s
        self.min_part_size = min_part_size
        self._schedule = schedule
        self._lk = threading.Lock()
        self._buckets: set[str] = set()
        self._objects: dict[tuple[str, str], bytes] = {}
        self._uploads: dict[str, _Upload] = {}
        self._next_id = 0
        # accounting: per-op request counts, bytes in/out of the store,
        # multipart part/abort/complete tallies, and a rolling byte window
        # for the observed-bandwidth gauge
        self._requests: dict[str, int] = {}
        self._bytes_in = 0
        self._bytes_out = 0
        self._parts_uploaded = 0
        self._aborted = 0
        self._completed = 0
        self._recent: deque = deque()  # (monotonic t, nbytes)
        self._observers: list = []

    # -- plumbing ------------------------------------------------------------
    def add_observer(self, fn) -> None:
        """``fn(op, nbytes)`` called after every request (outside the
        store lock) — the adapter's canonical-meter feed."""
        with self._lk:
            self._observers.append(fn)

    def _request(self, op: str, nbytes: int = 0,
                 inbound: bool = True) -> None:
        """One store request: fault schedule first (a covered ordinal
        raises/stalls exactly like a server 503/slow response), then the
        simulated latency, then the accounting.  A faulted request
        mutates nothing — callers account before they mutate."""
        if self._schedule is not None:
            self._schedule.check(f"objstore.{op}")
        if self.latency_s > 0.0:
            time.sleep(self.latency_s)
        now = time.monotonic()
        with self._lk:
            self._requests[op] = self._requests.get(op, 0) + 1
            if nbytes:
                if inbound:
                    self._bytes_in += nbytes
                else:
                    self._bytes_out += nbytes
                self._recent.append((now, nbytes))
                while self._recent and self._recent[0][0] < now - 30.0:
                    self._recent.popleft()
            observers = list(self._observers)
        for fn in observers:
            fn(op, nbytes)

    def _bucket_check(self, bucket: str) -> None:
        if bucket not in self._buckets:
            raise FileNotFoundError(f"no such bucket: {bucket}")

    # -- buckets + objects ---------------------------------------------------
    def create_bucket(self, name: str) -> None:
        with self._lk:
            self._buckets.add(name)

    def put_object(self, bucket: str, key: str, data: bytes) -> None:
        self._request("put", len(data))
        with self._lk:
            self._bucket_check(bucket)
            self._objects[(bucket, key)] = bytes(data)

    def get_object(self, bucket: str, key: str) -> bytes:
        with self._lk:
            self._bucket_check(bucket)
            data = self._objects.get((bucket, key))
        if data is None:
            raise FileNotFoundError(f"{bucket}/{key}")
        self._request("get", len(data), inbound=False)
        return data

    def head_object(self, bucket: str, key: str) -> int | None:
        """Object size, or None when absent (a HEAD is a billed request
        either way — existence probes cost money on a real store)."""
        self._request("head")
        with self._lk:
            data = self._objects.get((bucket, key))
            return len(data) if data is not None else None

    def delete_object(self, bucket: str, key: str) -> None:
        self._request("delete")
        with self._lk:
            if (bucket, key) not in self._objects:
                raise FileNotFoundError(f"{bucket}/{key}")
            del self._objects[(bucket, key)]

    def copy_object(self, bucket: str, src: str, dst: str) -> None:
        """Server-side copy: one request, no client byte transfer."""
        self._request("copy")
        with self._lk:
            data = self._objects.get((bucket, src))
            if data is None:
                raise FileNotFoundError(f"{bucket}/{src}")
            self._objects[(bucket, dst)] = data

    def list_objects(self, bucket: str,
                     prefix: str = "") -> list[tuple[str, int]]:
        self._request("list")
        with self._lk:
            return sorted((k, len(v)) for (b, k), v in self._objects.items()
                          if b == bucket and k.startswith(prefix))

    # -- multipart -----------------------------------------------------------
    def create_multipart(self, bucket: str, key: str) -> str:
        self._request("create_multipart")
        with self._lk:
            self._bucket_check(bucket)
            self._next_id += 1
            uid = f"mp-{self._next_id}"
            self._uploads[uid] = _Upload(uid, bucket, key)
            return uid

    def upload_part(self, upload_id: str, part_number: int,
                    data: bytes) -> None:
        """Upload (or RE-upload — last write of a part number wins, the
        S3 semantics the retry protocol leans on) one part."""
        if part_number < 1:
            raise ValueError("part numbers are 1-based")
        self._request("upload_part", len(data))
        with self._lk:
            up = self._uploads.get(upload_id)
            if up is None:
                raise FileNotFoundError(f"no such upload: {upload_id}")
            up.parts[part_number] = bytes(data)
            self._parts_uploaded += 1

    def complete_multipart(self, upload_id: str,
                           final_key: str | None = None) -> str:
        """Atomic publish: the object materializes under ``final_key``
        (default: the creation key) in one step, and the upload is gone.
        Parts must be contiguous from 1 and respect ``min_part_size``
        (except the last).  Emulator relaxation, documented in the module
        docstring: real S3 fixes the key at create."""
        self._request("complete")
        with self._lk:
            up = self._uploads.get(upload_id)
            if up is None:
                raise FileNotFoundError(f"no such upload: {upload_id}")
            nums = sorted(up.parts)
            if nums != list(range(1, len(nums) + 1)):
                raise ValueError(
                    f"multipart {upload_id}: non-contiguous parts {nums}")
            if self.min_part_size:
                for n in nums[:-1]:
                    if len(up.parts[n]) < self.min_part_size:
                        raise ValueError(
                            f"part {n} below min_part_size "
                            f"({len(up.parts[n])} < {self.min_part_size})")
            key = final_key if final_key is not None else up.key
            self._objects[(up.bucket, key)] = b"".join(
                up.parts[n] for n in nums)
            del self._uploads[upload_id]
            self._completed += 1
            return key

    def abort_multipart(self, upload_id: str) -> None:
        self._request("abort")
        with self._lk:
            if upload_id not in self._uploads:
                raise FileNotFoundError(f"no such upload: {upload_id}")
            del self._uploads[upload_id]
            self._aborted += 1

    def list_multipart_uploads(
            self, bucket: str,
            prefix: str = "") -> list[tuple[str, str, int, int]]:
        """Orphan discovery: ``(key, upload_id, n_parts, n_bytes)`` of
        every in-progress upload under the prefix."""
        self._request("list")
        with self._lk:
            return sorted(
                (u.key, u.upload_id, len(u.parts),
                 sum(len(p) for p in u.parts.values()))
                for u in self._uploads.values()
                if u.bucket == bucket and u.key.startswith(prefix))

    def upload_at(self, bucket: str, key: str) -> str | None:
        """The upload_id of an in-progress upload staged at ``key`` (no
        request accounting: recovery bookkeeping over state the adapter
        would normally hold client-side)."""
        with self._lk:
            for u in self._uploads.values():
                if u.bucket == bucket and u.key == key:
                    return u.upload_id
            return None

    def pending_part_bytes(self, upload_id: str) -> bytes:
        """Concatenated staged parts of an uncompleted upload — the
        emulator stand-in for the local staging buffer a real adapter
        verifies before publish (real S3 cannot read uncompleted parts).
        No request accounting for the same reason."""
        with self._lk:
            up = self._uploads.get(upload_id)
            if up is None:
                raise FileNotFoundError(f"no such upload: {upload_id}")
            nums = sorted(up.parts)
            return b"".join(up.parts[n] for n in nums)

    def pending_size(self, upload_id: str) -> int:
        with self._lk:
            up = self._uploads.get(upload_id)
            if up is None:
                raise FileNotFoundError(f"no such upload: {upload_id}")
            return sum(len(p) for p in up.parts.values())

    # -- accounting ----------------------------------------------------------
    def observed_bytes_per_s(self, window_s: float = 5.0) -> float:
        """Bytes moved through the store over the trailing window — the
        ``parquet.writer.objstore.bandwidth`` gauge's provider."""
        now = time.monotonic()
        with self._lk:
            total = sum(n for t, n in self._recent if t >= now - window_s)
        return total / window_s

    def stats(self) -> dict:
        with self._lk:
            return {
                "requests_by_op": dict(sorted(self._requests.items())),
                "requests_total": sum(self._requests.values()),
                "bytes_in": self._bytes_in,
                "bytes_out": self._bytes_out,
                "parts_uploaded": self._parts_uploaded,
                "multipart_completed": self._completed,
                "multipart_aborted": self._aborted,
                "multipart_pending": len(self._uploads),
                "objects": len(self._objects),
                "latency_s": self.latency_s,
            }


class _Pending:
    """One staged-but-unpublished file, adapter side: either a sealed
    small object (``single_data``) or a multipart upload whose parts are
    on the server and whose ``complete`` is deferred to the publish."""

    __slots__ = ("key", "upload_id", "n_parts", "size", "single_data",
                 "sealed", "async_s", "inflight", "failed_low", "error")

    def __init__(self, key: str) -> None:
        self.key = key
        self.upload_id: str | None = None
        self.n_parts = 0
        self.size = 0
        self.single_data: bytes | None = None
        self.sealed = False
        # upload-pipelining accounting: seconds of background part
        # uploads, in-flight background tasks, and the lowest part number
        # whose background upload failed (close re-ships from there)
        self.async_s = 0.0
        self.inflight = 0
        self.failed_low: int | None = None
        self.error: BaseException | None = None


class _RetainedBuffer:
    """The write handle's retained file bytes, spill-bounded: an
    in-memory bytearray until ``spill_threshold_bytes``, then rolled to
    an anonymous local tmp file (``tempfile.TemporaryFile`` — unlinked
    at creation, gone on process death) so the handle's memory stays
    bounded at GiB-rotation scale while seek-back rewrites into shipped
    territory and close-time re-ships stay byte-perfect (random
    ``write_at`` + ranged ``read`` work identically in both modes;
    sparse seek-ahead gaps read back as zeros either way).  ``None``
    threshold = never spill (the pre-spill behavior, byte for byte)."""

    __slots__ = ("_threshold", "_mem", "_file", "_size", "spilled",
                 "_on_spill")

    def __init__(self, threshold: int | None, on_spill=None) -> None:
        self._threshold = threshold
        self._mem: bytearray | None = bytearray()
        self._file = None
        self._size = 0
        self.spilled = False
        self._on_spill = on_spill

    def __len__(self) -> int:
        return self._size

    def _roll(self) -> None:
        import tempfile

        f = tempfile.TemporaryFile(prefix="kpw-objstore-spill-")
        f.write(bytes(self._mem))
        self._file = f
        self._mem = None
        self.spilled = True
        if self._on_spill is not None:
            self._on_spill()

    def write_at(self, pos: int, b: bytes) -> None:
        if self._file is None:
            mem = self._mem
            if pos > len(mem):  # sparse seek-ahead: zero-fill the gap
                mem.extend(b"\x00" * (pos - len(mem)))
            mem[pos:pos + len(b)] = b
            self._size = len(mem)
            if self._threshold is not None and self._size > self._threshold:
                self._roll()
        else:
            # a write past EOF leaves a hole that reads back as zeros —
            # the same sparse-gap semantics as the bytearray mode
            self._file.seek(pos)
            self._file.write(b)
            self._size = max(self._size, pos + len(b))

    def read(self, start: int, end: int) -> bytes:
        end = min(end, self._size)
        if start >= end:
            return b""
        if self._file is None:
            return bytes(self._mem[start:end])
        self._file.seek(start)
        return self._file.read(end - start)

    def to_bytes(self) -> bytes:
        return self.read(0, self._size)

    def release(self) -> None:
        """Drop the retained bytes (close the spill file / free the
        bytearray) once every byte is on the server — after seal, the
        handle can never be asked to re-ship."""
        f, self._file = self._file, None
        self._mem = bytearray()
        if f is not None:
            f.close()


class _ObjectWriteFile:
    """Write handle over the adapter: buffers the file locally, streams
    completed ``part_size`` slices to the background uploader while the
    producer keeps encoding (upload hides under encode), and seals — tail
    part uploaded, ``complete`` deferred — at close.  Supports
    ``seek``/``tell`` so the core writer's positioned retry protocol
    works: a rewind into an already-shipped part marks it dirty and close
    re-uploads it under the same part number (last write wins).

    Background upload failures never surface mid-write: the handle keeps
    the bytes, notes the lowest failed part, and close re-ships
    synchronously inside the worker's retried ``close`` seam.  The
    retained bytes are SPILL-BOUNDED (``spill_threshold_bytes`` on the
    adapter): past the threshold they live in an anonymous local tmp
    file instead of memory (:class:`_RetainedBuffer`), released once the
    handle seals."""

    def __init__(self, fs: "ObjectStoreFileSystem", path: str) -> None:
        self._fs = fs
        self._path = path
        self._data = _RetainedBuffer(fs.spill_threshold_bytes,
                                     on_spill=fs._note_spill)
        self._pos = 0
        self._clean_parts = 0  # parts 1..n uploaded and not overwritten
        self._pending = _Pending(fs._key(path))
        self._closed = False
        fs._register_pending(path, self._pending)

    # -- file protocol -------------------------------------------------------
    def write(self, data) -> int:
        b = bytes(data)
        pos = self._pos
        self._data.write_at(pos, b)
        self._pos = pos + len(b)
        if pos < self._clean_parts * self._fs.part_size:
            # rewind-overwrite into shipped territory: those parts are
            # dirty; close re-uploads them under the same part numbers
            self._clean_parts = pos // self._fs.part_size
        self._ship_full_parts()
        return len(b)

    def writelines(self, parts) -> None:
        for p in parts:
            self.write(p)

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == 1:
            pos += self._pos
        elif whence == 2:
            pos += len(self._data)
        if pos < 0:
            raise OSError("negative seek position")
        self._pos = pos
        return pos

    def tell(self) -> int:
        return self._pos

    def flush(self) -> None:
        pass  # durability is complete/put semantics, not flush

    def _part_bytes(self, idx: int) -> bytes:
        ps = self._fs.part_size
        return self._data.read(idx * ps, (idx + 1) * ps)

    def _ship_full_parts(self) -> None:
        """Hand every newly-completed part_size slice to the uploader
        (pipelined) or upload it inline (pipelining off — the baseline
        arm the overlap accounting compares against)."""
        fs = self._fs
        p = self._pending
        while (self._clean_parts + 1) * fs.part_size <= len(self._data):
            idx = self._clean_parts
            if p.upload_id is None:
                p.upload_id = fs.store.create_multipart(fs.bucket, p.key)
            data = self._part_bytes(idx)
            self._clean_parts = idx + 1
            if fs.pipeline_uploads:
                fs._submit_part(p, idx + 1, data)
            else:
                t0 = time.perf_counter()
                try:
                    with stage("upload.part"):
                        fs.store.upload_part(p.upload_id, idx + 1, data)
                except OSError as e:
                    # deferred like the background path: the bytes are
                    # retained, close re-ships from here
                    logger.warning("inline part upload failed (%r); close "
                                   "re-ships part %d", e, idx + 1)
                    with fs._mu:
                        p.failed_low = (idx + 1 if p.failed_low is None
                                        else min(p.failed_low, idx + 1))
                fs._note_sync_upload(time.perf_counter() - t0)

    def close(self) -> None:
        """Seal: wait out background parts, re-ship failures + the tail
        part synchronously, record the overlap accounting.  ``complete``
        is NOT called — that is the publish (``publish_commit``) or the
        materialize-on-read fallback.  Safe to retry: a raise leaves the
        handle open with all bytes retained."""
        if self._closed:
            return
        fs = self._fs
        p = self._pending
        t0 = time.perf_counter()
        total = len(self._data)
        if p.upload_id is None and total < fs.part_size:
            # small file: stage locally, publish is a single PUT
            p.single_data = self._data.to_bytes()
            p.size = total
            p.sealed = True
            self._closed = True
            self._data.release()
            fs._note_overlap(p, exposed_s=0.0)
            return
        with fs._mu:
            while p.inflight > 0:
                fs._cv.wait(timeout=0.1)
            if p.failed_low is not None:
                self._clean_parts = min(self._clean_parts, p.failed_low - 1)
                p.failed_low = None
                p.error = None
        if p.upload_id is None:
            p.upload_id = fs.store.create_multipart(fs.bucket, p.key)
        n_parts = max(1, (total + fs.part_size - 1) // fs.part_size)
        # close-time uploads (failed-part re-ships + the tail part) count
        # into upload_total_s like every other part upload — they are the
        # EXPOSED share of it; accrued in a finally so a raise that the
        # worker's close retry will resume still books the time spent
        t_up0 = time.perf_counter()
        try:
            for idx in range(self._clean_parts, n_parts):
                with stage("upload.part"):
                    fs.store.upload_part(p.upload_id, idx + 1,
                                         self._part_bytes(idx))
                self._clean_parts = idx + 1
        finally:
            fs._note_close_upload(time.perf_counter() - t_up0)
        p.n_parts = n_parts
        p.size = total
        p.sealed = True
        self._closed = True
        # every byte is on the server now: drop the retained buffer (and
        # its spill file, when the handle rolled past the threshold)
        self._data.release()
        fs._note_overlap(p, exposed_s=time.perf_counter() - t0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _AppendFile(io.BytesIO):
    """Read-modify-PUT append handle: object stores cannot append, so
    the whole object republishes at close (last writer wins — fine for
    the dead-letter files this path serves, whose frames are
    self-delimiting)."""

    def __init__(self, fs: "ObjectStoreFileSystem", path: str) -> None:
        super().__init__()
        self._fs = fs
        self._path = path
        try:
            self.write(fs.store.get_object(fs.bucket, fs._key(path)))
        except FileNotFoundError:
            pass  # lint: swallowed-exceptions ok — append-create of a
            # missing object starts empty by contract

    def close(self) -> None:
        self._fs.store.put_object(self._fs.bucket,
                                  self._fs._key(self._path),
                                  self.getvalue())
        super().close()


class ObjectStoreFileSystem(FileSystem):
    """FileSystem adapter over an :class:`EmulatedObjectStore` bucket.

    The capability seam: ``supports_rename = False`` routes every publish
    through :meth:`publish_commit` (multipart-complete / atomic PUT at
    the destination key) instead of ``durable_rename`` — see
    ``io/fs.py`` ``publish_file``, the one decision point the worker,
    process children and the compactor share.  ``sync``/``sync_dir`` are
    no-ops (durability is a property of ``complete``/``put``, there is no
    page cache to flush) and ``mkdirs`` is a no-op (there are no
    directories, only key prefixes)."""

    supports_rename = False

    def __init__(self, store: EmulatedObjectStore, bucket: str, *,
                 part_size: int = 8 * 1024 * 1024,
                 pipeline_uploads: bool = True,
                 spill_threshold_bytes: int | None = None,
                 registry=None) -> None:
        if part_size < 4096:
            raise ValueError("part_size must be >= 4096")
        if store.min_part_size and part_size < store.min_part_size:
            raise ValueError(
                f"part_size {part_size} below the store's min_part_size "
                f"{store.min_part_size}")
        if spill_threshold_bytes is not None and spill_threshold_bytes < 4096:
            raise ValueError("spill_threshold_bytes must be >= 4096")
        self.store = store
        self.bucket = bucket
        store.create_bucket(bucket)
        self.part_size = int(part_size)
        self.pipeline_uploads = bool(pipeline_uploads)
        # spill-to-disk bound for each write handle's retained buffer:
        # past this many bytes a handle's
        # retained file bytes roll to an anonymous local tmp file so
        # memory stays bounded at GiB-rotation scale.  None = retain in
        # memory (historical behavior).
        self.spill_threshold_bytes = (int(spill_threshold_bytes)
                                      if spill_threshold_bytes is not None
                                      else None)
        self._spilled_handles = 0
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._pending: dict[str, _Pending] = {}  # norm path -> staged file
        self._q: queue.Queue | None = None
        self._uploader: threading.Thread | None = None
        # overlap accounting (stats()['objectstore']['upload']): seconds
        # of part-upload work hidden under the open file vs exposed at
        # close, across sealed files
        self._hidden_s = 0.0
        self._exposed_s = 0.0
        self._upload_total_s = 0.0
        self._sync_upload_s = 0.0
        self._files_sealed = 0
        self._published_multipart = 0
        self._published_put = 0
        # canonical meters (runtime/metrics.py names); re-bound to a real
        # registry by the writer via bind_registry
        from ..runtime import metrics as M

        self._m_requests = (registry.meter(M.OBJSTORE_REQUESTS_METER)
                            if registry else M.Meter())
        self._m_bytes = (registry.meter(M.OBJSTORE_BYTES_METER)
                         if registry else M.Meter())
        self._m_parts = (registry.meter(M.OBJSTORE_PARTS_METER)
                         if registry else M.Meter())
        self._m_aborted = (registry.meter(M.OBJSTORE_ABORTED_METER)
                           if registry else M.Meter())
        # the store-request observer is attached only when a registry is
        # bound: observers are not removable, and recovery/verify flows
        # routinely build short-lived adapters over one long-lived store
        # — unconditional registration would accumulate a dead callback
        # (pinning the adapter) per construction forever
        self._observer_attached = False
        if registry is not None:
            registry.gauge(M.OBJSTORE_BANDWIDTH_GAUGE,
                           self.store.observed_bytes_per_s)
            self._attach_observer()

    def _attach_observer(self) -> None:
        if not self._observer_attached:
            self._observer_attached = True
            # lint: resource-pairing ok — observers are deliberately not
            # removable; attachment is once per adapter (gated by
            # _observer_attached) and only for registry-bound adapters,
            # so recovery/verify flows
            # building short-lived adapters attach nothing
            self.store.add_observer(self._on_store_request)

    def bind_registry(self, registry) -> None:
        """Re-point the canonical object-store meters + bandwidth gauge
        at a writer's registry (called from the writer constructor so
        both exporters render them with no per-metric wiring)."""
        from ..runtime import metrics as M

        self._m_requests = registry.meter(M.OBJSTORE_REQUESTS_METER)
        self._m_bytes = registry.meter(M.OBJSTORE_BYTES_METER)
        self._m_parts = registry.meter(M.OBJSTORE_PARTS_METER)
        self._m_aborted = registry.meter(M.OBJSTORE_ABORTED_METER)
        registry.gauge(M.OBJSTORE_BANDWIDTH_GAUGE,
                       self.store.observed_bytes_per_s)
        self._attach_observer()

    def _on_store_request(self, op: str, nbytes: int) -> None:
        self._m_requests.mark()
        if nbytes:
            self._m_bytes.mark(nbytes)
        if op == "upload_part":
            self._m_parts.mark()
        elif op == "abort":
            self._m_aborted.mark()

    # -- path plumbing -------------------------------------------------------
    @staticmethod
    def _norm(path: str) -> str:
        return os.path.normpath("/" + path.lstrip("/"))

    def _key(self, path: str) -> str:
        return self._norm(path).lstrip("/")

    def _register_pending(self, path: str, p: _Pending) -> None:
        with self._mu:
            self._pending[self._norm(path)] = p

    # -- background part uploader --------------------------------------------
    def _submit_part(self, p: _Pending, part_number: int,
                     data: bytes) -> None:
        self._ensure_uploader()
        with self._mu:
            p.inflight += 1
        self._q.put((p, part_number, data))

    def _ensure_uploader(self) -> None:
        # schedule-explorer edge: the concurrent-first-part spawn race
        # lives between this check and the start below — the singleton
        # probe on the spawn proves the lock closes the window
        schedcheck.point("objstore.uploader.ensure")
        with self._mu:
            if self._uploader is not None:
                return  # the loop never exits (daemon; no poison is sent)
            if self._q is None:
                self._q = queue.Queue()
            t = threading.Thread(target=self._uploader_loop,
                                 name="KPW-objstore-uploader", daemon=True)
            self._uploader = t
            # started INSIDE the lock: assign-then-start-outside let a
            # concurrent first-part submitter observe is_alive() False
            # and spawn a second loop on the same queue — two drainers
            # reorder a dirty re-upload behind its stale original
            schedcheck.note_uploader_spawn(id(self))
            t.start()

    def _uploader_loop(self) -> None:
        while True:
            task = self._q.get()
            if task is None:
                return
            p, pn, data = task
            t0 = time.perf_counter()
            try:
                with stage("upload.part"):
                    self.store.upload_part(p.upload_id, pn, data)
            except Exception as e:
                # recorded, not raised: the handle retains the bytes and
                # close re-ships from the lowest failed part inside the
                # worker's retried close seam
                logger.warning("background part upload %d failed: %r", pn, e)
                with self._mu:
                    p.error = e
                    p.failed_low = (pn if p.failed_low is None
                                    else min(p.failed_low, pn))
                    p.inflight -= 1
                    self._cv.notify_all()
                continue
            dt = time.perf_counter() - t0
            with self._mu:
                p.async_s += dt
                p.inflight -= 1
                self._upload_total_s += dt
                self._cv.notify_all()

    def _note_spill(self) -> None:
        with self._mu:
            self._spilled_handles += 1

    def _note_sync_upload(self, seconds: float) -> None:
        with self._mu:
            self._sync_upload_s += seconds
            self._upload_total_s += seconds

    def _note_close_upload(self, seconds: float) -> None:
        with self._mu:
            self._upload_total_s += seconds

    def _note_overlap(self, p: _Pending, exposed_s: float) -> None:
        """Fold one sealed file into the overlap accounting: background
        upload seconds minus the close-time exposure are the hidden
        (overlapped-under-encode) share; inline uploads (pipelining off)
        and the close-time wait + tail part are exposed."""
        with self._mu:
            hidden = max(0.0, p.async_s - exposed_s)
            self._hidden_s += hidden
            self._exposed_s += exposed_s
            self._files_sealed += 1

    # -- FileSystem surface --------------------------------------------------
    def mkdirs(self, path: str) -> None:
        pass  # no directories, only key prefixes

    def open_write(self, path: str):
        return _ObjectWriteFile(self, path)

    def open_append(self, path: str):
        return _AppendFile(self, path)

    def open_read(self, path: str):
        n = self._norm(path)
        with self._mu:
            p = self._pending.get(n)
        if p is not None and p.sealed:
            if p.single_data is not None:
                return io.BytesIO(p.single_data)
            return io.BytesIO(self.store.pending_part_bytes(p.upload_id))
        return io.BytesIO(self.store.get_object(self.bucket, self._key(n)))

    def _publish_pending(self, p: _Pending, dst_key: str) -> None:
        if not p.sealed:
            raise ValueError(f"pending upload for {p.key} is not sealed")
        if p.single_data is not None:
            self.store.put_object(self.bucket, dst_key, p.single_data)
            with self._mu:
                self._published_put += 1
        else:
            self.store.complete_multipart(p.upload_id, final_key=dst_key)
            with self._mu:
                self._published_multipart += 1

    def publish_commit(self, src: str, dst: str) -> None:
        """Atomic publish on a store with no rename: complete the staged
        multipart upload (or PUT the staged small object) at the
        DESTINATION key — visibility flips in one store operation, the
        object-store analog of the rename protocol's atomicity.  Retry
        safe for the same (src, dst) pair: if a previous attempt already
        completed (complete is the final op), the resumed call finds the
        destination present and returns."""
        s, d = self._norm(src), self._norm(dst)
        with self._mu:
            p = self._pending.pop(s, None)
        if p is None:
            if self.store.head_object(self.bucket, self._key(d)) is not None:
                return  # resumed retry: the complete already landed
            if self.store.head_object(self.bucket, self._key(s)) is not None:
                # the tmp was materialized by a read path: degrade to
                # copy + delete (2 requests, not atomic-at-dest — logged
                # so the protocol drift is visible)
                logger.warning("publish_commit of materialized tmp %s: "
                               "copy+delete fallback", src)
                self.store.copy_object(self.bucket, self._key(s),
                                       self._key(d))
                self.store.delete_object(self.bucket, self._key(s))
                return
            raise FileNotFoundError(src)
        try:
            self._publish_pending(p, self._key(d))
        except OSError:
            with self._mu:
                self._pending[s] = p  # transient: the retried call resumes
            raise

    def rename(self, src: str, dst: str) -> None:
        """Generic move (NOT the publish protocol): a staged pending file
        materializes at the destination; a stored object is server-side
        copy + delete — two billed requests and no atomicity, which is
        exactly why ``publish_file`` routes publishes through
        :meth:`publish_commit` instead."""
        s, d = self._norm(src), self._norm(dst)
        with self._mu:
            p = self._pending.pop(s, None)
        if p is not None:
            try:
                self._publish_pending(p, self._key(d))
            except OSError:
                with self._mu:
                    self._pending[s] = p
                raise
            return
        skey = self._key(s)
        if self.store.head_object(self.bucket, skey) is None:
            raise FileNotFoundError(src)
        self.store.copy_object(self.bucket, skey, self._key(d))
        self.store.delete_object(self.bucket, skey)

    def sync(self, path: str) -> None:
        # durability is a property of complete/put — nothing to flush,
        # but a missing path still surfaces (MemoryFileSystem parity)
        if not self.exists(path):
            raise FileNotFoundError(path)

    def sync_dir(self, path: str) -> None:
        pass  # no directory entries to sync

    def exists(self, path: str) -> bool:
        n = self._norm(path)
        key = self._key(n)
        with self._mu:
            if n in self._pending:
                return True
            # staged files under the prefix make a "directory" exist too
            if any(q.startswith(n.rstrip("/") + "/") for q in self._pending):
                return True
        if self.store.upload_at(self.bucket, key) is not None:
            return True
        # ONE billed LIST answers both questions — the exact key and the
        # directory-prefix probe (a HEAD followed by a trailing LIST
        # double-billed the common NEGATIVE file probe, e.g. the publish
        # collision loop's exists(dest) on every published file)
        listing = self.store.list_objects(self.bucket, key)
        if not key:  # the bucket root exists iff anything is in it
            return bool(listing)
        for k, _sz in listing:
            if k == key or k.startswith(key.rstrip("/") + "/"):
                return True
        return False

    def delete(self, path: str) -> None:
        """Delete an object — or ABORT a staged/orphaned multipart
        upload at this key (the tmp-sweep path: a crashed writer's
        in-progress upload is discarded, metered as aborted)."""
        n = self._norm(path)
        with self._mu:
            p = self._pending.pop(n, None)
        if p is not None:
            if p.upload_id is not None:
                self.store.abort_multipart(p.upload_id)
            return
        uid = self.store.upload_at(self.bucket, self._key(n))
        if uid is not None:
            self.store.abort_multipart(uid)
            return
        self.store.delete_object(self.bucket, self._key(n))

    def size(self, path: str) -> int:
        n = self._norm(path)
        with self._mu:
            p = self._pending.get(n)
        if p is not None:
            if p.single_data is not None:
                return len(p.single_data)
            if p.upload_id is not None:
                return self.store.pending_size(p.upload_id)
            return 0
        sz = self.store.head_object(self.bucket, self._key(n))
        if sz is None:
            uid = self.store.upload_at(self.bucket, self._key(n))
            if uid is not None:
                return self.store.pending_size(uid)
            raise FileNotFoundError(path)
        return sz

    def list_files(self, path: str, extension: str | None = None,
                   recursive: bool = True) -> list[str]:
        """Objects + staged pending files + ORPHANED multipart uploads
        under the prefix — orphans must be listable or the startup tmp
        sweep could never find (and abort) a crashed writer's upload."""
        prefix_n = self._norm(path).rstrip("/") + "/"
        prefix_k = prefix_n.lstrip("/")
        names = {f"/{k}" for k, _ in
                 self.store.list_objects(self.bucket, prefix_k)}
        names.update(f"/{k}" for k, _uid, _np, _nb in
                     self.store.list_multipart_uploads(self.bucket, prefix_k))
        with self._mu:
            names.update(q for q in self._pending if q.startswith(prefix_n))
        out = []
        for name in names:
            rest = name[len(prefix_n):]
            if not recursive and "/" in rest:
                continue
            if extension is not None and not name.endswith(extension):
                continue
            out.append(name)
        return sorted(out)

    # -- observability -------------------------------------------------------
    def objectstore_stats(self) -> dict:
        """The ``stats()['objectstore']`` block: store request/byte
        accounting plus the upload-pipelining overlap breakdown."""
        with self._mu:
            hidden, exposed = self._hidden_s, self._exposed_s
            total = self._upload_total_s
            up = {
                "pipeline_uploads": self.pipeline_uploads,
                "part_size": self.part_size,
                "files_sealed": self._files_sealed,
                "staged_pending": len(self._pending),
                "published_multipart": self._published_multipart,
                "published_put": self._published_put,
                "upload_total_s": round(total, 6),
                "hidden_upload_s": round(hidden, 6),
                "exposed_upload_s": round(exposed, 6),
                "inline_upload_s": round(self._sync_upload_s, 6),
                "overlap_pct": round(
                    100.0 * hidden / (hidden + exposed), 2)
                if (hidden + exposed) > 0 else 0.0,
                "spill_threshold_bytes": self.spill_threshold_bytes,
                "spilled_handles": self._spilled_handles,
            }
        return {
            "bucket": self.bucket,
            "store": self.store.stats(),
            "upload": up,
            "observed_bytes_per_s": round(
                self.store.observed_bytes_per_s(), 1),
        }


class BandwidthBudget:
    """Token-bucket bytes/s budget, shared across every consumer that
    holds a reference — the compactor's merge READS and merge-output
    WRITES draw from one bucket, so total remote traffic stays under the
    budget no matter how it splits."""

    def __init__(self, bytes_per_s: float,
                 burst_bytes: int | None = None) -> None:
        if bytes_per_s <= 0:
            raise ValueError("bytes_per_s must be positive")
        self.rate = float(bytes_per_s)
        self.burst = int(burst_bytes if burst_bytes is not None
                         else max(64 * 1024, int(bytes_per_s / 4)))
        self._lk = threading.Lock()
        # start EMPTY: accrual is capped at burst, so total consumption
        # can never exceed rate * elapsed — observed throughput stays
        # at-or-under the budget from the first byte (a full initial
        # bucket would let a short run overshoot by the whole burst)
        self._tokens = 0.0
        self._last = time.monotonic()
        self._consumed = 0
        self._t0 = self._last
        self._wait_s = 0.0

    def acquire(self, nbytes: int) -> None:
        """Take ``nbytes`` tokens, sleeping off any deficit (a single
        oversized request runs, then pays its debt — long-run throughput
        stays <= rate with at most ``burst`` of slack)."""
        if nbytes <= 0:
            return
        with self._lk:
            now = time.monotonic()
            self._tokens = min(float(self.burst),
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            self._tokens -= nbytes
            wait = max(0.0, -self._tokens / self.rate)
            self._consumed += nbytes
            self._wait_s += wait
        if wait > 0.0:
            time.sleep(wait)

    def observed(self) -> dict:
        with self._lk:
            elapsed = time.monotonic() - self._t0
            return {
                "budget_bytes_per_s": self.rate,
                "burst_bytes": self.burst,
                "bytes_consumed": self._consumed,
                "elapsed_s": round(elapsed, 3),
                "observed_bytes_per_s": round(
                    self._consumed / elapsed, 1) if elapsed > 0 else 0.0,
                "throttle_wait_s": round(self._wait_s, 3),
            }


class _BudgetedFile:
    """File wrapper drawing read/write bytes from the shared budget."""

    def __init__(self, inner, budget: BandwidthBudget | None) -> None:
        self._inner = inner
        self._budget = budget

    def read(self, n: int = -1):
        data = self._inner.read(n)
        if self._budget is not None and data:
            self._budget.acquire(len(data))
        return data

    def write(self, data) -> int:
        if self._budget is not None:
            self._budget.acquire(len(data))
        return self._inner.write(data)

    def writelines(self, parts) -> None:
        parts = list(parts)
        if self._budget is not None:
            self._budget.acquire(sum(len(p) for p in parts))
        self._inner.writelines(parts)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __getattr__(self, name):  # seek/tell/flush/close/... pass through
        return getattr(self._inner, name)


class BandwidthBudgetedFileSystem(FileSystem):
    """Remote-tier wrapper: token-bucket byte throttling over every file
    read/write plus request-count accounting over every store-visible
    operation — the Compactor's bandwidth-budgeted seam
    (``Builder.compaction(bandwidth_bytes_per_s=...)``).  Forwards the
    publish capability (``supports_rename`` / ``publish_commit``) so the
    protocol decision point sees the real sink."""

    def __init__(self, inner: FileSystem,
                 budget: BandwidthBudget | None = None) -> None:
        self.inner = inner
        self.budget = budget
        self._lk = threading.Lock()
        self._requests = 0

    @property
    def supports_rename(self) -> bool:
        return getattr(self.inner, "supports_rename", True)

    def _count(self) -> None:
        with self._lk:
            self._requests += 1

    def requests_total(self) -> int:
        with self._lk:
            return self._requests

    def publish_commit(self, src: str, dst: str) -> None:
        self._count()
        self.inner.publish_commit(src, dst)

    def mkdirs(self, path: str) -> None:
        self._count()
        self.inner.mkdirs(path)

    def open_write(self, path: str):
        self._count()
        return _BudgetedFile(self.inner.open_write(path), self.budget)

    def open_append(self, path: str):
        self._count()
        return _BudgetedFile(self.inner.open_append(path), self.budget)

    def open_read(self, path: str):
        self._count()
        return _BudgetedFile(self.inner.open_read(path), self.budget)

    def rename(self, src: str, dst: str) -> None:
        self._count()
        self.inner.rename(src, dst)

    def sync(self, path: str) -> None:
        self._count()
        self.inner.sync(path)

    def sync_dir(self, path: str) -> None:
        self._count()
        self.inner.sync_dir(path)

    def exists(self, path: str) -> bool:
        self._count()
        return self.inner.exists(path)

    def delete(self, path: str) -> None:
        self._count()
        self.inner.delete(path)

    def size(self, path: str) -> int:
        self._count()
        return self.inner.size(path)

    def list_files(self, path: str, extension: str | None = None,
                   recursive: bool = True) -> list[str]:
        self._count()
        return self.inner.list_files(path, extension=extension,
                                     recursive=recursive)
