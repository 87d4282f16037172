"""Process-parallel workers: zero-copy shared-memory batch handoff.

Page assembly runs behind the nogil boundary, but shred + queue-put still
convoy inside ONE interpreter: GIL *round trips* (each handoff between the
fetcher, the worker loop and the pipeline threads re-acquires the lock),
not held time, are the convoy killer, and a 2-thread worker sweep cannot
beat 1x while every worker shares a GIL.  This module escapes the
single-interpreter ceiling by running each worker as a **spawned
subprocess**:

* **Handoff** — broker pages already live in contiguous payload+offset
  buffers (:class:`~kpw_tpu_torch.ingest.broker.RecordBatch`), which is
  exactly the representation that crosses a process boundary zero-copy.
  The parent stages each poll batch into a slot of a
  ``multiprocessing.shared_memory`` ring (:class:`ShmBatchRing` — one
  memcpy, the same single copy ``fetch_batch`` pays out of the broker log
  in thread mode) and sends the child only a tiny ``(seq, slot)``
  descriptor; the child maps the same ring and feeds the slot's
  payload+offsets views **in place** to the C++ wire shredder — no
  pickling, no per-record objects, no second copy.
* **Ownership split** — each child runs the full shred → encode →
  assemble → publish leg against its own encoder (its own interpreter,
  its own ``_kpw_torch_assemble``; with the ``"cuda"`` backend its own
  CUDA context and a ``CudaChunkEncoder`` on a stream of its own) and its
  own tmp namespace; the parent keeps
  the ``PagedOffsetTracker`` + ack protocol.  Offsets commit only when
  the child acknowledges the published file, so at-least-once is
  unchanged: a child SIGKILLed mid-file never acked, and the parent
  redelivers its held runs to a restarted slot — exactly the thread-mode
  supervisor contract, now with a kill that actually reclaims the slot.
* **Spawn only** — the start method is pinned to ``spawn``
  (:data:`_MP_CTX`): a forked child cannot use the parent's CUDA context,
  and fork with live threads can deadlock.
* **The card's kernels build in the parent** — before it spawns a child
  that runs a card encoder, the pool builds every CUDA kernel
  (``ops/_build.py``, under its cross-process lock), so no child compiles.
* **The message class crosses as data** — a protobuf class as its
  ``FileDescriptorProto`` closure; a descriptor stand-in (the duck-typed
  descriptors the proto bridge reads, without protobuf) as a plain-data
  snapshot that the child rebuilds into stand-ins of its own, importing
  no protobuf.

Parent-side pieces: :class:`ProcessWorkerPool` (dispatcher + collector
threads, ring bookkeeping), :class:`_ProcWorkerSlot` (the ``_Worker``
duck type the existing supervisor/watchdog/stats machinery operates on),
:class:`_ProcHeartbeat` (watchdog adapter over the child's shared-memory
heartbeat cells).  Child-side: :func:`child_main` (the spawn entry) and
:class:`_ChildWorker` (the in-process worker loop).
"""

from __future__ import annotations

import logging
import multiprocessing
import os
import queue as pyqueue
import struct
import threading
import time

import numpy as np

from ..ingest.broker import RecordBatch, StaleGenerationError
from ..utils import schedcheck, tracing
from ..utils.tracing import stage
from .retry import RetryInterrupted
from .telemetry import TM_FIELDS

logger = logging.getLogger(__name__)

# spawn ONLY: the parent holds a CUDA context and runs threads, and a
# forked child can neither use that context nor safely inherit the threads
_MP_CTX = multiprocessing.get_context("spawn")

# -- shared-memory ring geometry --------------------------------------------
# [ heartbeat cells: _HB_MAX * _HB_CELL bytes ]
# [ telemetry cells: _HB_MAX * _TM_CELL bytes ][ slot 0 ][ slot 1 ] ...
# slot = [ header _SLOT_HEADER bytes ][ offsets (count+1) int64 ][ payload ]
_HB_MAX = 64          # max worker processes one ring serves
_HB_CELL = 32         # label_code i64, pending i64, started_at f64, beat f64
_TM_SLOTS = 16        # int64 counter slots per worker telemetry cell
#                       (telemetry.TM_FIELDS names all 16 as of the
#                       rebalance fields — shared-memory layout is
#                       append-only; grow _TM_SLOTS before TM_FIELDS)
_TM_CELL = _TM_SLOTS * 8
_SLOT_HEADER = 48     # count, offs_bytes, payload_bytes, partition,
#                       start_offset, ingest_us — all little-endian int64
_HDR = struct.Struct("<qqqqqq")

# heartbeat seam labels travel as small codes through the cells (fixed
# table, parent side decodes); 0 = unlabeled
_HB_LABELS = ("io", "open", "flush", "close", "publish", "shred",
              "append", "dead_letter")
_HB_CODE = {lbl: i + 1 for i, lbl in enumerate(_HB_LABELS)}


class ShmBatchRing:
    """A ring of fixed-size batch slots in one shared-memory segment,
    plus per-worker heartbeat AND telemetry cells at the front.

    The parent creates it (``create=True``), writes batches into free
    slots and recycles them when the consuming child reports the slot
    drained; children attach by name and read slot views zero-copy.
    Slot allocation/free bookkeeping lives entirely in the parent
    (:class:`ProcessWorkerPool`) — the ring itself is just memory."""

    def __init__(self, slots: int, slot_bytes: int, *, create: bool = True,
                 name: str | None = None) -> None:
        from multiprocessing import shared_memory

        if slots < 1 or slot_bytes <= _SLOT_HEADER + 16:
            raise ValueError("ring needs >= 1 slot of useful capacity")
        self.slots = slots
        self.slot_bytes = slot_bytes
        self._hb_bytes = _HB_MAX * _HB_CELL
        self._tm_bytes = _HB_MAX * _TM_CELL
        total = self._hb_bytes + self._tm_bytes + slots * slot_bytes
        self._shm = shared_memory.SharedMemory(create=create, name=name,
                                               size=total if create else 0)
        # NOTE on resource tracking: spawn children inherit the parent's
        # resource-tracker process, and register() dedupes by name, so
        # attach-side registrations collapse into the parent's one entry;
        # the parent's unlink() (pool.finalize) both removes the segment
        # and unregisters it.  A SIGKILLed child therefore never unlinks
        # the ring out from under the survivors (cpython #82300 only
        # bites processes with independent trackers).
        self.name = self._shm.name
        self._buf = self._shm.buf
        # heartbeat cells as one (HB_MAX, 4) float64/int64 view pair
        self._hb_i = np.frombuffer(self._buf, np.int64,
                                   count=_HB_MAX * 4).reshape(_HB_MAX, 4)
        self._hb_f = np.frombuffer(self._buf, np.float64,
                                   count=_HB_MAX * 4).reshape(_HB_MAX, 4)
        # telemetry cells: one int64 counter vector per worker (see
        # runtime/telemetry.py for the field meanings); single-writer
        # per cell, torn reads benign — every field is monotonic
        self._tm = np.frombuffer(
            self._buf, np.int64, count=_HB_MAX * _TM_SLOTS,
            offset=self._hb_bytes).reshape(_HB_MAX, _TM_SLOTS)

    # -- slot payload capacity ------------------------------------------------
    def fits(self, count: int, payload_bytes: int) -> bool:
        need = _SLOT_HEADER + (count + 1) * 8 + payload_bytes
        return need <= self.slot_bytes

    def max_records_for(self, est_record_bytes: float) -> int:
        """How many ~``est_record_bytes`` records one slot holds — the
        dispatcher's unit-splitting bound."""
        usable = self.slot_bytes - _SLOT_HEADER
        return max(1, int(usable / (max(est_record_bytes, 1.0) + 8)) - 1)

    def _slot_off(self, idx: int) -> int:
        if not 0 <= idx < self.slots:
            raise IndexError(f"slot {idx} out of range")
        return self._hb_bytes + self._tm_bytes + idx * self.slot_bytes

    # -- parent side -----------------------------------------------------------
    def write_slot(self, idx: int, partition: int, start_offset: int,
                   offsets: np.ndarray, payload) -> int:
        """Stage one contiguous batch into slot ``idx``: offsets are
        rebased to 0 (a RecordBatch slice window may start nonzero) and
        the payload window is memcpy'd once.  Returns the record count."""
        return self.write_slot_parts(idx, partition, start_offset,
                                     [(offsets, payload)])

    def write_slot_parts(self, idx: int, partition: int, start_offset: int,
                         parts, ingest_us: int = 0) -> int:
        """Stage SEVERAL offset-contiguous windows into one slot as a
        single merged offsets table + payload blob — the dispatcher packs
        a poll round's per-partition fetch slices together so unit size
        follows slot capacity, not fetch granularity (small fetches would
        otherwise make per-unit fixed costs the throughput ceiling).
        ``parts`` = [(offsets int64 n_i+1, payload buffer), ...]; the
        staging memcpy concatenates the windows (the same single copy the
        one-part path pays).  ``ingest_us`` stamps the unit's oldest
        batch's ingest wall-time (microseconds since the epoch, 0 =
        unknown) through the descriptor — the end-to-end ack-latency
        plane's anchor.  Returns the merged record count."""
        norm = [(np.ascontiguousarray(o, np.int64), p) for o, p in parts]
        count = sum(len(o) - 1 for o, _ in norm)
        nbytes = sum(int(o[-1] - o[0]) for o, _ in norm)
        if not self.fits(count, nbytes):
            raise ValueError(
                f"batch ({count} records, {nbytes} B) exceeds slot capacity "
                f"({self.slot_bytes} B incl. header+offsets)")
        off = self._slot_off(idx)
        self._buf[off: off + _SLOT_HEADER] = _HDR.pack(
            count, (count + 1) * 8, nbytes, partition, start_offset,
            int(ingest_us))
        dst_offs = np.frombuffer(self._buf, np.int64, count=count + 1,
                                 offset=off + _SLOT_HEADER)
        data_start = off + _SLOT_HEADER + (count + 1) * 8
        dst_offs[0] = 0
        rec = 0
        byte = 0
        for o, payload in norm:
            n = len(o) - 1
            base = int(o[0])
            window = memoryview(payload)[base: int(o[-1])]
            np.subtract(o[1:], base - byte, out=dst_offs[rec + 1:
                                                         rec + n + 1])
            self._buf[data_start + byte: data_start + byte + len(window)] \
                = window
            rec += n
            byte += len(window)
        return count

    # -- child side ------------------------------------------------------------
    def read_slot(self, idx: int):
        """(partition, start_offset, count, offsets_view, payload_view,
        ingest_us) — both views alias the shared segment (zero-copy); the
        caller must finish with them before the slot is reported free."""
        off = self._slot_off(idx)
        (count, offs_bytes, nbytes, partition, start_offset,
         ingest_us) = _HDR.unpack(bytes(self._buf[off: off + _SLOT_HEADER]))
        offs = np.frombuffer(self._buf, np.int64, count=count + 1,
                             offset=off + _SLOT_HEADER)
        o_end = off + _SLOT_HEADER + offs_bytes
        payload = self._buf[o_end: o_end + nbytes]
        return partition, start_offset, count, offs, payload, ingest_us

    # -- heartbeat cells -------------------------------------------------------
    def hb_publish(self, widx: int, label_code: int, pending: bool,
                   started_at: float) -> None:
        """Child side: publish this worker's oldest pending IO op (or
        clear it) plus a liveness beat.  One cell per worker, torn reads
        acceptable — the watchdog tolerates a stale sample.  Ordering:
        pending flips LAST on set and FIRST on clear, so a racing reader
        can never observe pending=1 paired with a cleared/stale
        started_at (which would read as an enormous stall age and get a
        healthy child condemned)."""
        if self._hb_i is None:  # ring already closed (exit race)
            return
        schedcheck.note_hb_write(widx)
        if pending:
            self._hb_i[widx, 0] = label_code
            self._hb_f[widx, 2] = started_at
            # schedule-explorer edge: the ordering above (payload fields
            # BEFORE the pending flip) is exactly what the torn-read
            # probe in _ProcHeartbeat.stall verifies under perturbation
            schedcheck.point("proc.hb.publish")
            self._hb_i[widx, 1] = 1
        else:
            self._hb_i[widx, 1] = 0
            schedcheck.point("proc.hb.publish")
            self._hb_i[widx, 0] = label_code
            self._hb_f[widx, 2] = started_at
        self._hb_f[widx, 3] = time.monotonic()

    def hb_read(self, widx: int) -> tuple[int, bool, float, float]:
        if self._hb_i is None:
            return 0, False, 0.0, 0.0
        return (int(self._hb_i[widx, 0]), bool(self._hb_i[widx, 1]),
                float(self._hb_f[widx, 2]), float(self._hb_f[widx, 3]))

    def hb_clear(self, widx: int) -> None:
        if self._hb_i is None:
            return
        self._hb_i[widx, 1] = 0
        self._hb_i[widx, 0] = 0

    def hb_label(self, widx: int) -> str | None:
        """Decode the op label the worker last published (``None`` when
        the cell is unlabeled or already cleared).  This is the flight
        recorder's stalled-stage attribution for a child that died
        without a goodbye (kill -9, OOM): the cell survives the death
        and is only cleared later by ``respawn_slot``."""
        code, _pending, _started, _beat = self.hb_read(widx)
        if 1 <= code <= len(_HB_LABELS):
            return _HB_LABELS[code - 1]
        return None

    # -- telemetry cells -------------------------------------------------------
    def tm_publish(self, widx: int, values) -> None:
        """Child side: overwrite this worker's telemetry counter cell
        (field order = ``telemetry.TM_FIELDS``).  Single writer per
        cell; a torn parent read sees a counter one tick stale, never
        garbage — every field is monotonic."""
        if self._tm is None:  # ring already closed (exit race)
            return
        n = min(len(values), _TM_SLOTS)
        self._tm[widx, :n] = values[:n]

    def tm_read(self, widx: int) -> list[int]:
        if self._tm is None:
            return [0] * _TM_SLOTS
        return [int(v) for v in self._tm[widx]]

    def tm_clear(self, widx: int) -> None:
        if self._tm is None:
            return
        self._tm[widx, :] = 0

    def close(self) -> None:
        # drop our numpy views before closing the mmap; a caller-held
        # slot view keeps the mapping alive until IT is released
        # (BufferError from mmap — the unmap happens at that release)
        self._hb_i = self._hb_f = self._tm = None
        self._buf = None
        try:
            self._shm.close()
        except (OSError, BufferError):
            pass

    def unlink(self) -> None:
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass


class _ProcHeartbeat:
    """Parent-side watchdog adapter over one child's heartbeat cells:
    presents the :class:`~kpw_tpu_torch.runtime.watchdog.Heartbeat` read API
    (``stall()``) the Watchdog scans.  CLOCK_MONOTONIC is system-wide on
    Linux, so the child's ``started_at`` stamp is directly comparable."""

    def __init__(self, ring: ShmBatchRing, widx: int) -> None:
        self._ring = ring
        self._widx = widx

    def stall(self) -> tuple[float, str | None]:
        code, pending, started_at, _beat = self._ring.hb_read(self._widx)
        # started_at == 0.0 can only be a torn read racing a clear (a
        # real op stamps a live monotonic clock) — never a stall
        if not pending or started_at == 0.0:
            return 0.0, None
        # invariant probe (schedule explorer): a stall age is about to
        # be computed — the clock it is computed from must be a live
        # stamp.  pending with a cleared/garbage started_at here is the
        # torn-read shape that would condemn a healthy child; the
        # hb_publish write ordering plus the guard above must make this
        # unreachable under ANY interleaving
        schedcheck.note_hb_sample(self._widx, True, started_at)
        label = (_HB_LABELS[code - 1]
                 if 1 <= code <= len(_HB_LABELS) else "io")
        return max(0.0, time.monotonic() - started_at), label


def _proto_spec(proto_class) -> tuple:
    """The picklable shape a spawned child rebuilds the message class from.

    A protobuf class (its ``DESCRIPTOR`` can ``CopyToProto``; protoc-
    generated or runtime-built) travels as ``("protobuf", full name,
    serialized FileDescriptorProto closure)``, and only this route imports
    ``google.protobuf``.  A descriptor stand-in — an object with the
    attributes the proto bridge reads by duck typing — travels as
    ``("snapshot", messages, enums)``, a plain-data copy of everything the
    bridge reads (:func:`_descriptor_snapshot`).  A class without a
    descriptor is not spawnable."""
    desc = getattr(proto_class, "DESCRIPTOR", None)
    if desc is None or not hasattr(desc, "fields"):
        raise ValueError(
            "process_workers needs a message class with a DESCRIPTOR (a "
            "protobuf class or a descriptor stand-in) so the spawned "
            "children can rebuild it")
    if not (hasattr(desc, "CopyToProto") and hasattr(desc, "file")):
        return ("snapshot",) + _descriptor_snapshot(desc)
    from google.protobuf import descriptor_pb2

    blobs: list[bytes] = []
    seen: set[str] = set()

    def add(fd) -> None:
        if fd.name in seen:
            return
        seen.add(fd.name)
        for dep in fd.dependencies:
            add(dep)
        fdp = descriptor_pb2.FileDescriptorProto()
        fd.CopyToProto(fdp)
        blobs.append(fdp.SerializeToString())

    add(desc.file)
    return "protobuf", desc.full_name, tuple(blobs)


def _descriptor_snapshot(desc) -> tuple[list, list]:
    """(messages, enums): plain dicts and tuples holding what the proto
    bridge reads from ``desc`` and every message and enum it reaches —
    names, numbers, types, labels, presence, each file's syntax.  Message
    and enum references are list indices (message 0 is ``desc``), so
    recursive types snapshot too.  Values the bridge derives where a
    descriptor lacks them (presence, syntax, the label from
    ``is_repeated`` / ``is_required``) are stored derived, so the rebuilt
    stand-ins read back the same answers."""
    from ..models.proto_bridge import (FD, _file_syntax, _has_presence,
                                       _is_repeated, _is_required,
                                       _values_by_number)

    messages: list = []
    enums: list = []
    msg_index: dict[int, int] = {}
    enum_index: dict[int, int] = {}

    def syntax(obj):
        f = getattr(obj, "file", None)
        return None if f is None else _file_syntax(f)

    def enum_ref(e) -> int:
        if id(e) not in enum_index:
            enum_index[id(e)] = len(enums)
            enums.append({"name": e.name, "syntax": syntax(e),
                          "values": sorted((v.name, n) for n, v in
                                           _values_by_number(e).items())})
        return enum_index[id(e)]

    def msg_ref(d) -> int:
        if id(d) in msg_index:
            return msg_index[id(d)]
        msg_index[id(d)] = len(messages)
        entry = {"name": d.name, "syntax": _file_syntax(getattr(d, "file", None)),
                 "fields": []}
        messages.append(entry)
        for fd in d.fields:
            label = (FD.LABEL_REPEATED if _is_repeated(fd) else
                     FD.LABEL_REQUIRED if _is_required(fd) else FD.LABEL_OPTIONAL)
            entry["fields"].append({
                "name": fd.name, "number": fd.number, "type": fd.type,
                "label": label, "has_presence": _has_presence(fd),
                "syntax": syntax(fd),
                "message": (msg_ref(fd.message_type)
                            if fd.type == FD.TYPE_MESSAGE else None),
                "enum": enum_ref(fd.enum_type) if fd.type == FD.TYPE_ENUM else None,
            })
        return msg_index[id(d)]

    msg_ref(desc)
    return messages, enums


class _SnapFile:
    """A file descriptor stand-in: only its syntax."""

    def __init__(self, syntax: str) -> None:
        self.syntax = syntax


class _SnapEnumValue:
    def __init__(self, name: str, number: int) -> None:
        self.name, self.number = name, number


class _SnapEnum:
    def __init__(self, spec: dict) -> None:
        self.name = spec["name"]
        if spec["syntax"] is not None:
            self.file = _SnapFile(spec["syntax"])
        self.values = [_SnapEnumValue(n, k) for n, k in spec["values"]]
        self.values_by_number = {v.number: v for v in self.values}


class _SnapField:
    def __init__(self, spec: dict, messages: list, enums: list) -> None:
        self.name, self.number = spec["name"], spec["number"]
        self.type, self.label = spec["type"], spec["label"]
        self.has_presence = spec["has_presence"]
        if spec["syntax"] is not None:
            self.file = _SnapFile(spec["syntax"])
        self.message_type = (None if spec["message"] is None
                             else messages[spec["message"]])
        self.enum_type = None if spec["enum"] is None else enums[spec["enum"]]


class _SnapMessage:
    """A message descriptor stand-in; ``fields`` are filled once every
    message of the snapshot exists (fields may refer to any of them)."""

    def __init__(self, spec: dict) -> None:
        self.name = spec["name"]
        self.file = _SnapFile(spec["syntax"])
        self.fields: list = []
        self.fields_by_name: dict = {}


def _class_from_snapshot(messages: list, enums: list):
    """The message class a snapshot describes: ``DESCRIPTOR`` built of
    stand-ins, and a ``FromString`` that raises, as a stand-in's does —
    such a class's records are shredded from the wire, never parsed, so
    a record the wire shredder refuses meets an error and the
    ``on_parse_error`` policy, as in thread mode."""
    enum_objs = [_SnapEnum(e) for e in enums]
    msg_objs = [_SnapMessage(m) for m in messages]
    for m, spec in zip(msg_objs, messages):
        m.fields = [_SnapField(f, msg_objs, enum_objs) for f in spec["fields"]]
        m.fields_by_name = {f.name: f for f in m.fields}
    root = msg_objs[0]

    def from_string(data):
        raise NotImplementedError(
            f"{root.name} was rebuilt from a descriptor snapshot and parses "
            "no record: records take the wire path")

    return type(root.name, (), {"DESCRIPTOR": root,
                                "FromString": staticmethod(from_string)})


def _proto_class_from_spec(spec):
    if spec[0] == "snapshot":
        return _class_from_snapshot(spec[1], spec[2])
    _, full_name, blobs = spec
    from google.protobuf import (descriptor_pb2, descriptor_pool,
                                 message_factory)

    pool = descriptor_pool.DescriptorPool()
    for b in blobs:
        pool.Add(descriptor_pb2.FileDescriptorProto.FromString(b))
    return message_factory.GetMessageClass(
        pool.FindMessageTypeByName(full_name))


class ChildConfig:
    """Everything one spawned worker needs, picklable by construction.
    Built by the pool from the Builder; the child reconstructs the proto
    class from its spec (:func:`_proto_spec`) and a fresh LocalFileSystem
    (the only filesystem whose handles are per-process by nature).
    ``device`` is the card encoder's device (``"cuda"`` / ``"auto"``)."""

    def __init__(self, b, index: int, ring_name: str, ring_slots: int,
                 slot_bytes: int) -> None:
        self.index = index
        self.ring_name = ring_name
        self.ring_slots = ring_slots
        self.slot_bytes = slot_bytes
        self.instance_name = b._instance_name
        self.target_dir = b._target_dir.rstrip("/")
        self.proto_spec = _proto_spec(b._proto_class)
        self.properties = b.writer_properties()  # plain dataclass
        self.backend = b._backend
        self.device = b._backend_device
        self.pipeline = b._pipeline
        self.batch_size = b._batch_size
        self.max_file_size = b._max_file_size
        self.max_file_open_duration = b._max_file_open_duration
        self.file_date_time_pattern = b._file_date_time_pattern
        self.directory_date_time_pattern = b._directory_date_time_pattern
        self.file_extension = b._file_extension
        self.on_parse_error = b._on_parse_error
        self.durable_publish = b._durable_publish
        self.verify_on_publish = b._verify_on_publish
        self.tracing = b._tracing
        self.trace_span_capacity = b._trace_span_capacity


# ---------------------------------------------------------------------------
# child side
# ---------------------------------------------------------------------------

def child_main(cfg: ChildConfig, work_q, ack_q) -> None:
    """Spawn entry: run one worker process until poison or fatal error.
    Must stay module-level (spawn pickles the callable by reference)."""
    try:
        worker = _ChildWorker(cfg, work_q, ack_q)
    except BaseException as e:  # noqa: BLE001 — startup must report, not vanish
        ack_q.put(("died", cfg.index, os.getpid(),
                   f"child startup failed: {e!r}"))
        raise
    worker.run()


class _ChildWorker:
    """The in-process half of one worker slot: drain ``(seq, slot)``
    units from the work queue, shred each slot's buffer in place, encode
    and rotate parquet files, publish with the exact tmp→(verify)→rename
    protocol of the thread-mode worker, and acknowledge published units
    so the parent can ack their offset runs.  Mirrors ``_Worker``'s loop
    shape; deliberately self-contained — it runs in a fresh interpreter
    where the parent's writer object does not exist."""

    def __init__(self, cfg: ChildConfig, work_q, ack_q) -> None:
        from ..io.fs import LocalFileSystem
        from ..models.proto_bridge import ProtoColumnarizer
        from .retry import RetryPolicy
        from .watchdog import Heartbeat

        self.cfg = cfg
        self.work_q = work_q
        self.ack_q = ack_q
        self.fs = LocalFileSystem()
        self.proto_class = _proto_class_from_spec(cfg.proto_spec)
        self.columnarizer = ProtoColumnarizer(self.proto_class)
        self.ring = ShmBatchRing(cfg.ring_slots, cfg.slot_bytes,
                                 create=False, name=cfg.ring_name)
        self.retry = RetryPolicy()
        self._stop = threading.Event()
        self.heartbeat = Heartbeat()
        self._hb_publisher = threading.Thread(target=self._publish_hb,
                                              name="kpw-child-hb",
                                              daemon=True)
        if cfg.backend in (None, "cpu"):
            self._encoder_factory = lambda: None
        else:
            from .select import AutoChoice, check_backend, make_encoder

            # the card (and its CUDA context) comes up here, before the
            # child reports ready; "auto" decides once per child, as each
            # JAX child runs its own probe
            check_backend(cfg.backend, cfg.device)
            choice = AutoChoice(cfg.device) if cfg.backend == "auto" else None
            opts = cfg.properties.encoder_options()
            self._encoder_factory = lambda: make_encoder(
                opts, cfg.backend, cfg.device, choice)
        self.current_file = None
        self._pending_seqs: list[int] = []  # units in the open file
        self._pending_parts: set[int] = set()  # partitions of those units
        self._carry_est = 64.0
        # cooperative-rebalance counters (TM cell fields): files flushed
        # under a revoke fence / open files abandoned on revoke-lost
        self._rebalance_fenced = 0
        self._rebalance_abandoned = 0
        # test seam for the zombie-child drill: while this path exists on
        # disk the child parks INSIDE its publish (heartbeat label
        # "publish" stays pending) — the cross-process analog of the
        # thread-mode gated exists() probe, which cannot reach a child
        # because proc mode pins the child filesystem to LocalFileSystem
        self._publish_gate = os.environ.get("KPW_CHILD_PUBLISH_GATE")
        # retry accounting, reported to the parent with every published
        # file so process-mode stats() shows real retry activity
        self._retries = 0
        self._backoff_s = 0.0
        self._last_error: str | None = None
        self._files_published = 0
        self._use_wire = self.columnarizer.wire_capable
        # telemetry-plane counters, published to this worker's shm cell
        # (~20 Hz from the heartbeat thread) and snapshotted over the
        # low-rate ack-queue side channel at rotation/seal boundaries
        self._written_records = 0
        self._written_bytes = 0
        self._flushed_records = 0
        self._flushed_bytes = 0
        self._deadletter_records = 0
        self._units_processed = 0
        self._rot_size = 0
        self._rot_time = 0
        self._last_side_send = 0.0
        self._spans_shipped = 0
        self.stage_timer: tracing.StageTimer | None = None
        self.span_recorder: tracing.SpanRecorder | None = None
        if cfg.tracing:
            # this interpreter's module globals are the child's own —
            # installing here mirrors writer.start() in the parent
            self.stage_timer = tracing.StageTimer()
            self.span_recorder = tracing.SpanRecorder(
                capacity=cfg.trace_span_capacity)
            tracing.set_tracer(self.stage_timer)
            tracing.set_span_recorder(self.span_recorder)

    # -- heartbeat publisher --------------------------------------------------
    def _publish_hb(self) -> None:
        ring, widx = self.ring, self.cfg.index
        while not self._stop.is_set():
            age, label = self.heartbeat.stall()
            if label is None:
                ring.hb_publish(widx, 0, False, 0.0)
            else:
                ring.hb_publish(widx, _HB_CODE.get(label, 0), True,
                                time.monotonic() - age)
            ring.tm_publish(widx, self._tm_values())
            self._stop.wait(0.05)
        ring.hb_clear(widx)

    # -- telemetry plane ------------------------------------------------------
    def _tm_values(self) -> tuple:
        """This worker's counter vector, field order = ``TM_FIELDS``."""
        rec = self.span_recorder
        st = self.stage_timer
        stage_us = 0
        if st is not None:
            stage_us = int(sum(s["seconds"]
                               for s in st.summary().values()) * 1e6)
        return (self._written_records, self._written_bytes,
                self._flushed_records, self._flushed_bytes,
                self._files_published, self._units_processed,
                self._retries, int(self._backoff_s * 1000),
                self._deadletter_records, self._rot_size, self._rot_time,
                # cumulative spans: shipped batches + whatever the side
                # channel has not drained yet (len(rec) alone would reset
                # to ~0 on every drain — a sawtooth, not a counter)
                (self._spans_shipped + len(rec)) if rec is not None else 0,
                rec.dropped if rec is not None else 0,
                stage_us,
                self._rebalance_fenced, self._rebalance_abandoned)

    def _maybe_send_telemetry(self, force: bool = False) -> None:
        """The low-rate side channel: a full snapshot (counter dict +
        stage summary + drained span buffer) over the ack queue.  Sent
        at rotation/seal boundaries and at exit; throttled so a
        fast-rotating child cannot flood the collector."""
        now = time.monotonic()
        if not force and now - self._last_side_send < 0.5:
            return
        self._last_side_send = now
        spans = None
        if self.span_recorder is not None:
            spans = self.span_recorder.export_payload(
                process_name=f"kpw-proc-worker-{self.cfg.index}")
            self._spans_shipped += len(spans["spans"])
        payload = {
            "pid": os.getpid(),
            "tm": dict(zip(TM_FIELDS, self._tm_values())),
            "stages": (self.stage_timer.summary()
                       if self.stage_timer is not None else None),
            "spans": spans,
        }
        try:
            self.ack_q.put(("telemetry", self.cfg.index, payload))
        except (OSError, ValueError):
            pass  # parent queue torn down mid-exit; nothing to report to

    def _retry(self, fn, label: str = "io"):
        token = self.heartbeat.io_started(label)
        try:
            return self.retry.call(fn, stop_event=self._stop,
                                   on_retry=self._on_retry, label=label)
        finally:
            self.heartbeat.io_finished(token)

    def _on_retry(self, attempt: int, exc: BaseException,
                  sleep_s: float) -> None:
        self.heartbeat.beat()
        self._retries += 1
        self._backoff_s += sleep_s
        self._last_error = repr(exc)

    # -- main loop -------------------------------------------------------------
    def run(self) -> None:
        self._hb_publisher.start()
        self.ack_q.put(("ready", self.cfg.index, os.getpid()))
        try:
            fence: dict[int, str] = {}  # partition -> pending fence mode
            while True:
                try:
                    msg = self.work_q.get_nowait()
                except pyqueue.Empty:
                    # queue drained: NOW service accumulated fence
                    # descriptors.  The deferral is the thread worker's
                    # _service_fence parity — an abandon posted a few µs
                    # behind its flush (the rejoin-after-expiry shape)
                    # must supersede it, not watch it publish rows whose
                    # commits can only come back fenced
                    if fence:
                        self._service_fences(fence)
                        fence = {}
                    try:
                        msg = self.work_q.get(timeout=0.05)
                    except pyqueue.Empty:
                        self._maybe_time_rotate()
                        continue
                if msg is None:  # poison: abandon the open tmp un-acked
                    self._abandon("close")
                    self.ack_q.put(("closed", self.cfg.index))
                    return
                kind = msg[0]
                if kind == "revoke":
                    # cross-process fence descriptor: the parent's
                    # rebalance listener revoked partitions; flush (drain
                    # window open) or abandon (LOST / deadline lapsed)
                    # whatever of the open file touches them.  Abandon
                    # supersedes a pending flush; a flush never
                    # downgrades an abandon.
                    _, parts, mode = msg
                    for p in parts:
                        if mode == "abandon" or fence.get(p) != "abandon":
                            fence[p] = mode
                elif kind == "unit":
                    _, seq, slot_idx = msg
                    self._process_unit(seq, slot_idx)
                self._maybe_time_rotate()
        except RetryInterrupted:
            self._abandon("close")
            self.ack_q.put(("closed", self.cfg.index))
        except BaseException as e:  # noqa: BLE001 — the death report IS the seam
            logger.exception("proc worker %d terminated", self.cfg.index)
            self._abandon("error")
            self.ack_q.put(("died", self.cfg.index, os.getpid(), repr(e)))
            raise
        finally:
            # final telemetry flush: the cell freezes at these values
            # (the parent banks them on respawn) and the side channel
            # carries the tail spans the parent has not seen yet
            self.ring.tm_publish(self.cfg.index, self._tm_values())
            self._maybe_send_telemetry(force=True)
            self._stop.set()
            # the heartbeat publisher must stop touching the mapping
            # before the ring closes (BufferError/segfault race otherwise)
            self._hb_publisher.join(timeout=1.0)
            self.ring.close()

    def _process_unit(self, seq: int, slot_idx: int) -> None:
        partition, start_offset, count, offs, payload, ingest_us = \
            self.ring.read_slot(slot_idx)
        self._units_processed += 1
        nbytes = int(offs[-1] - offs[0])
        # lint: clock-discipline ok — operator-facing ingest age (the
        # wall stamp travels from the consumer through the descriptor);
        # a span attribute for the trace timeline, never a liveness
        # verdict
        age_s = (round(max(0.0, time.time() - ingest_us / 1e6), 6)
                 if ingest_us else 0.0)
        batch = None
        records = None
        if self._use_wire:
            from ..models.proto_bridge import WireShredError

            try:
                with stage("worker.shred", records=count,
                           ingest_age_s=age_s):
                    batch = self.columnarizer.columnarize_buffer(payload,
                                                                 offs)
            except WireShredError:
                batch = None
        if batch is not None:
            if self.current_file is None:
                self._open_file()
            self._retry(self.current_file.flush_buffered, "flush")
            with stage("worker.append"):
                self.current_file.append_batch(batch)
            # slot memory is no longer referenced (shredder outputs are
            # fresh arrays) and the rows are IN the open file — recycle.
            # This message is also the parent's "written" edge, so it
            # must not precede the append (a death in between would
            # count written rows that never entered any file).
            self.ack_q.put(("free", self.cfg.index, slot_idx, seq))
            self._written_records += count
            self._written_bytes += nbytes
            self._retry(self.current_file.maybe_flush_row_group, "flush")
        else:
            # fallback: materialize + parse per record (poison-pill
            # policies live here, exactly like thread mode)
            blob = bytes(payload)
            records = [blob[int(offs[i]): int(offs[i + 1])]
                       for i in range(count)]
            parsed = self._parse_fallback(records, partition, start_offset)
            if not parsed:
                # nothing written for this unit: it is already safe
                # (skipped/dead-lettered) — recycle + ack, no publish
                self.ack_q.put(("free", self.cfg.index, slot_idx, seq))
                self.ack_q.put(("published", self.cfg.index, [seq], None,
                                self._retry_stats()))
                return
            if self.current_file is None:
                self._open_file()
            self.current_file.append_records(parsed)
            self.ack_q.put(("free", self.cfg.index, slot_idx, seq))
            self._written_records += len(parsed)
            self._written_bytes += nbytes
            self._retry(self.current_file.flush_if_full, "flush")
        self._pending_seqs.append(seq)
        self._pending_parts.add(partition)
        if (self.current_file is not None
                and self.current_file.get_data_size()
                >= self.cfg.max_file_size):
            self._finalize("size")

    def _parse_fallback(self, payloads: list, partition: int,
                        start_offset: int) -> list:
        parsed = []
        for i, raw in enumerate(payloads):
            try:
                parsed.append(self.proto_class.FromString(raw))
            except Exception:
                if self.cfg.on_parse_error == "dead_letter":
                    self._retry(lambda r=raw, o=start_offset + i:
                                self._dead_letter(partition, o, r),
                                "dead_letter")
                elif self.cfg.on_parse_error != "skip":
                    raise
        return parsed

    def _dead_letter(self, partition: int, offset: int, raw: bytes) -> None:
        d = f"{self.cfg.target_dir}/deadletter"
        self.fs.mkdirs(d)
        path = f"{d}/{self.cfg.instance_name}_{self.cfg.index}.bin"
        frame = struct.pack("<iqI", partition, offset, len(raw)) + raw
        with self.fs.open_append(path) as f:
            f.write(frame)
        self._deadletter_records += 1

    # -- files -----------------------------------------------------------------
    def _open_file(self) -> None:
        from .parquet_file import ParquetFile

        def make():
            tmp_dir = f"{self.cfg.target_dir}/tmp"
            self.fs.mkdirs(tmp_dir)
            import random

            path = (f"{tmp_dir}/{self.cfg.instance_name}_"
                    f"{self.cfg.index}_{random.getrandbits(63)}.tmp")
            return ParquetFile(self.fs, path, self.columnarizer,
                               self.cfg.properties,
                               batch_size=self.cfg.batch_size,
                               encoder=self._encoder_factory(),
                               pipeline=bool(self.cfg.pipeline),
                               est_record_bytes=self._carry_est,
                               retry_policy=self.retry,
                               heartbeat=self.heartbeat)

        self.current_file = self._retry(make, "open")

    def _service_fences(self, fence: dict) -> None:
        """Service the accumulated fence descriptors, abandon flavor
        first (its partitions' rows must not publish at all)."""
        ab = frozenset(p for p, m in fence.items() if m == "abandon")
        fl = frozenset(p for p, m in fence.items() if m == "flush")
        if ab:
            self._service_revoke(ab, "abandon")
        if fl:
            self._service_revoke(fl, "flush")

    def _service_revoke(self, parts: frozenset, mode: str) -> None:
        """One fence descriptor from the parent.  ``flush``: the drain
        window is open — publish+ack the open file now if it holds any
        revoked partition's rows (rotation cause ``revoke``, exactly the
        thread-mode `_service_fence` flavor).  ``abandon``: the window
        lapsed or the assignment is LOST — publishing would only earn a
        fenced commit, so the open file is dropped whole and its units
        reported ``abandoned`` (the parent redelivers retained-partition
        runs; revoked ones ride the committed frontier to the new owner).

        Work-queue FIFO makes the protocol race-free child-side: every
        unit dispatched before the fence lands in the open file before
        this runs, so the flush/abandon decision covers them all."""
        if not (self._pending_parts & parts):
            return  # open file (if any) holds only retained partitions
        if mode == "abandon":
            seqs, self._pending_seqs = self._pending_seqs, []
            self._pending_parts.clear()
            self._abandon("revoke")
            self._rebalance_abandoned += 1
            self.ack_q.put(("abandoned", self.cfg.index, seqs))
            self._maybe_send_telemetry()
            return
        self._rebalance_fenced += 1
        self._finalize("revoke")

    def _maybe_time_rotate(self) -> None:
        f = self.current_file
        # lint: clock-discipline ok — wall-clock file-age rotation
        # mirrors thread mode exactly (ParquetFile.get_creation_time is
        # wall time); rotation is a naming/policy deadline, never a
        # liveness verdict — a clock step rotates a file early, it
        # cannot condemn a worker
        if (f is not None and time.time() - f.get_creation_time()
                >= self.cfg.max_file_open_duration):
            self._finalize("time")

    def _finalize(self, reason: str) -> None:
        f = self.current_file
        if f is None:
            return
        f.rotation_reason = reason
        self._carry_est = f.est_record_bytes
        if f.get_num_written_records() == 0:
            self._retry(f.close, "close")
            self._retry(lambda: self.fs.delete(f.path), "close")
            self.current_file = None
            # an empty file can still cover all-skipped units
            self._ack_pending(None, reason)
            return
        self._retry(f.close, "close")
        size = self.fs.size(f.path)
        # publish: (verify) -> collision-safe dest -> (durable) rename —
        # the rename tail is the SHARED writer.publish_rename protocol,
        # so thread and process mode cannot drift
        from .writer import _format_now, publish_rename

        with stage("worker.publish"):
            if self.cfg.verify_on_publish:
                from ..io.verify import verify_file

                rep = verify_file(self.fs, f.path)
                if not rep.ok:
                    qdir = f"{self.cfg.target_dir}/quarantine"
                    self.fs.mkdirs(qdir)
                    qpath = f"{qdir}/{f.path.rsplit('/', 1)[-1]}"
                    n = 0
                    while self.fs.exists(qpath):
                        n += 1
                        qpath = (f"{qdir}/{f.path.rsplit('/', 1)[-1]}.{n}")
                    self.fs.rename(f.path, qpath)
                    # the parent meters the failure + quarantine; the
                    # raise below kills this child un-acked (redelivery)
                    self.ack_q.put(("verify_failed", self.cfg.index))
                    raise RuntimeError(
                        f"tmp failed structural verification, quarantined "
                        f"to {qpath}: {rep.errors[:3]}")
            dest_dir = self.cfg.target_dir
            if self.cfg.directory_date_time_pattern:
                dest_dir = (f"{dest_dir}/"
                            f"{_format_now(self.cfg.directory_date_time_pattern)}")
                self._retry(lambda d=dest_dir: self.fs.mkdirs(d), "publish")
            ts = _format_now(self.cfg.file_date_time_pattern)
            name = (f"{ts}_{self.cfg.instance_name}_{self.cfg.index}"
                    f"{self.cfg.file_extension}")
            if self._publish_gate:
                # zombie-child drill seam: park mid-publish (heartbeat
                # pending under "publish") until the gate file is removed
                tok = self.heartbeat.io_started("publish")
                try:
                    while (os.path.exists(self._publish_gate)
                           and not self._stop.is_set()):
                        time.sleep(0.01)
                finally:
                    self.heartbeat.io_finished(tok)
            dest = publish_rename(self.fs, self._retry, f.path, dest_dir,
                                  name, self.cfg.durable_publish)
        info = {
            "size": size,
            "records": f.get_num_written_records(),
            "reason": reason,
            # the published path rides the ack so the parent's fenced-ack
            # backstop can un-publish a zombie child's file (the parent
            # and child share the local tree — proc mode pins the fs)
            "dest": dest,
            "verified": bool(self.cfg.verify_on_publish),
            "index": f.index_info(),
            "assembly": f.assembly_info(),
        }
        self._files_published += 1
        self._flushed_records += info["records"]
        self._flushed_bytes += size
        if reason == "time":
            self._rot_time += 1
        elif reason != "revoke":  # revoke counts via _rebalance_fenced
            self._rot_size += 1
        self.current_file = None
        self._ack_pending(info, reason)

    def _ack_pending(self, file_info, reason: str) -> None:
        """Every unit whose rows are now durably published (or that wrote
        nothing) is safe to ack — the parent commits their offset runs."""
        self._pending_parts.clear()
        if not self._pending_seqs:
            if file_info is not None:
                self.ack_q.put(("published", self.cfg.index, [], file_info,
                                self._retry_stats()))
                self._maybe_send_telemetry()
            return
        seqs, self._pending_seqs = self._pending_seqs, []
        self.ack_q.put(("published", self.cfg.index, seqs, file_info,
                        self._retry_stats()))
        # seal boundary: the natural low-rate beat for the side channel
        self._maybe_send_telemetry()

    def _retry_stats(self) -> tuple:
        """(retries, backoff_s, last_error) riding every published-file
        ack so the parent slot's observability mirrors thread mode."""
        return (self._retries, round(self._backoff_s, 6), self._last_error)

    def _abandon(self, reason: str) -> None:
        f = self.current_file
        if f is None:
            return
        try:
            f.rotation_reason = reason
            f.abandon()
        except Exception:
            logger.exception("proc worker %d: abandon failed (ignored)",
                             self.cfg.index)
        self.current_file = None
        self._pending_parts.clear()


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------

class _ProcWorkerSlot:
    """Parent-side handle for one worker process — the ``_Worker`` duck
    type: the supervisor joins/restarts it, the watchdog scans its
    heartbeat, ``stats()``/``ack_lag()`` read the same attributes.  The
    decisive difference from a thread slot: ``condemn`` **SIGKILLs** the
    process, so a hung child is actually reclaimed instead of parked."""

    def __init__(self, pool: "ProcessWorkerPool", index: int) -> None:
        self.pool = pool
        self.index = index
        self.work_q = _MP_CTX.Queue()
        self._proc = _MP_CTX.Process(
            target=child_main,
            args=(pool.child_config(index), self.work_q, pool.ack_q),
            name=f"KPW-proc-{pool.instance_name}-{index}",
            daemon=True)
        self.heartbeat = _ProcHeartbeat(pool.ring, index)
        self.failed = False
        self.condemned = False
        self.ready = False  # set by the collector on the child's hello
        self.exit_reason: str | None = None
        self.retries = 0
        self.backoff_s = 0.0
        self.last_error: str | None = None
        self.pid: int | None = None
        # seq -> {"runs": [(p, s, e)], "count", "bytes", "slot", "freed",
        #          "sent", "fenced"} — guarded by _mu: dispatcher inserts
        # (sent=False) and marks sent under the lock, collector settles,
        # the supervisor reads held_runs() after join, the rebalance
        # listener backs out un-sent revoked units / force-releases runs
        self._mu = threading.Lock()
        self._ledger: dict[int, dict] = {}
        # sticky cooperative-revocation fence: partitions whose drain
        # window is open (GIL-atomic frozenset swaps, the thread
        # worker's _fence_req discipline — fetcher thread writes,
        # dispatcher reads)
        self._fence_flush: frozenset = frozenset()
        self._unacked_count = 0
        self._oldest_unacked_ts: float | None = None
        self._written = 0
        self._published_files = 0
        self._poisoned = False
        # stats() compatibility with the thread worker
        self._part_files: dict = {}

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> None:
        self._proc.start()
        self.pid = self._proc.pid

    def alive(self) -> bool:
        return self._proc.is_alive()

    def join(self, timeout: float | None = None) -> None:
        self._proc.join(timeout)

    def condemn(self, reason: str) -> None:
        """Watchdog abandon, process edition: the hung child is killed
        outright (its tmp stays on disk, swept next start; its held runs
        redeliver), and the slot is declared failed for the supervisor."""
        self.condemned = True
        self.exit_reason = reason
        self.failed = True
        try:
            self._proc.kill()
        except (OSError, ValueError):
            pass

    def close(self, timeout: float = 30.0,
              abandon_if_hung: bool = True) -> bool:
        """Poison → join → escalate.  The child abandons its open tmp on
        poison (never published, never acked — thread-mode close
        semantics); a child still alive at the deadline is terminated,
        then killed."""
        if not self._poisoned:
            self._poisoned = True
            try:
                self.work_q.put(None)
            except (OSError, ValueError):
                pass
        self._proc.join(timeout=max(0.0, timeout))
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=1.0)
            if self._proc.is_alive() and abandon_if_hung:
                self._proc.kill()
                self._proc.join(timeout=1.0)
        self.work_q.close()
        return not self._proc.is_alive()

    # -- supervisor surface ----------------------------------------------------
    def unacked(self) -> tuple[int, float | None]:
        """(records written and not yet acked, first write of the
        oldest of them): this slot's share of the writer's ``ack_lag``."""
        return self._unacked_count, self._oldest_unacked_ts

    def held_runs(self) -> list[tuple[int, int, int]]:
        """Every offset run dispatched to this child and never acked —
        the redelivery set after a death.  Mirrors ``_Worker.held_runs``
        (called by the supervisor AFTER joining the dead process)."""
        with self._mu:
            return [tuple(r) for e in self._ledger.values()
                    for r in e["runs"]]

    def drain_unfreed_slots(self) -> list[int]:
        """Ring slots dispatched to this child that it never reported
        drained — reclaimed by the pool once the process is dead (a dead
        process cannot be mid-read).  Atomically marks every entry freed
        under the ledger lock: a stale ``free`` ack still in the queue
        must find nothing left to recycle, or the same ring slot would
        enter the free pool twice and two units would be staged into the
        same shared memory concurrently.  Held runs stay in the ledger
        for the supervisor's redelivery."""
        schedcheck.point("proc.slot.drain")
        with self._mu:
            out = [e["slot"] for e in self._ledger.values()
                   if not e["freed"]]
            for e in self._ledger.values():
                e["freed"] = True
            return out

    # -- cooperative-rebalance surface (the _Worker fence duck type) -----------
    def request_fence(self, parts) -> None:
        """Revocation drain window opened: back out revoked units the
        child was never handed (their ledger runs release — the new
        owner reads them off the committed frontier), then forward the
        fence descriptor so the child flushes its open file early.  The
        fence is STICKY until ``fence_clear`` (mirroring the thread
        worker's ``_fence_req``): a batch buffered before the revoke can
        still dispatch after this descriptor, and the dispatcher re-sends
        the fence behind any such late unit so FIFO flushes it too."""
        ps = frozenset(parts)
        self._fence_flush = frozenset(self._fence_flush | ps)
        self.pool.backout_undispatched(self, ps)
        self._send_revoke(ps, "flush")

    def request_abandon(self, parts) -> None:
        """Drain deadline lapsed or assignment LOST: back out un-sent
        revoked units, force-release the revoked runs still in flight
        (held_runs() must stop reporting them even when the child is
        parked/unresponsive — the rejoin waits on that), and tell the
        child to drop its open file.  A file the parked child publishes
        later settles to zero acked runs and the collector's fenced
        backstop un-publishes it, so the release cannot double-count."""
        ps = frozenset(parts)
        # supersede any pending flush fence for them (thread-worker
        # request_abandon parity: their commits could no longer land)
        self._fence_flush = frozenset(self._fence_flush - ps)
        self.pool.backout_undispatched(self, ps)
        with self._mu:
            for e in self._ledger.values():
                if e["runs"] and any(r[0] in ps for r in e["runs"]):
                    e["runs"] = []
                    e["fenced"] = True
        self._send_revoke(ps, "abandon")

    def fence_clear(self, parts) -> None:
        """Drain confirmed for ``parts``: retire their sticky flush
        fence (the child-side state was consumed when the descriptor
        was serviced)."""
        self._fence_flush = frozenset(self._fence_flush - frozenset(parts))

    def _send_revoke(self, ps: frozenset, mode: str) -> None:
        rec = getattr(self.pool.w, "_flightrec", None)
        if rec is not None:
            rec.note("rebalance_fence_sent", worker=self.index,
                     partitions=sorted(ps), mode=mode)
        try:
            self.work_q.put(("revoke", tuple(sorted(ps)), mode))
        except (OSError, ValueError):
            pass  # child torn down; its ledger redelivers via the supervisor

    # -- ledger (dispatcher/collector) -----------------------------------------
    def note_dispatch(self, seq: int, runs, count: int, nbytes: int,
                      slot_idx: int) -> None:
        with self._mu:
            self._ledger[seq] = {"runs": runs, "count": count,
                                 "bytes": nbytes, "slot": slot_idx,
                                 "freed": False, "sent": False,
                                 "fenced": False}
            if self._oldest_unacked_ts is None:
                # lint: clock-discipline ok — operator-facing ack-age
                # observability matches thread-mode stats() (wall
                # timestamps); never consulted by watchdog/condemn logic
                self._oldest_unacked_ts = time.time()
            self._unacked_count += count

    def note_free(self, seq: int) -> tuple[int, int]:
        """The child drained the unit's ring slot (== its rows entered an
        open file).  Returns (count, bytes) for the written meters —
        (0, 0) when the entry is unknown OR already freed (a stale ack
        from a dead child whose slots ``drain_unfreed_slots`` reclaimed:
        recycling again would double-free the ring slot)."""
        schedcheck.point("proc.slot.note_free")
        with self._mu:
            e = self._ledger.get(seq)
            if e is None or e["freed"]:
                return 0, 0
            e["freed"] = True
            self._written += e["count"]
            return e["count"], e["bytes"]

    def mark_sent(self, seq: int) -> bool:
        """Dispatcher, immediately before the work-queue put: commit to
        sending.  Returns False when a concurrent revocation already
        backed the unit out — the put must not happen (the ring slot is
        recycled and the runs belong to the new owner)."""
        with self._mu:
            e = self._ledger.get(seq)
            if e is None:
                return False
            e["sent"] = True
            return True

    def backout_units(self, parts: frozenset) -> list[int]:
        """Pop every revoked unit the child was never handed (sent=False)
        and whose ring slot is still staged (freed=False): its runs were
        never processed anywhere, so dropping the entry hands them to the
        new owner via the committed frontier.  Returns the ring slots to
        recycle — the caller routes them through ``_recycle_slot`` so the
        double-recycle probe guards this path against the collector's
        concurrent ``free`` handling for the same slot."""
        with self._mu:
            out = []
            for seq, e in list(self._ledger.items()):
                if (not e["sent"] and not e["freed"] and e["runs"]
                        and all(r[0] in parts for r in e["runs"])):
                    self._ledger.pop(seq)
                    self._unacked_count = max(
                        0, self._unacked_count - e["count"])
                    out.append(e["slot"])
            if not self._ledger:
                self._oldest_unacked_ts = None
            return out

    def settle(self, seq: int):
        """The unit's rows are durably published (or needed no publish):
        pop its runs for acking."""
        return self.settle_unit(seq)[0]

    def peek_unit(self, seq: int) -> tuple[list, bool]:
        """(runs, fenced) WITHOUT popping the entry: the collector acks
        off the peek and settles only after the commits land, so
        ``held_runs()`` keeps reporting the runs until they are durable
        — ``revocation_drained`` must not confirm a handoff whose
        offsets have not committed yet (the new owner would refetch
        rows this member's file already published)."""
        with self._mu:
            e = self._ledger.get(seq)
            if e is None:
                return [], False
            return list(e["runs"]), bool(e.get("fenced"))

    def settle_unit(self, seq: int) -> tuple[list, bool]:
        """(runs, fenced): pop the unit; ``fenced`` is True when a
        revocation already force-released its runs — the ack arriving
        now is a zombie child's stale publish, and a file settling to
        zero acked runs with any fenced unit must be un-published."""
        with self._mu:
            e = self._ledger.pop(seq, None)
            if e is None:
                return [], False
            self._unacked_count = max(0, self._unacked_count - e["count"])
            if not self._ledger:
                self._oldest_unacked_ts = None
            return e["runs"], bool(e.get("fenced"))

    def inflight_units(self) -> int:
        with self._mu:
            return len(self._ledger)

    # -- observability ---------------------------------------------------------
    def rss_bytes(self) -> int:
        if self.pid is None:
            return 0
        try:
            with open(f"/proc/{self.pid}/statm") as f:
                return int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE")
        except (OSError, IndexError, ValueError):
            return 0

    def open_partitions(self) -> list:
        return []

    def observability(self) -> dict:
        """Same key shape as ``_Worker.observability`` so ``stats()``
        folds both modes uniformly, plus the process-mode extras."""
        ts = self._oldest_unacked_ts
        stall_age, stall_label = self.heartbeat.stall()
        return {
            "worker": self.index,
            "mode": "process",
            "pid": self.pid,
            "alive": self.alive(),
            "failed": self.failed,
            "condemned": self.condemned,
            "stall_age_s": round(stall_age, 3),
            "stalled_in": stall_label,
            "exit_reason": self.exit_reason,
            "restarts": self.pool.restart_count(self.index),
            "retries": self.retries,
            "retry_backoff_s": round(self.backoff_s, 6),
            "last_error": self.last_error,
            "unacked_records": self._unacked_count,
            # lint: clock-discipline ok — observability age over the
            # wall timestamp recorded above; stats()-only, not liveness
            "oldest_unacked_age_s": (round(time.time() - ts, 6)
                                     if ts is not None else 0.0),
            "open_partitions": [],
            "proc_rate_rps": 0.0,
            "poll_batch": 0,
            "rss_bytes": self.rss_bytes(),
            "inflight_units": self.inflight_units(),
            "written_records": self._written,
            "published_files": self._published_files,
            "pipeline": {"files": self._published_files,
                         "split_assembly": False, "stage_busy_s": {},
                         "queues": {}},
        }


class ProcessWorkerPool:
    """The parent's process-mode engine: the shared-memory ring, one
    dispatcher thread (consumer queue → ring slots → per-child work
    queues) and one collector thread (child acks → offset commits +
    meters + liveness).  Owned by :class:`KafkaProtoParquetWriter`;
    ``slots`` is the live worker list the writer aliases as
    ``self._workers`` so the supervisor, watchdog and stats
    machinery operate on process slots unchanged."""

    def __init__(self, writer) -> None:
        self.w = writer
        b = writer._b
        self.instance_name = b._instance_name
        self.n_workers = b._proc_workers
        if self.n_workers > _HB_MAX:
            raise ValueError(f"process_workers supports at most {_HB_MAX}")
        self.ring = ShmBatchRing(b._proc_ring_slots, b._proc_slot_bytes)
        self.ack_q = _MP_CTX.Queue()
        self._max_inflight = b._proc_max_inflight
        self.slots: list[_ProcWorkerSlot] = [
            _ProcWorkerSlot(self, i) for i in range(self.n_workers)]
        self._free: pyqueue.Queue = pyqueue.Queue()
        self._pool_key = id(self)
        schedcheck.note_pool_reset(self._pool_key, b._proc_ring_slots)
        for i in range(b._proc_ring_slots):
            self._free.put(i)
        self._stop = threading.Event()
        self._seq = 0
        self._rr = 0
        self.dispatched_units = 0
        self.acked_units = 0
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop,
            name=f"KPW-proc-dispatch-{self.instance_name}", daemon=True)
        self._collector = threading.Thread(
            target=self._collect_loop,
            name=f"KPW-proc-collect-{self.instance_name}", daemon=True)
        self._closed = False

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> None:
        self._build_kernels()
        for s in self.slots:
            s.start()
        self._collector.start()
        self._dispatcher.start()

    def _build_kernels(self) -> None:
        """Build every CUDA kernel here, in the parent, before a child that
        runs a card encoder spawns: the children (and their respawns) then
        load the finished libraries and never start ``nvcc``."""
        b = self.w._b
        if b._backend not in ("cuda", "auto"):
            return
        from ..device import resolve_device

        if resolve_device(b._backend_device).type == "cuda":
            from ..ops import _build

            _build.build()

    def child_config(self, index: int) -> ChildConfig:
        b = self.w._b
        return ChildConfig(b, index, self.ring.name, b._proc_ring_slots,
                           b._proc_slot_bytes)

    def restart_count(self, index: int) -> int:
        return self.w._restart_counts[index]

    def respawn_slot(self, index: int) -> _ProcWorkerSlot:
        """Supervisor restart: the dead slot's un-drained ring slots are
        reclaimed (the process is joined-dead, it cannot be mid-read) and
        a fresh process takes the index.  Held-run redelivery stays the
        supervisor's job, same as thread mode."""
        schedcheck.point("proc.pool.respawn")
        old = self.slots[index]
        for ring_idx in old.drain_unfreed_slots():
            self._recycle_slot(ring_idx)
        old.work_q.close()
        # bank the dead child's final telemetry counters (and clear the
        # cell for the successor) BEFORE the heartbeat clear: merged
        # scrape totals stay monotonic across restarts, and the dead
        # cell can never poison a later scrape
        self.w._bank_child_telemetry(index)
        # a child killed MID-IO leaves pending=1 in its heartbeat cell;
        # left stale, the watchdog would age it through the replacement's
        # spawn import and condemn the healthy newborn
        self.ring.hb_clear(index)
        fresh = _ProcWorkerSlot(self, index)
        self.slots[index] = fresh
        return fresh

    def healthy(self) -> bool:
        return (self._dispatcher.is_alive() and self._collector.is_alive()
                and not self._closed)

    def close(self, timeout: float = 10.0) -> None:
        """Stop dispatch FIRST (no new units), then the writer closes each
        slot (poison/join), then the collector drains and the ring is
        unlinked via :meth:`finalize`."""
        self._stop.set()
        self._dispatcher.join(timeout=timeout)

    def finalize(self, timeout: float = 5.0) -> None:
        self._closed = True
        self._collector.join(timeout=timeout)
        # bank every child's final counters before the views go away so
        # post-close stats()/scrapes keep the tree's lifetime totals
        for s in self.slots:
            self.w._bank_child_telemetry(s.index)
        self.ring.close()
        self.ring.unlink()

    def _recycle_slot(self, ring_idx: int) -> None:
        """THE re-entry point to the ring free pool — every recycler
        (collector free ack, respawn reclaim, dispatch backout) routes
        through here so the schedule explorer's double-recycle probe
        guards all of them: a slot entering the pool while already free
        is the double-free, whichever interleaving produced it."""
        schedcheck.note_slot_recycled(self._pool_key, ring_idx)
        self._free.put(ring_idx)

    def backout_undispatched(self, slot: _ProcWorkerSlot,
                             parts: frozenset) -> int:
        """Revocation met a unit still sitting un-dispatched in the ring
        (staged, ledger'd, never handed to the child): back it out whole.
        The runs release with the ledger entry (the new owner reads them
        from the committed frontier — sending now would double-write),
        and the ring slot recycles through the probed single re-entry
        point: the collector's ``free`` handling for the same slot is the
        racing party, the cross-process analog of the stale-free/
        respawn double recycle."""
        # schedule-explorer edge, BEFORE the ledger pop: the collector's
        # ``free`` handling for a unit of the same child races this
        # back-out — a shape that takes entries the dispatcher already
        # committed to sending (or the child already freed) recycles the
        # same ring slot twice, and the probe in _recycle_slot catches it
        schedcheck.point("proc.revoke.backout")
        backed = slot.backout_units(parts)
        for ring_idx in backed:
            self._recycle_slot(ring_idx)
        if backed:
            rec = getattr(self.w, "_flightrec", None)
            if rec is not None:
                rec.note("rebalance_backout", worker=slot.index,
                         units=len(backed))
        return len(backed)

    def redeliver_async(self, runs, label: str) -> None:
        """Redeliver abandoned runs off the collector thread (the
        consumer's redeliver path can block on a full queue and drops
        revoked/unassigned partitions itself — the retained-vs-revoked
        filter lives there, same as thread mode)."""
        if not runs:
            return
        t = threading.Thread(
            target=self._redeliver_runs, args=(list(runs),),
            name=f"KPW-proc-redeliver-{label}", daemon=True)
        t.start()

    def _redeliver_runs(self, runs) -> None:
        for p, s, e in runs:
            try:
                self.w.consumer.redeliver_run(p, s, e - s,
                                              stop_event=self._stop)
            except Exception:
                logger.exception("proc redelivery of %s failed", (p, s, e))

    # -- stats ------------------------------------------------------------------
    def ring_free(self) -> int:
        return self._free.qsize()

    def snapshot(self) -> dict:
        return {
            "workers": self.n_workers,
            "ring": {"slots": self.ring.slots,
                     "slot_bytes": self.ring.slot_bytes,
                     "free": self.ring_free(),
                     "shm_name": self.ring.name},
            "dispatched_units": self.dispatched_units,
            "acked_units": self.acked_units,
            "inflight_units": sum(s.inflight_units() for s in self.slots),
            "children": [{"worker": s.index, "pid": s.pid,
                          "alive": s.alive(),
                          "rss_bytes": s.rss_bytes(),
                          "inflight_units": s.inflight_units(),
                          "restarts": self.restart_count(s.index)}
                         for s in self.slots],
        }

    # -- dispatcher --------------------------------------------------------------
    def _dispatch_loop(self) -> None:
        try:
            # startup barrier: hold the first dispatch until every child
            # reported ready — spawn costs ~1-2 s of interpreter import,
            # and dispatching meanwhile would drain the backlog through
            # the first child alone (skewing short replays and bunching
            # every early unit's redelivery risk on one process)
            while (not self._stop.is_set()
                   and any(not s.ready and not s.failed
                           for s in self.slots)):
                time.sleep(0.01)
            while not self._stop.is_set():
                items, _runs = self.w.consumer.poll_many_batches(
                    self._poll_cap())
                if not items:
                    time.sleep(0.001)
                    continue
                with stage("worker.proc.dispatch"):
                    if not self._dispatch_round(items):
                        return  # shutting down mid-round
        except RetryInterrupted:
            pass  # close() interrupted a dead-letter retry
        except Exception:
            logger.exception("proc dispatcher died; process workers "
                             "starve (writer unhealthy)")

    def _poll_cap(self) -> int:
        # drain up to a few slots' worth per poll round at the ~64 B/rec
        # cfg6 shape; split-to-fit handles anything fatter per unit
        return max(256, 2 * self.ring.max_records_for(64.0))

    def _normalize_item(self, item):
        """One queue chunk -> (partition, start, offsets, payload,
        exact_runs).  ``exact_runs`` is None for an offset-contiguous
        chunk (the run is derivable as one (partition, start, count));
        a gapped Record list (compacted topic) carries its exact
        per-record runs instead.  Returns None for an empty chunk."""
        if isinstance(item, RecordBatch):
            if len(item) == 0:
                return None
            return (item.partition, item.start_offset,
                    np.ascontiguousarray(item.offsets, np.int64),
                    item.payload, None)
        if not item:
            return None
        blob = b"".join(r.value for r in item)
        lens = np.fromiter((len(r.value) for r in item), np.int64,
                           count=len(item))
        offs = np.zeros(len(item) + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        contiguous = item[-1].offset - item[0].offset == len(item) - 1
        exact = (None if contiguous
                 else [(r.partition, r.offset, r.offset + 1)
                       for r in item])
        return item[0].partition, item[0].offset, offs, blob, exact

    def _dispatch_round(self, items) -> bool:
        """Dispatch one poll round: offset-contiguous chunks of the same
        partition PACK into shared ring slots (merged offsets table, one
        staging memcpy each) so unit size tracks slot capacity rather
        than broker fetch granularity — with small fetches, one-unit-per-
        fetch made the per-unit fixed costs (queue messages, flush
        checks, ack round trips) the child's throughput ceiling.  Gapped
        chunks dispatch alone with exact per-record runs; oversized
        chunks split to fit.  Returns False when shutdown interrupted
        the round (the remainder stays tracked-but-unacked: redelivered
        to the next instance — the thread-mode close contract)."""
        packs: dict[int, dict] = {}
        for item in items:
            norm = self._normalize_item(item)
            if norm is None:
                continue
            partition, start, offs, payload, exact_runs = norm
            count = len(offs) - 1
            nbytes = int(offs[-1] - offs[0])
            if exact_runs is not None:
                # gapped: flush the partition's pack (order!), go alone
                if not self._flush_pack(packs.pop(partition, None)):
                    return False
                if not self._dispatch_split(partition, start, offs,
                                            payload, exact_runs):
                    return False
                continue
            pack = packs.get(partition)
            if pack is not None and (
                    pack["end"] != start
                    or not self.ring.fits(pack["count"] + count,
                                          pack["bytes"] + nbytes)):
                if not self._flush_pack(packs.pop(partition)):
                    return False
                pack = None
            if pack is None:
                if not self.ring.fits(count, nbytes):
                    if not self._dispatch_split(partition, start, offs,
                                                payload, None):
                        return False
                    continue
                packs[partition] = {
                    "partition": partition, "start": start,
                    "end": start + count, "count": count,
                    "bytes": nbytes, "parts": [(offs, payload)]}
            else:
                pack["parts"].append((offs, payload))
                pack["count"] += count
                pack["bytes"] += nbytes
                pack["end"] = start + count
        for pack in packs.values():
            if not self._flush_pack(pack):
                return False
        return True

    def _flush_pack(self, pack) -> bool:
        if pack is None:
            return True
        runs = [(pack["partition"], pack["start"],
                 pack["start"] + pack["count"])]
        return self._dispatch_unit(pack["partition"], pack["start"],
                                   pack["parts"], pack["count"],
                                   pack["bytes"], runs)

    def _dispatch_split(self, partition: int, start: int,
                        offs: np.ndarray, payload, exact_runs) -> bool:
        """Split one chunk across as many slots as its bytes need.  A
        gapped chunk (``exact_runs``) dispatches one record per unit so
        the child's ``start_offset + i`` offset arithmetic (dead-letter
        frame labels) stays exact — gapped batches are the rare
        compacted-topic shape, never the hot path."""
        n = len(offs) - 1
        pos = 0
        while pos < n:
            if exact_runs is not None:
                take = 1
            else:
                avg = max(1.0, float(offs[-1] - offs[0]) / n)
                take = min(n - pos, self.ring.max_records_for(avg))
                while take > 1 and not self.ring.fits(
                        take, int(offs[pos + take] - offs[pos])):
                    take = max(1, take // 2)
            rec_off = (start + pos if exact_runs is None
                       else exact_runs[pos][1])
            if take == 1 and not self.ring.fits(
                    1, int(offs[pos + 1] - offs[pos])):
                # a single record wider than a ring slot can never cross
                # the handoff: a poison pill at the DISPATCH layer — the
                # on_parse_error policy decides, exactly like a child-side
                # unparseable record (the first cut raised out of the
                # dispatcher thread, killing ingestion forever)
                if not self._handle_oversized(partition, rec_off,
                                              offs, payload, pos):
                    return False
                pos += 1
                continue
            sub_offs = offs[pos: pos + take + 1]
            if exact_runs is None:
                runs = [(partition, start + pos, start + pos + take)]
            else:
                runs = exact_runs[pos: pos + take]
            nbytes = int(sub_offs[-1] - sub_offs[0])
            if not self._dispatch_unit(partition, rec_off,
                                       [(sub_offs, payload)], take,
                                       nbytes, runs):
                return False
            pos += take
        return True

    def _handle_oversized(self, partition: int, offset: int,
                          offs: np.ndarray, payload, pos: int) -> bool:
        """One record too wide for any ring slot, resolved under the
        ``on_parse_error`` policy in the parent (the record cannot reach
        a child): ``raise`` kills the dispatcher — the process-mode
        analog of the reference poison pill killing the worker, visible
        via ``healthy()`` — while ``skip``/``dead_letter`` ack the
        single offset (after durable dead-letter append) and move on."""
        from ..ingest.offsets import PartitionOffset

        policy = self.w._b._on_parse_error
        nbytes = int(offs[pos + 1] - offs[pos])
        if policy == "raise":
            raise ValueError(
                f"record {partition}/{offset} ({nbytes} B) exceeds the "
                f"shared-memory slot capacity ({self.ring.slot_bytes} B); "
                f"raise process_workers(slot_bytes=...) or use "
                f"on_parse_error='skip'/'dead_letter'")
        logger.error(
            "%s oversized record %d/%d (%d B > slot capacity %d B)",
            "dead-lettering" if policy == "dead_letter" else "skipping",
            partition, offset, nbytes, self.ring.slot_bytes)
        if policy == "dead_letter":
            raw = bytes(memoryview(payload)[int(offs[pos]):
                                            int(offs[pos + 1])])
            b = self.w._b
            d = f"{self.w.target_dir}/deadletter"
            frame = struct.pack("<iqI", partition, offset, len(raw)) + raw

            def append() -> None:
                self.w.fs.mkdirs(d)
                with self.w.fs.open_append(
                        f"{d}/{b._instance_name}_dispatch.bin") as f:
                    f.write(frame)

            self.w.retry_policy.call(append, stop_event=self._stop,
                                     label="dead_letter")
        self.w.consumer.ack(PartitionOffset(partition, offset))
        return True

    def _dispatch_unit(self, partition: int, start_offset: int, parts,
                       count: int, nbytes: int, runs) -> bool:
        """Stage one unit (one or more contiguous windows) into a free
        slot and hand it to a child; ``runs`` are [start, end) tuples."""
        slot_idx = self._get_free_slot()
        if slot_idx is None:
            return False
        schedcheck.point("proc.ring.stage")
        # ack-latency anchor: the oldest covered batch's ingest
        # wall-time rides the descriptor (0 when the consumer has no
        # stamp for this run — e.g. records enqueued pre-upgrade)
        ing = self.w.consumer.ingest_stamp(partition, start_offset)
        self.ring.write_slot_parts(slot_idx, partition, start_offset,
                                   parts,
                                   ingest_us=int(ing * 1e6) if ing else 0)
        target = self._pick_child()
        if target is None:
            self._recycle_slot(slot_idx)
            return False
        self._seq += 1
        seq = self._seq
        target.note_dispatch(seq, [tuple(r) for r in runs], count, nbytes,
                             slot_idx)
        # commit-to-send under the ledger lock: a rebalance listener
        # backing out revoked un-sent units races this exact window, and
        # sending a unit whose ledger entry (and ring slot) were just
        # reclaimed would publish rows the new owner also redelivers
        if not target.mark_sent(seq):
            return not self._stop.is_set()
        try:
            target.work_q.put(("unit", seq, slot_idx))
        except (OSError, ValueError):
            # the child died between pick and put: the ledger entry makes
            # the runs redeliverable through the supervisor path
            return not self._stop.is_set()
        self.dispatched_units += 1
        if partition in target._fence_flush:
            # a batch buffered before the revoke dispatched AFTER the
            # fence descriptor: re-send it so work-queue FIFO flushes
            # this late unit inside the drain window too
            target._send_revoke(frozenset({partition}), "flush")
        return True

    def _get_free_slot(self):
        while not self._stop.is_set():
            try:
                idx = self._free.get(timeout=0.1)
            except pyqueue.Empty:
                continue
            schedcheck.note_slot_taken(self._pool_key, idx)
            return idx
        return None

    def _pick_child(self):
        """Round-robin over live, un-failed children with inflight
        headroom; blocks (stop-aware) while everyone is saturated —
        this, plus the bounded ring, is the process-mode backpressure."""
        while not self._stop.is_set():
            for k in range(len(self.slots)):
                s = self.slots[(self._rr + k) % len(self.slots)]
                if (not s.failed and not s._poisoned and s.alive()
                        and s.inflight_units() < self._max_inflight):
                    self._rr = (self._rr + k + 1) % len(self.slots)
                    return s
            time.sleep(0.002)
        return None

    # -- collector ---------------------------------------------------------------
    def _collect_loop(self) -> None:
        try:
            last_monitor = time.monotonic()
            while True:
                try:
                    msg = self.ack_q.get(timeout=0.2)
                except pyqueue.Empty:
                    if self._closed:
                        return
                    msg = None
                # liveness is TIME-based, not idle-based: under sustained
                # ack traffic from surviving children the queue never goes
                # Empty, and an OOM-killed child (no death notice) would
                # otherwise hold its unacked runs forever
                now = time.monotonic()
                if now - last_monitor >= 0.2:
                    last_monitor = now
                    self._monitor_liveness()
                if msg is not None:
                    self._handle(msg)
        except Exception:
            logger.exception("proc collector died; acks stop flowing "
                             "(writer unhealthy)")

    def _handle(self, msg) -> None:
        kind = msg[0]
        if kind == "free":
            _, widx, ring_idx, seq = msg
            schedcheck.point("proc.collector.free")
            count, nbytes = self.slots[widx].note_free(seq)
            if count:
                self.w._written_records.mark(count)
                self.w._written_bytes.mark(nbytes)
                # recycle ONLY when the ledger entry existed: a stale
                # "free" from a dead child's last breath arrives after
                # respawn_slot already reclaimed its un-drained slots,
                # and honoring it would double-free the ring slot (two
                # concurrent units staged into the same memory)
                self._recycle_slot(ring_idx)
        elif kind == "published":
            _, widx, seqs, file_info, retry_stats = msg
            slot = self.slots[widx]
            slot.retries, slot.backoff_s, slot.last_error = retry_stats
            acked_runs = 0
            fenced = False
            fenced_runs: list = []
            with stage("worker.proc.ack"):
                for seq in seqs:
                    runs, was_fenced = slot.peek_unit(seq)
                    fenced |= was_fenced
                    for p, s, e in runs:
                        try:
                            self.w.consumer.ack_run(p, s, e - s)
                            acked_runs += 1
                        except StaleGenerationError:
                            # the broker fenced this commit: the child
                            # published across a generation bump (zombie
                            # shape) — resolved below, never fatal to
                            # the collector
                            fenced = True
                            fenced_runs.append((p, s, e))
                    # settle strictly AFTER the commits (peek/settle
                    # split): see peek_unit
                    slot.settle_unit(seq)
                    self.acked_units += 1
            if fenced:
                self.w._fenced_acks.mark()
            if file_info is not None:
                if fenced and acked_runs == 0:
                    # nothing under the file committed: un-publish it
                    # (exactly-once restored — the rows ride the
                    # committed frontier to the new owner / redelivery),
                    # the proc-mode mirror of _fenced_ack_cleanup
                    self._fenced_unpublish(widx, file_info, fenced_runs)
                    return
                if fenced:
                    rec = getattr(self.w, "_flightrec", None)
                    if rec is not None:
                        rec.note("rebalance_fenced_ack_dropped",
                                 worker=widx, mode="proc",
                                 runs=fenced_runs)
                slot._published_files += 1
                self.w._flushed_records.mark(file_info["records"])
                self.w._flushed_bytes.mark(file_info["size"])
                self.w._file_size_histogram.update(file_info["size"])
                if file_info.get("verified"):
                    self.w._verified.mark()
                reason = file_info["reason"]
                if reason == "revoke":
                    self.w._rotated_revoke.mark()
                    rec = getattr(self.w, "_flightrec", None)
                    if rec is not None:
                        rec.note("rebalance_child_drained", worker=widx,
                                 records=file_info["records"])
                else:
                    (self.w._rotated_time if reason == "time"
                     else self.w._rotated_size).mark()
                info = file_info.get("index") or {}
                if info.get("pages_indexed"):
                    self.w._indexed.mark()
                if info.get("bloom_bytes"):
                    self.w._bloom_bytes_meter.mark(info["bloom_bytes"])
                asm = file_info.get("assembly") or {}
                if asm.get("native_chunks"):
                    self.w._native_asm_chunks.mark(asm["native_chunks"])
                    self.w._native_asm_pages.mark(asm["native_pages"])
        elif kind == "abandoned":
            # the child dropped its open file on a revoke-abandon: settle
            # every covered unit and redeliver what this member RETAINS
            # (redeliver_run drops revoked/unassigned partitions itself);
            # revoked runs were force-released at request_abandon and ride
            # the committed frontier to the new owner
            _, widx, seqs = msg
            slot = self.slots[widx]
            runs: list = []
            for seq in seqs:
                rs, _was_fenced = slot.settle_unit(seq)
                runs.extend(rs)
            self.w._fence_abandons.mark()
            rec = getattr(self.w, "_flightrec", None)
            if rec is not None:
                rec.note("rebalance_child_abandoned", worker=widx,
                         units=len(seqs), retained_runs=len(runs))
            self.redeliver_async(runs, f"abandon-{widx}")
        elif kind == "died":
            _, widx, pid, reason = msg
            schedcheck.point("proc.collector.died")
            slot = self.slots[widx]
            # pid-check: a delayed death notice from the PREVIOUS
            # occupant of this index must not condemn its replacement
            acted = (slot.pid == pid and not slot.failed
                     and not slot.condemned)
            schedcheck.note_death_notice(slot.pid, pid, acted)
            if acted:
                slot.exit_reason = reason
                slot.failed = True
                self.w._failed.mark()
                self.w._notify_worker_death(widx, reason)
        elif kind == "verify_failed":
            # the child quarantined its tmp and is about to die un-acked
            # (redelivery); the parent owns the meters
            self.w._verify_failed.mark()
            self.w._quarantined.mark()
        elif kind == "telemetry":
            # the low-rate side channel: a full child snapshot (counter
            # dict + stage summary + drained span buffer) — absorbed
            # into the merged trace and stats()['telemetry']
            _, widx, payload = msg
            self.w._absorb_child_telemetry(widx, payload)
        elif kind == "ready":
            _, widx, pid = msg
            self.slots[widx].pid = pid
            self.slots[widx].ready = True
        elif kind == "closed":
            pass  # clean poison exit; close() already joins

    def _fenced_unpublish(self, widx: int, file_info: dict,
                          fenced_runs) -> None:
        """A child's publish crossed a generation fence and NOTHING under
        the file committed: delete the just-renamed dest so the tree
        stays exactly-once (the new owner republishes the same rows from
        the committed frontier), and redeliver any retained runs whose
        ack the fence rejected.  Parent and child share the local tree —
        proc mode pins the filesystem — so the parent can un-publish."""
        dest = file_info.get("dest")
        if dest:
            try:
                self.w.fs.delete(dest)
            except OSError:
                logger.exception("fenced un-publish of %s failed "
                                 "(duplicate rows possible)", dest)
        rec = getattr(self.w, "_flightrec", None)
        if rec is not None:
            rec.note("rebalance_fenced_unpublish", worker=widx,
                     dest=dest, records=file_info.get("records"))
        self.redeliver_async(fenced_runs, f"fence-{widx}")

    def _monitor_liveness(self) -> None:
        """A SIGKILLed child sends no death notice — poll exit codes so
        the supervisor still wakes (the process analog of a thread's
        silent death being visible via ``alive()``)."""
        if self._stop.is_set():
            return
        for s in self.slots:
            if (not s.failed and not s._poisoned and s.pid is not None
                    and not s.alive()):
                s.exit_reason = (f"process exited rc="
                                 f"{s._proc.exitcode}")
                s.failed = True
                self.w._failed.mark()
                self.w._notify_worker_death(s.index, s.exit_reason)
