"""The port's process workers (``kpw_tpu_torch/runtime/procworkers.py``)
against the JAX package's, on the same records: counterparts of
``tests/test_procworkers.py`` and of ``tests/test_rebalance_procs.py``'s
fence and revoke tests, each run through both packages' ``Builder`` with the
port's ``"cpu"``, ``"native"`` and ``"cuda"`` on ``device="cpu"`` beside the
JAX ``"cpu"`` / ``"native"``, asserting the same outcome: the shared-memory
ring round trip (each package reading the other's slots), build-time
validation (the JAX set, plus ``"cuda"`` accepted), end to end, kill -9
at-least-once, watchdog condemn and restart, oversized-batch splitting,
the cooperative fence and revoke, and the descriptor spec of a stand-in
class.  Besides: the kernels build in the parent before a card child
spawns, and two processes building at once compile each source once.

Every writer spawns real children over a real on-disk ``LocalFileSystem``,
so the row counts stay small and each JAX outcome is computed once per
backend.  No test sleeps a fixed time: each waits for its condition with a
deadline.
"""

import collections
import concurrent.futures
import glob
import os
import pickle
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

import kpw_tpu as J
import kpw_tpu_torch as P
from kpw_tpu.io.verify import verify_file as j_verify_file
from kpw_tpu.runtime import procworkers as JPW
from kpw_tpu_torch.io.verify import verify_file as p_verify_file
from kpw_tpu_torch.runtime import MetricRegistry as PMetricRegistry
from kpw_tpu_torch.runtime import procworkers as PPW
from kpw_tpu_torch.utils import schedcheck as p_schedcheck
from proto_helpers import sample_message_class

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

TOPIC = "procs"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# port backend -> (encoder_backend arguments, the JAX counterpart: the JAX
# package refuses its card backend in process mode)
BACKENDS = {"cpu": (("cpu",), "cpu"), "native": (("native",), "native"),
            "cuda-on-cpu": (("cuda", "cpu"), "native")}
LIMIT_S = 90.0  # each wait of a test
_JAX_OUTCOMES: dict = {}  # (scenario, JAX backend) -> outcome, run once


@pytest.fixture(autouse=True)
def _schedcheck(schedcheck_checker):
    """Every test runs with both packages' schedule-explorer probes live
    in the parent (ring double-recycle, heartbeat torn read, death-notice
    pid check) and tiny seeded jitter at their preemption points."""
    port = p_schedcheck.install(seed=0, delay_prob=0.25, max_delay_s=0.002)
    try:
        yield
    finally:
        p_schedcheck.uninstall()
    assert not port.violations, [repr(v) for v in port.violations]
    assert not schedcheck_checker.violations, [
        repr(v) for v in schedcheck_checker.violations]


def wait_until(pred, limit: float = LIMIT_S) -> bool:
    deadline = time.monotonic() + limit
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return bool(pred())


def produce_indexed(broker, cls, rows, parts, pad=0):
    identity = {}
    filler = "x" * pad
    for i in range(rows):
        m = cls(query=f"q-{i}-{filler}", timestamp=i)
        p, off = broker.produce(TOPIC, m.SerializeToString(), partition=i % parts)
        identity[(p, off)] = i
    return identity


def proc_builder(pkg, broker, cls, target, backend, procs=2, proc_kw=None):
    b = (pkg.Builder().broker(broker).topic(TOPIC).proto_class(cls)
         .target_dir(target).filesystem(pkg.LocalFileSystem())
         .instance_name("procw").group_id("g")
         .process_workers(procs, **(proc_kw or {}))
         .max_file_size(256 * 1024)
         .max_file_open_duration_seconds(0.3))
    port_args, jax_backend = BACKENDS[backend]
    if pkg is P:
        b.encoder_backend(*port_args)
    else:
        b.encoder_backend(jax_backend)
    return b


def drained(w, broker, rows, parts) -> bool:
    return wait_until(lambda: (
        sum(broker.committed("g", TOPIC, p) for p in range(parts)) >= rows
        and w.ack_lag()["unacked_records"] == 0))


def published_timestamps(pkg, target):
    """Timestamp multiset over the published files, each of which must
    pass its package's structural verifier first."""
    verify = p_verify_file if pkg is P else j_verify_file
    fs = pkg.LocalFileSystem()
    got = collections.Counter()
    files = [f for f in glob.glob(f"{target}/**/*.parquet", recursive=True)
             if f"{target}/tmp/" not in f]
    for f in files:
        rep = verify(fs, f)
        assert rep.ok, (f, rep.errors)
        for r in pq.read_table(f).to_pylist():
            got[r["timestamp"]] += 1
    return got, files


def both(name, scenario, backend, tmp_path, side_by_side=True):
    """``scenario(pkg, backend, target)`` for the port on ``backend`` and
    for the JAX package on its counterpart (once per JAX backend: later
    calls reuse the outcome); returns (port outcome, JAX outcome).  The
    two runs share nothing but the machine (each has its own broker,
    target and children), so they run side by side on two threads, except
    the rebalance drills (``side_by_side=False``): their session timers
    and fences are timing-sensitive, and beside the port's run in one
    interpreter the JAX child's abandon did not always cross."""
    jax_backend = BACKENDS[backend][1]
    key = (name, jax_backend)
    jb = next(k for k, (_, v) in BACKENDS.items() if v == jax_backend)
    with concurrent.futures.ThreadPoolExecutor(2 if side_by_side else 1) as pool:
        port = pool.submit(scenario, P, backend, str(tmp_path / "port"))
        if key not in _JAX_OUTCOMES:
            _JAX_OUTCOMES[key] = pool.submit(scenario, J, jb,
                                             str(tmp_path / "jax")).result()
        return port.result(), _JAX_OUTCOMES[key]


# ---------------------------------------------------------------------------
# the handoff
# ---------------------------------------------------------------------------

def _batch(pkg):
    payloads = [f"record-{i}".encode() * (i % 5 + 1) for i in range(64)]
    lens = np.fromiter(map(len, payloads), np.int64, count=64)
    offs = np.zeros(65, np.int64)
    np.cumsum(lens, out=offs[1:])
    blob = b"".join(payloads)
    from kpw_tpu.ingest.broker import RecordBatch as JRB
    from kpw_tpu_torch.ingest.broker import RecordBatch as PRB

    return (PRB if pkg is P else JRB)(TOPIC, 3, 1000, blob, offs), blob


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shm_ring_roundtrip_byte_identical(writer):
    """A batch staged into a ring slot by either package reads back bit
    for bit through both: payload window, rebased offsets and run
    metadata survive the crossing, and the two packages' rings share one
    layout (one attaches to the other's segment by name)."""
    mods = {"port": (PPW, P), "jax": (JPW, J)}
    mod, pkg = mods[writer]
    ring = mod.ShmBatchRing(4, 1 << 16)
    try:
        rb, blob = _batch(pkg)
        win = rb.slice(10, 40)
        assert ring.write_slot(2, win.partition, win.start_offset,
                               win.offsets, win.payload) == 40
        base = int(win.offsets[0])
        for reader_mod, _ in mods.values():
            reader = (ring if reader_mod is mod else reader_mod.ShmBatchRing(
                4, 1 << 16, create=False, name=ring.name))
            part, start, count, r_offs, r_payload, ingest_us = reader.read_slot(2)
            assert (part, start, count, ingest_us) == (3, 1010, 40, 0)
            assert bytes(r_payload) == blob[base: int(win.offsets[-1])]
            np.testing.assert_array_equal(np.asarray(r_offs),
                                          np.asarray(win.offsets) - base)
            for i in range(count):
                assert bytes(r_payload[int(r_offs[i]): int(r_offs[i + 1])]) \
                    == win.payload_at(i)
            del r_offs, r_payload  # release the views before the unmap
            if reader is not ring:
                reader.close()
    finally:
        ring.close()
        ring.unlink()


def test_proc_handoff_shreds_byte_identical_to_thread_mode():
    """A batch consumed through the port's ring shreds to the same columns
    as the thread-mode direct path over the same buffer, and to the JAX
    package's shred of it."""
    from kpw_tpu.models.proto_bridge import ProtoColumnarizer as JCol
    from kpw_tpu_torch.core.bytecol import ByteColumn
    from kpw_tpu_torch.models.proto_bridge import ProtoColumnarizer as PCol

    cls = sample_message_class()
    payloads = [cls(query=f"q-{i}", timestamp=i, page_number=i % 7)
                .SerializeToString() for i in range(500)]
    offs = np.zeros(len(payloads) + 1, np.int64)
    np.cumsum(np.fromiter(map(len, payloads), np.int64), out=offs[1:])
    blob = b"".join(payloads)
    direct = PCol(cls).columnarize_buffer(blob, offs)
    jax = JCol(cls).columnarize_buffer(blob, offs)
    ring = PPW.ShmBatchRing(2, 1 << 20)
    try:
        ring.write_slot(0, 0, 0, offs, blob)
        _, _, _, r_offs, r_payload, _ = ring.read_slot(0)
        via_ring = PCol(cls).columnarize_buffer(r_payload, r_offs)
        assert via_ring.num_rows == direct.num_rows == jax.num_rows == 500
        for a, b, c in zip(direct.chunks, via_ring.chunks, jax.chunks):
            if isinstance(a.values, ByteColumn):
                assert bytes(a.values.data) == bytes(b.values.data) \
                    == bytes(c.values.data)
                np.testing.assert_array_equal(a.values.offsets, b.values.offsets)
                np.testing.assert_array_equal(a.values.offsets, c.values.offsets)
            else:
                np.testing.assert_array_equal(a.values, b.values)
                np.testing.assert_array_equal(a.values, c.values)
            for x in (b, c):
                if a.def_levels is None:
                    assert x.def_levels is None
                else:
                    np.testing.assert_array_equal(a.def_levels, x.def_levels)
        del r_offs, r_payload
    finally:
        ring.close()
        ring.unlink()


@pytest.mark.parametrize("mod", [PPW, JPW], ids=["port", "jax"])
def test_ring_rejects_oversized_batch(mod):
    ring = mod.ShmBatchRing(2, 8192)
    try:
        big = b"z" * 9000
        with pytest.raises(ValueError, match="slot capacity"):
            ring.write_slot(0, 0, 0, np.array([0, len(big)], np.int64), big)
    finally:
        ring.close()
        ring.unlink()


# ---------------------------------------------------------------------------
# build() validation and the message class across the spawn boundary
# ---------------------------------------------------------------------------

def test_process_mode_build_validation():
    """The JAX package's validation, raised alike by both packages; the
    port accepts the ``"cuda"`` backend in process mode (each child runs
    its own CudaChunkEncoder), where the JAX package refuses its card
    backend."""
    cls = sample_message_class()

    class NotAProto:
        @staticmethod
        def FromString(raw):
            return raw

    for pkg in (P, J):
        broker = pkg.FakeBroker()

        def base():
            b = (pkg.Builder().broker(broker).topic(TOPIC).proto_class(cls)
                 .target_dir("/out"))
            return b.encoder_backend("cpu")

        with pytest.raises(ValueError, match="LocalFileSystem"):
            base().filesystem(pkg.MemoryFileSystem()).process_workers(2).build()
        with pytest.raises(ValueError, match="partition_by"):
            (base().filesystem(pkg.LocalFileSystem()).process_workers(2)
             .partition_by("query").build())
        with pytest.raises(ValueError, match="backends"):
            (base().filesystem(pkg.LocalFileSystem()).process_workers(2)
             .encoder_backend("mesh").build())
        with pytest.raises(ValueError, match="custom parser"):
            (base().filesystem(pkg.LocalFileSystem()).process_workers(2)
             .parser(lambda b: cls.FromString(b)).build())
        with pytest.raises(ValueError, match="DESCRIPTOR"):
            (pkg.Builder().broker(broker).topic(TOPIC).proto_class(NotAProto)
             .target_dir("/out").filesystem(pkg.LocalFileSystem())
             .encoder_backend("cpu").process_workers(2).build())
    with pytest.raises(ValueError, match="backends"):
        (J.Builder().broker(J.FakeBroker()).topic(TOPIC).proto_class(cls)
         .target_dir("/out").filesystem(J.LocalFileSystem())
         .encoder_backend("tpu").process_workers(2).build())
    for backend in ("cuda", "auto"):
        w = (P.Builder().broker(P.FakeBroker()).topic(TOPIC).proto_class(cls)
             .target_dir("/out").filesystem(P.LocalFileSystem())
             .encoder_backend(backend, device="cpu").process_workers(2).build())
        assert w._b._proc_workers == 2


def _standins():
    """Descriptor stand-ins beyond the smoke run's: a proto3 file, an enum
    (with its own file), a recursive message and a field that reads its
    presence from the descriptor."""
    from kpw_tpu_torch.models.proto_bridge import FD

    class File:
        def __init__(self, syntax):
            self.syntax = syntax

    class Value:
        def __init__(self, name, number):
            self.name, self.number = name, number

    class Enum:
        name = "Color"
        file = File("proto2")
        values = [Value("RED", 0), Value("GREEN", 1), Value("BLUE", 2)]

    class Desc:
        def __init__(self, name, fields, syntax):
            self.name, self.fields, self.file = name, fields, File(syntax)

    def field(name, number, ftype, label, **kw):
        f = chip_smoke.WireField(name, number, ftype, label, kw.pop("message", None))
        for k, v in kw.items():
            setattr(f, k, v)
        return f

    leaf = Desc("Leaf", [
        field("id", 1, FD.TYPE_INT64, FD.LABEL_OPTIONAL),
        field("name", 2, FD.TYPE_STRING, FD.LABEL_OPTIONAL, has_presence=True),
        field("color", 3, FD.TYPE_ENUM, FD.LABEL_OPTIONAL, enum_type=Enum),
        field("tags", 4, FD.TYPE_STRING, FD.LABEL_REPEATED, file=File("proto2"))],
        "proto3")
    tree = Desc("Tree", [], "proto2")
    tree.fields = [field("leaf", 1, FD.TYPE_MESSAGE, FD.LABEL_OPTIONAL, message=leaf),
                   field("child", 2, FD.TYPE_MESSAGE, FD.LABEL_OPTIONAL, message=tree)]
    return leaf, tree


def _columns(schema):
    return [(c.path, c.leaf.physical_type, c.leaf.converted_type, c.max_def,
             c.max_rep) for c in schema.columns]


def _same_chunks(a, b):
    """Two shredded batches hold equal values and levels, column for
    column."""
    from kpw_tpu_torch.core.bytecol import ByteColumn

    assert a.num_rows == b.num_rows and len(a.chunks) == len(b.chunks)
    for x, y in zip(a.chunks, b.chunks):
        if isinstance(x.values, ByteColumn):
            assert bytes(x.values.data) == bytes(y.values.data)
            np.testing.assert_array_equal(x.values.offsets, y.values.offsets)
        else:
            np.testing.assert_array_equal(x.values, y.values)
        for lv in ("def_levels", "rep_levels"):
            if getattr(x, lv) is None:
                assert getattr(y, lv) is None
            else:
                np.testing.assert_array_equal(getattr(x, lv), getattr(y, lv))


def _same_descriptor(a, b, seen=None):
    """Everything the proto bridge reads, compared through its own
    readers."""
    from kpw_tpu_torch.models import proto_bridge as pb

    seen = set() if seen is None else seen
    if id(a) in seen:
        return
    seen.add(id(a))
    assert a.name == b.name
    assert pb._file_syntax(a.file) == pb._file_syntax(b.file)
    assert [f.name for f in a.fields] == [f.name for f in b.fields]
    for fa, fb in zip(a.fields, b.fields):
        assert (fa.number, fa.type) == (fb.number, fb.type)
        assert pb._repetition_for(fa) == pb._repetition_for(fb)
        assert pb._has_presence(fa) == pb._has_presence(fb)
        assert pb._is_repeated(fa) == pb._is_repeated(fb)
        assert pb._is_required(fa) == pb._is_required(fb)
        fa_file, fb_file = getattr(fa, "file", None), getattr(fb, "file", None)
        assert (fa_file is None) == (fb_file is None)
        if fa_file is not None:
            assert pb._file_syntax(fa_file) == pb._file_syntax(fb_file)
        if fa.type == pb.FD.TYPE_ENUM:
            assert ({n: v.name for n, v in pb._values_by_number(fa.enum_type).items()}
                    == {n: v.name for n, v in pb._values_by_number(fb.enum_type).items()})
            assert pb._file_syntax(fa.enum_type.file) == pb._file_syntax(fb.enum_type.file)
        if fa.type == pb.FD.TYPE_MESSAGE:
            _same_descriptor(fa.message_type, fb.message_type, seen)


def test_descriptor_spec_round_trip():
    """The port's spec of a stand-in class is plain data (it pickles, and
    holds no descriptor object): the class rebuilt from it reads back the
    same descriptor through the proto bridge, gives the same schema and
    wire plan, shreds the smoke run's Order records to the same columns,
    and refuses to parse, as the stand-in does.  A protobuf class keeps
    the JAX package's route: its spec equals the JAX spec's blobs and the
    rebuilt class parses."""
    from kpw_tpu_torch.models.proto_bridge import ProtoColumnarizer, proto_to_schema

    leaf, tree = _standins()
    cases = [chip_smoke.replay_class(), chip_smoke.order_class(),
             type("Leaf", (), {"DESCRIPTOR": leaf}),
             type("Tree", (), {"DESCRIPTOR": tree})]  # recursive: no schema
    for cls in cases:
        spec = PPW._proto_spec(cls)
        assert spec[0] == "snapshot"
        rebuilt = PPW._proto_class_from_spec(pickle.loads(pickle.dumps(spec)))
        _same_descriptor(cls.DESCRIPTOR, rebuilt.DESCRIPTOR)
        if cls is not cases[-1]:
            assert _columns(proto_to_schema(rebuilt)) == _columns(proto_to_schema(cls))
            assert (ProtoColumnarizer(rebuilt).wire_capable
                    == ProtoColumnarizer(cls).wire_capable)
        with pytest.raises(NotImplementedError, match="wire path"):
            rebuilt.FromString(b"\x08\x01")
    order, rebuilt = cases[1], PPW._proto_class_from_spec(PPW._proto_spec(cases[1]))
    rng = np.random.default_rng(5)
    payloads = chip_smoke.order_payloads(*chip_smoke.order_rows(rng, 300))
    assert ProtoColumnarizer(rebuilt).wire_capable
    _same_chunks(ProtoColumnarizer(order).columnarize_payloads(payloads),
                 ProtoColumnarizer(rebuilt).columnarize_payloads(payloads))
    cls = sample_message_class()
    spec = PPW._proto_spec(cls)
    assert spec[0] == "protobuf" and spec[1:] == JPW._proto_spec(cls)
    real = PPW._proto_class_from_spec(spec)
    msg = cls(query="q", timestamp=7)
    assert real.FromString(msg.SerializeToString()).timestamp == 7


# ---------------------------------------------------------------------------
# end to end, kill -9, watchdog, oversized batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_process_mode_end_to_end(backend, tmp_path):
    """Two worker processes drain a seeded replay to ack-lag exactly 0:
    every produced row lands in a verified published file, every offset
    commits, both children publish, and the process-mode observability
    (per-child rss, ring occupancy, ``worker.proc.*`` gauges) is live."""
    rows, parts = 3000, 2

    def scenario(pkg, backend, target):
        cls = sample_message_class()
        broker = pkg.FakeBroker()
        broker.create_topic(TOPIC, parts)
        produce_indexed(broker, cls, rows, parts)
        reg = PMetricRegistry() if pkg is P else J.MetricRegistry()
        b = proc_builder(pkg, broker, cls, target, backend)
        w = b.metric_registry(reg).build()
        w.start()
        try:
            ok = drained(w, broker, rows, parts)
            got, files = published_timestamps(pkg, target)
            procs = w.stats()["procs"]
            writers = {f.rsplit("_", 1)[-1].split(".")[0].split("-")[0]
                       for f in files}
            return {
                "drained": ok, "lost": sorted(set(range(rows)) - set(got)),
                "written_all": w.total_written_records >= rows,
                "healthy": w.healthy(), "workers": procs["workers"],
                "ring_free": procs["ring"]["free"] == procs["ring"]["slots"],
                "acked_all": procs["acked_units"] == procs["dispatched_units"] >= 1,
                "children": [(c["alive"], c["rss_bytes"] > 0)
                             for c in procs["children"]],
                "gauges": (reg.get("worker.proc.alive").value,
                           reg.get("worker.proc.ring.slots").value
                           == procs["ring"]["slots"],
                           reg.get("worker.proc.inflight.records").value,
                           reg.get("worker.proc.rss.bytes").value > 0),
                "writers": len(writers),
            }
        finally:
            w.close()

    port, jax = both("e2e", scenario, backend, tmp_path)
    assert port == jax
    assert port["drained"] and not port["lost"] and port["writers"] == 2


@pytest.mark.parametrize("backend", ["cuda-on-cpu"])
def test_process_worker_kill9_at_least_once(backend, tmp_path):
    """A seeded replay with one worker process SIGKILLed mid-run ends with
    acked offsets in verified published files, ack-lag 0 and no row lost;
    the supervisor restarts the slot and its runs flow through the ring
    again."""
    rows, parts = 8000, 2

    def scenario(pkg, backend, target):
        cls = sample_message_class()
        broker = pkg.FakeBroker()
        broker.create_topic(TOPIC, parts)
        identity = produce_indexed(broker, cls, rows, parts, pad=100)
        w = proc_builder(pkg, broker, cls, target, backend).supervise(
            True, max_restarts=3, restart_backoff_seconds=0.05).build()
        w.start()
        try:
            assert wait_until(lambda: w.total_written_records >= rows // 4)
            victim = w._workers[0].pid
            os.kill(victim, signal.SIGKILL)
            ok = drained(w, broker, rows, parts)
            got, _ = published_timestamps(pkg, target)
            missing = [(p, off) for p in range(parts)
                       for off in range(broker.committed("g", TOPIC, p))
                       if got[identity[(p, off)]] < 1]
            # the death and the restart can come after the drain, when the
            # victim held no unit
            return {"drained": ok, "acked_missing": missing,
                    "lost": sorted(set(range(rows)) - set(got)),
                    "lag": w.ack_lag()["unacked_records"],
                    "restarted": wait_until(lambda: w.stats()["supervision"]
                                            ["restarts_total"] >= 1),
                    "failed_marked": w.stats()["meters"]["parquet.writer.failed"]
                    ["count"] >= 1,
                    "healthy": wait_until(w.healthy)}
        finally:
            w.close()

    port, jax = both("kill9", scenario, backend, tmp_path)
    assert port == jax
    assert port["drained"] and not port["lost"] and port["restarted"]


@pytest.mark.parametrize("backend", ["cpu"])
def test_watchdog_condemn_kills_and_restarts_child(backend, tmp_path):
    """Condemning a (simulated) hung child SIGKILLs the process, and the
    supervisor restarts the slot with its held runs redelivered; the
    stream still drains with no row lost."""
    rows, parts = 4000, 2

    def scenario(pkg, backend, target):
        cls = sample_message_class()
        broker = pkg.FakeBroker()
        broker.create_topic(TOPIC, parts)
        produce_indexed(broker, cls, rows, parts, pad=80)
        w = (proc_builder(pkg, broker, cls, target, backend)
             .supervise(True, max_restarts=3, restart_backoff_seconds=0.05)
             .watchdog(True, io_stall_deadline_seconds=30.0, abandon_stalled=True)
             .build())
        w.start()
        try:
            assert wait_until(lambda: w.total_written_records >= rows // 8)
            slot = w._workers[0]
            victim_pid = slot.pid
            w._on_watchdog_stall(0, slot, 99.0, "publish")
            condemned = slot.condemned and slot.failed
            ok = drained(w, broker, rows, parts)
            fresh = w._workers[0]
            got, _ = published_timestamps(pkg, target)
            s = w.stats()
            return {"condemned": condemned, "drained": ok,
                    "victim_gone": wait_until(lambda: not slot.alive(), 10),
                    "respawned": fresh is not slot and fresh.pid != victim_pid,
                    "lost": sorted(set(range(rows)) - set(got)),
                    "restarted": s["supervision"]["restarts_total"] >= 1,
                    "stalled": s["meters"]["parquet.writer.stalled"]["count"] >= 1}
        finally:
            w.close()

    port, jax = both("watchdog", scenario, backend, tmp_path)
    assert port == jax
    assert port["drained"] and port["respawned"] and not port["lost"]


@pytest.mark.parametrize("backend", ["native"])
def test_dispatcher_splits_oversized_batches(backend, tmp_path):
    """Batches wider than one ring slot (8 KiB slots) split into several
    units and still drain with no row lost."""
    rows, parts = 1200, 1

    def scenario(pkg, backend, target):
        cls = sample_message_class()
        broker = pkg.FakeBroker()
        broker.create_topic(TOPIC, parts)
        produce_indexed(broker, cls, rows, parts, pad=200)
        w = proc_builder(pkg, broker, cls, target, backend, procs=1,
                         proc_kw={"ring_slots": 4, "slot_bytes": 8192}).build()
        w.start()
        try:
            ok = drained(w, broker, rows, parts)
            got, _ = published_timestamps(pkg, target)
            return {"drained": ok, "lost": sorted(set(range(rows)) - set(got)),
                    "split": w.stats()["procs"]["dispatched_units"] > 4}
        finally:
            w.close()

    port, jax = both("split", scenario, backend, tmp_path)
    assert port == jax == {"drained": True, "lost": [], "split": True}


# ---------------------------------------------------------------------------
# cooperative rebalance across the process boundary
# ---------------------------------------------------------------------------

def _rb_builder(pkg, broker, tgt, name, backend, drain=2.0, open_s=0.3):
    b = (pkg.Builder().broker(broker).topic(TOPIC)
         .proto_class(sample_message_class())
         .target_dir(tgt).filesystem(pkg.LocalFileSystem())
         .instance_name(name).group_id("g").batch_size(64)
         .process_workers(1, ring_slots=4)
         .retry_policy((P.runtime.RetryPolicy if pkg is P else J.RetryPolicy)(
             base_sleep=0.005, max_sleep=0.05))
         .max_file_size(512 * 1024).block_size(16 * 1024)
         .max_file_open_duration_seconds(open_s)
         .rebalance_drain_deadline_seconds(drain))
    port_args, jax_backend = BACKENDS[backend]
    b.encoder_backend(*port_args) if pkg is P else b.encoder_backend(jax_backend)
    return b


def _rb_produce(broker, lo, hi, parts, pad=60):
    cls = sample_message_class()
    filler = "x" * pad
    for i in range(lo, hi):
        broker.produce(TOPIC, cls(query=f"r-{i % parts}-{i}-{filler}",
                                  timestamp=i).SerializeToString(),
                       partition=i % parts)


def _exactly_once(tgt, n, parts, pad=60):
    from crash_child import published_files

    rows: dict[str, int] = {}
    for f in published_files(tgt):
        for r in pq.read_table(f).to_pylist():
            rows[r["query"]] = rows.get(r["query"], 0) + 1
    filler = "x" * pad
    expect = {f"r-{i % parts}-{i}-{filler}" for i in range(n)}
    return {"lost": len(expect - set(rows)),
            "duplicated": len({k for k, v in rows.items() if v > 1})}


def _committed(broker, parts):
    return sum(broker.committed("g", TOPIC, p) for p in range(parts))


def _kinds(w):
    return {e["kind"] for e in w._flightrec.events()}


@pytest.mark.parametrize("backend", ["native"])
def test_fence_descriptor_roundtrip_flush(backend, tmp_path):
    """A second member joins; the parent's listener sends ``revoke`` flush
    descriptors down the work queue, the child publishes its open file
    early (rotation cause ``revoke``), the drain completes inside the
    window and the handoff stays exactly-once."""
    parts, n = 4, 600

    def scenario(pkg, backend, tgt):
        broker = pkg.FakeBroker(session_timeout_s=5.0, revocation_drain_s=3.0)
        broker.create_topic(TOPIC, parts)
        w0 = _rb_builder(pkg, broker, tgt, "w0", backend, drain=3.0, open_s=10.0).build()
        w0.start()
        try:
            _rb_produce(broker, 0, n // 2, parts)
            assert wait_until(lambda: w0.total_written_records >= n // 2)
            w1 = _rb_builder(pkg, broker, tgt, "w1", backend).build()
            w1.start()
            try:
                out = {
                    "assigned": wait_until(lambda: len(
                        w1.stats()["consumer"]["rebalance"]["assigned"]) == 2),
                    "revoke_rotation": wait_until(
                        lambda: w0._rotated_revoke.count >= 1),
                    "child_fenced": wait_until(lambda: w0._child_telemetry.field(
                        "rebalance_fenced") >= 1)}
                out["kinds"] = sorted(_kinds(w0) & {
                    "rebalance_fence_sent", "rebalance_child_drained",
                    "rebalance_drain_complete"})
                _rb_produce(broker, n // 2, n, parts)
                out["drained"] = wait_until(lambda: (
                    _committed(broker, parts) >= n
                    and w0.ack_lag()["unacked_records"] == 0
                    and w1.ack_lag()["unacked_records"] == 0))
                out["full_resets"] = [w.stats()["consumer"]["rebalance"]["full_resets"]
                                      for w in (w0, w1)]
                out["rebalances"] = broker.group_stats("g", TOPIC)["rebalances"] >= 2
            finally:
                w1.close()
        finally:
            w0.close()
        return out | _exactly_once(tgt, n, parts)

    port, jax = both("fence", scenario, backend, tmp_path, side_by_side=False)
    assert port == jax
    assert port["drained"] and port["revoke_rotation"] and port["lost"] == 0


@pytest.mark.parametrize("backend", ["native"])
def test_revoked_undispatched_unit_backed_out(backend, tmp_path):
    """A revoked unit staged in the ring but never handed to the child is
    backed out at the fence: its slot recycles and its runs release; a
    unit already committed to sending is not."""
    def scenario(pkg, backend, tgt):
        broker = pkg.FakeBroker(session_timeout_s=5.0, revocation_drain_s=2.0)
        broker.create_topic(TOPIC, 2)
        w = _rb_builder(pkg, broker, tgt, "w0", backend, open_s=10.0).build()
        w.start()
        try:
            pool = w._procpool
            slot = pool.slots[0]
            ri = pool._get_free_slot()
            slot.note_dispatch(10_001, [(0, 500, 564)], 64, 4096, ri)
            staged = (slot.inflight_units(), (0, 500, 564) in slot.held_runs())
            backed = pool.backout_undispatched(slot, frozenset({0}))
            after = (slot.inflight_units(), slot.held_runs(),
                     "rebalance_backout" in _kinds(w))
            ri2 = pool._get_free_slot()
            slot.note_dispatch(10_002, [(1, 600, 664)], 64, 4096, ri2)
            sent = slot.mark_sent(10_002)
            kept = (pool.backout_undispatched(slot, frozenset({1})),
                    slot.inflight_units())
            slot.settle(10_002)
            pool._recycle_slot(ri2)
            return {"staged": staged, "backed": backed, "after": after,
                    "sent": sent, "kept": kept}
        finally:
            w.close()

    port, jax = both("backout", scenario, backend, tmp_path, side_by_side=False)
    assert port == jax == {"staged": (1, True), "backed": 1,
                           "after": (0, [], True), "sent": True, "kept": (0, 1)}


@pytest.mark.parametrize("backend", ["cpu"])
def test_partitions_lost_abandons_across_process_boundary(backend, tmp_path):
    """Session expiry while rows sit in a child's open file: on rejoin the
    abandon descriptor crosses the process boundary, the child drops its
    open file unacked, the survivor republishes from the committed
    frontier, and the tree stays exactly-once."""
    parts, n = 4, 600

    def scenario(pkg, backend, tgt):
        # sessions of 2 s (the JAX package's drill: 0.5 s), so that only the
        # suspended member expires, also on a loaded machine
        broker = pkg.FakeBroker(session_timeout_s=2.0, revocation_drain_s=1.0)
        broker.create_topic(TOPIC, parts)
        victim = _rb_builder(pkg, broker, tgt, "vic", backend, drain=1.0,
                             open_s=30.0).build()
        surv = (pkg.Builder().broker(broker).topic(TOPIC)
                .proto_class(sample_message_class())
                .target_dir(tgt).filesystem(pkg.LocalFileSystem())
                .instance_name("sur").group_id("g").batch_size(64).thread_count(1)
                .max_file_size(128 * 1024).block_size(16 * 1024)
                .max_file_open_duration_seconds(0.3)
                .rebalance_drain_deadline_seconds(1.0)
                .encoder_backend("cpu").build())
        victim.start()
        surv.start()
        try:
            _rb_produce(broker, 0, n // 2, parts)
            out = {"assigned": wait_until(lambda: len(
                surv.stats()["consumer"]["rebalance"]["assigned"]) == 2)}
            # the handoff to the survivor is drained; rows produced now
            # reach the victim's child only for the partitions it kept, and
            # sit unacked in its open file (30 s time rotation) until the
            # abandon below
            def settled():
                rb = victim.stats()["consumer"]["rebalance"]
                return len(rb["assigned"]) == 2 and not rb["revoke_pending"]

            assert wait_until(settled)
            _rb_produce(broker, n // 2, 3 * n // 4, parts)
            assert wait_until(lambda: victim.ack_lag()["unacked_records"] > 0)
            victim.consumer.suspend(True)
            _rb_produce(broker, 3 * n // 4, n, parts)
            out["survivor_drained"] = wait_until(lambda: (
                _committed(broker, parts) >= n
                and surv.ack_lag()["unacked_records"] == 0))
            out["expired"] = broker.group_stats("g", TOPIC)["expired_members"]
            # on rejoin the victim posts two fence descriptors to its child,
            # the revoke's flush and then the loss's abandon; the child
            # serves them once its queue is empty, the abandon superseding
            # the flush.  The child is held stopped until both are in its
            # queue: otherwise a loaded machine can let it serve the flush
            # alone (the file publishes, its commit comes back fenced, it
            # is un-published, and no abandon crosses the boundary)
            slot = victim._procpool.slots[0]
            os.kill(slot.pid, signal.SIGSTOP)
            try:
                victim.consumer.suspend(False)
                out["abandon_sent"] = wait_until(lambda: any(
                    e["kind"] == "rebalance_fence_sent" and e["mode"] == "abandon"
                    for e in victim._flightrec.events()))
                # the queue's feeder thread has written both into the pipe
                wait_until(lambda: not slot.work_q._buffer)
                time.sleep(0.1)
            finally:
                os.kill(slot.pid, signal.SIGCONT)
            out["abandoned"] = wait_until(lambda: victim._fence_abandons.count >= 1)
            out["kinds"] = sorted(_kinds(victim) & {
                "rebalance_partitions_lost", "rebalance_child_abandoned"})
            out["child_abandoned"] = wait_until(lambda: victim._child_telemetry.field(
                "rebalance_abandoned") >= 1)
            out["victim_drained"] = wait_until(
                lambda: victim.ack_lag()["unacked_records"] == 0)
        finally:
            victim.close()
            surv.close()
        return out | _exactly_once(tgt, n, parts)

    port, jax = both("lost", scenario, backend, tmp_path, side_by_side=False)
    assert port == jax
    assert port["abandoned"] and port["lost"] == 0 and port["duplicated"] == 0


# ---------------------------------------------------------------------------
# the CUDA kernels build once, in the parent
# ---------------------------------------------------------------------------

def test_pool_builds_kernels_in_the_parent_before_spawning(monkeypatch):
    """With a card backend on a CUDA device the pool builds every kernel
    before the first child starts (so no child compiles); on the CPU, and
    with the host encoders, it builds nothing."""
    from kpw_tpu_torch.ops import _build

    events = []
    monkeypatch.setattr(_build, "build", lambda *a: events.append("build") or {})
    monkeypatch.setattr(PPW._ProcWorkerSlot, "start",
                        lambda self: events.append(f"spawn {self.index}"))
    monkeypatch.setattr(PPW.ProcessWorkerPool, "_dispatch_loop", lambda self: None)
    monkeypatch.setattr(PPW.ProcessWorkerPool, "_collect_loop", lambda self: None)
    cls = sample_message_class()

    def pool(backend, device):
        b = (P.Builder().broker(P.FakeBroker()).topic(TOPIC).proto_class(cls)
             .target_dir("/out").filesystem(P.LocalFileSystem())
             .encoder_backend(backend, device=device).process_workers(2))
        b._proc_workers, b._proc_ring_slots = 2, 2
        writer = type("W", (), {"_b": b, "_restart_counts": [0, 0]})()
        p = PPW.ProcessWorkerPool(writer)
        try:
            p.start()
        finally:
            p.ring.close()
            p.ring.unlink()
        return list(events)

    import kpw_tpu_torch.device as dev

    assert pool("cuda", "cpu") == ["spawn 0", "spawn 1"]
    events.clear()
    assert pool("native", "cuda") == ["spawn 0", "spawn 1"]
    events.clear()
    monkeypatch.setattr(dev, "resolve_device", lambda d: torch.device("cuda"))
    for backend in ("cuda", "auto"):
        events.clear()
        assert pool(backend, "cuda") == ["build", "spawn 0", "spawn 1"]


_BUILD_RACE = textwrap.dedent("""
    import sys
    from kpw_tpu_torch.ops import _build
    _build.BUILD_DIR = sys.argv[1]
    print(sorted(_build.build()))
""")


def test_kernel_build_runs_once_across_processes(tmp_path):
    """Two processes that build the kernels at once (as process workers on
    one checkout would without the parent's build) compile each source
    once: the build holds a file lock, and the one that waited finds the
    libraries built.  ``nvcc`` is a stand-in script that counts its
    calls."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    calls = tmp_path / "calls"
    nvcc.write_text(textwrap.dedent(f"""\
        #!/bin/sh
        echo "$@" >> {calls}
        sleep 0.3
        while [ "$1" != "-o" ]; do shift; done
        echo so > "$2"
    """))
    nvcc.chmod(0o755)
    env = dict(os.environ, CUDA_HOME=str(home))
    build_dir = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_RACE, str(build_dir)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    from kpw_tpu_torch.ops import _build

    assert sorted(outs, key=len) == ["[]", repr(sorted(_build.SOURCES))]
    assert len(calls.read_text().splitlines()) == len(_build.SOURCES)
    for name in _build.SOURCES:
        assert (build_dir / f"{name}.log").exists()
