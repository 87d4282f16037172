"""The port's streaming writer (``kpw_tpu_torch.Builder``) against the JAX
package's, on the same records: FakeBroker → wire shred → encoder → size and
time rotation → publish → ack, with the port's ``"cpu"`` and ``"native"``
encoders and ``"cuda"`` run on the CPU (``device="cpu"``).

- the deterministic arm of the smoke run's stream phase (one partition,
  one worker thread, autotune, time rotation and the row-group pipeline
  off, polls of 64): two runs of the JAX ``Builder`` publish equal bytes,
  and the port's files equal them byte for byte;
- counterparts of ``tests/test_writer_integration.py``'s tests, each run
  through both packages' writers on the same records and asserting the
  same outcome;
- ``STAGE_NAMES`` and the Chrome-trace export.

No test sleeps a fixed time: each polls for its condition with a deadline,
and every writer is closed with a deadline.
"""

import collections
import io
import json
import os
import sys
import time

import pyarrow.parquet as pq
import pytest
import torch

import kpw_tpu as J
import kpw_tpu_torch as P
from proto_helpers import sample_message_class

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

TOPIC = "logs"
# port backend -> (encoder_backend arguments, the JAX counterpart)
BACKENDS = {"cpu": (("cpu",), "cpu"), "native": (("native",), "native"),
            "cuda-on-cpu": (("cuda", "cpu"), "tpu")}
LIMIT_S = 30.0  # each wait of a test


def wait_until(pred, what: str, limit: float = LIMIT_S):
    deadline = time.monotonic() + limit
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.002)
    raise AssertionError(f"not within {limit} s: {what}")


def make_builder(pkg, broker, fs, cls, backend, **overrides):
    args, jax_backend = BACKENDS[backend]
    b = (pkg.Builder().broker(broker).topic(TOPIC).proto_class(cls)
         .target_dir("/out").filesystem(fs).instance_name("test").batch_size(16))
    if pkg is P:
        b.encoder_backend(*args)
    else:
        b.encoder_backend(jax_backend)
    for name, value in overrides.items():
        getattr(b, name)(value)
    return b


class Run:
    """One writer of either package, started on entry and closed with a
    deadline on exit."""

    def __init__(self, builder):
        self.w = builder.build()

    def __enter__(self):
        self.w.start()
        return self.w

    def __exit__(self, *exc):
        self.w.close(deadline=LIMIT_S)


def produce_samples(broker, cls, count, start=0):
    msgs = []
    for i in range(start, start + count):
        m = cls(query=f"query-{i}", timestamp=i)
        if i % 2 == 0:
            m.page_number = i % 7
        broker.produce(TOPIC, m.SerializeToString())
        msgs.append(m)
    return msgs


def read_rows(fs, paths):
    rows = []
    for p in sorted(paths):
        rows.extend(pq.read_table(io.BytesIO(fs.open_read(p).read())).to_pylist())
    return rows


def multiset(rows):
    return collections.Counter((r["query"], r["timestamp"], r["page_number"])
                               for r in rows)


def msgs_multiset(msgs):
    return collections.Counter(
        (m.query, m.timestamp, m.page_number if m.HasField("page_number") else None)
        for m in msgs)


def both(scenario, backend):
    """``scenario(pkg, backend)`` for the port and the JAX package; returns
    (port outcome, JAX outcome)."""
    return scenario(P, backend), scenario(J, backend)


# ---------------------------------------------------------------------------
# the deterministic arm
# ---------------------------------------------------------------------------

def replay_class():
    from proto_helpers import _F, _field, build_classes

    fields = ([_field(f"i{k}", k + 1, _F.TYPE_INT64, _F.LABEL_REQUIRED)
               for k in range(8)]
              + [_field(f"s{k}", k + 9, _F.TYPE_STRING, _F.LABEL_REQUIRED)
                 for k in range(4)])
    return build_classes("replay", {"Replay": fields})["Replay"]


def deterministic_files(pkg, backend, cls, payloads):
    """The smoke run's deterministic arm at its rehearsal size (256 KiB
    files) through ``pkg``'s Builder: the published files' bytes in
    publish order, and the records acked."""
    args, jax_backend = BACKENDS[backend]
    broker = pkg.FakeBroker()
    broker.create_topic("det", 1)
    broker.produce_many("det", payloads)
    fs = pkg.MemoryFileSystem()
    size = 256 * 1024
    b = (pkg.Builder().broker(broker).topic("det").proto_class(cls)
         .target_dir("/det").filesystem(fs).instance_name("det").group_id("det")
         .thread_count(1).compression("snappy").autotune(False).batch_ingest(True)
         .max_file_size(size).block_size(size // 2)
         .max_file_open_duration_seconds(3600.0)
         .pipeline(False).batch_size(64).fetch_max_records(2048))
    b.encoder_backend(*args) if pkg is P else b.encoder_backend(jax_backend)
    with Run(b) as w:
        wait_until(lambda: w.total_written_records >= len(payloads), "all written")
    files = sorted(fs.list_files("/det", extension=".parquet"))
    return [fs.open_read(f).read() for f in files], broker.committed("det", "det", 0)


def _same_prefix(a, b):
    """Files of two runs equal file for file; the last size rotation may
    race close() (see ``chip_smoke.deterministic_files``), so one list may
    hold one file more."""
    n = min(len(a), len(b))
    return n >= 2 and abs(len(a) - len(b)) <= 1 and a[:n] == b[:n]


_jax_det: dict = {}


def test_jax_builder_deterministic_arm_is_deterministic():
    """Two runs of the JAX Builder under the deterministic arm's settings
    publish equal bytes, file for file.  (Without them they do not: with
    the row-group pipeline on, a file's size at a rotation check depends
    on whether its last row group has finished encoding, and polls take
    whatever the fetcher has queued.)"""
    cls = replay_class()
    payloads = chip_smoke.replay_payloads(20_000)
    first, acked1 = deterministic_files(J, "cpu", cls, payloads)
    second, acked2 = deterministic_files(J, "native", cls, payloads)
    assert _same_prefix(first, second), ([len(f) for f in first],
                                         [len(f) for f in second])
    _jax_det["files"] = first


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_deterministic_arm_equals_jax(backend):
    cls = replay_class()
    payloads = chip_smoke.replay_payloads(20_000)
    if "files" not in _jax_det:
        _jax_det["files"] = deterministic_files(J, "cpu", cls, payloads)[0]
    got, acked = deterministic_files(P, backend, cls, payloads)
    want = _jax_det["files"]
    assert _same_prefix(got, want), ([len(f) for f in got], [len(f) for f in want])
    rows = sum(pq.read_metadata(io.BytesIO(f)).num_rows for f in got)
    assert acked == rows  # an acked record is in a published file
    # the smoke run's descriptor stand-in gives the same files
    stand_in, _ = deterministic_files(P, backend, chip_smoke.replay_class(), payloads)
    assert _same_prefix(stand_in, want)


# ---------------------------------------------------------------------------
# counterparts of tests/test_writer_integration.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_max_open_duration(backend):
    """Time rotation: 100 records, one file with a custom extension in the
    target root, content round-trips, every offset committed."""
    def scenario(pkg, backend):
        broker = pkg.FakeBroker()
        broker.create_topic(TOPIC, 1)
        fs = pkg.MemoryFileSystem()
        cls = sample_message_class()
        msgs = produce_samples(broker, cls, 100)
        with Run(make_builder(pkg, broker, fs, cls, backend, group_id="g",
                              max_file_open_duration_seconds=0.5,
                              file_extension=".p")) as w:
            wait_until(lambda: broker.committed("g", TOPIC, 0) == 100
                       and w.ack_lag()["unacked_records"] == 0, "committed")
        files = fs.list_files("/out", extension=".p")
        assert len(files) == 1 and files[0].rsplit("/", 1)[0] == "/out"
        rows = read_rows(fs, files)
        assert multiset(rows) == msgs_multiset(msgs)
        return rows

    port, jax = both(scenario, backend)
    assert port == jax


def size_rotation(pkg, backend, max_size, block_size, chunk=2000):
    """Drive size rotation until two files publish: every file lands in
    the reference's band (0.99x-1.11x of max_file_size)."""
    broker = pkg.FakeBroker()
    broker.create_topic(TOPIC, 1)
    fs = pkg.MemoryFileSystem()
    cls = sample_message_class()
    produced = 0
    with Run(make_builder(pkg, broker, fs, cls, backend, max_file_size=max_size,
                          block_size=block_size,
                          max_file_open_duration_seconds=300.0)):
        deadline = time.monotonic() + LIMIT_S
        while len(fs.list_files("/out", extension=".parquet")) < 2:
            assert time.monotonic() < deadline, "never rotated by size"
            if produced < 200_000:
                produce_samples(broker, cls, chunk, start=produced)
                produced += chunk
            time.sleep(0.002)
        sizes = [fs.size(f) for f in fs.list_files("/out", extension=".parquet")]
    assert all(max_size * 0.99 < s < max_size * 1.11 for s in sizes), sizes
    return len(sizes) >= 2


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_max_file_size(backend):
    port, jax = both(lambda pkg, be: size_rotation(pkg, be, 100 * 1024, 10 * 1024),
                     backend)
    assert port and jax


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_at_least_once_redelivery_after_crash(backend):
    """close() abandons the open tmp file unacked; a fresh writer of the
    same group gets every record again and commits them all."""
    def scenario(pkg, backend):
        broker = pkg.FakeBroker()
        broker.create_topic(TOPIC, 1)
        fs = pkg.MemoryFileSystem()
        cls = sample_message_class()
        msgs = produce_samples(broker, cls, 80)
        with Run(make_builder(pkg, broker, fs, cls, backend, group_id="g")) as w1:
            wait_until(lambda: w1.total_written_records >= 80, "80 written")
        assert w1.total_written_records == 80
        assert fs.list_files("/out", extension=".parquet") == []
        assert broker.committed("g", TOPIC, 0) == 0
        with Run(make_builder(pkg, broker, fs, cls, backend, group_id="g",
                              max_file_open_duration_seconds=0.5)):
            wait_until(lambda: broker.committed("g", TOPIC, 0) == 80, "80 committed")
        rows = read_rows(fs, fs.list_files("/out", extension=".parquet"))
        assert multiset(rows) == msgs_multiset(msgs)
        return rows

    port, jax = both(scenario, backend)
    assert port == jax


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_poison_pill_policies(backend):
    """'skip': the bad record is acked and dropped, the 20 good ones are
    published."""
    def scenario(pkg, backend):
        broker = pkg.FakeBroker()
        broker.create_topic(TOPIC, 1)
        fs = pkg.MemoryFileSystem()
        cls = sample_message_class()
        produce_samples(broker, cls, 10)
        broker.produce(TOPIC, b"\xff\xff not a proto \x01")
        produce_samples(broker, cls, 10, start=10)
        with Run(make_builder(pkg, broker, fs, cls, backend, group_id="g",
                              on_parse_error="skip",
                              max_file_open_duration_seconds=0.5)):
            wait_until(lambda: broker.committed("g", TOPIC, 0) == 21, "21 committed")
        rows = read_rows(fs, fs.list_files("/out", extension=".parquet"))
        assert len(rows) == 20
        return rows

    port, jax = both(scenario, backend)
    assert port == jax


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_builder_validation(backend, monkeypatch):
    """The reference's validation, on both packages; the options whose
    modules came last (the object store and compaction's budgets build;
    ``consumer_config`` without a broker and an ``hdfs://`` default FS
    raise the JAX package's errors here, where neither kafka-python nor
    libhdfs is installed; ``"mesh"`` builds on the CPU); process workers,
    compaction and routes build; and the card backends raise without a
    card."""
    cls = sample_message_class()
    for pkg in (P, J):
        broker = pkg.FakeBroker()

        def base():
            return make_builder(pkg, broker, pkg.MemoryFileSystem(), cls, backend)

        with pytest.raises(ValueError, match="missing required"):
            pkg.Builder().topic("t").build()
        with pytest.raises(ValueError, match="max_file_size"):
            base().max_file_size(1024).build()
        with pytest.raises(ValueError, match="cover"):
            (base().max_expected_throughput_per_second(300_000)
             .max_file_open_duration_seconds(10).offset_tracker_page_size(1000)
             .offset_tracker_max_open_pages_per_partition(2).build())
        b = base()
        b.build()
        assert b._offset_tracker_max_open_pages == 900

    def built(pkg, setter, *args, **kwargs):
        """The writer's sink type, or the error's type and text with the
        package's name made the same."""
        b = make_builder(pkg, pkg.FakeBroker(), pkg.MemoryFileSystem(), cls, backend)
        if setter in ("consumer_config", "filesystem_config"):
            b._broker = None if setter == "consumer_config" else b._broker
            b._filesystem = None if setter == "filesystem_config" else b._filesystem
        getattr(b, setter)(*args, **kwargs)
        try:
            w = b.build()
        except (ImportError, RuntimeError) as e:
            # the package's own text (an underlying library's follows a colon)
            return (type(e).__name__,
                    str(e).replace("kpw_tpu_torch", "kpw_tpu").split(":")[0])
        w.close()
        return type(w.fs).__name__
    for setter, args, kwargs, want in (
            ("object_store", ("b",), {}, "ObjectStoreFileSystem"),
            ("compaction", (1 << 20,), {"bandwidth_bytes_per_s": 1e6},
             "MemoryFileSystem"),
            ("compaction", (1 << 20,), {"request_budget_per_round": 4},
             "MemoryFileSystem"),
            ("consumer_config", ({"bootstrap.servers": "localhost:1"},), {},
             "ImportError"),
            ("filesystem_config", ({"fs.defaultFS": "hdfs://nn:8020"},), {},
             "RuntimeError")):
        got = {}
        for pkg in (P, J):
            a = ((pkg.EmulatedObjectStore(),) + args if setter == "object_store"
                 else args)
            got[pkg] = built(pkg, setter, *a, **kwargs)
        assert got[P] == got[J]
        assert (got[P] if isinstance(got[P], str) else got[P][0]) == want
    # process workers, compaction, routes and the mesh are ported: they build
    broker = P.FakeBroker()
    assert isinstance(make_builder(P, broker, P.MemoryFileSystem(), cls, backend)
                      .route("t2", cls, "/t2").build(), P.MultiWriter)
    make_builder(P, broker, P.MemoryFileSystem(), cls, backend).compaction(1 << 20).build()
    with pytest.raises(ValueError, match="LocalFileSystem"):
        make_builder(P, broker, P.MemoryFileSystem(), cls, backend) \
            .process_workers(2).build()
    with pytest.raises(ValueError, match="object-store"):
        make_builder(P, broker, None, cls, backend).object_store(
            P.EmulatedObjectStore()).process_workers(2).build()
    make_builder(P, broker, P.MemoryFileSystem(), cls, backend) \
        .encoder_backend("mesh", device="cpu").build().close()
    # the default backend is the card's: without one, build() raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for be in ("cuda", "auto", "mesh"):
        b = (P.Builder().broker(broker).topic(TOPIC).proto_class(cls)
             .target_dir("/x").filesystem(P.MemoryFileSystem()))
        if be != "cuda":
            b.encoder_backend(be)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            b.build()


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_wire_fallback_preserves_row_order(backend):
    """A poison pill sends one poll batch through the Python path; the next
    clean batch takes the wire path: rows stay in offset order."""
    def scenario(pkg, backend):
        broker = pkg.FakeBroker()
        broker.create_topic(TOPIC, 1)
        fs = pkg.MemoryFileSystem()
        cls = sample_message_class()
        for i in range(10):
            broker.produce(TOPIC, cls(query=f"a-{i}", timestamp=i).SerializeToString())
        broker.produce(TOPIC, b"\xff\xff\xff\xff")
        for i in range(10, 20):
            broker.produce(TOPIC, cls(query=f"a-{i}", timestamp=i).SerializeToString())
        with Run(make_builder(pkg, broker, fs, cls, backend, group_id="g",
                              batch_size=1024, on_parse_error="skip",
                              max_file_open_duration_seconds=0.5)):
            wait_until(lambda: broker.committed("g", TOPIC, 0) == 21, "21 committed")
        rows = read_rows(fs, fs.list_files("/out", extension=".parquet"))
        assert [r["timestamp"] for r in rows] == list(range(20))
        return rows

    port, jax = both(scenario, backend)
    assert port == jax


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_custom_parser_disables_wire_path(backend):
    """A parser() that strips an envelope: content comes from the parser,
    never from the raw bytes."""
    def scenario(pkg, backend):
        broker = pkg.FakeBroker()
        broker.create_topic(TOPIC, 1)
        fs = pkg.MemoryFileSystem()
        cls = sample_message_class()
        for i in range(50):
            broker.produce(
                TOPIC, b"ENV!" + cls(query=f"e-{i}", timestamp=i).SerializeToString())
        b = make_builder(pkg, broker, fs, cls, backend, group_id="g",
                         parser=lambda raw: cls.FromString(raw[4:]),
                         max_file_open_duration_seconds=0.5)
        with Run(b):
            wait_until(lambda: broker.committed("g", TOPIC, 0) == 50, "50 committed")
        assert b._parser_is_default is False
        rows = read_rows(fs, fs.list_files("/out", extension=".parquet"))
        assert sorted(r["timestamp"] for r in rows) == list(range(50))
        assert all(r["query"].startswith("e-") for r in rows)
        return sorted(rows, key=lambda r: r["timestamp"])

    port, jax = both(scenario, backend)
    assert port == jax


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_published_name_collision_never_overwrites(backend, monkeypatch):
    """Finalizations inside one timestamp tick get -N suffixes: nothing
    published is overwritten."""
    import kpw_tpu.runtime.writer as JW
    import kpw_tpu_torch.runtime.writer as PW

    monkeypatch.setattr(JW, "_format_now", lambda pattern: "frozen")
    monkeypatch.setattr(PW, "_format_now", lambda pattern: "frozen")

    def scenario(pkg, backend):
        broker = pkg.FakeBroker()
        broker.create_topic(TOPIC, 1)
        fs = pkg.MemoryFileSystem()
        cls = sample_message_class()
        max_size = 100 * 1024
        produced = 0
        with Run(make_builder(pkg, broker, fs, cls, backend, max_file_size=max_size,
                              block_size=10 * 1024,
                              max_file_open_duration_seconds=300.0)):
            deadline = time.monotonic() + LIMIT_S
            while len(fs.list_files("/out", extension=".parquet")) < 3:
                assert time.monotonic() < deadline, "never rotated three times"
                if produced < 300_000:
                    produce_samples(broker, cls, 2000, start=produced)
                    produced += 2000
                time.sleep(0.002)
            files = sorted(fs.list_files("/out", extension=".parquet"))
        names = [f.rsplit("/", 1)[-1] for f in files]
        first = {"frozen_test_0.parquet", "frozen_test_0-1.parquet",
                 "frozen_test_0-2.parquet"}
        full = all(fs.size(f) > max_size * 0.99 for f in files)
        assert first <= set(names)
        assert full
        # how many files the loop saw depends on timing; the outcome is
        # that the first three names were published and every file is full
        return sorted(first & set(names)), full

    port, jax = both(scenario, backend)
    assert port == jax


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def test_stage_names_equal_jax():
    from kpw_tpu.utils import tracing as jt
    from kpw_tpu_torch.utils import tracing as pt

    assert pt.STAGE_NAMES == jt.STAGE_NAMES


def test_trace_export(tmp_path):
    """A traced writer's close() writes a Chrome trace whose spans carry
    the stages the JAX package's trace carries for the same run."""
    def scenario(pkg, backend):
        broker = pkg.FakeBroker()
        broker.create_topic(TOPIC, 1)
        fs = pkg.MemoryFileSystem()
        cls = sample_message_class()
        produce_samples(broker, cls, 200)
        path = str(tmp_path / f"{pkg.__name__}.json")
        b = make_builder(pkg, broker, fs, cls, backend, group_id="g",
                         max_file_open_duration_seconds=0.3)
        b.tracing(True).trace_path(path)
        with Run(b) as w:
            wait_until(lambda: broker.committed("g", TOPIC, 0) == 200, "committed")
            assert w.span_recorder is not None and len(w.span_recorder) > 0
        with open(path) as f:
            doc = json.load(f)
        names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
        assert {"consumer.fetch", "worker.shred", "rowgroup.io_write"} <= names
        return names & {"consumer.fetch", "worker.shred", "worker.append",
                        "worker.publish", "rowgroup.io_write"}

    port, jax = both(scenario, "cuda-on-cpu")
    assert port == jax
    from kpw_tpu_torch.utils.tracing import get_span_recorder, get_tracer

    assert get_span_recorder() is None and get_tracer() is None
