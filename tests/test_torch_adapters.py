"""The port's real-backend adapters against the JAX package's:
``kpw_tpu_torch/ingest/kafka_client.py`` (``KafkaBrokerClient``) driven by
the scripted kafka-python stand-in ``tests/fake_kafka.py``, and
``kpw_tpu_torch/io/hdfs.py`` (``HdfsFileSystem``) with pyarrow's
``HadoopFileSystem`` swapped for a sub-tree of a local directory — the
counterparts of ``tests/test_real_adapters.py``.  Each scenario runs
through both packages (the fake cluster reset between them) and must end
in the same outcome; the ``Builder`` builds each adapter from its
pass-through config map (``consumer_config`` without a broker, an
``hdfs://`` ``fs.defaultFS``), and without kafka-python both packages
raise the same ``ImportError``."""

import sys
import threading
import time
import types

import pyarrow.parquet as pq
import pytest
import torch

import fake_kafka
import kpw_tpu as J
import kpw_tpu_torch as P
from proto_helpers import sample_message_class

torch.set_num_threads(1)


@pytest.fixture()
def kafka_env(monkeypatch):
    fake_kafka.reset_cluster()
    monkeypatch.setitem(sys.modules, "kafka", fake_kafka)
    structs_mod = types.ModuleType("kafka.structs")
    structs_mod.OffsetAndMetadata = fake_kafka.structs.OffsetAndMetadata
    errors_mod = types.ModuleType("kafka.errors")
    errors_mod.CommitFailedError = fake_kafka.errors.CommitFailedError
    monkeypatch.setitem(sys.modules, "kafka.structs", structs_mod)
    monkeypatch.setitem(sys.modules, "kafka.errors", errors_mod)
    return fake_kafka


def client(pkg):
    return pkg.KafkaBrokerClient("broker:9092", poll_timeout_ms=1)


def both(scenario):
    """(port outcome, JAX outcome), each on a fresh fake cluster."""
    out = []
    for pkg in (P, J):
        fake_kafka.reset_cluster()
        out.append(scenario(pkg))
    return tuple(out)


def pump_until(c, group, topic, member, want, deadline=5.0):
    end = time.time() + deadline
    while time.time() < end:
        c.generation(group, topic)
        got = c.assignment(group, topic, member)
        if len(got) == want:
            return got
        time.sleep(0.001)
    raise AssertionError(f"assignment never reached {want} partitions")


def test_join_pump_assign_fetch_commit(kafka_env):
    def scenario(pkg):
        kafka_env.CLUSTER.create_topic("t", 4)
        for p in range(4):
            for i in range(10):
                kafka_env.CLUSTER.produce("t", p, f"p{p}-{i}".encode())
        c = client(pkg)
        c.join_group("g", "t", "m1")
        out = {"before_pump": c.assignment("g", "t", "m1"),
               "parts": pump_until(c, "g", "t", "m1", 4)}
        member = next(iter(c._members.values()))
        recs = c.fetch("t", 2, 0, max_records=5)
        out["fetch"] = [(r.partition, r.offset, r.value) for r in recs]
        out["paused"] = sorted(tp.partition for tp in member.consumer.paused())
        out["replay"] = [r.offset for r in c.fetch("t", 2, 2, max_records=3)]
        c.fetch("t", 1, 0, max_records=2)
        out["paused2"] = sorted(tp.partition for tp in member.consumer.paused())
        c.commit("g", "t", 2, 5)
        out["committed"] = (c.committed("g", "t", 2), c.committed("g", "t", 3))
        c.leave_group("g", "t", "m1")
        out["after_leave"] = c.assignment("g", "t", "m1")
        return out

    port, jax = both(scenario)
    assert port == jax
    assert port["parts"] == [0, 1, 2, 3] and port["paused"] == [0, 1, 3]
    assert port["replay"] == [2, 3, 4] and port["committed"] == (5, 0)


def test_two_members_split_and_rebalance(kafka_env):
    def scenario(pkg):
        kafka_env.CLUSTER.create_topic("t", 4)
        for p in range(4):
            kafka_env.CLUSTER.produce("t", p, f"v{p}".encode())
        c = client(pkg)
        c.join_group("g", "t", "a")
        c.join_group("g", "t", "b")
        end = time.time() + 5
        while time.time() < end:
            c.generation("g", "t")
            pa, pb = c.assignment("g", "t", "a"), c.assignment("g", "t", "b")
            if len(pa) == 2 and len(pb) == 2:
                break
            time.sleep(0.001)
        split = sorted(pa + pb)
        gen_before = c.generation("g", "t")
        fetched = [[r.value for r in c.fetch("t", p, 0, max_records=10)]
                   for p in range(4)]
        c.leave_group("g", "t", "b")
        still = c.assignment("g", "t", "a")[0]
        end = time.time() + 5
        while time.time() < end:
            c.fetch("t", still, 1, max_records=1)
            c.generation("g", "t")
            if len(c.assignment("g", "t", "a")) == 4:
                break
            time.sleep(0.001)
        c.commit("g", "t", 3, 1)
        return {"split": split, "fetched": fetched,
                "survivor": c.assignment("g", "t", "a"),
                "gen_moved": c.generation("g", "t") != gen_before,
                "committed": c.committed("g", "t", 3)}

    port, jax = both(scenario)
    assert port == jax
    assert port == {"split": [0, 1, 2, 3], "fetched": [[b"v0"], [b"v1"], [b"v2"], [b"v3"]],
                    "survivor": [0, 1, 2, 3], "gen_moved": True, "committed": 1}


def test_commit_retries_across_rebalance_window(kafka_env):
    def scenario(pkg):
        kafka_env.CLUSTER.create_topic("t", 2)
        c = client(pkg)
        c.join_group("g", "t", "a")
        pump_until(c, "g", "t", "a", 2)
        c.join_group("g", "t", "b")
        stop = threading.Event()

        def pumper():
            while not stop.is_set():
                c.generation("g", "t")
                time.sleep(0.005)

        th = threading.Thread(target=pumper, daemon=True)
        th.start()
        try:
            moved = None
            end = time.time() + 5
            while time.time() < end and moved is None:
                pa, pb = set(c.assignment("g", "t", "a")), set(c.assignment("g", "t", "b"))
                if pa and pb and pa | pb == {0, 1}:
                    moved = next(iter(pb))
                time.sleep(0.002)
            c.commit("g", "t", moved, 7)
            return c.committed("g", "t", moved)
        finally:
            stop.set()
            th.join(timeout=5)

    assert both(scenario) == (7, 7)


def test_smart_consumer_end_to_end_over_kafka_client(kafka_env):
    def scenario(pkg):
        kafka_env.CLUSTER.create_topic("t", 3)
        total = 300
        for i in range(total):
            kafka_env.CLUSTER.produce("t", i % 3, f"r{i}".encode())
        c = client(pkg)
        consumer = (P.ingest.consumer if pkg is P else J.ingest.consumer)
        sc = consumer.SmartCommitConsumer(c, "g", page_size=50,
                                          max_open_pages_per_partition=10,
                                          fetch_max_records=40)
        sc.subscribe("t")
        sc.start()
        try:
            got = []
            end = time.time() + 10
            while len(got) < total and time.time() < end:
                batch = sc.poll_many(64)
                if not batch:
                    time.sleep(0.002)
                    continue
                got.extend(batch)
                for r in batch:
                    sc.ack_run(r.partition, r.offset, 1)
            end = time.time() + 5
            while time.time() < end and not all(
                    c.committed("g", "t", p) == total // 3 for p in range(3)):
                time.sleep(0.005)
            return (sorted(r.value for r in got),
                    [c.committed("g", "t", p) for p in range(3)])
        finally:
            sc.close()

    port, jax = both(scenario)
    assert port == jax
    assert len(port[0]) == 300 and port[1] == [100, 100, 100]


def test_kafka_client_edge_branches(kafka_env):
    def scenario(pkg):
        kafka_env.CLUSTER.create_topic("t", 2)
        c = client(pkg)
        out = [c.committed("g", "t", 0)]
        with pytest.raises(RuntimeError, match="no consumer joined"):
            c.commit("g", "t", 0, 1)
        c.join_group("g", "t", "m")
        c.join_group("g", "t", "m")
        out += [len(c._members), c.committed("g", "t", 0),
                c.fetch("t", 0, 0, max_records=5)]
        pump_until(c, "g", "t", "m", 2)
        out.append(c.fetch("t", 9, 0, max_records=5))
        with pytest.raises(RuntimeError, match="kept failing"):
            c.commit("g", "t", 9, 1)
        return out

    port, jax = both(scenario)
    assert port == jax == [0, 1, 0, [], []]


def test_consumer_config_builds_the_kafka_client(kafka_env):
    """``consumer_config`` without a broker builds a ``KafkaBrokerClient``
    from the pass-through map (``group.id`` routed to the writer's group,
    a conflicting ``group_id()`` refused, ``bootstrap.servers`` required)."""
    def scenario(pkg):
        cls = sample_message_class()

        def b():
            return (pkg.Builder().topic("t").proto_class(cls).target_dir("/o")
                    .filesystem(pkg.MemoryFileSystem()).encoder_backend("cpu"))

        w = b().consumer_config({"bootstrap.servers": "broker:9092",
                                 "group.id": "cg", "client.id": "x"}).build()
        out = [type(w._b._broker).__name__, w._b._group_id,
               w._b._broker._config]
        w.close()
        for cfg, gid in (({"bootstrap.servers": "b:1", "group.id": "cg"}, "other"),
                         ({"group.id": "cg"}, None)):
            bb = b().consumer_config(cfg)
            if gid:
                bb.group_id(gid)
            with pytest.raises(ValueError) as e:
                bb.build()
            out.append(str(e.value).split(" ")[0])
        return out

    port, jax = both(scenario)
    assert port == jax
    assert port[:2] == ["KafkaBrokerClient", "cg"] and port[2] == {"client_id": "x"}


def test_kafka_client_without_kafka_python_raises_import_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "kafka", None)
    msgs = []
    for pkg in (P, J):
        with pytest.raises(ImportError, match="kafka-python") as e:
            client(pkg)
        msgs.append(str(e.value).replace("kpw_tpu_torch", "kpw_tpu"))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# HDFS
# ---------------------------------------------------------------------------

@pytest.fixture()
def hdfs_root(monkeypatch, tmp_path):
    """pyarrow's HadoopFileSystem replaced by a sub-tree of a local
    directory (one per package): every adapter method runs its real
    pyarrow logic, only the libhdfs transport is substituted."""
    import pyarrow.fs as pafs

    roots = []

    def fake_hadoop(host, port, user=None, **kwargs):
        assert host == "namenode" and port == 9000
        root = tmp_path / f"hdfs{len(roots)}"
        root.mkdir()
        roots.append(root)
        return pafs.SubTreeFileSystem(str(root), pafs.LocalFileSystem())

    monkeypatch.setattr(pafs, "HadoopFileSystem", fake_hadoop)
    return roots


def hdfs_of(pkg):
    return pkg.HdfsFileSystem(host="namenode", port=9000)


def test_hdfs_adapter_full_surface(hdfs_root):
    def scenario(pkg):
        fs = hdfs_of(pkg)
        fs.mkdirs("out/tmp")
        with fs.open_write("out/tmp/a.tmp") as f:
            f.write(b"hello")
        out = [fs.exists("out/tmp/a.tmp"), fs.size("out/tmp/a.tmp")]
        with fs.open_append("out/tmp/a.tmp") as f:
            f.write(b" world")
        fs.rename("out/tmp/a.tmp", "out/a.parquet")
        out += [fs.exists("out/tmp/a.tmp"), fs.open_read("out/a.parquet").read()]
        fs.mkdirs("out/sub")
        with fs.open_write("out/sub/b.parquet") as f:
            f.write(b"x")
        out += [[p.rsplit("/", 1)[-1] for p in fs.list_files("out", ".parquet")],
                [p.rsplit("/", 1)[-1] for p in fs.list_files("out", ".parquet",
                                                             recursive=False)]]
        for bad, exc in (("out/nope", FileNotFoundError), ("out/sub", IsADirectoryError)):
            with pytest.raises(exc):
                fs.delete(bad)
        fs.delete("out/sub/b.parquet")
        out.append(fs.exists("out/sub/b.parquet"))
        return out

    port, jax = both(scenario)
    assert port == jax == [True, 5, False, b"hello world", ["a.parquet", "b.parquet"],
                           ["a.parquet"], False]


def test_hdfs_list_files_nested_partition_parity(hdfs_root):
    def scenario(pkg):
        fs = hdfs_of(pkg)
        layout = ["a.parquet", "dt=20260803/hour=14/x.parquet",
                  "dt=20260803/hour=15/z.parquet", "dt=20260804/notes.txt",
                  "tmp/k=1/pt_0_7.tmp"]
        for rel in layout:
            d = rel.rsplit("/", 1)[0] if "/" in rel else ""
            fs.mkdirs(f"p/{d}" if d else "p")
            with fs.open_write(f"p/{rel}") as f:
                f.write(b"x")
        rel = lambda ps: sorted(p.split("p/", 1)[1] for p in ps)  # noqa: E731
        return (rel(fs.list_files("p", extension=".parquet")), rel(fs.list_files("p")),
                rel(fs.list_files("p", extension=".parquet", recursive=False)),
                fs.list_files("p/absent"))

    port, jax = both(scenario)
    assert port == jax and port[2] == ["a.parquet"] and port[3] == []


def test_writer_over_hdfs_from_the_default_fs(hdfs_root):
    """``filesystem_config({"fs.defaultFS": "hdfs://namenode:9000"})``
    builds the HDFS adapter (reference parity, KPW.java:137-141) and the
    writer publishes through it: produce, rotate, read back."""
    def scenario(pkg):
        broker = pkg.FakeBroker()
        broker.create_topic("logs", 1)
        cls = sample_message_class()
        for i in range(120):
            broker.produce("logs", cls(query=f"q-{i}", timestamp=i).SerializeToString())
        b = (pkg.Builder().broker(broker).topic("logs").proto_class(cls)
             .target_dir("out").filesystem_config({"fs.defaultFS": "hdfs://namenode:9000"})
             .instance_name("hdfs-test").max_file_open_duration_seconds(0.5))
        b.encoder_backend("cuda", device="cpu") if pkg is P else b.encoder_backend("cpu")
        w = b.build()
        fs = w.fs
        with w:
            deadline = time.time() + 10
            files = []
            while time.time() < deadline and not files:
                files = fs.list_files("out", extension=".parquet", recursive=False)
                time.sleep(0.01)
        rows = [r["timestamp"] for p in files
                for r in pq.read_table(fs.open_read(p)).to_pylist()]
        return type(fs).__name__, sorted(rows)

    port, jax = both(scenario)
    assert port == jax == ("HdfsFileSystem", list(range(120)))
