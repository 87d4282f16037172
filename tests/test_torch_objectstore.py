"""The port's object-store tier (``kpw_tpu_torch/io/objectstore.py``)
against the JAX package's, the counterparts of ``tests/test_objectstore.py``:
each scenario runs through both packages on the same inputs (the port's
writers on its ``"cuda"`` encoder run on the CPU, the JAX package's on
``"cpu"``: their files are byte-identical) and must end in the same
outcome — store semantics and accounting, the multipart publish protocol
byte-identical to the rename protocol, background upload failures
re-shipped at close, the 503 fault persona, orphaned-multipart recovery
from the compactor's write-ahead plan in both crash windows, the startup
sweep, the bandwidth budget, verification over the store, the builder's
rejections and the canonical metric names.  The timing-shaped cases
(upload overlap, the bandwidth cap) assert the JAX suite's bounds on the
port."""

import dataclasses
import errno
import time
from types import SimpleNamespace

import pyarrow.parquet as pq
import pytest
import torch

import kpw_tpu as J
import kpw_tpu_torch as P
from proto_helpers import sample_message_class

torch.set_num_threads(1)

TOPIC = "ot"


def api(pkg):
    """The names a scenario needs, from ``pkg``."""
    if pkg is P:
        from kpw_tpu_torch.io import fs, objectstore, verify
        from kpw_tpu_torch.models.proto_bridge import ProtoColumnarizer
        from kpw_tpu_torch.runtime import export, metrics, retry
        from kpw_tpu_torch.runtime.parquet_file import ParquetFile
    else:
        from kpw_tpu.io import fs, objectstore, verify
        from kpw_tpu.models.proto_bridge import ProtoColumnarizer
        from kpw_tpu.runtime import export, metrics, retry
        from kpw_tpu.runtime.parquet_file import ParquetFile
    return SimpleNamespace(pkg=pkg, os=objectstore, fs=fs, verify=verify, M=metrics,
                           export=export, RetryPolicy=retry.RetryPolicy,
                           ProtoColumnarizer=ProtoColumnarizer, ParquetFile=ParquetFile)


def both(scenario):
    """(port outcome, JAX outcome) of ``scenario(api(pkg))``."""
    return scenario(api(P)), scenario(api(J))


def builder(a, broker, cls):
    b = a.pkg.Builder().broker(broker).topic(TOPIC).proto_class(cls)
    return b.encoder_backend("cuda", device="cpu") if a.pkg is P else b.encoder_backend("cpu")


def messages(cls, n, start=0, pad=120):
    return [cls(query=f"q-{start + i}-{'x' * pad}", timestamp=start + i)
            for i in range(n)]


def objfs(a, store=None, part_size=4096, **kw):
    store = store or a.os.EmulatedObjectStore()
    return store, a.os.ObjectStoreFileSystem(store, "t", part_size=part_size, **kw)


def write_file(a, fs, tmp_path, cls, msgs, row_group_size=16 * 1024):
    props = dataclasses.replace(a.pkg.Builder().proto_class(cls).writer_properties(),
                                row_group_size=row_group_size)
    pf = a.ParquetFile(fs, tmp_path, a.ProtoColumnarizer(cls), props, batch_size=256)
    pf.append_records(msgs)
    pf.close()
    return pf.path


def plant(a, fs, cls, root="/out", per_dir=3, rows_each=400, dirs=("k=0",)):
    ts = 0
    for d in dirs:
        for i in range(per_dir):
            path = f"{root}/{d}/2026_f{i}.parquet"
            write_file(a, fs, path + ".tmp", cls, messages(cls, rows_each, start=ts))
            fs.mkdirs(path.rsplit("/", 1)[0])
            a.fs.publish_file(fs, path + ".tmp", path, durable=False)
            ts += rows_each
    return ts


def published_rows(a, fs, root):
    got = {}
    for rep in a.verify.verify_dir(fs, root):
        assert rep.ok, rep.errors
        for r in pq.read_table(fs.open_read(rep.path)).to_pylist():
            got[r["timestamp"]] = got.get(r["timestamp"], 0) + 1
    return got


def compactor(a, fs, cls, **kw):
    return a.pkg.Compactor(fs, "/out", cls, a.pkg.Builder().proto_class(cls)
                           .writer_properties(), target_size=1 << 20,
                           instance_name="oc", **kw)


# -- the emulated store ------------------------------------------------------

def test_multipart_semantics_and_accounting():
    def scenario(a):
        store = a.os.EmulatedObjectStore()
        store.create_bucket("b")
        uid = store.create_multipart("b", "k/x.bin")
        store.upload_part(uid, 1, b"a" * 10)
        store.upload_part(uid, 2, b"b" * 4)
        out = {"before": (store.list_objects("b", "k/"),
                          store.list_multipart_uploads("b", "k/") == [
                              ("k/x.bin", uid, 2, 14)])}
        with pytest.raises(FileNotFoundError):
            store.get_object("b", "k/x.bin")
        store.complete_multipart(uid)
        out["after"] = (store.get_object("b", "k/x.bin"),
                        store.list_multipart_uploads("b", "k/"))
        uid2 = store.create_multipart("b", "k/y.bin")
        store.upload_part(uid2, 2, b"z")
        with pytest.raises(ValueError):
            store.complete_multipart(uid2)  # non-contiguous parts
        store.abort_multipart(uid2)
        store.put_object("b", "a", b"x" * 100)
        store.get_object("b", "a")
        store.copy_object("b", "a", "a2")
        st = store.stats()
        st.pop("latency_s")
        out["stats"] = st
        return out

    port, jax = both(scenario)
    assert port == jax
    assert port["after"] == (b"a" * 10 + b"b" * 4, [])
    assert port["stats"]["multipart_aborted"] == 1 and port["stats"]["bytes_out"] == 114


# -- the publish protocol ----------------------------------------------------

def test_multipart_publish_byte_identical_to_rename_publish():
    """One file through the rename protocol and through multipart
    complete, verified while still staged, published twice (the resumed
    retry): the bytes are equal across protocols and packages."""
    def scenario(a):
        cls = sample_message_class()
        msgs = messages(cls, 3000)
        mem = a.pkg.MemoryFileSystem()
        mem.mkdirs("/r/tmp")
        write_file(a, mem, "/r/tmp/a.tmp", cls, msgs)
        a.fs.publish_file(mem, "/r/tmp/a.tmp", "/r/out.parquet")
        store, fs = objfs(a)
        fs.mkdirs("/o/tmp")
        tmp = write_file(a, fs, "/o/tmp/a.tmp", cls, msgs)
        staged = (store.stats()["multipart_pending"], a.verify.verify_file(fs, tmp).ok)
        a.fs.publish_file(fs, tmp, "/o/out.parquet")
        a.fs.publish_file(fs, tmp, "/o/out.parquet")  # resumed retry: clean
        st = store.stats()
        return {"rename": mem.open_read("/r/out.parquet").read(),
                "commit": fs.open_read("/o/out.parquet").read(), "staged": staged,
                "completed": st["multipart_completed"],
                "pending": st["multipart_pending"],
                "verified": a.verify.verify_file(fs, "/o/out.parquet").ok}

    port, jax = both(scenario)
    assert port == jax
    assert port["rename"] == port["commit"] and len(port["commit"]) > 3 * 4096
    assert port["staged"] == (1, True) and port["completed"] == 1
    assert port["pending"] == 0 and port["verified"]


def test_background_upload_failure_reships_at_close():
    def scenario(a):
        sched = a.pkg.FaultSchedule(seed=3).fail_nth("objstore.upload_part", 2,
                                                     err=errno.EAGAIN)
        store, fs = objfs(a, a.os.EmulatedObjectStore(schedule=sched))
        payload = bytes(bytearray(range(256))) * 64  # 16 KiB, 4 parts
        with fs.open_write("/p/a.bin") as f:
            f.write(payload)
            time.sleep(0.05)  # let the background failure land
        a.fs.publish_file(fs, "/p/a.bin", "/p/out.bin")
        return fs.open_read("/p/out.bin").read() == payload

    assert both(scenario) == (True, True)


def test_upload_pipelining_hides_parts_under_open_file():
    """The port keeps the JAX suite's bounds: parts hide under a paced
    open file, and with pipelining off nothing hides."""
    a = api(P)
    overlap = {}
    for pipeline in (True, False):
        store = a.os.EmulatedObjectStore(latency_s=0.005)
        fs = a.os.ObjectStoreFileSystem(store, "t", part_size=4096,
                                        pipeline_uploads=pipeline)
        with fs.open_write("/p/a.bin") as f:
            for _ in range(10):
                f.write(b"z" * 4096)
                time.sleep(0.01)
        overlap[pipeline] = fs.objectstore_stats()["upload"]
    assert overlap[True]["files_sealed"] == 1 and overlap[True]["overlap_pct"] >= 50.0
    assert overlap[False]["overlap_pct"] == 0.0 and overlap[False]["inline_upload_s"] > 0


def test_spill_threshold_bounds_retained_buffer_byte_perfect():
    def scenario(a):
        import random

        store, fs = objfs(a, part_size=4096, spill_threshold_bytes=8192)
        rng = random.Random(19)
        expected = bytearray()

        def w(f, data, pos=None):
            if pos is not None:
                f.seek(pos)
            else:
                pos = f.tell()
            f.write(data)
            expected[pos:pos + len(data)] = data

        with fs.open_write("/d/big.tmp") as f:
            for _ in range(10):
                w(f, bytes(rng.getrandbits(8) for _ in range(4096)))
            w(f, b"REWRITTEN-AFTER-SHIP", pos=100)
            w(f, b"tail-after-rewind", pos=len(expected))
            spilled = f._data.spilled
        a.fs.publish_file(fs, "/d/big.tmp", "/d/big.bin", durable=False)
        up = fs.objectstore_stats()["upload"]
        return {"spilled": spilled, "equal": store.get_object("t", "d/big.bin")
                == bytes(expected), "handles": up["spilled_handles"],
                "threshold": up["spill_threshold_bytes"]}

    port, jax = both(scenario)
    assert port == jax == {"spilled": True, "equal": True, "handles": 1,
                           "threshold": 8192}


# -- the writer on the store -------------------------------------------------

def test_writer_survives_objectstore_fault_persona():
    """Scattered 503s on part uploads, slow parts, a failed complete: every
    one retried or re-shipped, no worker death, a full drain, every acked
    offset in a verified object exactly once, no upload left pending."""
    def scenario(a):
        cls = sample_message_class()
        rows, parts = 4000, 2
        broker = a.pkg.FakeBroker()
        broker.create_topic(TOPIC, parts)
        for i, m in enumerate(messages(cls, rows)):
            broker.produce(TOPIC, m.SerializeToString(), partition=i % parts)
        sched = a.pkg.objectstore_persona(seed=5, n_throttles=6, window=60,
                                          slow_parts=2, slow_s=0.02,
                                          complete_fail_nth=1)
        store = a.os.EmulatedObjectStore(schedule=sched)
        reg = a.M.MetricRegistry()
        w = (builder(a, broker, cls).target_dir("/obj")
             .object_store(store, "b", part_size=16 * 1024)
             .metric_registry(reg).instance_name("objw").group_id("g").batch_size(256)
             .retry_policy(a.RetryPolicy(base_sleep=0.005, max_sleep=0.05))
             .max_file_size(256 * 1024).block_size(32 * 1024)
             .max_file_open_duration_seconds(0.5)).build()
        w.start()
        deadline = time.time() + 60
        while time.time() < deadline:
            if (sum(broker.committed("g", TOPIC, p) for p in range(parts)) >= rows
                    and w.ack_lag()["unacked_records"] == 0):
                break
            time.sleep(0.01)
        stats = w.stats()
        w.close()
        got = published_rows(a, w.fs, "/obj")
        prom = a.export.registry_to_prometheus(reg)
        return {"committed": sum(broker.committed("g", TOPIC, p) for p in range(parts)),
                "dead": stats["supervision"]["workers_dead"],
                "throttled": any(e["errno"] == errno.EAGAIN for e in sched.fired()),
                "rows": len(got), "once": all(v == 1 for v in got.values()),
                "pending": store.stats()["multipart_pending"],
                "stats": sorted(stats["objectstore"]),
                "names": all(n in prom for n in (
                    "parquet_writer_objstore_requests_total",
                    "parquet_writer_objstore_bandwidth"))}

    port, jax = both(scenario)
    assert port == jax
    assert port == {"committed": 4000, "dead": 0, "throttled": True, "rows": 4000,
                    "once": True, "pending": 0, "stats": port["stats"], "names": True}


def test_writer_startup_sweep_aborts_orphan_upload():
    def scenario(a):
        cls = sample_message_class()
        store = a.os.EmulatedObjectStore()
        store.create_bucket("b")
        uid = store.create_multipart("b", "obj/tmp/objw_0_123.tmp")
        store.upload_part(uid, 1, b"half a row group")
        broker = a.pkg.FakeBroker()
        broker.create_topic(TOPIC, 1)
        w = (builder(a, broker, cls).target_dir("/obj").object_store(store, "b")
             .instance_name("objw").group_id("g").clean_abandoned_tmp(True)).build()
        w.start()
        w.close()
        st = store.stats()
        return st["multipart_pending"], st["multipart_aborted"]

    assert both(scenario) == ((0, 1), (0, 1))


def test_builder_rejects_process_workers_and_failover_on_objstore():
    def scenario(a):
        cls = sample_message_class()
        store, fs = objfs(a)
        errs = []
        for make in (
                lambda: a.pkg.Builder().broker(a.pkg.FakeBroker()).topic(TOPIC)
                .proto_class(cls).target_dir("/obj").object_store(store, "b")
                .process_workers(2).build(),
                lambda: a.pkg.FailoverFileSystem(fs, a.pkg.MemoryFileSystem()),
                lambda: a.pkg.FailoverFileSystem(a.pkg.MemoryFileSystem(), fs)):
            with pytest.raises(ValueError) as e:
                make()
            errs.append(str(e.value))
        return errs

    port, jax = both(scenario)
    assert port == jax
    assert "multipart upload handle" in port[0] and "rename-capable" in port[1]


def test_fault_wrapper_forwards_objstore_surfaces():
    def scenario(a):
        cls = sample_message_class()
        store, fs = objfs(a)
        wrapped = a.pkg.FaultInjectingFileSystem(fs, a.pkg.FaultSchedule(seed=1))
        reg = a.M.MetricRegistry()
        wrapped.bind_registry(reg)
        wrapped.mkdirs("/o/tmp")
        write_file(a, wrapped, "/o/tmp/a.tmp", cls, messages(cls, 1500))
        a.fs.publish_file(wrapped, "/o/tmp/a.tmp", "/o/out.parquet")
        plain = a.pkg.FaultInjectingFileSystem(a.pkg.MemoryFileSystem(),
                                               a.pkg.FaultSchedule())
        return {"rename": wrapped.supports_rename,
                "completed": store.stats()["multipart_completed"],
                "sealed": wrapped.objectstore_stats()["upload"]["files_sealed"],
                "parts": a.export.registry_to_json(reg)[a.M.OBJSTORE_PARTS_METER]["count"] > 0,
                "plain": (plain.supports_rename, hasattr(plain, "objectstore_stats"))}

    port, jax = both(scenario)
    assert port == jax == {"rename": False, "completed": 1, "sealed": 1,
                           "parts": True, "plain": (True, False)}


# -- orphans, compaction and verification over the store ---------------------

@pytest.mark.parametrize("window", ["complete", "retire"])
def test_orphan_recovery_from_the_write_ahead_plan(window):
    """Crash window 1 (``complete`` never ran: the plan rolls back and the
    orphan upload is aborted) and window 2 (``complete`` landed, the
    retires did not: the plan rolls forward); a fresh compactor recovers
    and no row is lost or duplicated."""
    def scenario(a):
        cls = sample_message_class()
        sched = a.pkg.FaultSchedule(seed=7)
        store, fs = objfs(a, a.os.EmulatedObjectStore(schedule=sched))
        total = plant(a, fs, cls)
        sched.fail_forever_from("objstore." + ("complete" if window == "complete"
                                               else "copy"), 1)
        summary = compactor(a, fs, cls).compact_once()
        mid = (store.stats()["multipart_pending"],
               sum(1 for v in published_rows(a, fs, "/out").values() if v > 1))
        sched.stop()
        fresh_fs = a.os.ObjectStoreFileSystem(store, "t", part_size=4096)
        fresh = compactor(a, fresh_fs, cls)
        rec = fresh.recover()
        while fresh.compact_once()["merged"] > 0:
            pass
        got = published_rows(a, fresh_fs, "/out")
        return {"summary": {k: summary[k] for k in ("merged", "failed")}, "mid": mid,
                "recover": {k: rec[k] for k in ("plans", "rolled_back", "rolled_forward")},
                "pending": store.stats()["multipart_pending"],
                "rows": (len(got), total), "once": all(v == 1 for v in got.values()),
                "tombstones": len(fresh_fs.list_files("/out/compacted",
                                                      extension=".parquet"))}

    port, jax = both(scenario)
    assert port == jax
    assert port["pending"] == 0 and port["once"] and port["rows"][0] == port["rows"][1]
    assert port["recover"]["rolled_back" if window == "complete" else "rolled_forward"] == 1


def test_remote_compaction_on_objstore_under_bandwidth_cap():
    """Merge reads and uploads over the store draw from one token bucket:
    the same merges on both packages, and on the port the observed rate
    stays at or under the budget."""
    def scenario(a):
        cls = sample_message_class()
        store, fs = objfs(a, part_size=8 * 1024)
        total = plant(a, fs, cls, per_dir=5, rows_each=800)
        c = compactor(a, fs, cls, bandwidth_bytes_per_s=1_500_000)
        merged = 0
        while (m := c.compact_once()["merged"]) > 0:
            merged += m
        obs = c.compactor_stats()["remote"]["budget"]
        got = published_rows(a, a.os.ObjectStoreFileSystem(store, "t"), "/out")
        return {"merged": merged, "rows": (len(got), total),
                "once": all(v == 1 for v in got.values()),
                "under": obs["bytes_consumed"] > 0
                and obs["observed_bytes_per_s"] <= 1_500_000 * 1.001}

    port, jax = both(scenario)
    assert port == jax and port["under"] and port["once"]


def test_verify_dir_and_summary_over_emulated_store():
    def scenario(a):
        cls = sample_message_class()
        _, fs = objfs(a)
        total = plant(a, fs, cls, per_dir=2, dirs=("k=0", "k=1"))
        roll = a.verify.summarize(a.verify.verify_dir(fs, "/out"))
        return {k: roll[k] for k in ("files", "failed", "rows")}, total

    port, jax = both(scenario)
    assert port == jax and port[0] == {"files": 4, "failed": 0, "rows": port[1]}


def test_bandwidth_budget_caps_observed_rate():
    a = api(P)
    budget = a.os.BandwidthBudget(2_000_000, burst_bytes=64 * 1024)
    fs = a.os.BandwidthBudgetedFileSystem(P.MemoryFileSystem(), budget)
    fs.mkdirs("/b")
    t0 = time.perf_counter()
    with fs.open_write("/b/x.bin") as f:
        for _ in range(6):
            f.write(b"q" * 100_000)
    with fs.open_read("/b/x.bin") as f:
        assert len(f.read()) == 600_000
    elapsed = time.perf_counter() - t0
    obs = budget.observed()
    assert elapsed >= (1_200_000 - budget.burst) / budget.rate * 0.9
    assert obs["observed_bytes_per_s"] <= budget.rate * 1.2
    assert obs["bytes_consumed"] == 1_200_000
