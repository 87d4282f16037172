"""The port's multi-tenant writer (``kpw_tpu_torch/runtime/multiwriter.py``,
``Builder.route``) against the JAX package's, on the same records:
counterparts of ``tests/test_tenants.py``, each drill run through both
packages' ``Builder`` and held to the same outcome — one shared broker
session, per-tenant trees and meters, quotas as backpressure on the
offender, the open-file budget, fault domains (a sink fault, a poison
stream, an incompatible schema contained to its route), schema evolution,
the cross-file schema audit and the shared compaction service.  Every
route runs the builder's encoder: the port's ``"cpu"``, ``"native"`` and
``"cuda"`` on ``device="cpu"`` beside the JAX ``"cpu"``, ``"native"`` and
``"tpu"``.  A shared compaction bandwidth budget needs
``io/objectstore.py`` and raises ``NotImplementedError`` naming it.

The port's half of every drill runs under the port's schedule-explorer
probes (the quota ledger's torn-update probe included) and lock-order
detector, the JAX half under the JAX package's.
"""

import errno
import threading
import time
from types import SimpleNamespace

import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import kpw_tpu as J
import kpw_tpu_torch as P
from kpw_tpu_torch.utils import lockcheck as p_lockcheck
from kpw_tpu_torch.utils import schedcheck as p_schedcheck
from proto_helpers import _F, _field, build_classes, sample_message_class

torch.set_num_threads(1)

PARTS = 2
BACKENDS = {"cpu": (("cpu",), "cpu"), "native": (("native",), "native"),
            "cuda-on-cpu": (("cuda", "cpu"), "tpu")}


def api(pkg):
    if pkg is P:
        from kpw_tpu_torch.io.fs import publish_file
        from kpw_tpu_torch.io.verify import audit_schema_consistency, file_schema
        from kpw_tpu_torch.models.proto_bridge import ProtoColumnarizer
        from kpw_tpu_torch.runtime import (MetricRegistry, TenantQuotaLedger,
                                           registry_to_json, registry_to_prometheus)
        from kpw_tpu_torch.runtime import metrics
        from kpw_tpu_torch.runtime.parquet_file import ParquetFile
    else:
        from kpw_tpu import (MetricRegistry, TenantQuotaLedger, registry_to_json,
                             registry_to_prometheus)
        from kpw_tpu.io.fs import publish_file
        from kpw_tpu.io.verify import audit_schema_consistency, file_schema
        from kpw_tpu.models.proto_bridge import ProtoColumnarizer
        from kpw_tpu.runtime import metrics
        from kpw_tpu.runtime.parquet_file import ParquetFile
    names = {k: v for k, v in locals().items() if k not in ("pkg", "metrics")}
    return SimpleNamespace(M=metrics, **names)


def both(scenario, backend="cpu"):
    """``scenario(pkg, backend)`` for the port under its own probes and
    for the JAX package under the JAX package's: (port, JAX) outcomes."""
    det = p_lockcheck.install()
    checker = p_schedcheck.install(seed=0, delay_prob=0.25, max_delay_s=0.002)
    try:
        port = scenario(P, backend)
    finally:
        p_schedcheck.uninstall()
        p_lockcheck.uninstall()
    assert not det.violations, [repr(v) for v in det.violations]
    assert not checker.violations, [repr(v) for v in checker.violations]
    from kpw_tpu.utils import lockcheck as j_lockcheck
    from kpw_tpu.utils import schedcheck as j_schedcheck

    jdet = j_lockcheck.install()
    jchecker = j_schedcheck.install(seed=0, delay_prob=0.25, max_delay_s=0.002)
    try:
        jax = scenario(J, backend)
    finally:
        j_schedcheck.uninstall()
        j_lockcheck.uninstall()
    assert not jdet.violations and not jchecker.violations
    return port, jax


def sample_v2_class():
    return build_classes("sample_v2_port", {
        "SampleMessage": [
            _field("query", 1, _F.TYPE_STRING, _F.LABEL_REQUIRED),
            _field("timestamp", 2, _F.TYPE_INT64, _F.LABEL_REQUIRED),
            _field("page_number", 3, _F.TYPE_INT32),
            _field("result_per_page", 4, _F.TYPE_INT32),
            _field("extra_score", 5, _F.TYPE_INT32),
        ]})["SampleMessage"]


def sample_incompatible_class():
    return build_classes("sample_bad_port", {
        "SampleMessage": [
            _field("query", 1, _F.TYPE_STRING, _F.LABEL_REQUIRED),
            _field("timestamp", 2, _F.TYPE_STRING, _F.LABEL_REQUIRED),
        ]})["SampleMessage"]


def produce(broker, topic, cls, n, start=0, pad=40, page_mod=None):
    for i in range(start, start + n):
        m = cls(query=f"q-{i}-{'x' * pad}", timestamp=i)
        if page_mod is not None:
            m.page_number = i % page_mod
        broker.produce(topic, m.SerializeToString(), partition=i % PARTS)


def base_builder(pkg, broker, fs, backend, reg=None):
    b = (pkg.Builder().broker(broker).filesystem(fs)
         .instance_name("tenants").thread_count(1).batch_size(256)
         .max_file_size(128 * 1024).block_size(32 * 1024)
         .max_file_open_duration_seconds(0.4)
         .supervise(True, max_restarts=4, restart_backoff_seconds=0.02))
    args, jax_backend = BACKENDS[backend]
    b.encoder_backend(*args) if pkg is P else b.encoder_backend(jax_backend)
    if reg is not None:
        b.metric_registry(reg)
    return b


def drain(mw, broker, expected, deadline_s=90, sample=None):
    group = next(iter(mw.routes.values()))._b._group_id
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if sample is not None:
            sample(mw)
        done = all(sum(broker.committed(group, topic, p) for p in range(PARTS)) >= rows
                   for topic, rows in expected.items())
        if done and mw.ack_lag()["unacked_records"] == 0:
            return
        time.sleep(0.02)
    raise AssertionError(f"never drained: lag={mw.ack_lag()}")


def tree_rows(fs, target, skip=("/tmp/",)):
    got: dict[int, int] = {}
    for f in fs.list_files(target, extension=".parquet"):
        if any(s in f for s in skip):
            continue
        for r in pq.read_table(fs.open_read(f)).to_pylist():
            got[r["timestamp"]] = got.get(r["timestamp"], 0) + 1
    return got


def seed_tree(pkg, fs, target, cls, rows, name="seed.parquet", start=0):
    a = api(pkg)
    props = pkg.Builder().proto_class(cls).writer_properties()
    tmp = f"{target}/tmp/{name}.tmp"
    fs.mkdirs(f"{target}/tmp")
    pf = a.ParquetFile(fs, tmp, a.ProtoColumnarizer(cls), props, batch_size=256)
    pf.append_records([cls(query=f"s-{i}", timestamp=i)
                       for i in range(start, start + rows)])
    pf.close()
    a.publish_file(fs, tmp, f"{target}/{name}", durable=False)
    return f"{target}/{name}"


# ---------------------------------------------------------------------------
# shared session, per-tenant trees, observability
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_routes_share_session_publish_per_tenant_trees_and_meters(backend):
    """Three tenants over one broker session, each with the builder's
    encoder: each drains into its own tree, the session's per-tenant fetch
    split is observable, and the tenant meters render in both
    exporters."""
    def scenario(pkg, backend):
        a = api(pkg)
        cls = sample_message_class()
        broker = pkg.FakeBroker()
        for t in ("ta", "tb", "tc"):
            broker.create_topic(t, PARTS)
            produce(broker, t, cls, 2000)
        fs = pkg.MemoryFileSystem()
        reg = a.MetricRegistry()
        mw = (base_builder(pkg, broker, fs, backend, reg)
              .route("ta", cls, "/mt/ta", queue_quota=50_000, ack_sla_seconds=30)
              .route("tb", cls, "/mt/tb").route("tc", cls, "/mt/tc").build())
        out = {"multi": type(mw).__name__}
        with mw:
            drain(mw, broker, {"ta": 2000, "tb": 2000, "tc": 2000})
            st = mw.stats()
            out["healthy"] = st["healthy"]
            out["tenants"] = {t: (st["tenants"][t]["state"],
                                  st["tenants"][t]["ack"]["unacked_records"],
                                  st["tenants"][t]["workers_dead"],
                                  st["tenants"][t]["sla_violated"],
                                  st["session"]["records_by_tenant"][t] >= 2000)
                              for t in ("ta", "tb", "tc")}
            out["quota"] = st["tenants"]["ta"]["quota"]["queue_quota"]
            out["route_stats"] = mw.route_stats("tb")["ack"]["unacked_records"]
        out["rows"] = {t: sorted(tree_rows(fs, f"/mt/{t}")) == list(range(2000))
                       for t in ("ta", "tb", "tc")}
        prom, js = a.registry_to_prometheus(reg), a.registry_to_json(reg)
        M = a.M
        out["rendered"] = all(
            name in js and name.replace(".", "_") in prom
            for name in (M.TENANT_QUEUE_STALLS_METER, M.TENANT_QUEUE_STALL_MS_METER,
                         M.TENANT_FILES_EVICTED_METER, M.DEADLETTER_METER,
                         M.TENANT_ROUTES_GAUGE, M.TENANT_ROUTES_DEGRADED_GAUGE))
        return out

    port, jax = both(scenario, backend)
    assert port == jax
    assert port["multi"] == "MultiWriter" and all(port["rows"].values())


# ---------------------------------------------------------------------------
# quotas: backpressure on the offender
# ---------------------------------------------------------------------------

def test_noisy_neighbor_quota_throttles_offender_not_victims():
    """The burst tenant's small queue share parks its own fetch gate; the
    victim's never fires; both drain, nothing is dropped."""
    def scenario(pkg, backend):
        cls = sample_message_class()
        broker = pkg.FakeBroker()
        broker.create_topic("burst", PARTS)
        broker.create_topic("victim", PARTS)
        produce(broker, "burst", cls, 12_000)
        produce(broker, "victim", cls, 2000)
        mw = (base_builder(pkg, broker, pkg.MemoryFileSystem(), backend)
              .route("burst", cls, "/nn/burst", queue_quota=600)
              .route("victim", cls, "/nn/victim", queue_quota=50_000,
                     ack_sla_seconds=30)
              .build())
        with mw:
            drain(mw, broker, {"burst": 12_000, "victim": 2000})
            led = mw.stats()["quota_ledger"]["tenants"]
            return {"burst_stalled": led["burst"]["quota_stalls"] > 0,
                    "victim_stalls": led["victim"]["quota_stalls"],
                    "queued": (led["burst"]["queued_records"],
                               led["victim"]["queued_records"]),
                    "sla": mw.stats()["tenants"]["victim"]["sla_violated"]}

    port, jax = both(scenario, "native")
    assert port == jax == {"burst_stalled": True, "victim_stalls": 0,
                           "queued": (0, 0), "sla": False}


def test_quota_gate_blocks_until_credit_and_counts_stall():
    """Ledger unit: a tenant at its share parks until a drain credit
    frees headroom; the stall is counted on the offender only."""
    def scenario(pkg, backend):
        led = api(pkg).TenantQuotaLedger()
        led.register("a", queue_quota=2)
        led.register("b", queue_quota=2)
        led.on_enqueued("a", 2)
        released = threading.Event()

        def gate():
            led.wait_turn("a", tick_s=0.01)
            released.set()

        t = threading.Thread(target=gate, daemon=True)
        t.start()
        parked = not released.wait(0.15)
        sibling = led.wait_turn("b")
        led.on_drained("a", 1)
        freed = released.wait(10.0)
        t.join(10.0)
        snap = led.tenant_snapshot("a")
        return {"parked": parked, "sibling": sibling, "freed": freed,
                "stalls": snap["quota_stalls"], "stalled": snap["quota_stall_s"] > 0,
                "b_stalls": led.tenant_snapshot("b")["quota_stalls"]}

    port, jax = both(scenario)
    assert port == jax == {"parked": True, "sibling": 0.0, "freed": True,
                           "stalls": 1, "stalled": True, "b_stalls": 0}


def test_quota_ledger_torn_update_probe():
    """The port's schedule explorer guards the ledger against torn
    multi-route updates as the JAX package's does: a consistent charge
    passes, a diverged per-tenant sum raises and is recorded."""
    from kpw_tpu.utils import schedcheck as j_schedcheck

    for sc in (p_schedcheck, j_schedcheck):
        act = sc.install(seed=0, delay_prob=0.25, max_delay_s=0.002)
        try:
            sc.note_quota_ledger(0xbeef, 7, 7)
            with pytest.raises(sc.QuotaLedgerTornError, match="torn"):
                sc.note_quota_ledger(0xbeef, 3, 4)
            assert any(isinstance(v, sc.QuotaLedgerTornError) for v in act.violations)
        finally:
            sc.uninstall()


def test_open_file_budget_evicts_lru_within_the_offending_route():
    """A partitioned route at its open-file budget closes and publishes
    its own LRU file before opening another: open files stay within the
    budget, the eviction meter binds, everything drains."""
    def scenario(pkg, backend):
        a = api(pkg)
        cls = sample_message_class()
        broker = pkg.FakeBroker()
        broker.create_topic("pt", PARTS)
        produce(broker, "pt", cls, 4000, page_mod=6)
        fs = pkg.MemoryFileSystem()
        reg = a.MetricRegistry()
        mw = (base_builder(pkg, broker, fs, backend, reg)
              .route("pt", cls, "/fb/pt", open_file_budget=2,
                     partition_by={"spec": "page_number", "max_open_partitions": 8})
              .build())
        seen = []
        with mw:
            drain(mw, broker, {"pt": 4000}, sample=lambda m: seen.append(
                m.stats()["tenants"]["pt"]["quota"]["open_files"]))
        return {"within": max(seen) <= 2,
                "evicted": reg.get(a.M.TENANT_FILES_EVICTED_METER).count > 0,
                "rows": set(tree_rows(fs, "/fb/pt")) >= set(range(4000))}

    port, jax = both(scenario, "cuda-on-cpu")
    assert port == jax == {"within": True, "evicted": True, "rows": True}


# ---------------------------------------------------------------------------
# fault domains
# ---------------------------------------------------------------------------

def test_sink_fault_pauses_offending_route_alone_then_recovers():
    """ENOSPC on one tenant's sink pauses that route alone: the sibling
    drains fully during the outage with no worker death, and after
    ``heal()`` the paused route resumes and drains."""
    def scenario(pkg, backend):
        cls = sample_message_class()
        broker = pkg.FakeBroker()
        for t in ("sick", "well"):
            broker.create_topic(t, PARTS)
            produce(broker, t, cls, 3000)
        sched = pkg.FaultSchedule(seed=3).recover_after("write", nth=6, err=errno.ENOSPC)
        mw = (base_builder(pkg, broker, pkg.MemoryFileSystem(), backend)
              .route("sick", cls, "/fd/sick",
                     filesystem=pkg.FaultInjectingFileSystem(pkg.MemoryFileSystem(), sched),
                     degraded_mode={"flag": True, "probe_interval_seconds": 0.05,
                                    "probe_backoff_max_seconds": 0.2})
              .route("well", cls, "/fd/well", filesystem=pkg.MemoryFileSystem(),
                     ack_sla_seconds=30)
              .build())
        out = {}
        try:
            mw.start()
            group = mw.route("well")._b._group_id
            deadline = time.monotonic() + 30
            while (time.monotonic() < deadline
                   and mw.stats()["tenants"]["sick"]["state"] != "paused"):
                time.sleep(0.02)
            out["paused"] = mw.stats()["tenants"]["sick"]["state"]
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and not (
                    sum(broker.committed(group, "well", p) for p in range(PARTS)) >= 3000
                    and mw.route("well").ack_lag()["unacked_records"] == 0):
                time.sleep(0.02)
            st = mw.stats()["tenants"]["well"]
            out["well"] = (sum(broker.committed(group, "well", p)
                               for p in range(PARTS)) >= 3000,
                           st["workers_dead"], st["restarts_total"], st["healthy"])
            sched.heal()
            drain(mw, broker, {"sick": 3000, "well": 3000})
            st = mw.stats()["tenants"]["sick"]
            out["sick"] = (st["state"], st["workers_dead"])
        finally:
            mw.close()
        return out

    port, jax = both(scenario, "native")
    assert port == jax == {"paused": "paused", "well": (True, 0, 0, True),
                           "sick": ("running", 0)}


def test_poison_stream_dead_letters_alone():
    """Garbage payloads on one tenant's topic dead-letter in its own tree
    without touching the sibling; the counts are exact."""
    def scenario(pkg, backend):
        a = api(pkg)
        cls = sample_message_class()
        broker = pkg.FakeBroker()
        broker.create_topic("poison", PARTS)
        broker.create_topic("clean", PARTS)
        n_poison = 0
        for i in range(2000):
            if i % 100 == 7:
                broker.produce("poison", b"\xff\xfe garbage " + bytes([i % 256]),
                               partition=i % PARTS)
                n_poison += 1
            else:
                broker.produce("poison", cls(query=f"q-{i}", timestamp=i)
                               .SerializeToString(), partition=i % PARTS)
        produce(broker, "clean", cls, 2000)
        fs = pkg.MemoryFileSystem()
        reg = a.MetricRegistry()
        mw = (base_builder(pkg, broker, fs, backend, reg)
              .route("poison", cls, "/ps/poison", on_parse_error="dead_letter")
              .route("clean", cls, "/ps/clean").build())
        with mw:
            drain(mw, broker, {"poison": 2000, "clean": 2000})
            st = mw.stats()["tenants"]
            out = {"poison_dl": st["poison"]["deadletter_records"],
                   "clean": (st["clean"]["deadletter_records"],
                             st["clean"]["workers_dead"], st["clean"]["restarts_total"])}
        out["meter"] = reg.get(a.M.DEADLETTER_METER).count
        out["dl_files"] = bool(fs.list_files("/ps/poison/deadletter"))
        out["clean_rows"] = sorted(tree_rows(fs, "/ps/clean")) == list(range(2000))
        return out, n_poison

    port, jax = both(scenario, "cpu")
    assert port == jax
    (out, n_poison) = port
    assert out["poison_dl"] == out["meter"] == n_poison and out["clean_rows"]


# ---------------------------------------------------------------------------
# schema evolution
# ---------------------------------------------------------------------------

def test_schema_additive_evolution_reads_consistently_merged():
    """V1 files, then V2 (one added optional field) streamed into the same
    tree: the merged read stays consistent and the audit reports the
    column as additive."""
    def scenario(pkg, backend):
        v1, v2 = sample_message_class(), sample_v2_class()
        broker = pkg.FakeBroker()
        broker.create_topic("evo", PARTS)
        fs = pkg.MemoryFileSystem()
        seed_tree(pkg, fs, "/evo/tree", v1, 500)
        for i in range(500, 1000):
            m = v2(query=f"q-{i}", timestamp=i)
            m.extra_score = i * 2
            broker.produce("evo", m.SerializeToString(), partition=i % PARTS)
        mw = base_builder(pkg, broker, fs, backend).route("evo", v2, "/evo/tree").build()
        with mw:
            drain(mw, broker, {"evo": 500})
            state = mw.stats()["tenants"]["evo"]["state"]
        files = [f for f in fs.list_files("/evo/tree", extension=".parquet")
                 if "/tmp/" not in f]
        merged = pa.concat_tables([pq.read_table(fs.open_read(f)) for f in files],
                                  promote_options="permissive")
        by_ts = {r["timestamp"]: r for r in merged.to_pylist()}
        audit = api(pkg).audit_schema_consistency(fs, "/evo/tree")
        return {"state": state, "several": len(files) >= 2,
                "rows": sorted(by_ts) == list(range(1000)),
                "values": (by_ts[100]["extra_score"], by_ts[700]["extra_score"]),
                "consistent": audit["consistent"],
                "additive": "extra_score" in audit["additive_columns"]}

    port, jax = both(scenario, "cuda-on-cpu")
    assert port == jax == {"state": "running", "several": True, "rows": True,
                           "values": (None, 1400), "consistent": True,
                           "additive": True}


def test_schema_incompatible_route_dead_letters_with_typed_reason():
    """A route whose proto conflicts with its published tree flips to
    dead-lettering at start() with the typed reason; the tree gains no
    mixed-schema file, acks still commit, the sibling is untouched."""
    def scenario(pkg, backend):
        v1, bad = sample_message_class(), sample_incompatible_class()
        broker = pkg.FakeBroker()
        broker.create_topic("tbad", PARTS)
        broker.create_topic("tok", PARTS)
        for i in range(300):
            broker.produce("tbad", bad(query=f"q-{i}", timestamp=str(i))
                           .SerializeToString(), partition=i % PARTS)
        produce(broker, "tok", v1, 1000)
        fs = pkg.MemoryFileSystem()
        seed_tree(pkg, fs, "/si/tree", v1, 200)
        before = {f for f in fs.list_files("/si/tree", extension=".parquet")
                  if "/tmp/" not in f}
        mw = (base_builder(pkg, broker, fs, backend)
              .route("tbad", bad, "/si/tree").route("tok", v1, "/si/ok").build())
        with mw:
            status = mw.route_status("tbad")
            out = {"status": (status["state"], status["reason_type"],
                              "timestamp" in status["reason"]),
                   "tok": mw.route_status("tok")["state"]}
            drain(mw, broker, {"tbad": 300, "tok": 1000})
            st = mw.stats()["tenants"]
            out["dl"] = (st["tbad"]["deadletter_records"],
                         st["tok"]["deadletter_records"], st["tok"]["workers_dead"])
        after = {f for f in fs.list_files("/si/tree", extension=".parquet")
                 if "/tmp/" not in f}
        out["unchanged"] = before == after
        out["consistent"] = api(pkg).audit_schema_consistency(fs, "/si/tree")["consistent"]
        out["dl_files"] = bool(fs.list_files("/si/tree/deadletter"))
        return out

    port, jax = both(scenario, "cpu")
    assert port == jax == {
        "status": ("dead_lettering", "SchemaIncompatibleError", True),
        "tok": "running", "dl": (300, 0, 0), "unchanged": True,
        "consistent": True, "dl_files": True}


def test_cross_file_schema_audit_flags_planted_mixed_tree():
    """A tree holding one leaf under two physical types is flagged with
    the column and its carrier files; a clean tree is not."""
    def scenario(pkg, backend):
        a = api(pkg)
        v1, bad = sample_message_class(), sample_incompatible_class()
        fs = pkg.MemoryFileSystem()
        seed_tree(pkg, fs, "/audit/tree", v1, 50, name="a.parquet")
        seed_tree(pkg, fs, "/audit/tree", v1, 50, name="b.parquet", start=50)
        clean = a.audit_schema_consistency(fs, "/audit/tree")
        props = pkg.Builder().proto_class(bad).writer_properties()
        tmp = "/audit/tree/tmp/x.tmp"
        fs.mkdirs("/audit/tree/tmp")
        pf = a.ParquetFile(fs, tmp, a.ProtoColumnarizer(bad), props, batch_size=64)
        pf.append_records([bad(query=f"q-{i}", timestamp=str(i)) for i in range(20)])
        pf.close()
        a.publish_file(fs, tmp, "/audit/tree/mixed.parquet", durable=False)
        audit = a.audit_schema_consistency(fs, "/audit/tree")
        leaves = a.file_schema(fs, "/audit/tree/mixed.parquet")
        return {"clean": (clean["consistent"], clean["files"]),
                "audit": (audit["consistent"], audit["files"]),
                "conflicts": sorted((c["column"], sorted(c["types"]))
                                    for c in audit["conflicts"]),
                "carriers": sorted(f for c in audit["conflicts"]
                                   for files in c["types"].values() for f in files),
                "leaves": sorted(leaves)}

    port, jax = both(scenario)
    assert port == jax
    assert port["clean"] == (True, 2) and port["audit"] == (False, 3)
    assert "/audit/tree/mixed.parquet" in port["carriers"]


# ---------------------------------------------------------------------------
# shared compaction service
# ---------------------------------------------------------------------------

def test_shared_compaction_service_compacts_every_route():
    """One service thread drives both routes' compactors: small files in
    both trees merge, and every row stays readable exactly once."""
    def scenario(pkg, backend):
        cls = sample_message_class()
        broker = pkg.FakeBroker()
        for t in ("ca", "cb"):
            broker.create_topic(t, PARTS)
            produce(broker, t, cls, 5000, pad=80)
        fs = pkg.MemoryFileSystem()
        comp = {"target_size": 512 * 1024, "scan_interval_seconds": 0.2}
        mw = (base_builder(pkg, broker, fs, backend).max_file_size(100 * 1024)
              .route("ca", cls, "/cp/ca", compaction=comp)
              .route("cb", cls, "/cp/cb", compaction=comp).build())
        with mw:
            drain(mw, broker, {"ca": 5000, "cb": 5000})
            deadline = time.monotonic() + 30
            merged = {}
            while time.monotonic() < deadline:
                snap = mw.stats()["compaction"]["by_tenant"]
                merged = {t: snap[t]["merged"] > 0 for t in ("ca", "cb")}
                if all(merged.values()):
                    break
                time.sleep(0.05)
        rows = {t: tree_rows(fs, f"/cp/{t}", skip=("/tmp/", "/compacted/"))
                for t in ("ca", "cb")}
        return {"merged": merged,
                "rows": {t: (sorted(r) == list(range(5000)),
                             all(c == 1 for c in r.values())) for t, r in rows.items()}}

    port, jax = both(scenario, "cuda-on-cpu")
    assert port == jax == {"merged": {"ca": True, "cb": True},
                           "rows": {"ca": (True, True), "cb": (True, True)}}


def test_shared_bandwidth_budget_raises_naming_objectstore():
    """One bandwidth bucket (``io/objectstore.py``'s ``BandwidthBudget``)
    for every route's merge traffic: on both packages the first route
    naming ``bandwidth_bytes_per_s`` sets it and every route's compactor
    draws from that one object.  The name is the one the test had when it
    asserted the ``NotImplementedError`` the port raised before
    ``io/objectstore.py`` was ported: it now asserts the opposite."""
    def scenario(pkg, backend):
        cls = sample_message_class()
        mw = base_builder(pkg, pkg.FakeBroker(), pkg.MemoryFileSystem(), backend)
        for t, cfg in (("ca", {"bandwidth_bytes_per_s": 2e6}), ("cb", {})):
            mw.route(t, cls, f"/cp/{t}", compaction={"target_size": 1 << 20, **cfg})
        mw = mw.build()
        try:
            comps = mw._compaction_svc._compactors
            budgets = {name: c._budget for name, c in comps.items()}
            return {"shared": len({id(b) for b in budgets.values()}) == 1,
                    "rates": sorted((t, b.rate) for t, b in budgets.items()),
                    "remote": {t: c.compactor_stats()["remote"]["bandwidth_bytes_per_s"]
                               for t, c in comps.items()}}
        finally:
            mw.close()

    port, jax = both(scenario, "cpu")
    assert port == jax
    assert port["shared"] and port["rates"] == [("ca", 2e6), ("cb", 2e6)]
