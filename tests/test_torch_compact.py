"""The port's compaction service (``kpw_tpu_torch/io/compact.py``) against
the JAX package's, on the same inputs: counterparts of
``tests/test_compact.py``'s compactor tests, each run through both
packages.  Both rewrite with the CPU encoder, so the merged files they
publish must be byte-identical; the write-ahead plan's crash protocol
(roll forward, roll back, torn output, failed retire) must end in the
same published tree.  Faults come from each package's own
``FaultInjectingFileSystem`` around its own in-memory filesystem.  The
remote tier's options (``bandwidth_bytes_per_s``,
``request_budget_per_round``, a shared bandwidth budget) wrap the sink in
each package's ``io/objectstore.py`` throttling filesystem.

The port's half of every test runs under the port's lock-order detector.
"""

import json
import time
from types import SimpleNamespace

import pyarrow.parquet as pq
import pytest
import torch

import kpw_tpu as J
import kpw_tpu_torch as P
from kpw_tpu_torch.utils import lockcheck as p_lockcheck
from proto_helpers import _F, _field, build_classes, nested_message_classes, \
    sample_message_class

torch.set_num_threads(1)

TOPIC = "pt"
BACKENDS = {"cpu": (("cpu",), "cpu"), "native": (("native",), "native"),
            "cuda-on-cpu": (("cuda", "cpu"), "tpu")}


def api(pkg):
    """The names a scenario needs, from ``pkg``."""
    if pkg is P:
        from kpw_tpu_torch.io import compact, verify
        from kpw_tpu_torch.models.proto_bridge import ProtoColumnarizer
        from kpw_tpu_torch.runtime import metrics
        from kpw_tpu_torch.runtime.parquet_file import ParquetFile
        from kpw_tpu_torch.utils.tracing import STAGE_NAMES
    else:
        from kpw_tpu.io import compact, verify
        from kpw_tpu.models.proto_bridge import ProtoColumnarizer
        from kpw_tpu.runtime import metrics
        from kpw_tpu.runtime.parquet_file import ParquetFile
        from kpw_tpu.utils.tracing import STAGE_NAMES
    return SimpleNamespace(compact=compact, verify=verify, M=metrics,
                           ProtoColumnarizer=ProtoColumnarizer,
                           ParquetFile=ParquetFile, STAGE_NAMES=STAGE_NAMES)


def both(scenario):
    """``scenario(pkg)`` for the port (under the port's lock-order
    detector) and for the JAX package: (port outcome, JAX outcome)."""
    det = p_lockcheck.install()
    try:
        port = scenario(P)
    finally:
        p_lockcheck.uninstall()
    assert not det.violations, [repr(v) for v in det.violations]
    return port, scenario(J)


def props(pkg, cls=None):
    return pkg.Builder().proto_class(cls or sample_message_class()).writer_properties()


def write_small_file(pkg, fs, path, cls, msgs):
    a = api(pkg)
    pf = a.ParquetFile(fs, path + ".tmp", a.ProtoColumnarizer(cls), props(pkg, cls),
                       batch_size=4096)
    pf.append_records(msgs)
    pf.close()
    fs.mkdirs(path.rsplit("/", 1)[0])
    fs.rename(path + ".tmp", path)


def plant(pkg, fs, cls, per_dir=4, rows_each=50, dirs=("k=0", "k=1"), root="/out"):
    """Small published files written directly: the total row count
    (timestamps unique)."""
    ts = 0
    for d in dirs:
        fs.mkdirs(f"{root}/{d}")
        for i in range(per_dir):
            msgs = [cls(query=f"q-{ts + j}", timestamp=ts + j) for j in range(rows_each)]
            write_small_file(pkg, fs, f"{root}/{d}/2026_f{i}.parquet", cls, msgs)
            ts += rows_each
    return ts


def published(pkg, fs, target="/out"):
    """({timestamp: count}, {path: bytes}) over every verified published
    file (tmp/quarantine/compacted excluded by verify_dir)."""
    reports = api(pkg).verify.verify_dir(fs, target)
    assert all(r.ok for r in reports), [r.errors for r in reports if not r.ok]
    got: dict[int, int] = {}
    files = {}
    for r in reports:
        files[r.path] = fs.open_read(r.path).read()
        for row in pq.read_table(fs.open_read(r.path)).to_pylist():
            got[row["timestamp"]] = got.get(row["timestamp"], 0) + 1
    return got, files


def compactor(pkg, fs, cls, **kw):
    kw.setdefault("target_size", 1 << 20)
    kw.setdefault("instance_name", "pt")
    return api(pkg).compact.Compactor(fs, "/out", cls, props(pkg, cls), **kw)


def listing(fs, d, ext):
    return sorted(fs.list_files(d, extension=ext))


# ---------------------------------------------------------------------------
# merge planning, verify-before-publish, retirement
# ---------------------------------------------------------------------------

def test_compactor_merges_retires_and_preserves_rows():
    def scenario(pkg):
        cls = sample_message_class()
        fs = pkg.MemoryFileSystem()
        total = plant(pkg, fs, cls)
        before = api(pkg).verify.verify_dir(fs, "/out")
        reg = (P.runtime.MetricRegistry if pkg is P else J.MetricRegistry)()
        c = compactor(pkg, fs, cls, registry=reg)
        summary = c.compact_once()
        got, files = published(pkg, fs)
        M = api(pkg).M
        return {"summary": {k: summary[k] for k in ("merged", "retired", "rows")},
                "before": len(before), "rows": (len(got), total),
                "once": all(v == 1 for v in got.values()), "files": files,
                "tombs": listing(fs, "/out/compacted", ".parquet"),
                "meters": (reg.get(M.COMPACTOR_MERGED_METER).count,
                           reg.get(M.COMPACTOR_RETIRED_METER).count),
                "rewritten": c.compactor_stats()["rows_rewritten"]}

    port, jax = both(scenario)
    assert port == jax
    assert port["summary"]["merged"] == 2 and len(port["files"]) == 2
    assert len(port["tombs"]) == 8 and port["once"]


def test_compactor_output_name_stable_across_remerges():
    """A merge output re-merged with newer small files round after round
    keeps one ``-compacted`` tag and the same bytes in both packages."""
    def scenario(pkg):
        cls = sample_message_class()
        fs = pkg.MemoryFileSystem()
        total = plant(pkg, fs, cls, per_dir=2, dirs=("k=0",))
        c = compactor(pkg, fs, cls)
        merged = [c.compact_once()["merged"]]
        for round_no in range(3):
            msgs = [cls(query=f"n{round_no}-{j}", timestamp=total + j) for j in range(50)]
            total += 50
            write_small_file(pkg, fs, f"/out/k=0/2027_n{round_no}.parquet", cls, msgs)
            merged.append(c.compact_once()["merged"])
        got, files = published(pkg, fs)
        return {"merged": merged, "files": files, "rows": (len(got), total)}

    port, jax = both(scenario)
    assert port == jax
    (name,) = port["files"]
    assert "compacted-compacted" not in name and port["merged"] == [1, 1, 1, 1]


def test_compactor_respects_min_files():
    def scenario(pkg):
        cls = sample_message_class()
        fs = pkg.MemoryFileSystem()
        plant(pkg, fs, cls, per_dir=1, dirs=("k=0",))
        planned = compactor(pkg, fs, cls, min_files=2).compact_once()["planned_groups"]
        return planned, published(pkg, fs)[1]

    port, jax = both(scenario)
    assert port == jax and port[0] == 0 and len(port[1]) == 1


def test_compactor_skips_unverifiable_input():
    def scenario(pkg):
        cls = sample_message_class()
        fs = pkg.MemoryFileSystem()
        plant(pkg, fs, cls, per_dir=3, dirs=("k=0",))
        with fs.open_read("/out/k=0/2026_f1.parquet") as f:
            whole = f.read()
        with fs.open_write("/out/k=0/2026_f1.parquet") as f:
            f.write(whole[: len(whole) // 2])
        summary = compactor(pkg, fs, cls).compact_once()
        merged = {r.path: fs.open_read(r.path).read()
                  for r in api(pkg).verify.verify_dir(fs, "/out") if r.ok}
        return {"merged": summary["merged"], "retired": summary["retired"],
                "torn_kept": fs.open_read("/out/k=0/2026_f1.parquet").read()
                == whole[: len(whole) // 2], "files": merged}

    port, jax = both(scenario)
    assert port == jax
    assert (port["merged"], port["retired"], port["torn_kept"]) == (1, 2, True)


def test_compactor_torn_rewrite_quarantined_inputs_untouched():
    """A torn merged tmp (writes dropped) never publishes: it is
    quarantined, the failed meter marks, every input stays published."""
    def scenario(pkg):
        cls = sample_message_class()
        inner = pkg.MemoryFileSystem()
        total = plant(pkg, inner, cls, per_dir=2, dirs=("k=0",))
        fs = pkg.FaultInjectingFileSystem(inner,
                                          pkg.FaultSchedule(seed=3).drop_writes_from(3))
        reg = (P.runtime.MetricRegistry if pkg is P else J.MetricRegistry)()
        summary = compactor(pkg, fs, cls, registry=reg).compact_once()
        got, files = published(pkg, inner)
        return {"merged": summary["merged"], "failed": summary["failed"] >= 1,
                "meter": reg.get(api(pkg).M.COMPACTOR_FAILED_METER).count >= 1,
                "rows": (len(got), total), "files": files,
                "quarantined": len(listing(inner, "/out/quarantine", ".tmp")),
                "tmp": listing(inner, "/out/tmp", ".tmp")}

    port, jax = both(scenario)
    assert port == jax
    assert port["merged"] == 0 and port["failed"] and port["quarantined"] >= 1


# ---------------------------------------------------------------------------
# the write-ahead plan's crash protocol
# ---------------------------------------------------------------------------

def test_compactor_recover_rolls_forward_after_partial_retire():
    """Publish landed, the first retire failed: recover() finishes
    retiring so no duplicate-published input survives."""
    def scenario(pkg):
        cls = sample_message_class()
        inner = pkg.MemoryFileSystem()
        total = plant(pkg, inner, cls, per_dir=2, dirs=("k=0",))
        sched = pkg.FaultSchedule(seed=4).fail_nth("rename", 3)
        merged = compactor(pkg, pkg.FaultInjectingFileSystem(inner, sched),
                           cls).compact_once()["merged"]
        dup = any(v > 1 for v in published(pkg, inner)[0].values())
        plans = listing(inner, "/out/compacted/.plans", ".plan.json")
        rec = compactor(pkg, inner, cls).recover()
        got, files = published(pkg, inner)
        return {"merged": merged, "dup_before": dup, "plans": len(plans),
                "recover": rec, "rows": (len(got), total),
                "once": all(v == 1 for v in got.values()), "files": files,
                "plans_after": listing(inner, "/out/compacted/.plans", ".plan.json")}

    port, jax = both(scenario)
    assert port == jax
    assert port["dup_before"] and port["recover"]["rolled_forward"] == 1 and port["once"]


def test_compactor_recover_keeps_plan_when_retire_fails():
    """A retire failing during recovery keeps the plan; the next, healed
    recovery finishes the roll-forward."""
    def scenario(pkg):
        cls = sample_message_class()
        inner = pkg.MemoryFileSystem()
        total = plant(pkg, inner, cls, per_dir=2, dirs=("k=0",))
        sched = pkg.FaultSchedule(seed=5).fail_nth("rename", 3, count=2)
        merged = compactor(pkg, pkg.FaultInjectingFileSystem(inner, sched),
                           cls).compact_once()["merged"]
        sick = pkg.FaultSchedule(seed=5).fail_forever_from("rename", 1)
        rec = compactor(pkg, pkg.FaultInjectingFileSystem(inner, sick), cls).recover()
        kept = listing(inner, "/out/compacted/.plans", ".plan.json")
        compactor(pkg, inner, cls).recover()
        got, files = published(pkg, inner)
        return {"merged": merged, "rolled_forward": rec["rolled_forward"],
                "kept": len(kept), "rows": (len(got), total),
                "once": all(v == 1 for v in got.values()), "files": files,
                "plans_after": listing(inner, "/out/compacted/.plans", ".plan.json")}

    port, jax = both(scenario)
    assert port == jax
    assert port["kept"] == 1 and not port["plans_after"] and port["once"]


def test_compactor_recover_rolls_back_unpublished_plan():
    """A plan and a half-written merged tmp, the output never landed:
    recover() drops the plan and sweeps the tmp."""
    def scenario(pkg):
        cls = sample_message_class()
        fs = pkg.MemoryFileSystem()
        total = plant(pkg, fs, cls, per_dir=2, dirs=("k=0",))
        fs.mkdirs("/out/compacted/.plans")
        plan = {"output": "/out/k=0/2026_f0-compacted.parquet",
                "inputs": [{"path": f"/out/k=0/2026_f{i}.parquet",
                            "tombstone": f"/out/compacted/k=0/2026_f{i}.parquet"}
                           for i in range(2)],
                "rows": total, "instance": "pt"}
        with fs.open_write("/out/compacted/.plans/x.plan.json") as f:
            f.write(json.dumps(plan).encode())
        fs.mkdirs("/out/tmp")
        with fs.open_write("/out/tmp/pt_compact_42.tmp") as f:
            f.write(b"half a merged row group")
        rec = compactor(pkg, fs, cls).recover()
        got, files = published(pkg, fs)
        return {"recover": rec, "rows": (len(got), total), "files": files,
                "tmp": listing(fs, "/out/tmp", ".tmp")}

    port, jax = both(scenario)
    assert port == jax
    assert port["recover"] == {"plans": 1, "rolled_forward": 0, "rolled_back": 1,
                               "tmp_swept": 1}


def test_compactor_recover_restores_inputs_under_torn_output():
    """The planned output is torn and one input already tombstoned:
    recover() quarantines the output and restores the input."""
    def scenario(pkg):
        cls = sample_message_class()
        fs = pkg.MemoryFileSystem()
        total = plant(pkg, fs, cls, per_dir=2, dirs=("k=0",))
        out = "/out/k=0/2026_f0-compacted.parquet"
        with fs.open_write(out) as f:
            f.write(b"PAR1 torn garbage")
        fs.mkdirs("/out/compacted/k=0")
        fs.rename("/out/k=0/2026_f0.parquet", "/out/compacted/k=0/2026_f0.parquet")
        fs.mkdirs("/out/compacted/.plans")
        plan = {"output": out,
                "inputs": [{"path": f"/out/k=0/2026_f{i}.parquet",
                            "tombstone": f"/out/compacted/k=0/2026_f{i}.parquet"}
                           for i in range(2)],
                "rows": total, "instance": "pt"}
        with fs.open_write("/out/compacted/.plans/x.plan.json") as f:
            f.write(json.dumps(plan).encode())
        rec = compactor(pkg, fs, cls).recover()
        got, files = published(pkg, fs)
        return {"rolled_back": rec["rolled_back"], "rows": (len(got), total),
                "once": all(v == 1 for v in got.values()), "files": files,
                "quarantine": listing(fs, "/out/quarantine", ".parquet")}

    port, jax = both(scenario)
    assert port == jax
    assert port["rolled_back"] == 1 and port["quarantine"] and port["once"]


# ---------------------------------------------------------------------------
# row reconstruction
# ---------------------------------------------------------------------------

def test_row_to_message_preserves_empty_submessage_presence():
    classes = build_classes("presence_port", {
        "Inner": [_field("x", 1, _F.TYPE_INT32)],
        "Outer": [_field("inner", 1, _F.TYPE_MESSAGE, type_name=".kpwtest.Inner")],
    })
    outer = classes["Outer"]
    for pkg in (P, J):
        set_empty = api(pkg).compact.row_to_message(outer, {"inner": {"x": None}})
        assert set_empty.HasField("inner") and not set_empty.inner.HasField("x")
        assert not api(pkg).compact.row_to_message(outer, {"inner": None}).HasField("inner")


def test_row_to_message_nested_roundtrip():
    order_cls = nested_message_classes()
    msg = order_cls(order_id=7, note="n")
    it = msg.items.add()
    it.sku, it.qty = "a", 2
    it.tags.extend(["x", "y"])
    row = {"order_id": 7, "note": "n",
           "items": [{"sku": "a", "qty": 2, "tags": ["x", "y"]}]}
    assert (api(P).compact.row_to_message(order_cls, row) == msg
            == api(J).compact.row_to_message(order_cls, row))


# ---------------------------------------------------------------------------
# the Builder-wired service
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_writer_with_compaction_service_end_to_end(backend):
    """A partitioned writer with ``Builder.compaction``: small files
    appear, merges land while the writer lives, and every row stays
    exactly once in the verified published set."""
    rows = 3000

    def scenario(pkg):
        cls = sample_message_class()
        broker = pkg.FakeBroker()
        broker.create_topic(TOPIC, 2)
        for i in range(rows):
            broker.produce(TOPIC, cls(query="q" * 60 + str(i), timestamp=i)
                           .SerializeToString(), partition=i % 2)
        fs = pkg.MemoryFileSystem()
        b = (pkg.Builder().broker(broker).topic(TOPIC).proto_class(cls)
             .target_dir("/out").filesystem(fs)
             .instance_name("pt").group_id("g").batch_size(128)
             .max_file_size(100 * 1024).max_file_open_duration_seconds(0.4)
             .partition_by(lambda rec, msg: f"k={msg.timestamp % 2}")
             .compaction(512 * 1024, scan_interval_seconds=0.1))
        args, jax_backend = BACKENDS[backend]
        b.encoder_backend(*args) if pkg is P else b.encoder_backend(jax_backend)
        w = b.build()
        w.start()
        try:
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and not (
                    sum(broker.committed("g", TOPIC, p) for p in range(2)) >= rows
                    and w.ack_lag()["unacked_records"] == 0
                    and w.stats()["compactor"]["merged"] >= 1):
                time.sleep(0.02)
            merged = w.stats()["compactor"]["merged"] >= 1
        finally:
            w.close()
        got, _ = published(pkg, fs)
        return {"merged": merged, "rows": len(got),
                "once": all(v == 1 for v in got.values())}

    port, jax = both(scenario)
    assert port == jax == {"merged": True, "rows": rows, "once": True}


# ---------------------------------------------------------------------------
# the remote tier, and the canonical names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["bandwidth", "requests", "shared_budget"])
def test_remote_tier_options_raise_naming_objectstore(tier):
    """The remote tier's options (a bandwidth budget, a request budget per
    round, a caller's shared ``BandwidthBudget``) wrap the sink in
    ``io/objectstore.py``'s throttling filesystem on both packages: the
    same rounds merge and defer the same groups, the published trees are
    byte-identical, and the remote block reports the same budget; the
    ``Builder`` builds with them.  The name is the one the test had when
    it asserted the ``NotImplementedError`` the port raised before
    ``io/objectstore.py`` was ported: it now asserts the opposite."""
    def scenario(pkg):
        cls = sample_message_class()
        fs = pkg.MemoryFileSystem()
        total = plant(pkg, fs, cls, per_dir=6, rows_each=120)
        sizes = [fs.size(p) for p in listing(fs, "/out", ".parquet")]
        kw = {"bandwidth": {"bandwidth_bytes_per_s": 5e7},
              "requests": {"request_budget_per_round": 5},
              "shared_budget": {"bandwidth_budget": pkg.BandwidthBudget(5e7)}}[tier]
        c = compactor(pkg, fs, cls, target_size=int(sum(sizes[:3]) / 1.2),
                      small_file_ratio=1.0, **kw)
        rounds = []
        for _ in range(20):
            s = c.compact_once()
            rounds.append({k: s[k] for k in ("merged", "deferred_requests")})
            if not s["merged"]:
                break
        remote = c.compactor_stats()["remote"]
        budget = remote.pop("budget", None)
        got, files = published(pkg, fs)
        w = (pkg.Builder().broker(pkg.FakeBroker()).topic(TOPIC).proto_class(cls)
             .target_dir("/w").filesystem(pkg.MemoryFileSystem())
             .encoder_backend("cpu")
             .compaction(1 << 20, **({"bandwidth_bytes_per_s": 1e6}
                                     if tier != "requests"
                                     else {"request_budget_per_round": 4}))
             .build())
        w.close()
        return {"rounds": rounds, "remote": remote,
                "budget": budget and (budget["budget_bytes_per_s"], budget["bytes_consumed"] > 0),
                "rows": (len(got), total), "once": all(v == 1 for v in got.values()),
                "files": files}

    port, jax = both(scenario)
    assert port == jax
    assert port["once"] and port["rows"][0] == port["rows"][1]
    assert len(port["rounds"]) > 2
    if tier == "requests":
        assert port["rounds"][0] == {"merged": 1, "deferred_requests": 3}


def test_partition_compaction_canonical_names_registered():
    for pkg in (P, J):
        M = api(pkg).M
        for name in (M.PARTITIONS_OPEN_GAUGE, M.PARTITIONS_EVICTED_METER,
                     M.COMPACTOR_MERGED_METER, M.COMPACTOR_RETIRED_METER,
                     M.COMPACTOR_FAILED_METER):
            assert name in M.METRIC_NAMES
        assert "compactor.merge" in api(pkg).STAGE_NAMES
    assert api(P).M.METRIC_NAMES == api(J).M.METRIC_NAMES
