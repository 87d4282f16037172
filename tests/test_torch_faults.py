"""The port's fault injection and degraded operation against the JAX
package's: ``kpw_tpu_torch/io/faults.py`` (``FaultSchedule``,
``FaultInjectingFileSystem``, ``objectstore_persona``),
``kpw_tpu_torch/ingest/faults.py`` (``FaultInjectingBroker``) and
``kpw_tpu_torch/io/failover.py`` (``FailoverFileSystem``), the
counterparts of ``tests/test_faults.py``'s schedule and wrapper tests and
of ``tests/test_degrade.py``'s failover, pause/resume and bounded-close
scenarios.  Each case runs through both packages on the same inputs and
must end in the same outcome: the same ops fail with the same errnos at
the same ordinals, the same bytes land, the same spills reconcile.  The
port's writers run its ``"cuda"`` encoder on the CPU."""

import errno
import threading
import time
from types import SimpleNamespace

import pyarrow.parquet as pq
import pytest
import torch

import kpw_tpu as J
import kpw_tpu_torch as P
from proto_helpers import sample_message_class

torch.set_num_threads(1)

TOPIC = "degrade"


def api(pkg):
    if pkg is P:
        from kpw_tpu_torch.io import faults, verify
        from kpw_tpu_torch.runtime.retry import RetryPolicy
    else:
        from kpw_tpu.io import faults, verify
        from kpw_tpu.runtime.retry import RetryPolicy
    return SimpleNamespace(pkg=pkg, faults=faults, verify=verify, RetryPolicy=RetryPolicy)


def both(scenario, *args):
    return scenario(api(P), *args), scenario(api(J), *args)


def fired(sched):
    """The fault log without its clock."""
    return [{k: v for k, v in e.items() if k not in ("t", "ts", "time")}
            for e in sched.fired()]


# ---------------------------------------------------------------------------
# FaultSchedule / FaultInjectingFileSystem: one op script, many schedules
# ---------------------------------------------------------------------------

SCHEDULES = {
    "fail_nth": lambda s: s.fail_nth("write", 2, count=2, err=errno.EIO),
    "open_rename_delete": lambda s: s.fail_nth("open", 1).fail_nth("rename", 1)
    .fail_nth("delete", 1),
    "fail_forever_from": lambda s: s.fail_forever_from("write", 3),
    "fail_random": lambda s: s.fail_random("write", 3, 8),
    "torn_write": lambda s: s.fail_nth("write", 1, partial=0.5),
    "drop_writes": lambda s: s.drop_writes_from(3),
    "latency_only": lambda s: s.delay_nth("write", 1, 0.02),
    "recover_after_n": lambda s: s.recover_after("open", nth=2, err=errno.ENOSPC,
                                                 heal_after_ops=2),
    "recover_after_heal": lambda s: s.recover_after("write", nth=2, err=errno.EROFS),
    "stop": lambda s: s.fail_forever_from("write", 1),
    "persona": lambda s: s,
}


def run_script(a, case: str, inner, root: str) -> dict:
    """Open, write 8 chunks, close, rename and delete through the wrapper
    under the case's schedule, retrying each failed op once; the midpoint
    heals or stops the schedule where the case says so.  Returns every
    op's outcome, the bytes that landed, the fault log and the counts."""
    if case == "persona":
        sched = a.faults.objectstore_persona(seed=5, n_throttles=3, window=20)
    else:
        sched = SCHEDULES[case](a.faults.FaultSchedule(seed=5))
    fs = a.faults.FaultInjectingFileSystem(inner, sched)
    log = []

    def do(name, fn, retries=1):
        for _ in range(retries + 1):
            try:
                out = fn()
                log.append((name, "ok"))
                return out
            except a.faults.InjectedFault as e:
                log.append((name, e.errno))
        return None

    fs.mkdirs(f"{root}/d")
    f = do("open", lambda: fs.open_write(f"{root}/d/a"), retries=3)
    for i in range(8):
        if i == 4 and case == "recover_after_heal":
            sched.heal()
        if i == 4 and case == "stop":
            sched.stop()
        do("write", lambda: f.write(b"%02d" % i))
    f.close()
    do("rename", lambda: fs.rename(f"{root}/d/a", f"{root}/d/b"))
    with inner.open_read(f"{root}/d/b") as rf:
        data = rf.read()
    do("delete", lambda: fs.delete(f"{root}/d/b"))
    return {"log": log, "data": data, "fired": fired(sched), "plan": sched.plan(),
            "counts": dict(sched.counts()), "exists": fs.exists(f"{root}/d/b"),
            "listing": [p[len(root):] for p in fs.list_files(root)]}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
@pytest.mark.parametrize("inner", ["memory", "local"])
def test_fault_schedule_op_script(case, inner, tmp_path):
    def scenario(a, sub):
        if inner == "memory":
            return run_script(a, case, a.pkg.MemoryFileSystem(), "/p")
        return run_script(a, case, a.pkg.LocalFileSystem(), str(tmp_path / sub))

    port, jax = scenario(api(P), "port"), scenario(api(J), "jax")
    assert port == jax
    if case == "torn_write":  # the tear lands, the retry writes after it
        assert port["data"].startswith(b"0000")
    if case == "latency_only":
        assert port["fired"] == [] and port["data"] == b"".join(b"%02d" % i
                                                               for i in range(8))


def test_fault_schedule_plans_are_seeded():
    a, b = P.FaultSchedule(seed=42).fail_random("write", 5, 100), \
        J.FaultSchedule(seed=42).fail_random("write", 5, 100)
    assert a.plan() == b.plan()
    assert a.plan() != P.FaultSchedule(seed=43).fail_random("write", 5, 100).plan()
    assert (P.objectstore_persona(seed=3).plan()
            == J.objectstore_persona(seed=3).plan())


def test_hang_rules_park_release_and_time_out():
    """A hung op parks (no return, no raise) until released or stopped,
    then proceeds; a timeout-bounded hang proceeds by itself."""
    def scenario(a):
        out = {}
        for how in ("release", "stop", "timeout"):
            sched = a.faults.FaultSchedule(seed=0).hang_nth(
                "write", 1, timeout_s=0.2 if how == "timeout" else None)
            fs = a.faults.FaultInjectingFileSystem(a.pkg.MemoryFileSystem(), sched)
            fs.mkdirs("/h")
            f = fs.open_write("/h/a")
            done = threading.Event()

            def park():
                f.write(b"payload")
                f.close()
                done.set()

            t0 = time.monotonic()
            threading.Thread(target=park, daemon=True).start()
            parked = not done.wait(0.1)
            if how == "release":
                sched.release_hangs()
            elif how == "stop":
                sched.stop()
            finished = done.wait(5)
            out[how] = {"parked": parked, "finished": finished,
                        "waited": time.monotonic() - t0 >= 0.1,
                        "data": fs.open_read("/h/a").read(),
                        "hang": [(e["hang"], e["errno"]) for e in sched.fired()]}
        return out

    port, jax = both(scenario)
    assert port == jax
    assert all(v["parked"] and v["finished"] and v["data"] == b"payload"
               for v in port.values())


@pytest.mark.parametrize("kind", ["memory", "local", "fault-wrapped"])
def test_list_files_recursive_nested_partition_parity(kind, tmp_path):
    def scenario(a, sub):
        if kind == "local":
            fs, root = a.pkg.LocalFileSystem(), str(tmp_path / sub)
        else:
            fs, root = a.pkg.MemoryFileSystem(), "/p"
            if kind == "fault-wrapped":
                fs = a.faults.FaultInjectingFileSystem(fs, a.faults.FaultSchedule(seed=0))
        for rel in ("dt=1/a.parquet", "dt=1/hour=2/b.parquet", "dt=2/c.txt",
                    "top.parquet"):
            fs.mkdirs(f"{root}/" + rel.rsplit("/", 1)[0] if "/" in rel else root)
            with fs.open_write(f"{root}/{rel}") as f:
                f.write(b"x")
        rel = lambda ps: sorted(p[len(root):] for p in ps)  # noqa: E731
        return (rel(fs.list_files(root)), rel(fs.list_files(root, extension=".parquet")),
                rel(fs.list_files(root, recursive=False)),
                fs.list_files(f"{root}/missing"))

    port, jax = scenario(api(P), "port"), scenario(api(J), "jax")
    assert port == jax
    assert port[2] == ["/top.parquet"] and port[3] == []


def test_failover_list_files_unions_nested_trees():
    def scenario(a):
        primary, fallback = a.pkg.MemoryFileSystem(), a.pkg.MemoryFileSystem()
        for fs, rel in ((primary, "dt=1/a.parquet"), (fallback, "dt=1/b.parquet"),
                        (fallback, "dt=2/hour=3/c.parquet")):
            fs.mkdirs("/p/" + rel.rsplit("/", 1)[0])
            with fs.open_write(f"/p/{rel}") as f:
                f.write(b"x")
        ffs = a.pkg.FailoverFileSystem(primary, fallback, probe_interval_s=60)
        try:
            return (ffs.list_files("/p", extension=".parquet"),
                    ffs.list_files("/p", extension=".parquet", recursive=False))
        finally:
            ffs.close()

    port, jax = both(scenario)
    assert port == jax == (["/p/dt=1/a.parquet", "/p/dt=1/b.parquet",
                            "/p/dt=2/hour=3/c.parquet"], [])


# ---------------------------------------------------------------------------
# FaultInjectingBroker
# ---------------------------------------------------------------------------

def test_fault_injecting_broker():
    """Fetch and commit faults at scheduled ordinals on either fetch shape,
    a forced rebalance at a fetch ordinal bumping the generation, and the
    inner broker's feature detection kept."""
    def scenario(a):
        broker = a.pkg.FakeBroker()
        broker.create_topic("t", 2)
        for i in range(40):
            broker.produce("t", b"r%d" % i, partition=i % 2)
        sched = (a.faults.FaultSchedule(seed=1).fail_nth("fetch", 2, err=errno.EAGAIN)
                 .fail_nth("commit", 1, err=errno.ECONNRESET))
        fb = a.pkg.FaultInjectingBroker(broker, sched, rebalance_on_fetch=(3,))
        out = []
        gen0 = fb.generation("g", "t")
        for call in (lambda: fb.fetch("t", 0, 0, 5), lambda: fb.fetch_batch("t", 1, 0, 5),
                     lambda: fb.fetch("t", 0, 5, 5), lambda: fb.commit("g", "t", 0, 5),
                     lambda: fb.commit("g", "t", 0, 5)):
            try:
                r = call()
                out.append("ok" if r is None else len(r))
            except a.faults.InjectedFault as e:
                out.append(e.errno)
        fb.force_rebalance()
        bare = a.faults.FaultSchedule(seed=0)

        class NoBatch:
            def fetch(self, *args):
                return []

        return {"out": out, "gen": fb.generation("g", "t") - gen0,
                "committed": broker.committed("g", "t", 0), "fired": fired(sched),
                "batch_hidden": a.pkg.FaultInjectingBroker(NoBatch(), bare).fetch_batch}

    port, jax = both(scenario)
    assert port == jax
    assert port["out"] == [5, errno.EAGAIN, 5, errno.ECONNRESET, "ok"]
    assert port["gen"] == 2 and port["committed"] == 5 and port["batch_hidden"] is None


# ---------------------------------------------------------------------------
# degraded operation: failover, pause/resume, bounded close
# ---------------------------------------------------------------------------

def produce_indexed(broker, cls, rows, parts, pad=80):
    for i in range(rows):
        m = cls(query=f"q-{i}-" + "x" * pad, timestamp=i)
        broker.produce(TOPIC, m.SerializeToString(), partition=i % parts)


def make_writer(a, broker, fs, **knobs):
    b = (a.pkg.Builder().broker(broker).topic(TOPIC)
         .proto_class(sample_message_class()).target_dir("/out")
         .filesystem(fs).instance_name("degrade").group_id("g").batch_size(256)
         .retry_policy(a.RetryPolicy(base_sleep=0.005, max_sleep=0.05))
         .max_file_size(128 * 1024).block_size(32 * 1024)
         .max_file_open_duration_seconds(0.4))
    b.encoder_backend("cuda", device="cpu") if a.pkg is P else b.encoder_backend("cpu")
    for name, args in knobs.items():
        getattr(b, name)(**args) if isinstance(args, dict) else getattr(b, name)(args)
    return b.build()


def wait_until(cond, timeout=30.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


def committed(broker, parts):
    return sum(broker.committed("g", TOPIC, p) for p in range(parts))


def verified_rows(a, fs):
    got = {}
    for rep in a.verify.verify_dir(fs, "/out"):
        assert rep.ok, rep.errors
        for r in pq.read_table(fs.open_read(rep.path)).to_pylist():
            got[r["timestamp"]] = got.get(r["timestamp"], 0) + 1
    return got


def acked_covered(broker, parts, got):
    return all(got.get(off * parts + p, 0) >= 1 for p in range(parts)
               for off in range(broker.committed("g", TOPIC, p)))


def test_failover_spill_and_reconcile_invariant():
    """The primary dies (ENOSPC on open) mid-run: publishes spill to the
    fallback, the primary heals, every spill is verified and migrated
    back; every acked offset is then in a verified file ON THE PRIMARY."""
    def scenario(a):
        cls = sample_message_class()
        rows, parts = 6000, 2
        broker = a.pkg.FakeBroker()
        broker.create_topic(TOPIC, parts)
        produce_indexed(broker, cls, rows, parts)
        sched = a.faults.FaultSchedule(seed=4).recover_after("open", nth=2,
                                                              err=errno.ENOSPC)
        inner = a.pkg.MemoryFileSystem()
        fallback = a.pkg.MemoryFileSystem()
        ffs = a.pkg.FailoverFileSystem(a.faults.FaultInjectingFileSystem(inner, sched),
                                       fallback, probe_interval_s=0.05)
        w = make_writer(a, broker, ffs)
        w.start()
        try:
            wait_until(lambda: ffs.failover_stats()["spilled"] >= 2, msg="spills")
            degraded = ffs.degraded()
            sched.heal()
            wait_until(lambda: not ffs.degraded(), msg="primary recovery")
            wait_until(lambda: committed(broker, parts) >= rows
                       and w.ack_lag()["unacked_records"] == 0, msg="drain")
            st = w.stats()["failover"]
        finally:
            w.close()
            ffs.close()
        got = verified_rows(a, inner)
        return {"degraded": degraded, "failovers": st["failovers"],
                "recoveries": st["recoveries"],
                "reconciled_all": st["reconciled"] == st["spilled"] >= 2,
                "failed": st["reconcile_failed"], "pending": st["spilled_pending"],
                "covered": acked_covered(broker, parts, got),
                "left": a.verify.verify_dir(fallback, "/out")}

    port, jax = both(scenario)
    assert port == jax == {"degraded": True, "failovers": 1, "recoveries": 1,
                           "reconciled_all": True, "failed": 0, "pending": [],
                           "covered": True, "left": []}


def test_failover_declared_down_quarantine_and_close():
    """An operator's verdict flips the route: a valid spill reconciles
    home by durable rename, an unverifiable one is quarantined on the
    fallback (moved, never deleted, never migrated), and closing a healthy
    composite stops its reconciler without degrading its routing."""
    def scenario(a):
        import numpy as np

        core = a.pkg.core
        primary, fallback = a.pkg.MemoryFileSystem(), a.pkg.MemoryFileSystem()
        ffs = a.pkg.FailoverFileSystem(primary, fallback, probe_interval_s=30,
                                       probe_dir="/t/tmp")
        try:
            ffs.mkdirs("/t/tmp")
            ffs.declare_primary_down("watchdog: worker 0 IO hung")
            schema = core.Schema([core.leaf("v", "int64")])
            sink = ffs.open_write("/t/tmp/spill.tmp")
            pw = core.ParquetFileWriter(sink, schema)
            pw.write_batch(core.columns_from_arrays(schema,
                                                    {"v": np.arange(16, dtype=np.int64)}))
            pw.close()
            sink.close()
            ffs.durable_rename("/t/tmp/spill.tmp", "/t/spill.parquet")
            with ffs.open_write("/t/tmp/x.tmp") as f:
                f.write(b"PAR1 garbage, not a parquet file")
            ffs.rename("/t/tmp/x.tmp", "/t/garbage.parquet")
            spilled = (fallback.exists("/t/spill.parquet"),
                       primary.exists("/t/spill.parquet"),
                       ffs.failover_stats()["spilled"])
            ok = ffs.reconcile_now()
            st = ffs.failover_stats()
            q = st["quarantined_spills"]
            out = {"spilled": spilled, "reconciled": (ok, st["reconciled"],
                                                      st["reconcile_failed"]),
                   "home": a.verify.verify_file(primary, "/t/spill.parquet").ok,
                   "quarantined": [(e["path"], fallback.open_read(e["quarantined_to"])
                                    .read()) for e in q],
                   "degraded": ffs.degraded()}
        finally:
            ffs.close()
        healthy = a.pkg.FailoverFileSystem(a.pkg.MemoryFileSystem(),
                                           a.pkg.MemoryFileSystem(), probe_interval_s=0.05)
        healthy.close()
        healthy.mkdirs("/t/tmp")
        with healthy.open_write("/t/tmp/a.tmp") as f:
            f.write(b"x")
        healthy.rename("/t/tmp/a.tmp", "/t/a.parquet")
        out["closed"] = (healthy.degraded(), healthy.primary.exists("/t/a.parquet"),
                         healthy.failover_stats()["spilled"])
        return out

    port, jax = both(scenario)
    assert port == jax
    assert port == {"spilled": (True, False, 2), "reconciled": (True, 1, 1),
                    "home": True,
                    "quarantined": [("/t/garbage.parquet",
                                     b"PAR1 garbage, not a parquet file")],
                    "degraded": False, "closed": (False, True, 0)}


def test_pause_resume_on_fatal_errno():
    """ENOSPC pauses the worker instead of killing it: the bounded queue
    fills with the fetcher alive, the schedule heals, the writer resumes
    and drains with no death or restart."""
    def scenario(a):
        cls = sample_message_class()
        rows, parts = 6000, 2
        broker = a.pkg.FakeBroker()
        broker.create_topic(TOPIC, parts)
        produce_indexed(broker, cls, rows, parts)
        sched = a.faults.FaultSchedule(seed=5).recover_after("write", nth=8,
                                                              err=errno.ENOSPC)
        fs = a.faults.FaultInjectingFileSystem(a.pkg.MemoryFileSystem(), sched)
        w = make_writer(a, broker, fs,
                        degraded_mode=dict(probe_interval_seconds=0.05,
                                           probe_backoff_max_seconds=0.2),
                        max_queued_records_in_consumer=2000)
        w.start()
        try:
            wait_until(lambda: w.stats()["degraded"]["paused_workers"], msg="pause")
            paused = (w.healthy(), "28" in w.stats()["degraded"]["paused_workers"][0]
                      ["cause"] or "ENOSPC" in w.stats()["degraded"]["paused_workers"][0]
                      ["cause"])
            wait_until(lambda: (w.stats()["consumer"]["queue"]["depth"]
                                == w.stats()["consumer"]["queue"]["capacity"]),
                       msg="backpressure")
            alive = w.stats()["consumer"]["fetcher_alive"]
            sched.heal()
            wait_until(lambda: committed(broker, parts) >= rows
                       and w.ack_lag()["unacked_records"] == 0, msg="drain")
            st = w.stats()
            out = {"paused": paused, "alive": alive,
                   "counts": (st["degraded"]["pause_count"],
                              st["degraded"]["resume_count"],
                              st["degraded"]["paused_workers"]),
                   "failed": st["meters"]["parquet.writer.failed"]["count"],
                   "restarts": st["supervision"]["restarts_total"],
                   "healthy": w.healthy(),
                   "covered": acked_covered(broker, parts, verified_rows(a, fs))}
        finally:
            w.close()
        return out

    port, jax = both(scenario)
    assert port == jax == {"paused": (False, True), "alive": True,
                           "counts": (1, 1, []), "failed": 0, "restarts": 0,
                           "healthy": True, "covered": True}


def test_close_deadline_returns_under_hung_write():
    """A write that never returns: ``close(deadline=2)`` comes back within
    the budget, reports the hung worker, and nothing is published or
    committed."""
    def scenario(a):
        cls = sample_message_class()
        broker = a.pkg.FakeBroker()
        broker.create_topic(TOPIC, 2)
        produce_indexed(broker, cls, 2000, 2)
        sched = a.faults.FaultSchedule(seed=7).hang_nth("write", 1)
        fs = a.faults.FaultInjectingFileSystem(a.pkg.MemoryFileSystem(), sched)
        w = make_writer(a, broker, fs)
        w.start()
        try:
            wait_until(lambda: sched.counts().get("write", 0) >= 1, msg="the hang")
            time.sleep(0.1)
            t0 = time.monotonic()
            report = w.close(deadline=2.0)
            return {"fast": time.monotonic() - t0 < 6.0,
                    "met": report["deadline_met"], "hung": report["hung_workers"],
                    "abandoned": report["abandoned_held_records"] > 0,
                    "committed": committed(broker, 2),
                    "published": a.verify.verify_dir(fs, "/out")}
        finally:
            sched.release_hangs()

    port, jax = both(scenario)
    assert port == jax == {"fast": True, "met": True, "hung": [0], "abandoned": True,
                           "committed": 0, "published": []}
