"""The port's spans (``kpw_tpu_torch/utils/tracing.py``) on the CPU.

- every literal span name in the package is registered, in the JAX
  package's ``STAGE_NAMES`` or in the port's own ``PORT_STAGE_NAMES``;
- a traced writer's file cycle nests as documented: each ``worker.rotate``,
  on the worker's finisher thread, holds one ``worker.close``, one
  ``worker.publish`` and the file's ``worker.ack``, and the worker thread
  waits for it in ``worker.rotate_wait``; each ``rowgroup.latency`` holds its row group's merge,
  launch (or encode), assembly and IO write; every ``stage()`` span carries
  its thread's CPU time;
- with nothing installed, spans and transfer counters read no clock and
  count nothing;
- spans and the PyTorch profiler's events share the Unix clock.

Only nesting and presence are asserted, no timing thresholds.
"""

import ast
import os
import statistics
import threading
import time
import types

import numpy as np
import pytest
import torch

import kpw_tpu_torch as P
from kpw_tpu_torch import device as port_device
from kpw_tpu_torch.core import ParquetFileWriter, Schema, WriterProperties, leaf
from kpw_tpu_torch.core.writer import columns_from_arrays
from kpw_tpu_torch.ops.backend import CudaChunkEncoder
from kpw_tpu_torch.utils import tracing
from proto_helpers import sample_message_class

torch.set_num_threads(1)

PACKAGE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "kpw_tpu_torch")
TOPIC = "t"
LIMIT_S = 30.0
EPS = 1e-6  # float rounding of span ends, in seconds
WORKER_TOP = ("worker.poll", "worker.shred", "worker.append", "worker.handoff",
              "worker.rotate_wait")


def wait_until(pred, what: str, limit: float = LIMIT_S):
    deadline = time.monotonic() + limit
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.002)
    raise AssertionError(f"not within {limit} s: {what}")


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def _span_calls():
    """(path, line, name) of every call ``stage(...)`` / ``record_span(...)``
    (bare or as an attribute) in the package whose first argument is a
    string literal; a non-literal first argument is reported as None."""
    for d, _, files in os.walk(PACKAGE):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            for node in ast.walk(ast.parse(open(path).read())):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                fn = node.func
                name = (fn.id if isinstance(fn, ast.Name)
                        else fn.attr if isinstance(fn, ast.Attribute) else None)
                if name not in ("stage", "record_span"):
                    continue
                arg = node.args[0]
                yield (path, node.lineno,
                       arg.value if isinstance(arg, ast.Constant) else None)


def test_every_literal_span_name_is_registered():
    calls = list(_span_calls())
    names = {n for _, _, n in calls}
    assert {"worker.rotate", "rowgroup.latency", "worker.shred"} <= names
    known = set(tracing.STAGE_NAMES) | set(tracing.PORT_STAGE_NAMES)
    bad = [(os.path.relpath(p, PACKAGE), line, n) for p, line, n in calls
           if n is not None and n not in known]
    assert not bad, bad


def test_port_stage_names_are_new_and_each_is_used():
    port = tracing.PORT_STAGE_NAMES
    assert len(set(port)) == len(port)
    assert not set(port) & set(tracing.STAGE_NAMES)
    used = {n for _, _, n in _span_calls()}
    assert set(port) <= used


# ---------------------------------------------------------------------------
# a traced writer's file cycle
# ---------------------------------------------------------------------------

def _traced_run(mode: str):
    """A traced ``cuda``-on-CPU writer over 6,000 records of about 80 B in
    files of 100 KiB (the least the Builder takes) and row groups of 24
    KiB, drained until every published file is acked.  Returns (spans,
    recorder)."""
    cls = sample_message_class()
    broker = P.FakeBroker()
    broker.create_topic(TOPIC, 1)
    n = 6000
    rng = np.random.default_rng(13)
    broker.produce_many(TOPIC, [cls(query=rng.bytes(32).hex(), timestamp=i).SerializeToString()
                                for i in range(n)])
    b = (P.Builder().broker(broker).topic(TOPIC).proto_class(cls)
         .target_dir("/out").filesystem(P.MemoryFileSystem()).instance_name("tr")
         .group_id("g").encoder_backend("cuda", device="cpu")
         .batch_size(64).fetch_max_records(256)
         .max_file_size(100 << 10).block_size(24 << 10)
         .max_file_open_duration_seconds(0.5)
         .pipeline(mode != "sync").tracing(True))
    if mode == "records":  # a parser of its own: the per-record path
        b.parser(lambda v: cls.FromString(v))
    w = b.build()
    w.start()
    try:
        wait_until(lambda: broker.committed("g", TOPIC, 0) == n, "every record acked")
    finally:
        w.close(deadline=LIMIT_S)
    rec = w.span_recorder
    return rec.snapshot(), rec


def _thread_clock_step_ms() -> float:
    """The largest step of this thread's CPU clock while it spins: a
    microsecond or less where the clock is fine, a scheduler tick (10 ms,
    say) where the kernel charges CPU time a tick at a time.  A span's
    ``cpu_ms`` can then exceed its wall time by up to one step."""
    step, changes = 0, 0
    last = time.thread_time_ns()
    start = time.perf_counter()
    while time.perf_counter() - start < 1.0 and (
            changes < 3 or time.perf_counter() - start < 0.05):
        now = time.thread_time_ns()
        if now != last:
            step, changes = max(step, now - last), changes + 1
            last = now
    return step / 1e6


def _within(inner, outer) -> bool:
    return (outer[3] - EPS <= inner[3]
            and inner[3] + inner[4] <= outer[3] + outer[4] + EPS)


@pytest.mark.parametrize("mode", ["pipelined", "sync", "records"])
def test_file_cycle_and_row_group_spans_nest(mode):
    spans, rec = _traced_run(mode)
    assert rec.dropped == 0
    by = {}
    for s in spans:
        by.setdefault(s[0], []).append(s)

    # every stage() span carries its thread's CPU time, within its wall time
    # and one step of the thread clock
    step_ms = _thread_clock_step_ms()
    for name, _, _, _, dur, attrs in spans:
        if name == "rowgroup.latency":  # record_span: work of three threads
            continue
        assert "cpu_ms" in attrs, name
        assert 0 <= attrs["cpu_ms"] <= dur * 1e3 + 1.0 + step_ms, (
            name, attrs["cpu_ms"], dur, step_ms)

    # the file cycle: rotate > close, publish, ack of the same file
    rotates = by["worker.rotate"]
    assert len(rotates) >= 3
    for r in rotates:
        attrs = r[5]
        assert attrs["records"] > 0 and attrs["bytes"] > 0 and attrs["reason"]
        mine = {name: [s for s in by.get(name, ()) if s[2] == r[2] and _within(s, r)]
                for name in ("worker.close", "worker.publish", "worker.ack")}
        assert len(mine["worker.close"]) == 1 and len(mine["worker.publish"]) == 1
        assert len(mine["worker.ack"]) >= 1
        for name, got in mine.items():
            assert all(s[5]["file"] == attrs["file"] for s in got), name
        assert mine["worker.ack"][0][5]["runs"] >= 1
    assert len({r[5]["file"] for r in rotates}) == len(rotates)

    # the worker's top-level spans follow each other on its thread; the
    # rotations, on its finisher thread, follow each other there
    worker = by["worker.poll"][0][2]
    assert {s[2] for s in by["worker.poll"]} == {worker}
    finisher = rotates[0][2]
    assert finisher != worker and {r[2] for r in rotates} == {finisher}
    top = sorted((s for s in spans if s[2] == worker and s[0] in WORKER_TOP),
                 key=lambda s: s[3])
    assert {s[0] for s in top} >= {"worker.poll", "worker.append", "worker.handoff",
                                   "worker.rotate_wait"}
    for a, b in zip(top, top[1:]):
        assert a[3] + a[4] <= b[3] + EPS, (a[0], b[0])
    fin = sorted(rotates, key=lambda s: s[3])
    for a, b in zip(fin, fin[1:]):
        assert a[3] + a[4] <= b[3] + EPS and a[5]["file"] < b[5]["file"]
    # a wait ends once the rotation it waits for has ended
    ends = {r[5]["file"]: r[3] + r[4] for r in rotates}
    waits = by["worker.rotate_wait"]
    assert len(waits) >= len(rotates) - 1
    for wt in waits:
        assert ends[wt[5]["file"]] <= wt[3] + wt[4] + EPS
    polls = by["worker.poll"]
    assert sum(s[5]["records"] for s in polls) >= 6000
    assert any(s[5].get("rows", 0) > 0 for s in by["worker.handoff"])
    if mode != "records":
        shreds = by["worker.shred"]
        assert sum(s[5]["records"] for s in shreds) >= 6000
        assert all(s[5]["bytes"] > 0 for s in shreds)

    # a row group's path: latency > merge, launch or encode, assemble, io_write
    latencies = by["rowgroup.latency"]
    assert len(latencies) >= len(rotates)
    per_rg = {}
    for s in spans:
        rg = (s[5] or {}).get("rg")
        if s[0].startswith("rowgroup.") and s[0] != "rowgroup.latency":
            assert rg is not None, s[0]
            per_rg.setdefault(rg, {}).setdefault(s[0], []).append(s)
    for lat in latencies:
        rg = lat[5]["rg"]
        got = {name: [s for s in group if _within(s, lat)]
               for name, group in per_rg[rg].items()}
        assert len(got.get("rowgroup.merge", ())) == 1
        assert len(got.get("rowgroup.io_write", ())) == 1
        launched = len(got.get("rowgroup.launch", ()))
        assert launched + len(got.get("rowgroup.encode", ())) == 1
        assert len(got.get("rowgroup.assemble", ())) == launched
        assert got["rowgroup.io_write"][0][5]["rows"] == lat[5]["rows"] > 0
    assert len({lat[5]["rg"] for lat in latencies}) == len(latencies)


# ---------------------------------------------------------------------------
# tracing off costs nothing
# ---------------------------------------------------------------------------

class _NoClock(types.SimpleNamespace):
    def __getattr__(self, name):
        raise AssertionError(f"time.{name} read with nothing installed")


def test_nothing_installed_reads_no_clock_and_counts_nothing(monkeypatch):
    assert tracing.get_span_recorder() is None and tracing.get_tracer() is None
    monkeypatch.setattr(tracing, "time", _NoClock())
    seen = []
    real = port_device.transfer_counts

    def counts():
        seen.append(real())
        return seen[-1]

    monkeypatch.setattr(port_device, "transfer_counts", counts)
    with tracing.stage("worker.poll", records=0) as span:
        assert span is None
    tracing.record_span("rowgroup.latency", 1.0, 2.0, rg="0:0")
    with tracing.count_transfers(None):
        t = port_device.to_device(np.arange(8, dtype=np.int32), "cpu")
        (back,) = port_device.to_host([t])
    assert back.tolist() == list(range(8))

    # a CPU encode, pipelined, and a short writer
    schema = Schema([leaf("a", "int64"), leaf("b", "int32")])
    props = WriterProperties(row_group_size=1 << 14)
    buf = __import__("io").BytesIO()
    w = ParquetFileWriter(buf, schema, props, pipeline=True, encoder=CudaChunkEncoder(
        props.encoder_options(), min_device_rows=1, device="cpu"))
    rng = np.random.default_rng(3)
    flushed = sum(w.write_batch(columns_from_arrays(schema, {
        "a": rng.integers(0, 9, 3000), "b": rng.integers(0, 5, 3000).astype(np.int32)}))
        for _ in range(4))
    w.close()
    assert flushed == 12000

    cls = sample_message_class()
    broker = P.FakeBroker()
    broker.create_topic(TOPIC, 1)
    broker.produce_many(TOPIC, [cls(query=f"q{i}", timestamp=i).SerializeToString()
                                for i in range(600)])
    writer = (P.Builder().broker(broker).topic(TOPIC).proto_class(cls)
              .target_dir("/out").filesystem(P.MemoryFileSystem()).group_id("g")
              .encoder_backend("cuda", device="cpu").batch_size(64)
              .max_file_open_duration_seconds(0.2).build())
    writer.start()
    try:
        wait_until(lambda: broker.committed("g", TOPIC, 0) == 600, "every record acked")
    finally:
        writer.close(deadline=LIMIT_S)
    assert seen and all(c is None for c in seen)


def test_transfer_counts_belong_to_their_thread_and_block():
    counts = {}
    with tracing.count_transfers(counts):
        assert tracing.transfer_counts() is counts
        other = []
        t = threading.Thread(target=lambda: other.append(tracing.transfer_counts()))
        t.start()
        t.join()
        assert other == [None]
        with tracing.count_transfers(None):
            assert tracing.transfer_counts() is None
        assert tracing.transfer_counts() is counts
    assert tracing.transfer_counts() is None


# ---------------------------------------------------------------------------
# one clock
# ---------------------------------------------------------------------------

def test_spans_and_profiler_events_share_the_unix_clock():
    from torch.profiler import ProfilerActivity, profile

    rec = tracing.SpanRecorder()
    tracing.set_span_recorder(rec)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(9):
                with tracing.stage("worker.poll", records=0):
                    time.sleep(0.002)
    finally:
        tracing.set_span_recorder(None)
    ours = [rec.epoch_wall + s[3] for s in rec.snapshot()]
    theirs = sorted(e.start_ns() / 1e9 for e in prof.profiler.kineto_results.events()
                    if e.name() == "worker.poll")
    assert len(ours) == len(theirs) == 9
    offsets = [abs(a - b) for a, b in zip(ours, theirs)]
    assert statistics.median(offsets) < 1e-3, offsets


# ---------------------------------------------------------------------------
# the probe that splits a traced window (cycle_probe.py)
# ---------------------------------------------------------------------------

def test_cycle_probe_splits_a_traced_window():
    import cycle_probe

    spans, _ = _traced_run("pipelined")
    worker = next(s[2] for s in spans if s[0] == "worker.poll")
    finisher = next(s[2] for s in spans if s[0] == "worker.rotate")
    mine = [(n, t, d, a) for n, _, tid, t, d, a in spans
            if tid in (worker, finisher) or not n.startswith("worker.")]
    w0 = min(t for n, t, _, _ in mine if n == "worker.poll")
    w1 = max(t + d for n, t, d, _ in mine if n == "worker.rotate")
    split = cycle_probe.analyse(mine, w0, w1)
    assert split["files"] >= 3
    assert split["layout"] == "finisher"
    assert 0 < split["cover_share"] <= 1 + EPS
    assert 0 < split["finisher_share"] <= 1 + EPS
    assert split["per_file_ms"]["worker.rotate_wait"] >= 0
    assert split["uncovered_s"] == pytest.approx(sum(split["gaps_s"].values()), abs=1e-3)
    per_file = split["per_file_ms"]
    assert per_file["worker.close"] + per_file["worker.publish"] + per_file["worker.ack"] \
        <= per_file["worker.rotate"] + EPS
    assert split["rowgroups"] >= split["files"]
    mean = split["rowgroup_mean"]
    stages = ("wait_dispatch", "merge", "merge_to_launch", "launch", "wait_assemble",
              "assemble", "wait_io", "io_write", "tail")
    assert sum(mean[k] for k in stages) == pytest.approx(mean["latency"], abs=1e-6)
    assert 0 <= split["shred_cpu_share"]
    # a writer that predates ``cpu_ms`` records spans without attributes
    bare = cycle_probe.analyse([(n, t, d, None) for n, t, d, _ in mine], w0, w1)
    assert bare["cover_share"] == split["cover_share"] and bare["rowgroups"] == 0
    # a writer that predates the finisher rotates on the worker thread
    serial = cycle_probe.analyse([s for s in mine if s[0] != "worker.rotate_wait"], w0, w1)
    assert serial["layout"] == "serial" and serial["finisher_share"] is None
    assert serial["per_file_ms"]["worker.rotate"] == split["per_file_ms"]["worker.rotate"]
    # the sampler reads the writer's threads by group, the finisher apart
    assert cycle_probe._group("KafkaProtoParquetWriter-tr-0-finisher") == "finisher"
    assert cycle_probe._group("KafkaProtoParquetWriter-tr-0") == "worker"
