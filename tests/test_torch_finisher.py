"""The thread worker's finisher (``kpw_tpu_torch/runtime/writer.py``): a
size or time rotation hands the file to the worker's finisher thread, one
file deep, which closes, publishes and acks it while the worker polls and
shreds the next file.

- the overlap engages: the next file's shred starts inside the previous
  file's ``worker.rotate``, and the worker's ``worker.rotate_wait`` is
  shorter than a close that sleeps;
- order: every file's acks come after its own rename and before the next
  file's rename, files publish in offset order, and a held close ages in
  the heartbeat beside the worker's own IO;
- failure: a fatal ``OSError`` and a ``PipelineError`` raised in the
  finisher's close publish nothing of that file and ack nothing of it; the
  worker pauses (degraded mode) or dies and restarts (supervision), and
  after redelivery the published records equal the produced ones;
- ``close()`` returns only after the finishing file is published and acked;
- a revoke rotation finishes inline after the outstanding job; a
  lost-partition abandon during a finish drops the finishing file's fenced
  runs and redelivers the rest; the partitioned path never starts a
  finisher;
- the published files equal the JAX package's serial writer's, byte for
  byte.

No test sleeps a fixed time to wait for the writer: each polls for its
condition with a deadline.  The sinks' sleeps and gates stand for a slow
close.
"""

import collections
import errno
import io
import sys
import threading
import time

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

import kpw_tpu as J
import kpw_tpu_torch as P
from kpw_tpu_torch.core.writer import PipelineError
from kpw_tpu_torch.io.fs import _MemFile
from kpw_tpu_torch.runtime.retry import RetryPolicy
from proto_helpers import sample_message_class
from test_torch_runtime import _same_prefix, replay_class

torch.set_num_threads(1)

TOPIC = "t"
LIMIT_S = 30.0
EPS = 1e-6  # float rounding of span ends, in seconds


def wait_until(pred, what: str, limit: float = LIMIT_S):
    deadline = time.monotonic() + limit
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.002)
    raise AssertionError(f"not within {limit} s: {what}")


class _Sink(_MemFile):
    def __init__(self, fs, path, nth):
        super().__init__(fs, path)
        self.nth = nth

    def close(self):
        if not self.closed:
            self._fs.on_close(self.nth, self._path)
        super().close()


class RecordingFS(P.MemoryFileSystem):
    """A memory filesystem that numbers the tmp files it opens (1, 2, ...),
    can make their open sleep and their close sleep, block until released
    or raise, and logs every rename into ``events`` (shared with the
    consumer's acks)."""

    def __init__(self, events, delay_s=0.0, hold=(), fail=None, open_delay_s=0.0):
        super().__init__()
        self.events = events
        self.delay_s = delay_s
        self.open_delay_s = open_delay_s
        self.hold = set(hold)
        self.fail = dict(fail or {})  # nth -> exception to raise once
        self.entered = threading.Event()
        self.release = threading.Event()
        self.opened = 0
        self.failed_paths = []

    def open_write(self, path):
        if "/tmp/" not in path or "/.probe_" in path:
            return super().open_write(path)
        self.opened += 1
        if self.open_delay_s:
            time.sleep(self.open_delay_s)
        return _Sink(self, path, self.opened)

    def on_close(self, nth, path):
        if nth in self.hold:
            self.hold.discard(nth)
            self.entered.set()
            assert self.release.wait(LIMIT_S)
        if self.delay_s:
            time.sleep(self.delay_s)
        exc = self.fail.pop(nth, None)
        if exc is not None:
            self.failed_paths.append(path)
            raise exc

    def rename(self, src, dst):
        super().rename(src, dst)
        self.events.append(("rename", src, dst))


def record_acks(w, events):
    """Log the consumer's run acks into ``events``, in the order they land."""
    ack_run = w.consumer.ack_run

    def logged(partition, start, count):
        ack_run(partition, start, count)
        events.append(("ack", partition, start, count))

    w.consumer.ack_run = logged


def produce(broker, cls, n, parts=1):
    """Records ``i`` of timestamp ``i``, about 80 B each, on partition
    ``i % parts``; returns the timestamps of each partition in offset
    order."""
    noise = np.random.default_rng(13).bytes(32 * n).hex()
    by_part = collections.defaultdict(list)
    for i in range(n):
        by_part[i % parts].append(i)
    for p, ts in by_part.items():
        broker.produce_many(TOPIC, [cls(query=noise[64 * i:64 * i + 64],
                                        timestamp=i).SerializeToString()
                                    for i in ts], partition=p)
    return by_part


def builder(broker, fs, cls, **knobs):
    b = (P.Builder().broker(broker).topic(TOPIC).proto_class(cls)
         .target_dir("/out").filesystem(fs).instance_name("fin").group_id("g")
         .encoder_backend("cuda", device="cpu")
         .batch_size(64).fetch_max_records(256)
         .max_file_size(100 << 10).block_size(24 << 10)
         .max_file_open_duration_seconds(3600.0)
         .retry_policy(RetryPolicy(base_sleep=0.005, max_sleep=0.05)))
    for name, args in knobs.items():
        getattr(b, name)(**args) if isinstance(args, dict) else getattr(b, name)(args)
    return b


def published(fs):
    """{path: sorted timestamps} of every published file."""
    out = {}
    for f in fs.list_files("/out", extension=".parquet"):
        if "/tmp/" in f:
            continue
        out[f] = sorted(pq.read_table(io.BytesIO(fs.open_read(f).read()),
                                      columns=["timestamp"]).column(0).to_pylist())
    return out


def check_acks_follow_their_file(events, files, offsets_of):
    """Every ack lands after the rename of the file that holds its records
    and before the next rename; every published file is acked.  ``files``:
    the published files' timestamps by path; ``offsets_of(p, s, e)``: the
    timestamps of a run.  Returns the renames in order."""
    renames, current, acked = [], None, set()
    for ev in events:
        if ev[0] == "rename":
            if current is not None:
                assert current in acked, f"{current} published, never acked"
            current = ev[2]
            renames.append(ev)
        else:
            _, p, s, c = ev
            assert current is not None, f"ack {ev} before any publish"
            assert set(offsets_of(p, s, s + c)) <= set(files[current]), (ev, current)
            acked.add(current)
    assert current is None or current in acked
    return renames


def spans_of(w):
    by = collections.defaultdict(list)
    for s in w.span_recorder.snapshot():
        by[s[0]].append(s)
    return by


# ---------------------------------------------------------------------------
# the overlap
# ---------------------------------------------------------------------------

def test_next_file_shreds_while_the_previous_one_closes():
    cls = sample_message_class()
    broker = P.FakeBroker()
    broker.create_topic(TOPIC, 1)
    n = 8000
    produce(broker, cls, n)
    # the worker's own part of a file takes at least the open's sleep, which
    # the close's tail (footer, rename, acks) stays well under
    delay = 0.3
    fs = RecordingFS([], delay_s=delay, open_delay_s=0.1)
    w = builder(broker, fs, cls, tracing=True).build()
    w.start()
    try:
        wait_until(lambda: broker.committed("g", TOPIC, 0) >= n - 2000, "files acked")
    finally:
        w.close(deadline=LIMIT_S)
    by = spans_of(w)
    worker = by["worker.poll"][0][2]
    rotates = sorted(by["worker.rotate"], key=lambda s: s[3])
    assert len(rotates) >= 3
    assert all(r[2] != worker for r in rotates)
    shreds = sorted((s for s in by["worker.shred"] if s[2] == worker), key=lambda s: s[3])
    for r in rotates[:-1]:
        assert r[4] >= delay
        nxt = next(s for s in shreds if s[3] >= r[3])
        assert nxt[3] < r[3] + r[4], "the next file's shred waited for the close"
    waits = by["worker.rotate_wait"]
    assert len(waits) >= len(rotates) - 1
    assert all(s[2] == worker and s[4] < delay for s in waits), [s[4] for s in waits]


# ---------------------------------------------------------------------------
# order, and the heartbeat of a held close
# ---------------------------------------------------------------------------

def test_files_publish_and_ack_in_order_acks_after_their_rename():
    cls = sample_message_class()
    broker = P.FakeBroker()
    broker.create_topic(TOPIC, 1)
    n = 8000
    produce(broker, cls, n)
    events = []
    fs = RecordingFS(events, delay_s=0.02)
    w = builder(broker, fs, cls, max_file_open_duration_seconds=0.5).build()
    record_acks(w, events)
    w.start()
    try:
        wait_until(lambda: broker.committed("g", TOPIC, 0) == n
                   and w.ack_lag()["unacked_records"] == 0, "every record acked")
    finally:
        w.close(deadline=LIMIT_S)
    files = published(fs)
    renames = check_acks_follow_their_file(events, files, lambda p, s, e: range(s, e))
    assert len(renames) == len(files) >= 4
    # publish order is offset order, and together the files hold each record once
    order = [files[r[2]] for r in renames]
    assert all(a[-1] < b[0] for a, b in zip(order, order[1:]))
    assert sorted(t for ts in order for t in ts) == list(range(n))
    assert w._rotated_size.count + w._rotated_time.count == len(files)


def test_a_held_close_ages_beside_the_workers_own_io():
    """The finisher's close and the worker's IO publish into one heartbeat
    under their own threads: a close held on the finisher stays pending,
    and the watchdog flags it, while the worker opens the next file."""
    cls = sample_message_class()
    broker = P.FakeBroker()
    broker.create_topic(TOPIC, 1)
    produce(broker, cls, 2500)
    fs = RecordingFS([], hold={1})
    w = builder(broker, fs, cls, watchdog=dict(io_stall_deadline_seconds=0.2,
                                               poll_interval_seconds=0.02)).build()
    w.start()
    wk = w._workers[0]
    try:
        assert fs.entered.wait(LIMIT_S)
        wait_until(lambda: fs.opened >= 2 and w.total_written_records == 2500,
                   "the worker went on to the next file")
        wait_until(lambda: w.stats()["watchdog"]["stalled_workers"], "the stall flagged")
        assert w.stats()["watchdog"]["stalled_workers"][0]["label"] == "close"
        assert wk.heartbeat.stall()[1] == "close" and not w.healthy()
        assert wk.alive() and not wk.failed
        fs.release.set()
        wait_until(lambda: broker.committed("g", TOPIC, 0) > 0, "the held file acked")
        wait_until(lambda: not w.stats()["watchdog"]["stalled_workers"], "stall cleared")
    finally:
        fs.release.set()
        w.close(deadline=LIMIT_S)


# ---------------------------------------------------------------------------
# failure in the finisher's close
# ---------------------------------------------------------------------------

FAILURES = {
    # a fatal errno pauses the worker under degraded mode
    "oserror-pause": (lambda: OSError(errno.ENOSPC, "no space left (close)"),
                      dict(degraded_mode=dict(probe_interval_seconds=0.05,
                                              probe_backoff_max_seconds=0.2))),
    # a poisoned pipe of a non-fatal cause kills it; supervision restarts it
    "pipeline-death": (lambda: _pipeline_error(),
                       dict(supervise=dict(restart_backoff_seconds=0.01))),
}


def _pipeline_error():
    try:
        raise OSError(errno.EIO, "row-group write failed")
    except OSError as cause:
        try:
            raise PipelineError("row-group pipeline failed") from cause
        except PipelineError as e:
            return e


@pytest.mark.parametrize("kind", sorted(FAILURES))
def test_a_failed_finish_publishes_and_acks_nothing_then_redelivers(kind):
    make_exc, knobs = FAILURES[kind]
    cls = sample_message_class()
    broker = P.FakeBroker()
    broker.create_topic(TOPIC, 1)
    n = 6000
    produce(broker, cls, n)
    events = []
    fs = RecordingFS(events, fail={1: make_exc()})
    w = builder(broker, fs, cls, max_file_open_duration_seconds=0.5, **knobs).build()
    record_acks(w, events)
    w.start()
    try:
        wait_until(lambda: broker.committed("g", TOPIC, 0) == n
                   and w.ack_lag()["unacked_records"] == 0, "every record acked")
        st = w.stats()
    finally:
        w.close(deadline=LIMIT_S)
    assert len(fs.failed_paths) == 1
    files = published(fs)
    renames = check_acks_follow_their_file(events, files, lambda p, s, e: range(s, e))
    assert fs.failed_paths[0] not in {r[1] for r in renames}
    assert events[0][0] == "rename"  # nothing acked before a file published
    got = collections.Counter(t for ts in files.values() for t in ts)
    assert got == collections.Counter(range(n))
    if kind == "oserror-pause":
        assert (st["degraded"]["pause_count"], st["degraded"]["resume_count"]) == (1, 1)
        assert st["supervision"]["restarts_total"] == 0
    else:
        assert st["supervision"]["restarts_total"] == 1
        assert st["degraded"]["pause_count"] == 0


# ---------------------------------------------------------------------------
# close
# ---------------------------------------------------------------------------

def test_close_returns_after_the_finishing_file_is_published_and_acked():
    cls = sample_message_class()
    broker = P.FakeBroker()
    broker.create_topic(TOPIC, 1)
    n = 2000
    produce(broker, cls, n)
    events = []
    fs = RecordingFS(events, hold={1})
    w = builder(broker, fs, cls).build()
    record_acks(w, events)
    w.start()
    try:
        assert fs.entered.wait(LIMIT_S)
        wait_until(lambda: w.total_written_records == n, "the rest written")
    finally:
        held = 0.3
        threading.Timer(held, fs.release.set).start()
        t0 = time.monotonic()
        report = w.close()
        took = time.monotonic() - t0
    assert took >= held - 0.05
    files = published(fs)
    assert len(files) == 1
    (path, ts), = files.items()
    assert broker.committed("g", TOPIC, 0) == len(ts) == ts[-1] + 1
    check_acks_follow_their_file(events, files, lambda p, s, e: range(s, e))
    # the open file is abandoned, as before: its records stay unacked
    assert report["abandoned_unacked_records"] == n - len(ts) > 0
    assert not w._workers[0]._finisher.is_alive()


# ---------------------------------------------------------------------------
# revoke, abandon, and the partitioned path
# ---------------------------------------------------------------------------

def test_a_revoke_rotation_finishes_inline_after_the_outstanding_job():
    cls = sample_message_class()
    broker = P.FakeBroker()
    broker.create_topic(TOPIC, 1)
    n = 2000
    produce(broker, cls, n)
    fs = RecordingFS([], hold={1})
    w = builder(broker, fs, cls, tracing=True).build()
    w.start()
    wk = w._workers[0]
    try:
        assert fs.entered.wait(LIMIT_S)
        wait_until(lambda: w.total_written_records == n, "the rest written")
        wk.request_fence(frozenset({0}))
        wait_until(lambda: any(s[0] == "worker.rotate_wait"
                               for s in w.span_recorder.snapshot())
                   or wk._finishing is not None and wk.heartbeat.stall()[1] == "close",
                   "the revoke waits")
        fs.release.set()
        wait_until(lambda: broker.committed("g", TOPIC, 0) == n, "both files acked")
        wk.fence_clear({0})
    finally:
        fs.release.set()
        w.close(deadline=LIMIT_S)
    assert w._rotated_revoke.count == 1
    by = spans_of(w)
    worker = by["worker.poll"][0][2]
    first = next(r for r in by["worker.rotate"] if r[5]["file"] == 1)
    revoke = next(r for r in by["worker.rotate"] if r[5]["reason"] == "revoke")
    assert first[2] != worker and revoke[2] == worker and revoke[5]["file"] == 2
    assert first[3] + first[4] <= revoke[3] + EPS
    wait = next(s for s in by["worker.rotate_wait"] if s[5]["file"] == 1)
    assert wait[3] + wait[4] <= revoke[3] + EPS and wait[2] == worker


def test_a_lost_partition_abandon_drops_the_finishing_files_fenced_runs():
    cls = sample_message_class()
    broker = P.FakeBroker()
    broker.create_topic(TOPIC, 2)
    n = 2000  # under two files: the second never fills, so the worker stays free
    by_part = produce(broker, cls, n, parts=2)
    events = []
    fs = RecordingFS(events, hold={1})
    w = builder(broker, fs, cls, max_file_open_duration_seconds=0.5).build()
    w.start()
    wk = w._workers[0]
    try:
        assert fs.entered.wait(LIMIT_S)
        job = wk._finishing
        runs = [tuple(r) for r in job.runs]
        assert {p for p, _, _ in runs} == {0, 1}
        assert set(wk.held_runs()) >= set(runs)
        wk.request_abandon(frozenset({0}))
        wait_until(lambda: wk._fence_abandon_req is None, "the abandon serviced")
        assert job.fate == "abandon"
        fs.release.set()
        wait_until(lambda: broker.committed("g", TOPIC, 1) == len(by_part[1])
                   and w.ack_lag()["unacked_records"] == 0,
                   "partition 1 redelivered and acked")
    finally:
        fs.release.set()
        w.close(deadline=LIMIT_S)
    assert w._fence_abandons.count >= 1
    assert broker.committed("g", TOPIC, 0) == 0  # its dropped runs hold the frontier
    assert job.path not in {e[1] for e in events}  # never published
    got = collections.Counter(t for ts in published(fs).values() for t in ts)
    dropped = {by_part[0][o] for p, s, e in runs if p == 0 for o in range(s, e)}
    assert not dropped & set(got)
    assert all(got[t] == 1 for t in by_part[1])


def test_the_partitioned_path_finishes_on_the_worker_thread():
    cls = sample_message_class()
    broker = P.FakeBroker()
    broker.create_topic(TOPIC, 1)
    n = 4000
    produce(broker, cls, n)
    fs = RecordingFS([])
    w = builder(broker, fs, cls, tracing=True, max_file_open_duration_seconds=0.5,
                partition_by=dict(spec=lambda rec, msg: f"k={msg.timestamp % 2}",
                                  max_open_partitions=2)).build()
    w.start()
    try:
        wait_until(lambda: broker.committed("g", TOPIC, 0) == n
                   and w.ack_lag()["unacked_records"] == 0, "every record acked")
    finally:
        w.close(deadline=LIMIT_S)
    assert w._workers[0]._finisher is None
    by = spans_of(w)
    assert len(by["worker.publish"]) >= 4 and not by["worker.rotate_wait"]
    assert {s[1] for s in by["worker.publish"]} == {w._workers[0]._thread.name}
    got = collections.Counter(t for ts in published(fs).values() for t in ts)
    assert got == collections.Counter(range(n))


def test_many_workers_and_finishers_under_a_short_switch_interval():
    """More worker threads (each with its finisher) than cores, switching
    threads every 10 us: every record publishes once and is acked, and
    every file any worker opened is folded into its pipeline totals once."""
    cls = sample_message_class()
    broker = P.FakeBroker()
    broker.create_topic(TOPIC, 16)
    n = 24_000
    produce(broker, cls, n, parts=16)
    fs = RecordingFS([])
    w = builder(broker, fs, cls, thread_count=12,
                max_file_open_duration_seconds=0.5).build()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        w.start()
        try:
            wait_until(lambda: sum(broker.committed("g", TOPIC, p) for p in range(16)) == n
                       and w.ack_lag()["unacked_records"] == 0, "every record acked")
        finally:
            w.close(deadline=LIMIT_S)
    finally:
        sys.setswitchinterval(interval)
    got = collections.Counter(t for ts in published(fs).values() for t in ts)
    assert got == collections.Counter(range(n))
    assert sum(wk._pipe_totals["files"] for wk in w._workers) == fs.opened
    assert all(wk._finisher is None or not wk._finisher.is_alive() for wk in w._workers)


# ---------------------------------------------------------------------------
# the same bytes as the serial writer
# ---------------------------------------------------------------------------

def _deterministic(pkg, payloads, trace):
    broker = pkg.FakeBroker()
    broker.create_topic("det", 1)
    broker.produce_many("det", payloads)
    fs = pkg.MemoryFileSystem()
    size = 256 * 1024
    b = (pkg.Builder().broker(broker).topic("det").proto_class(replay_class())
         .target_dir("/det").filesystem(fs).instance_name("det").group_id("det")
         .thread_count(1).compression("snappy").autotune(False).batch_ingest(True)
         .max_file_size(size).block_size(size // 2)
         .max_file_open_duration_seconds(3600.0)
         .pipeline(False).batch_size(64).fetch_max_records(2048).tracing(trace))
    b.encoder_backend("cuda", device="cpu") if pkg is P else b.encoder_backend("cpu")
    w = b.build()
    w.start()
    try:
        wait_until(lambda: w.total_written_records >= len(payloads), "all written")
        files = sorted(fs.list_files("/det", extension=".parquet"))
        wait_until(lambda: broker.committed("det", "det", 0) == sum(
            pq.read_metadata(io.BytesIO(fs.open_read(f).read())).num_rows for f in files),
            "the published files acked")
    finally:
        w.close(deadline=LIMIT_S)
    files = sorted(fs.list_files("/det", extension=".parquet"))
    return [fs.open_read(f).read() for f in files], w


def test_published_bytes_equal_the_serial_writers():
    import chip_smoke

    payloads = chip_smoke.replay_payloads(20_000)
    got, w = _deterministic(P, payloads, True)
    want, _ = _deterministic(J, payloads, False)
    assert _same_prefix(got, want), ([len(f) for f in got], [len(f) for f in want])
    by = spans_of(w)
    worker = by["worker.poll"][0][2]
    assert len(by["worker.rotate"]) >= 2
    assert all(r[2] != worker and r[5]["reason"] == "size" for r in by["worker.rotate"])
