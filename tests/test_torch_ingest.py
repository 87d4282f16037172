"""The port's ingest layer (``kpw_tpu_torch.ingest``: ``FakeBroker``, the
paged offset tracker, ``SmartCommitConsumer``) against the JAX package's:
the same produce / poll / ack sequence, made from a seed, gives the same
partition placement, the same records and the same commits after every
ack, exactly."""

import time

import numpy as np
import pytest

import kpw_tpu.ingest as J
import kpw_tpu_torch.ingest as P


def produce(pkg, rng, n_parts=3):
    """A broker with keyed, unkeyed and bulk-produced records."""
    broker = pkg.FakeBroker()
    broker.create_topic("t", n_parts)
    for i in range(300):
        key = None if i % 3 else b"k%d" % (i % 7)
        broker.produce("t", b"v%d" % i, key=key)
    broker.produce_many("t", [rng.bytes(int(k)) for k in rng.integers(0, 40, 900)])
    return broker


@pytest.mark.parametrize("batch", [False, True], ids=["records", "batches"])
def test_broker_and_consumer_commit_like_jax(batch):
    """Produce, drain every record through the consumer, then ack runs in a
    seeded order: the log, the delivered records and the committed offsets
    after every ack are the JAX package's."""
    out = {}
    for name, pkg in (("port", P), ("jax", J)):
        broker = produce(pkg, np.random.default_rng(5))
        ends = [broker.end_offset("t", p) for p in range(3)]
        logs = [[(r.offset, r.key, r.value) for r in broker.fetch("t", p, 0, 10_000)]
                for p in range(3)]
        consumer = pkg.SmartCommitConsumer(
            broker, "g", page_size=64, max_open_pages_per_partition=64,
            fetch_max_records=37, batch_ingest=batch)
        consumer.subscribe("t")
        consumer.start()
        got: dict = {p: [] for p in range(3)}
        try:
            deadline = time.monotonic() + 30
            while sum(map(len, got.values())) < sum(ends):
                assert time.monotonic() < deadline, "consumer never drained"
                recs, runs = consumer.poll_many_runs(100)
                for r in recs:
                    got[r.partition].append((r.offset, r.value))
                if not recs:
                    time.sleep(0.002)
            # ack in runs of seeded lengths, in a seeded order
            rng = np.random.default_rng(9)
            runs = []
            for p in range(3):
                at = 0
                while at < ends[p]:
                    k = min(int(rng.integers(1, 90)), ends[p] - at)
                    runs.append((p, at, k))
                    at += k
            commits = []
            for i in rng.permutation(len(runs)):
                p, start, count = runs[i]
                consumer.ack_run(p, start, count)
                commits.append(tuple(broker.committed("g", "t", q) for q in range(3)))
        finally:
            consumer.close(timeout=10)
        out[name] = (ends, logs, {p: sorted(v) for p, v in got.items()}, commits)
    assert out["port"] == out["jax"]
    ends, logs, got, commits = out["port"]
    assert commits[-1] == tuple(ends)
    assert got == {p: [(o, v) for o, _, v in logs[p]] for p in range(3)}


def test_offset_tracker_like_jax():
    """The paged tracker's commit frontier after every track / ack / skip,
    and its backpressure, on a seeded sequence."""
    rng = np.random.default_rng(1)
    ops = []
    for _ in range(400):
        p = int(rng.integers(0, 2))
        start = int(rng.integers(0, 600))
        ops.append((["track_run", "ack_run", "skip_run"][int(rng.integers(0, 3))],
                    p, start, int(rng.integers(1, 40))))
    out = {}
    for name, pkg in (("port", P), ("jax", J)):
        t = pkg.PagedOffsetTracker(32, 4)
        seen = []
        delivered = {0: 0, 1: 0}
        for op, p, start, count in ops:
            if op in ("track_run", "skip_run"):  # in delivery order
                getattr(t, op)(p, delivered[p], count)
                delivered[p] += count
                seen.append(None)
            elif op == "ack_run":
                start = min(start, max(delivered[p] - 1, 0))
                count = max(0, min(count, delivered[p] - start))
                seen.append(t.ack_run(p, start, count) if count else None)
            seen.append((t.committed(p), t.is_backpressured(p), t.pending(p)))
        out[name] = (seen, t.snapshot())
    assert out["port"] == out["jax"]
