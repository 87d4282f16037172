"""Where a thread worker's time goes: its file cycle and a row group's path,
split from the spans of traced ``kpwbench`` runs, beside the CPU time of the
writer's threads, traced and untraced.

    python3 cycle_probe.py --seeds 11,12,13 --trace 1,1,0 --seconds 45 \\
        --out chiprun_out/cycle.json
    python3 cycle_probe.py --seeds 1 --trace 1 --seconds 2 --cpu --out /tmp/c.json

Each run is ``kpwbench.harness.run_cell`` of the cell (``taxi64.catchup`` by
default; ``--cpu`` runs its tiny version on the CPU) in this process.  A
sampler thread reads the CPU clocks of the writer's threads every 20 ms, by
kernel thread id.  The split assumes one thread worker, since the harness
keeps no thread with a span.  Where the window holds ``worker.rotate_wait``
spans, the worker hands each file to its finisher thread: the worker's
cycle is then poll, shred, append, handoff and the wait, and
``worker.rotate`` (close, publish, ack) is the finisher's, reported on its
own; without them ``worker.rotate`` is part of the worker's cycle, as in a
writer that predates the finisher.  It reads spans without attributes too,
as a writer that predates ``cpu_ms`` records them.  ``--micro`` first times
the span seam's clocks and an empty span on this host.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

# the worker thread's top-level spans: they follow each other on its thread
CYCLE = ("worker.poll", "worker.shred", "worker.append", "worker.handoff")
ROTATE_PARTS = ("worker.close", "worker.publish", "worker.ack")
THREADS = {"worker": "KafkaProtoParquetWriter-", "fetcher": "smart-consumer-",
           "encode": "kpw-rg-encode", "assemble": "kpw-rg-assemble", "io": "kpw-rg-io"}
GROUPS = ("worker", "finisher", *list(THREADS)[1:])


def _group(name: str) -> str | None:
    """The thread group of a thread's name: the worker's finisher thread is
    named after the worker, with ``-finisher`` at the end."""
    g = next((g for g, p in THREADS.items() if name.startswith(p)), None)
    return "finisher" if g == "worker" and name.endswith("-finisher") else g


def _clip(start: float, dur: float, w0: float, w1: float) -> float:
    return max(0.0, min(start + dur, w1) - max(start, w0))


def _rowgroup(d: dict) -> dict | None:
    """A row group's latency split into its stages and the waits between
    them, in seconds, with the launch span's device counters."""
    lat, m, io = (d.get(n) for n in ("rowgroup.latency", "rowgroup.merge",
                                     "rowgroup.io_write"))
    la = d.get("rowgroup.launch") or d.get("rowgroup.encode")
    a = d.get("rowgroup.assemble")
    if None in (lat, m, la, io):
        return None
    end = lambda s: s[1] + s[2]  # noqa: E731
    last = a or la
    out = {"latency": lat[2], "wait_dispatch": m[1] - lat[1], "merge": m[2],
           "merge_to_launch": la[1] - end(m), "launch": la[2],
           "assemble": a[2] if a else 0.0,
           "wait_assemble": a[1] - end(la) if a else 0.0,
           "wait_io": io[1] - end(last), "io_write": io[2], "tail": end(lat) - end(io)}
    for name, s in (("merge", m), ("launch", la), ("assemble", a), ("io_write", io)):
        if s is not None and "cpu_ms" in s[3]:
            out[f"{name}_cpu"] = s[3]["cpu_ms"] / 1e3
    for k in ("h2d_bytes", "h2d_pinned_bytes", "d2h_bytes", "d2h_pinned_bytes",
              "device_ms"):
        if k in la[3]:
            out[k] = la[3][k]
    return out


def analyse(spans: list, w0: float, w1: float) -> dict:
    """The split of a traced window [w0, w1] from its spans, each
    (name, start, duration, attrs) on one clock."""
    win = w1 - w0
    sp = [(n, t, d, a or {}) for n, t, d, a in spans if t < w1 and t + d > w0]
    inside = [s for s in sp if w0 <= s[1] and s[1] + s[2] <= w1]
    by: dict = {}
    for s in inside:
        by.setdefault(s[0], []).append(s)
    rotates = by.get("worker.rotate", [])
    files = max(len(rotates), 1)
    finisher = any(s[0] == "worker.rotate_wait" for s in sp)
    top_names = CYCLE + (("worker.rotate_wait",) if finisher else ("worker.rotate",))
    top = {n: sum(_clip(s[1], s[2], w0, w1) for s in sp if s[0] == n) for n in top_names}
    covered = sum(top.values())
    gaps: dict = {}
    seq = sorted((s for s in sp if s[0] in top_names), key=lambda s: s[1])
    for x, y in zip(seq, seq[1:]):
        g = min(y[1], w1) - max(x[1] + x[2], w0)
        if g > 0:
            gaps[f"{x[0]}->{y[0]}"] = gaps.get(f"{x[0]}->{y[0]}", 0.0) + g
    per_file = {n: v / files * 1e3 for n, v in top.items()}
    per_file["uncovered"] = (win - covered) / files * 1e3
    rotate_s = sum(_clip(s[1], s[2], w0, w1) for s in sp if s[0] == "worker.rotate")
    per_file["worker.rotate"] = rotate_s / files * 1e3
    in_rotate = lambda s: any(r[1] <= s[1] <= r[1] + r[2] for r in rotates)  # noqa: E731
    for n in ROTATE_PARTS:
        per_file[n] = sum(s[2] for s in by.get(n, []) if in_rotate(s)) / files * 1e3
    cpu: dict = {}
    for s in inside:
        if "cpu_ms" in s[3]:
            c = cpu.setdefault(s[0], {"wall_ms": 0.0, "cpu_ms": 0.0, "spans": 0})
            c["wall_ms"] += s[2] * 1e3
            c["cpu_ms"] += s[3]["cpu_ms"]
            c["spans"] += 1
    shred = cpu.get("worker.shred")
    groups: dict = {}
    for s in sp:
        if "rg" in s[3]:
            groups.setdefault(s[3]["rg"], {})[s[0]] = s
    parts = [p for d in groups.values()
             if (lat := d.get("rowgroup.latency")) is not None
             and w0 <= lat[1] and lat[1] + lat[2] <= w1
             and (p := _rowgroup(d)) is not None]
    out = {"window_s": win, "files": len(rotates),
           "layout": "finisher" if finisher else "serial",
           # the worker thread's cycle, and the finisher thread's busy share
           "cover_share": covered / win,
           "finisher_share": rotate_s / win if finisher else None,
           "uncovered_s": win - covered,
           "gaps_s": dict(sorted(gaps.items(), key=lambda kv: -kv[1])),
           "per_file_ms": per_file,
           "shred_cpu_share": 100 * shred["cpu_ms"] / shred["wall_ms"] if shred else None,
           "cpu_by_span": cpu, "rowgroups": len(parts)}
    if parts:
        keys = sorted({k for p in parts for k in p})
        out["rowgroup_mean"] = {k: statistics.fmean(p[k] for p in parts if k in p)
                                for k in keys}
        out["rowgroup_min"] = {k: min(p[k] for p in parts if k in p) for k in keys}
        out["rowgroup_max"] = {k: max(p[k] for p in parts if k in p) for k in keys}
    return out


class Sampler(threading.Thread):
    """Sums the CPU clocks of the writer's threads, by group, every 20 ms.
    A thread's clock is read by its kernel thread id, the clock id that
    ``pthread_getcpuclockid`` gives: a thread that has just ended reads
    EINVAL, where its pthread handle could no longer be dereferenced."""

    def __init__(self) -> None:
        super().__init__(daemon=True)
        self.stop = threading.Event()
        self.last: dict = {}  # kernel thread id -> CPU seconds
        self.total = dict.fromkeys(GROUPS, 0.0)
        self.samples: list = []  # (perf_counter, {group: cpu_s})

    def run(self) -> None:
        while not self.stop.is_set():
            for t in threading.enumerate():
                g, tid = _group(t.name), t.native_id
                if g is None or tid is None:
                    continue
                try:
                    c = time.clock_gettime((~tid << 3) | 6)
                except OSError:
                    continue
                self.total[g] += c - self.last.get(tid, 0.0)
                self.last[tid] = c
            self.samples.append((time.perf_counter(), dict(self.total)))
            time.sleep(0.02)

    def at(self, t: float) -> dict | None:
        for (t0, a), (t1, b) in zip(self.samples, self.samples[1:]):
            if t0 <= t <= t1:
                f = (t - t0) / (t1 - t0) if t1 > t0 else 0.0
                return {g: a[g] + f * (b[g] - a[g]) for g in GROUPS}
        return None


def seam_costs(n: int = 20000) -> dict:
    """Microseconds a call: the seam's clocks, the profiler annotation, and
    an empty span with nothing installed and with a recorder."""
    import torch

    from kpw_tpu_torch.utils import tracing

    def per_call(fn):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    def empty_span():
        with tracing.stage("worker.poll", records=0):
            pass

    def annotation():
        with torch.profiler.record_function("x"):
            pass

    out = {"thread_time_ns": per_call(time.thread_time_ns),
           "perf_counter": per_call(time.perf_counter),
           "record_function": per_call(annotation), "span_off": per_call(empty_span)}
    tracing.set_span_recorder(tracing.SpanRecorder(capacity=1 << 20))
    try:
        out["span_on"] = per_call(empty_span)
    finally:
        tracing.set_span_recorder(None)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", required=True, help="comma-separated, one run each")
    ap.add_argument("--trace", required=True, help="comma-separated 0/1, one a run")
    ap.add_argument("--seconds", type=float, default=45)
    ap.add_argument("--workload", default="taxi64.catchup")
    ap.add_argument("--out", required=True)
    ap.add_argument("--cpu", action="store_true", help="the cell's tiny version, on the CPU")
    ap.add_argument("--micro", action="store_true", help="time the span seam first")
    a = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    from kpwbench import harness, spec

    cell, device = spec.load(a.workload), "cuda"
    if a.cpu:
        from kpwbench.tests.test_kpwbench_harness import tiny
        cell, device = tiny(a.workload), "cpu"
    rate = spec._module("metrics", "ack.records_per_s", spec.PACKAGE)
    # the harness hands its Run, spans and window included, only to _result
    captured: dict = {}
    result = harness._result

    def keep_run(run, *args, **kwargs):
        captured["run"] = run
        return result(run, *args, **kwargs)

    harness._result = keep_run
    card = "cpu" if a.cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    report = {"card": card, "runs": []}
    if a.micro:
        report["seam_us"] = seam_costs()
        print("[probe] seam_us", json.dumps(report["seam_us"]), flush=True)
    for seed, trace in zip(map(int, a.seeds.split(",")), map(int, a.trace.split(","))):
        sampler = Sampler()

        def start_sampler(stage, obj):
            if stage == "writer":
                sampler.start()

        res = harness.run_cell(cell, seed, a.seconds, bool(trace), device=device,
                               t_start=time.perf_counter(), fault=start_sampler,
                               log=lambda m: print(m, flush=True))
        run = captured.pop("run")
        sampler.stop.set()
        sampler.join()
        c0, c1 = sampler.at(run.w0), sampler.at(run.w1)
        committed = run.committed_in_window()
        row = {"seed": seed, "trace": trace, "correct": res["correct"],
               "committed": committed, "records_per_s": rate.read(run),
               "metrics": res["metrics"],
               "cpu_s": {g: c1[g] - c0[g] for g in GROUPS} if c0 and c1 else None}
        if row["cpu_s"]:
            row["worker_cpu_us_per_record"] = row["cpu_s"]["worker"] / committed * 1e6
        if trace:
            row["cycle"] = analyse(run.spans, run.w0, run.w1)
            row["busy_s"] = res["device"].get("busy_s")
        report["runs"].append(row)
        print("[probe]", json.dumps({k: row.get(k) for k in (
            "seed", "trace", "correct", "records_per_s", "worker_cpu_us_per_record")}
            | ({"cover_share": row["cycle"]["cover_share"]} if trace else {})), flush=True)
        with open(a.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
    sys.stdout.flush()
    os._exit(0)  # the writer's daemon threads and the CUDA context: no slow teardown
