"""One run of one cell: set-up, warm-up, the measured window, the read-back.

The system under test is the port's public API: a ``Builder`` built from
the configuration's file with the ``"cuda"`` encoder, over the port's own
``FakeBroker`` with its topic served from the record pool (``broker.py``)
and a ``LocalFileSystem`` directory under ``TMPDIR``.  The load generator
produces into the broker from its own thread.  Warm-up runs the writer
until each worker thread has published a file, and at least the traffic
file's ``warmup_s`` seconds of load; the window then lasts ``seconds``.  With ``trace``, the writer records its spans and the PyTorch
profiler records the device's operations over the window.  After the
window the writer is closed, and the reference (``reference/check.py``)
reads every published file back.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import time

import numpy as np

from . import broker as broker_mod
from . import host as host_mod
from . import load as load_mod
from .reference import check as ref_check

TOPIC, GROUP, INSTANCE = "kpwbench", "kpwbench", "kpwbench"
GRACE_S = 60.0        # an open-loop record not committed this long after the window has failed
WARMUP_LIMIT_S = 600.0


class Run:
    """What a metric reader reads: the window, the commits, and with
    ``trace`` the spans and the device's operations, all on the
    ``time.perf_counter`` clock."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool) -> None:
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.config, self.traffic = cell.config, cell.traffic
        self.t_start = None
        self.w0 = self.w1 = None
        self.commits = []       # (time, partition, next offset)
        self.spans = []         # (name, start, duration, attrs)
        self.device_ops = []    # (name, start, duration)
        self.files = []         # (path, bytes) of every published file
        self.load = None
        self.t_end = None     # when the wait for the window's commits ended
        self.host = None      # the host's facts over the window (host.py)

    # -- helpers for metric readers -----------------------------------------
    def bursts(self, gap_s: float = 0.02) -> list:
        """Commits grouped into bursts (a file's acks come together):
        (time of the burst's last commit, total committed after it)."""
        parts = self.cell.config["partitions"]
        front = [0] * parts
        out, last = [], None
        for t, p, off in self.commits:
            front[p] = max(front[p], off)
            if last is not None and t - last <= gap_s and out:
                out[-1] = (t, sum(front))
            else:
                out.append((t, sum(front)))
            last = t
        return out

    def committed_at(self, t: float) -> int:
        parts = self.cell.config["partitions"]
        front = [0] * parts
        for tc, p, off in self.commits:
            if tc > t:
                break
            front[p] = max(front[p], off)
        return sum(front)

    def committed_in_window(self) -> int:
        return self.committed_at(self.w1) - self.committed_at(self.w0)

    def window_spans(self, *names) -> list:
        return [s for s in self.spans
                if s[0] in names and self.w0 <= s[1] and s[1] + s[2] <= self.w1]

    def commit_times(self, parts: np.ndarray, offsets: np.ndarray) -> np.ndarray:
        """The time at which each record (partition, offset) was committed;
        inf where it was not."""
        out = np.full(len(offsets), np.inf)
        for p in np.unique(parts).tolist():
            log = [(t, off) for t, q, off in self.commits if q == p]
            if not log:
                continue
            ts = np.array([t for t, _ in log])
            offs = np.maximum.accumulate(np.array([o for _, o in log]))
            sel = parts == p
            at = np.searchsorted(offs, offsets[sel], side="right")
            got = at < len(offs)
            t_sel = np.full(int(sel.sum()), np.inf)
            t_sel[got] = ts[at[got]]
            out[sel] = t_sel
        return out


def build_writer(config: dict, broker, target: str, msg, device: str, trace: bool):
    from kpw_tpu_torch import Builder, LocalFileSystem

    b = (Builder().broker(broker).topic(TOPIC).proto_class(msg)
         .target_dir(target).filesystem(LocalFileSystem())
         .instance_name(INSTANCE).group_id(GROUP)
         .thread_count(config["thread_count"])
         .encoder_backend(config["encoder_backend"], device=device)
         .compression(config["compression"])
         .enable_dictionary(config["enable_dictionary"])
         .block_size(config["block_size"])
         .max_file_size(config["max_file_size"])
         .max_file_open_duration_seconds(config["max_file_open_duration_seconds"]))
    if trace:
        b.tracing(True, span_capacity=1 << 20)
    return b.build()


def _published(target: str) -> list:
    return sorted(os.path.join(target, f) for f in os.listdir(target)
                  if f.endswith(".parquet"))


def _workers_published(target: str, threads: int) -> bool:
    seen = {os.path.splitext(f)[0].rsplit("_", 1)[-1] for f in os.listdir(target)
            if f.endswith(".parquet")}
    return len(seen) >= threads


class _Spans:
    """Moves the writer's spans out of its bounded ring into the run, on
    the perf_counter clock."""

    def __init__(self, writer, run: Run) -> None:
        self.w, self.run = writer, run

    def drain(self) -> None:
        rec = self.w.span_recorder
        if rec is None:
            return
        shift = time.perf_counter() - rec.now()
        self.run.spans += [(name, start + shift, dur, attrs)
                           for name, _, _, start, dur, attrs in rec.drain()]


def _device_events(prof) -> list:
    """The profiler's device operations (kernels, copies, memsets) on the
    perf_counter clock: (name, start, duration)."""
    from torch.autograd import DeviceType

    shift = time.time() - time.perf_counter()
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        out.append((e.name(), e.start_ns() / 1e9 - shift, e.duration_ns() / 1e9))
    out.sort(key=lambda x: x[1])
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None, fault=None, log=print,
             stats: dict | None = None) -> dict:
    """One run; returns the result line's object.  ``fault``, for the
    harness's own tests and the control (``faults.py``), is called with the
    writer before it starts, with the target directory after it closes, and
    at the end.  ``stats``, when given, receives the consumer's lag at the
    window's start and end and the file count."""
    import torch

    run = Run(cell, seed, seconds, trace)
    run.t_start = time.perf_counter() if t_start is None else t_start
    marks = [("imports", time.perf_counter())]
    config = cell.config
    pool = cell.generator.make_pool(config, seed)
    marks.append(("pool", time.perf_counter()))
    broker = broker_mod.make(pool, TOPIC)
    broker.create_topic(TOPIC, config["partitions"])
    run.commits = broker.commit_log
    lg = load_mod.Load(cell.traffic, broker, TOPIC, GROUP, pool)
    run.load = lg
    lg.prime()
    marks.append(("backlog", time.perf_counter()))
    target = tempfile.mkdtemp(prefix="kpwbench-")
    prof = w = None
    try:
        w = build_writer(config, broker, target, cell.generator.message(config),
                         device, trace)
        if fault is not None:
            fault("writer", w)
        spans = _Spans(w, run)
        on_card = device != "cpu"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        marks.append(("writer built", time.perf_counter()))
        w.start()
        lg.start()
        marks.append(("writer started", time.perf_counter()))
        t_load = time.perf_counter()
        t_limit = t_load + WARMUP_LIMIT_S
        steady = t_load + cell.traffic.get("warmup_s", 0.0)
        while (not _workers_published(target, config["thread_count"])
               or time.perf_counter() < steady):
            if time.perf_counter() > t_limit or lg.error or not w.healthy():
                raise RuntimeError(f"warm-up: no file from every worker "
                                   f"(load error {lg.error}, healthy {w.healthy()})")
            spans.drain()
            time.sleep(0.01)
        spans.drain()
        if trace and on_card:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        run.w0 = time.perf_counter()
        h0 = host_mod.snapshot()
        marks.append(("first files", run.w0))
        log("[setup] " + ", ".join(f"{name} {t - run.t_start:.3f} s" for name, t in marks))
        lag0 = _consumer_lag(broker, lg)
        while (left := run.w0 + seconds - time.perf_counter()) > 0:
            time.sleep(left)
        run.w1 = time.perf_counter()
        run.host = host_mod.delta(h0, host_mod.snapshot())
        lg.stop_at = run.w1
        if prof is not None:
            prof.__exit__(None, None, None)
        lag1 = _consumer_lag(broker, lg)
        lg.stop()
        if lg.mode == "open_loop":
            _await_commits(broker, lg, run)
        run.t_end = time.perf_counter()
        spans.drain()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        w.close()
        w = None  # closed; its spans are still drained through ``spans``
        spans.drain()
        if prof is not None:
            run.device_ops = _device_events(prof)
            prof = None
        if lg.error:
            raise RuntimeError(f"load generator failed: {lg.error}")
        if fault is not None:
            fault("closed", target)
        paths = _published(target)
        run.files = [(p, os.path.getsize(p)) for p in paths]
        committed = [broker.committed(GROUP, TOPIC, p) for p in range(config["partitions"])]
        log(f"[run] window {run.w0 - run.t_start:.3f}..{run.w1 - run.t_start:.3f} s; "
            f"files {len(paths)}; committed {sum(committed)}; produced {sum(lg.ends)}; "
            f"consumer lag at window start {lag0}, at end {lag1}; load generator "
            f"cpu {lg.cpu_s:.3f} s, max lag {lg.max_lag_s * 1e3:.3f} ms")
        log("[host] " + json.dumps(run.host))
        log("[bursts] " + json.dumps([[round(t - run.w0, 6), n] for t, n in run.bursts()
                                      if run.w0 <= t <= run.w1]))
        if stats is not None:
            stats.update(lag_start=lag0, lag_end=lag1, files=len(paths))
        t_ref = time.perf_counter()
        checks = ref_check.compare(paths, pool, committed, list(lg.ends), config, seed)
        log(f"[run] read-back {time.perf_counter() - t_ref:.3f} s, rows read "
            f"{checks['rows_read']}")
        return _result(run, checks, peak, on_card)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        if w is not None:  # a run that failed: stop the writer's threads
            with contextlib.suppress(Exception):  # the first error is the one raised
                w.close(deadline=30)
        lg.stop()
        if fault is not None:
            fault("end", None)
        shutil.rmtree(target, ignore_errors=True)


def _consumer_lag(broker, lg) -> int:
    return sum(lg.ends[p] - broker.committed(GROUP, TOPIC, p) for p in range(lg.parts))


def _await_commits(broker, lg, run: Run) -> None:
    """Wait, at most ``GRACE_S``, until every record due in the window is
    committed."""
    parts, offs, _ = lg.due(run.w0, run.w1)
    need = [0] * lg.parts
    for p in range(lg.parts):
        sel = offs[parts == p]
        need[p] = int(sel.max()) + 1 if len(sel) else 0
    deadline = time.perf_counter() + GRACE_S
    while time.perf_counter() < deadline:
        if all(broker.committed(GROUP, TOPIC, p) >= need[p] for p in range(lg.parts)):
            return
        time.sleep(0.005)


def _result(run: Run, checks: dict, peak: int, on_card: bool) -> dict:
    import torch

    cell = run.cell
    metrics = {}
    readers = cell.readers
    for m in (cell.per_layer if run.trace else cell.end_to_end):
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct = all(checks[k] <= lim for k, lim in ref_check.LIMITS.items())
    if run.load.mode == "open_loop":
        parts, offs, due = run.load.due(run.w0, run.w1)
        attempted = int(len(offs))
        failed = int(np.isinf(run.commit_times(parts, offs)).sum())
    else:
        attempted, failed = run.committed_in_window(), 0
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if run.trace:
        from .breakdown import busy, breakdown

        device["busy_s"] = busy(run)
        device["window_s"] = run.w1 - run.w0
        out["breakdown"] = breakdown(run)
    out["checks"] = {k: {"value": checks[k], "limit": lim}
                     for k, lim in ref_check.LIMITS.items()}
    return out
