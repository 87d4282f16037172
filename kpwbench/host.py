"""The host's facts over a run's window, from the process's own view.

``snapshot()`` reads, and changes nothing: the machine's steal, iowait
and busy jiffies (``/proc/stat``), the process's context switches and CPU
time (``resource.getrusage``), the mean ``cpu MHz`` over the cores
(``/proc/cpuinfo``), ``Dirty`` and ``Writeback`` (``/proc/meminfo``), the
load average, the process's CPU affinity, and for the writer's threads,
grouped by the thread name's prefix, their CPU time (each thread's own
clock), time runnable but waiting for a core, involuntary switches and
migrations between cores (``/proc/self/task/<tid>/``).  ``delta(a, b)``
makes the window's values: counters as differences, levels at both ends.
A value whose file is missing or unreadable is None.  A sandboxed kernel
may serve some of these files with zeros: the CPU times are the facts
that every machine gives.
"""

from __future__ import annotations

import os
import resource
import threading
import time

# thread name prefixes of the writer's threads (runtime/writer.py,
# ingest/consumer.py, core/writer.py) and of the harness's own
THREADS = {"worker": "KafkaProtoParquetWriter-", "fetcher": "smart-consumer-",
           "encode": "kpw-rg-encode", "assemble": "kpw-rg-assemble", "io": "kpw-rg-io",
           "load": "kpwbench-load", "main": "MainThread"}


def _read(path: str) -> str | None:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def _stat(proc: str) -> dict:
    text = _read(f"{proc}/stat")
    keys = ("steal_j", "iowait_j", "busy_j", "total_j")
    if text is None or not text.startswith("cpu "):
        return dict.fromkeys(keys)
    v = [int(x) for x in text.split("\n", 1)[0].split()[1:]]
    v += [0] * (8 - len(v))
    # user nice system idle iowait irq softirq steal [guest guest_nice, inside user]
    total = sum(v[:8])
    return {"steal_j": v[7], "iowait_j": v[4], "busy_j": total - v[3] - v[4],
            "total_j": total}


def _mhz(proc: str) -> float | None:
    text = _read(f"{proc}/cpuinfo")
    if text is None:
        return None
    mhz = [float(line.split(":", 1)[1]) for line in text.splitlines()
           if line.startswith("cpu MHz")]
    return sum(mhz) / len(mhz) if mhz else None


def _meminfo(proc: str) -> dict:
    out = {"dirty_kb": None, "writeback_kb": None}
    text = _read(f"{proc}/meminfo")
    for line in (text or "").splitlines():
        name, _, rest = line.partition(":")
        if name in ("Dirty", "Writeback"):
            out[name.lower() + "_kb"] = int(rest.split()[0])
    return out


def _task(proc: str, tid: int) -> dict:
    """One thread's CPU time (its own clock), and where ``/proc`` has
    them its run-queue wait (s), involuntary switches and migrations."""
    try:
        # the clock id pthread_getcpuclockid gives, built from the kernel's
        # thread id: a thread that has just ended reads EINVAL, where its
        # pthread handle could no longer be dereferenced
        cpu = time.clock_gettime((~tid << 3) | 6)
    except OSError:
        cpu = None
    out = {"cpu_s": cpu, "wait_s": None, "nivcsw": None, "migrations": None}
    base = f"{proc}/self/task/{tid}"
    sched = _read(f"{base}/schedstat")
    if sched:
        out["wait_s"] = int(sched.split()[1]) / 1e9
    for line in (_read(f"{base}/status") or "").splitlines():
        if line.startswith("nonvoluntary_ctxt_switches:"):
            out["nivcsw"] = int(line.split()[1])
    for line in (_read(f"{base}/sched") or "").splitlines():
        if line.startswith("se.nr_migrations"):
            out["migrations"] = int(line.split(":")[1])
    return out


def _group(name: str) -> str:
    return next((g for g, p in THREADS.items() if name.startswith(p)), "other")


def snapshot(proc: str = "/proc") -> dict:
    """The facts at one instant; ``proc`` is where ``/proc`` is mounted."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    tasks = {t.native_id: (_group(t.name), _task(proc, t.native_id))
             for t in threading.enumerate() if t.native_id}
    try:
        cores = sorted(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        cores = None
    return {"t": time.perf_counter(), **_stat(proc), "nvcsw": ru.ru_nvcsw,
            "nivcsw": ru.ru_nivcsw, "utime_s": ru.ru_utime, "stime_s": ru.ru_stime,
            "mhz": _mhz(proc), **_meminfo(proc), "load1": os.getloadavg()[0],
            "cores": cores, "tasks": tasks}


def _diff(a, b):
    return None if a is None or b is None else b - a


def delta(a: dict, b: dict) -> dict:
    """The window's facts from its two snapshots: counters as ``b - a``;
    the cores' mean MHz, Dirty and Writeback at both ends; the load
    average and the affinity at the end; and per thread group the sums of
    the counters of the threads alive at the end (0 at the start for a
    thread started inside the window: the row-group pipeline's threads,
    which live for one file, count only the files open at the end)."""
    out = {"window_s": b["t"] - a["t"]}
    for k in ("steal_j", "iowait_j", "busy_j", "total_j", "nvcsw", "nivcsw", "utime_s",
              "stime_s"):
        out[k] = _diff(a[k], b[k])
    for k in ("mhz", "dirty_kb", "writeback_kb"):
        out[k] = [a[k], b[k]]
    out["load1"] = b["load1"]
    out["cores"] = b["cores"]
    groups: dict = {}
    for tid, (g, t1) in b["tasks"].items():
        t0 = a["tasks"].get(tid, (g, {}))[1]
        s = groups.setdefault(g, {"threads": 0, **dict.fromkeys(
            ("cpu_s", "wait_s", "nivcsw", "migrations"))})
        s["threads"] += 1
        for k in ("cpu_s", "wait_s", "nivcsw", "migrations"):
            if t1[k] is not None:
                s[k] = (s[k] or 0) + t1[k] - (t0.get(k) or 0)
    out["threads"] = dict(sorted(groups.items()))
    return out
