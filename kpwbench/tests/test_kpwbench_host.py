"""The ``[host]`` probe: the facts of a window from the process's own
``/proc``, and None for what a machine does not have."""

import os
import threading
import time

from kpwbench import host

COUNTERS = ("steal_j", "iowait_j", "busy_j", "total_j", "nvcsw", "nivcsw", "utime_s",
            "stime_s")


def _busy_window(proc="/proc"):
    a = host.snapshot(proc)
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name="kpw-rg-io-test")
    t.start()
    try:
        end = time.perf_counter() + 0.2
        while time.perf_counter() < end:
            pass
        return host.delta(a, host.snapshot(proc))
    finally:
        stop.set()
        t.join(timeout=10)
        assert not t.is_alive()


def test_every_fact_is_present_and_not_negative_on_this_machine():
    d = _busy_window()
    for k in COUNTERS:
        assert d[k] is not None and d[k] >= 0, k
    assert d["total_j"] > 0 and d["utime_s"] > 0
    for k in ("mhz", "dirty_kb", "writeback_kb"):
        assert len(d[k]) == 2 and all(v is not None and v >= 0 for v in d[k]), k
    assert d["load1"] >= 0 and d["cores"] and d["window_s"] >= 0.2
    main = d["threads"]["main"]
    assert main["threads"] == 1 and main["cpu_s"] > 0.1
    for g in d["threads"].values():
        assert all(g[k] is not None and g[k] >= 0
                   for k in ("cpu_s", "wait_s", "nivcsw", "migrations")), g
    # a thread started inside the window counts from 0, under its name's group
    assert d["threads"]["io"]["threads"] == 1


def test_a_missing_proc_reads_none_and_raises_nothing(tmp_path):
    d = _busy_window(str(tmp_path))
    for k in ("steal_j", "iowait_j", "busy_j", "total_j"):
        assert d[k] is None, k
    assert d["mhz"] == [None, None] and d["dirty_kb"] == [None, None]
    assert d["writeback_kb"] == [None, None]
    # getrusage and the threads' own clocks need no /proc
    assert d["utime_s"] > 0 and d["nvcsw"] is not None
    assert d["threads"]["main"]["cpu_s"] > 0.1
    for g in d["threads"].values():
        assert g["wait_s"] is None and g["nivcsw"] is None and g["migrations"] is None


def test_the_proc_files_are_read_as_the_kernel_writes_them(tmp_path):
    (tmp_path / "stat").write_text("cpu  100 5 30 900 7 2 3 11 0 0\ncpu0 1 2 3 4\n")
    (tmp_path / "cpuinfo").write_text("processor\t: 0\ncpu MHz\t\t: 2000.5\n\n"
                                      "processor\t: 1\ncpu MHz\t\t: 3000.5\n")
    (tmp_path / "meminfo").write_text("MemTotal:  100 kB\nDirty:   4096 kB\n"
                                      "Writeback:  12 kB\n")
    s = host.snapshot(str(tmp_path))
    # user nice system idle iowait irq softirq steal: busy is all but idle and iowait
    assert (s["steal_j"], s["iowait_j"], s["busy_j"], s["total_j"]) == (11, 7, 151, 1058)
    assert s["mhz"] == 2500.5 and (s["dirty_kb"], s["writeback_kb"]) == (4096, 12)


def test_a_thread_that_has_ended_reads_no_cpu_and_raises_nothing():
    t = threading.Thread(target=lambda: None)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    end = time.perf_counter() + 10  # the kernel's thread outlives the join a moment
    while os.path.exists(f"/proc/self/task/{t.native_id}") and time.perf_counter() < end:
        time.sleep(0.01)
    assert host._task("/nonexistent", t.native_id)["cpu_s"] is None
    me = host._task("/proc", threading.get_native_id())["cpu_s"]
    assert me is not None and abs(me - time.thread_time()) < 0.05
