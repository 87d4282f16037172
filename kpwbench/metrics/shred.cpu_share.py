"""The share of the wire shredder's time (span ``worker.shred``) that its
thread spent on a core, in percent: the spans' thread CPU time (attribute
``cpu_ms``) over their wall time in the window.  The rest is time the
thread waited, for the GIL above all."""


def read(run):
    spans = [s for s in run.window_spans("worker.shred") if "cpu_ms" in (s[3] or {})]
    wall_ms = sum(s[2] for s in spans) * 1e3
    if not spans or wall_ms <= 0:
        return None
    return 100.0 * sum(s[3]["cpu_ms"] for s in spans) / wall_ms
