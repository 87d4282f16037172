"""Mean time from a row group's detach from the writer's buffer to the end
of its IO write (span ``rowgroup.latency`` of ``core/writer.py``: the
merge, the encode's launch and assembly, the IO write and the waits in the
pipeline's queues between them) in the window, in milliseconds."""


def read(run):
    spans = run.window_spans("rowgroup.latency")
    if not spans:
        return None
    return sum(s[2] for s in spans) / len(spans) * 1e3
