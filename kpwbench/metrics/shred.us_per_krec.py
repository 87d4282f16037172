"""Host time of the wire shredder (span ``worker.shred``:
``models/proto_bridge.py`` into ``native/src/shred.cc``) per 1,000 records
committed in the window, in microseconds."""


def read(run):
    krec = run.committed_in_window() / 1e3
    spans = run.window_spans("worker.shred")
    if not spans or krec <= 0:
        return None
    return sum(s[2] for s in spans) / krec * 1e6
