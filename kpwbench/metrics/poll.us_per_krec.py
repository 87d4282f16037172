"""Time the worker threads spend polling the consumer's queue (span
``worker.poll`` of ``runtime/writer.py``, with the 1 ms sleep of an empty
poll) per 1,000 records committed in the window, in microseconds: how long
the writer starves on the fetcher."""


def read(run):
    krec = run.committed_in_window() / 1e3
    spans = run.window_spans("worker.poll")
    if not spans or krec <= 0:
        return None
    return sum(s[2] for s in spans) / krec * 1e6
