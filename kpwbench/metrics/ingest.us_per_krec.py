"""Host time of the ingest layer (spans ``consumer.fetch`` and
``consumer.track`` of ``ingest/consumer.py``) per 1,000 records committed
in the window, in microseconds."""


def read(run):
    krec = run.committed_in_window() / 1e3
    spans = run.window_spans("consumer.fetch", "consumer.track")
    if not spans or krec <= 0:
        return None
    return sum(s[2] for s in spans) / krec * 1e6
