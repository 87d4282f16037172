"""Mean time from a file's rotation to the commit of its offsets (span
``worker.rotate`` of ``runtime/writer.py``: the close, which waits for the
file's row groups in flight and writes the footer, then the publish and
the acks) in the window, in milliseconds."""


def read(run):
    spans = run.window_spans("worker.rotate")
    if not spans:
        return None
    return sum(s[2] for s in spans) / len(spans) * 1e3
