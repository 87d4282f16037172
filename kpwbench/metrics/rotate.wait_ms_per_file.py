"""Mean time a worker thread waits, when it hands a file over, for the
previous file's close, publish and acks on its finisher thread to end
(span ``worker.rotate_wait`` of ``runtime/writer.py``) in the window, in
milliseconds: about 0 when that finish ran wholly behind the next file's
poll and shred, the whole finish when nothing overlapped.  None where the
writer records no such span, as a writer without a finisher does."""


def read(run):
    spans = run.window_spans("worker.rotate_wait")
    if not spans:
        return None
    return sum(s[2] for s in spans) / len(spans) * 1e3
