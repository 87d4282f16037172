"""Mean time of a file's publish (span ``worker.publish``: verify and the
rename into the target directory, ``runtime/writer.py`` over ``io/fs.py``)
in the window, in milliseconds."""


def read(run):
    spans = run.window_spans("worker.publish")
    if not spans:
        return None
    return sum(s[2] for s in spans) / len(spans) * 1e3
