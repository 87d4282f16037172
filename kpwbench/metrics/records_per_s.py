"""Records committed per second over the window, counted in whole files:
the end-to-end twin of the traced ``ack.records_per_s``, read from the
untraced run.

A file sink commits in lumps of one file (its acks come as one burst of
commits).  The rate is the records committed by the bursts after the
window's first burst up to and including its last, over the time between
those two bursts: all the files the window completes, over the time they
took; a count cut at the window's edges would swing by a file.
"""


def read(run):
    bursts = [b for b in run.bursts() if run.w0 <= b[0] <= run.w1]
    if len(bursts) < 2 or bursts[-1][0] <= bursts[0][0]:
        return None
    return (bursts[-1][1] - bursts[0][1]) / (bursts[-1][0] - bursts[0][0])
