"""Records committed per second over the window, counted in whole files.

A file sink commits in lumps of one file (its acks come as one burst of
commits).  The rate is the records committed by the bursts after the
window's first burst up to and including its last, over the time between
those two bursts; a count cut at the window's edges would swing by a file.
A per-layer metric of the traced run: on a host shared with other work the
rate of one process swings by more than any end-to-end bound can hold.
"""


def read(run):
    bursts = [b for b in run.bursts() if run.w0 <= b[0] <= run.w1]
    if len(bursts) < 2 or bursts[-1][0] <= bursts[0][0]:
        return None
    return (bursts[-1][1] - bursts[0][1]) / (bursts[-1][0] - bursts[0][0])
