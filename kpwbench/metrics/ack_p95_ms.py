"""The 95th percentile, over every record due in the window, of its commit
time less the time it was due to be produced (open loop: a stall counts
against every record behind it).  A record never committed counts at the
time the wait for it ended."""

import numpy as np


def read(run):
    if run.load.mode != "open_loop":
        return None
    parts, offs, due = run.load.due(run.w0, run.w1)
    if len(offs) == 0:
        return None
    t = run.commit_times(parts, offs)
    t = np.where(np.isinf(t), run.t_end, t)
    return float(np.percentile(t - due, 95)) * 1e3
