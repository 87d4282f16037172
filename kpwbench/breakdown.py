"""Reductions of a traced run's device operations: the device's busy time
in the window, and the ``breakdown`` of the result line (the device
operations that took most time, and the longest idle gaps, each named by
the host span that covers most of it)."""

from __future__ import annotations

import numpy as np


def _intervals(run) -> list:
    """Busy intervals of the device within the window, merged."""
    out = []
    for _, start, dur in run.device_ops:
        a, b = max(start, run.w0), min(start + dur, run.w1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy(run) -> float:
    """Seconds of the window in which an operation ran on the device (the
    union of kernel, copy and memset intervals)."""
    return sum(b - a for a, b in _intervals(run))


class _HostSpans:
    def __init__(self, spans: list) -> None:
        self.names = sorted({s[0] for s in spans})
        code = {n: i for i, n in enumerate(self.names)}
        self.code = np.array([code[s[0]] for s in spans], np.int64)
        self.start = np.array([s[1] for s in spans])
        self.end = self.start + np.array([s[2] for s in spans])

    def label(self, a: float, b: float) -> str:
        """The host span name that covers most of [a, b)."""
        o = np.minimum(b, self.end) - np.maximum(a, self.start)
        hit = o > 0
        if not hit.any():
            return "no span"
        cover = np.bincount(self.code[hit], weights=o[hit], minlength=len(self.names))
        return self.names[int(np.argmax(cover))]


def breakdown(run, top: int = 10) -> dict:
    by_name: dict = {}
    for name, start, dur in run.device_ops:
        if run.w0 <= start < run.w1:
            by_name[name] = by_name.get(name, 0.0) + dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    edges = [run.w0] + [x for a, b in _intervals(run) for x in (a, b)] + [run.w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]),
                  reverse=True)[:top]
    host = _HostSpans(run.spans)
    return {"device_ops": [[name[:120], t] for name, t in ops],
            "idle_gaps": [[host.label(a, b), g] for g, a, b in gaps]}
