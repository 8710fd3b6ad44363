"""The card's timeline over a traced window, read from torch.profiler's
trace, and the host's spans laid over it.

Device activity is every kernel, copy and memset the profiler recorded
on the card (CUPTI sees the port's ctypes launches too).  The host's
clock and the trace's are tied by the benchmark's own annotation around
each call (`portbench/call`), whose start it also reads on the host.
"""
from __future__ import annotations

import json
import re
import statistics

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_MARK = "portbench/call"


def _union(intervals):
    """Disjoint, sorted [start, end] of the union of intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class DeviceTrace:
    """Device events (name, start s, end s) on the host's perf_counter
    clock, clipped to the window [t0, t1]."""

    def __init__(self, events, t0: float, t1: float):
        self.t0, self.t1 = t0, t1
        self.events = [(n, max(s, t0), min(e, t1)) for n, s, e in events
                       if e > t0 and s < t1]
        self.busy = _union([[s, e] for _n, s, e in self.events])

    @classmethod
    def from_chrome(cls, path: str, host_marks: list[float], t0: float,
                    t1: float) -> "DeviceTrace":
        """Read an exported trace.  host_marks: the host's perf_counter
        at each CALL_MARK annotation's start, in order."""
        with open(path) as f:
            evs = json.load(f)["traceEvents"]
        marks = sorted(e["ts"] for e in evs if e.get("ph") == "X"
                       and e.get("cat") == "user_annotation"
                       and e.get("name") == CALL_MARK)
        if not marks or len(marks) != len(host_marks):
            raise RuntimeError(f"{len(marks)} call marks in the trace, "
                               f"{len(host_marks)} calls made")
        off = statistics.median(m / 1e6 - h for m, h in
                                zip(marks, host_marks))
        dev = [(e["name"], e["ts"] / 1e6 - off,
                (e["ts"] + e.get("dur", 0)) / 1e6 - off)
               for e in evs if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS]
        return cls(dev, t0, t1)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    def seconds(self, pattern: str) -> float:
        """Device seconds of the events whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.events if rx.search(n))

    def top_ops(self, k: int = 10, width: int = 120) -> list:
        """[name, seconds] of the k operations that took most device
        time, each name cut to `width` characters."""
        tot: dict[str, float] = {}
        for n, s, e in self.events:
            tot[n[:width]] = tot.get(n[:width], 0.0) + (e - s)
        return sorted(([n, v] for n, v in tot.items()),
                      key=lambda x: -x[1])[:k]

    def gaps(self) -> list[tuple[float, float]]:
        """The window's idle intervals, longest first."""
        out, t = [], self.t0
        for s, e in self.busy:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.t1 > t:
            out.append((t, self.t1))
        return sorted(out, key=lambda g: g[0] - g[1])


def label_gaps(gaps, spans, calls, k: int = 10) -> list:
    """[label, seconds] of the k longest gaps, each labelled with the
    innermost host span at its midpoint: a span of the program's
    tracelog, else the call it falls in (the entry point outside the
    program's spans), else the client between calls."""
    out = []
    for s, e in gaps[:k]:
        mid = (s + e) / 2
        inner = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        if inner:
            label = min(inner, key=lambda sp: sp[2] - sp[1])[0]
        elif any(c.t0 <= mid <= c.t1 for c in calls):
            label = "api (outside the program's spans)"
        else:
            label = "portbench/client (between calls)"
        out.append([label, e - s])
    return out
