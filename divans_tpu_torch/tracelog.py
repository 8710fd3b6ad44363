"""Stage tracing: a wall-clock timeline of the port's stages.

The port of divans_tpu/tracelog.py, the analog of the reference
codec's per-thread event log: one compress() or decompress() call as a
list of named stages (traces, model pass, lane coding, assembly, the
decode pipeline, host fallbacks), so a stall between the host pool and
the card shows where it hides.

Zero overhead when disabled: a span is one bool check, and it never
synchronises the card.  A span records host wall time; where a stage
queues device work, its span ends where that stage already waits for
the card (a copy back, an event), so device time lands in the stage
that waits for it.  Enable with env DIVANS_TRACELOG=1, the CLI flag
`-timing`, or `tracelog.enable()`; read with `events()`/`report()`.

    with tracelog.span("encode/model_pass", frames=n):
        ...

The log is process-global and append-only within one enable window.
Pair it with torch.profiler for the card's own timeline.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field


@dataclass
class Event:
    name: str
    t0: float
    dt: float
    meta: dict = field(default_factory=dict)


_events: list[Event] = []
_enabled = os.environ.get("DIVANS_TRACELOG", "") not in ("", "0")
_t_origin = time.perf_counter()


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def clear() -> None:
    del _events[:]


def events() -> list[Event]:
    return list(_events)


@contextlib.contextmanager
def span(name: str, **meta):
    """Time a stage; no-op (one bool check) when tracing is disabled."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _events.append(Event(name, t0 - _t_origin,
                             time.perf_counter() - t0, meta))


def report() -> str:
    """Aggregated per-stage table: total, calls, mean and share."""
    if not _events:
        return "tracelog: no events (enable with DIVANS_TRACELOG=1)"
    agg: dict[str, list[float]] = {}
    for e in _events:
        agg.setdefault(e.name, []).append(e.dt)
    total = sum(sum(v) for v in agg.values())
    lines = ["  total ms   calls   avg ms    %     stage"]
    for name in sorted(agg, key=lambda k: -sum(agg[k])):
        s = sum(agg[name])
        n = len(agg[name])
        lines.append(f"{s * 1e3:10.1f} {n:7d} {s / n * 1e3:8.2f} "
                     f"{100 * s / total:5.1f}    {name}")
    lines.append(f"{total * 1e3:10.1f}                         TOTAL")
    return "\n".join(lines)
