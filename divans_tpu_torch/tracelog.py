"""Stage tracing: a wall-clock timeline of the port's stages.

The port of divans_tpu/tracelog.py, the analog of the reference
codec's per-thread event log: one compress() or decompress() call as a
tree of named stages (traces, model pass, lane coding, assembly, the
decode pipeline, host fallbacks), so a stall between the host pool and
the card shows where it hides.

Each span records its own id, its parent (the span it opened inside,
None for a root), its request (the id of its root span: every span of
one api.compress or api.decompress call shares it) and its thread.  The
open span is a contextvars.ContextVar, so a pool worker keeps its
caller's span as its parent when its function is wrapped in
`bound(fn)`.  While tracing is on, each span also opens
torch.profiler.record_function(name): under torch.profiler the stages
appear in export_chrome_trace as user annotations on the profiler's
clock, beside the kernels and copies they launch, and key_averages()
gives each stage's device time without a synchronise.  The profiler
records the threads it was started on; a pool worker's spans reach it
when it profiles all threads (its experimental `profile_all_threads`).

Zero overhead when disabled: a span is one bool check (no ids, no
context copy, no profiler range), and it never synchronises the card.
A span records host wall time; where a stage queues device work, its
span ends where that stage already waits for the card (a copy back, an
event), so device time lands in the stage that waits for it.  Enable
with env DIVANS_TRACELOG=1, the CLI flag `-timing`, or
`tracelog.enable()`; read with `events()`/`report()`.

    with tracelog.span("encode/model_pass", frames=n) as meta:
        ...     # meta: the span's dict (None when disabled)

The log is process-global and append-only within one enable window.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from dataclasses import dataclass, field

from torch.profiler import record_function


@dataclass
class Event:
    name: str
    t0: float
    dt: float
    meta: dict = field(default_factory=dict)
    request: int | None = None
    parent: int | None = None
    thread: int = 0
    id: int = 0


_events: list[Event] = []
_enabled = os.environ.get("DIVANS_TRACELOG", "") not in ("", "0")
_t_origin = time.perf_counter()
_ids = itertools.count(1)
# (request, span id) of the innermost open span, None outside every span
_open: contextvars.ContextVar[tuple[int, int] | None] = \
    contextvars.ContextVar("divans_tracelog_open", default=None)
_OFF = contextlib.nullcontext()


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def clear() -> None:
    del _events[:]


def events() -> list[Event]:
    return list(_events)


class _Span:
    __slots__ = ("name", "meta", "id", "parent", "request", "token", "rf",
                 "t0")

    def __init__(self, name: str, meta: dict):
        self.name = name
        self.meta = meta

    def __enter__(self) -> dict:
        outer = _open.get()
        self.id = next(_ids)
        self.parent = None if outer is None else outer[1]
        self.request = self.id if outer is None else outer[0]
        self.token = _open.set((self.request, self.id))
        self.rf = record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self.meta

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        _open.reset(self.token)
        _events.append(Event(self.name, self.t0 - _t_origin, dt, self.meta,
                             self.request, self.parent,
                             threading.get_native_id(), self.id))
        return False


def span(name: str, **meta):
    """Time a stage; no-op (one bool check) when tracing is disabled.
    The context yields the span's `meta` dict, for values known only
    inside it (None when disabled)."""
    if not _enabled:
        return _OFF
    return _Span(name, meta)


def bound(fn):
    """`fn` run in a copy of the caller's context, so that the spans a
    pool worker opens have the caller's open span as their parent and
    share its request; `fn` itself when tracing is disabled."""
    if not _enabled:
        return fn
    ctx = contextvars.copy_context()

    def run(*args, **kwargs):
        # a context is entered by one thread at a time: a copy a call
        return ctx.copy().run(fn, *args, **kwargs)
    return run


def self_seconds(evs: list[Event]) -> dict[int, float]:
    """Each span's self time by its id: its duration less the part of
    its interval that its own children on its own thread cover."""
    kids: dict[int, list[Event]] = {}
    for e in evs:
        if e.parent is not None:
            kids.setdefault(e.parent, []).append(e)
    out = {}
    for e in evs:
        end = e.t0 + e.dt
        covered, reach = 0.0, e.t0
        for s, t in sorted((max(c.t0, e.t0), min(c.t0 + c.dt, end))
                           for c in kids.get(e.id, ())
                           if c.thread == e.thread):
            s = max(s, reach)
            if t > s:
                covered += t - s
                reach = t
        out[e.id] = e.dt - covered
    return out


def report() -> str:
    """Aggregated per-stage table: total, calls, mean, self time and its
    share.  TOTAL is the root spans' time; a span opened on a pool
    worker under another thread's span is that worker's time, beside
    its parent's, and the pool row sums those spans, so the self column
    sums to TOTAL plus the pool row."""
    if not _events:
        return "tracelog: no events (enable with DIVANS_TRACELOG=1)"
    own = self_seconds(_events)
    thread_of = {e.id: e.thread for e in _events}
    agg: dict[str, list[float]] = {}
    for e in _events:
        a = agg.setdefault(e.name, [0.0, 0, 0.0])
        a[0] += e.dt
        a[1] += 1
        a[2] += own[e.id]
    total = sum(e.dt for e in _events if e.parent is None)
    pool = sum(e.dt for e in _events if e.parent is not None
               and thread_of.get(e.parent, e.thread) != e.thread)
    base = total or 1.0
    lines = ["  total ms   calls   avg ms   self ms    %     stage"]
    for name in sorted(agg, key=lambda k: -agg[k][0]):
        s, n, own_s = agg[name]
        lines.append(f"{s * 1e3:10.1f} {n:7d} {s / n * 1e3:8.2f} "
                     f"{own_s * 1e3:9.1f} {100 * own_s / base:5.1f}    "
                     f"{name}")
    if pool:
        lines.append(f"{pool * 1e3:10.1f}                                  "
                     "pool threads (spans under another thread's span)")
    lines.append(f"{total * 1e3:10.1f}                                  "
                 "TOTAL (root spans)")
    return "\n".join(lines)
