"""Per-call readings of the program's tracelog spans, for the per-layer
readers under metrics/."""


def per_call_ms(run, span: str, op: str) -> float | None:
    """Milliseconds of `span` a completed call of `op`: the span's
    duration summed over the window (every event of it, on any thread)
    over the window's completed calls of the op; None where the program
    records no such span, or no call completed."""
    got = [dt for name, _t0, _t1, dt in run.spans if name == span]
    calls = run.ops(op)
    if not got or not calls:
        return None
    return 1e3 * sum(got) / len(calls)
