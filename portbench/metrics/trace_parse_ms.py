"""Milliseconds of the program's `encode/parse` span a write
(native.build_trace: the host library's quality-10 parse of each frame,
on the encode's pool), summed over a call's frames on every thread and
over the window's completed writes: against `trace_build_ms`, the wall
of the same pool, it says how well the pool's threads are used."""
from portbench.spans import per_call_ms


def read(run):
    return per_call_ms(run, "encode/parse", "write")
