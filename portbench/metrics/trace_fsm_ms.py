"""Milliseconds of the program's `encode/trace_fsm` span a write
(native.build_trace: the host library's trace FSM, dtpu_build_trace,
over each frame's matches, on the encode's pool), summed over a call's
frames on every thread and over the window's completed writes."""
from portbench.spans import per_call_ms


def read(run):
    return per_call_ms(run, "encode/trace_fsm", "write")
