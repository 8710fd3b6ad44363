"""Mean milliseconds of the program's `encode/trace_build` span a call
(codec/adaptive.compress_frames: the host traces of a call's frames on
the program's pool, native parse and trace FSM), over the window."""


def read(run):
    return run.span_ms("encode/trace_build")
