"""Milliseconds a read spends in the program's `decode/execute` span
(codec/decode.decompress_frames: one frame's command script run over its
decoded literals into the output, native.execute_script, on the finish
pool), summed over a call's frames on every thread and over the
window's completed reads."""
from portbench.spans import per_call_ms


def read(run):
    return per_call_ms(run, "decode/execute", "read")
