"""Milliseconds a read spends in the program's `decode/structure` span
(codec/decode.decompress_frames: the host structure pass of one frame,
native.decode_cmd_structure, on the structure pool), summed over a
call's frames on every thread and over the window's completed reads."""
from portbench.spans import per_call_ms


def read(run):
    return per_call_ms(run, "decode/structure", "read")
