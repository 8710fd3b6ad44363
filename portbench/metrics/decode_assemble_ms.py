"""Milliseconds a read spends in the program's `decode/assemble` span
(codec/adaptive.decompress_frames: every host copy that builds the
output, the scan's rows and the host-decoded frames into one buffer,
then its bytes), over the window's completed reads."""
from portbench.spans import per_call_ms


def read(run):
    return per_call_ms(run, "decode/assemble", "read")
