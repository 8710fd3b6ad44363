"""Milliseconds a read spends in the program's `decode/pack` span
(codec/adaptive.decompress_frames: scan_decode.pack_frames, each frame's
streams packed as the scan's lanes on the host), over the window's
completed reads."""
from portbench.spans import per_call_ms


def read(run):
    return per_call_ms(run, "decode/pack", "read")
