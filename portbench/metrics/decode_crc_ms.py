"""Milliseconds a read spends in the program's `decode/crc` span
(api.decompress: the CRC32C of the output against the container's),
over the window's completed reads."""
from portbench.spans import per_call_ms


def read(run):
    return per_call_ms(run, "decode/crc", "read")
