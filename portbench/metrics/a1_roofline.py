"""A1's share of its roofline: the least time the card could take for
the model passes of the window's encodes (portbench/work.py:
model_pass_work on the traces the seed's blocks give, against 16.7
TOP/s of INT32 and 3.35 TB/s of HBM), over the device time of both of
csrc/model_pass.cu's kernels (rows_kernel and weights_kernel)."""
from portbench import work

KERNELS = r"\b(rows_kernel|weights_kernel)\b"


def read(run):
    writes = run.ops("write")
    if run.device is None or not writes:
        return None
    busy = run.device.seconds(KERNELS)
    if busy <= 0:
        return None
    need = {}
    for c in writes:
        if c.block not in need:
            need[c.block] = work.bound_seconds(
                *work.model_pass_work(run.block_traces(c.block)))[0]
    return 100.0 * sum(need[c.block] for c in writes) / busy
