"""A2's share of its roofline: the least time the card could take for
the scans of the window's decodes (portbench/work.py: scan_work on each
container's frames and the traces the seed's blocks give, against 16.7
TOP/s of INT32 and 3.35 TB/s of HBM), over the device time of
csrc/scan_decode.cu's scan_kernel.  Frames are counted whole: a frame
the scan flags would count the share its wpos reached, and
scan_frame_pct says how many there were."""
from portbench import work
from portbench.reference import codec as ref

KERNEL = r"\bscan_kernel\b"


def read(run):
    reads = run.ops("read")
    if run.device is None or not reads:
        return None
    busy = run.device.seconds(KERNEL)
    if busy <= 0:
        return None
    need = {}
    for c in reads:
        if c.block not in need:
            got = ref.read_container(run.containers[c.block])
            frames = [work.Frame(n, cmd, lit) for n, (cmd, lit)
                      in zip(got["raw_lens"], got["frames"])]
            need[c.block] = work.bound_seconds(*work.scan_work(
                frames, run.block_traces(c.block), got["raw_lens"]))[0]
    return 100.0 * sum(need[c.block] for c in reads) / busy
