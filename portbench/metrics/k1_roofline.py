"""Kernel 1's share of its roofline: the least time the card could take
for the literal decodes of the window's reads (portbench/work_k1.py:
group_work on each group of the grouped pipeline's schedule, against
portbench/work.py's 16.7 TOP/s of INT32 and 3.35 TB/s of HBM), over the
device time of csrc/lit_decode.cu's lit_decode_group_kernel.

The work is counted by the benchmark alone: each frame's literal bytes
from the seed's block through the reference's quality-10 parse, its
sub-streams from the container's lit field split by the frozen golden
copy; nothing is read from the program's counters."""
from concurrent.futures import ThreadPoolExecutor

from portbench import work, work_k1
from portbench.reference import codec as ref
from portbench.reference import deferred as rd

KERNEL = r"\blit_decode_group_kernel\b"


def container_seconds(blob: bytes, raw: bytes) -> float:
    """The least time of every group launch of one deferred decode."""
    got = ref.read_container(blob)
    s = rd.container_chunk(blob) // 2
    offs = [0]
    for n in got["raw_lens"]:
        offs.append(offs[-1] + n)
    with ThreadPoolExecutor(8) as pool:
        totals = list(pool.map(lambda i: rd.lit_total(raw[offs[i]:
                                                          offs[i + 1]]),
                               range(len(got["raw_lens"]))))
    subs = [rd.sub_streams(lit, t) for (_cmd, lit), t
            in zip(got["frames"], totals)]
    needs = [-(-t // s) for t in totals]
    least = 0.0
    for g in work_k1.groups(needs):
        jobs = [sub for i in g for sub in subs[i]]
        n_lit = [n for _p, n in jobs]
        words = sum(work_k1.stream_words_bytes(p) for p, n in jobs if n)
        n_steps = work_k1.longest_lane([-(-n // s) for n in n_lit])
        n_bytes, n_ops, _dec, _chunks = work_k1.group_work(
            n_lit, words, work_k1.LANES, n_steps, s,
            work_k1.LANES * work_k1.CARRY_BYTES_PER_LANE)
        least += work.bound_seconds(n_bytes, n_ops)[0]
    return least


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
            need[c.block] = container_seconds(run.containers[c.block],
                                              run.blocks[c.block])
    return 100.0 * sum(need[c.block] for c in reads) / busy
