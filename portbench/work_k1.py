"""Kernel 1's yardstick: the work that the chunk-deferred literal
decode's lane groups need, copied from chip_smoke.py (`_group_work` and
its prices); the peaks are portbench/work.py's.

A group launch decodes every literal sub-stream of its frames on LANES
lanes, a lane working its queue of sub-streams one chunk (S / 2 bytes)
a step, for as many steps as its longest lane needs.  The groups are
the grouped pipeline's schedule: consecutive frames in file order, a
group closing once its frames' chunks reach LANES x GROUP_CHUNKS, its
sub-streams bin-packed largest first onto the least-loaded lane.
"""
from __future__ import annotations

import heapq

import numpy as np

# the literal decode, counted as the function needs it (not as the
# kernel's rescaled grids spend it): ~90 a decoded nibble on the chain
# (word select, 15 compares and adds, the two exact floor divisions of
# the symbol's start and freq, the state update, the next context), ~110
# a nibble for its adjustment and counts (four exact floor divisions,
# the bit length, two clamps, the atomic), and per chunk a lane decodes
# ~15 a premixed entry (the average alone: two loads, four products, two
# shifts, two adds, a shift, the i16 wrap, the store) over 192 x 16 and
# ~6 a committed entry (the add, the cumulative count, one renorm pass)
# over 385 x 16
DECODE_OPS_PER_NIBBLE = 90
ADJ_OPS_PER_NIBBLE = 110
PREMIX_OPS_PER_ENTRY = 15
COMMIT_OPS_PER_ENTRY = 6

LANES = 128
GROUP_CHUNKS = 128
R_LIT = 385
# a lane's final carry, int32: six scalars (state, cursor, p1, p2,
# n_rem, fidx), the committed model and the pend's adds [385, 16], the
# mixer weights [2, 3], the pend's limsum and cnt [385] and wadj [2, 2]
CARRY_BYTES_PER_LANE = 4 * (6 + 2 * R_LIT * 16 + 6 + 2 * R_LIT + 4)


def group_work(n_lit, words_bytes: int, lanes: int, n_steps: int, s: int,
               carry_bytes: int):
    """(bytes, operations, literal bytes, lane chunks) one group launch
    needs; n_lit: every queued stream's literal bytes (zeros are empty
    slots).  Bytes: the renorm words read (`words_bytes`), each stream's
    tables (lcmap, speeds, state, count, offset), the luts and perm
    read once; the bytes (lanes x n_steps x s), the scalars, the
    committed model and the pend written once (`carry_bytes`).
    Operations: DECODE_OPS_PER_NIBBLE and ADJ_OPS_PER_NIBBLE for each
    decoded nibble, and for each chunk a lane decodes, the premix of 192
    x 16 entries and the commit of 385 x 16."""
    n_lit = np.asarray(n_lit, np.int64)
    n_bytes_dec = int(n_lit.sum())
    lane_chunks = int(((n_lit + s - 1) // s).sum())
    n_streams = int((n_lit > 0).sum())
    out = lanes * n_steps * s + carry_bytes
    n_bytes = words_bytes + n_streams * (64 + 6 + 3) * 4 + (512 + 384) * 4 \
        + out
    n_ops = ((DECODE_OPS_PER_NIBBLE + ADJ_OPS_PER_NIBBLE) * 2 * n_bytes_dec
             + (PREMIX_OPS_PER_ENTRY * 192 * 16
                + COMMIT_OPS_PER_ENTRY * 385 * 16) * lane_chunks)
    return n_bytes, n_ops, n_bytes_dec, lane_chunks


def groups(needs, target: int = LANES * GROUP_CHUNKS) -> list[list[int]]:
    """Frame indices cut into groups: consecutive, in file order, a group
    closing once its frames' chunks (`needs`) reach `target`."""
    out, cur, need = [], [], 0
    for i, n in enumerate(needs):
        cur.append(i)
        need += n
        if need >= target:
            out.append(cur)
            cur, need = [], 0
    if cur:
        out.append(cur)
    return out


def longest_lane(chunks, lanes: int = LANES) -> int:
    """The most chunks a lane runs when streams of these chunk counts are
    bin-packed largest first onto the least-loaded of `lanes` lanes
    (at least 1)."""
    heap = [(0, lane) for lane in range(lanes)]
    top = 0
    for c in sorted((c for c in chunks if c > 0), reverse=True):
        load, lane = heapq.heappop(heap)
        top = max(top, load + c)
        heapq.heappush(heap, (load + c, lane))
    return max(1, top)


def stream_words_bytes(payload: bytes) -> int:
    """The renorm words of a stream read whole: its body past the 4-byte
    state, in int32 words."""
    return -(-max(0, len(payload) - 4) // 4) * 4
