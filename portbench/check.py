"""What decides `correct`: the timed calls' outputs against the plain
reference, each number beside its limit.

Reads: every decode in the window against the seed's input, byte for
byte.  Writes: every container of the window parsed by the frozen
format copy, its header, frame lengths and CRC against the reference's
(the CRC by the benchmark's own numpy CRC32C); every container of one
block equal to the others of that block; and a sample of frames, drawn
from the seed, coded again by the reference encoder and compared stream
for stream with the program's.  Each comparison is exact, so each limit
is 0.
"""
from __future__ import annotations

import numpy as np

from .reference import codec as ref

LIMITS = {"failed_calls": 0, "bad_reads": 0, "bad_bytes": 0,
          "bad_headers": 0, "unstable_blocks": 0, "bad_frames": 0}


def _diff_bytes(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    x = np.frombuffer(a, np.uint8, n)
    y = np.frombuffer(b, np.uint8, n)
    return int((x != y).sum()) + abs(len(a) - len(b))


def check_reads(calls, blocks) -> dict:
    bad_reads = bad_bytes = 0
    for c in calls:
        if c.op != "read" or c.error is not None:
            continue
        want = blocks[c.block]
        if c.out != want:
            bad_reads += 1
            bad_bytes += _diff_bytes(c.out, want)
    return {"bad_reads": bad_reads, "bad_bytes": bad_bytes}


def check_writes(calls, blocks, config: dict, n_frames: int,
                 rng: np.random.Generator) -> dict:
    """The write checks; n_frames frames are coded again by the
    reference, drawn by rng from the blocks the window wrote."""
    writes = [c for c in calls if c.op == "write" and c.error is None]
    if not writes:
        return {}
    ropts = ref.options_of(config)
    ref.check_supported(ropts)
    first: dict[int, bytes] = {}
    want_hdr: dict[int, dict] = {}
    bad_headers = unstable = 0
    for c in writes:
        if c.block not in first:
            first[c.block] = c.out
            want_hdr[c.block] = ref.expected_header(blocks[c.block], ropts)
        elif c.out != first[c.block]:
            unstable += 1
    parsed = {}
    for b, blob in first.items():
        try:
            got = ref.read_container(blob)
        except Exception:  # noqa: BLE001 - an unreadable container is bad
            got = None
        parsed[b] = got
        head = None if got is None else {k: got[k] for k in want_hdr[b]}
        if head != want_hdr[b]:
            # every call on this block returned these bytes or was counted
            bad_headers += sum(1 for c in writes if c.block == b
                               and c.out == blob)
    pairs = [(b, i) for b in sorted(first)
             for i in range(len(want_hdr[b]["raw_lens"]))]
    pick = rng.permutation(len(pairs))[:n_frames].tolist()
    bad_frames = 0
    mb = ropts.metablock_size
    for j in pick:
        b, i = pairs[j]
        raw = blocks[b][i * mb:(i + 1) * mb]
        got = parsed[b]
        have = got["frames"][i] if got and i < len(got["frames"]) else None
        if have != ref.encode_frame(raw, ropts):
            bad_frames += 1
    return {"bad_headers": bad_headers, "unstable_blocks": unstable,
            "bad_frames": bad_frames, "frames_checked": len(pick)}


def verdict(calls, blocks, config, traffic, seed: int):
    """({name: (value, limit)} of every number compared, the number of
    frames the reference coded again)."""
    got = {"failed_calls": sum(1 for c in calls if c.error is not None)}
    if any(c.op == "read" for c in calls):
        got.update(check_reads(calls, blocks))
    rng = np.random.default_rng([seed % (1 << 64), 1])
    got.update(check_writes(calls, blocks, config,
                            traffic.get("check_frames", 3), rng))
    checked = got.pop("frames_checked", 0)
    return {k: (v, LIMITS[k]) for k, v in got.items()}, checked


def is_correct(checks: dict) -> bool:
    return all(v <= limit for v, limit in checks.values())
