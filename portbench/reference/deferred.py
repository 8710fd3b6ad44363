"""The benchmark's plain reference for the chunk-deferred read path.

It imports nothing of the program.  `golden/codec/deferred.py` is a
frozen copy of the golden deferred decoder (the structure pass, the
script executor and the whole-frame decode), run in plain Python
(~0.1 MB/s): the independent witness that a container made in set-up
is the deferred format and decodes to its input.  The literal counts
that kernel 1's work formula takes come from the seed's blocks through
the quality-10 parse of `codec.py` (a frame's literals are the bytes no
match covers) and from the container's lit fields, split by the frozen
copy.
"""
from __future__ import annotations

import numpy as np

from . import codec as ref
from .golden.codec import deferred as gd
from .golden.options import DivansOptions

SUB_LIT = gd.SUB_LIT


def container_chunk(blob: bytes) -> int:
    """The container's chunk size S from its flags byte (0: adaptive)."""
    return gd.flags_to_chunk(ref.read_container(blob)["flags"])


def decode_frame(cmd: bytes, lit: bytes, raw_len: int, chunk: int) -> bytes:
    """One deferred metablock decoded by the frozen golden decoder."""
    return gd.decode_metablock(cmd, lit, raw_len, DivansOptions(), chunk)


def lit_total(raw: bytes) -> int:
    """The literal bytes of a frame: those the quality-10 parse's matches
    do not cover."""
    m = ref.q10_matches(raw)
    return len(raw) - int(m[:, 2].sum())


def sub_streams(lit_field: bytes, total: int) -> list[tuple[bytes, int]]:
    """(payload, literal bytes) of each literal sub-stream of a frame
    whose literals number `total`: SUB_LIT bytes each, the last the
    rest."""
    subs = gd.lit_subs_split(lit_field)
    return [(p, max(0, min(SUB_LIT, total - j * SUB_LIT)))
            for j, p in enumerate(subs)]


def check_frames(blob: bytes, want: bytes, got: bytes, seed: int,
                 n: int = 3) -> dict:
    """n frames of a deferred container, drawn from the seed, decoded by
    the frozen golden decoder and held against the input (`want`) and
    the program's output (`got`), each over the frame's slice: the
    frames drawn and how many differed from each."""
    c = ref.read_container(blob)
    chunk = gd.flags_to_chunk(c["flags"])
    if chunk == 0:
        raise ValueError("not a chunk-deferred container")
    offs = np.concatenate([[0], np.cumsum(c["raw_lens"])]).tolist()
    rng = np.random.default_rng([seed % (1 << 64), 2])
    pick = sorted(rng.permutation(len(c["raw_lens"]))[:n].tolist())
    bad_input = bad_program = 0
    for i in pick:
        (cmd, lit), lo, hi = c["frames"][i], offs[i], offs[i + 1]
        raw = decode_frame(cmd, lit, hi - lo, chunk)
        bad_input += raw != want[lo:hi]
        bad_program += raw != got[lo:hi]
    return {"frames": pick, "bad_vs_input": bad_input,
            "bad_vs_program": bad_program}
