"""Block-type segmentation: heterogeneous inputs -> literal block switches.

The reference inherits block splits from brotli's metablock splitter and
codes them as BlockSwitch commands with their own prior family
(the reference's src/codec/block_type.rs:18-195).  Our matcher is
brotli-free, so this module supplies the splitter: a byte-class
clustering over fixed windows.  Each block type addresses its own 64
context-map rows (engine_np._literal_nibble: cmap_index =
ctx + btype << 6), so heterogeneous segments (text vs binary vs tables)
stop polluting each other's literal models.

Opt-in via DivansOptions.block_split.  Since round 3, nb<=4 split
streams encode AND decode on the native fast path (split profile,
container flag 3 — native.py, COMPONENTS.md row 21); only nb>4 or
non-identity literal context maps fall back to the golden engine.
The full profile->decode-path matrix lives in DESIGN.md.

A copy of divans_tpu/ir/blocks.py
(the port imports nothing of that package).
"""
from __future__ import annotations

import numpy as np

WIN = 4096          # classification window
MIN_SEG = 8192      # segments shorter than this merge into their left
MAX_TYPES = 4       # lcm values t*64+i must stay < 256
_THRESH = 0.55      # L1 feature distance to open a new block type


def _features(a: np.ndarray) -> np.ndarray:
    """Per-window byte-class fractions [nwin, 5]: letters, digits,
    whitespace/punct, zero bytes, high bytes."""
    nwin = len(a) // WIN
    w = a[:nwin * WIN].reshape(nwin, WIN)
    letter = ((w | 0x20) >= 97) & ((w | 0x20) <= 122)
    digit = (w >= 48) & (w <= 57)
    zero = w == 0
    high = w >= 128
    other = ~(letter | digit | zero | high)
    f = np.stack([letter.mean(1), digit.mean(1), other.mean(1),
                  zero.mean(1), high.mean(1)], axis=1)
    return f


def segment(data: bytes) -> list[tuple[int, int]]:
    """[(start_offset, block_type)] covering `data`; first type is 0.

    Greedy online clustering of window features into <= MAX_TYPES
    centroids, then run merging and short-segment absorption."""
    if len(data) < 2 * MIN_SEG:
        return [(0, 0)]
    a = np.frombuffer(data, np.uint8)
    feats = _features(a)
    centroids: list[np.ndarray] = []
    counts: list[int] = []
    labels = np.zeros(len(feats), np.int32)
    for i, f in enumerate(feats):
        if centroids:
            d = [float(np.abs(f - c).sum()) for c in centroids]
            j = int(np.argmin(d))
        else:
            d, j = [_THRESH + 1], 0
        if d[j] > _THRESH and len(centroids) < MAX_TYPES:
            centroids.append(f.copy())
            counts.append(1)
            j = len(centroids) - 1
        else:
            counts[j] += 1
            centroids[j] += (f - centroids[j]) / counts[j]
        labels[i] = j
    # windows -> segments, absorbing short runs leftward
    segs: list[list[int]] = []  # [start, label]
    for i, lab in enumerate(labels):
        if segs and segs[-1][1] == lab:
            continue
        start = i * WIN
        if segs and start - segs[-1][0] < MIN_SEG:
            continue  # too short: stay in the previous segment
        segs.append([start, int(lab)])
    # renumber by first appearance so the stream starts in type 0
    remap: dict[int, int] = {}
    out = []
    for start, lab in segs:
        t = remap.setdefault(lab, len(remap))
        if out and out[-1][1] == t:
            continue
        out.append((start, t))
    return out


def per_type_strides(data: bytes, segments) -> list[int]:
    """Literal-prior stride per block type (detect.detect_stride over the
    type's own bytes; 1 = the plain previous-byte prior)."""
    from .detect import detect_stride
    nb = max(t for _, t in segments) + 1
    bounds = [s for s, _ in segments] + [len(data)]
    parts: list[bytes] = [b""] * nb
    for (start, t), end in zip(segments, bounds[1:]):
        parts[t] += data[start:end]
    return [detect_stride(p, quality=1) for p in parts]


def prediction_mode_for(nb: int, options, strides=None):
    """PredictionMode whose literal context map gives each of the nb
    block types its own 64 rows (values t*64 + ctx), with per-type
    stride priors carried in the mixing mask (mv_mode=4: mask value
    4 + stride - 1 on the type's context slice)."""
    from . import commands as cmds
    from .matcher import default_prediction_mode
    pm = default_prediction_mode(options)
    lcm = bytes(t * 64 + i for t in range(nb) for i in range(64))
    mv = b""
    if strides and any(s > 1 for s in strides):
        vals = [0 if s <= 1 else 4 + min(7, s - 1) for s in strides]
        mv = bytes(vals[min((i & 0xFF) >> 6, nb - 1)]
                   for i in range(cmds.NUM_MIXING_VALUES))
    return cmds.PredictionMode(
        literal_prediction_mode=pm.literal_prediction_mode,
        context_mixing=pm.context_mixing,
        adv_context_map=pm.adv_context_map,
        prior_depth=pm.prior_depth,
        speeds=pm.speeds,
        literal_context_map=lcm,
        distance_context_map=pm.distance_context_map,
        mixing_values=mv,
    )


def _cluster_windows(feats: np.ndarray, thresh: float,
                     win_bytes: int) -> list[tuple[int, int]]:
    """Greedy online clustering of per-window feature rows into
    <= MAX_TYPES centroids -> [(start_offset, type)] with
    first-appearance renumbering (the literal splitter's algorithm,
    factored for the cmd/dist streams)."""
    centroids: list[np.ndarray] = []
    counts: list[int] = []
    labels = np.zeros(len(feats), np.int32)
    for i, f in enumerate(feats):
        if centroids:
            d = [float(np.abs(f - c).sum()) for c in centroids]
            j = int(np.argmin(d))
        else:
            d, j = [thresh + 1], 0
        if d[j] > thresh and len(centroids) < MAX_TYPES:
            centroids.append(f.copy())
            counts.append(1)
            j = len(centroids) - 1
        else:
            counts[j] += 1
            centroids[j] += (f - centroids[j]) / counts[j]
        labels[i] = j
    segs: list[list[int]] = []
    for i, lab in enumerate(labels):
        if segs and segs[-1][1] == lab:
            continue
        start = i * win_bytes
        if segs and start - segs[-1][0] < MIN_SEG:
            continue
        segs.append([start, int(lab)])
    remap: dict[int, int] = {}
    out = []
    for start, lab in segs:
        t = remap.setdefault(lab, len(remap))
        if out and out[-1][1] == t:
            continue
        out.append((start, t))
    return out


def segment_commands(raw: bytes, commands) -> tuple[list, list]:
    """(cmd_segments, dist_segments) — block splits for the command and
    distance streams, from the parsed commands' own statistics (the
    reference inherits 3-family splits from brotli,
    the reference's src/codec/block_type.rs:18-195; here each family
    clusters its own feature windows).

    Command features per window: histogram of (copy-length bucket,
    literal-run bucket); distance features: histogram of
    bitlen(distance) buckets.  Windows are raw-position aligned so
    switches land at stable offsets."""
    from . import commands as cmds
    n = len(raw)
    if n < 2 * MIN_SEG:
        return [(0, 0)], [(0, 0)]
    nwin = max(1, n // WIN)
    fc = np.zeros((nwin, 8), np.float64)    # copy-len + lit-run buckets
    fd = np.zeros((nwin, 8), np.float64)    # distance bitlen buckets
    pos = 0
    for c in commands:
        w = min(pos // WIN, nwin - 1)
        if isinstance(c, cmds.Literal):
            fc[w, 4 + min(3, len(c.data).bit_length() // 4)] += 1
            pos += len(c.data)
        elif isinstance(c, cmds.Copy):
            fc[w, min(3, c.num_bytes.bit_length() // 4)] += 1
            fd[w, min(7, c.distance.bit_length() // 3)] += 1
            pos += c.num_bytes
        elif isinstance(c, cmds.Dict):
            pos += c.final_size
    for f in (fc, fd):
        tot = f.sum(axis=1, keepdims=True)
        f /= np.maximum(tot, 1)
    # cmd/dist histograms vary more window-to-window than byte-class
    # fractions: 0.8 keeps homogeneous text at one segment while the
    # heterogeneous fixture still splits 4-5 ways (threshold probe,
    # PERF_NOTES round 5)
    return (_cluster_windows(fc, 0.8, WIN),
            _cluster_windows(fd, 0.8, WIN))


def inject_switches(raw: bytes, commands: list, segments, options,
                    cmd_segs=None, dist_segs=None) -> list:
    """Post-pass over the matcher's command list: split literal runs at
    segment boundaries and insert BlockSwitchLiteral commands; replaces
    the PredictionMode header with the nb-type variant.  When cmd/dist
    segment lists are given (segment_commands), the corresponding
    BlockSwitchCommand / BlockSwitchDistance commands are emitted at
    their own boundaries (the reference's 3-family splits,
    block_type.rs:18-195) — the copy/distance priors are keyed by those
    types (engine_np.code_copy ctype / model.get_distance_prior)."""
    from . import commands as cmds
    have_lit = len(segments) >= 2
    have_cmd = cmd_segs is not None and len(cmd_segs) >= 2
    have_dist = dist_segs is not None and len(dist_segs) >= 2
    if not (have_lit or have_cmd or have_dist):
        return commands
    nb = max(t for _, t in segments) + 1
    assert isinstance(commands[0], cmds.PredictionMode)
    out: list = [prediction_mode_for(nb, options,
                                     per_type_strides(raw, segments))]
    end = (len(raw) + 1, -1)
    bounds = list(segments[1:]) + [end]
    cbounds = (list(cmd_segs[1:]) if have_cmd else []) + [end]
    dbounds = (list(dist_segs[1:]) if have_dist else []) + [end]
    si = ci = di = 0
    pos = 0

    def maybe_switch(p: int) -> None:
        nonlocal si, ci, di
        while p >= bounds[si][0]:
            out.append(cmds.BlockSwitchLiteral(block_type=bounds[si][1]))
            si += 1
        while p >= cbounds[ci][0]:
            out.append(cmds.BlockSwitchCommand(block_type=cbounds[ci][1]))
            ci += 1
        while p >= dbounds[di][0]:
            out.append(cmds.BlockSwitchDistance(block_type=dbounds[di][1]))
            di += 1

    for cmd in commands[1:]:
        if isinstance(cmd, cmds.Literal):
            data = cmd.data
            off = 0
            while off < len(data):
                maybe_switch(pos + off)
                take = min(len(data) - off, bounds[si][0] - (pos + off))
                out.append(cmds.Literal(data[off:off + take]))
                off += take
            pos += len(data)
        else:
            maybe_switch(pos)
            out.append(cmd)
            if isinstance(cmd, cmds.Copy):
                pos += cmd.num_bytes
            elif isinstance(cmd, cmds.Dict):
                pos += cmd.final_size
    return out
