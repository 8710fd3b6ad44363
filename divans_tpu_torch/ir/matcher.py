"""LZ matcher: raw bytes -> command IR.

A port of divans_tpu/ir/matcher.py (whose module notes are normative).
By quality:
  * <= 9: the hash-chain greedy matcher with one-step lazy evaluation
    (_find_matches_greedy, Python, as the reference's build_commands
    runs it; native.find_matches is its C twin);
  * 10: the cost-model optimal parse (native.find_matches_optimal);
  * 11: the optimal parse with static dictionary edges, measured
    against the greedy parse on each frame's first 96 KiB, then a
    greedy static-dictionary pass inside the literal runs.
build_commands then applies the options on the list: context-map
clustering (ir/cmaps), the IR optimizer (ir/optimize, levels 1 and 2),
block split (ir/blocks) and the prior-bitmask mask (ir/detect).  The
heavy parts run in the native library (native.dict_scan,
native.find_matches_optimal, native.find_matches, and the trace FSM and
stream coder that measure a parse); Python builds the dictionary index
once per process and assembles the command list.  Without the native
library, as in the reference: no optimal parse, so qualities 10 and 11
take the greedy parse (quality 11 skips the parse selection), and the
dictionary scan runs in Python (_dict_best_at at each position).

Emits [PredictionMode, (Literal | Copy | Dict | BlockSwitch*)...] for one
metablock.  The reference's environment knobs are module constants here,
at the reference's defaults.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

from .. import dictionary, native
from ..constants import LITERAL_PREDICTION_MODE_UTF8
from ..options import DivansOptions
from ..probability.speed import MUD, Speed
from . import commands as cmds

MIN_MATCH = 4
Q11_DEPTH = 256        # chain depth of the quality-11 parse
Q11_KCAND = 5          # its candidate frontier width
LIT_COST_SCALE16 = 0   # 0 = one calibrated literal cost per block
DICT_ALL_TR = False    # index every transform, not only _DICT_TTYPES
PARSE_MEASURE_CAP = 96 << 10   # bytes the parse selection measures
SPLIT_3FAMILY = False  # block split also segments commands and distances
_HASH_MUL = 0x1E35A7BD  # multiplicative hash of the greedy matcher

_DICT_LENGTHS = range(4, 25)   # word lengths indexed (all of RFC 7932)
# transform families put into the index: Identity, UppercaseFirst,
# OmitLast1/2, OmitFirst1
_DICT_TTYPES = (0, 10, 1, 2, 12)

_INDEX_LOCK = threading.Lock()
_DICT_INDEX: dict | None = None
_DICT_FLAT = None


def _dict_index() -> dict:
    """4-byte-prefix bucket -> [(output_bytes, word_size, word_id,
    transform)] for every indexed transform output of at least MIN_MATCH
    bytes, longest output first; the first (shortest word, then earliest
    transform) of equal outputs wins.  Built once per process."""
    global _DICT_INDEX
    if _DICT_INDEX is None:
        with _INDEX_LOCK:
            if _DICT_INDEX is None:
                _DICT_INDEX = _build_dict_index()
    return _DICT_INDEX


def _build_dict_index() -> dict:
    d = dictionary.load()
    by_out: dict[bytes, tuple[int, int, int]] = {}
    if d.available:
        tids = [tid for tid, (_p, tt, _s) in enumerate(d.transforms)
                if DICT_ALL_TR or tt in _DICT_TTYPES]
        for wlen in _DICT_LENGTHS:
            if not dictionary.DICT_BITS[wlen]:
                continue
            for wid in range(1 << dictionary.DICT_BITS[wlen]):
                for tid in tids:
                    out = d.transform_word(wlen, wid, tid)
                    if len(out) >= MIN_MATCH:
                        by_out.setdefault(out, (wlen, wid, tid))
    buckets: dict[int, list] = {}
    for out, val in by_out.items():
        buckets.setdefault(int.from_bytes(out[:4], "big"), []).append(
            (out, *val))
    for g in buckets:
        buckets[g].sort(key=lambda e: -len(e[0]))
    return buckets


def _dict_flat_index():
    """The bucket index flattened for native.dict_scan: (grams u32[G]
    sorted, bucket_off i32[G+1], out_blob bytes, ent_off, ent_len,
    ent_wlen, ent_wid, ent_tid i32[E], pref16 i32[65537] (the gram range
    of each high 16-bit prefix), p8, m8 u64[E] (each entry's first <= 8
    bytes big-endian, and their mask))."""
    global _DICT_FLAT
    if _DICT_FLAT is None:
        buckets = _dict_index()
        with _INDEX_LOCK:
            if _DICT_FLAT is None:
                _DICT_FLAT = _flatten(buckets)
    return _DICT_FLAT


def _flatten(buckets: dict):
    grams = np.sort(np.array(list(buckets.keys()), np.uint32))
    off = [0]
    blob = bytearray()
    eo, el, ew, ei, et = [], [], [], [], []
    for g in grams:
        for (out, wlen, wid, tid) in buckets[int(g)]:
            eo.append(len(blob))
            el.append(len(out))
            ew.append(wlen)
            ei.append(wid)
            et.append(tid)
            blob += out
        off.append(len(eo))
    pref16 = np.searchsorted(grams >> np.uint32(16),
                             np.arange(65537, dtype=np.uint32)).astype(
                                 np.int32)
    eo_a = np.array(eo, np.int32)
    el_a = np.array(el, np.int32)
    # first min(8, len) bytes of each entry as a big-endian u64, zero
    # padded, and the mask of those bytes
    k = np.arange(8)
    n8 = np.minimum(el_a, 8)[:, None]
    src = np.frombuffer(bytes(blob) + b"\0" * 8, np.uint8)
    byte = np.where(k < n8, src[eo_a[:, None] + k], 0).astype(np.uint64)
    shift = (8 * (7 - k)).astype(np.uint64)
    p8 = np.bitwise_or.reduce(byte << shift, axis=1)
    m8 = np.bitwise_or.reduce(np.where(k < n8, np.uint64(0xFF) << shift,
                                       np.uint64(0)), axis=1)
    return (np.ascontiguousarray(grams), np.array(off, np.int32),
            bytes(blob), eo_a, el_a, np.array(ew, np.int32),
            np.array(ei, np.int32), np.array(et, np.int32),
            np.ascontiguousarray(pref16), np.ascontiguousarray(p8),
            np.ascontiguousarray(m8))


def _dict_scan(data: bytes):
    """(out_len, ent_idx) i32[n]: the longest dictionary-transform output
    at every position (native.dict_scan; without the library the same
    scan in Python, _dict_best_at at each position)."""
    index = _dict_flat_index()
    res = native.dict_scan(data, index)
    if res is not None:
        return res
    n = len(data)
    out_len = np.zeros(max(1, n), np.int32)
    ent_idx = np.full(max(1, n), -1, np.int32)
    grams, boff = index[:2]
    if n < MIN_MATCH or grams.shape[0] == 0:
        return out_len[:n], ent_idx[:n]
    buckets = _dict_index()
    for i in range(n - 3):
        hit = _dict_best_at(data, i)
        if hit is not None:
            flen = hit[0]
            out_len[i] = flen
            # the entry id: its place in the flattened bucket
            g = int.from_bytes(data[i:i + 4], "big")
            base = int(boff[int(np.searchsorted(grams, g))])
            for k, e in enumerate(buckets[g]):
                if len(e[0]) == flen and data[i:i + flen] == e[0]:
                    ent_idx[i] = base + k
                    break
    return out_len, ent_idx


def _dict_best_at(data, i: int, limit: int | None = None):
    """The longest dictionary-transform output matching data[i:...] and
    ending by `limit` (default the end), as (final length, word size,
    word id, transform), or None."""
    if i + 4 > len(data):
        return None
    b = _dict_index().get(int.from_bytes(data[i:i + 4], "big"))
    if b is None:
        return None
    hi = len(data) if limit is None else limit
    for (out, wlen, wid, tid) in b:
        if i + len(out) <= hi and data[i:i + len(out)] == out:
            return (len(out), wlen, wid, tid)
    return None


_SCAN_CACHE = threading.local()


def _dict_scan_cached(raw: bytes):
    """One scan per block, shared by the parse's dictionary edges, the
    literal-run pass and command materialisation (per thread: the encode
    pool runs blocks concurrently)."""
    slot = getattr(_SCAN_CACHE, "slot", None)
    if slot is None or slot[0] is not raw:
        slot = (raw, _dict_scan(raw))
        _SCAN_CACHE.slot = slot
    return slot[1]


def default_prediction_mode(options: DivansOptions) -> cmds.PredictionMode:
    """The model header emitted per metablock."""
    if options.use_context_map:
        lcm = bytes(range(64))          # identity: full 6-bit context
        dcm = bytes([0, 1, 2, 3])       # identity: 4 copy-length buckets
    else:
        lcm = b""
        dcm = b""
    speeds = options.literal_adaptation or (MUD, MUD, Speed(8, 8192),
                                            Speed(8, 8192))
    # stride > 1: a constant mixing mask of 4 + stride - 1 selects the
    # stride prior for every literal
    mv = b""
    fs = options.force_stride_value
    if fs > 1:
        mv = bytes([4 + min(7, fs - 1)]) * cmds.NUM_MIXING_VALUES
    return cmds.PredictionMode(
        literal_prediction_mode=LITERAL_PREDICTION_MODE_UTF8,
        context_mixing=min(options.dynamic_context_mixing, 7) & 3,
        adv_context_map=0,
        prior_depth=options.prior_depth,
        speeds=tuple(speeds),
        literal_context_map=lcm,
        distance_context_map=dcm,
        mixing_values=mv,
    )


def find_matches_optimal(data: bytes, quality: int):
    """The cost-model optimal parse (quality >= 10) as a list of
    [position, distance, length] (distance 0 = a dictionary edge), or
    None for fewer than MIN_MATCH bytes or without the native library
    (the parse is native code only).  Quality 11 searches
    Q11_DEPTH-deep chains over a Q11_KCAND-entry frontier and adds the
    dictionary edges; quality 10 keeps the mechanical trace's parse
    (native.Q10_DEPTH, native.Q10_KCAND)."""
    if len(data) < MIN_MATCH or native.load() is None:
        return None
    if quality >= 11:
        dlen, dcost = _dict_candidate_arrays(data)
        res = native.find_matches_optimal(data, Q11_DEPTH, Q11_KCAND, dlen,
                                          dcost, LIT_COST_SCALE16)
    else:
        res = native.find_matches_optimal(data, native.Q10_DEPTH,
                                          native.Q10_KCAND,
                                          lit_scale16=LIT_COST_SCALE16)
    return res.tolist()


def _dict_candidate_arrays(data):
    """Per-position dictionary edge for the parse: (final length, cost in
    1/16 bits), 0 length = none.  Cost: the command nibble, size and
    transform overhead, and the word id at ~0.63 bits a bit."""
    n = len(data)
    dlen, ent_idx = _dict_scan_cached(data)
    ew = _dict_flat_index()[5]
    if ew.shape[0] == 0:      # no dictionary: no candidates
        return np.zeros(n, np.int32), np.zeros(n, np.int32)
    bits = np.asarray(dictionary.DICT_BITS, np.int32)
    wlen = np.where(ent_idx >= 0, ew[np.maximum(ent_idx, 0)], 4)
    dcost = np.where(dlen > 0, 80 + 10 * bits[wlen], 0).astype(np.int32)
    return dlen, dcost


def _dict_command_at(data, pos):
    """The dictionary candidate the parse chose at `pos` (the same scan)."""
    out_len, ent_idx = _dict_scan_cached(data)
    e = int(ent_idx[pos])
    if out_len[pos] > 0 and e >= 0:
        ew, ei, et = _dict_flat_index()[5:8]
        return cmds.Dict(word_size=int(ew[e]), word_id=int(ei[e]),
                         transform=int(et[e]), final_size=int(out_len[pos]))
    raise AssertionError(f"no dictionary candidate at {pos}")


def _commands_from_matches(data, matches, options):
    """matches -> [PredictionMode, Literal/Copy/Dict...] (no dictionary
    pass over the literal runs)."""
    out = [default_prediction_mode(options)]
    pos = 0
    for (mpos, dist, mlen) in matches:
        if mpos > pos:
            out.append(cmds.Literal(data[pos:mpos]))
        if dist == 0:
            out.append(_dict_command_at(data, mpos))
        else:
            out.append(cmds.Copy(distance=dist, num_bytes=mlen))
        pos = mpos + mlen
    if pos < len(data):
        out.append(cmds.Literal(data[pos:]))
    return out


def find_matches(data: bytes, quality: int) -> list:
    """[position, distance, length] rows sorted by position.  Quality 11
    takes the optimal parse with dictionary edges unless the greedy
    parse (native.find_matches) codes the frame's first
    PARSE_MEASURE_CAP bytes smaller; quality 10 takes the optimal parse;
    below 10, and at 10 and 11 without the native library (no optimal
    parse), the greedy matcher."""
    n = len(data)
    if n < MIN_MATCH:
        return []
    opt = find_matches_optimal(data, quality) if quality >= 10 else None
    if opt is None:
        return _find_matches_greedy(data, quality)
    if quality < 11:
        return opt
    greedy = native.find_matches(data, quality)
    greedy = (_find_matches_greedy(data, quality) if greedy is None
              else greedy.tolist())
    cap = min(n, PARSE_MEASURE_CAP)
    bo = _measured_total_bits(data[:cap], _clip_matches(opt, cap))
    bg = _measured_total_bits(data[:cap], _clip_matches(greedy, cap))
    if bo is not None and (bg is None or bo <= bg):
        return opt
    return greedy


def _hash4(data: bytes, i: int) -> int:
    v = int.from_bytes(data[i:i + 4], "little")
    return ((v * _HASH_MUL) & 0xFFFFFFFF) >> 17  # 15-bit bucket


def _match_len(data: bytes, a: int, b: int, limit: int) -> int:
    n = 0
    while b + n < limit and data[a + n] == data[b + n]:
        n += 1
    return n


def _find_matches_greedy(data: bytes, quality: int) -> list:
    """Greedy hash-chain matches with one-step lazy evaluation (quality
    >= 5) and backward extension over the pending literals; chain depth
    2^(quality - 4), capped at 64."""
    n = len(data)
    chains: dict[int, list[int]] = {}
    depth = max(1, min(64, 1 << max(0, quality - 4)))
    lazy = quality >= 5
    matches: list[tuple[int, int, int]] = []

    def best_at(i: int) -> tuple[int, int]:
        """(length, distance) of the best match at i, or (0, 0)."""
        if i + MIN_MATCH > n:
            return 0, 0
        cand = chains.get(_hash4(data, i))
        best_len, best_dist = 0, 0
        if cand:
            for j in reversed(cand[-depth:]):
                ln = _match_len(data, j, i, n)
                if ln > best_len or (ln == best_len and i - j < best_dist):
                    best_len, best_dist = ln, i - j
                    if ln >= 128:
                        break
        return (best_len, best_dist) if best_len >= MIN_MATCH else (0, 0)

    def insert(i: int) -> None:
        if i + 4 <= n:
            lst = chains.setdefault(_hash4(data, i), [])
            lst.append(i)
            if len(lst) > 4 * depth:
                del lst[:2 * depth]

    i = 0
    prev_end = 0
    while i + MIN_MATCH <= n:
        ln, d = best_at(i)
        if ln:
            if lazy and i + 1 + MIN_MATCH <= n:
                insert(i)
                l2, d2 = best_at(i + 1)
                if l2 > ln + 1:
                    i += 1  # defer: the literal byte joins the pending run
                    ln, d = l2, d2
            # backward extension: pending literal bytes that also match
            # at distance d join the copy
            s = i
            while s > prev_end and s > d and data[s - 1] == data[s - 1 - d]:
                s -= 1
            matches.append((s, d, ln + (i - s)))
            end = i + ln
            prev_end = end
            if lazy:
                step = max(1, ln // 8) if ln > 64 else 1
                j = i + 1
                while j < end:
                    insert(j)
                    j += step
            i = end
        else:
            insert(i)
            i += 1
    return matches


def _prefer_repeat_distances(data, matches):
    """Swap a copy's distance for a distance-LRU hit when the same bytes
    are there (an LRU mnemonic costs ~3 bits against 4 + 0.55 log2(d)
    for an explicit distance); the LRU is simulated as the codec keeps
    it (codec/model.py)."""
    out = []
    lru = [4, 11, 15, 16]
    for (pos, dist, length) in matches:
        best = dist
        if dist == 0:                 # dictionary edge, not a copy
            out.append((pos, dist, length))
            continue
        if dist not in lru:
            threshold_gain = 16 + 9 * dist.bit_length() - 48
            if threshold_gain > 0:
                for d in lru:
                    if d != dist and d <= pos \
                            and data[pos - d:pos - d + length] \
                            == data[pos:pos + length]:
                        best = d
                        break
        out.append((pos, best, length))
        if best != lru[0]:
            if best == lru[1]:
                lru[:2] = [best, lru[0]]
            elif best == lru[2]:
                lru[0], lru[1], lru[2] = best, lru[0], lru[1]
            else:
                lru[:] = [best] + lru[:3]
    return out


def _measured_costs(data, matches, lit16, dist16):
    """A parse's measured costs for a second parse: the literal rate and
    the per-bitlen distance costs (1/16 bits) of its replay under the
    deferred model (codec/deferred.replay_trace at chunk 256), or None
    outside the cm layout."""
    from ..codec import deferred as deferred_mod
    from ..codec import trace as trace_mod
    from ..codec.layout import ModelLayout, PROFILES

    try:
        opts = DivansOptions()
        layout = ModelLayout(PROFILES["cm"])
        commands = _commands_from_matches(data, matches, opts)
        tr, bounds = trace_mod.build_trace_with_bounds(
            data, commands, opts, layout)
        if tr.shape[0] == 0:
            return None
        _, freqs = deferred_mod.replay_trace(tr, 256)
        bits16 = (-np.log2(np.maximum(freqs, 1) / 32768.0) * 16)
        is_dist = np.zeros(layout.num_rows, bool)
        for seg in ("c_dmn", "c_dbeg", "c_dlast", "c_dmant"):
            off, shape = layout.segments[seg]
            is_dist[off:off + int(np.prod(shape))] = True
        lit_bits = bits16[tr[:, 2] == 1].sum()
        lit_bytes = sum(len(c.data) for c in commands
                        if isinstance(c, cmds.Literal))
        new_lit16 = int(lit_bits / lit_bytes) if lit_bytes >= 64 else lit16
        sums = np.zeros(33)
        cnts = np.zeros(33)
        for (a, b), c in zip(bounds, commands):
            if isinstance(c, cmds.Copy):
                rows = tr[a:b, 0]
                bl = c.distance.bit_length()
                sums[bl] += bits16[a:b][is_dist[rows]].sum()
                cnts[bl] += 1
        new_dist16 = np.array(dist16)
        for bl in range(33):
            if cnts[bl] >= 8:
                new_dist16[bl] = int(sums[bl] / cnts[bl])
        return max(new_lit16, 8), new_dist16
    except (KeyError, AssertionError):
        return None


def _clip_matches(matches, cap: int):
    """Matches restricted to data[:cap] (a straddling copy is cut; a
    straddling dictionary edge, whose size is fixed, is dropped)."""
    out = []
    for (pos, dist, length) in matches:
        if pos >= cap:
            break
        if pos + length > cap:
            if dist == 0 or cap - pos < MIN_MATCH:
                break
            out.append((pos, dist, cap - pos))
            break
        out.append((pos, dist, length))
    return out


def _measured_total_bits(data, matches):
    """Exact coded size of a parse in bits: both streams coded by the
    native coder (traced by the native FSM, or codec/trace where it
    refuses the list), under the default options, the unbucketed cm layout
    and chunk 256 (the reference measures under exactly these)."""
    from ..codec.layout import ModelLayout, PROFILES

    try:
        opts = DivansOptions()
        layout = ModelLayout(PROFILES["cm"])
        commands = _commands_from_matches(data, matches, opts)
    except (KeyError, AssertionError):
        return None
    tr = native.build_trace_cmds(data, commands, opts, layout)
    if tr is None:
        from ..codec import trace as trace_mod
        tr = trace_mod.build_trace(data, commands, opts, layout)
    cmd_b, lit_b = native.encode_streams(
        tr, layout.num_rows, 256, lit_base=layout.segments["lit_hi"][0])
    return 8.0 * (len(cmd_b) + len(lit_b))


def _dict_matches_in(raw: bytes, lo: int, hi: int) -> list:
    """Greedy static-dictionary matches inside the literal run [lo, hi):
    (position, (final length, word size, word id, transform)); a hit
    whose output crosses `hi` is skipped."""
    if not _dict_index():
        return []
    out_len, ent_idx = _dict_scan_cached(raw)
    ew, ei, et = _dict_flat_index()[5:8]
    out = []
    i = lo
    while i + MIN_MATCH <= hi:
        flen = int(out_len[i])
        if flen >= MIN_MATCH and i + flen <= hi:
            e = int(ent_idx[i])
            out.append((i, (flen, int(ew[e]), int(ei[e]), int(et[e]))))
            i += flen
        else:
            i += 1
    return out


def build_commands(raw: bytes, options: DivansOptions) -> list:
    """One metablock's command list under `options` (detection already
    resolved: ir/detect.apply_detection)."""
    out: list = [default_prediction_mode(options)]
    if (options.cmap_clustering and options.use_context_map
            and not options.block_split):
        # a data-adaptive literal context map
        from . import cmaps
        out[0] = dataclasses.replace(
            out[0], literal_context_map=cmaps.cluster_lcm(
                raw, max_clusters=options.cmap_clustering))
    matches = find_matches(raw, options.quality)
    use_dict = options.quality >= 11

    def emit_literal_run(lo: int, hi: int) -> None:
        pos = lo
        if use_dict:
            for (dpos, (flen, wlen, wid, tid)) in _dict_matches_in(raw, lo,
                                                                   hi):
                if dpos > pos:
                    out.append(cmds.Literal(raw[pos:dpos]))
                out.append(cmds.Dict(word_size=wlen, word_id=wid,
                                     transform=tid, final_size=flen))
                pos = dpos + flen
        if hi > pos:
            out.append(cmds.Literal(raw[pos:hi]))

    pos = 0
    for (mpos, dist, mlen) in matches:
        if mpos > pos:
            emit_literal_run(pos, mpos)
        if dist == 0:                 # dictionary edge chosen by the parse
            out.append(_dict_command_at(raw, mpos))
        else:
            out.append(cmds.Copy(distance=dist, num_bytes=mlen))
        pos = mpos + mlen
    if pos < len(raw):
        emit_literal_run(pos, len(raw))
    if options.divans_ir_optimizer >= 2:
        from .optimize import optimize_measured
        out = out[:1] + optimize_measured(raw, out[1:], options)
    elif options.divans_ir_optimizer:
        from .optimize import optimize
        out = out[:1] + optimize(raw, out[1:])
    if options.block_split and options.use_context_map:
        from . import blocks
        cseg = dseg = None
        if SPLIT_3FAMILY:
            cseg, dseg = blocks.segment_commands(raw, out)
        out = blocks.inject_switches(raw, out, blocks.segment(raw), options,
                                     cseg, dseg)
    elif (options.prior_bitmask_detection and options.use_context_map
          and not options.force_stride_value):
        from .detect import detect_prior_bitmask
        mv = detect_prior_bitmask(raw, options.prior_bitmask_detection)
        if mv is not None:
            out[0] = dataclasses.replace(out[0], mixing_values=mv)
    return out
