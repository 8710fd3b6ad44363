"""Deferred decode on the device: the port of the main path of
divans_tpu/codec/pallas_decode.py (`decompress_frames`).

Three stages, as in the reference:
  1. host C++ decodes each frame's command structure
     (native.decode_cmd_structure), on a thread pool;
  2. the device decodes every literal byte: 128 persistent worker lanes
     each work through a queue of literal sub-streams (pack_lane_queues);
     one launch of the CUDA kernel (lit_decode.decode_group) runs a whole
     lane group: per chunk the stream switch, the premix, the decode
     against the frozen model and the commit of the previous chunk's
     updates (the deferred profile's one-chunk lag);
  3. host C++ executes the command scripts (native.execute_script) into
     one preallocated output buffer, on a 2-thread finish pool.

The plain version of stage 2 (lit_decode.decode_group_plain) keeps the
commit in plain PyTorch on int32 tensors (codec/lit_model.py, shared
with the encode's literal model pass), as it was XLA (not Pallas) in
the reference.  Layout is natural: per lane, a model of 385 rebased
literal rows x 16 CDF entries ([B, R, 16]).
"""
from __future__ import annotations

import dataclasses
import heapq
import os
import time
from concurrent.futures import ThreadPoolExecutor, as_completed

import numpy as np
import torch

from .. import constants, cuda_build, native, tracelog
from ..options import DivansOptions
from . import deferred, engine_np, lit_decode, lit_model
from .deferred import SUB_LIT, lit_subs_split

LANES = 128
GROUP_CHUNKS = 128               # chunk slots per lane per issued group
N_FINISHERS = 2

# frames decoded by each path since the last reset: "device" = literals
# on the lane kernel, "host" = native serial decode, "golden" = the
# golden engine (a frame native code refuses, or a whole container the
# golden engine decodes: api.decompress)
STATS = {"device_frames": 0, "host_frames": 0, "golden_frames": 0}


def reset_stats() -> None:
    STATS.update(dict.fromkeys(STATS, 0))


def _stream_words(s: bytes) -> np.ndarray:
    """An ANS stream body (past the 4-byte state) as packed renorm words:
    the bytes read as little-endian int32 (two u16 words each)."""
    body = s[4:]
    pad = (-len(body)) % 4
    if pad:
        body = body + b"\0" * pad
    return np.frombuffer(body, dtype="<i4")


def lut_table() -> np.ndarray:
    """int32[512]: UTF8-mode lut0 ++ lut1."""
    mode = constants.LITERAL_PREDICTION_MODE_UTF8
    return np.concatenate([constants.literal_lut0(mode),
                           constants.literal_lut1(mode)]).astype(np.int32)


@dataclasses.dataclass
class LaneQueues:
    """Streams bin-packed onto lanes, all int32 numpy arrays: words [L,W]
    (each lane's streams' packed words back to back), counts [L]
    (streams per lane), and per queue position f and lane l: state0,
    n_lit, woff (word offset) [F,L], lcmap [F,L,64], spd [F,L,6]
    ((inc, lim) of speeds 0, 2, 3); luts [512]."""
    words: np.ndarray
    counts: np.ndarray
    state0: np.ndarray
    n_lit: np.ndarray
    woff: np.ndarray
    lcmap: np.ndarray
    spd: np.ndarray
    luts: np.ndarray

    def to(self, device) -> dict:
        return {f.name: torch.from_numpy(
                    np.ascontiguousarray(getattr(self, f.name))).to(device)
                for f in dataclasses.fields(self)}


def pack_lane_queues(lit_streams: list[bytes], n_lits: list[int],
                     lcmaps, speeds_list, chunk: int, lanes: int = LANES,
                     spread: int | None = None):
    """LPT bin-packing of literal streams onto `lanes` worker lanes
    (streams by chunk count, largest first, each to the least-loaded
    lane).  Zero-literal streams take no slot.  `spread` limits the
    packing to the first N lanes (tests force deep queues with it).
    Returns (LaneQueues, n_steps, placement): placement[i] = (lane,
    chunk offset) or None; n_steps = the longest lane's chunk count."""
    s_bytes = chunk // 2
    jobs = sorted(
        ((-(-n_lits[i] // s_bytes), i) for i in range(len(lit_streams))
         if n_lits[i] > 0), reverse=True)
    heap = [(0, l) for l in range(spread or lanes)]
    lane_jobs: list[list[int]] = [[] for _ in range(lanes)]
    loads = [0] * lanes
    for c, i in jobs:
        load, l = heapq.heappop(heap)
        lane_jobs[l].append(i)
        loads[l] = load + c
        heapq.heappush(heap, (load + c, l))
    # the queue depth and word columns keep the JAX package's padding
    # (pow2 depth, 2048-word columns), so both packings are equal arrays
    f_max = max(1, max(len(j) for j in lane_jobs))
    f_max = 1 << (f_max - 1).bit_length()
    state0 = np.zeros((f_max, lanes), np.int32)
    n_lit = np.zeros((f_max, lanes), np.int32)
    woff = np.zeros((f_max, lanes), np.int32)
    lcmap = np.zeros((f_max, lanes, 64), np.int32)
    spd = np.zeros((f_max, lanes, 6), np.int32)
    counts = np.zeros(lanes, np.int32)
    placement: list[tuple[int, int] | None] = [None] * len(lit_streams)
    lane_words: list[np.ndarray] = []
    for l, jl in enumerate(lane_jobs):
        segs, w_off, c_off = [], 0, 0
        for k, i in enumerate(jl):
            s = lit_streams[i]
            w = _stream_words(s)
            if len(s) >= 4:
                state0[k, l] = int.from_bytes(s[:4], "little")
            n_lit[k, l] = n_lits[i]
            woff[k, l] = w_off
            lcmap[k, l] = np.asarray(lcmaps[i], np.int32)[:64]
            sp = speeds_list[i]
            spd[k, l] = [sp[0].inc, sp[0].lim, sp[2].inc, sp[2].lim,
                         sp[3].inc, sp[3].lim]
            placement[i] = (l, c_off)
            segs.append(w)
            w_off += w.shape[0]
            c_off += -(-n_lits[i] // s_bytes)
        counts[l] = len(jl)
        lane_words.append(np.concatenate(segs) if segs
                          else np.zeros(0, np.int32))
    w_len = max(2, max(w.shape[0] for w in lane_words))
    w_len = -(-w_len // 2048) * 2048
    words = np.zeros((lanes, w_len), np.int32)
    for l, w in enumerate(lane_words):
        words[l, :w.shape[0]] = w
    n_steps = max(1, max(loads))
    return (LaneQueues(words, counts, state0, n_lit, woff, lcmap, spd,
                       lut_table()), n_steps, placement)


def _unpack6(packed: np.ndarray) -> np.ndarray:
    """Inverse of the JAX package's pack6 on the trailing axis."""
    p = np.asarray(packed, np.int64)[..., None]
    vals = (p >> (6 * np.arange(4))) & 63
    return vals.reshape(*packed.shape[:-1], -1).astype(np.int32)


def from_tpu_lane_arrays(arrays) -> LaneQueues:
    """The JAX package's pack_lane_queues arrays (TPU lane-minor layout,
    6-bit packed tables) as the port's LaneQueues."""
    words, counts, state0, n_lit_all, woff_all, lcmap_all, spd_all, luts = \
        [np.asarray(a) for a in arrays]
    lcmap = _unpack6(np.swapaxes(lcmap_all, 1, 2))        # [F, L, 64]
    return LaneQueues(words.astype(np.int32), counts.astype(np.int32),
                      state0.astype(np.int32), n_lit_all.astype(np.int32),
                      woff_all.astype(np.int32), lcmap,
                      spd_all.astype(np.int32), _unpack6(luts[:, 0]))


def from_tpu_lit_lanes(arrays) -> LaneQueues:
    """The JAX package's pack_lit_lanes arrays (states, words, n_lit
    [L], lcmap_t [16, L] and luts [128, 128] 6-bit packed, spd [L, 6];
    one stream a lane) as the port's LaneQueues with one queue entry a
    lane, as the reference's _decode_lit_scan wraps them (every lane's
    count 1, word offset 0)."""
    states, words, n_lit, lcmap_t, luts, spd = [np.asarray(a)
                                                for a in arrays]
    lanes = states.shape[0]
    return LaneQueues(words.astype(np.int32), np.ones(lanes, np.int32),
                      states.astype(np.int32)[None],
                      n_lit.astype(np.int32)[None],
                      np.zeros((1, lanes), np.int32),
                      _unpack6(lcmap_t.T)[None],
                      spd.astype(np.int32)[None], _unpack6(luts[:, 0]))


def lane_slice(queues: LaneQueues, lo: int, hi: int) -> LaneQueues:
    """Lanes [lo, hi) of the queues (the luts whole)."""
    return LaneQueues(queues.words[lo:hi], queues.counts[lo:hi],
                      queues.state0[:, lo:hi], queues.n_lit[:, lo:hi],
                      queues.woff[:, lo:hi], queues.lcmap[:, lo:hi],
                      queues.spd[:, lo:hi], queues.luts)


def group_inputs(queues: LaneQueues, chunk: int, layout, device):
    """A lane group's inputs to lit_decode.decode_group: (the queue
    tensors on `device`, perm int32[384], renorm passes a commit)."""
    dev = torch.device(device)
    perm = torch.from_numpy(lit_model.planes(layout)).to(dev)
    return (queues.to(dev), perm,
            lit_model.renorm_passes(queues.spd, chunk // 2))


@torch.inference_mode()
def decode_lanes(queues: LaneQueues, n_steps: int, chunk: int, layout,
                 device, timing: list | None = None):
    """Run `n_steps` chunks over every lane; returns the decoded bytes,
    uint8[L, n_steps * chunk//2] on `device` (a stream placed at chunk
    offset c starts at column c * chunk//2).

    The group is one lit_decode.decode_group call: one kernel launch on
    the card, the plain chunk loop on the CPU.  With `timing` (on the
    card), the group appends ((CUDA events before and after the launch),
    the host seconds spent issuing it)."""
    q, perm, n_pass = group_inputs(queues, chunk, layout, device)
    s = chunk // 2
    if timing is not None:
        t_host = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    out, _carry = lit_decode.decode_group(q, perm, n_pass, n_steps, s)
    if timing is not None:
        ev[1].record()
        timing.append((ev, time.perf_counter() - t_host))
    return out


def issue_lane_queues(queues: LaneQueues, n_steps: int, chunk: int, layout,
                      device, timing: list | None = None):
    """Decode one group of lanes and start the copy to the host: returns
    (host uint8 tensor, CUDA event or None).  On the card the copy goes
    to pinned memory without blocking; the event marks its end."""
    out = decode_lanes(queues, n_steps, chunk, layout, device, timing=timing)
    if out.device.type != "cuda":
        return out, None
    host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(out, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _host_decode(f, layout, chunk):
    """A frame outside the card's envelope, on the host: (raw bytes,
    "host") from the native serial decoder, or (raw bytes, "golden")
    from the golden engine for a frame native code refuses (the golden
    deferred decoder at chunk > 0, engine_np at chunk 0), as
    divans_tpu.native.decompress does.  A corrupt frame raises the
    golden engine's CodedError."""
    raw = native.decode_metablock(f.cmd, f.lit, f.raw_len,
                                  layout.profile.name != "stride", layout,
                                  chunk)
    if raw is not None:
        return raw, "host"
    opts = DivansOptions()
    with tracelog.span("decode/golden_fallback", bytes=f.raw_len):
        if chunk:
            raw = deferred.decode_metablock(f.cmd, f.lit, f.raw_len, opts,
                                            chunk)
        else:
            raw = engine_np.decode_metablock(f.cmd, f.lit, f.raw_len, opts)
    return raw, "golden"


def decode_structure(f, chunk: int, layout):
    """Stage 1 for one frame: its native command script, or None when the
    frame leaves the lane kernel's envelope (the mix/split/stride
    profiles, or a script the device cannot take)."""
    if layout.profile.name != "cm" or not layout.lo_bucketed:
        return None
    sc = native.decode_cmd_structure(f.cmd, f.raw_len, layout, chunk)
    return sc if sc is not None and sc.supported else None


def lane_jobs(frames, ready):
    """The lane jobs of one group: each literal sub-stream of a frame is
    one job.  ready: [(frame index, script)].  Returns (streams, n_lits,
    lcmaps, speeds, spans), the first four per job and spans[k] = (first
    job, job count) of ready[k]."""
    streams, n_lits, lcmaps, spds, spans = [], [], [], [], []
    for i, sc in ready:
        subs = lit_subs_split(frames[i].lit)
        spans.append((len(streams), len(subs)))
        for j, payload in enumerate(subs):
            streams.append(payload)
            n_lits.append(max(0, min(SUB_LIT, sc.lit_total - j * SUB_LIT)))
            lcmaps.append(sc.lcmap)
            spds.append(sc.speeds)
    return streams, n_lits, lcmaps, spds, spans


def decompress_frames(frames, chunk: int, layout, device,
                      timing: list | None = None) -> bytes:
    """Full deferred decode of a frame list on `device` (made the current
    device while the groups are issued).

    Pipelining: all frames' structure passes are queued on a thread pool
    at once; frames gather into GROUPS in script-arrival order, sized by
    literal chunk need (GROUP_CHUNKS per lane), and each group is issued
    as soon as it is full, while later groups' structure passes run.
    Kernel launches and tensor ops all come from this thread, on one
    stream.  Each group's finish (wait for its copy, reassemble the
    literals, execute the scripts) runs on a 2-thread pool.

    Frames outside the lane kernel's envelope (the mix/split/stride
    profiles, or a script the device cannot take) decode host-side
    through native.decode_metablock on the same pool.  `timing` is
    handed to decode_lanes (CUDA events around each group's launch)."""
    s_bytes = chunk // 2
    need_target = LANES * GROUP_CHUNKS

    def one(f):
        """("dev", script) for frames in the kernel envelope, else
        ("host" or "golden", raw bytes) decoded right here."""
        sc = decode_structure(f, chunk, layout)
        if sc is not None:
            return "dev", sc
        raw, kind = _host_decode(f, layout, chunk)
        return kind, raw

    offsets = np.zeros(len(frames) + 1, np.int64)
    np.cumsum([f.raw_len for f in frames], out=offsets[1:])
    out_buf = np.empty(int(offsets[-1]), np.uint8)

    def issue_group(ready):
        """ready: [(frame index, script)]."""
        streams, n_lits, lcmaps, spds, spans = lane_jobs(frames, ready)
        queues, n_steps, placement = pack_lane_queues(
            streams, n_lits, lcmaps, spds, chunk)
        host, event = issue_lane_queues(queues, n_steps, chunk, layout,
                                        device, timing)
        return ready, spans, n_lits, placement, host, event

    def finish_group(group):
        ready, spans, n_lits, placement, host, event = group
        if event is not None:
            event.synchronize()
        arr = host.numpy()
        for (i, sc), (off, k) in zip(ready, spans):
            lb = np.empty(sum(n_lits[off:off + k]), np.uint8)
            pos = 0
            for j in range(off, off + k):
                if placement[j] is None:
                    continue
                lane, c_off = placement[j]
                o = c_off * s_bytes
                lb[pos:pos + n_lits[j]] = arr[lane, o:o + n_lits[j]]
                pos += n_lits[j]
            native.execute_script(sc, lb,
                                  out=out_buf[offsets[i]:offsets[i + 1]])

    finish_futs = []
    n_workers = max(1, min(8, os.cpu_count() or 2))
    with tracelog.span("decode/device_pipeline", frames=len(frames)), \
            cuda_build.on_device(device), \
            ThreadPoolExecutor(n_workers) as ex, \
            ThreadPoolExecutor(N_FINISHERS) as finisher:
        futs = {ex.submit(one, frames[i]): i for i in range(len(frames))}
        ready: list = []
        need = 0
        for fut in as_completed(futs):
            kind, val = fut.result()
            i = futs[fut]
            STATS["device_frames" if kind == "dev" else f"{kind}_frames"] \
                += 1
            if kind != "dev":
                out_buf[offsets[i]:offsets[i + 1]] = np.frombuffer(val,
                                                                   np.uint8)
                continue
            ready.append((i, val))
            # SUB_LIT is a multiple of s_bytes: per-sub chunk ceils sum to
            # one ceil over the frame's literal total
            need += -(-val.lit_total // s_bytes)
            if need >= need_target:
                finish_futs.append(finisher.submit(finish_group,
                                                   issue_group(ready)))
                ready, need = [], 0
        if ready:
            finish_futs.append(finisher.submit(finish_group,
                                               issue_group(ready)))
    for fut in finish_futs:
        fut.result()
    return out_buf.tobytes()
