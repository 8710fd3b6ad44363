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
     one output buffer (the calling thread's, kept across calls), on a
     2-thread finish pool.

The frames go to the card in file order, so the lane groups, their
launches and the counters in STATS are a function of the container
alone, whichever pool thread finishes first.  The structure pool takes
the CPUs the process may run on (structure_workers).

Without the native library, stages 1 and 3 are the reference's golden
Python ones (deferred.decode_cmd_structure and deferred.execute_script,
on a CmdScript), stage 2 stays on the card, and frames outside the
kernel decode on the golden engine.

The plain version of stage 2 (lit_decode.decode_group_plain) keeps the
commit in plain PyTorch on int32 tensors (codec/lit_model.py, shared
with the encode's literal model pass), as it was XLA (not Pallas) in
the reference.  Layout is natural: per lane, a model of 385 rebased
literal rows x 16 CDF entries ([B, R, 16]).

The reference's opt-in routes are here too, off by default as there
(decompress_frames' keywords, or its environment variables): the segment
pipeline over a ResumableLaneDecoder (kernel 1 resumed from each lane's
carry), the backlog split to the host, and wider groups (qpl).  So are
its last public functions: decode_structures, decode_literals_batch and
the numpy oracle decode_literals_np.
"""
from __future__ import annotations

import dataclasses
import heapq
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor, as_completed

import numpy as np
import torch

from .. import constants, cuda_build, native, tracelog
from ..ans.coder_np import ANSDecoder
from ..options import DivansOptions
from ..probability import scalar
from . import deferred, engine_np, lit_decode, lit_model
from ..errors import CorruptStream, ErrCode
from .deferred import SUB_LIT, lit_subs_split

LANES = 128
GROUP_CHUNKS = 128               # chunk slots per lane per issued group
N_FINISHERS = 2
SEG_STEPS = 192                  # chunks a segment of the resumable route

# frames decoded by each path since the last reset: "device" = literals
# on the lane kernel, "host" = native serial decode, "golden" = the
# golden engine (a frame native code refuses, or a whole container the
# golden engine decodes: api.decompress); and the grouped pipeline's
# kernel-1 launches ("groups"), the chunks their lanes decode
# ("lane_chunks") and the chunk slots they run, a group's lanes times its
# longest lane's chunks ("slot_chunks")
STATS = {"device_frames": 0, "host_frames": 0, "golden_frames": 0,
         "groups": 0, "lane_chunks": 0, "slot_chunks": 0}


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


def _spd6(speeds) -> list[int]:
    """A stream's (inc, lim) of speeds 0, 2 and 3, as the kernel takes
    them."""
    return [speeds[0].inc, speeds[0].lim, speeds[2].inc, speeds[2].lim,
            speeds[3].inc, speeds[3].lim]


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
            spd[k, l] = _spd6(speeds_list[i])
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


def _timed(launch, timing: list | None):
    """Run `launch`; with `timing` (on the card) append ((CUDA events
    before and after it), the host seconds spent issuing it)."""
    if timing is None:
        return launch()
    t_host = time.perf_counter()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    res = launch()
    ev[1].record()
    timing.append((ev, time.perf_counter() - t_host))
    return res


def _to_host(out: torch.Tensor):
    """(host uint8 tensor, CUDA event or None): on the card the copy goes
    to pinned memory without blocking; the event marks its end."""
    if out.device.type != "cuda":
        return out, None
    host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(out, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


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
    out, _carry = _timed(lambda: lit_decode.decode_group(
        q, perm, n_pass, n_steps, chunk // 2), timing)
    return out


def issue_lane_queues(queues: LaneQueues, n_steps: int, chunk: int, layout,
                      device, timing: list | None = None):
    """Decode one group of lanes and start the copy to the host: returns
    (host uint8 tensor, CUDA event or None)."""
    return _to_host(decode_lanes(queues, n_steps, chunk, layout, device,
                                 timing=timing))


def decode_literals_batch(lit_streams: list[bytes], n_lits: list[int],
                          lcmaps, speeds_list, chunk: int, layout,
                          device) -> list[bytes]:
    """Decode up to LANES literal streams on `device`, one stream a lane
    (pack_lane_queues, then decode_lanes): each stream's bytes, equal to
    decode_literals_np's."""
    if len(lit_streams) > LANES:
        raise ValueError(f"{len(lit_streams)} streams, at most {LANES}")
    queues, n_steps, placement = pack_lane_queues(
        lit_streams, n_lits, lcmaps, speeds_list, chunk)
    out = decode_lanes(queues, n_steps, chunk, layout, device).cpu().numpy()
    return [b"" if p is None else out[p[0], :n].tobytes()
            for p, n in zip(placement, n_lits)]


class ResumableLaneDecoder:
    """Persistent queue lanes across launches (the port of the reference's
    ResumableLaneDecoder, divans_tpu/codec/pallas_decode.py:990-1171).

    Every lane's carry (model, mixer, pend, ANS state, cursor, queue
    position) stays on `device` between segments, so a 32 KiB sub-stream
    can span launches and streams are added between them.  Each lane
    consumes one chunk a step and switches to its next stream when the
    current one is exhausted, so the host replays the schedule exactly
    (the twin in `_advance`) and knows where each stream's chunks land,
    with no feedback from the card."""

    def __init__(self, chunk: int, layout, device, lanes: int = LANES):
        self.chunk = chunk
        self.s_bytes = chunk // 2
        self.lanes = lanes
        self.device = torch.device(device)
        self.perm = torch.from_numpy(lit_model.planes(layout)).to(self.device)
        self.luts = torch.from_numpy(lut_table()).to(self.device)
        # per lane: [state0, n_lit, woff (None until uploaded), lcmap[64],
        # speeds (inc, lim of 0, 2, 3)]; a stream's words are contiguous,
        # a lane's streams need not be
        self.rows: list[list] = [[] for _ in range(lanes)]
        self.backlog = [0] * lanes          # unconsumed chunks a lane
        self.words: torch.Tensor | None = None   # [lanes, W], appended to
        self.pending_words: list = []       # (lane, row, words)
        self.sim_fidx = [-1] * lanes
        self.sim_rem = [0] * lanes
        self.gstep = 0
        self.start_step: dict = {}          # (lane, row) -> its first step
        self.carry: dict | None = None
        self._heap = [(0, l) for l in range(lanes)]

    def add_stream(self, payload: bytes, n_lit: int, lcmap, speeds):
        """Queue a stream on the least-backlogged lane (LPT); returns its
        (lane, row) key, the id of segment()'s placements, or None for
        an empty stream or n_lit <= 0 (a corrupt container may declare
        more sub-streams than its literals cover: the frame then decodes
        short and fails its script's length check)."""
        chunks = -(-n_lit // self.s_bytes) if n_lit > 0 else 0
        if chunks == 0:
            return None
        load, l = heapq.heappop(self._heap)
        state0 = int.from_bytes(payload[:4], "little") \
            if len(payload) >= 4 else 0
        key = (l, len(self.rows[l]))
        self.rows[l].append([state0, n_lit, None,
                             np.asarray(lcmap, np.int32)[:64],
                             _spd6(speeds)])
        self.pending_words.append((l, key[1], _stream_words(payload)))
        self.backlog[l] += chunks
        heapq.heappush(self._heap, (load + chunks, l))
        return key

    def pending_chunks(self) -> int:
        return sum(self.backlog)

    def max_backlog(self) -> int:
        return max(self.backlog) if self.backlog else 0

    def _upload_delta(self) -> None:
        """Append the new streams' words to the device buffer (in whole
        2048-word columns, so carried cursors stay valid) and set their
        word offsets."""
        if not self.pending_words:
            return
        per_lane: dict = {}
        for l, ri, w in self.pending_words:
            per_lane.setdefault(l, []).append((ri, w))
        delta_w = max(sum(w.shape[0] for _ri, w in v)
                      for v in per_lane.values())
        delta_w = -(-max(delta_w, 2) // 2048) * 2048
        delta = np.zeros((self.lanes, delta_w), np.int32)
        w_dev = 0 if self.words is None else self.words.shape[1]
        for l, v in per_lane.items():
            pos = 0
            for ri, w in v:
                self.rows[l][ri][2] = w_dev + pos
                delta[l, pos:pos + w.shape[0]] = w
                pos += w.shape[0]
        dd = torch.from_numpy(delta).to(self.device)
        self.words = dd if self.words is None \
            else torch.cat([self.words, dd], dim=1)
        self.pending_words = []

    def _arrays(self):
        """The queue tables over every row, rebuilt (a few KB; pow2 depth
        as pack_lane_queues pads), and the renorm passes a commit over
        every row's speeds."""
        f_max = max(1, max(len(r) for r in self.rows))
        f_max = 1 << (f_max - 1).bit_length()
        t = {"counts": np.zeros(self.lanes, np.int32),
             "state0": np.zeros((f_max, self.lanes), np.int32),
             "n_lit": np.zeros((f_max, self.lanes), np.int32),
             "woff": np.zeros((f_max, self.lanes), np.int32),
             "lcmap": np.zeros((f_max, self.lanes, 64), np.int32),
             "spd": np.zeros((f_max, self.lanes, 6), np.int32)}
        for l, rws in enumerate(self.rows):
            t["counts"][l] = len(rws)
            for k, (st, nl, wo, lc, sp) in enumerate(rws):
                t["state0"][k, l] = st
                t["n_lit"][k, l] = nl
                t["woff"][k, l] = wo
                t["lcmap"][k, l] = lc
                t["spd"][k, l] = sp
        return t, lit_model.renorm_passes(t["spd"], self.s_bytes)

    @torch.inference_mode()
    def segment(self, n_steps: int, timing: list | None = None):
        """Launch one segment of n_steps chunks (from idle_carry the first
        time, from the last carry after that), start its copy to the host
        and advance the host twin.  Returns (host uint8 tensor [lanes,
        n_steps * s], CUDA event or None, placements): placements[key] =
        [(chunk in the stream, step in this segment, chunks)], one run a
        stream a segment.  A failed launch raises."""
        self._upload_delta()
        if self.words is None:
            raise ValueError("segment() before any stream was added")
        tables, n_pass = self._arrays()
        with tracelog.span("decode/segment", n_steps=n_steps), \
                cuda_build.on_device(self.device):
            q = {"words": self.words, "luts": self.luts,
                 **{k: torch.from_numpy(v).to(self.device)
                    for k, v in tables.items()}}
            if self.carry is None:
                self.carry = lit_decode.idle_carry(self.lanes, self.device)
            out, self.carry = _timed(lambda: lit_decode.decode_group(
                q, self.perm, n_pass, n_steps, self.s_bytes,
                carry=self.carry), timing)
            host, event = _to_host(out)
        return host, event, self._advance(n_steps)

    def _advance(self, n_steps: int) -> dict:
        """The host twin of the kernel's queue logic over n_steps: a lane
        works one stream on consecutive steps until it is exhausted, so
        each (stream, segment) is one run."""
        placements: dict = {}
        for l in range(self.lanes):
            rws = self.rows[l]
            fidx, rem = self.sim_fidx[l], self.sim_rem[l]
            t = 0
            while t < n_steps:
                if rem <= 0:
                    if fidx + 1 >= len(rws):
                        break                   # idle to the segment's end
                    fidx += 1
                    rem = rws[fidx][1]
                    self.start_step[(l, fidx)] = self.gstep + t
                n_here = min(n_steps - t, -(-rem // self.s_bytes))
                key = (l, fidx)
                ci = self.gstep + t - self.start_step[key]
                placements.setdefault(key, []).append((ci, t, n_here))
                self.backlog[l] -= n_here
                rem -= n_here * self.s_bytes
                t += n_here
            self.sim_fidx[l], self.sim_rem[l] = fidx, rem
        self.gstep += n_steps
        return placements


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


def _structure(f, chunk: int, layout):
    """One frame's command script: native.decode_cmd_structure's, or
    without the library the golden pass's (deferred.decode_cmd_structure,
    a CmdScript), as the reference's decode falls back; None where native
    code refuses the frame (it then decodes on the host)."""
    if native.load() is None:
        return deferred.decode_cmd_structure(f.cmd, f.raw_len,
                                             DivansOptions(), chunk)
    return native.decode_cmd_structure(f.cmd, f.raw_len, layout, chunk)


def decode_structure(f, chunk: int, layout):
    """Stage 1 for one frame: its command script (_structure), or None
    when the frame leaves the lane kernel's envelope (the mix/split/stride
    profiles, or a script the device cannot take)."""
    if layout.profile.name != "cm" or not layout.lo_bucketed:
        return None
    sc = _structure(f, chunk, layout)
    return sc if sc is not None and sc.supported else None


def execute(script, lit_bytes, out: np.ndarray) -> None:
    """Stage 3 for one frame: its script run over its decoded literals
    into `out`, the frame's uint8 slice of the output (native code for a
    NativeScript, deferred.execute_script for a CmdScript, as the
    reference's _execute dispatches).  A script that does not fill its
    frame exactly raises CorruptStream."""
    if isinstance(script, native.NativeScript):
        native.execute_script(script, lit_bytes, out=out)
        return
    raw = deferred.execute_script(script, bytes(lit_bytes))
    if len(raw) != out.size:
        raise CorruptStream("script execution failed",
                            ErrCode.SCRIPT_FAILED)
    out[:] = np.frombuffer(raw, np.uint8)


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


def decode_structures(frames, chunk: int, layout) -> list | None:
    """Stage 1 over a frame list: each frame's command script
    (_structure: native, or the golden pass without the library), or
    None when a frame leaves the lane kernel's envelope.  The native pass
    runs on a thread pool (ctypes releases the interpreter lock), the
    golden one in turn."""
    def one(f):
        return _structure(f, chunk, layout)

    if len(frames) > 1 and native.load() is not None:
        with ThreadPoolExecutor(structure_workers()) as ex:
            scripts = list(ex.map(one, frames))
    else:
        scripts = [one(f) for f in frames]
    if not all(sc is not None and sc.supported for sc in scripts):
        return None
    return scripts


def structure_workers() -> int:
    """The grouped pipeline's default structure pool: a thread for each
    CPU the process may use (its affinity mask), 1 to 8.  The structure
    passes are most of a call's work (~7-9 ms of native code a 256 KiB
    frame); the issuing thread and the finishers mostly wait (for a
    script, for the card), so they get no cores of their own: on an
    8-core H100 host, decoding a 48 MiB container in turns, 5 workers
    took 24 % longer a call than 8, and 7 took 2.5 % longer."""
    return max(1, min(8, len(os.sched_getaffinity(0))))


_local = threading.local()


def _out_buffer(n: int) -> np.ndarray:
    """uint8[n]: the front of this thread's output buffer, grown to its
    largest call and kept after it (a fresh 48 MiB array a call paid its
    page faults, and its unmapping, every call).  Each call returns a
    copy (`tobytes`), and its pools are joined before it returns, so no
    writer outlives the call."""
    buf = getattr(_local, "out", None)
    if buf is None or buf.size < n:
        buf = _local.out = np.empty(n, np.uint8)
    return buf[:n]


def _setting(value, name: str, default: int) -> int:
    """A route setting: the keyword when given, else the reference's
    environment variable of that name, read now, else its default."""
    return int(os.environ.get(name, default)) if value is None else value


def decompress_frames(frames, chunk: int, layout, device,
                      timing: list | None = None, *, resume=None,
                      backlog=None, qpl=None, group_chunks=None,
                      workers=None, finishers=None, seg_steps=None,
                      seg_chunks=None) -> bytes:
    """Full deferred decode of a frame list on `device` (made the current
    device while the groups are issued).

    Pipelining: all frames' structure passes are queued on a thread pool
    at once; this thread takes their scripts in file order, so frames
    gather into GROUPS of consecutive frames, sized by literal chunk need
    (GROUP_CHUNKS per lane), and each group is issued as soon as it is
    full, while later groups' structure passes run.  The groups, their
    lanes and their launches are thus the same on every call of one
    container.  Kernel launches and tensor ops all come from this
    thread, on one stream.  Each group's finish (wait for its copy,
    gather each frame's literals, execute the scripts) runs on a
    2-thread pool.  The structure pool takes the CPUs the process may
    use, its affinity mask (structure_workers).

    Spans (tracelog): decode/device_pipeline over decode/structure (a
    frame, on the structure pool), decode/group_issue (the lane jobs,
    their packing, the upload and kernel 1's enqueue) and, on the finish
    pool, decode/group_finish over decode/group_wait (the copy's
    event), decode/lit_gather and decode/execute (a frame each).  STATS
    counts the groups, the chunks their lanes decode and the chunk slots
    they run.

    Frames outside the lane kernel's envelope (the mix/split/stride
    profiles, or a script the device cannot take) decode host-side
    through native.decode_metablock on the same pool.  `timing` is
    handed to decode_lanes (CUDA events around each group's launch, or
    each segment's).

    The reference's opt-in routes, each a keyword; a keyword left None
    reads the reference's environment variable at call time, else takes
    its default (so with none set this is the grouped pipeline above):
      resume (DIVANS_DEC_RESUME=1): the segment pipeline (one
        ResumableLaneDecoder over the container), cm bucketed only;
      backlog (DIVANS_DEC_BACKLOG, default off): a frame decodes on the
        host while `backlog` groups are in flight (0: every frame);
      qpl (DIVANS_DEC_QPL, 1): qpl * LANES lanes a group or segment (on
        the card more blocks; the reference interleaved queues a lane);
      group_chunks (DIVANS_DEC_GROUP_CHUNKS, 128): chunk slots per lane
        a group; workers (DIVANS_DEC_WORKERS, structure_workers()) and
        finishers (DIVANS_DEC_FINISHERS, 2): the pools' threads;
      seg_steps (DIVANS_DEC_SEG_STEPS, 192): the steps of a segment;
        seg_chunks (DIVANS_DEC_SEG_CHUNKS, seg_steps): a segment
        launches once lanes * seg_chunks chunks are pending."""
    if resume is None:
        resume = os.environ.get("DIVANS_DEC_RESUME") == "1"
    backlog = _setting(backlog, "DIVANS_DEC_BACKLOG", 999999)
    lanes = _setting(qpl, "DIVANS_DEC_QPL", 1) * LANES
    if lanes < LANES:
        raise ValueError(f"qpl must be at least 1, got {lanes // LANES}")
    need_target = lanes * _setting(group_chunks, "DIVANS_DEC_GROUP_CHUNKS",
                                   GROUP_CHUNKS)
    n_workers = _setting(workers, "DIVANS_DEC_WORKERS", structure_workers())
    n_finish = _setting(finishers, "DIVANS_DEC_FINISHERS", N_FINISHERS)
    s_bytes = chunk // 2
    inflight = [0]           # groups issued and not yet copied back
    inflight_lock = threading.Lock()

    def one(f):
        """("dev", script) for frames in the kernel envelope, else
        ("host" or "golden", raw bytes) decoded right here; with `backlog`
        groups in flight every frame decodes here (with the native
        library only, as in the reference)."""
        if inflight[0] < backlog or native.load() is None:
            with tracelog.span("decode/structure", bytes=f.raw_len):
                sc = decode_structure(f, chunk, layout)
            if sc is not None:
                return "dev", sc
        raw, kind = _host_decode(f, layout, chunk)
        return kind, raw

    offsets = np.zeros(len(frames) + 1, np.int64)
    np.cumsum([f.raw_len for f in frames], out=offsets[1:])
    out_buf = _out_buffer(int(offsets[-1]))

    def arrived(i, kind, val) -> bool:
        """Count frame i's path; store a host-decoded frame.  True when
        its script goes to the card."""
        STATS["device_frames" if kind == "dev" else f"{kind}_frames"] += 1
        if kind != "dev":
            out_buf[offsets[i]:offsets[i + 1]] = np.frombuffer(val, np.uint8)
        return kind == "dev"

    if resume and layout.profile.name == "cm" and layout.lo_bucketed:
        seg_steps = _setting(seg_steps, "DIVANS_DEC_SEG_STEPS", SEG_STEPS)
        seg_chunks = _setting(seg_chunks, "DIVANS_DEC_SEG_CHUNKS", seg_steps)
        # a segment must consume chunks, or the pipeline would not end
        if seg_steps < 1 or seg_chunks < 1:
            raise ValueError(f"seg_steps and seg_chunks must be at least "
                             f"1, got {seg_steps} and {seg_chunks}")
        _decompress_frames_resumable(
            frames, chunk, layout, device, one, arrived, out_buf, offsets,
            ResumableLaneDecoder(chunk, layout, device, lanes), n_workers,
            n_finish, seg_steps, lanes * seg_chunks, timing)
        return out_buf.tobytes()

    def issue_group(ready):
        """ready: [(frame index, script)]."""
        with tracelog.span("decode/group_issue") as meta:
            streams, n_lits, lcmaps, spds, spans = lane_jobs(frames, ready)
            queues, n_steps, placement = pack_lane_queues(
                streams, n_lits, lcmaps, spds, chunk, lanes=lanes)
            host, event = issue_lane_queues(queues, n_steps, chunk, layout,
                                            device, timing)
            if meta is not None:
                meta.update(lanes=int((queues.counts > 0).sum()),
                            chunks=n_steps)
        STATS["groups"] += 1
        STATS["lane_chunks"] += sum(-(-n // s_bytes) for n in n_lits)
        STATS["slot_chunks"] += lanes * n_steps
        with inflight_lock:
            inflight[0] += 1
        return ready, spans, n_lits, placement, host, event

    def finish_group(group):
        ready, spans, n_lits, placement, host, event = group
        with tracelog.span("decode/group_finish", frames=len(ready)):
            # the count drops even if the wait raises, or the backlog
            # split would stay on for the rest of the call
            try:
                with tracelog.span("decode/group_wait"):
                    if event is not None:
                        event.synchronize()
            finally:
                with inflight_lock:
                    inflight[0] -= 1
            arr = host.numpy()
            for (i, sc), (off, k) in zip(ready, spans):
                with tracelog.span("decode/lit_gather"):
                    lb = np.empty(sum(n_lits[off:off + k]), np.uint8)
                    pos = 0
                    for j in range(off, off + k):
                        if placement[j] is None:
                            continue
                        lane, c_off = placement[j]
                        o = c_off * s_bytes
                        lb[pos:pos + n_lits[j]] = arr[lane, o:o + n_lits[j]]
                        pos += n_lits[j]
                with tracelog.span("decode/execute",
                                   bytes=int(offsets[i + 1] - offsets[i])):
                    execute(sc, lb, out_buf[offsets[i]:offsets[i + 1]])

    finish_futs = []
    with tracelog.span("decode/device_pipeline", frames=len(frames)), \
            cuda_build.on_device(device), \
            ThreadPoolExecutor(n_workers) as ex, \
            ThreadPoolExecutor(n_finish) as finisher:
        job = tracelog.bound(one)
        finish = tracelog.bound(finish_group)
        futs = [ex.submit(job, f) for f in frames]
        ready: list = []
        need = 0
        # in file order: the groups do not depend on which worker
        # finishes first
        for i, fut in enumerate(futs):
            kind, val = fut.result()
            if not arrived(i, kind, val):
                continue
            ready.append((i, val))
            # SUB_LIT is a multiple of s_bytes: per-sub chunk ceils sum to
            # one ceil over the frame's literal total
            need += -(-val.lit_total // s_bytes)
            if need >= need_target:
                finish_futs.append(finisher.submit(finish,
                                                   issue_group(ready)))
                ready, need = [], 0
        if ready:
            finish_futs.append(finisher.submit(finish, issue_group(ready)))
    for fut in finish_futs:
        fut.result()
    return out_buf.tobytes()


def _decompress_frames_resumable(frames, chunk: int, layout, device, one,
                                 arrived, out_buf, offsets, dec, n_workers,
                                 n_finish, seg_steps: int, seg_need: int,
                                 timing) -> None:
    """The segment pipeline (the reference's _decompress_frames_resumable,
    pallas_decode.py:1186-1281): one ResumableLaneDecoder spans the
    container, each frame's sub-streams join its queues as its script
    arrives, and a segment of seg_steps launches whenever seg_need chunks
    are pending, then more until none is.  Each segment's finish runs on
    the finish pool; a frame executes into its slice of out_buf once its
    last stream is done, a frame without literals at once."""
    s_bytes = chunk // 2
    stream_buf: dict = {}     # key -> the stream's bytes
    stream_left: dict = {}    # key -> chunks outstanding
    stream_frame: dict = {}   # key -> frame index
    frame_left: dict = {}     # frame index -> streams outstanding
    frame_keys: dict = {}
    scripts: dict = {}
    lock = threading.Lock()

    def finish_seg(seg):
        host, event, placements = seg
        if event is not None:
            event.synchronize()
        arr = host.numpy()
        done = []
        for key, runs in placements.items():
            buf = stream_buf[key]
            lane = key[0]
            for ci, t, n_here in runs:
                lo = ci * s_bytes
                hi = min(lo + n_here * s_bytes, buf.shape[0])
                buf[lo:hi] = arr[lane, t * s_bytes:t * s_bytes + hi - lo]
            with lock:
                stream_left[key] -= sum(r[2] for r in runs)
                if stream_left[key] <= 0:
                    i = stream_frame[key]
                    frame_left[i] -= 1
                    if frame_left[i] == 0:
                        done.append(i)
        for i in done:
            lb = np.concatenate([stream_buf[k] for k in frame_keys[i]])
            execute(scripts[i], lb, out_buf[offsets[i]:offsets[i + 1]])

    seg_futs = []
    with tracelog.span("decode/segment_pipeline", frames=len(frames)), \
            cuda_build.on_device(device), \
            ThreadPoolExecutor(n_workers) as ex, \
            ThreadPoolExecutor(n_finish) as finisher:
        job = tracelog.bound(one)
        futs = {ex.submit(job, frames[i]): i for i in range(len(frames))}
        for fut in as_completed(futs):
            kind, sc = fut.result()
            i = futs[fut]
            if not arrived(i, kind, sc):
                continue
            scripts[i] = sc
            keys = []
            for j, payload in enumerate(lit_subs_split(frames[i].lit)):
                nl = max(0, min(SUB_LIT, sc.lit_total - j * SUB_LIT))
                key = dec.add_stream(payload, nl, sc.lcmap, sc.speeds)
                if key is not None:
                    keys.append(key)
                    stream_buf[key] = np.empty(nl, np.uint8)
                    stream_left[key] = -(-nl // s_bytes)
                    stream_frame[key] = i
            frame_keys[i] = keys
            if not keys:
                execute(sc, b"", out_buf[offsets[i]:offsets[i + 1]])
                continue
            frame_left[i] = len(keys)
            while dec.pending_chunks() >= seg_need:
                seg_futs.append(finisher.submit(
                    finish_seg, dec.segment(seg_steps, timing)))
        # drain: the lanes may hold uneven tails
        while dec.pending_chunks() > 0:
            seg_futs.append(finisher.submit(
                finish_seg, dec.segment(seg_steps, timing)))
    for fut in seg_futs:
        fut.result()


# ---------------------------------------------------------- numpy oracle

def decode_literals_np(lit_stream: bytes, n_bytes: int, lcmap, speeds,
                       chunk: int) -> bytes:
    """Decode `n_bytes` literal bytes of one deferred literal stream, byte
    by byte on the host: the readable oracle of the lane decode (the port
    of the reference's decode_literals_np, pallas_decode.py:1534).  The
    literal path of the golden deferred codec (cm profile, mixing on,
    UTF8 luts); rows keyed as the codec keys them, so the chunk
    histograms agree bit for bit."""
    lut0 = constants.literal_lut0(constants.LITERAL_PREDICTION_MODE_UTF8)
    lut1 = constants.literal_lut1(constants.LITERAL_PREDICTION_MODE_UTF8)
    dec = ANSDecoder(lit_stream)
    pol = deferred.DeferredPolicy(chunk)
    sp0, sp2, sp3 = speeds[0], speeds[2], speeds[3]
    out = bytearray()
    p1 = p2 = 0

    def nib(nib_key, cm_key, which, cm_sp):
        nibble_prob = pol.row(nib_key)
        cm_prob = pol.row(cm_key)
        w = pol.weights[which]
        mixed = scalar.average(cm_prob, nibble_prob, w[2] & 0xFFFF)
        off = dec.peek_offset()
        v = scalar.offset_to_sym(mixed, off)
        start, freq = scalar.sym_to_start_freq(mixed, v)
        dec.advance(start, freq)
        p_cm = scalar.sym_to_start_freq(cm_prob, v)[1]
        p_nib = scalar.sym_to_start_freq(nibble_prob, v)[1]
        pol.record_wadj(which, *deferred.weight_adjustments(p_cm, p_nib,
                                                            freq))
        pol.record_blend(cm_key, v, cm_sp.inc, cm_sp.lim)
        pol.record_blend(nib_key, v, sp0.inc, sp0.lim)
        pol.tick()
        return v

    for _ in range(n_bytes):
        sel = int(lut0[p1]) | int(lut1[p2])
        ctx = int(lcmap[sel])
        hi = nib(("lit_hi", 0, 0, ctx), ("cm", 0, ctx), 1, sp3)
        lo = nib(("lit_lo", 0, ctx >> 3, hi), ("cm", 1, hi, ctx >> 3), 0, sp2)
        b = (hi << 4) | lo
        out.append(b)
        p2, p1 = p1, b
    return bytes(out)
