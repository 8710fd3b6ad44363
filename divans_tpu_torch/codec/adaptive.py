"""The adaptive profile (chunk_nibbles=0, the default options) on the
device: the port of the chunk-0 branches of
divans_tpu/codec/jax_engine.compress (:964-982, :1020-1040, :1064-1072,
:1085-1094) and jax_engine.decompress (:1185-1202).

Encode (`compress_frames`):
  1. traces: encode.frame_trace of each metablock (the mechanical trace
     FSM, or the matcher's command list through the native or the
     Python trace FSM) on a
     pool of up to 8 host threads, with the layout's lo_bucketed=False,
     each range-checked for the kernel (model_pass.check_trace);
  2. upload: the traces back to back on the device, 40 B a step, copied
     frame by frame;
  3. model pass: one launch of csrc/model_pass.cu over every frame
     (codec/model_pass), which writes each step's (start, freq) straight
     into its stream's lane, cmd lane 2b and lit lane 2b + 1 of frame b;
  4. rANS: one launch of csrc/rans_encode.cu over the 2B lanes
     (ans/rans_encode.encode_lanes, the function of the reference's
     ans/kernels.encode_lanes);
  5. compaction (rans_encode.compact_global) and the copy back of the
     words the lanes emitted;
  6. assembly: each lane's wire bytes (rans_encode.assemble_global, b""
     for a lane that coded nothing); the lit field is the lane's bytes
     whole (no sub-streams at chunk 0).
The frames equal native.compress's (and the reference's).

Decode (`decompress_frames`): the container's lanes sent up as they are
on the wire through the calling thread's staging buffers (pinned, reused
across calls) and expanded on the device into scan_decode.pack_frames'
arrays, one launch of csrc/scan_decode.cu over every frame
(codec/scan_decode), each lane's window[:raw_len] brought down in file
order in one copy; a lane
the scan flags (dict commands, block switches, out-of-range contexts,
corrupt streams) is decoded again on the host by native.decode_metablock
at chunk 0, the reference's own abstain-and-redecode design, and a frame
that native code refuses too by the golden engine (engine_np).  STATS counts
the frames by path.

Without the native library both directions keep their device stages:
the traces come from the greedy parse through the Python trace FSM
(encode.frame_trace), and every flagged frame decodes on the golden
engine, as in the reference (jax_engine.py:965-969, :1191-1202).
"""
from __future__ import annotations

import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import cuda_build, tracelog
from ..ans import rans_encode
from ..ans.coder_np import ENC_START_STATE
from ..container import format as fmt
from . import decode, encode, model_pass, scan_decode
from .layout import ModelLayout, PROFILES

# frames decoded by each path since the last reset: "scan" the device
# scan, "host" the native serial decode, "golden" the golden engine (a
# frame native code refuses too, or a whole container: api.decompress);
# decodes staged through a thread's host buffers, and those that had to
# grow one
STATS = {"scan_frames": 0, "host_frames": 0, "golden_frames": 0,
         "staged_calls": 0, "staging_grows": 0}


def reset_stats() -> None:
    STATS.update(dict.fromkeys(STATS, 0))


def _pool_width() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def frame_trace(raw: bytes, options, layout) -> np.ndarray:
    """One frame's trace, range-checked for the model-pass kernel."""
    t = encode.frame_trace(raw, options, layout)
    model_pass.check_trace(t, layout.num_rows)
    return t


def _host_frame(raw: bytes, options, layout):
    """A pool worker's share: the frame's checked trace and its (cmd,
    lit) step counts."""
    with tracelog.span("encode/frame_trace", bytes=len(raw)) as meta:
        t = frame_trace(raw, options, layout)
        if meta is not None:
            meta["steps"] = t.shape[0]
        return t, model_pass.lane_counts(t)


@torch.inference_mode()
def compress_frames(blocks, options, layout, device,
                    billing: list | None = None) -> list[fmt.MetablockFrame]:
    """The adaptive encode of metablocks on `device` ("cuda", "cuda:N",
    made the current device for its device stages, or "cpu" for the
    plain versions).  `billing` (a list) gets each frame's (trace, freqs
    in trace order), the freqs copied back with the compacted words.
    Each stage is a tracelog span (encode/trace_build over the pool's
    encode/frame_trace spans, encode/model_pass over encode/upload,
    encode/ans_lanes, encode/lane_bytes)."""
    dev = torch.device(device)
    with tracelog.span("encode/trace_build", blocks=len(blocks)):
        with ThreadPoolExecutor(_pool_width()) as pool:
            got = list(pool.map(tracelog.bound(
                lambda b: _host_frame(b, options, layout)), blocks))
        counts = [c for _t, c in got]
        n_lane = max(1, max(max(c) for c in counts))
        n_steps = np.array([t.shape[0] for t, _c in got], np.int32)
    with tracelog.span("encode/model_pass", profile="adaptive"), \
            cuda_build.on_device(dev):
        total = int(n_steps.sum())
        with tracelog.span("encode/upload", steps=total):
            # the traces back to back on the device, copied frame by
            # frame (no host copy of the whole)
            trace_d = torch.empty((total, model_pass.NCOLS),
                                  dtype=torch.int32, device=dev)
            off = 0
            for t, _c in got:
                trace_d[off:off + t.shape[0]].copy_(torch.from_numpy(t))
                off += t.shape[0]
            n_steps_d = torch.from_numpy(n_steps).to(dev)
        starts, freqs, lane_n = model_pass.model_pass(trace_d, n_steps_d,
                                                      layout.num_rows, n_lane)
    with tracelog.span("encode/ans_lanes", lanes=2 * len(blocks)), \
            cuda_build.on_device(dev):
        words, flags, states = rans_encode.encode_lanes(starts, freqs,
                                                        lane_n)
        flat_w, header = rans_encode.compact_global(words, flags, lane_n,
                                                    states)
        header = header.cpu().numpy()
        lane_n = lane_n.cpu().numpy()
        host_counts = np.array(counts, np.int32).reshape(-1)
        if not np.array_equal(lane_n, host_counts):
            raise RuntimeError("the model pass's lane counts differ from "
                               "the traces'")
        flat_w = flat_w[:int(header[0].sum())].cpu().numpy()
        if billing is not None:
            freqs = freqs.cpu().numpy()
    with tracelog.span("encode/lane_bytes"):
        lanes = rans_encode.assemble_global(flat_w, header[0], header[1],
                                            host_counts.tolist())
        frames = [fmt.MetablockFrame(len(blocks[i]), lanes[2 * i],
                                     lanes[2 * i + 1])
                  for i in range(len(blocks))]
    if billing is not None:
        billing += [(t, encode.trace_order(t, freqs[2 * i, :nc],
                                           freqs[2 * i + 1, :nl]))
                    for i, (t, (nc, nl)) in enumerate(got)]
    return frames


@dataclasses.dataclass
class _Packed:
    """One call's lanes in the up buffer, and what the host keeps of
    them: the frames' raw_len (int32 [B]) and their offsets in the file
    (int64 [B + 1]), the word widths (next_pow2, as pack_frames gives
    them), window_size and max_steps."""
    n_head: int
    n_wire: int
    raw_len: np.ndarray
    offsets: np.ndarray
    wc: int
    wl: int
    window_size: int
    max_steps: int
    grew: bool

    @property
    def total(self) -> int:
        return int(self.offsets[-1])


class _Staging:
    """The adaptive decode's host side on one (thread, device): two host
    buffers, pinned for a CUDA device, one for the way up and one for
    the way down, each grown to the largest call it has seen and reused
    after that.

    Up (`pack`, `upload`): a header, int64 [5, B] (each frame's cmd and
    lit lane lengths, their offsets past the header, raw_len), then the
    frames' lanes back to back as they are on the wire (u32 state then
    u16 words; b"" for a lane that coded nothing), then 4 zero bytes;
    one copy to the device, where `unpack_lanes` turns them into the
    scan's inputs, equal to scan_decode.pack_frames'.  Down
    (`copy_back`, `assemble`): every frame's first raw_len window bytes
    in file order, then the ok flags, in one copy; each flagged frame's
    host bytes in its place; the file out in one `bytes` copy.

    Each async copy records an event, and the next call waits for them
    before it writes a buffer again: a call that raised between a copy
    and its synchronise leaves no copy in flight over the buffers."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.pin = dev.type == "cuda"
        self.up = self.down = torch.empty(0, dtype=torch.uint8)
        self.events: list = []

    def _grow(self, name: str, n: int) -> bool:
        if getattr(self, name).numel() >= n:
            return False
        setattr(self, name, torch.empty(n, dtype=torch.uint8,
                                        pin_memory=self.pin))
        return True

    def pack(self, frames) -> _Packed:
        """The frames' lanes into the up buffer, room for the file in the
        down buffer: a lane of odd length past its state raises
        ValueError, as pack_frames does."""
        for ev in self.events:
            ev.synchronize()
        self.events = []
        b = len(frames)
        lanes = [s for f in frames for s in (f.cmd, f.lit)]
        lens = np.fromiter(map(len, lanes), np.int64, 2 * b)
        odd = lens[(lens > 4) & (lens % 2 == 1)]
        if odd.size:
            raise ValueError(f"a lane of {odd[0]} bytes: its words are u16")
        raw_len = np.array([f.raw_len for f in frames], np.int32)
        starts = np.cumsum(lens) - lens
        head = np.stack([lens[0::2], lens[1::2], starts[0::2], starts[1::2],
                         raw_len.astype(np.int64)])
        offsets = np.zeros(b + 1, np.int64)
        np.cumsum(raw_len, out=offsets[1:])
        n_wire = int(lens.sum())
        grew = self._grow("up", head.nbytes + n_wire + 4)
        grew |= self._grow("down", int(offsets[-1]) + b)
        buf = self.up.numpy()
        buf[:head.nbytes] = head.reshape(-1).view(np.uint8)
        mv = memoryview(buf)[head.nbytes:]
        pos = 0
        for s in lanes:
            mv[pos:pos + len(s)] = s
            pos += len(s)
        mv[pos:pos + 4] = bytes(4)
        words = np.maximum(lens - 4, 0) // 2
        window_size = scan_decode.next_pow2(int(raw_len.max()) + 1)
        return _Packed(head.nbytes, n_wire, raw_len, offsets,
                       scan_decode.next_pow2(max(1, int(words[0::2].max()))),
                       scan_decode.next_pow2(max(1, int(words[1::2].max()))),
                       window_size, 8 * window_size + 16384, grew)

    def upload(self, p: _Packed):
        """The up buffer on the device in one copy, expanded there:
        (cmd_states, cmd_words, lit_states, lit_words, raw_len), the
        scan's inputs."""
        d = self.up[:p.n_head + p.n_wire + 4].to(self.dev,
                                                 non_blocking=self.pin)
        if self.pin:
            self._record()
        head = d[:p.n_head].view(torch.int64).view(5, -1)
        wire = d[p.n_head:]
        return (*unpack_lanes(wire, head[2], head[0], p.wc),
                *unpack_lanes(wire, head[3], head[1], p.wl),
                head[4].to(torch.int32))

    def copy_back(self, window: torch.Tensor, ok: torch.Tensor,
                  p: _Packed) -> np.ndarray:
        """Each frame's first raw_len window bytes in file order, then
        the ok flags, into the down buffer in one copy (which waits for
        the scan): the ok flags, bool [B]."""
        b, total = p.raw_len.shape[0], p.total
        rows = [r[:n] for r, n in zip(window.unbind(0), p.raw_len.tolist())]
        flat = torch.cat(rows + [ok.view(torch.uint8)])
        self.down[:total + b].copy_(flat, non_blocking=self.pin)
        if self.pin:
            self._record().synchronize()
        return self.down[total:total + b].numpy().astype(bool)

    def assemble(self, p: _Packed, host: dict[int, bytes]) -> bytes:
        """The file: the down buffer with each flagged frame's host bytes
        (`host`, by frame index) in its place."""
        buf = self.down.numpy()
        for i, raw in host.items():
            buf[p.offsets[i]:p.offsets[i + 1]] = np.frombuffer(raw, np.uint8)
        return buf[:p.total].tobytes()

    def _record(self):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.dev))
        self.events.append(ev)
        return ev


_local = threading.local()


def staging(dev: torch.device) -> _Staging:
    """The calling thread's staging for `dev`: concurrent decodes never
    share a buffer."""
    by_dev = getattr(_local, "staging", None)
    if by_dev is None:
        by_dev = _local.staging = {}
    if dev not in by_dev:
        by_dev[dev] = _Staging(dev)
    return by_dev[dev]


def unpack_lanes(wire: torch.Tensor, starts: torch.Tensor,
                 lens: torch.Tensor, width: int):
    """One stream's lanes as the scan takes them, on wire's device:
    (states int32 [B], words int32 [B, width]), equal to pack_frames'.
    Lane b is wire[starts[b]:starts[b] + lens[b]] (uint8; int64 starts
    and lens; at least 3 bytes of wire past the last lane): its
    little-endian u32 state (a shorter lane's bytes as they are, none
    the coder's start state), then its u16 words, zero-padded."""
    dev = wire.device
    k = torch.arange(4, device=dev)
    byte = wire[starts[:, None] + k].long() * (k < lens[:, None])
    state = (byte << (8 * k)).sum(1)
    state = torch.where(lens == 0, ENC_START_STATE, state)
    state = torch.where(state >= 1 << 31, state - (1 << 32), state)
    k = torch.arange(width, device=dev)
    valid = k < ((lens - 4).clamp(min=0) // 2)[:, None]
    pos = torch.where(valid, starts[:, None] + 4 + 2 * k, 0)
    words = (wire[pos].int() | (wire[pos + 1].int() << 8)) * valid
    return state.to(torch.int32), words.to(torch.int32)


@torch.inference_mode()
def decompress_frames(frames, profile: str, device) -> bytes:
    """The adaptive decode of a container's frames on `device` (made the
    current device for the scan and its copies): the lanes up through
    the thread's staging, one scan launch over all of them, the file
    down, the frames the scan flags on the host.  Each stage is a
    tracelog span (decode/device_pipeline over decode/pack (the lanes
    into the up buffer), decode/upload (its copy, `bytes` the lanes',
    and the expansion), decode/scan and decode/copy_back (waits for the
    scan; `bytes` the file's), then decode/serial_frames and
    decode/assemble)."""
    dev = torch.device(device)
    st = staging(dev)
    with tracelog.span("decode/device_pipeline", frames=len(frames)), \
            cuda_build.on_device(dev):
        with tracelog.span("decode/pack"):
            p = st.pack(frames)
        with tracelog.span("decode/upload", bytes=p.n_wire):
            args = st.upload(p)
        with tracelog.span("decode/scan", max_steps=p.max_steps):
            window, ok, _wpos = scan_decode.decode_scan(
                *args, profile, p.window_size, p.max_steps)
        with tracelog.span("decode/copy_back", bytes=p.total):
            ok = st.copy_back(window, ok, p)
    flagged = np.flatnonzero(~ok).tolist()
    layout = ModelLayout(PROFILES[profile], lo_bucketed=False)
    with tracelog.span("decode/serial_frames", frames=len(flagged)), \
            ThreadPoolExecutor(_pool_width()) as pool:
        host = list(pool.map(tracelog.bound(
            lambda i: decode._host_decode(frames[i], layout, 0)), flagged))
    with tracelog.span("decode/assemble", bytes=p.total):
        out = st.assemble(p, {i: raw for i, (raw, _k) in zip(flagged, host)})
    kinds = [kind for _raw, kind in host]
    STATS["scan_frames"] += len(frames) - len(flagged)
    STATS["host_frames"] += kinds.count("host")
    STATS["golden_frames"] += kinds.count("golden")
    STATS["staged_calls"] += 1
    STATS["staging_grows"] += p.grew
    return out
