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

Decode (`decompress_frames`): every frame of the container packed
(scan_decode.pack_frames), one launch of csrc/scan_decode.cu over all of
them (codec/scan_decode), each ok lane's window[:raw_len] taken; a lane
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

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import cuda_build, tracelog
from ..ans import rans_encode
from ..container import format as fmt
from . import decode, encode, model_pass, scan_decode
from .layout import ModelLayout, PROFILES

# frames decoded by each path since the last reset: "scan" the device
# scan, "host" the native serial decode, "golden" the golden engine (a
# frame native code refuses too, or a whole container: api.decompress)
STATS = {"scan_frames": 0, "host_frames": 0, "golden_frames": 0}


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


@torch.inference_mode()
def decompress_frames(frames, profile: str, device) -> bytes:
    """The adaptive decode of a container's frames on `device` (made the
    current device for the scan and its copies): one scan launch over
    all of them, the frames it flags on the host, then the output.
    Each stage is a tracelog span (decode/device_pipeline over
    decode/pack, decode/upload, decode/scan and decode/copy_back, then
    decode/serial_frames and decode/assemble)."""
    dev = torch.device(device)
    with tracelog.span("decode/device_pipeline", frames=len(frames)), \
            cuda_build.on_device(dev):
        with tracelog.span("decode/pack"):
            cs, cw, ls, lw, raw_len, window_size, max_steps = \
                scan_decode.pack_frames(frames)
        with tracelog.span("decode/upload"):
            args = [torch.from_numpy(a).to(dev)
                    for a in (cs, cw, ls, lw, raw_len)]
        with tracelog.span("decode/scan", max_steps=max_steps):
            window, ok, _wpos = scan_decode.decode_scan(
                *args, profile, window_size, max_steps)
        with tracelog.span("decode/copy_back"):
            # the first copy waits for the scan
            ok = ok.cpu().numpy()
            width = int(raw_len.max()) if len(frames) else 0
            window = window[:, :width].cpu().numpy()
    flagged = [i for i in range(len(frames)) if not ok[i]]
    layout = ModelLayout(PROFILES[profile], lo_bucketed=False)
    with tracelog.span("decode/serial_frames", frames=len(flagged)), \
            ThreadPoolExecutor(_pool_width()) as pool:
        host = list(pool.map(tracelog.bound(
            lambda i: decode._host_decode(frames[i], layout, 0)), flagged))
    with tracelog.span("decode/assemble", bytes=int(raw_len.sum())):
        offsets = np.zeros(len(frames) + 1, np.int64)
        np.cumsum(raw_len, out=offsets[1:])
        out = np.empty(int(offsets[-1]), np.uint8)
        for i, f in enumerate(frames):
            if ok[i]:
                out[offsets[i]:offsets[i + 1]] = window[i, :f.raw_len]
        for i, (raw, _kind) in zip(flagged, host):
            out[offsets[i]:offsets[i + 1]] = np.frombuffer(raw, np.uint8)
        out = out.tobytes()
    kinds = [kind for _raw, kind in host]
    STATS["scan_frames"] += len(frames) - len(flagged)
    STATS["host_frames"] += kinds.count("host")
    STATS["golden_frames"] += kinds.count("golden")
    return out
