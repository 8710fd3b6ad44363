"""Deferred encode on the device: the port of the hybrid pipeline
divans_tpu/codec/jax_engine.py:797 (`_compress_hybrid`).

Per metablock (frame), as in the reference:
  1. host C++ builds the trace (native.build_trace), codes the cmd
     stream (native.encode_streams, sel=1) and packs the literal bytes
     (native.pack_lit), on a pool of up to 8 threads;
  2. the device codes the literals, HYBRID_BATCH frames at a time: each
     frame's packed row is cut into SUB_LIT-byte sub-streams, one lane
     each; the literal model pass (codec/lit_pass, kernel
     csrc/lit_pass.cu) gives every nibble's (start, freq), the wide rANS
     encode (ans/rans_encode, kernel csrc/rans_encode.cu) codes them,
     and compact_global packs the emitted words into one flat stream;
  3. a puller thread waits on each batch's recorded CUDA event, turns
     the flat stream into per-lane bytes (assemble_global) and joins each
     frame's sub-streams into its lit field (lit_subs_join).
The cmd and lit streams use disjoint model rows, so coding them apart
gives the bytes of coding them together (native.compress).

Launches and torch ops all come from the issuing thread, on one stream.
A frame outside the packed envelope (pack_lit returns None: the stride
and mix profiles, a dead first literal step) has its literals coded on
the host too (native.encode_streams, sel=3), as the decode takes such
frames on the host (decode.STATS); the reference sends them through its
XLA pass, whose port is the generic deferred pass (ROADMAP.md).
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native
from ..ans import rans_encode
from ..container import format as fmt
from . import lit_model, lit_pass
from .deferred import SUB_LIT, lit_subs_join

HYBRID_BATCH = 16   # frames per device batch, as in the reference

# frames coded by each path of compress_frames since the last reset:
# "device" = literals on the kernels, "host" = native lit coding
STATS = {"device_frames": 0, "host_frames": 0}


def split_subs(row: np.ndarray) -> list[np.ndarray]:
    """A frame's packed row as its SUB_LIT-byte sub-stream lanes (one
    packed element is one literal byte); an empty row is one empty lane."""
    k = max(1, -(-len(row) // SUB_LIT))
    return [row[j * SUB_LIT:(j + 1) * SUB_LIT] for j in range(k)]


def in_envelope(layout) -> bool:
    """Can the literal kernels take this layout's frames at all?  (The
    bucketed cm profile; pack_lit then decides frame by frame.)"""
    if layout.profile.name != "cm" or not layout.lo_bucketed:
        return False
    lit_model.planes(layout)
    return True


def host_frame(raw: bytes, options, layout, chunk: int):
    """The host side of one frame: (cmd bytes, packed row, speeds, lit
    field).  The row and speeds are set for a frame in the packed
    envelope, the host-coded lit field for any other."""
    lit_base = layout.segments["lit_hi"][0]
    trace = native.build_trace(raw, options, layout)
    packed = native.pack_lit(trace, lit_base) if in_envelope(layout) \
        else None
    if packed is None:
        cmd_b, lit_b = native.encode_streams(trace, layout.num_rows, chunk,
                                             sel=3, lit_base=lit_base)
        return cmd_b, None, None, lit_b
    cmd_b, _ = native.encode_streams(trace, layout.num_rows, chunk, sel=1,
                                     lit_base=lit_base)
    return cmd_b, packed[0], packed[1], None


def batch_lanes(host_results):
    """A batch's lanes from its frames' host_frame results: (rows, spds,
    spans), spans[k] = (first lane, lane count) of the k-th frame that
    has a packed row."""
    rows, spds, spans = [], [], []
    for _cmd, row, spd, _lit in host_results:
        if row is None:
            continue
        subs = split_subs(row)
        spans.append((len(rows), len(subs)))
        rows += subs
        spds += [spd] * len(subs)
    return rows, spds, spans


def batch_inputs(rows, spds, chunk: int):
    """The kernels' host inputs for a batch of lanes: (packed uint16
    [B, N/2], spd int32 [B, 6], n_nib int32 [B]), N the longest lane's
    nibbles rounded up to a whole chunk (padding lies past n_nib and
    changes no byte)."""
    n_nib = np.array([2 * len(r) for r in rows], np.int32)
    n_padded = max(chunk, -(-int(n_nib.max()) // chunk) * chunk)
    packed, spd = lit_pass.assemble_lit_rows(rows, spds, n_padded)
    return packed, spd, n_nib


def upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on `dev`: on the card through pinned memory, without
    blocking the issuing thread."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


@torch.inference_mode()
def issue_batch(rows, spds, chunk: int, device, events=None):
    """The device side of one batch of lanes: upload, lit pass, rANS
    encode, compaction, and the start of the copy back.  Returns (flat,
    header, event): host tensors and, on the card, the CUDA event that
    marks the end of their copy (None on the CPU).  `events`: four
    timing CUDA events to record around the lit pass, the rANS encode
    and the compaction with its copy."""
    dev = torch.device(device)
    t_packed, t_spd, t_nib = (upload(a, dev)
                              for a in batch_inputs(rows, spds, chunk))
    marks = iter(events or ())

    def mark():
        ev = next(marks, None)
        if ev is not None:
            ev.record()

    mark()
    starts, freqs = lit_pass.lit_pass(t_packed, t_spd, t_nib, chunk)
    mark()
    words, flags, states = rans_encode.encode_lanes(starts, freqs, t_nib)
    mark()
    flat, header = rans_encode.compact_global(words, flags, t_nib, states)
    if dev.type != "cuda":
        return flat, header, None
    out = []
    for t in (flat, header):
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        out.append(h)
    mark()
    event = torch.cuda.Event()
    event.record()
    return out[0], out[1], event


def pull_batch(flat, header, event, lane_counts) -> list[bytes]:
    """Wait for a batch's copy, then its per-lane wire bytes."""
    if event is not None:
        event.synchronize()
    header = header.numpy()
    total = int(header[0].sum())
    return rans_encode.assemble_global(flat[:total].numpy(), header[0],
                                       header[1], lane_counts)


def compress_frames(blocks, options, layout, chunk: int, device,
                    timing: list | None = None) -> list[fmt.MetablockFrame]:
    """Deferred encode of metablocks on `device` ("cuda", or "cpu" for
    the plain versions); the frames equal native.compress's.  With
    `timing` (on the card), each batch appends (four CUDA events: lit
    pass start, rANS start, compaction start, copy issued; the seconds
    the issuing thread waited for the batch's host work)."""
    n = len(blocks)
    cmd: list = [None] * n
    lit: list = [None] * n
    pulls = []
    n_workers = max(1, min(8, os.cpu_count() or 1))
    with ThreadPoolExecutor(n_workers) as pool, \
            ThreadPoolExecutor(1) as puller:
        futs = [pool.submit(host_frame, b, options, layout, chunk)
                for b in blocks]
        for lo in range(0, n, HYBRID_BATCH):
            idxs = range(lo, min(lo + HYBRID_BATCH, n))
            t_wait = time.perf_counter()
            got = [futs[i].result() for i in idxs]
            t_wait = time.perf_counter() - t_wait
            for i, g in zip(idxs, got):
                cmd[i], lit[i] = g[0], g[3]
            dev_idxs = [i for i, g in zip(idxs, got) if g[1] is not None]
            STATS["device_frames"] += len(dev_idxs)
            STATS["host_frames"] += len(got) - len(dev_idxs)
            rows, spds, spans = batch_lanes(got)
            if rows:
                events = None
                if timing is not None:
                    events = [torch.cuda.Event(enable_timing=True)
                              for _ in range(4)]
                    timing.append((events, t_wait))
                job = issue_batch(rows, spds, chunk, device, events)
                pulls.append((dev_idxs, spans, puller.submit(
                    pull_batch, *job, [len(r) for r in rows])))
        for dev_idxs, spans, fut in pulls:
            lane_bytes = fut.result()
            for i, (off, k) in zip(dev_idxs, spans):
                lit[i] = lit_subs_join(lane_bytes[off:off + k])
    return [fmt.MetablockFrame(len(blocks[i]), cmd[i], lit[i])
            for i in range(n)]
