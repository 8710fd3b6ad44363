"""Deferred encode on the device: the port of the two device branches of
divans_tpu/codec/jax_engine.compress.

  * Hybrid (`_compress_hybrid`, jax_engine.py:797), for the options the
    mechanical trace covers (native.supports: quality <= 10): the host
    codes each frame's cmd stream, the card its literals.
  * Uniform device lanes (jax_engine.py:984-1063 with
    `deferred_model_pass`, :610), for quality 11 (native.supports_cmds):
    the card codes both streams, the cmd stream with the cmd model pass
    (codec/cmd_pass, kernel csrc/cmd_pass.cu), one lane per frame.

Per metablock (frame), on a pool of up to 8 host threads: the trace
(frame_trace: the mechanical FSM, or at quality 11 the matcher's
command list through the FSM), the stream split, the cmd steps packed
for the card (uniform) or the cmd stream coded (hybrid), the literal
bytes packed (native.pack_lit).  Then HYBRID_BATCH frames at a time the
card runs, from one issuing thread on one stream: the cmd model pass on
the batch's cmd lanes; the literal model pass (codec/lit_pass, kernel
csrc/lit_pass.cu) on its lit lanes, one per SUB_LIT-byte sub-stream; for
each stream the wide rANS encode (ans/rans_encode, kernel
csrc/rans_encode.cu) and compact_global, then the copy back.  A puller
thread waits on each batch's CUDA event, turns each stream's flat words
into per-lane bytes (assemble_global) and joins each frame's literal
sub-streams into its lit field (lit_subs_join).  The streams use
disjoint model rows and lanes are independent, so the bytes equal
native.compress's whatever the batching (the reference runs its uniform
branch over the whole file at once).

What the card does not take is coded on the host (native.encode_streams)
and counted in STATS: a frame's literals outside the packed envelope
(pack_lit returns None: the stride and mix profiles, a dead first
literal step), whose port is the generic deferred pass (ROADMAP.md).  On
the uniform path every cmd stream goes to the card: the FSM codes each
cmd row at one speed, and a frame whose cmd speeds are not constant
breaks that contract and raises.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..ans import rans_encode
from ..container import format as fmt
from ..ir.matcher import build_commands
from . import cmd_pass, lit_model, lit_pass
from .deferred import SUB_LIT, cmd_chunk, lit_subs_join

HYBRID_BATCH = 16   # frames per device batch, as in the reference

# frames whose cmd / lit stream each path coded since the last reset
STATS = {"cmd_device": 0, "cmd_host": 0, "lit_device": 0, "lit_host": 0}


def reset_stats() -> None:
    STATS.update(dict.fromkeys(STATS, 0))


class HostFrame(NamedTuple):
    """The host side of one frame.  A stream the card codes has its
    packed input set and its bytes None; a stream the host coded has its
    bytes set."""
    cmd: bytes | None
    lit: bytes | None
    cmd_row: np.ndarray | None     # uint16 cmd steps (pack_cmd_rows)
    cmd_spd: tuple | None          # (inc, lim) int32[lit_base]
    lit_row: np.ndarray | None     # uint16 literal bytes (pack_lit)
    lit_spd: np.ndarray | None     # int32[6]


def _rebase_lit(t: np.ndarray, lit_base: int) -> np.ndarray:
    """A lit-stream trace's rows rebased to the lit sub-model: row 0 (the
    frozen CDF_INIT row) stays 0, rows [lit_base, R) map to [1, R -
    lit_base + 1)."""
    t = t.copy()
    for col in (0, 7):
        v = t[:, col]
        t[:, col] = np.where(v == 0, 0, v - (lit_base - 1))
    return t


def split_stream_traces(traces: list[np.ndarray], layout):
    """Frame traces split by stream for the per-stream model passes, the
    lit rows rebased: (cmd_traces, lit_traces, lit_masks, r_cmd, r_lit)
    with r_cmd = lit_base the cmd model's rows."""
    lit_base = layout.segments["lit_hi"][0]
    masks = [t[:, 2] == 1 for t in traces]
    cmd_ts = [t[~m] for t, m in zip(traces, masks)]
    lit_ts = [_rebase_lit(t[m], lit_base) for t, m in zip(traces, masks)]
    return cmd_ts, lit_ts, masks, lit_base, layout.num_rows - lit_base + 1


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


def frame_trace(raw: bytes, options, layout) -> np.ndarray:
    """One frame's trace: the mechanical FSM for the options
    native.supports takes, the matcher's command list through the FSM
    for those of native.supports_cmds (quality 11)."""
    if native.supports(options):
        return native.build_trace(raw, options, layout)
    trace = native.build_trace_cmds(raw, build_commands(raw, options),
                                    options, layout)
    if trace is None:
        raise NotImplementedError("the native trace builder refused the "
                                  "command list")
    return trace


def host_frame(raw: bytes, options, layout, chunk: int) -> HostFrame:
    """Trace one frame, pack what the card codes and code the rest.  The
    cmd stream goes to the card on the uniform path (options beyond the
    mechanical trace, as in the reference), the literals wherever
    pack_lit takes them."""
    lit_base = layout.segments["lit_hi"][0]
    trace = frame_trace(raw, options, layout)
    sel = 3                       # bit 0: host codes cmd, bit 1: lit
    cmd_row = cmd_spd = None
    if not native.supports(options):
        cmd_t = split_stream_traces([trace], layout)[0][0]
        cmd_spd = cmd_pass.cmd_speeds_from_rows([cmd_t], lit_base)
        if cmd_spd is None:
            raise ValueError("a cmd row coded at two speeds, or a mixing "
                             "cmd step: outside the cmd pass's contract")
        cmd_row = cmd_pass.pack_cmd_rows(cmd_t)
        sel &= ~1
    packed = native.pack_lit(trace, lit_base) if in_envelope(layout) \
        else None
    if packed is not None:
        sel &= ~2
    cmd_b = lit_b = None
    if sel:
        cmd_b, lit_b = native.encode_streams(trace, layout.num_rows, chunk,
                                             sel=sel, lit_base=lit_base)
    return HostFrame(cmd_b if sel & 1 else None, lit_b if sel & 2 else None,
                     cmd_row, cmd_spd,
                     *(packed[:2] if packed is not None else (None, None)))


def batch_lanes(host_results):
    """A batch's lit lanes from its frames' host_frame results: (rows,
    spds, spans), spans[k] = (first lane, lane count) of the k-th frame
    that has a packed row."""
    rows, spds, spans = [], [], []
    for g in host_results:
        if g.lit_row is None:
            continue
        subs = split_subs(g.lit_row)
        spans.append((len(rows), len(subs)))
        rows += subs
        spds += [g.lit_spd] * len(subs)
    return rows, spds, spans


def batch_inputs(rows, spds, chunk: int):
    """The lit kernels' host inputs for a batch of lanes: (packed uint16
    [B, N/2], spd int32 [B, 6], n_nib int32 [B]), N the longest lane's
    nibbles rounded up to a whole chunk (padding lies past n_nib and
    changes no byte)."""
    n_nib = np.array([2 * len(r) for r in rows], np.int32)
    n_padded = max(chunk, -(-int(n_nib.max()) // chunk) * chunk)
    packed, spd = lit_pass.assemble_lit_rows(rows, spds, n_padded)
    return packed, spd, n_nib


def cmd_batch_inputs(host_results, s: int):
    """The cmd kernels' host inputs for a batch's frames that send their
    cmd stream to the card: (packed uint16 [B, N], inc, lim int32 [B, R],
    n_steps int32 [B]), N the longest lane rounded up to a whole chunk of
    s steps."""
    live = [g for g in host_results if g.cmd_row is not None]
    n_steps = np.array([len(g.cmd_row) for g in live], np.int32)
    n_padded = max(s, -(-int(n_steps.max()) // s) * s)
    packed = cmd_pass.assemble_cmd_rows([g.cmd_row for g in live], n_padded)
    inc = np.stack([g.cmd_spd[0] for g in live])
    lim = np.stack([g.cmd_spd[1] for g in live])
    return packed, inc, lim, n_steps


def upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on `dev`: on the card through pinned memory, without
    blocking the issuing thread."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


@torch.inference_mode()
def issue_batch(cmd_inputs, lit_inputs, chunk: int, device, marks=None):
    """The device side of one batch: for each stream given (the cmd
    kernels' inputs and the lit kernels', or None), upload, model pass,
    rANS encode and compaction; then the start of the copy back.
    Returns ([(flat, header)] per stream given, event): host tensors and,
    on the card, the CUDA event that marks the end of their copy (None on
    the CPU).  `marks` (on the card): a list that gets (stage, CUDA
    event) recorded at the start of each stage ("cmd_pass", "cmd_rans",
    "cmd_compact", the same for "lit", "copy"), then ("end", event)."""
    dev = torch.device(device)

    def mark(stage):
        if marks is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((stage, ev))

    outs = []
    for inputs, stream in ((cmd_inputs, "cmd"), (lit_inputs, "lit")):
        if inputs is None:
            continue
        t = [upload(a, dev) for a in inputs]
        mark(f"{stream}_pass")
        if stream == "cmd":
            starts, freqs = cmd_pass.cmd_pass(*t, cmd_chunk(chunk))
        else:
            starts, freqs = lit_pass.lit_pass(*t, chunk)
        counts = t[-1]
        mark(f"{stream}_rans")
        words, flags, states = rans_encode.encode_lanes(starts, freqs, counts)
        mark(f"{stream}_compact")
        outs.append(rans_encode.compact_global(words, flags, counts, states))
    if dev.type != "cuda":
        return outs, None
    mark("copy")
    host = []
    for flat, header in outs:
        pair = []
        for t in (flat, header):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            pair.append(h)
        host.append(tuple(pair))
    mark("end")
    event = torch.cuda.Event()
    event.record()
    return host, event


def pull_batch(outs, event, lane_counts) -> list[list[bytes]]:
    """Wait for a batch's copy, then each stream's per-lane wire bytes."""
    if event is not None:
        event.synchronize()
    res = []
    for (flat, header), counts in zip(outs, lane_counts):
        header = header.numpy()
        total = int(header[0].sum())
        res.append(rans_encode.assemble_global(flat[:total].numpy(),
                                               header[0], header[1], counts))
    return res


def compress_frames(blocks, options, layout, chunk: int, device,
                    timing: list | None = None) -> list[fmt.MetablockFrame]:
    """Deferred encode of metablocks on `device` ("cuda", or "cpu" for
    the plain versions); the frames equal native.compress's.  With
    `timing` (on the card), each batch appends (its marks, as in
    issue_batch; the seconds the issuing thread waited for the batch's
    host work)."""
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
                cmd[i], lit[i] = g.cmd, g.lit
            cmd_idxs = [i for i, g in zip(idxs, got) if g.cmd_row is not None]
            lit_idxs = [i for i, g in zip(idxs, got) if g.lit_row is not None]
            STATS["cmd_device"] += len(cmd_idxs)
            STATS["cmd_host"] += len(got) - len(cmd_idxs)
            STATS["lit_device"] += len(lit_idxs)
            STATS["lit_host"] += len(got) - len(lit_idxs)
            rows, spds, spans = batch_lanes(got)
            cmd_in = cmd_batch_inputs(got, cmd_chunk(chunk)) if cmd_idxs \
                else None
            lit_in = batch_inputs(rows, spds, chunk) if rows else None
            if cmd_in is None and lit_in is None:
                continue
            marks = None
            if timing is not None:
                marks = []
                timing.append((marks, t_wait))
            outs, event = issue_batch(cmd_in, lit_in, chunk, device, marks)
            counts = [inputs[-1].tolist() for inputs in (cmd_in, lit_in)
                      if inputs is not None]
            pulls.append((cmd_idxs, lit_idxs, spans,
                          puller.submit(pull_batch, outs, event, counts)))
        for cmd_idxs, lit_idxs, spans, fut in pulls:
            streams = fut.result()
            if cmd_idxs:
                for i, b in zip(cmd_idxs, streams.pop(0)):
                    cmd[i] = b
            for i, (off, k) in zip(lit_idxs, spans):
                lit[i] = lit_subs_join(streams[0][off:off + k])
    return [fmt.MetablockFrame(len(blocks[i]), cmd[i], lit[i])
            for i in range(n)]
