"""Deferred encode on the device: the port of the two device branches of
divans_tpu/codec/jax_engine.compress.

  * Hybrid (`_compress_hybrid`, jax_engine.py:797), for the options the
    mechanical trace covers (native.supports: quality <= 10, detected
    stride and speeds included): the host codes each frame's cmd
    stream, the card its literals.
  * Uniform device lanes (jax_engine.py:984-1063 with
    `deferred_model_pass`, :610), for every other option the card takes
    (quality 11, the IR optimizer), and for every frame when the caller
    bills (`billing`, as jax_engine.compress skips its hybrid for
    billing_out): each frame is traced on the host and the card codes
    both streams, one cmd lane per frame.  Without the native library
    every frame takes these lanes, as in the reference (no hybrid,
    jax_engine.py:817): the greedy parse's command list through the
    Python trace FSM (codec/trace), the literals packed for kernel 3 by
    lit_pass.pack_lit_row.

Per metablock (frame), on a pool of up to 8 host threads: the trace
(frame_trace: the mechanical FSM, or the matcher's command list
through the FSM), the stream split, the cmd stream coded
(hybrid) or prepared for the card (uniform), the literals prepared for
the card.  Then HYBRID_BATCH frames at a time the card runs, from one
issuing thread on one stream, up to four jobs (batch_jobs), each a
model pass, the wide rANS encode (ans/rans_encode, kernel
csrc/rans_encode.cu) and compact_global, then the copy back:
  * "cmd": the cmd model pass (codec/cmd_pass, kernel csrc/cmd_pass.cu)
    on the cmd streams whose speeds are constant per row (its contract,
    checked frame by frame), packed one uint16 a step;
  * "cmd_generic": the generic deferred pass (codec/deferred_pass,
    kernel csrc/deferred_pass.cu) on the other cmd streams, as traces;
  * "lit": the literal model pass (codec/lit_pass, kernel
    csrc/lit_pass.cu) on the literals native.pack_lit packs (the
    bucketed cm profile), one lane per SUB_LIT-byte sub-stream;
  * "lit_generic": the generic deferred pass on every other frame's
    literals (the stride and mix profiles, a dead first literal step):
    the rebased lit trace cut into sub-stream lanes.
A puller thread waits on each batch's CUDA event, turns each job's flat
words into per-lane bytes (assemble_global) and joins each frame's
literal sub-streams into its lit field (lit_subs_join).  The streams use
disjoint model rows and lanes are independent, so the bytes equal
native.compress's whatever the batching and whichever pass takes a lane
(the reference runs its uniform branch over the whole file at once, and
sends a whole hybrid batch to its XLA pass when one frame leaves the
packed envelope).  No frame's literals are coded on the host.
"""
from __future__ import annotations

import functools
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from .. import cuda_build, native, tracelog
from ..ans import rans_encode
from ..container import format as fmt
from ..ir.matcher import build_commands
from . import cmd_pass, deferred_pass, lit_model, lit_pass
from . import trace as trace_mod
from .deferred import SUB_LIT, cmd_chunk, lit_subs_join

HYBRID_BATCH = 16   # frames per device batch, as in the reference

# frames whose cmd / lit stream each path coded since the last reset:
# "device" the specialised kernel (cmd pass, lit pass), "generic" the
# generic deferred pass, "host" the host coder (cmd streams only: every
# frame's literals go to one of the two passes)
STATS = {"cmd_device": 0, "cmd_generic": 0, "cmd_host": 0,
         "lit_device": 0, "lit_generic": 0}

# the model pass of each job (batch_jobs), called with its arrays on the
# device and then its scalar arguments; host_frame has range-checked
# the generic jobs' traces
_generic = functools.partial(deferred_pass.deferred_pass, checked=True)
PASSES = {"cmd": cmd_pass.cmd_pass, "cmd_generic": _generic,
          "lit": lit_pass.lit_pass, "lit_generic": _generic}


def reset_stats() -> None:
    STATS.update(dict.fromkeys(STATS, 0))


class HostFrame(NamedTuple):
    """The host side of one frame: per stream, exactly one of the host's
    bytes (the hybrid path's cmd stream), the specialised kernel's
    packed input, or the generic pass's trace."""
    cmd: bytes | None
    cmd_row: np.ndarray | None     # uint16 cmd steps (pack_cmd_rows)
    cmd_spd: tuple | None          # (inc, lim) int32[lit_base]
    cmd_trace: np.ndarray | None   # int32 [n, 10] cmd trace, checked
    lit_row: np.ndarray | None     # uint16 literal bytes (pack_lit)
    lit_spd: np.ndarray | None     # int32[6]
    lit_trace: np.ndarray | None   # int32 [n, 10] rebased lit trace, checked
    trace: np.ndarray | None = None  # the frame's whole trace (billing)


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


def split_subs(row: np.ndarray, size: int = SUB_LIT) -> list[np.ndarray]:
    """A frame's packed row as its SUB_LIT-byte sub-stream lanes (one
    packed element is one literal byte; a lit trace passes size
    2*SUB_LIT, a row pair per byte); an empty row is one empty lane."""
    k = max(1, -(-len(row) // size))
    return [row[j * size:(j + 1) * size] for j in range(k)]


def split_lit_sub_traces(lit_ts: list[np.ndarray]):
    """Frames' rebased lit traces as sub-stream lanes (deferred-v3), each
    a lane with a fresh model.  Returns (sub-traces, spans), spans[i] =
    (first sub-trace, count) of frame i."""
    subs, spans = [], []
    for t in lit_ts:
        pieces = split_subs(t, 2 * SUB_LIT)
        spans.append((len(subs), len(pieces)))
        subs += pieces
    return subs, spans


def in_envelope(layout) -> bool:
    """Can the literal kernels take this layout's frames at all?  (The
    bucketed cm profile; pack_lit then decides frame by frame.)"""
    if layout.profile.name != "cm" or not layout.lo_bucketed:
        return False
    lit_model.planes(layout)
    return True


def frame_trace(raw: bytes, options, layout) -> np.ndarray:
    """One frame's trace: the mechanical FSM for the options
    native.supports takes, else (or where that FSM abstains) the
    matcher's command list (ir/matcher.build_commands: quality 11, the
    IR optimizer) through the native FSM, or through the Python trace
    FSM (codec/trace) where native code refuses the list (quality 11
    without the context map) or is absent."""
    if native.supports(options):
        trace = native.build_trace(raw, options, layout)
        if trace is not None:
            return trace
    commands = build_commands(raw, options)
    trace = native.build_trace_cmds(raw, commands, options, layout)
    if trace is None:
        trace = trace_mod.build_trace(raw, commands, options, layout)
    return trace


def host_frame(raw: bytes, options, layout, chunk: int,
               billing: bool = False) -> HostFrame:
    """Trace one frame and prepare each stream for the pass that takes
    it.  The cmd stream is coded here on the hybrid path and goes to the
    card on the uniform path (options beyond the mechanical trace, or
    `billing`, as in the reference): to the cmd pass when its speeds are
    constant per row, else to the generic pass.  The literals go to the
    lit pass when pack_lit (or without the library its numpy twin,
    lit_pass.pack_lit_row) takes them, else to the generic pass.  A
    trace for the generic pass is range-checked here
    (deferred_pass.check_lane).  With `billing` the frame's trace is
    kept (HostFrame.trace)."""
    lit_base = layout.segments["lit_hi"][0]
    trace = frame_trace(raw, options, layout)
    # without the native library: no hybrid (the reference's
    # jax_engine.py:817) and the literals packed by the numpy twin
    have_native = native.load() is not None
    hybrid = have_native and native.supports(options) and not billing
    packed = native.pack_lit(trace, lit_base) \
        if have_native and in_envelope(layout) else None
    cmd_t = lit_t = None
    if not hybrid or packed is None:
        (cmd_t,), (lit_t,), *_ = split_stream_traces([trace], layout)
        if not have_native and in_envelope(layout):
            packed = lit_pass.pack_lit_row(lit_t)
    cmd_b = cmd_row = cmd_spd = None
    if hybrid:
        cmd_b = native.encode_streams(trace, layout.num_rows, chunk, sel=1,
                                      lit_base=lit_base)[0]
        cmd_t = None
    else:
        cmd_spd = cmd_pass.cmd_speeds_from_rows([cmd_t], lit_base)
        if cmd_spd is not None:
            cmd_row = cmd_pass.pack_cmd_rows(cmd_t)
            cmd_t = None
    lit_row = lit_spd = None
    if packed is not None:
        lit_row, lit_spd = packed[:2]
        lit_t = None
    if cmd_t is not None:
        deferred_pass.check_lane(cmd_t, lit_base)
    if lit_t is not None:
        deferred_pass.check_lane(lit_t, layout.num_rows - lit_base + 1)
    return HostFrame(cmd_b, cmd_row, cmd_spd, cmd_t, lit_row, lit_spd, lit_t,
                     trace if billing else None)


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


def generic_inputs(traces: list[np.ndarray], s: int):
    """The generic pass's host inputs for a batch of lane traces:
    (trace int32 [B, N, 10], counts int32 [B]), N the longest lane
    rounded up to a whole chunk of s steps."""
    return (deferred_pass.pad_traces(traces, s),
            np.array([t.shape[0] for t in traces], np.int32))


def batch_jobs(got, idxs, layout, chunk: int):
    """The device jobs of one batch from its frames' host_frame results
    (got, frame indices idxs): ([(name, host arrays, scalar arguments of
    its pass)], places), places[j] = (stream, [(frame index, first lane,
    lane count)]) for job j."""
    lit_base = layout.segments["lit_hi"][0]
    r_lit = layout.num_rows - lit_base + 1
    s_cmd = cmd_chunk(chunk)
    jobs, places = [], []
    k4 = [(i, g) for i, g in zip(idxs, got) if g.cmd_row is not None]
    if k4:
        jobs.append(("cmd", cmd_batch_inputs([g for _i, g in k4], s_cmd),
                     (s_cmd,)))
        places.append(("cmd", [(i, j, 1) for j, (i, _g) in enumerate(k4)]))
    gen = [(i, g.cmd_trace) for i, g in zip(idxs, got)
           if g.cmd_trace is not None]
    if gen:
        jobs.append(("cmd_generic",
                     generic_inputs([t for _i, t in gen], s_cmd),
                     (lit_base, s_cmd)))
        places.append(("cmd", [(i, j, 1) for j, (i, _t) in enumerate(gen)]))
    k3 = [i for i, g in zip(idxs, got) if g.lit_row is not None]
    if k3:
        rows, spds, spans = batch_lanes(got)
        jobs.append(("lit", batch_inputs(rows, spds, chunk), (chunk,)))
        places.append(("lit", [(i, *sp) for i, sp in zip(k3, spans)]))
    gen = [(i, g.lit_trace) for i, g in zip(idxs, got)
           if g.lit_trace is not None]
    if gen:
        subs, spans = split_lit_sub_traces([t for _i, t in gen])
        jobs.append(("lit_generic", generic_inputs(subs, chunk),
                     (r_lit, chunk)))
        places.append(("lit", [(i, *sp) for (i, _t), sp in zip(gen, spans)]))
    return jobs, places


def upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on `dev`: on the card through pinned memory, without
    blocking the issuing thread."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


@torch.inference_mode()
def issue_batch(jobs, device, marks=None, keep_freqs: bool = False):
    """The device side of one batch: for each job (name, host arrays,
    scalar arguments; batch_jobs), upload, model pass (PASSES[name]),
    rANS encode and compaction; then the start of the copy back.
    Returns ([(flat, header)] per job, event): host tensors and, on the
    card, the CUDA event that marks the end of their copy (None on the
    CPU).  With `keep_freqs` each job's tuple also holds the model
    pass's freqs [B, N], in the same copy.  `marks` (on the card): a
    list that gets (stage, CUDA event) recorded at the start of each
    stage (f"{name}_pass", f"{name}_rans", f"{name}_compact" per job,
    "copy"), then ("end", event)."""
    dev = torch.device(device)

    def mark(stage):
        if marks is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((stage, ev))

    outs = []
    for name, arrays, params in jobs:
        t = [upload(a, dev) for a in arrays]
        mark(f"{name}_pass")
        starts, freqs = PASSES[name](*t, *params)
        counts = t[-1]
        mark(f"{name}_rans")
        words, flags, states = rans_encode.encode_lanes(starts, freqs, counts)
        mark(f"{name}_compact")
        out = rans_encode.compact_global(words, flags, counts, states)
        outs.append((*out, freqs) if keep_freqs else out)
    if dev.type != "cuda":
        return outs, None
    mark("copy")
    host = []
    for out in outs:
        copies = []
        for t in out:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            copies.append(h)
        host.append(tuple(copies))
    mark("end")
    event = torch.cuda.Event()
    event.record()
    return host, event


def pull_batch(outs, event, lane_counts):
    """Wait for a batch's copy, then per job (its lanes' wire bytes, its
    lanes' freqs as numpy arrays cut to each lane's count, or None
    without issue_batch's keep_freqs)."""
    if event is not None:
        event.synchronize()
    res = []
    for (flat, header, *kept), counts in zip(outs, lane_counts):
        header = header.numpy()
        total = int(header[0].sum())
        lanes = rans_encode.assemble_global(flat[:total].numpy(), header[0],
                                            header[1], counts)
        lane_f = None
        if kept:
            f = kept[0].numpy()
            lane_f = [f[j, :n] for j, n in enumerate(counts)]
        res.append((lanes, lane_f))
    return res


def trace_order(trace: np.ndarray, cmd_freqs: np.ndarray,
                lit_freqs: np.ndarray) -> np.ndarray:
    """A frame's freqs in trace order: the cmd lane's on the steps of
    stream 0, the lit lanes' (sub-streams in order) on those of stream
    1."""
    lit = trace[:, 2] == 1
    if (len(cmd_freqs), len(lit_freqs)) != (int((~lit).sum()),
                                            int(lit.sum())):
        raise RuntimeError("the model passes' lane counts differ from the "
                           "trace's")
    out = np.empty(trace.shape[0], np.int32)
    out[~lit] = cmd_freqs
    out[lit] = lit_freqs
    return out


def compress_frames(blocks, options, layout, chunk: int, device,
                    timing: list | None = None,
                    billing: list | None = None) -> list[fmt.MetablockFrame]:
    """Deferred encode of metablocks on `device` ("cuda", "cuda:N", made
    the current device while the batches are issued, or "cpu" for the
    plain versions); the frames equal native.compress's.  With
    `timing` (on the card), each batch appends (its marks, as in
    issue_batch; the seconds the issuing thread waited for the batch's
    host work).  With `billing` (a list), every frame takes the uniform
    lanes, and the list gets each frame's (trace, freqs in trace
    order)."""
    n = len(blocks)
    bill = billing is not None
    cmd: list = [None] * n
    lit: list = [None] * n
    traces: list = [None] * n
    freqs: dict = {"cmd": [None] * n, "lit": [None] * n}
    pulls = []
    n_workers = max(1, min(8, os.cpu_count() or 1))
    with cuda_build.on_device(device), \
            ThreadPoolExecutor(n_workers) as pool, \
            ThreadPoolExecutor(1) as puller:
        frame = tracelog.bound(host_frame)
        futs = [pool.submit(frame, b, options, layout, chunk, bill)
                for b in blocks]
        for lo in range(0, n, HYBRID_BATCH):
            idxs = range(lo, min(lo + HYBRID_BATCH, n))
            t_wait = time.perf_counter()
            with tracelog.span("encode/host_cmd_wait", frames=len(idxs)):
                got = [futs[i].result() for i in idxs]
            t_wait = time.perf_counter() - t_wait
            for i, g in zip(idxs, got):
                cmd[i] = g.cmd
                traces[i] = g.trace
            with tracelog.span("encode/lit_dispatch", frames=len(idxs)):
                jobs, places = batch_jobs(got, idxs, layout, chunk)
                for (name, _a, _p), (stream, frames) in zip(jobs, places):
                    key = "device" if name == stream else "generic"
                    STATS[f"{stream}_{key}"] += len(frames)
                STATS["cmd_host"] += sum(g.cmd is not None for g in got)
                if not jobs:
                    continue
                marks = None
                if timing is not None:
                    marks = []
                    timing.append((marks, t_wait))
                outs, event = issue_batch(jobs, device, marks, bill)
                counts = [arrays[-1].tolist() for _n, arrays, _p in jobs]
                pulls.append((places, puller.submit(pull_batch, outs, event,
                                                    counts)))
        with tracelog.span("encode/lit_pull", batches=len(pulls)):
            for places, fut in pulls:
                for (stream, frames), (lanes, lane_f) in zip(places,
                                                             fut.result()):
                    for i, off, k in frames:
                        if stream == "cmd":
                            cmd[i] = lanes[off]
                        else:
                            lit[i] = lit_subs_join(lanes[off:off + k])
                        if lane_f is not None:
                            freqs[stream][i] = np.concatenate(
                                lane_f[off:off + k])
    if bill:
        billing += [(t, trace_order(t, c, f)) for t, c, f in
                    zip(traces, freqs["cmd"], freqs["lit"])]
    return [fmt.MetablockFrame(len(blocks[i]), cmd[i], lit[i])
            for i in range(n)]
