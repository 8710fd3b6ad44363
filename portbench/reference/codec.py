"""The benchmark's plain reference for the write path, and the traces
its work formulas count.

It imports nothing of the program.  Two parts of the repository are
used as they stand: the host C++ library `native/` (its optimal parse
and its trace FSM, bound here by the benchmark's own ctypes calls),
which the program also loads; and `golden/`, a frozen copy of the
golden engine's metablock encoder, which codes a frame from the parse's
command list in plain Python (~0.1 MB/s).  So the reference shares the
match finder with the program, and nothing after it: the trace FSM, the
model, the rANS coder, the container and the checksum are its own.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from .golden import constants
from .golden.codec.engine_np import encode_metablock
from .golden.codec.layout import ModelLayout, PROFILES
from .golden.container import format as fmt
from .golden.container.crc32c import crc32c
from .golden.ir import commands as cmds
from .golden.options import DivansOptions
from .golden.probability.speed import MUD, Speed

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LIB = os.path.join(ROOT, "native", "libdivans_tpu_native.so")

# the quality-10 parse: chain depth, candidate frontier, literal cost
# scale (0: one calibrated cost a block), distance cost 40/16 + 7/16 a bit
Q10_DEPTH, Q10_KCAND, LIT_SCALE16, DIST_BASE, DIST_PER_BIT = 24, 2, 0, 40, 7
MIN_MATCH = 4
# segment order of trace_builder.cpp's Seg enum
SEGS = ["cc", "ll_cs", "ll_beg", "ll_last", "ll_mant",
        "c_ccs", "c_cbeg", "c_clast", "c_cmant",
        "c_dmn", "c_dbeg", "c_dlast", "c_dmant",
        "bt_stride",
        "pm_only", "pm_dcm", "pm_pd", "pm_palette", "pm_mvmode",
        "pm_cmn", "pm_cf", "pm_cs",
        "lit_hi", "lit_lo", "cm_first", "cm_second",
        "d_sbeg", "d_slast", "d_idx", "d_tr",
        "pm_mix",
        "lit_hi_s", "lit_lo_s",
        "bt_mn", "bt_f", "bt_s"]

_P, _I = ctypes.c_void_p, ctypes.c_int32
_lib = None
_lock = threading.Lock()


def options_of(config: dict) -> DivansOptions:
    return DivansOptions(**config["options"])


def lib() -> ctypes.CDLL:
    """The host library, built with `make -C native` when absent."""
    global _lib
    with _lock:
        if _lib is None:
            if not os.path.exists(LIB):
                subprocess.run(["make", "-C", os.path.dirname(LIB)],
                               check=True, capture_output=True)
            so = ctypes.CDLL(LIB)
            so.dtpu_parse_optimal.restype = _I
            so.dtpu_parse_optimal.argtypes = [_P, _I, _I, _I, _I, _I, _I, _P,
                                              _P, _P, _I]
            so.dtpu_build_trace.restype = _I
            so.dtpu_build_trace.argtypes = [_P, _I, _P, _I, _I, _I, _I, _I,
                                            _P, _P, _I, _I, _I, _P, _P, _P,
                                            _P, _I]
            _lib = so
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def q10_matches(raw: bytes) -> np.ndarray:
    """int32[n, 3] rows of (position, distance, length): the optimal
    parse that quality 10 takes."""
    n = len(raw)
    if n < MIN_MATCH:
        return np.zeros((0, 3), np.int32)
    out = np.zeros((n // 2 + 8, 3), np.int32)
    nm = lib().dtpu_parse_optimal(raw, n, Q10_DEPTH, Q10_KCAND, LIT_SCALE16,
                                  DIST_BASE, DIST_PER_BIT, None, None,
                                  _ptr(out), out.shape[0])
    if nm < 0:
        raise RuntimeError("the optimal parse overflowed its buffer")
    return out[:nm]


def _speeds(opts: DivansOptions):
    return opts.literal_adaptation or (MUD, MUD, Speed(8, 8192),
                                       Speed(8, 8192))


def q10_commands(raw: bytes, opts: DivansOptions) -> list:
    """The frame's command list: the model header, then the parse's
    literal runs and copies."""
    mv = b""
    if opts.force_stride_value > 1:
        mv = bytes([4 + min(7, opts.force_stride_value - 1)]) \
            * cmds.NUM_MIXING_VALUES
    out = [cmds.PredictionMode(
        literal_prediction_mode=constants.LITERAL_PREDICTION_MODE_UTF8,
        context_mixing=min(opts.dynamic_context_mixing, 7) & 3,
        adv_context_map=0, prior_depth=opts.prior_depth,
        speeds=tuple(_speeds(opts)),
        literal_context_map=bytes(range(64)) if opts.use_context_map
        else b"",
        distance_context_map=bytes([0, 1, 2, 3]) if opts.use_context_map
        else b"",
        mixing_values=mv)]
    pos = 0
    for mpos, dist, mlen in q10_matches(raw).tolist():
        if mpos > pos:
            out.append(cmds.Literal(raw[pos:mpos]))
        out.append(cmds.Copy(distance=dist, num_bytes=mlen))
        pos = mpos + mlen
    if pos < len(raw):
        out.append(cmds.Literal(raw[pos:]))
    return out


def check_supported(opts: DivansOptions) -> None:
    """The reference codes the adaptive profile at quality 10 with the
    context map; anything else has no reference here yet."""
    if (opts.chunk_nibbles or opts.quality != 10 or not
            opts.use_context_map or opts.force_stride_value > 1):
        raise NotImplementedError(
            "the write reference codes quality 10, chunk_nibbles 0, with "
            "the context map; these options have none")


def encode_frame(raw: bytes, opts: DivansOptions) -> tuple[bytes, bytes]:
    """(cmd stream, literal stream) of one metablock, coded in Python."""
    check_supported(opts)
    return encode_metablock(raw, q10_commands(raw, opts), opts)


def expected_header(block: bytes, opts: DivansOptions) -> dict:
    """What a container of this block states besides its streams."""
    mb = opts.metablock_size
    return {"window": opts.window_size, "mb_log2": opts.mb_log2,
            "flags": 0, "raw_lens": [len(block[o:o + mb])
                                     for o in range(0, len(block), mb)],
            "crc": crc32c(block)}


def read_container(blob: bytes) -> dict:
    """A container's header, frames and checksum, parsed by the frozen
    format copy."""
    window, mb_log2, frames, crc, flags = fmt.deserialize(blob)
    return {"window": window, "mb_log2": mb_log2, "flags": flags,
            "raw_lens": [f.raw_len for f in frames], "crc": crc,
            "frames": [(f.cmd, f.lit) for f in frames]}


def frame_trace(raw: bytes, opts: DivansOptions) -> np.ndarray:
    """int32[n, 10]: the adaptive trace of one metablock, as the native
    trace FSM builds it from the quality-10 parse (the work formulas
    count its steps)."""
    layout = ModelLayout(PROFILES["cm"], lo_bucketed=False)
    seg = np.array([layout.idx(s, *([0] * len(layout.segments[s][1])))
                    if s in layout.segments else -1 for s in SEGS], np.int32)
    adapt = np.array([[s.inc, s.lim] for s in _speeds(opts)], np.int32)
    lut0 = np.ascontiguousarray(constants.literal_lut0(
        constants.LITERAL_PREDICTION_MODE_UTF8))
    lut1 = np.ascontiguousarray(constants.literal_lut1(
        constants.LITERAL_PREDICTION_MODE_UTF8))
    matches = q10_matches(raw)
    if matches.shape[0] == 0:
        matches = np.zeros((1, 3), np.int32)
        nm = 0
    else:
        nm = matches.shape[0]
    cap = 4 * len(raw) + 16384
    out = np.empty((cap, 10), np.int32)
    ns = lib().dtpu_build_trace(
        raw, len(raw), _ptr(matches), nm,
        1 if opts.use_context_map else 0,
        min(opts.dynamic_context_mixing, 7), opts.prior_depth,
        max(1, opts.force_stride_value), _ptr(adapt), _ptr(seg),
        layout.segments["cm_second"][1][1], layout.lo_shift,
        1 if layout.lo_bucketed else 0, _ptr(lut0), _ptr(lut1), None,
        _ptr(out), cap)
    if ns < 0:
        raise RuntimeError("the trace FSM refused a frame")
    return out[:ns]
