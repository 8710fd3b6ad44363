"""The port's ctypes binding to the repo's host C++ library.

native/codec_core.cpp and native/trace_builder.cpp build
native/libdivans_tpu_native.so (`make -C native`, run here when the
library is absent).  The port binds it itself, with the calls it needs:

  * decode: the command-structure pass (`decode_cmd_structure`), the
    script executor (`execute_script`) and the serial whole-frame decoder
    (`decode_metablock`) for frames outside the device envelope;
  * encode: the matcher and trace FSM (`build_trace`, with a
    prior-bitmask mask), the stream coder (`encode_streams`), the
    literal packer of the device encode (`pack_lit`) and the host-only
    `compress`; the trace is mechanical (matches straight into the FSM)
    for the options of `supports_trace`, else the matcher's command
    list (ir/matcher.build_commands: quality 11, the IR optimizer, block
    split) goes through the FSM (`build_trace_cmds`);
  * the host-only `decompress`, a frame at a time;
  * `crc32c` (SSE4.2).

If the library cannot be built or loaded, `load()` warns once and
returns None, and so does every wrapper below (`crc32c` computes the
checksum in Python instead; `execute_script` takes a NativeScript, which
only the library makes): each caller then takes the reference's
Python route (the greedy parse and the Python dictionary scan in
ir/matcher, the Python trace FSM codec/trace, the golden structure pass
and script executor of codec/deferred, the golden engine codec/engine_np),
while the device stages stay on the card.  The containers are then the
reference's lib-less ones (its quality-10 parse is the greedy one).
Where the native code refuses (`compress` returns None,
`decode_metablock` None), the golden engine codes in Python too, as in
the reference.  A library that loads and fails inside a call raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import subprocess
import threading
import warnings

import numpy as np

from . import constants, tracelog
from .codec.layout import ModelLayout, PROFILES
from .errors import CorruptStream, ErrCode
from .options import DivansOptions
from .probability.speed import Speed, MUD

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SO = os.path.join(_ROOT, "native", "libdivans_tpu_native.so")

# segment order shared with trace_builder.cpp's Seg enum
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
_PI = ctypes.POINTER(ctypes.c_int32)
# argument types of the C entry points (codec_core.cpp, trace_builder.cpp)
_SIGNATURES = {
    "dtpu_match": [_P, _I, _I, _P, _I],
    "dtpu_parse_optimal": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I],
    "dtpu_build_trace": [_P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I,
                         _P, _P, _P, _P, _I],
    "dtpu_encode_streams_sel": [_P, _I, _I, _I, _I, _I, _P, _PI, _P, _PI],
    "dtpu_decode_metablock": [_P, _I, _P, _I, _I, _I, _I, _I, _P, _I, _I,
                              _P, _P, _P, _P, _I, _P, _P, _P, _I],
    "dtpu_decode_cmd_structure": [_P, _I, _I, _I, _I, _I, _P, _I, _I, _P, _P,
                                  _P, _I, _P, _P, _P, _I, _P, _I, _P, _I,
                                  _P, _P],
    "dtpu_execute_script": [_P, _I, _P, ctypes.c_int64, _P, _I, _P, _I],
    "dtpu_pack_lit": [_P, _I, _I, _P, _I, _P],
    "dtpu_build_trace_cmds": [_P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I,
                              _I, _P, _P, _P, _I, _P, _I],
}
# entry points that return nothing
_VOID_SIGNATURES = {
    "dtpu_dict_scan": [_P, _I, _P, _I] + [_P] * 9,
}

_lib = None        # the library; False once its build or load failed
_lock = threading.Lock()


def load():
    """The native library, built with `make -C native` if absent, or None
    when it cannot be built or loaded (warned once; the failure is cached,
    so no later call, from any thread, builds again)."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _open()
    return _lib or None


def _open():
    """The loaded library with its signatures set, or False (warned)."""
    try:
        if not os.path.exists(_SO):
            res = subprocess.run(["make", "-C", os.path.join(_ROOT,
                                                             "native")],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise OSError("make -C native failed:\n" + res.stdout
                              + res.stderr)
        lib = ctypes.CDLL(_SO)
    except OSError as e:
        warnings.warn(f"the native library is unavailable, so the host "
                      f"stages run in Python (the reference's lib-less "
                      f"routes): {e}", RuntimeWarning, stacklevel=3)
        return False
    for fn, args in _SIGNATURES.items():
        getattr(lib, fn).restype = ctypes.c_int32
        getattr(lib, fn).argtypes = args
    for fn, args in _VOID_SIGNATURES.items():
        getattr(lib, fn).restype = None
        getattr(lib, fn).argtypes = args
    lib.dtpu_crc32c.restype = ctypes.c_uint32
    lib.dtpu_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_uint32]
    return lib


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32c through the library's SSE4.2 path, or the Python table
    (container/crc32c.crc32c_py) without the library."""
    buf = data if isinstance(data, bytes) else bytes(data)
    lib = load()
    if lib is None:
        from .container.crc32c import crc32c_py
        return crc32c_py(buf, crc)
    return lib.dtpu_crc32c(buf or b"\0", len(buf), crc) & 0xFFFFFFFF


def _seg_array(layout: ModelLayout) -> np.ndarray:
    return np.array([layout.idx(s, *([0] * len(layout.segments[s][1])))
                     if s in layout.segments else -1
                     for s in SEGS], np.int32)


def _luts():
    lut0 = np.ascontiguousarray(
        constants.literal_lut0(constants.LITERAL_PREDICTION_MODE_UTF8))
    lut1 = np.ascontiguousarray(
        constants.literal_lut1(constants.LITERAL_PREDICTION_MODE_UTF8))
    return lut0, lut1


@functools.lru_cache(maxsize=8)
def _seg_luts_cached(profile_name: str, lo_bucketed: bool):
    layout = ModelLayout(PROFILES[profile_name], lo_bucketed=lo_bucketed)
    lut0, lut1 = _luts()
    return _seg_array(layout), lut0, lut1, layout.segments["cm_second"][1][1]


def _seg_luts(layout: ModelLayout):
    return _seg_luts_cached(layout.profile.name, layout.lo_bucketed)


@functools.lru_cache(maxsize=1)
def _dict_arrays():
    """RFC 7932 dictionary packed for the C++ decoder: (data u8[],
    offsets u32[32], prefix/suffix pool u8[], tr_meta i32[ntr,5])."""
    from . import dictionary
    d = dictionary.load()
    if not d.available:
        return None
    data = np.frombuffer(d.data, np.uint8)
    offs = np.array(d.offsets_by_length, np.uint32)
    pool = bytearray()
    meta = np.zeros((len(d.transforms), 5), np.int32)
    for i, (prefix, ttype, suffix) in enumerate(d.transforms):
        meta[i] = (len(pool), len(prefix),
                   ttype, len(pool) + len(prefix), len(suffix))
        pool += prefix + suffix
    return (data, offs, np.frombuffer(bytes(pool) or b"\0", np.uint8), meta)


def _dict_args():
    dct = _dict_arrays()
    if dct is None:
        return (None, 0, None, None, None, 0)
    data, offs, pool, meta = dct
    return (data.ctypes.data_as(ctypes.c_void_p), data.shape[0],
            offs.ctypes.data_as(ctypes.c_void_p),
            pool.ctypes.data_as(ctypes.c_void_p),
            meta.ctypes.data_as(ctypes.c_void_p), meta.shape[0])


# ------------------------------------------------------------------ encode

Q10_DEPTH = 24   # chain depth of the quality-10 optimal parse
Q10_KCAND = 2    # its candidate frontier width

def supports_trace(options: DivansOptions) -> bool:
    """Does the mechanical trace (matcher straight into the FSM,
    `build_trace`) cover these options?  Detection is resolved first
    (ir/detect.apply_detection): its result is a stride and speeds,
    which the FSM takes; a prior-bitmask mask goes in as `mask`."""
    return (options.quality < 11
            and options.prior_depth == 0
            and options.external_probs is None
            and not options.block_split
            and options.cmap_clustering == 0
            and options.streaming_chunk_bytes == 0
            and options.divans_ir_optimizer == 0)


def supports(options: DivansOptions) -> bool:
    """Does the hybrid encode (the mechanical trace, the cmd stream coded
    on the host) cover these options?  Exactly the mechanical trace's
    options, as divans_tpu.native.supports: detection is resolved before
    (ir/detect.apply_detection) into a stride and speeds, which the
    trace takes.  Prior-bitmask detection never reaches this test
    (api.host_only keeps it on the host)."""
    return supports_trace(options)


def find_matches(raw: bytes, quality: int) -> np.ndarray | None:
    """Greedy+lazy hash-chain matches (dtpu_match), int32[n,3] rows of
    (position, distance, length); None without the library."""
    lib = load()
    if lib is None:
        return None
    n = len(raw)
    matches = np.empty((max(1, n // 4 + 8), 3), np.int32)
    nm = lib.dtpu_match(raw or b"\0", n, quality,
                        matches.ctypes.data_as(ctypes.c_void_p),
                        matches.shape[0])
    if nm < 0:
        raise RuntimeError("match buffer overflow")
    return matches[:nm]


def dict_scan(data: bytes, index):
    """(out_len i32[n], ent_idx i32[n]): the longest dictionary-transform
    output at every position (0 and -1 where none), over the flattened
    index of ir/matcher._dict_flat_index; None without the library
    (ir/matcher then scans in Python)."""
    lib = load()
    if lib is None:
        return None
    (grams, boff, blob, eo, el, _ew, _ei, _et, pref16, p8, m8) = index
    n = len(data)
    out_len = np.zeros(max(1, n), np.int32)
    ent_idx = np.full(max(1, n), -1, np.int32)
    if n < 4 or grams.shape[0] == 0:
        return out_len[:n], ent_idx[:n]

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    lib.dtpu_dict_scan(data, n, ptr(grams), grams.shape[0], ptr(pref16),
                       ptr(boff), blob, ptr(eo), ptr(el), ptr(p8), ptr(m8),
                       ptr(out_len), ptr(ent_idx))
    return out_len, ent_idx


def find_matches_optimal(data: bytes, depth: int, kcand: int,
                         dict_len: np.ndarray | None = None,
                         dict_cost: np.ndarray | None = None,
                         lit_scale16: int = 0) -> np.ndarray | None:
    """Cost-model optimal parse (dtpu_parse_optimal: literal costs, DP
    and repeat-distance rewrite in one call), int32[n,3] rows of
    (position, distance, length); distance 0 marks a dictionary edge.
    ir/matcher gives each quality's chain depth and candidate frontier
    width, and at quality 11 the per-position dictionary edges.  Distance
    cost 40/16 + 7/16 * bitlen bits; lit_scale16 0 = one calibrated
    literal cost.  None without the library (ir/matcher then parses
    greedily)."""
    lib = load()
    if lib is None:
        return None
    n = len(data)
    out = np.zeros((n // 2 + 8, 3), np.int32)
    dl = None if dict_len is None else dict_len.ctypes.data_as(
        ctypes.c_void_p)
    dc = None if dict_cost is None else dict_cost.ctypes.data_as(
        ctypes.c_void_p)
    nm = lib.dtpu_parse_optimal(data, n, depth, kcand, lit_scale16, 40, 7,
                                dl, dc, out.ctypes.data_as(ctypes.c_void_p),
                                out.shape[0])
    if nm < 0:
        raise RuntimeError("optimal parse overflowed its match buffer")
    return out[:nm]


def _mask_ok(mask: bytes) -> bool:
    """The native FSM covers mask values {0} and the strides {4..11}."""
    return all(v == 0 or 4 <= v <= 11 for v in set(mask))


def build_trace(raw: bytes, options: DivansOptions, layout: ModelLayout,
                mask: bytes | None = None) -> np.ndarray | None:
    """raw bytes -> int32[n,10] trace (the mechanical trace FSM), or None
    outside `supports_trace` or the FSM's envelope, or without the
    library.  `mask` is an 8192-entry per-context mixing mask (a
    prior-bitmask detection's)."""
    lib = load()
    if lib is None or not supports_trace(options):
        return None
    if mask is not None and not _mask_ok(mask):
        return None
    n = len(raw)
    with tracelog.span("encode/parse", bytes=n):
        if options.quality >= 10 and n >= 4:
            matches = find_matches_optimal(raw, Q10_DEPTH, Q10_KCAND)
        else:
            matches = find_matches(raw, options.quality)
    nm = matches.shape[0]
    if nm == 0:
        matches = np.zeros((1, 3), np.int32)
    cap = 4 * n + 16384
    out = np.empty((cap, 10), np.int32)
    mask_buf = ((ctypes.c_uint8 * 8192).from_buffer_copy(mask)
                if mask is not None else None)
    with tracelog.span("encode/trace_fsm", matches=nm):
        ns = lib.dtpu_build_trace(
            raw, n, matches.ctypes.data_as(ctypes.c_void_p), nm,
            *_fsm_args(options, layout), mask_buf,
            out.ctypes.data_as(ctypes.c_void_p), cap)
    if ns < 0:
        return None
    return out[:ns]


def _fsm_args(options: DivansOptions, layout: ModelLayout) -> tuple:
    """The trace FSM's arguments shared by dtpu_build_trace and
    dtpu_build_trace_cmds, from use_cm to lut1 (each pointer keeps its
    array alive)."""
    speeds = options.literal_adaptation or (MUD, MUD, Speed(8, 8192),
                                            Speed(8, 8192))
    adapt = np.array([[s.inc, s.lim] for s in speeds], np.int32)
    lut0, lut1 = _luts()

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    return (1 if options.use_context_map else 0,
            min(options.dynamic_context_mixing, 7),
            options.prior_depth,
            max(1, options.force_stride_value),
            ptr(adapt), ptr(_seg_array(layout)),
            layout.segments["cm_second"][1][1], layout.lo_shift,
            1 if layout.lo_bucketed else 0,
            ptr(lut0), ptr(lut1))


def _cmd_rows(commands, options: DivansOptions):
    """Command list -> (int32[n,5] rows for dtpu_build_trace_cmds, mask,
    nb), or None when the list is outside the native FSM.  Rows: (0,
    len) Literal, (1, distance, len) Copy, (2, word_size, word_id,
    transform, final_size) Dict, (3, block_type, stride) a literal block
    switch.  The first command is a PredictionMode equal to the options'
    default but for its mixing mask (values {0, 4..11}: `mask`) and an
    identity literal map of nb <= 4 block types."""
    from .ir import commands as cmds
    from .ir.matcher import default_prediction_mode

    if not commands or not isinstance(commands[0], cmds.PredictionMode):
        return None
    pm = commands[0]
    default = default_prediction_mode(options)
    mask = None
    nb = 1
    if pm != default:
        if dataclasses.replace(
                pm, mixing_values=default.mixing_values,
                literal_context_map=default.literal_context_map) != default:
            return None
        lcm = pm.literal_context_map
        if lcm != default.literal_context_map:
            nb = len(lcm) // 64
            if not (1 <= nb <= 4 and lcm == bytes(range(nb * 64))):
                return None
        mv = pm.mixing_values
        if mv and any(mv):
            if not _mask_ok(mv) or len(mv) != 8192:
                return None
            mask = bytes(mv)
    rows = np.zeros((len(commands) - 1, 5), np.int32)
    for i, c in enumerate(commands[1:]):
        if isinstance(c, cmds.Literal):
            rows[i] = (0, len(c.data), 0, 0, 0)
        elif isinstance(c, cmds.Copy):
            rows[i] = (1, c.distance, c.num_bytes, 0, 0)
        elif isinstance(c, cmds.Dict):
            rows[i] = (2, c.word_size, c.word_id, c.transform, c.final_size)
        elif isinstance(c, cmds.BlockSwitchLiteral):
            rows[i] = (3, c.block_type, c.stride, 0, 0)
        else:
            return None
    return rows, mask, nb


def build_trace_cmds(raw: bytes, commands, options: DivansOptions,
                     layout: ModelLayout) -> np.ndarray | None:
    """An explicit command list -> int32[n,10] trace through the C++ FSM
    (Dict commands, masks and literal block switches included), or None
    when the list or the FSM is outside the envelope, or without the
    library (codec/trace is the Python FSM for those)."""
    lib = load()
    if lib is None:
        return None
    res = _cmd_rows(commands, options)
    if res is None:
        return None
    rows, mask, nb = res
    if mask is not None and "lit_hi_s" not in layout.segments:
        return None   # a masked stream needs the mix or split layout
    if nb * 64 > layout.segments["cm_first"][1][0]:
        return None   # each block type needs 64 context rows
    n = len(raw)
    cap = 4 * n + 16384
    out = np.empty((cap, 10), np.int32)
    mask_buf = ((ctypes.c_uint8 * 8192).from_buffer_copy(mask)
                if mask is not None else None)
    ns = lib.dtpu_build_trace_cmds(
        raw or b"\0", n, rows.ctypes.data_as(ctypes.c_void_p), rows.shape[0],
        *_fsm_args(options, layout), mask_buf, nb,
        out.ctypes.data_as(ctypes.c_void_p), cap)
    if ns < 0:
        return None
    return out[:ns]


def encode_streams(trace: np.ndarray, num_rows: int, chunk: int = 0,
                   sel: int = 3, lit_base: int = 0):
    """trace int32[n,10] -> (cmd_bytes, lit_field), or None without the
    library.  chunk > 0 selects the deferred profile (lit output = the
    deferred-v3 sub-stream field).  sel: bit0 = code the cmd stream, bit1
    = lit."""
    lib = load()
    if lib is None:
        return None
    n = trace.shape[0]
    trace = np.ascontiguousarray(trace, np.int32)
    cap = 4 * n + 1024
    cb = np.empty(cap, np.uint8)
    lb = np.empty(cap, np.uint8)
    cl = ctypes.c_int32(cap)
    ll = ctypes.c_int32(cap)
    rc = lib.dtpu_encode_streams_sel(
        trace.ctypes.data_as(ctypes.c_void_p), n, num_rows, chunk,
        lit_base, sel,
        cb.ctypes.data_as(ctypes.c_void_p), ctypes.byref(cl),
        lb.ctypes.data_as(ctypes.c_void_p), ctypes.byref(ll))
    if rc != 0:
        raise RuntimeError("stream buffer overflow")
    return cb[:cl.value].tobytes(), lb[:ll.value].tobytes()


def pack_lit(trace: np.ndarray, lit_base: int):
    """Trace -> (packed lit row uint16[n_lit_bytes], spd int32[6],
    lit_row_count), or None when the trace leaves the packed-byte
    envelope (a dead first literal step, a non-cm row pattern) or without
    the library (codec/lit_pass.pack_lit_row is the numpy twin).  One
    uint16 per literal byte: ctx | hi<<6 | lo<<10 | act<<14 | mix<<15;
    spd = (inc, lim) of speeds 0, 2, 3.  The C++ pass splits the stream
    and rebases the rows itself (GIL-free)."""
    lib = load()
    if lib is None:
        return None
    n = trace.shape[0]
    trace = np.ascontiguousarray(trace, np.int32)
    cap = n // 2 + 8
    row = np.empty(cap, np.uint16)
    spd = np.zeros(6, np.int32)
    cnt = lib.dtpu_pack_lit(
        trace.ctypes.data_as(ctypes.c_void_p), n, lit_base,
        row.ctypes.data_as(ctypes.c_void_p), cap,
        spd.ctypes.data_as(ctypes.c_void_p))
    if cnt < 0:
        return None
    return row[:cnt // 2], spd, cnt


def compress(data: bytes,
             options: DivansOptions | None = None) -> bytes | None:
    """Host-native compress, byte-identical to divans_tpu.native.compress:
    detection resolved first (ir/detect.apply_detection), each frame
    traced by the mechanical FSM (with a prior-bitmask mask where one is
    detected) or from its command list (ir/matcher.build_commands:
    quality 11, the IR optimizer, block split), then both streams coded
    here.  Returns None outside that envelope (ECDF, streaming, a list
    the FSM refuses: clustered context maps, quality 11 without the
    context map) and without the library, where the golden engine
    (codec/engine_np) codes the file.  The reference the card's encode
    is held against."""
    from concurrent.futures import ThreadPoolExecutor
    from .container import format as fmt
    from .codec.deferred import chunk_to_flags
    from .codec.layout import PROFILE_FLAGS, profile_for_options
    from .ir import commands as ir_cmds
    from .ir.detect import apply_detection, detect_prior_bitmask
    from .ir.matcher import build_commands

    options = options or DivansOptions()
    if (options.stride_detection_quality or options.speed_detection_quality
            or options.force_stride_value):
        options = apply_detection(data, options)
    # the command-level envelope (the FSM may still refuse a list)
    cmds_ok = (options.prior_depth == 0 and options.external_probs is None
               and options.streaming_chunk_bytes == 0)
    if load() is None or not (supports_trace(options) or cmds_ok):
        return None
    profile = profile_for_options(options)
    # masked and block-split streams stay per-nibble adaptive, as
    # codec/engine_np.compress codes them
    chunk = (0 if options.block_split or options.prior_bitmask_detection
             else options.chunk_nibbles)
    layout = ModelLayout(PROFILES[profile], lo_bucketed=chunk > 0)
    lit_base = layout.segments["lit_hi"][0]

    def one(raw):
        """(frame, used a block switch, used a mask), or None outside
        the native envelope."""
        mask = None
        f_split = f_mask = False
        if (options.prior_bitmask_detection and options.use_context_map
                and not options.force_stride_value):
            mask = detect_prior_bitmask(raw, options.prior_bitmask_detection)
            f_mask = mask is not None and any(mask)
        trace = build_trace(raw, options, layout, mask=mask)
        if trace is None and cmds_ok:
            commands = build_commands(raw, options)
            for c in commands:
                if isinstance(c, ir_cmds.BlockSwitchLiteral):
                    f_split = True
                elif (isinstance(c, ir_cmds.PredictionMode)
                      and any(c.mixing_values)):
                    f_mask = True
            trace = build_trace_cmds(raw, commands, options, layout)
        if trace is None:
            return None
        cmd_b, lit_b = encode_streams(trace, layout.num_rows, chunk,
                                      lit_base=lit_base)
        return fmt.MetablockFrame(len(raw), cmd_b, lit_b), f_split, f_mask

    mb = options.metablock_size
    blocks = [data[off:off + mb] for off in range(0, len(data), mb)]
    # metablocks are independent; ctypes releases the GIL
    with tracelog.span("encode/native_serial", bytes=len(data)):
        if len(blocks) > 1:
            with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
                results = list(ex.map(tracelog.bound(one), blocks))
        else:
            results = [one(b) for b in blocks]
    if any(r is None for r in results):
        return None
    used_split = any(r[1] for r in results)
    # a forced stride with the context map puts a constant mask in every PM
    used_mask = (any(r[2] for r in results)
                 or (options.use_context_map and options.force_stride_value > 1))
    # the flag records what the streams used (layout.emitted_profile)
    if not options.use_context_map:
        emitted = "stride"
    elif used_split:
        emitted = "split"
    elif used_mask:
        emitted = "mix"
    else:
        emitted = "cm"
    return fmt.serialize([r[0] for r in results], options.window_size,
                         options.mb_log2, crc32c(data),
                         flags=PROFILE_FLAGS[emitted] | chunk_to_flags(chunk))


# ------------------------------------------------------------------ decode

def decode_metablock(cmd: bytes, lit: bytes, raw_len: int, use_cm: bool,
                     layout: ModelLayout, chunk: int = 0) -> bytes | None:
    """Native serial decode of one frame; None = out of profile, or no
    library."""
    lib = load()
    if lib is None:
        return None
    masked = 1 if layout.profile.hi_s_shape is not None else 0
    seg, lut0, lut1, nctx = _seg_luts(layout)
    out = np.zeros(max(1, raw_len), np.uint8)
    rc = lib.dtpu_decode_metablock(
        cmd or b"\0", len(cmd), lit or b"\0", len(lit), raw_len,
        (1 if use_cm else 0) | (masked << 1), layout.num_rows, chunk,
        seg.ctypes.data_as(ctypes.c_void_p), nctx, layout.lo_shift,
        lut0.ctypes.data_as(ctypes.c_void_p),
        lut1.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p), *_dict_args())
    if rc != 0:
        return None
    return out[:raw_len].tobytes()


class NativeScript:
    """Command structure decoded natively from the cmd stream alone: the
    host half of the deferred decode.  ops stay native (int32[n,3] plus a
    dict-word pool) so execution is memcpy-speed C++."""

    __slots__ = ("ops", "pool", "raw_len", "lit_total", "lcmap", "speeds",
                 "supported")

    def __init__(self, ops, pool, raw_len, lit_total, lcmap, speeds,
                 supported):
        self.ops = ops
        self.pool = pool
        self.raw_len = raw_len
        self.lit_total = lit_total
        self.lcmap = lcmap
        self.speeds = speeds
        self.supported = supported


def decode_cmd_structure(cmd: bytes, raw_len: int, layout: ModelLayout,
                         chunk: int) -> NativeScript | None:
    """Native cmd-structure pass; None = out of profile, or no library
    (codec/deferred.decode_cmd_structure is the golden pass)."""
    lib = load()
    if lib is None or chunk <= 0:
        return None
    seg, lut0, lut1, nctx = _seg_luts(layout)
    dargs = _dict_args()
    info = np.zeros(16, np.int32)
    lcm_out = np.zeros(256, np.uint8)
    ops_cap = raw_len // 4 + 4096
    while True:
        ops = np.zeros((ops_cap, 3), np.int32)
        pool = np.zeros(raw_len + 64, np.uint8)
        n = lib.dtpu_decode_cmd_structure(
            cmd or b"\0", len(cmd), raw_len,
            1 if layout.profile.name == "cm" else 0,
            layout.num_rows, chunk,
            seg.ctypes.data_as(ctypes.c_void_p), nctx, layout.lo_shift,
            lut0.ctypes.data_as(ctypes.c_void_p),
            lut1.ctypes.data_as(ctypes.c_void_p),
            *dargs,
            ops.ctypes.data_as(ctypes.c_void_p), ops_cap,
            pool.ctypes.data_as(ctypes.c_void_p), pool.shape[0],
            info.ctypes.data_as(ctypes.c_void_p),
            lcm_out.ctypes.data_as(ctypes.c_void_p))
        if n != -2:
            break
        ops_cap = 8 * raw_len + 8192  # guard bound; cannot overflow twice
    if n < 0:
        return None
    speeds = [Speed(int(info[3 + 2 * i]), int(info[4 + 2 * i]))
              for i in range(4)]
    # device envelope: one PM, mixing on, a single literal block type
    supported = info[2] == 1 and info[1] == 1 and info[12] <= 1
    return NativeScript(ops[:n], pool[:info[11]].tobytes(), raw_len,
                        int(info[0]), [int(v) for v in lcm_out[:64]],
                        speeds, bool(supported))


def execute_script(script: NativeScript, lit_bytes,
                   out: np.ndarray | None = None) -> bytes | None:
    """Replay a NativeScript with its decoded literal bytes (bytes or a
    contiguous uint8 ndarray).  With `out` (a uint8 view of length
    raw_len) the frame is written in place and None is returned."""
    lib = load()
    ops = np.ascontiguousarray(script.ops, np.int32)
    if out is None:
        dst = np.zeros(max(1, script.raw_len), np.uint8)
    else:
        # hard errors: a wrong-sized `out` would let the C side write
        # past the caller's slice
        if out.dtype != np.uint8 or out.size != script.raw_len:
            raise ValueError(f"out must be uint8[{script.raw_len}], got "
                             f"{out.dtype}[{out.size}]")
        if not out.flags["C_CONTIGUOUS"]:
            raise ValueError("out must be C-contiguous")
        dst = out if script.raw_len else np.zeros(1, np.uint8)
    if isinstance(lit_bytes, np.ndarray):
        n_lit = lit_bytes.size
        lbuf = lit_bytes.ctypes.data_as(ctypes.c_void_p) if n_lit else b"\0"
    else:
        n_lit = len(lit_bytes)
        lbuf = lit_bytes or b"\0"
    rc = lib.dtpu_execute_script(
        ops.ctypes.data_as(ctypes.c_void_p), ops.shape[0],
        lbuf, ctypes.c_int64(n_lit),
        script.pool or b"\0", len(script.pool),
        dst.ctypes.data_as(ctypes.c_void_p), script.raw_len)
    if rc != 0:
        raise CorruptStream("script execution failed", ErrCode.SCRIPT_FAILED)
    if out is None:
        return dst[:script.raw_len].tobytes()
    return None


def decompress(blob: bytes) -> bytes:
    """Host-native decompress, each frame by `decode_metablock`, a frame
    it refuses (every frame without the library) by the golden engine
    (codec/deferred.decode_metablock at chunk > 0,
    codec/engine_np.decode_metablock at chunk 0), as
    divans_tpu.native.decompress does."""
    from concurrent.futures import ThreadPoolExecutor
    from .codec import deferred, engine_np
    from .codec.layout import FLAG_PROFILES
    from .container import format as fmt

    _w, _mb, frames, stored_crc, flags = fmt.deserialize(blob)
    chunk = deferred.flags_to_chunk(flags)
    profile = FLAG_PROFILES.get(flags & 0b11)
    layout = (ModelLayout(PROFILES[profile], lo_bucketed=chunk > 0)
              if profile else None)
    opts = DivansOptions()

    def one(f):
        raw = None
        if layout is not None:
            with tracelog.span("decode/native_serial", bytes=f.raw_len):
                raw = decode_metablock(f.cmd, f.lit, f.raw_len,
                                       profile != "stride", layout, chunk)
        if raw is None:
            with tracelog.span("decode/golden_fallback", bytes=f.raw_len):
                if chunk:
                    raw = deferred.decode_metablock(f.cmd, f.lit, f.raw_len,
                                                    opts, chunk)
                else:
                    raw = engine_np.decode_metablock(f.cmd, f.lit,
                                                     f.raw_len, opts)
        return raw

    # the pool only for native code, which releases the interpreter lock
    if len(frames) > 1 and load() is not None:
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
            parts = list(ex.map(tracelog.bound(one), frames))
    else:
        parts = [one(f) for f in frames]
    out = b"".join(parts)
    fmt.check_crc(out, stored_crc)
    return out
