"""Chunk-deferred adaptation — the device-speed model policy (a copy of
divans_tpu/codec/deferred.py: the normative rules, the golden deferred
codec and the numpy trace replay).

The reference adapts every CDF after every nibble (frequentist_cdf.rs:73-85
via codec call sites), which serializes coding at one model read-modify-write
per nibble.  This module defines the **deferred profile**: a format variant
where all model state is frozen within a chunk of S coded nibbles and
updated in one batch at chunk boundaries.  Everything inside a chunk then
becomes gather-only — the property the TPU engines exploit (encode: whole
chunks vectorize as gathers + one histogram matmul, jax_engine.py; decode:
a gather-only Pallas inner loop).

Measured ratio cost (research/deferred_adaptation_study.py, alice29):
chunk=64 +0.25%, 256 +0.79%, 1024 +2.49%; the one-chunk commit lag below
costs ≈ one doubling of S.

Normative rules (format-defining; encoder and decoder must both implement
these exactly — they deliberately differ from the serial blend sequence so
that the boundary update is batched / matmul-shaped):

  * Chunks: coded nibbles (both streams, FSM order) are numbered t = 0,1,…;
    chunk k covers t in [kS, (k+1)S).  S is a power of two carried in the
    container flags byte.  COPY runs, ring-buffer work etc. do not tick t.
  * Visibility (commit lag LAG = 1): coding at chunk k uses the model state
    with chunks 0..k-1-LAG applied.  (Chunks 0 and 1 both see the initial
    state.)  The lag exists so a pipelined kernel can overlap chunk k's
    gathers with the application of chunk k-1's updates.
  * Boundary CDF rule, per model row touched in the chunk (int32 math):
        row[i]  += sum over hits (sym, inc) of: inc if i >= sym else 0
        lim_eff  = floor(sum(lim of each hit) / num hits)
        repeat at most MAX_RENORM_PASSES times while row[15] >= lim_eff:
            row[i] = (row[i]+i+1) - ((row[i]+i+1) >> 2)
    Hits with inc == 0 (the frozen static-prior path) record nothing.
  * Boundary mixer rule, per mixer `which` (int32 wraparound arithmetic):
        adj_t(model i) = clamp((error * (n1i - p1)) >> (log_geo - 15),
                               +/- ADJ_CLAMP)        # w-independent!
        w_i'  = clamp(w_i + sum of adj_t, 1, 2^30 - 1)
        then the >=2^24 rescale of weights.rs:64-80, then norm_weight.
    p1 = coded freq under the mixed CDF, n1i = freq under model i, all
    from the frozen snapshot, so every adj_t in a chunk is independent.

Deferred-v2 (round 2) — three further normative rules, all chosen for the
TPU decode kernel (costs measured in research/deferred_v2_study.py):

  * Per-stream ticking: the cmd and lit streams run their own chunk
    clocks — S_lit = S (the container value), S_cmd = max(16, S / 4).
    Each stream's nibbles tick only its own clock, and each stream's
    chunk updates touch only its own model rows (the row sets are
    disjoint by layout).  Ratio-neutral (-0.01% at 64/256) and it fully
    decouples the two decode passes (cmd pass needs no lit state and
    vice versa), mirroring the reference's 2-thread split
    (src/parallel_decompressor.rs:99-133) as two independent kernels.
  * Lo-context bucketing: lit_lo/cm_second context dims 64 -> 8
    (layout.LO_BUCKET_SHIFT, +0.25%).
  * Self-fed literal history: last_8_literals accumulates literal bytes
    only — copies/dicts do not clobber it with window bytes (the
    reference syncs from the ring buffer after every command,
    src/cmd_to_raw/mod.rs:69-86).  This frees the literal decode kernel
    from the window entirely (one pure byte-stream pass).  Costs +1.3%
    on text; the adaptive profile (S = 0) keeps reference semantics and
    stays the max-ratio path.

The adaptive (S = 0) wire format is unchanged; deferred streams are marked
in the container flags byte (bits 2-4 = log2(S) - 3).

Deferred-v3 (round 4) — LIT SUB-STREAMS, the N-lane ANS step of the
SURVEY §2 parallelism plan (reference analog: the 2-stream mux that
makes its 2-thread pipeline possible, src/mux.rs + NUM_STREAMS=2 at
src/interface.rs:235-290 — here the lane count scales with the data):

  * A metablock's literal bytes are split at fixed SUB_LIT-byte
    boundaries into independent sub-streams: each has its own ANS
    coder, fresh lit-side model (DeferredPolicy: rows + mixer weights)
    and zeroed literal history (last_8_literals).  The cmd stream, LZ
    window, and command model stay metablock-wide — only the literal
    MODEL domain shrinks, so the ratio cost is tiny and confined to
    frames with > SUB_LIT literals.
  * Wire: the frame's lit field = varint(n_subs), varint(len(sub_i))
    for i < n_subs-1 (the last length is implied), then the
    concatenated sub-stream payloads.
  * Why: a stream is decoded serially per lane; the device kernel's
    scan length is bounded below by the LARGEST single stream.  Real
    corpora put 100x between the median and max literal loads, so
    without splitting the grid runs nearly empty
    (research/probe_decode_stages.py: 18% utilization).  Sub-streams
    make every lane job <= SUB_LIT/ (chunk/2) steps and bin-pack
    near-perfectly (pallas_decode.pack_lane_queues) — in BOTH
    directions (the encode lanes pack the same way).
"""
from __future__ import annotations

from .. import errors
from ..errors import CorruptStream

import numpy as np

from ..probability import scalar
from ..probability.scalar import CDF_INIT, WEIGHT_INIT, norm_weight
from ..probability.speed import Speed

LAG = 1
MAX_RENORM_PASSES = 24
ADJ_CLAMP = 1 << 21
WEIGHT_MAX = (1 << 30) - 1
SUB_LIT = 1 << 15   # literal bytes per lit sub-stream (deferred-v3); 1<<14 cost +4.6% on alice29 (text models still learning at 16 KiB)


def lit_subs_join(subs: list[bytes]) -> bytes:
    """Assemble a frame's lit field from its sub-stream payloads."""
    from ..container.format import write_varint
    out = bytearray(write_varint(len(subs)))
    for s in subs[:-1]:
        out += write_varint(len(s))
    for s in subs:
        out += s
    return bytes(out)


def lit_subs_split(lit_field: bytes) -> list[bytes]:
    """Split a frame's lit field into its sub-stream payloads."""
    from ..container.format import read_varint, CorruptContainer
    if not lit_field:
        return [b""]
    n, pos = read_varint(lit_field, 0)
    if not 1 <= n <= 1 << 20:
        raise CorruptContainer(f"bad lit sub-stream count {n}", errors.ErrCode.BAD_LIT_SUBS)
    lens = []
    for _ in range(n - 1):
        ln, pos = read_varint(lit_field, pos)
        lens.append(ln)
    subs = []
    for ln in lens:
        if pos + ln > len(lit_field):
            raise CorruptContainer("lit sub-stream overruns the field", errors.ErrCode.LIT_SUB_OVERRUN)
        subs.append(lit_field[pos:pos + ln])
        pos += ln
    subs.append(lit_field[pos:])
    return subs


def cmd_chunk(chunk: int) -> int:
    """Per-stream ticking: the cmd stream's chunk size for lit chunk S."""
    return max(16, chunk >> 2)

# container flags byte: bits 0-1 profile, bits 2-4 chunk code
_CHUNK_SHIFT = 2
_CHUNK_BITS = 0b111


def chunk_to_flags(chunk: int) -> int:
    """chunk (0 = adaptive, else power of two in [16, 1024]) -> flag bits."""
    if chunk == 0:
        return 0
    assert chunk & (chunk - 1) == 0 and 16 <= chunk <= 1024, chunk
    return (chunk.bit_length() - 4) << _CHUNK_SHIFT


def flags_to_chunk(flags: int) -> int:
    code = (flags >> _CHUNK_SHIFT) & _CHUNK_BITS
    return 0 if code == 0 else 1 << (code + 3)


def _wrap_i32(x: int) -> int:
    return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def apply_row_update(row: list[int], add_ge: list[int], lim: int) -> None:
    """The boundary CDF rule, in place (row holds int16-range values)."""
    r = [row[i] + add_ge[i] for i in range(16)]
    for _ in range(MAX_RENORM_PASSES):
        if r[15] < lim:
            break
        r = [(v + i + 1) - ((v + i + 1) >> 2) for i, v in enumerate(r)]
    row[:] = r


def weight_adjustments(p_cm: int, p_nib: int, weighted: int) -> tuple[int, int]:
    """Per-step clamped mixer adjustments (w-independent, see module doc)."""
    total = 1 << 15
    p1 = weighted
    error = total - p1
    log_geo = (p1 * (total - p1)).bit_length()
    shift = max(log_geo - 15, 0)
    out = []
    for n1i in (p_cm, p_nib):
        adj = (error * (n1i - p1)) >> shift
        out.append(min(max(adj, -ADJ_CLAMP), ADJ_CLAMP))
    return out[0], out[1]


def apply_weight_update(w: list[int], adj_sum0: int, adj_sum1: int) -> None:
    """The boundary mixer rule, in place on w = [w0, w1, norm_weight]."""
    w0 = min(max(1, _wrap_i32(w[0] + _wrap_i32(adj_sum0))), WEIGHT_MAX)
    w1 = min(max(1, _wrap_i32(w[1] + _wrap_i32(adj_sum1))), WEIGHT_MAX)
    if (w0 | w1) & 0x7F000000:
        ilog = max(w0.bit_length(), w1.bit_length())
        if ilog >= 24:
            w0 >>= ilog - 24
            w1 >>= ilog - 24
    w[0], w[1], w[2] = w0, w1, norm_weight(w0, w1)


class DeferredPolicy:
    """Snapshot/commit bookkeeping shared by the golden deferred codec.

    Rows are keyed by any hashable identity (the codec uses
    (table_name, *key); the trace replay uses flat layout rows — both are
    injective, so the chunk histograms agree)."""

    def __init__(self, chunk: int, lag: int = LAG):
        assert chunk > 0
        self.chunk = chunk
        self.lag = lag
        self.committed: dict = {}
        self.weights = [list(WEIGHT_INIT), list(WEIGHT_INIT)]
        self.queue: list = []
        self._new_chunk()
        self.t = 0

    def _new_chunk(self):
        self.cur_rows: dict = {}
        self.cur_wadj = [[0, 0], [0, 0]]

    def row(self, key) -> list[int]:
        """The frozen snapshot row for this chunk.  Callers must not mutate."""
        r = self.committed.get(key)
        return r if r is not None else CDF_INIT

    def record_blend(self, key, sym: int, inc: int, lim: int) -> None:
        if inc == 0:
            return
        upd = self.cur_rows.get(key)
        if upd is None:
            upd = self.cur_rows[key] = [[0] * 16, 0, 0]
        add_ge, _, _ = upd
        for i in range(sym, 16):
            add_ge[i] += inc
        upd[1] += lim
        upd[2] += 1

    def record_wadj(self, which: int, adj0: int, adj1: int) -> None:
        acc = self.cur_wadj[which]
        acc[0] = _wrap_i32(acc[0] + adj0)
        acc[1] = _wrap_i32(acc[1] + adj1)

    def tick(self) -> None:
        self.t += 1
        if self.t % self.chunk == 0:
            self.queue.append((self.cur_rows, self.cur_wadj))
            self._new_chunk()
            if len(self.queue) > self.lag:
                rows, wadj = self.queue.pop(0)
                for key, (add_ge, limsum, cnt) in rows.items():
                    row = self.committed.get(key)
                    if row is None:
                        row = self.committed[key] = list(CDF_INIT)
                    apply_row_update(row, add_ge, limsum // cnt)
                for which in (0, 1):
                    apply_weight_update(self.weights[which],
                                        wadj[which][0], wadj[which][1])


# ======================================================================
# golden deferred codec (policy plugged into the shared FSM)
# ======================================================================

def make_deferred_codec(io_cmd, io_lit, options, chunk: int, lag: int = LAG,
                        script=None):
    """A MetablockCodec whose model policy is the deferred-v2 profile:
    per-stream chunk clocks, bucketed lo context, self-fed lit history.

    With `script` (a CmdScript), the *structure* variant instead: literal
    content is skipped (deferred-v2's per-stream decoupling means the cmd
    FSM needs only the literals' lengths) and the decoded command
    structure is recorded, the host half of the deferred decode.  It is
    the golden twin of native.decode_cmd_structure, which the decode
    takes when the library is there."""
    from .engine_np import MetablockCodec

    class _DeferredCodec(MetablockCodec):
        def __init__(self):
            from .layout import LO_BUCKET_SHIFT
            super().__init__(io_cmd, io_lit, options)
            self.policy_cmd = DeferredPolicy(cmd_chunk(chunk), lag)
            self.policy = DeferredPolicy(chunk, lag)  # lit clock + weights
            self.lo_shift = LO_BUCKET_SHIFT  # deferred format buckets lo ctx
            self.sync_lit_history = False    # deferred lit history is self-fed
            self._lit_count = 0
            self._lit_subs: list[bytes] = []  # encoder: finished subs
            self._lit_sub_iter = None         # decoder: remaining payloads

        def _pre_literal_byte(self):
            """deferred-v3: switch to a fresh lit sub-stream every
            SUB_LIT literal bytes — new ANS coder, fresh lit model and
            mixer weights, zeroed literal history (the sub decodes
            exactly as a standalone stream; see module docstring)."""
            if self._lit_count and self._lit_count % SUB_LIT == 0:
                from .engine_np import EncIO, DecIO
                if self.io_lit is not None:
                    if self.io_lit.is_encoder:
                        self._lit_subs.append(self.io_lit.finish())
                        self.io_lit = EncIO()
                    else:
                        sub = next(self._lit_sub_iter, None)
                        if sub is None:   # the reference: StopIteration
                            raise CorruptStream(
                                "literals past the last lit sub-stream",
                                errors.ErrCode.BAD_LIT_SUBS)
                        self.io_lit = DecIO(sub)
                self.policy = DeferredPolicy(chunk, lag)
                self.lbk.last_8_literals = 0
            self._lit_count += 1

        def finish_lit_field(self) -> bytes:
            """Encoder: flush the open sub and assemble the lit field."""
            return lit_subs_join(self._lit_subs + [self.io_lit.finish()])

        def start_lit_field(self, lit_field: bytes) -> None:
            """Decoder: parse the sub header, point io_lit at sub 0."""
            from .engine_np import DecIO
            subs = lit_subs_split(lit_field)
            self.io_lit = DecIO(subs[0])
            self._lit_sub_iter = iter(subs[1:])

        def _nib(self, io, table, key, value, speed: Speed) -> int:
            pol = self.policy_cmd  # all _nib call sites code the cmd stream
            row_key = (table.name,) + tuple(key)
            cdf = pol.row(row_key)
            v = io.code(cdf, value)
            pol.record_blend(row_key, v, speed.inc, speed.lim)
            pol.tick()
            return v

        def _code_lit_nibble(self, is_high, nib_key, cm_key, value, mm_opts):
            pol = self.policy
            lbk = self.lbk
            io = self.io_lit
            nib_row_key = ("lit_hi" if is_high else "lit_lo",) + tuple(nib_key)
            nibble_prob = pol.row(nib_row_key)
            if cm_key is not None:
                cm_row_key = ("cm",) + tuple(cm_key)
                cm_prob = pol.row(cm_row_key)
                which = 1 if is_high else 0
                w = pol.weights[which]
                mixed = scalar.average(cm_prob, nibble_prob, w[2] & 0xFFFF)
                v = io.code(mixed, value)
                weighted = scalar.sym_to_start_freq(mixed, v)[1]
                p_cm = scalar.sym_to_start_freq(cm_prob, v)[1]
                p_nib = scalar.sym_to_start_freq(nibble_prob, v)[1]
                pol.record_wadj(which, *weight_adjustments(p_cm, p_nib, weighted))
                sp = lbk.literal_adaptation[3 if is_high else 2]
                pol.record_blend(cm_row_key, v, sp.inc, sp.lim)
            else:
                prior = CDF_INIT if mm_opts == 2 else nibble_prob
                v = io.code(prior, value)
            if mm_opts != 2:
                sp = lbk.literal_adaptation[0]
                pol.record_blend(nib_row_key, v, sp.inc, sp.lim)
            pol.tick()
            return v

    if script is None:
        return _DeferredCodec()

    class _StructureCodec(_DeferredCodec):
        def _literal_nibble(self, is_high, value, cur_byte_prior):
            return 0  # the content lives on the (untouched) lit stream

        def code_literal(self, cmd):
            data = super().code_literal(cmd)
            script.ops.append(("L", len(data)))
            script.lit_total += len(data)
            return data

        def code_copy(self, cmd):
            d, n = super().code_copy(cmd)
            script.ops.append(("C", d, n))
            return d, n

        def code_dict(self, cmd):
            w = super().code_dict(cmd)
            script.ops.append(("D", w))
            return w

        def code_block_switch(self, which, btype_in, kind):
            bt = super().code_block_switch(which, btype_in, kind)
            if kind == 0 and bt != 0:
                script.supported = False  # the kernel assumes block type 0
            return bt

        def code_prediction_mode(self, cmd):
            pm = super().code_prediction_mode(cmd)
            script.pm_count += 1
            script.pred_mode = pm.literal_prediction_mode
            return pm

    return _StructureCodec()


class CmdScript:
    """Command structure decoded from the cmd stream alone by the golden
    pass (decode_cmd_structure): ops ("L", n) / ("C", dist, n) / ("D",
    word bytes), the literal byte total, and the literal model's
    configuration from the PredictionMode (lcmap, speeds), as
    native.NativeScript holds them.  `supported` is False when the stream
    leaves the literal kernel's envelope (block switches, more than one
    PredictionMode, non-UTF8 luts, a mixing mask, mixing off); the frame
    then decodes on the host."""

    def __init__(self):
        self.ops: list[tuple] = []
        self.lit_total = 0
        self.pm_count = 0
        self.pred_mode = -1
        self.supported = True
        self.lcmap: list[int] | None = None
        self.speeds: list | None = None


def decode_cmd_structure(cmd_stream: bytes, raw_len: int, options,
                         chunk: int) -> CmdScript:
    """Decode one deferred metablock's command structure (no literals)
    in Python."""
    from .engine_np import DecIO, _decode_loop
    from .. import constants
    script = CmdScript()
    codec = make_deferred_codec(DecIO(cmd_stream), None, options, chunk,
                                script=script)
    _decode_loop(codec, raw_len)
    lbk = codec.lbk
    script.lcmap = [int(x) for x in lbk.literal_context_map[:64]]
    script.speeds = list(lbk.literal_adaptation)
    if script.pm_count != 1:
        script.supported = False
    if not lbk.combine_literal_predictions:
        script.supported = False  # the kernel always mixes (cm profile)
    if any(lbk.mixing_mask):
        script.supported = False  # the kernel assumes no mixing mask
    if script.pred_mode != constants.LITERAL_PREDICTION_MODE_UTF8:
        script.supported = False  # the kernel takes the UTF8 luts
    return script


def execute_script(script: CmdScript, lit_bytes: bytes) -> bytes:
    """Replay a CmdScript with its decoded literal bytes."""
    from .engine_np import _execute_copy
    out = bytearray()
    pos = 0
    for op in script.ops:
        if op[0] == "L":
            out += lit_bytes[pos:pos + op[1]]
            pos += op[1]
        elif op[0] == "C":
            _execute_copy(out, op[1], op[2])
        else:
            out += op[1]
    return bytes(out)


def encode_metablock(raw: bytes, commands, options,
                     chunk: int) -> tuple[bytes, bytes]:
    from .engine_np import EncIO, _run_one_command
    from ..ir import commands as cmds
    io_cmd, io_lit = EncIO(), EncIO()
    codec = make_deferred_codec(io_cmd, io_lit, options, chunk)
    for cmd in commands:
        _run_one_command(codec, cmd)
    codec.code_command_type(cmds.END_NIBBLE)
    assert bytes(codec.output) == raw, "encoder ring-buffer replay mismatch"
    return io_cmd.finish(), codec.finish_lit_field()


def decode_metablock(cmd_stream: bytes, lit_stream: bytes, raw_len: int,
                     options, chunk: int) -> bytes:
    from .engine_np import DecIO, _decode_loop
    io_cmd = DecIO(cmd_stream)
    codec = make_deferred_codec(io_cmd, None, options, chunk)
    codec.start_lit_field(lit_stream)
    return _decode_loop(codec, raw_len)


# ======================================================================
# trace replay (numpy, chunk-vectorized) — the encode-side model pass
# ======================================================================

def replay_trace(trace: np.ndarray, chunk: int,
                 lag: int = LAG) -> tuple[np.ndarray, np.ndarray]:
    """Deferred-v2 (start, freq) for each trace step, in trace order.

    NOTE (deferred-v3): a metablock's lit stream resets its model every
    SUB_LIT literal bytes; wire-exact replay of a trace with > SUB_LIT
    literals must feed the lit rows per sub-trace
    (jax_engine._split_lit_sub_traces).  Whole-trace replay remains a
    fine cost estimator (ir/matcher.py fallback).

    Per-stream ticking: each stream's rows replay on their own chunk
    clock (cmd = cmd_chunk(chunk), lit = chunk); results scatter back to
    the interleaved trace positions.  Padding rows (stream == -1, if
    any) replay as no-ops on the lit clock."""
    n = trace.shape[0]
    starts = np.zeros(n, np.int32)
    freqs = np.ones(n, np.int32)
    for sid, s in ((0, cmd_chunk(chunk)), (1, chunk)):
        m = trace[:, 2] == sid
        if not m.any():
            continue
        s_, f_ = _replay_stream(trace[m], s, lag)
        starts[m], freqs[m] = s_, f_
    return starts, freqs


def _replay_stream(trace: np.ndarray, chunk: int,
                   lag: int = LAG) -> tuple[np.ndarray, np.ndarray]:
    """One stream's deferred (start, freq) (codec/trace.py columns).

    Row identity here is the flat layout index (trace col 0 / col 7) —
    injective with the codec's (table, key) identity, so bytes agree.
    Semantically this is DeferredPolicy applied to the whole trace; the
    chunk interior is vectorized (everything reads frozen snapshots).
    """
    n = trace.shape[0]
    nrows = int(max(trace[:, 0].max(initial=0), trace[:, 7].max(initial=0))) + 1
    model = np.broadcast_to(
        np.asarray(CDF_INIT, np.int32), (nrows, 16)).copy()
    wts = np.array([WEIGHT_INIT, WEIGHT_INIT], np.int32)
    pending: list = []

    starts = np.zeros(n, np.int32)
    freqs = np.zeros(n, np.int32)

    flat, value, _stream, inc, lim, mix, which, cm_idx, cm_inc, cm_lim = \
        (trace[:, i].astype(np.int32) for i in range(10))
    idx16 = np.arange(16)[None, :]

    for k0 in range(0, n, chunk):
        k1 = min(k0 + chunk, n)
        sl = slice(k0, k1)
        f = flat[sl]
        v = value[sl]
        rows = model[f]
        cm_rows = model[cm_idx[sl]]
        do_mix = mix[sl] != 0
        nw = wts[which[sl], 2] & 0xFFFF
        mixed = _np_average(cm_rows, rows, nw)
        coded = np.where(do_mix[:, None], mixed, rows)
        s_, q_ = _np_sym_to_start_freq(coded, v)
        starts[sl], freqs[sl] = s_, q_

        # ---- record this chunk's updates
        upd_rows: dict = {}
        ge_v = (idx16 >= v[:, None]).astype(np.int64)
        cm_live = do_mix & (cm_inc[sl] != 0)
        for t in range(k1 - k0):
            pairs = []
            if inc[sl][t]:
                pairs.append((int(f[t]), int(inc[sl][t]), int(lim[sl][t])))
            if cm_live[t]:
                pairs.append((int(cm_idx[sl][t]), int(cm_inc[sl][t]),
                              int(cm_lim[sl][t])))
            for key, i_, l_ in pairs:
                u = upd_rows.get(key)
                if u is None:
                    u = upd_rows[key] = [np.zeros(16, np.int64), 0, 0]
                u[0] += i_ * ge_v[t]
                u[1] += l_
                u[2] += 1
        # mixer adjustments (vectorized; p1*p0 <= 2^30 fits int32)
        _, p_cm = _np_sym_to_start_freq(cm_rows, v)
        _, p_nib = _np_sym_to_start_freq(rows, v)
        p1 = q_.astype(np.int64)
        error = (1 << 15) - p1
        log_geo = _np_bit_length_pos((p1 * error).astype(np.int32))
        shift = np.maximum(log_geo.astype(np.int64) - 15, 0)
        wadj = [[0, 0], [0, 0]]
        for i_model, n1i in ((0, p_cm), (1, p_nib)):
            adj = (error * (n1i.astype(np.int64) - p1)) >> shift
            adj = np.clip(adj, -ADJ_CLAMP, ADJ_CLAMP)
            for wsel in (0, 1):
                m = do_mix & (which[sl] == wsel)
                wadj[wsel][i_model] = _wrap_i32(int(adj[m].sum()))
        pending.append((upd_rows, wadj))

        # ---- commit the chunk that becomes visible
        if len(pending) > lag:
            upd, wa = pending.pop(0)
            for key, (add_ge, limsum, cnt) in upd.items():
                row = list(int(x) for x in model[key])
                apply_row_update(row, [int(x) for x in add_ge], limsum // cnt)
                model[key] = row
            for wsel in (0, 1):
                w = [int(x) for x in wts[wsel]]
                apply_weight_update(w, wa[wsel][0], wa[wsel][1])
                wts[wsel] = w
    return starts, freqs


# numpy CDF arithmetic of the replay: the integer rules of
# probability/cdf16.py on int32 numpy arrays, with numpy's floor division
# as the reference's replay divides (the torch helpers floor a row's max
# at 1, which a wrapped row would tell apart)

def _np_bit_length_pos(x: np.ndarray) -> np.ndarray:
    r = np.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        r = np.where((x >> (r + shift)) > 0, r + shift, r)
    return r + (x > 0).astype(x.dtype)


def _np_wrap_i16(x: np.ndarray) -> np.ndarray:
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _np_average(cdf_a: np.ndarray, cdf_b: np.ndarray,
                mix_rate: np.ndarray) -> np.ndarray:
    amax = cdf_a[..., 15:16]
    bmax = cdf_b[..., 15:16]
    shift = np.maximum(_np_bit_length_pos(amax * bmax) - 15, 0)
    mix_rate = np.asarray(mix_rate, np.int32)[..., None]
    inv_mix = (1 << 15) - mix_rate
    ra = (cdf_a * bmax) >> shift
    rb = (cdf_b * amax) >> shift
    return _np_wrap_i16((ra * mix_rate + rb * inv_mix + 1) >> 15)


def _np_sym_to_start_freq(cdf: np.ndarray, sym: np.ndarray):
    from ..constants import LOG2_SCALE
    maxv = cdf[..., 15]
    c_sym = np.take_along_axis(cdf, sym[..., None], axis=-1)[..., 0]
    c_prev = np.take_along_axis(cdf, np.maximum(sym - 1, 0)[..., None],
                                axis=-1)[..., 0]
    c_prev = np.where(sym > 0, c_prev, 0)
    r_sym = (c_sym << LOG2_SCALE) // maxv
    r_prev = np.where(sym > 0, (c_prev << LOG2_SCALE) // maxv, 0)
    return r_prev + 1, r_sym - r_prev - 1
