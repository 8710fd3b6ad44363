"""Frozen copy for the benchmark's deferred read reference: the golden
deferred decoder of divans_tpu_torch/codec/deferred.py as of the
deferred-q10 configuration's first version (the normative rules, the
policy, the structure pass decode_cmd_structure, execute_script and
decode_metablock), with the encoder's lit field assembly, the flags
writer and the numpy trace replay left out.  It imports nothing of the
program: engine_np, layout, scalar and speed are the golden copies
beside it.

The chunk-deferred profile: all model state is frozen within a chunk of
S coded nibbles and updated in one batch at chunk boundaries, with a
one-chunk commit lag; the cmd and lit streams tick their own clocks
(S_lit = S, S_cmd = max(16, S / 4)); the lo context is bucketed; the
literal history is self-fed; and a metablock's literals are split at
SUB_LIT-byte boundaries into sub-streams, each with its own coder,
fresh literal model and mixer weights.  The frame's lit field is
varint(n_subs), varint(len(sub_i)) for i < n_subs - 1, then the
payloads.
"""
from __future__ import annotations

from .. import errors
from ..errors import CorruptStream
from ..probability import scalar
from ..probability.scalar import CDF_INIT, WEIGHT_INIT, norm_weight
from ..probability.speed import Speed

LAG = 1
MAX_RENORM_PASSES = 24
ADJ_CLAMP = 1 << 21
WEIGHT_MAX = (1 << 30) - 1
SUB_LIT = 1 << 15   # literal bytes per lit sub-stream (deferred-v3); 1<<14 cost +4.6% on alice29 (text models still learning at 16 KiB)


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


def decode_metablock(cmd_stream: bytes, lit_stream: bytes, raw_len: int,
                     options, chunk: int) -> bytes:
    from .engine_np import DecIO, _decode_loop
    io_cmd = DecIO(cmd_stream)
    codec = make_deferred_codec(io_cmd, None, options, chunk)
    codec.start_lit_field(lit_stream)
    return _decode_loop(codec, raw_len)
