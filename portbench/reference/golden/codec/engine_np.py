"""Golden serial codec engine — the exact-integer host implementation.

Frozen copy for the benchmark's write reference: the metablock encoder
and decoder of divans_tpu_torch/codec/engine_np.py as of the benchmark's
first version, with the file-level compress/decompress (and the imports
only they used) left out.  It imports nothing of the program.

One `MetablockCodec` codes one metablock: an independent model domain with
its own adaptive priors, distance LRU, and pair of ANS streams (cmd +
literal).  The command FSM reproduces the reference's coding semantics —
the same nibble decomposition, prior selection, and blend speeds at every
call site — so compression ratio matches the reference's model within a
metablock (citations per state below).  A copy of
divans_tpu/codec/engine_np.py: the port's golden engine, which codes the
options its card paths and native code leave (clustered context maps,
ECDF, streamed frames) and decodes the frames they refuse; every path of
the port gives its bytes.

Encode and decode share one FSM body, parameterized by the io objects
(the reference achieves this with its EncoderOrDecoderSpecialization,
src/codec/interface.rs:72-98).
"""
from __future__ import annotations

from .. import errors

from ..ans.coder_np import ANSEncoder, ANSDecoder
from ..probability import scalar
from ..probability.speed import (Speed, MUD, SLOW, MED, FAST, PLANE, ROCKET,
                                 u8_to_speed)
from ..ir import commands as cmds
from ..options import DivansOptions
from .. import dictionary
from .model import (CrossCommandBookKeeping, LiteralBookKeeping, CorruptStream,
                    get_distance_from_mnemonic_code)

NUM_LITERAL_LENGTH_MNEMONIC = 14


def _mv_is_per_btype(mv: bytes, nb: int) -> bool:
    """True if the mixing mask is one constant per literal block type
    (mv_mode=4 wire shape: value keyed by (index & 0xFF) >> 6, clamped)."""
    vals = [mv[t * 64] for t in range(nb)]
    return all(v == vals[min((i & 0xFF) >> 6, nb - 1)]
               for i, v in enumerate(mv))


def round_up_mod_4(v: int) -> int:
    return ((v - 1) | 3) + 1


def bit_length(v: int) -> int:
    return v.bit_length()


class EncIO:
    """Encoder side of get_or_put_nibble: knows the value, emits its range."""
    is_encoder = True

    def __init__(self):
        self.ans = ANSEncoder()

    def code(self, cdf: list[int], value: int) -> int:
        start, freq = scalar.sym_to_start_freq(cdf, value)
        self.ans.put(start, freq)
        return value

    def finish(self) -> bytes:
        return self.ans.flush()


class DecIO:
    """Decoder side: ignores the passed value, pulls the symbol."""
    is_encoder = False

    def __init__(self, data: bytes):
        self.ans = ANSDecoder(data)

    def code(self, cdf: list[int], _value: int) -> int:
        off = self.ans.peek_offset()
        sym = scalar.offset_to_sym(cdf, off)
        start, freq = scalar.sym_to_start_freq(cdf, sym)
        self.ans.advance(start, freq)
        return sym


class MetablockCodec:
    def __init__(self, io_cmd, io_lit, options: DivansOptions):
        self.io_cmd = io_cmd
        self.io_lit = io_lit
        self.options = options
        self.bk = CrossCommandBookKeeping()
        self.lbk = LiteralBookKeeping()
        self.bk.desired_context_mixing = min(options.dynamic_context_mixing, 7)
        self.bk.desired_prior_depth = options.prior_depth
        self.bk.desired_do_context_map = options.use_context_map
        self.output = bytearray()
        self.dict = dictionary.load()
        # Deferred (chunked) streams bucket the lo-nibble context dim
        # 64 -> 8 (layout.LO_BUCKET_SHIFT); adaptive streams keep full
        # resolution.  Set by the deferred codec / the trace FSM (codec/trace).
        self.lo_shift = 0
        # Adaptive streams clobber last_8_literals with window bytes after
        # every command (the reference's sync, cmd_to_raw/mod.rs:69-86);
        # deferred streams keep the literal history self-fed (literal
        # bytes only) so the TPU literal-decode kernel never needs the
        # window.  Set False by the deferred codec / the trace FSM.
        self.sync_lit_history = True

    # ------------------------------------------------------------------ util
    def _pre_literal_byte(self) -> None:
        """Hook before each literal content byte; the deferred codec
        switches lit sub-streams here (deferred-v3, deferred.SUB_LIT)."""

    def _nib(self, io, table, key: tuple, value: int, speed: Speed) -> int:
        """get_or_put_nibble + blend at one prior-table cell."""
        cdf = table.get(key)
        v = io.code(cdf, value)
        scalar.blend(cdf, v, speed.inc, speed.lim)
        return v

    # -------------------------------------------------------------- commands
    def code_command_type(self, value: int) -> int:
        """Begin state (codec/mod.rs:662-688): type nibble under the
        CrossCommand FullSelection prior keyed by last_4_states."""
        key = (self.bk.last_4_states >> 4,)
        return self._nib(self.io_cmd, self.bk.cc_priors, key, value, ROCKET)

    def code_literal(self, cmd: cmds.Literal | None) -> bytes:
        """Literal command (codec/literal.rs:495-728 length FSM + content)."""
        bk, io = self.bk, self.io_cmd
        ctype = bk.get_command_block_type()
        if io.is_encoder:
            literal_len = len(cmd.data)
            serialized = (literal_len - (NUM_LITERAL_LENGTH_MNEMONIC + 1)) & 0xFFFFFFFF
            shortcut = min(NUM_LITERAL_LENGTH_MNEMONIC, literal_len - 1)
            if cmd.high_entropy:
                # escape nibble, then the length is re-coded (literal.rs:569-583)
                self._nib(io, bk.lit_len_priors, ("cs", ctype, 0),
                          NUM_LITERAL_LENGTH_MNEMONIC + 1, MED)
        else:
            serialized = 0
            shortcut = 0
        # LiteralCountSmall (literal.rs:565-596)
        shortcut = self._nib(io, bk.lit_len_priors, ("cs", ctype, 0), shortcut, MED)
        if shortcut == NUM_LITERAL_LENGTH_MNEMONIC + 1:
            # high-entropy flag set; the length arrives in the next nibble
            shortcut = self._nib(io, bk.lit_len_priors, ("cs", ctype, 0),
                                 0, MED)
            if shortcut == NUM_LITERAL_LENGTH_MNEMONIC + 1:
                raise CorruptStream("repeated high-entropy escape", errors.ErrCode.HIGH_ENTROPY_ESCAPE)
        if shortcut < NUM_LITERAL_LENGTH_MNEMONIC:
            num_bytes = shortcut + 1
            bk.last_llen = num_bytes
        else:
            # LiteralCountFirst (:597-621)
            lllen = bit_length(serialized)
            beg = self._nib(io, bk.lit_len_priors, ("beg", ctype),
                            min(15, lllen), MUD)
            if beg == 15:
                # LiteralCountLengthGreater14Less25 (:622-633)
                last = self._nib(io, bk.lit_len_priors, ("last", ctype),
                                 (lllen - 15) & 0xF, MUD)
                num_bytes = self._mantissa(io, bk.lit_len_priors,
                                           lambda _i: ("mant", ctype),
                                           serialized, round_up_mod_4(last + 14),
                                           1 << (last + 14), MUD) \
                    + NUM_LITERAL_LENGTH_MNEMONIC + 1
                bk.last_llen = num_bytes
            elif beg <= 1:
                num_bytes = NUM_LITERAL_LENGTH_MNEMONIC + 1 + beg
                # quirk kept from the reference: last_llen not updated here
            else:
                num_bytes = self._mantissa(io, bk.lit_len_priors,
                                           lambda _i: ("mant", ctype),
                                           serialized, round_up_mod_4(beg - 1),
                                           1 << (beg - 1), MUD) \
                    + NUM_LITERAL_LENGTH_MNEMONIC + 1
                bk.last_llen = num_bytes
        # content nibbles against the LIT stream (literal.rs:260-394)
        data = cmd.data if io.is_encoder else None
        ext = self.options.external_probs
        out = bytearray()
        for i in range(num_bytes):
            self._pre_literal_byte()
            b = data[i] if data is not None else 0
            pos = len(self.output) + i
            if ext is not None and 8 * pos + 8 <= len(ext):
                # external-probability path (literal.rs:662-698): both
                # nibbles code against one-shot ECDFs; no model adaptation
                h = self._ecdf_nibble(b >> 4, ext[8 * pos + 4:8 * pos + 8])
                l = self._ecdf_nibble(b & 0xF, ext[8 * pos:8 * pos + 4])
            else:
                h = self._literal_nibble(True, b >> 4, 0)
                l = self._literal_nibble(False, b & 0xF, h)
            byte = (h << 4) | l
            self.lbk.push_literal_byte(byte)
            out.append(byte)
        return bytes(out)

    def _ecdf_nibble(self, value: int, probs4: bytes) -> int:
        from ..probability.external_cdf import external_prob_cdf
        cdf = external_prob_cdf(probs4)
        return self.io_lit.code(cdf, value)

    def _literal_nibble(self, is_high: bool, value: int, cur_byte_prior: int) -> int:
        """The literal hot path (codec/literal.rs:153-259): compute the
        prior indices from the byte history, then code via _code_lit_nibble
        (overridden by the encode-trace FSM, codec/trace.py)."""
        lbk = self.lbk
        l8 = lbk.last_8_literals
        prev_byte = (l8 >> 0x38) & 0xFF
        prev_prev = (l8 >> 0x30) & 0xFF
        selected = int(lbk.literal_lut0[prev_byte] | lbk.literal_lut1[prev_prev])
        cmap_index = selected + (lbk.btype_last << 6)
        actual_context = lbk.literal_context_map[cmap_index]
        if is_high:
            mm_index = actual_context | ((prev_byte >> 4) << 8)
        else:
            mm_index = actual_context | ((cur_byte_prior & 0xF) << 8) | 4096
        mm_opts = lbk.mixing_mask[mm_index]
        fast_cm = 0xFF if mm_opts != 3 else 0
        mm = 0xFF if (mm_opts != 0 and mm_opts != 3) else 0
        opt1 = 0xF if mm_opts == 1 else 0
        stride_offset = 0 if mm_opts < 4 else (min(7, mm_opts ^ 4) << 3)
        stride_byte = (l8 >> (0x38 - stride_offset)) & 0xFF
        if is_high:
            index_b = stride_byte & mm & (~opt1 & 0xFF)
            index_c = actual_context
        else:
            # deferred-profile format departure from the reference's
            # 3x256x256 table (src/codec/priors.rs:35-47): chunked streams
            # bucket the LO nibble's context-map dimension 64 -> 8
            # (lo_shift = 3; adaptive streams keep lo_shift = 0).
            # Measured cost +0.25% (research/deferred_v2_study.py);
            # shrinks lit_lo + cm_second 8x, which the TPU decode
            # kernel's select-scan fetch and the encode onehot matmul
            # both need.
            index_b = (mm & stride_byte) \
                | ((~mm & 0xFF) & (actual_context >> self.lo_shift))
            index_c = (cur_byte_prior & fast_cm) | ((actual_context & opt1) << 4)
        sel = (mm >> 7) ^ (opt1 >> 2)
        nib_key = (sel, index_b, index_c)
        if lbk.combine_literal_predictions:
            cm_key = (0, actual_context) if is_high \
                else (1, cur_byte_prior, actual_context >> self.lo_shift)
        else:
            cm_key = None
        return self._code_lit_nibble(is_high, nib_key, cm_key, value, mm_opts)

    def _code_lit_nibble(self, is_high: bool, nib_key: tuple,
                         cm_key: tuple | None, value: int, mm_opts: int) -> int:
        """Code one literal nibble: optional two-model mix + blends."""
        lbk = self.lbk
        io = self.io_lit
        table = lbk.lit_high_priors if is_high else lbk.lit_low_priors
        nibble_prob = table.get(nib_key)
        if cm_key is not None:
            cm_prob = lbk.lit_cm_priors.get(cm_key)
            w = lbk.model_weights[1 if is_high else 0]
            mixed = scalar.average(cm_prob, nibble_prob, w[2] & 0xFFFF)
            v = io.code(mixed, value)
            weighted = scalar.sym_to_start_freq(mixed, v)[1]
            p_cm = scalar.sym_to_start_freq(cm_prob, v)[1]
            p_nib = scalar.sym_to_start_freq(nibble_prob, v)[1]
            scalar.weights_update(w, p_cm, p_nib, weighted)
            sp = lbk.literal_adaptation[3 if is_high else 2]
            scalar.blend(cm_prob, v, sp.inc, sp.lim)
        else:
            prior = scalar.CDF_INIT if mm_opts == 2 else nibble_prob
            v = io.code(prior, value)
        if mm_opts != 2:
            sp = lbk.literal_adaptation[0]
            scalar.blend(nibble_prob, v, sp.inc, sp.lim)
        return v

    def _mantissa(self, io, table, key_fn, value: int, len_remaining: int,
                  seed: int, speed, first_key=None, first_speed=None) -> int:
        """Shared big-endian nibble-mantissa loop (copy.rs:138-162 et al).

        `seed` carries the implied leading-one bit; key_fn(i) gives the
        prior key for the i-th mantissa nibble (i==0 may differ)."""
        decoded = seed
        i = 0
        while len_remaining > 0:
            next_rem = len_remaining - 4
            nib = ((value ^ decoded) >> next_rem) & 0xF if io.is_encoder else 0
            key = first_key if (i == 0 and first_key is not None) else key_fn(i)
            sp = first_speed if (i == 0 and first_speed is not None) else speed
            if callable(sp):
                sp = sp(i)
            nib = self._nib(io, table, key, nib, sp)
            decoded |= nib << next_rem
            len_remaining = next_rem
            i += 1
        return decoded

    def code_copy(self, cmd: cmds.Copy | None) -> tuple[int, int]:
        """Copy command (codec/copy.rs:49-287): returns (distance, num_bytes)."""
        bk, io = self.bk, self.io_cmd
        ctype = bk.get_command_block_type()
        in_nb = cmd.num_bytes if io.is_encoder else 0
        in_d = cmd.distance if io.is_encoder else 0
        # CountSmall (:87-106)
        cs_index = ((bk.last_4_states >> 4) & 3) + 4 * min(bk.last_llen - 1, 3)
        shortcut = self._nib(io, bk.copy_priors, ("ccs", ctype, cs_index),
                             min(15, in_nb), MUD)
        if shortcut < 15:
            num_bytes = shortcut
            bk.last_clen = bit_length(num_bytes)
        else:
            clen = bit_length(in_nb)
            beg = self._nib(io, bk.copy_priors, ("cbeg", ctype, 0),
                            min(15, (clen - 4) & 0xFF) if io.is_encoder else 0, FAST)
            if beg == 15:
                last = self._nib(io, bk.copy_priors, ("clast", ctype, 0),
                                 (clen - 19) & 0xF, FAST)
                bk.last_clen = last + 19
                num_bytes = self._mantissa(
                    io, bk.copy_priors, lambda _i: ("cmant", ctype, 0),
                    in_nb, round_up_mod_4(last + 18), 1 << (last + 18), SLOW,
                    first_key=("cmant", ctype, (bk.last_clen % 4) + 1))
            else:
                bk.last_clen = beg + 4
                num_bytes = self._mantissa(
                    io, bk.copy_priors, lambda _i: ("cmant", ctype, 0),
                    in_nb, round_up_mod_4(beg + 3), 1 << (beg + 3), SLOW,
                    first_key=("cmant", ctype, (bk.last_clen % 4) + 1))
        # DistanceLengthMnemonic (:166-196)
        actual_prior = bk.get_distance_prior(num_bytes)
        mn_in = bk.distance_mnemonic_code(in_d, num_bytes) if io.is_encoder else 0
        mnemonic = self._nib(io, bk.copy_priors,
                             ("dmn", actual_prior, 1 if bk.last_llen < 8 else 0),
                             mn_in, SLOW)
        if mnemonic != 15:
            distance, ok, _ = get_distance_from_mnemonic_code(
                bk.distance_lru, mnemonic, num_bytes)
            if not ok:
                raise CorruptStream("bad distance mnemonic", errors.ErrCode.BAD_DIST_MNEMONIC)
            bk.last_dlen = bit_length(distance)
            return distance, num_bytes
        # DistanceLengthFirst (:197-226)
        dlen = bit_length(in_d)
        if io.is_encoder:
            beg_in = min(14, dlen - 1)
            if ((bk.distance_lru[1] - 3) & 0xFFFFFFFF) == in_d:
                beg_in = 15
        else:
            beg_in = 0
        dist_index = bit_length(num_bytes) >> 2
        beg = self._nib(io, bk.copy_priors, ("dbeg", actual_prior, dist_index),
                        beg_in, SLOW)
        if beg == 15:
            distance = (bk.distance_lru[1] - 3) & 0xFFFFFFFF
            bk.last_dlen = bit_length(distance)
        elif beg == 14:
            last = self._nib(io, bk.copy_priors, ("dlast", actual_prior, 0),
                             (dlen - 15) & 0xF, ROCKET)
            bk.last_dlen = last + 15
            distance = self._dist_mantissa(in_d, round_up_mod_4(last + 14),
                                           1 << (last + 14), actual_prior)
        elif beg == 0:
            distance = 1
            bk.last_dlen = 1
        else:
            bk.last_dlen = beg + 1
            distance = self._dist_mantissa(in_d, round_up_mod_4(beg),
                                           1 << beg, actual_prior)
        return distance, num_bytes

    def _dist_mantissa(self, in_d: int, len_remaining: int, seed: int,
                       actual_prior: int) -> int:
        """Distance mantissa nibbles (copy.rs:240-280): first-nibble prior
        index (last_dlen&3)+1 and a speed derived from that index."""
        bk = self.bk
        first_index = (bk.last_dlen & 3) + 1
        speed0 = Speed(0x4 << ((first_index & 6) << ((first_index & 2) >> 1)), 0x4000)
        speed_rest = Speed(0x4 << ((0 & 6) << 0), 0x4000)  # index 0 -> inc 4
        return self._mantissa(
            self.io_cmd, bk.copy_priors, lambda _i: ("dmant", actual_prior, 0),
            in_d, len_remaining, seed, speed_rest,
            first_key=("dmant", actual_prior, first_index), first_speed=speed0)

    def code_dict(self, cmd: cmds.Dict | None) -> bytes:
        """Dict command (codec/dict.rs:77-170): returns the transformed word."""
        bk, io = self.bk, self.io_cmd
        ctype = bk.get_command_block_type()
        ws_in = min(15, (cmd.word_size - 4) & 0xFF) if io.is_encoder else 0
        beg = self._nib(io, bk.dict_priors, ("sbeg", ctype), ws_in, MUD)
        if beg == 15:
            last = self._nib(io, bk.dict_priors, ("slast", ctype),
                             (cmd.word_size - 19) if io.is_encoder else 0, MUD)
            word_size = last + 19
            if word_size > 24:
                raise CorruptStream("dict word size too large", errors.ErrCode.DICT_SIZE)
        else:
            word_size = beg + 4
        bits = dictionary.DICT_BITS[word_size]
        actual_prior = bk.get_distance_prior(word_size)
        word_id = self._mantissa(
            io, bk.dict_priors, lambda _i: ("idx", actual_prior, 0),
            cmd.word_id if io.is_encoder else 0, round_up_mod_4(bits), 0, MUD,
            first_key=("idx", actual_prior, (bits % 4) + 1))
        high = self._nib(io, bk.dict_priors, ("tr", 0, word_size >> 1),
                         (cmd.transform >> 4) if io.is_encoder else 0, FAST)
        low = self._nib(io, bk.dict_priors, ("tr", 1, high),
                        (cmd.transform & 0xF) if io.is_encoder else 0, FAST)
        transform = (high << 4) | low
        if transform >= dictionary.NUM_TRANSFORMS:
            raise CorruptStream("dict transform out of range", errors.ErrCode.DICT_TRANSFORM)
        if not self.dict.available:
            raise CorruptStream("stream uses the static dictionary but none is loaded", errors.ErrCode.DICT_MISSING)
        if word_id >= (1 << bits):
            raise CorruptStream("dict word id out of range", errors.ErrCode.DICT_WORD_ID)
        return self.dict.transform_word(word_size, word_id, transform)

    def code_block_switch(self, which: int, value: int, max_seen_key: int) -> int:
        """BlockTypeState FSM (codec/block_type.rs:27-110)."""
        bk, io = self.bk, self.io_cmd
        if io.is_encoder:
            if value == bk.btype_lru[which][1]:
                mnemonic = 0
            elif value == (bk.btype_max_seen[which] + 1) & 0xFF:
                mnemonic = 1
            elif value <= 12:
                mnemonic = value + 2
            else:
                mnemonic = 15
        else:
            mnemonic = 0
        mnemonic = self._nib(io, bk.btype_priors, ("mn", which), mnemonic, SLOW)
        if mnemonic == 0:
            return bk.btype_lru[which][1]
        if mnemonic == 1:
            return (bk.btype_max_seen[which] + 1) & 0xFF
        if mnemonic != 15:
            return mnemonic - 2
        first = self._nib(io, bk.btype_priors, ("f", which),
                          value & 0xF, SLOW)
        second = self._nib(io, bk.btype_priors, ("s", which),
                           value >> 4, SLOW)
        return (second << 4) | first

    def code_stride_nibble(self, value: int) -> int:
        return self._nib(self.io_cmd, self.bk.btype_priors, ("stride", 0),
                         value, SLOW)

    def code_prediction_mode(self, cmd: cmds.PredictionMode | None) -> cmds.PredictionMode:
        """PredictionMode / context-map header (codec/context_map.rs:104-428)."""
        bk, io = self.bk, self.io_cmd
        pp = bk.prediction_priors
        bk.reset_context_map_lru()
        bk.reset_distance_context_map()
        out = cmds.PredictionMode()
        pm_in = cmd.literal_prediction_mode if io.is_encoder else 0
        out.literal_prediction_mode = self._nib(io, pp, ("only",), pm_in, MED)
        if out.literal_prediction_mode > 3:
            raise CorruptStream("bad prediction mode", errors.ErrCode.BAD_PREDICTION_MODE)
        # DynamicContextMixing (:187-207)
        mix_in = (bk.desired_context_mixing | ((cmd.adv_context_map & 1) << 3)) \
            if io.is_encoder else 0
        mix = self._nib(io, pp, ("dcm",), mix_in, MED)
        out.context_mixing = mix & 3
        out.adv_context_map = mix >> 2
        # PriorDepth (:208-220)
        out.prior_depth = self._nib(io, pp, ("pd",),
                                    bk.desired_prior_depth if io.is_encoder else 0,
                                    FAST)
        # AdaptationSpeed: 4 speeds x 4 palette nibbles (:221-263)
        speeds = []
        for si in range(4):
            if io.is_encoder:
                f8 = cmd.speeds[si].to_f8_tuple()
            else:
                f8 = (0, 0)
            inc8 = 0
            lim8 = 0
            for pt in range(4):
                if pt == 0:
                    nib_in = (f8[0] & 0x7F) >> 3
                elif pt == 1:
                    nib_in = (f8[0] & 0x7F) & 0x7
                elif pt == 2:
                    nib_in = (f8[1] & 0x7F) >> 3
                else:
                    nib_in = (f8[1] & 0x7F) & 0x7
                nib = self._nib(io, pp, ("palette", pt), nib_in, FAST)
                if pt == 0:
                    inc8 |= nib << 3
                elif pt == 1:
                    inc8 |= nib
                elif pt == 2:
                    lim8 |= nib << 3
                else:
                    lim8 |= nib
            inc, lim = u8_to_speed(inc8), u8_to_speed(lim8)
            if not (inc <= 0x4000 and lim <= 0x4000):
                # a corrupt stream (the reference's Speed asserts here)
                raise CorruptStream(f"speed ({inc}, {lim}) out of range",
                                    errors.ErrCode.BAD_PREDICTION_MODE)
            speeds.append(Speed(inc, lim))
        out.speeds = tuple(speeds)
        # context maps (:264-384)
        out.literal_context_map = bytes(self._code_context_map(
            cmd.literal_context_map if io.is_encoder else None, False))
        bk.reset_context_map_lru()
        out.distance_context_map = bytes(self._code_context_map(
            cmd.distance_context_map if io.is_encoder else None, True))
        # mixing values (reference: 8192 raw nibbles, context_map.rs:385-422).
        # Format departure: a leading mv_mode nibble elides the constant
        # masks (0 = all zeros, 1 = all fours, 2 = explicit, 3 = constant
        # value carried in one extra nibble — how stride detection emits
        # stride s as mask value 4 + s - 1; 4 = one value per literal
        # block type, nb nibbles — how block_split carries per-segment
        # strides) so the scan decoder pays 1-2 steps instead of 8192 in
        # the common cases.
        combine = out.context_mixing != 0
        nb = max(1, len(out.literal_context_map) // 64)
        if io.is_encoder:
            mv = cmd.mixing_values
            const_v = mv[0] if mv and all(x == mv[0] for x in mv) else None
            per_t = ([mv[t * 64] for t in range(nb)]
                     if mv and _mv_is_per_btype(mv, nb) else None)
            if not bk.desired_do_context_map and (not mv or const_v == 4):
                mv_mode = 1
            elif not any(mv):
                mv_mode = 0
            elif const_v is not None:
                mv_mode = 3
            elif per_t is not None:
                mv_mode = 4
            elif not combine:
                mv_mode = 0
            else:
                mv_mode = 2
        else:
            mv_mode = 0
        mv_mode = self._nib(io, pp, ("mvmode",), mv_mode, MED)
        if mv_mode == 0:
            out.mixing_values = bytes(cmds.NUM_MIXING_VALUES)
        elif mv_mode == 1:
            out.mixing_values = bytes([4]) * cmds.NUM_MIXING_VALUES
        elif mv_mode == 3:
            v = self._nib(io, pp, ("mix", 16),
                          const_v if io.is_encoder else 0, PLANE)
            out.mixing_values = bytes([v]) * cmds.NUM_MIXING_VALUES
        elif mv_mode == 4:
            vals = []
            for t in range(nb):
                vin = per_t[t] if io.is_encoder else 0
                vals.append(self._nib(io, pp, ("mix", 16), vin, PLANE))
            out.mixing_values = bytes(
                vals[min((i & 0xFF) >> 6, nb - 1)]
                for i in range(cmds.NUM_MIXING_VALUES))
        elif mv_mode == 2:
            mv_out = bytearray()
            for index in range(cmds.NUM_MIXING_VALUES):
                if io.is_encoder:
                    nib_in = (cmd.mixing_values[index]
                              if index < len(cmd.mixing_values) else 0)
                else:
                    nib_in = 0
                prior = (mv_out[index - 256] & 0xF) if index >= 256 else 16
                mv_out.append(self._nib(io, pp, ("mix", prior), nib_in, PLANE))
            out.mixing_values = bytes(mv_out)
        else:
            raise CorruptStream("bad mixing-value mode", errors.ErrCode.BAD_MV_MODE)
        return out

    def _code_context_map(self, in_map: bytes | None, is_distance: bool) -> bytearray:
        """ContextMapMnemonic / nibble escape loop (context_map.rs:264-384)."""
        bk, io = self.bk, self.io_cmd
        pp = bk.prediction_priors
        out = bytearray()
        which = 1 if is_distance else 0
        index = 0
        while True:
            if io.is_encoder:
                src = in_map if bk.desired_do_context_map else b""
                if index >= len(src):
                    mnemonic = 14  # eof
                else:
                    target = src[index]
                    mnemonic = 15
                    for li, lv in enumerate(bk.cmap_lru):
                        if lv == target:
                            mnemonic = li
                    if target == ((max(bk.cmap_lru) + 1) & 0xFF):
                        mnemonic = 13
            else:
                mnemonic = 0
            mnemonic = self._nib(io, pp, ("cmn", which), mnemonic, MED)
            if mnemonic == 14:
                return out
            if mnemonic == 15:
                val_in = in_map[index] if io.is_encoder else 0
                msn = self._nib(io, pp, ("cf", which), val_in >> 4, MED)
                lsn = self._nib(io, pp, ("cs", which), val_in & 0xF, MED)
                val = (msn << 4) | lsn
            else:
                if mnemonic == 13:
                    val = (max(bk.cmap_lru) + 1) & 0xFF
                else:
                    val = bk.cmap_lru[mnemonic]
            bk.obs_context_map_for_lru(is_distance, index, val)
            out.append(val)
            index += 1


# ======================================================================
# metablock-level entry points
# ======================================================================

def encode_metablock(raw: bytes, commands: list[cmds.Command],
                     options: DivansOptions) -> tuple[bytes, bytes]:
    """Encode one metablock's command stream; returns (cmd_bytes, lit_bytes)."""
    io_cmd = EncIO()
    io_lit = EncIO()
    codec = MetablockCodec(io_cmd, io_lit, options)
    for cmd in commands:
        _run_one_command(codec, cmd)
    codec.code_command_type(cmds.END_NIBBLE)
    assert bytes(codec.output) == raw, "encoder ring-buffer replay mismatch"
    return io_cmd.finish(), io_lit.finish()


def encode_metablock_streamed(raw: bytes, commands: list[cmds.Command],
                              options: DivansOptions, chunk_raw: int):
    """Encode one metablock as a STREAMED frame: [(raw_delta, cmd_chunk,
    lit_chunk)] where feeding the first k chunks lets a decoder emit
    sum(raw_delta[:k]) output bytes — decode latency bounded by
    chunk_raw, not metablock size (the reference's <=64 KiB stream
    interleave, mux.rs:23,445-478).  Chunk boundaries land on command
    boundaries; the concatenated chunks are exactly the plain frame's
    cmd/lit streams, so non-streaming consumers reassemble and decode
    unchanged.  The sub-stream prefix property comes from the rANS wire
    layout: state[4] ++ forward-order renorm words, so the prefix needed
    for the first S symbols is 4 + 2*pulls(S) (ANSEncoder
    flush_with_marks)."""
    io_cmd = EncIO()
    io_lit = EncIO()
    codec = MetablockCodec(io_cmd, io_lit, options)
    marks = []                       # (raw_pos, cmd_syms, lit_syms)
    for cmd in commands:
        _run_one_command(codec, cmd)
        marks.append((len(codec.output), len(io_cmd.ans._pairs),
                      len(io_lit.ans._pairs)))
    codec.code_command_type(cmds.END_NIBBLE)
    assert bytes(codec.output) == raw, "encoder ring-buffer replay mismatch"
    # the END nibble belongs to the final chunk
    marks.append((len(raw), len(io_cmd.ans._pairs),
                  len(io_lit.ans._pairs)))
    cmd_b, cmarks = io_cmd.ans.flush_with_marks()
    lit_b, lmarks = io_lit.ans.flush_with_marks()

    def pref(b, mk, s):
        return 0 if s == 0 else 4 + 2 * mk[s]

    bounds = []
    target = chunk_raw
    for m in marks[:-1]:
        if m[0] >= target:
            if not bounds or m != bounds[-1]:
                bounds.append(m)
            target = m[0] + chunk_raw
    if not bounds or bounds[-1] != marks[-1]:
        bounds.append(marks[-1])
    chunks = []
    prev = (0, 0, 0)
    for m in bounds:
        chunks.append((m[0] - prev[0],
                       cmd_b[pref(cmd_b, cmarks, prev[1]):
                             pref(cmd_b, cmarks, m[1])],
                       lit_b[pref(lit_b, lmarks, prev[2]):
                             pref(lit_b, lmarks, m[2])]))
        prev = m
    assert b"".join(c[1] for c in chunks) == cmd_b
    assert b"".join(c[2] for c in chunks) == lit_b
    return chunks


class StreamedMetablockDecoder:
    """Incremental decoder for one streamed frame: feed chunks, collect
    output bytes as they unlock (resume granularity = one chunk)."""

    def __init__(self, raw_len: int, options: DivansOptions):
        self.raw_len = raw_len
        self.codec = MetablockCodec(DecIO(b""), DecIO(b""), options)
        self._raw_done = 0
        self._ended = False
        self._guard = 0

    def feed(self, raw_delta: int, cmd_chunk: bytes,
             lit_chunk: bytes) -> bytes:
        """Feed one chunk; returns the newly decodable raw bytes."""
        self.codec.io_cmd.ans.extend(cmd_chunk)
        self.codec.io_lit.ans.extend(lit_chunk)
        self._raw_done += raw_delta
        return self._pump(self._raw_done)

    def finish(self) -> bytes:
        """All chunks fed: decode through the END command and verify."""
        out = self._pump(self._raw_done, expect_end=True)
        if len(self.codec.output) != self.raw_len:
            raise CorruptStream(
                f"metablock decoded {len(self.codec.output)} != "
                f"{self.raw_len}", errors.ErrCode.LENGTH_MISMATCH)
        return out

    def _pump(self, raw_limit: int, expect_end: bool = False) -> bytes:
        codec = self.codec
        start = len(codec.output)
        while not self._ended and (len(codec.output) < raw_limit
                                   or expect_end):
            if not _decode_one_command(codec):
                self._ended = True
                break
            self._guard += 1
            if (len(codec.output) > self.raw_len
                    or self._guard > 8 * self.raw_len + 1024):
                raise CorruptStream(
                    "metablock decode overran declared length",
                    errors.ErrCode.LENGTH_OVERRUN)
        return bytes(codec.output[start:])


def _run_one_command(codec: MetablockCodec, cmd) -> None:
    bk, lbk = codec.bk, codec.lbk
    nib = cmds.CMD_NIBBLE[type(cmd)]
    codec.code_command_type(nib)
    if isinstance(cmd, cmds.Literal):
        bk.obs_literal_state()
        data = codec.code_literal(cmd)
        codec.output += data
        if codec.sync_lit_history:
            lbk.sync_last_8_from_output(codec.output)
    elif isinstance(cmd, cmds.Copy):
        bk.obs_copy_state()
        distance, num_bytes = codec.code_copy(cmd)
        bk.obs_distance(distance)
        _execute_copy(codec.output, distance, num_bytes)
        if codec.sync_lit_history:
            lbk.sync_last_8_from_output(codec.output)
    elif isinstance(cmd, cmds.Dict):
        bk.obs_dict_state()
        word = codec.code_dict(cmd)
        codec.output += word
        if codec.sync_lit_history:
            lbk.sync_last_8_from_output(codec.output)
    elif isinstance(cmd, cmds.BlockSwitchLiteral):
        btype = codec.code_block_switch(0, cmd.block_type, 0)
        stride = codec.code_stride_nibble(cmd.stride)
        bk.obs_btypel(btype)
        lbk.btype_last = btype
        lbk.stride = stride
    elif isinstance(cmd, cmds.BlockSwitchCommand):
        btype = codec.code_block_switch(1, cmd.block_type, 1)
        bk.obs_btypec(btype)
    elif isinstance(cmd, cmds.BlockSwitchDistance):
        btype = codec.code_block_switch(2, cmd.block_type, 2)
        bk.obs_btyped(btype)
    elif isinstance(cmd, cmds.PredictionMode):
        pm = codec.code_prediction_mode(cmd)
        lbk.obs_prediction_mode(pm, bk.desired_do_context_map)
    else:
        raise TypeError(f"unknown command {cmd!r}")


def _execute_copy(output: bytearray, distance: int, num_bytes: int) -> None:
    if distance == 0 or distance > len(output):
        raise CorruptStream(f"copy distance {distance} beyond window {len(output)}", errors.ErrCode.BAD_DISTANCE)
    start = len(output) - distance
    if distance >= num_bytes:
        output += output[start:start + num_bytes]
    else:
        for i in range(num_bytes):  # overlapping copy replicates the pattern
            output.append(output[start + i])


def decode_metablock(cmd_stream: bytes, lit_stream: bytes, raw_len: int,
                     options: DivansOptions) -> bytes:
    """Decode one metablock back to raw bytes."""
    io_cmd = DecIO(cmd_stream)
    io_lit = DecIO(lit_stream)
    codec = MetablockCodec(io_cmd, io_lit, options)
    return _decode_loop(codec, raw_len)


def _decode_one_command(codec: MetablockCodec) -> bool:
    """Decode one command; False when it was the END marker."""
    bk, lbk = codec.bk, codec.lbk
    nib = codec.code_command_type(0)
    if nib == cmds.END_NIBBLE:
        return False
    if nib == 0x3:
        bk.obs_literal_state()
        data = codec.code_literal(None)
        codec.output += data
        if codec.sync_lit_history:
            lbk.sync_last_8_from_output(codec.output)
    elif nib == 0x1:
        bk.obs_copy_state()
        distance, num_bytes = codec.code_copy(None)
        bk.obs_distance(distance)
        _execute_copy(codec.output, distance, num_bytes)
        if codec.sync_lit_history:
            lbk.sync_last_8_from_output(codec.output)
    elif nib == 0x2:
        bk.obs_dict_state()
        word = codec.code_dict(None)
        codec.output += word
        if codec.sync_lit_history:
            lbk.sync_last_8_from_output(codec.output)
    elif nib == 0x4:
        btype = codec.code_block_switch(0, 0, 0)
        stride = codec.code_stride_nibble(0)
        bk.obs_btypel(btype)
        lbk.btype_last = btype
        lbk.stride = stride
    elif nib == 0x5:
        bk.obs_btypec(codec.code_block_switch(1, 0, 1))
    elif nib == 0x6:
        bk.obs_btyped(codec.code_block_switch(2, 0, 2))
    elif nib == 0x7:
        pm = codec.code_prediction_mode(None)
        lbk.obs_prediction_mode(pm, bk.desired_do_context_map)
    else:
        raise CorruptStream(f"bad command nibble {nib}", errors.ErrCode.BAD_COMMAND)
    return True


def _decode_loop(codec: MetablockCodec, raw_len: int) -> bytes:
    """The decode-side command pump, shared with the deferred codec."""
    guard = 0
    while _decode_one_command(codec):
        guard += 1
        if len(codec.output) > raw_len or guard > 8 * raw_len + 1024:
            raise CorruptStream("metablock decode overran declared length", errors.ErrCode.LENGTH_OVERRUN)
    if len(codec.output) != raw_len:
        raise CorruptStream(f"metablock decoded {len(codec.output)} != {raw_len}", errors.ErrCode.LENGTH_MISMATCH)
    return bytes(codec.output)
