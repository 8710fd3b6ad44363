"""Per-metablock adaptive model state for the golden serial engine.

Prior tables are sparse dict-of-rows (a row materializes to the default
CDF on first touch) — semantically identical to the reference's dense
flat allocations (src/priors.rs define_prior_struct!) since untouched
rows are never observed.  Table shapes follow src/codec/priors.rs:8-133.

A copy of divans_tpu/codec/model.py.  The card's model passes hold the
same rows densely (codec/layout); their outputs equal this model's.
"""
from __future__ import annotations

from ..probability import scalar
from ..probability.speed import DEFAULT_LITERAL_SPEED
from .. import constants
from ..errors import CorruptStream, ErrCode  # noqa: F401 (re-exported)


class PriorTable:
    """Sparse table of 16-entry CDFs keyed by an index tuple.

    `name` identifies the table family for the dense-layout mapping
    (codec/layout.py idx_for_key)."""

    __slots__ = ("rows", "name")

    def __init__(self, name: str = ""):
        self.rows: dict[tuple, list[int]] = {}
        self.name = name

    def get(self, key: tuple) -> list[int]:
        row = self.rows.get(key)
        if row is None:
            row = scalar.CDF_INIT.copy()
            self.rows[key] = row
        return row


NUM_BLOCK_TYPES = 256
BLOCK_TYPE_LITERAL_SWITCH = 0
BLOCK_TYPE_COMMAND_SWITCH = 1
BLOCK_TYPE_DISTANCE_SWITCH = 2


class CrossCommandBookKeeping:
    """Command-side state (reference codec/interface.rs:142-168, 355-400)."""

    def __init__(self):
        self.last_4_states = 3 << 4          # interface.rs:375 (LOG_NUM_COPY_TYPE_PRIORS=4)
        self.distance_lru = [4, 11, 15, 16]  # interface.rs:396
        self.btype_lru = [[0, 1], [0, 1], [0, 1]]
        self.btype_max_seen = [0, 0, 0]
        self.last_dlen = 1
        self.last_clen = 1
        self.last_llen = 1
        self.cmap_lru = list(range(13))
        self.distance_context_map = [i & 3 for i in range(NUM_BLOCK_TYPES * 4)]
        # priors
        self.cc_priors = PriorTable("cc")       # FullSelection (16, 1)
        self.lit_len_priors = PriorTable("lit_len")  # CountSmall/SizeBeg/SizeLast/Mantissa
        self.copy_priors = PriorTable("copy")
        self.dict_priors = PriorTable("dict")
        self.btype_priors = PriorTable("btype")
        self.prediction_priors = PriorTable("pred")
        # desired-* mirrors of encoder options (carried into the PM command)
        self.desired_context_mixing = 0
        self.desired_prior_depth = 0
        self.desired_do_context_map = True
        self.desired_force_stride = 0          # 0 == UseBrotliRec disabled, stride from cmd
        self.desired_literal_adaptation: tuple | None = None

    # ---- block types ----
    def get_command_block_type(self) -> int:
        return self.btype_lru[BLOCK_TYPE_COMMAND_SWITCH][0]

    def get_distance_block_type(self) -> int:
        return self.btype_lru[BLOCK_TYPE_DISTANCE_SWITCH][0]

    def get_literal_block_type(self) -> int:
        return self.btype_lru[BLOCK_TYPE_LITERAL_SWITCH][0]

    def _obs_btype(self, which: int, btype: int) -> None:
        self.last_4_states >>= 2
        self.btype_lru[which] = [btype, self.btype_lru[which][0]]
        self.btype_max_seen[which] = max(self.btype_max_seen[which], btype)

    def obs_btypel(self, btype: int) -> None:
        self._obs_btype(BLOCK_TYPE_LITERAL_SWITCH, btype)

    def obs_btypec(self, btype: int) -> None:
        self._obs_btype(BLOCK_TYPE_COMMAND_SWITCH, btype)

    def obs_btyped(self, btype: int) -> None:
        self._obs_btype(BLOCK_TYPE_DISTANCE_SWITCH, btype)

    # ---- command-type FSM prior ----
    def obs_copy_state(self) -> None:
        self.last_4_states = ((self.last_4_states >> 2) | 64) & 0xFF

    def obs_dict_state(self) -> None:
        self.last_4_states = ((self.last_4_states >> 2) | 192) & 0xFF

    def obs_literal_state(self) -> None:
        self.last_4_states = ((self.last_4_states >> 2) | 128) & 0xFF

    # ---- distances ----
    def obs_distance(self, distance: int) -> None:
        lru = self.distance_lru
        if distance == lru[1]:
            self.distance_lru = [distance, lru[0], lru[2], lru[3]]
        elif distance == lru[2]:
            self.distance_lru = [distance, lru[0], lru[1], lru[3]]
        elif distance != lru[0]:
            self.distance_lru = [distance, lru[0], lru[1], lru[2]]

    def get_distance_prior(self, copy_len: int) -> int:
        dtype = self.get_distance_block_type()
        idx = dtype * 4 + min(max(copy_len, 2) - 2, 3)
        return self.distance_context_map[idx]

    def distance_mnemonic_code(self, d: int, l: int) -> int:
        for i in range(15):
            item, ok, _ = get_distance_from_mnemonic_code(self.distance_lru, i, l)
            if item == d and ok:
                return i
        return 15

    # ---- context-map LRU (interface.rs:439-467) ----
    def reset_context_map_lru(self) -> None:
        self.cmap_lru = list(range(13))

    def reset_distance_context_map(self) -> None:
        for i in range(len(self.distance_context_map)):
            self.distance_context_map[i] = i & 3

    def obs_context_map_for_lru(self, is_distance: bool, index: int, val: int) -> None:
        lru = self.cmap_lru
        if val in lru:
            pos = lru.index(val)
            if pos != 0:
                self.cmap_lru = [val] + lru[:pos] + lru[pos + 1:]
        else:
            self.cmap_lru = [val] + lru[:-1]
        if is_distance:
            if index >= len(self.distance_context_map):
                raise CorruptStream("distance context map index out of range", ErrCode.DIST_CMAP_RANGE)
            self.distance_context_map[index] = val


def get_distance_from_mnemonic_code(lru: list[int], code: int, _num_bytes: int):
    """codec/interface.rs:978-1009: 15 mnemonics over the distance LRU."""
    if code < 4:
        return lru[code], True, code
    unsigned = code >> 2
    signed = unsigned - (((-(code & 1)) & unsigned) << 1)
    index = (code & 2) >> 1
    ret = lru[index] + signed
    return ret & 0xFFFFFFFF, ret > 0, index


class LiteralBookKeeping:
    """Literal-side state (reference codec/interface.rs:125-140, 246-340)."""

    def __init__(self):
        self.last_8_literals = 0              # u64, newest byte in the top 8 bits
        self.stride = 0
        self.btype_last = 0
        self.combine_literal_predictions = False
        self.mixing_param = 0
        self.literal_adaptation = [DEFAULT_LITERAL_SPEED] * 4
        self.literal_lut0 = constants.literal_lut0(constants.LITERAL_PREDICTION_MODE_UTF8)
        self.literal_lut1 = constants.literal_lut1(constants.LITERAL_PREDICTION_MODE_UTF8)
        self.mixing_mask = [0] * 8192
        self.literal_context_map = [0] * (NUM_BLOCK_TYPES * 64)
        self.model_weights = [scalar.WEIGHT_INIT.copy(), scalar.WEIGHT_INIT.copy()]
        self.lit_high_priors = PriorTable("lit_hi")  # (sel, index_b, index_c)
        self.lit_low_priors = PriorTable("lit_lo")
        self.lit_cm_priors = PriorTable("cm")  # FirstNibble (0, ctx) / SecondNibble (1, prior, ctx)

    def push_literal_byte(self, b: int) -> None:
        self.last_8_literals = ((self.last_8_literals >> 8)
                                | (b << 0x38)) & 0xFFFFFFFFFFFFFFFF

    def sync_last_8_from_output(self, out: bytearray) -> None:
        """After each command the reference clobbers last_8_literals with the
        ring buffer's tail (codec/mod.rs:771-786)."""
        tail = out[-8:]
        v = 0
        n = len(tail)
        for i, b in enumerate(tail):
            v |= b << ((8 - n + i) * 8)
        self.last_8_literals = v

    def obs_pred_mode(self, mode: int) -> None:
        self.literal_lut0 = constants.literal_lut0(mode)
        self.literal_lut1 = constants.literal_lut1(mode)

    def obs_prediction_mode(self, pm, do_context_map: bool) -> None:
        """Apply a decoded PredictionMode command
        (obs_prediction_mode_context_map, codec/interface.rs:296-323)."""
        self.combine_literal_predictions = (pm.context_mixing & 3) != 0
        self.mixing_param = pm.context_mixing & 3
        self.obs_pred_mode(pm.literal_prediction_mode)
        self.literal_adaptation = list(pm.speeds)
        lcm = pm.literal_context_map
        for i in range(len(self.literal_context_map)):
            self.literal_context_map[i] = lcm[i] if i < len(lcm) else 0
        mv = pm.mixing_values
        for i in range(8192):
            self.mixing_mask[i] = mv[i] if i < len(mv) else 0
