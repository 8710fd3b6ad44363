"""The command IR: brotli-style commands, the interchange between the
matcher (ir/matcher) and the coders (the trace FSM of
native.build_trace_cmds and codec/trace, the golden engine
codec/engine_np).  A copy of divans_tpu/ir/commands.py.
"""
from __future__ import annotations

import dataclasses
from typing import Union

from ..constants import LITERAL_PREDICTION_MODE_UTF8
from ..probability.speed import DEFAULT_LITERAL_SPEED, Speed

NUM_MIXING_VALUES = 8192


@dataclasses.dataclass
class Literal:
    data: bytes
    high_entropy: bool = False


@dataclasses.dataclass
class Copy:
    distance: int
    num_bytes: int


@dataclasses.dataclass
class Dict:
    word_size: int      # 4..24
    word_id: int        # < 2^DICT_BITS[word_size]
    transform: int      # < 121
    final_size: int     # length after the transform


@dataclasses.dataclass
class BlockSwitchLiteral:
    block_type: int
    stride: int = 0


@dataclasses.dataclass
class BlockSwitchCommand:
    block_type: int


@dataclasses.dataclass
class BlockSwitchDistance:
    block_type: int


@dataclasses.dataclass
class PredictionMode:
    """Model-configuration header command: everything the decoder needs,
    so the decoder is configuration-free."""
    literal_prediction_mode: int = LITERAL_PREDICTION_MODE_UTF8
    context_mixing: int = 0          # 0..7 on the wire; &3 = mixer level
    adv_context_map: int = 0
    prior_depth: int = 0
    # adaptation speeds: [stride-low, stride-high, cm-low, cm-high]
    speeds: tuple[Speed, Speed, Speed, Speed] = (DEFAULT_LITERAL_SPEED,) * 4
    literal_context_map: bytes = b""     # 64 entries per literal block type
    distance_context_map: bytes = b""    # 4 entries per distance block type
    mixing_values: bytes = b""           # NUM_MIXING_VALUES entries or empty


Command = Union[Literal, Copy, Dict, BlockSwitchLiteral, BlockSwitchCommand,
                BlockSwitchDistance, PredictionMode]

CMD_NIBBLE = {Copy: 0x1, Dict: 0x2, Literal: 0x3, BlockSwitchLiteral: 0x4,
              BlockSwitchCommand: 0x5, BlockSwitchDistance: 0x6,
              PredictionMode: 0x7}
END_NIBBLE = 0xF
