"""Structured error codes (a copy of divans_tpu/errors.py's taxonomy).

Values are stable ABI shared with the JAX package and the C API: never
renumber, only append.
"""
from __future__ import annotations

import enum


class ErrCode(enum.IntEnum):
    GENERIC = 1

    # ---- container layer (container/format.py)
    BAD_MAGIC = 10
    BAD_VERSION = 11
    BAD_WINDOW = 12
    TRUNCATED_VARINT = 13
    VARINT_TOO_LONG = 14
    MISSING_EOF = 15
    TRUNCATED_FRAME = 16
    TRUNCATED_TRAILER = 17
    BAD_TRAILER_MAGIC = 18
    CRC_MISMATCH = 19
    PARTIAL_FRAME = 20
    BAD_LIT_SUBS = 21
    LIT_SUB_OVERRUN = 22

    # ---- codec stream layer (codec/*, native.py)
    BAD_COMMAND = 40
    BAD_DISTANCE = 41
    BAD_DIST_MNEMONIC = 42
    DIST_CMAP_RANGE = 43
    DICT_SIZE = 44
    DICT_TRANSFORM = 45
    DICT_MISSING = 46
    DICT_WORD_ID = 47
    BAD_PREDICTION_MODE = 48
    BAD_MV_MODE = 49
    LENGTH_OVERRUN = 50
    LENGTH_MISMATCH = 51
    HIGH_ENTROPY_ESCAPE = 52
    SCRIPT_FAILED = 53


class CodedError(Exception):
    """Base for exceptions carrying an ErrCode (`.code`)."""

    def __init__(self, msg: str = "", code: ErrCode = ErrCode.GENERIC):
        super().__init__(msg)
        self.code = ErrCode(code)


class CorruptStream(CodedError):
    """Codec-layer failure (the JAX package raises its twin from
    codec/engine_np.py)."""
