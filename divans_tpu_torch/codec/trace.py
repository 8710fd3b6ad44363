"""Encode-side trace FSM: command stream -> per-nibble coding trace.

The device encode is two-pass (DESIGN.md §2).  Pass 1 (here, host) runs
the codec FSM *without touching any CDF* — control flow never depends on
CDF contents at encode time, only on command values and bookkeeping —
and records, for every nibble, which dense model row codes it and how it
adapts.  Pass 2 (the card's model passes, codec/encode and
codec/adaptive) replays the trace, then the rANS encode codes the
streams.  A copy of divans_tpu/codec/trace.py: the Python twin of the
native FSM (native.build_trace_cmds), for the command lists native code
refuses (quality 11 without the context map).

The FSM is inherited from the golden MetablockCodec (engine_np.py) with
only the two coding hooks overridden, so the trace is exact by
construction: same calls, same order, same bookkeeping.

Trace row columns (int32):
  0 flat   dense model row that codes this nibble (0 = frozen CDF_INIT)
  1 value  the nibble
  2 stream 0 = cmd, 1 = lit
  3 inc, 4 lim   blend speed for the coding row (inc 0 = no adaptation)
  5 mix    1 = two-model literal mix (average + weight update)
  6 which  mixer select: 0 = low nibble, 1 = high nibble
  7 cm_idx context-model row (mix only; else 0)
  8 cm_inc, 9 cm_lim  blend speed for the context-model row
"""
from __future__ import annotations

import numpy as np

from ..options import DivansOptions
from ..ir import commands as cmds
from .engine_np import MetablockCodec, _run_one_command
from .layout import ModelLayout

NCOLS = 10
NOOP_LIM = 0x4000  # blend(row, v, 0, 0x4000) never renorms a live row


class _TraceIO:
    is_encoder = True


class TraceCodec(MetablockCodec):
    """MetablockCodec with coding replaced by trace recording."""

    def __init__(self, options: DivansOptions, layout: ModelLayout):
        super().__init__(_TraceIO(), _TraceIO(), options)
        self.layout = layout
        # deferred (lo_bucketed) layouts: bucketed lo ctx + self-fed
        # literal history (codec/deferred.py deferred-v2 rules)
        self.lo_shift = layout.lo_shift
        self.sync_lit_history = not layout.lo_bucketed
        self.rows: list[tuple] = []
        self._lit_count = 0

    def _pre_literal_byte(self):
        """deferred-v3 lit sub-streams: the trace's context keys must be
        computed with the literal history zeroed at every SUB_LIT
        boundary, exactly as the decoder resets it (deferred.py).  The
        model/weight resets live downstream — every lit model pass runs
        per sub-trace with a fresh model."""
        if not self.sync_lit_history:   # deferred profiles only
            from .deferred import SUB_LIT
            if self._lit_count and self._lit_count % SUB_LIT == 0:
                self.lbk.last_8_literals = 0
            self._lit_count += 1

    def _nib(self, io, table, key, value, speed):
        flat = self.layout.idx_for_key(table.name, key)
        stream = 0 if io is self.io_cmd else 1
        self.rows.append((flat, value, stream, speed.inc, speed.lim,
                          0, 0, 0, 0, NOOP_LIM))
        return value

    def _code_lit_nibble(self, is_high, nib_key, cm_key, value, mm_opts):
        lbk = self.lbk
        lay = self.layout
        nib_flat = lay.idx_for_key("lit_hi" if is_high else "lit_lo", nib_key)
        sp0 = lbk.literal_adaptation[0]
        inc, lim = (0, NOOP_LIM) if mm_opts == 2 else (sp0.inc, sp0.lim)
        if cm_key is None:
            flat = 0 if mm_opts == 2 else nib_flat
            self.rows.append((flat, value, 1, inc, lim, 0, 0, 0, 0, NOOP_LIM))
        else:
            cm_flat = lay.idx_for_key("cm", cm_key)
            cm_sp = lbk.literal_adaptation[3 if is_high else 2]
            self.rows.append((nib_flat, value, 1, inc, lim, 1,
                              1 if is_high else 0, cm_flat,
                              cm_sp.inc, cm_sp.lim))
        return value


def build_trace(raw: bytes, commands: list[cmds.Command],
                options: DivansOptions, layout: ModelLayout) -> np.ndarray:
    """Trace one metablock's command stream; returns int32[n, 10].

    Also replays commands into the ring buffer and asserts it reproduces
    `raw` (same invariant as the golden encoder)."""
    return build_trace_with_bounds(raw, commands, options, layout)[0]


def build_trace_with_bounds(raw: bytes, commands: list[cmds.Command],
                            options: DivansOptions, layout: ModelLayout):
    """build_trace plus per-command trace-row spans [(start, end), ...]
    (used by the measured-cost IR optimizer, ir/optimize.py)."""
    codec = TraceCodec(options, layout)
    bounds = []
    for cmd in commands:
        a = len(codec.rows)
        _run_one_command(codec, cmd)
        bounds.append((a, len(codec.rows)))
    codec.code_command_type(cmds.END_NIBBLE)
    assert bytes(codec.output) == raw, "trace ring-buffer replay mismatch"
    return np.array(codec.rows, dtype=np.int32).reshape(-1, NCOLS), bounds
